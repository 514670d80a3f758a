"""Hard-mode synthetic corpus: recall behaves like real SIFT/Deep (the port
of ``chamjax/data/hard.py``).

The corpus family is the JAX package's: many more clusters than IVF cells,
Zipf cluster mass (``p_c ∝ (c+1)^-zipf_a``), overlapping clusters
(``center_scale`` ≈ the within-cluster spread), per-cluster anisotropy
(``n_banks`` permutations of one decaying eigenvalue profile ``lam``) and
queries that are independent draws from the same density (or jittered
corpus rows).  Its nprobe→recall curve is meant to resemble the Faiss
anchors the reference cites (SIFT100M IVF4096,PQ16 → R@10
0.41/0.66/0.79/0.80 at nprobe 1/4/16/32).

Everything is a deterministic row-indexed stream: ``draw(start, count)``
generates ``GEN``-row chunks, chunk ``s`` from ``fold_in(fold_in(key,
salt), s)`` — the JAX package's threefry streams (``chamjax_torch.random``),
so both packages draw the same rows from one seed, on the CPU as on a card,
whatever the caller's chunking.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from chamjax_torch import random as jr
from chamjax_torch.utils.device import resolve_device
from chamjax_torch.utils.precision import fp32_matmul

GEN = 1 << 20     # generator granularity (rows); draws are identical
                  # regardless of the caller's chunking


def _scan16(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sums in XLA's CPU order: rows of 16, each
    summed left to right, plus the scanned totals of the rows before."""
    n = x.shape[0]
    if n <= 16:
        rows = x[None]
    else:
        rows = torch.nn.functional.pad(x, (0, -n % 16)).reshape(-1, 16)
    p = rows.clone()
    for j in range(1, p.shape[1]):
        p[:, j] = p[:, j - 1] + rows[:, j]
    if n <= 16:
        return p[0]
    totals = _scan16(p[:, -1].contiguous())
    carry = torch.cat([totals.new_zeros(1), totals[:-1]])
    return (p + carry[:, None]).reshape(-1)[:n]


def _sum32(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum in XLA's CPU order: blocks of 32 summed left to
    right, again until at most 32 partial sums remain, those left to
    right."""
    while x.shape[0] > 32:
        blocks = torch.nn.functional.pad(x, (0, -x.shape[0] % 32)).reshape(
            -1, 32)
        x = blocks[:, 0].clone()
        for j in range(1, 32):
            x = x + blocks[:, j]
    acc = x.new_zeros(())
    for v in x:
        acc = acc + v
    return acc


def zipf_cdf(n_clusters: int, zipf_a: float, device) -> torch.Tensor:
    """The cluster-mass CDF ``cumsum(w) / sum(w)``, ``w = (c + 1) **
    -zipf_a``, float32, equal to the JAX package's bit for bit: the power
    through float64 (XLA's is float32 powf, rounded alike in all but a few
    weights whose last bit never reaches the CDF), the prefix sums and the
    total in XLA's CPU summation orders.  A uniform draw picks its cluster
    by this CDF, so one ulp here moves rows across a cluster boundary."""
    x = torch.arange(1, n_clusters + 1, dtype=torch.float64, device=device)
    w = torch.pow(x, float(np.float32(-zipf_a))).to(torch.float32)
    return _scan16(w) / _sum32(w)


class HardCorpus(NamedTuple):
    """Deterministic streamed hard-mode corpus."""

    d: int
    n_clusters: int
    seed: int
    draw_base: object       # draw(start, count) -> (count, d) f32 tensor
    draw_train: object      # same stream salted differently
    queries: object         # queries(nq, jitter=...) -> (nq, d) tensor
    params: dict


def make_hard_corpus(
    d: int = 128,
    n_clusters: int = 262_144,
    seed: int = 42,
    *,
    zipf_a: float = 1.05,
    rank: Optional[int] = None,
    spectrum_tau: float = 0.0,
    center_scale: float = 1.25,
    noise: float = 0.05,
    n_banks: int = 64,
    device=None,
) -> HardCorpus:
    """Build the hard-mode streamed generator on ``device``.

    ``spectrum_tau`` 0 defaults to ``rank/3``; ``center_scale`` sets the
    cluster separation in units of the ~1-per-dim within-cluster std."""
    dev = resolve_device(device)
    rank = rank or max(4, d // 4)
    tau = spectrum_tau or rank / 3.0
    key = jr.key(seed)
    k_c, k_p, k_b, _ = jr.split(key, 4)
    centers = jr.normal(k_c, (n_clusters, d), scale=center_scale, device=dev)
    proj = jr.normal(k_p, (rank, d), device=dev) / float(
        np.float32(np.sqrt(rank)))
    lam = torch.exp(-torch.arange(rank, dtype=torch.float32, device=dev)
                    / tau)
    lam = lam * torch.sqrt(rank / torch.sum(lam * lam))
    perms = torch.stack([jr.permutation(k, rank, device=dev)
                         for k in jr.split(k_b, n_banks)])
    lam_bank = lam[perms]                               # (n_banks, rank)
    cdf = zipf_cdf(n_clusters, zipf_a, dev)

    @fp32_matmul()
    def gen(k) -> torch.Tensor:
        k1, k2, k3 = jr.split(k, 3)
        u = jr.uniform(k1, (GEN,), device=dev)
        asg = torch.clamp(torch.searchsorted(cdf, u, side="left"),
                          max=n_clusters - 1)
        z = jr.normal(k2, (GEN, rank), device=dev)
        z = z * lam_bank[asg % n_banks]
        eps = jr.normal(k3, (GEN, d), scale=noise, device=dev)
        return centers[asg] + torch.matmul(z, proj) + eps

    def make_draw(salt: int):
        base = jr.fold_in(key, salt)

        def draw(s: int, c: int) -> torch.Tensor:
            if s % GEN or c % GEN or c <= 0:
                raise ValueError(f"hard-mode draws must align to GEN={GEN} "
                                 f"rows; got ({s}, {c})")
            parts = [gen(jr.fold_in(base, s + i)) for i in range(0, c, GEN)]
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        return draw

    draw_base = make_draw(1)
    draw_train = make_draw(2)

    def queries(nq: int, jitter: float = -1.0, salt: int = 3
                ) -> torch.Tensor:
        """Query set.  ``jitter < 0`` (default): independent draws from the
        same density (a fresh salted stream).  ``jitter >= 0``: corpus rows
        of the first GEN, chosen without replacement, plus Gaussian noise
        of ``jitter`` (the re-finding regime)."""
        if not 0 < nq <= GEN:
            raise ValueError(f"nq={nq} must be in 1..GEN={GEN}")
        if jitter < 0:
            return make_draw(3 + salt)(0, GEN)[:nq]
        k_i, k_e = jr.split(jr.fold_in(key, salt))
        idx = jr.choice(k_i, GEN, nq, device=dev)
        eps = jr.normal(k_e, (nq, d), scale=jitter, device=dev)
        return draw_base(0, GEN)[idx] + eps

    return HardCorpus(
        d=d, n_clusters=n_clusters, seed=seed,
        draw_base=draw_base, draw_train=draw_train, queries=queries,
        params=dict(zipf_a=zipf_a, rank=rank, spectrum_tau=tau,
                    center_scale=center_scale, noise=noise,
                    n_banks=n_banks, mass_cdf=cdf.cpu().numpy(),
                    lam=lam.cpu().numpy()))


def synthetic_dataset_hard(nb: int = GEN, nq: int = 256, nt: int = GEN,
                           d: int = 64, seed: int = 42,
                           n_clusters: int = 16_384,
                           jitter: float = 0.35, device=None, **kw):
    """Host convenience wrapper (tests, small calibration runs): a
    ``Dataset`` drawn from the hard-mode stream on ``device``.  ``nb`` and
    ``nt`` round up to GEN and truncate, so small sets are prefixes of the
    at-scale stream."""
    from chamjax_torch.data.datasets import Dataset

    hc = make_hard_corpus(d=d, n_clusters=n_clusters, seed=seed,
                          device=device, **kw)
    nb_g = -(-nb // GEN) * GEN
    nt_g = -(-nt // GEN) * GEN
    xb = hc.draw_base(0, nb_g)[:nb].cpu().numpy()
    xt = hc.draw_train(0, nt_g)[:nt].cpu().numpy()
    xq = hc.queries(nq, jitter=jitter).cpu().numpy()
    return Dataset(name=f"HARD{nb}", xb=xb, xq=xq, xt=xt)
