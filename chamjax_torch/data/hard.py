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
generates ``GEN``-row chunks, each from a ``torch.Generator`` seeded by
(seed, salt, chunk start) on the draw's device, so a draw is identical
whatever the caller's chunking.  The stream is torch's, not JAX-PRNG: the
two packages draw different corpora from one seed, and on one seed a CPU
draw (MT19937) differs from a card draw (Philox).  The RNG-free parameters
— the Zipf mass CDF and the eigenvalue profile ``lam`` — are computed as
the JAX package computes them, in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from chamjax_torch.utils.device import resolve_device, seeded_generator
from chamjax_torch.utils.precision import fp32_matmul

GEN = 1 << 20     # generator granularity (rows); draws are identical
                  # regardless of the caller's chunking

# seed-sequence salts of the parameter draws (the JAX package splits its
# key four ways: centers, projection, banks, and one unused)
_CENTERS, _PROJ, _BANKS, _STREAM, _QUERIES = range(5)


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
    centers = torch.randn((n_clusters, d), generator=seeded_generator(
        dev, seed, _CENTERS), device=dev) * center_scale
    proj = torch.randn((rank, d), generator=seeded_generator(
        dev, seed, _PROJ), device=dev) / np.sqrt(rank)
    lam = torch.exp(-torch.arange(rank, dtype=torch.float32, device=dev)
                    / tau)
    lam = lam * torch.sqrt(rank / torch.sum(lam * lam))
    g_b = seeded_generator(dev, seed, _BANKS)
    perms = torch.stack([torch.randperm(rank, generator=g_b, device=dev)
                         for _ in range(n_banks)])
    lam_bank = lam[perms]                               # (n_banks, rank)
    w = (torch.arange(n_clusters, dtype=torch.float32, device=dev)
         + 1.0) ** (-zipf_a)
    cdf = torch.cumsum(w, 0) / torch.sum(w)

    @fp32_matmul()
    def gen(g: torch.Generator) -> torch.Tensor:
        u = torch.rand((GEN,), generator=g, device=dev)
        asg = torch.clamp(torch.searchsorted(cdf, u, side="left"),
                          max=n_clusters - 1)
        z = torch.randn((GEN, rank), generator=g, device=dev)
        z = z * lam_bank[asg % n_banks]
        eps = torch.randn((GEN, d), generator=g, device=dev) * noise
        return centers[asg] + torch.matmul(z, proj) + eps

    def make_draw(salt: int):
        def draw(s: int, c: int) -> torch.Tensor:
            if s % GEN or c % GEN or c <= 0:
                raise ValueError(f"hard-mode draws must align to GEN={GEN} "
                                 f"rows; got ({s}, {c})")
            parts = [gen(seeded_generator(dev, seed, _STREAM, salt, s + i))
                     for i in range(0, c, GEN)]
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        return draw

    draw_base = make_draw(1)
    draw_train = make_draw(2)

    def queries(nq: int, jitter: float = -1.0, salt: int = 3
                ) -> torch.Tensor:
        """Query set.  ``jitter < 0`` (default): independent draws from the
        same density (a fresh salted stream).  ``jitter >= 0``: corpus rows
        of the first GEN, drawn without replacement, plus Gaussian noise of
        ``jitter`` (the re-finding regime)."""
        if not 0 < nq <= GEN:
            raise ValueError(f"nq={nq} must be in 1..GEN={GEN}")
        if jitter < 0:
            return make_draw(3 + salt)(0, GEN)[:nq]
        g = seeded_generator(dev, seed, _QUERIES, salt)
        idx = torch.randperm(GEN, generator=g, device=dev)[:nq]
        eps = torch.randn((nq, d), generator=g, device=dev) * jitter
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
