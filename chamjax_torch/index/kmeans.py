"""K-means: Lloyd iterations with fp32 matmul assignment and an
``index_add_`` update (the port of ``chamjax/index/kmeans.py``).

Data is streamed to the device in fixed-size chunks; empty clusters are
re-seeded from heavy ones.  k-means++ seeding draws the JAX package's
threefry streams (``chamjax_torch.random``), so both packages seed the same
centroids from the same sample and seed.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from chamjax_torch import random as jr
from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul


def _scores(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """``2 x·c - ||c||²`` = ``||x||² - ||x - c||²`` (larger is nearer)."""
    cn = torch.sum(cent * cent, dim=1)
    return 2.0 * torch.matmul(x, cent.T) - cn[None, :]


def _assign_chunk(x: torch.Tensor, cent: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid per row → (assignment (n,) int64, min_dist (n,))."""
    scores = _scores(x, cent)
    best, a = torch.max(scores, dim=1)
    xn = torch.sum(x * x, dim=1)
    return a, xn - best


def _cap_chunk(chunk: int, k: int) -> int:
    """Bound the (chunk, k) score matrix to ~1 GB f32."""
    return max(4096, min(chunk, (1 << 28) // max(k, 1)))


@fp32_matmul()
def assign(x, centroids, chunk: int = 1 << 18, device=None) -> np.ndarray:
    """Chunked nearest-centroid assignment → ``(n,) int32`` numpy."""
    dev = resolve_device(device)
    cent = as_f32(centroids, dev)
    chunk = _cap_chunk(chunk, centroids.shape[0])
    out = np.empty((x.shape[0],), np.int32)
    for i in range(0, x.shape[0], chunk):
        xi = as_f32(x[i:i + chunk], dev)
        out[i:i + xi.shape[0]] = _assign_chunk(xi, cent)[0].cpu().numpy()
    return out


def _topc_chunk(x: torch.Tensor, cent: torch.Tensor, c: int):
    vals, idx = torch.topk(_scores(x, cent), c, dim=1, largest=True,
                           sorted=True)
    return idx, -vals        # (n, c) ids, partial distances


def _place(rows, cands, counts, cap, out) -> None:
    """Greedy capacity pass: each row takes its first candidate with room."""
    for row, cs in zip(rows, cands):
        for cl in cs:
            if counts[cl] < cap:
                out[row] = cl
                counts[cl] += 1
                break


@fp32_matmul()
def assign_balanced(
    x,
    centroids,
    cap: Optional[int] = None,
    n_cand: int = 8,
    chunk: int = 1 << 18,
    hard: bool = False,
    device=None,
) -> np.ndarray:
    """Capacity-constrained assignment: each point goes to its nearest
    centroid *with room*, among its ``n_cand`` nearest.

    Points are placed confident-first (stable argsort of the best
    distance).  The top-``n_cand`` candidate search runs on the device; the
    greedy capacity loop runs on the host, as in the JAX package.

    - ``hard=False``: overflow rows go to their nearest cell (soft cap).
    - ``hard=True``: overflow retries with a widening candidate list; since
      k·cap ≥ n there is always a cell with room, so the cap is exact.
    """
    dev = resolve_device(device)
    n = x.shape[0]
    k = centroids.shape[0]
    if cap is None:
        cap = int(np.ceil(n / k * 1.3))
    if hard and k * cap < n:
        raise ValueError(
            f"assign_balanced(hard=True): infeasible cap — k*cap = "
            f"{k}*{cap} = {k * cap} < n = {n}; every cell fills before "
            f"all points are placed. Raise cap (balance_factor ≥ 1.0) "
            f"or nlist.")
    cent = as_f32(centroids, dev)
    chunk = _cap_chunk(chunk, k)
    n_cand = min(n_cand, k)
    cand = np.empty((n, n_cand), np.int32)
    best_d = np.empty((n,), np.float32)
    for i in range(0, n, chunk):
        xi = as_f32(x[i:i + chunk], dev)
        ids, dd = _topc_chunk(xi, cent, n_cand)
        cand[i:i + xi.shape[0]] = ids.cpu().numpy()
        best_d[i:i + xi.shape[0]] = dd[:, 0].cpu().numpy()
    order = np.argsort(best_d, kind="stable")
    counts = [0] * k
    out = np.full(n, -1, np.int32)
    _place(order.tolist(), cand[order].tolist(), counts, cap, out)
    overflow = int((out < 0).sum())
    if not hard:
        if overflow:
            warnings.warn(
                f"assign_balanced: {overflow}/{n} points overflowed all "
                f"{n_cand} candidate cells and fell back to their nearest "
                f"cell — the cap ({cap}) is soft and max list size may "
                f"exceed it. Pass hard=True / IndexConfig.balance_hard "
                f"for an exact cap.", stacklevel=3)
            rows = np.flatnonzero(out < 0)
            out[rows] = cand[rows, 0]
        return out
    if overflow > max(1, n // 200):
        warnings.warn(
            f"assign_balanced(hard=True): {overflow}/{n} points "
            f"({100.0 * overflow / n:.1f}%) overflowed all {n_cand} "
            f"nearest cells — the cap ({cap}) binds against natural "
            f"cluster sizes and hard displacement at this rate costs "
            f"recall. Raise balance_factor or nlist.", stacklevel=3)
    # Widening retry for the unplaced rows: each round quadruples the
    # candidate width; at width == k every cell is seen and k·cap ≥ n
    # guarantees one has room.
    width = n_cand
    while width < k and (out < 0).any():
        width = min(width * 4, k)
        rows = np.flatnonzero(out < 0)
        rchunk = _cap_chunk(chunk, max(width, k))
        for i in range(0, rows.size, rchunk):
            ri = rows[i:i + rchunk]
            xi = as_f32(x[ri], dev)
            ids = _topc_chunk(xi, cent, width)[0].cpu().numpy()
            _place(ri.tolist(), ids.tolist(), counts, cap, out)
    if (out < 0).any():
        raise RuntimeError("assign_balanced: capacity accounting bug")
    return out


def _kmeanspp_init(x: torch.Tensor, k: int, key: jr.Key) -> torch.Tensor:
    """k-means++ (D²-sampling) seeding, the JAX package's draws: the first
    centre ``randint(key, (), 0, n)``, centre ``i`` the argmax of
    ``log(D²) + gumbel(fold_in(key, i))`` (the Gumbel-max trick,
    ``random.gumbel_argmax``: on a card one fused launch a step, the index
    left on the card, so no step waits on the host)."""
    n, d = x.shape
    key = jr.as_key(key)
    first = jr.randint(key, (), 0, n, device=x.device)
    c = x.index_select(0, first.reshape(1).long())
    min_d = torch.sum((x - c) ** 2, dim=1)
    cents = torch.empty((k, d), dtype=x.dtype, device=x.device)
    cents[0] = c[0]
    scratch = jr.argmax_scratch(x.device)
    for i in range(1, k):
        idx = jr.gumbel_argmax(key, i, min_d, scratch=scratch)
        c = x.index_select(0, idx.reshape(1))
        cents[i] = c[0]
        min_d = torch.minimum(min_d, torch.sum((x - c) ** 2, dim=1))
    return cents


@fp32_matmul()
def kmeans(
    x,
    k: int,
    iters: int = 15,
    seed: int = 0,
    chunk: int = 1 << 18,
    init_sample: int = 1 << 17,
    verbose: bool = False,
    device=None,
) -> np.ndarray:
    """Lloyd k-means with k-means++ seeding. Returns centroids ``(k, d)``
    float32 numpy.

    Deterministic given (x, k, iters, seed, device).  Seeding runs on a
    subsample of ``init_sample`` points (chosen with numpy, as in the JAX
    package); empty clusters are re-seeded from the heaviest cluster's
    centroid plus a small deterministic jitter.
    """
    dev = resolve_device(device)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    if k >= n:
        cent = as_f32(x, dev)
        pad = torch.from_numpy(
            rng.standard_normal((k - n, d)).astype(np.float32)).to(dev)
        cent_dev = torch.cat([cent, pad], dim=0)
    else:
        if n <= init_sample:
            sample = as_f32(x, dev)
        else:
            sel = np.sort(rng.choice(n, size=init_sample, replace=False))
            sample = as_f32(x[sel] if not isinstance(x, torch.Tensor)
                            else x[torch.from_numpy(sel).to(x.device)], dev)
        cent_dev = _kmeanspp_init(sample, k, jr.key(seed))

    chunk = _cap_chunk(chunk, k)
    for it in range(iters):
        sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((k,), dtype=torch.float32, device=dev)
        sse = torch.zeros((), dtype=torch.float64, device=dev)
        for i in range(0, n, chunk):
            xi = as_f32(x[i:i + chunk], dev)
            a, dmin = _assign_chunk(xi, cent_dev)
            sums.index_add_(0, a, xi)
            counts.index_add_(0, a, torch.ones_like(dmin))
            sse += dmin.sum(dtype=torch.float64)
        counts_np = counts.cpu().numpy()
        new_cent = sums.cpu().numpy() / np.maximum(counts_np, 1.0)[:, None]
        empty = np.where(counts_np == 0)[0]
        if empty.size:
            heavy = np.argsort(-counts_np)[:empty.size]
            jitter = rng.standard_normal((empty.size, d)).astype(np.float32)
            scale = (np.abs(new_cent[heavy]).mean(axis=1, keepdims=True)
                     * 1e-3 + 1e-6)
            new_cent[empty] = new_cent[heavy] + jitter * scale
        cent_dev = torch.from_numpy(new_cent.astype(np.float32)).to(dev)
        if verbose:
            print(f"kmeans iter {it}: sse={float(sse):.4e} "
                  f"empty={empty.size}", flush=True)
    return cent_dev.cpu().numpy()
