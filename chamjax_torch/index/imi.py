"""Inverted multi-index (IMI) coarse quantizer (the port of
``chamjax/index/imi.py``).

The coarse quantizer is the cartesian product of two 2^B-way
sub-quantizers, one per vector half (Faiss key ``"IMI2xB,PQm"``): nlist =
4^B cells from 2·2^B trained centroids.  A product centroid is
``c_(i,j) = [a_i ‖ b_j]``, so squared L2 splits per half,
``||x − c_(i,j)||² = ||x₁ − a_i||² + ||x₂ − b_j||²``, and both assignment
(two small argmins) and the coarse scan (two small fp32 GEMMs plus a
broadcast add) are factored.  Downstream (packing, LUTs, the scans) sees
ordinary materialised centroids.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from chamjax_torch.index.kmeans import kmeans
from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul


def train_imi(xt, bits: int, iters: int = 15, seed: int = 0, device=None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Train the two half-space codebooks ``(a (2^bits, d/2), b (...))``."""
    xt = np.ascontiguousarray(xt, np.float32)
    d = xt.shape[1]
    if d % 2:
        raise ValueError(f"IMI needs an even dim, got {d}")
    h = d // 2
    k = 1 << bits
    cents_a = kmeans(xt[:, :h], k, iters=iters, seed=seed, device=device)
    cents_b = kmeans(xt[:, h:], k, iters=iters, seed=seed + 1,
                     device=device)
    return cents_a, cents_b


def imi_centroids(cents_a: np.ndarray, cents_b: np.ndarray) -> np.ndarray:
    """Materialise the product grid ``(K², d)``: row i·K+j = [a_i ‖ b_j]."""
    k, h = cents_a.shape
    grid_a = np.repeat(cents_a, k, axis=0)          # (K², h)
    grid_b = np.tile(cents_b, (k, 1))               # (K², h)
    return np.concatenate([grid_a, grid_b], axis=1).astype(np.float32)


def _half_assign(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    cn = torch.sum(cents * cents, dim=1)
    scores = 2.0 * torch.matmul(x, cents.T) - cn[None]
    return torch.argmax(scores, dim=1)


@fp32_matmul()
def assign_imi(x, cents_a, cents_b, chunk: int = 1 << 18, device=None
               ) -> np.ndarray:
    """Factored assignment: cell id = argmin_a · K + argmin_b, as ``(n,)``
    int64 numpy."""
    dev = resolve_device(device)
    x = np.ascontiguousarray(x, np.float32)
    k, h = cents_a.shape
    ca, cb = as_f32(cents_a, dev), as_f32(cents_b, dev)
    out = np.empty(x.shape[0], np.int64)
    for s in range(0, x.shape[0], chunk):
        xs = as_f32(x[s:s + chunk], dev)
        ia = _half_assign(xs[:, :h], ca)
        ib = _half_assign(xs[:, h:], cb)
        out[s:s + xs.shape[0]] = (ia * k + ib).cpu().numpy()
    return out


@fp32_matmul()
def coarse_scan_imi(
    queries: torch.Tensor,   # (b, d) float32
    cents_a: torch.Tensor,   # (K, d/2) float32
    cents_b: torch.Tensor,   # (K, d/2) float32
    nprobe: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factored IMI coarse scan → ``(list_ids (b, nprobe) int32, dists)``,
    nearest first, true squared L2: the contract of ``ops.coarse`` over the
    materialised grid, for two (b, K, d/2) GEMMs and a (b, K, K) add."""
    k, h = cents_a.shape
    qa, qb = queries[:, :h], queries[:, h:]
    da = (torch.sum(qa * qa, dim=1, keepdim=True)
          - 2.0 * torch.matmul(qa, cents_a.T)
          + torch.sum(cents_a * cents_a, dim=1)[None])      # (b, K)
    db = (torch.sum(qb * qb, dim=1, keepdim=True)
          - 2.0 * torch.matmul(qb, cents_b.T)
          + torch.sum(cents_b * cents_b, dim=1)[None])      # (b, K)
    full = (da[:, :, None] + db[:, None, :]).reshape(queries.shape[0], k * k)
    neg, idx = torch.topk(-full, nprobe, dim=1)
    return idx.to(torch.int32), -neg
