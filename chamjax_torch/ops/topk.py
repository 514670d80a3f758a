"""Top-k selection (the port of ``chamjax/ops/topk.py``).

The JAX package's wide first stage is ``approx_min_k`` on the TPU; the
port selects exactly with ``torch.topk``, which is what JAX does off the
TPU.  ``use_approx``, ``recall_target`` and ``l1`` are accepted with the
same contracts; they cannot lower recall here.
"""

from __future__ import annotations

from typing import Tuple

import torch


def select_topk(
    dists: torch.Tensor,        # (b, n) — smaller is better
    k: int,
    use_approx: bool = True,
    recall_target: float = 0.99,
    l1: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k per row → ``(dists (b, k), positions (b, k) int32)``,
    nearest first.  When ``n < k`` the tail is padded with ``(+inf, 0)``."""
    n = dists.shape[-1]
    kk = min(k, n)
    vals, idx = torch.topk(dists, kk, dim=-1, largest=False, sorted=True)
    if kk < k:
        pad_shape = dists.shape[:-1] + (k - kk,)
        vals = torch.cat([vals, torch.full(pad_shape, float("inf"),
                                           dtype=vals.dtype,
                                           device=vals.device)], dim=-1)
        idx = torch.cat([idx, torch.zeros(pad_shape, dtype=idx.dtype,
                                          device=idx.device)], dim=-1)
    return vals, idx.to(torch.int32)


def merge_topk(
    d1: torch.Tensor, i1: torch.Tensor, d2: torch.Tensor, i2: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact merge of two candidate sets (the L2 queue)."""
    d = torch.cat([d1, d2], dim=-1)
    i = torch.cat([i1, i2], dim=-1)
    vals, pos = torch.topk(d, k, dim=-1, largest=False, sorted=True)
    return vals, torch.gather(i, -1, pos)
