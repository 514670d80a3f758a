"""Inverted-list ADC scan in plain torch — the port's independent oracle
backend (the port of ``chamjax/ops/scan_xla.py``).

For each (query, probe) pair it reads a fixed ``scan_len`` window of codes
from the probed list's start, accumulates ``dist = Σ_m LUT[m][code_m]``
with one gather and a sum, masks rows outside the list to +inf and keeps a
running top-k over probe chunks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from chamjax_torch.ops.topk import merge_topk, select_topk


def scan_lists_xla(
    codes_t: torch.Tensor,      # (m, n_pad) uint8 — transposed packed codes
    ids: torch.Tensor,          # (n_pad,) int32, -1 = padding
    list_start: torch.Tensor,   # (nlist,) int32
    list_len: torch.Tensor,     # (nlist,) int32
    luts: torch.Tensor,         # (b, nprobe, ksub, m) float32
    list_ids: torch.Tensor,     # (b, nprobe) int32
    *,
    scan_len: int,
    probe_chunk: int,
    k: int,
    use_approx: bool = True,
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(dists (b, k) f32, ids (b, k) int32)``; unfilled slots are
    (+inf, -1)."""
    b, nprobe = list_ids.shape
    m, n_pad = codes_t.shape
    dev = codes_t.device
    pc = min(probe_chunk, nprobe)
    pos = torch.arange(scan_len, device=dev)
    best_d = torch.full((b, k), float("inf"), device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for p0 in range(0, nprobe, pc):
        lids = list_ids[:, p0:p0 + pc].long()               # (b, c)
        lut_c = luts[:, p0:p0 + pc]                         # (b, c, ksub, m)
        starts = list_start.long()[lids]
        lens = list_len.long()[lids]
        # A window that would run past the packed tail is moved back to fit
        # and its valid mask shifted by the same delta, so a short list
        # near the tail never scores earlier lists' rows as its own.
        s_cl = torch.clamp(starts, 0, max(n_pad - scan_len, 0))
        delta = starts - s_cl
        rows = s_cl[:, :, None] + pos                       # (b, c, L)
        w_codes = codes_t[:, rows].permute(1, 2, 3, 0).long()   # (b,c,L,m)
        contrib = torch.gather(lut_c, 2, w_codes)           # (b, c, L, m)
        dist = contrib.sum(dim=-1)                          # (b, c, L)
        valid = ((pos >= delta[:, :, None])
                 & (pos < (delta + lens)[:, :, None]))
        dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
        flat_d = dist.reshape(b, -1)
        flat_i = ids[rows].reshape(b, -1)
        cd, cpos = select_topk(flat_d, k, use_approx=use_approx,
                               recall_target=recall_target)
        ci = torch.gather(flat_i, 1, cpos.long())
        ci = torch.where(torch.isfinite(cd), ci, torch.full_like(ci, -1))
        best_d, best_i = merge_topk(best_d, best_i, cd, ci, k)
    return best_d, best_i
