"""Segmented-scan helpers (the port of the layout helpers of
``chamjax/ops/scan_seg.py``).

Every inverted list is viewed as ``ceil(len/seg)`` uniform seg-row
*windows*; a query's probed lists expand into a flat, probe-major window
table padded/truncated to a static budget ``W``.  The LUTs move from the
``build_luts``' ``(b, nprobe, ksub, m)`` layout to the scan kernel's
``(b·nprobe, m, ksub)`` (or packed-bf16 ``(b·nprobe, m, 128)`` int32)
layout here only.  The flat-layout kernel ``adc_scan_segments`` is not
ported yet.
"""

from __future__ import annotations

import sys
from typing import Tuple

import torch

LANES = 128
SEG = 1024            # default rows per window
MAX_SEG = 4096        # DeviceIVF overread padding covers any seg <= this

# Window cost model constant of the JAX package's ``auto_seg``: every
# window costs a fixed ~2048 row-slots on top of its seg rows.  Kept as is
# so both packages choose the same seg; it has not been re-measured on a
# GPU.
WINDOW_FIXED_ROWS = 2048


def pack_luts_bf16(luts: torch.Tensor) -> torch.Tensor:
    """(..., m, 256) f32 LUTs → (..., m, 128) int32, entries (2c, 2c+1)
    packed as one bf16 pair: bf16(2c) in the low half, bf16(2c+1) in the
    high half.  Rounding is float32 → bfloat16 round-to-nearest-even;
    bit-identical to ``chamjax.ops.scan_seg.pack_luts_bf16``.

    On a little-endian machine two neighbouring bf16 values already are
    that int32 in memory, so the packing is a rounding and a view."""
    if sys.byteorder != "little":
        raise RuntimeError("pack_luts_bf16 assumes a little-endian machine")
    return luts.to(torch.bfloat16).contiguous().view(torch.int32)


def prepare_luts(luts: torch.Tensor, probe: torch.Tensor, *,
                 lut_bf16: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, nprobe, ksub, m) LUTs + (b, W) window→probe map →
    ``(luts_k (b·nprobe, m, ksub|128), lut_idx (b·W,) int32)`` in the
    kernel's layout."""
    b, nprobe, ksub, m = luts.shape
    lut_idx = (torch.arange(b, dtype=torch.int32, device=luts.device)[:, None]
               * nprobe + probe).reshape(-1).to(torch.int32)
    luts_k = luts.permute(0, 1, 3, 2).reshape(b * nprobe, m, ksub)
    if lut_bf16:
        luts_k = pack_luts_bf16(luts_k)
    return luts_k.contiguous(), lut_idx


def expand_windows(
    list_ids: torch.Tensor,     # (b, nprobe) int32 — probed cells, rank order
    list_start: torch.Tensor,   # (nlist,) int32
    list_len: torch.Tensor,     # (nlist,) int32
    *,
    windows: int,               # W — static per-query window budget
    seg: int = SEG,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe list → flat window table (probe-major, trailing pads len=0).

    Returns ``(starts (b,W) int32, lens (b,W) int32, probe (b,W) int32,
    valid (b,W) bool)``.
    """
    b, nprobe = list_ids.shape
    lid_all = list_ids.long()
    lens_all = list_len.long()
    seg_cnt = (lens_all[lid_all] + seg - 1) // seg               # (b, nprobe)
    off = torch.cumsum(seg_cnt, dim=1)                           # inclusive
    w = torch.arange(windows, device=list_ids.device)
    # searchsorted(off, w, 'right') as a broadcast compare-count
    probe = torch.sum(w[None, None, :] >= off[:, :, None], dim=1)
    valid = w[None, :] < off[:, -1:]
    probe_c = torch.clamp(probe, max=nprobe - 1)
    prev = torch.gather(off, 1, torch.clamp(probe_c - 1, min=0))
    base = torch.where(probe_c > 0, prev, torch.zeros_like(prev))
    seg_within = w[None, :] - base
    lid = torch.gather(lid_all, 1, probe_c)
    starts = list_start.long()[lid] + seg_within * seg
    lens = torch.clamp(lens_all[lid] - seg_within * seg, 0, seg)
    zero = torch.zeros_like(lens)
    lens = torch.where(valid, lens, zero).to(torch.int32)
    starts = torch.where(valid, starts, zero).to(torch.int32)
    return starts, lens, probe_c.to(torch.int32), valid
