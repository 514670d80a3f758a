"""Multi-window segmented ADC scan over the flat code layout (the port of
``chamjax/ops/scan_seg_multi.py``).

On the TPU this variant handles ``group`` windows per grid step to amortise
the fixed cost of a step.  On the card every window is one launch block of
``csrc/adc_scan_flat.cu`` either way, so ``group`` only keeps the JAX
package's contract: ``bW % group == 0``, and ``W`` rounded up to a
multiple of it.  Windows stay in probe-major order (no slot-major
permutation on this route), so tie order stays comparable with chamjax.
"""

from __future__ import annotations

from typing import Tuple

import torch

from chamjax_torch.ops.scan_seg import (LANES, check_flat_inputs, check_seg,
                                        expand_windows, flat_scan_reference,
                                        launch_flat, prepare_luts,
                                        select_rows, select_rows_lane_l1)
from chamjax_torch.utils import tracing


def adc_scan_segments_multi_reference(codes_t, starts, lens, lut_idx, luts,
                                      *, seg: int, lut_bf16: bool = False,
                                      lane_l1: bool = False) -> torch.Tensor:
    """Plain version of :func:`adc_scan_segments_multi` (same contract)."""
    return flat_scan_reference(codes_t, starts, lens, lut_idx, luts,
                               width=seg, lut_bf16=lut_bf16, lane_l1=lane_l1)


def adc_scan_segments_multi(
    codes_t: torch.Tensor,      # (m, n_pad_seg) uint8 — MAX_SEG-padded
    starts: torch.Tensor,       # (bW,) int32 — bW % group == 0
    lens: torch.Tensor,         # (bW,) int32
    lut_idx: torch.Tensor,      # (bW,) int32
    luts: torch.Tensor,         # (n_lut, m, 256) f32 | (n_lut, m, 128) i32
    *,
    seg: int,
    group: int = 4,
    lut_bf16: bool = False,
    lane_l1: bool = False,
) -> torch.Tensor:
    """Returns ``dists (bW, seg) float32`` (+inf on padding/skips), or with
    ``lane_l1`` ``(bW, 2, 128) float32``: row 0 the per-lane min over the
    window's row groups, row 1 the winning group index (int32 bits; read
    it with ``.view(torch.int32)``).

    CPU tensors run :func:`adc_scan_segments_multi_reference`; CUDA
    tensors launch ``adc_scan_flat.cu`` (or raise)."""
    what = "adc_scan_segments_multi"
    check_seg(what, seg)
    check_flat_inputs(what, codes_t, starts, lens, lut_idx, luts,
                      lut_bf16=lut_bf16)
    bw = starts.shape[0]
    if group < 1 or bw % group:
        raise ValueError(f"{what}: bW={bw} not a multiple of group={group}")
    if codes_t.device.type == "cpu":
        return adc_scan_segments_multi_reference(
            codes_t, starts, lens, lut_idx, luts, seg=seg, lut_bf16=lut_bf16,
            lane_l1=lane_l1)
    shape = (bw, 2, LANES) if lane_l1 else (bw, seg)
    out = torch.empty(shape, dtype=torch.float32, device=codes_t.device)
    if bw:
        launch_flat(what, codes_t, starts, lens, lut_idx, luts, out, bw,
                    codes_t.shape[0], seg, int(lut_bf16), int(lane_l1))
    return out


def scan_lists_seg_multi(
    codes_t: torch.Tensor,      # (m, n_pad_seg) uint8
    ids: torch.Tensor,          # (n_pad_seg,) int32
    list_start: torch.Tensor,   # (nlist,) int32
    list_len: torch.Tensor,     # (nlist,) int32
    luts: torch.Tensor,         # (b, nprobe, ksub, m) float32
    list_ids: torch.Tensor,     # (b, nprobe) int32
    *,
    windows: int,
    seg: int,
    group: int = 4,
    k: int,
    use_approx: bool = True,
    recall_target: float = 0.99,
    lut_bf16: bool = False,
    select_l1: int = 0,
    lane_l1: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented multi-window scan + selection → ``(dists (b, k) f32,
    ids (b, k))``.  ``lane_l1``: the kernel reduces each (window, lane)
    bucket of ``seg/128`` rows to its min, so selection runs over
    ``W·128`` candidates instead of ``W·seg``; two true top-k rows in one
    bucket keep only the better."""
    b = luts.shape[0]
    windows = -(-windows // group) * group      # round W up to group multiple
    with tracing.annotate("search.windows"):
        starts, lens, probe, _valid = expand_windows(
            list_ids, list_start, list_len, windows=windows, seg=seg)
    with tracing.annotate("search.pack"):
        luts_k, lut_idx = prepare_luts(luts, probe, lut_bf16=lut_bf16)
    with tracing.annotate("search.scan"):
        dists = adc_scan_segments_multi(
            codes_t, starts.reshape(-1), lens.reshape(-1), lut_idx, luts_k,
            seg=seg, group=group, lut_bf16=lut_bf16, lane_l1=lane_l1)
    sel = dict(k=k, use_approx=use_approx, recall_target=recall_target,
               select_l1=select_l1)
    if lane_l1:
        return select_rows_lane_l1(dists, starts, ids, **sel)
    return select_rows(dists.reshape(b, windows * seg), starts, ids,
                       width=seg, **sel)
