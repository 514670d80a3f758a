"""Padded-window ADC scan: one window of ``scan_len`` rows per (query,
probe) from the probed list's start (the port of
``chamjax/ops/scan_pallas.py``, named like it so a reader finds the
counterpart; on the card it is a CUDA kernel, not Pallas).

``adc_scan_distances`` launches ``csrc/adc_scan_flat.cu`` on CUDA tensors
with LUT row ``p`` for window ``p``; CPU tensors run its plain version.  The
TPU kernel's ``(bp, groups, 8, 128)`` output slab is a Mosaic layout whose
reshape is the natural row order, so the kernel writes ``(bp, scan_len)``
directly.  Rows past a list's length read nothing and score +inf.
"""

from __future__ import annotations

from typing import Tuple

import torch

from chamjax_torch.ops.scan_seg import (check_flat_inputs,
                                        flat_scan_reference, launch_flat,
                                        select_rows)

GROUP = 1024          # rows per output slab of the TPU kernel: scan_len unit


def resolve_chunk(scan_len: int, chunk: int) -> int:
    """The JAX package's DMA chunk rule: ``chunk`` if it divides
    ``scan_len`` and is a ``GROUP`` multiple, else the largest of 4096,
    2048, 1024 that divides it; never above ``scan_len``.  The CUDA kernel
    reads only rows below each list's length, so it takes no chunk; the
    rule picks ``IVFSearcher.tile`` so both packages carry the same
    arguments."""
    if chunk <= 0 or scan_len % chunk or chunk % GROUP:
        chunk = GROUP
        for c in (4096, 2048):
            if scan_len % c == 0:
                chunk = c
                break
    return min(chunk, scan_len)


def adc_scan_distances_reference(codes_t, starts, lens, luts, *,
                                 scan_len: int) -> torch.Tensor:
    """Plain version of :func:`adc_scan_distances` (same contract)."""
    rows = torch.arange(starts.shape[0], dtype=torch.int32,
                        device=starts.device)
    return flat_scan_reference(codes_t, starts, lens, rows, luts,
                               width=scan_len)


def adc_scan_distances(
    codes_t: torch.Tensor,      # (m, n_pad) uint8 — transposed packed codes
    starts: torch.Tensor,       # (bp,) int32 — window start column
    lens: torch.Tensor,         # (bp,) int32 — valid rows per window
    luts: torch.Tensor,         # (bp, m, 256) float32
    *,
    scan_len: int,
    chunk: int = 2048,
) -> torch.Tensor:
    """Returns ``dists (bp, scan_len) float32`` (+inf past each window's
    length).  ``scan_len`` must be a multiple of ``GROUP``; ``starts``
    need no alignment.  ``chunk`` is the TPU kernel's DMA slab
    (:func:`resolve_chunk`), accepted and not needed here.  CPU tensors
    run :func:`adc_scan_distances_reference`; CUDA tensors launch the
    kernel (or raise)."""
    what = "adc_scan_distances"
    if scan_len <= 0 or scan_len % GROUP:
        raise ValueError(f"{what}: scan_len {scan_len} must be a positive "
                         f"multiple of {GROUP}")
    check_flat_inputs(what, codes_t, starts, lens, None, luts,
                      lut_bf16=False)
    bp = starts.shape[0]
    if luts.shape[0] != bp:
        raise ValueError(f"{what}: luts has {luts.shape[0]} rows for "
                         f"{bp} windows (one LUT per window)")
    if codes_t.device.type == "cpu":
        return adc_scan_distances_reference(codes_t, starts, lens, luts,
                                            scan_len=scan_len)
    out = torch.empty((bp, scan_len), dtype=torch.float32,
                      device=codes_t.device)
    if bp:
        launch_flat(what, codes_t, starts, lens, None, luts, out, bp,
                    codes_t.shape[0], scan_len)
    return out


def scan_lists_pallas(
    codes_t: torch.Tensor,      # (m, n_pad) uint8
    ids: torch.Tensor,          # (n_pad,) int32
    list_start: torch.Tensor,   # (nlist,) int32
    list_len: torch.Tensor,     # (nlist,) int32
    luts: torch.Tensor,         # (b, nprobe, ksub, m) float32
    list_ids: torch.Tensor,     # (b, nprobe) int32
    *,
    scan_len: int,
    tile: int = 2048,
    k: int,
    use_approx: bool = True,
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full scan + selection → ``(dists (b, k) f32, ids (b, k) int32)``."""
    b, nprobe, ksub, m = luts.shape
    lid = list_ids.long()
    starts = list_start[lid]                            # (b, nprobe)
    lens = torch.clamp(list_len[lid], max=scan_len)
    luts_k = luts.permute(0, 1, 3, 2).reshape(b * nprobe, m, ksub)
    dists = adc_scan_distances(
        codes_t, starts.reshape(-1).contiguous(),
        lens.reshape(-1).contiguous(), luts_k.contiguous(),
        scan_len=scan_len, chunk=tile)
    return select_rows(dists.reshape(b, nprobe * scan_len), starts, ids,
                       k=k, width=scan_len, use_approx=use_approx,
                       recall_target=recall_target)
