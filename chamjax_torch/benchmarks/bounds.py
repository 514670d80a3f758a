"""The least time the card could take for a kernel's work, from the
inputs of one call: the bytes the function needs (each input byte it
depends on read once, each output byte written once) over the HBM rate,
against its operations over the card's rate for their type
(``perf_model.roofline_ms``): a scan's adds at the fp32 rate, the threefry
hash's integer operations at the integer rate.  Where the work depends
on the data (window lengths, repeated tiles or LUT rows), the count is
what these inputs need."""

from __future__ import annotations

from typing import Tuple

import torch

from chamjax_torch.perf_model import H100, GpuSpec, roofline_ms

LANES = 128


def tile_scan_bound(codes_tiled, tile_idx, lens, lut_idx, luts,
                    out_bytes: int, spec: GpuSpec = H100
                    ) -> Tuple[float, str]:
    """``adc_scan_tiles``: per referenced tile, the rows the longest window
    over it needs, x m; the distinct LUT rows; tile_idx, lens and lut_idx;
    the output."""
    m = codes_tiled.shape[1]
    active = lens > 0
    rows = torch.zeros(codes_tiled.shape[0], dtype=torch.int64,
                       device=lens.device)
    rows.scatter_reduce_(0, tile_idx[active].long(), lens[active].long(),
                         reduce="amax")
    code_bytes = int(rows.sum()) * m
    lut_rows = int(torch.unique(lut_idx[active]).numel())
    lut_bytes = lut_rows * luts.shape[1] * luts.shape[2] * 4
    nbytes = code_bytes + lut_bytes + 3 * 4 * tile_idx.numel() + out_bytes
    return roofline_ms(nbytes, int(lens.long().sum()) * m, spec)


def flat_scan_bound(codes_t, starts, lens, lut_rows, luts, *, width: int,
                    n_idx: int, out_bytes: int, spec: GpuSpec = H100
                    ) -> Tuple[float, str]:
    """The flat-layout scans: the distinct code columns the windows read
    (the union of ``[start, start + len)``, len cut at ``width`` and at
    the end of ``codes_t``) x m, the distinct LUT rows, ``n_idx`` int32
    index arrays of bW entries, the output."""
    m, n_cols = codes_t.shape
    s = starts.long()
    ln = torch.minimum(lens.long().clamp(max=width), n_cols - s).clamp(min=0)
    ln = torch.where(s < 0, torch.zeros_like(ln), ln)
    active = ln > 0
    one = torch.ones(int(active.sum()), dtype=torch.int64, device=s.device)
    diff = torch.zeros(n_cols + 1, dtype=torch.int64, device=s.device)
    diff.index_add_(0, s[active], one)
    diff.index_add_(0, (s + ln)[active], -one)
    cols = int((torch.cumsum(diff, 0)[:n_cols] > 0).sum())
    lut_rows_n = int(torch.unique(lut_rows[active]).numel())
    nbytes = (cols * m + lut_rows_n * luts.shape[1] * luts.shape[2] * 4
              + n_idx * 4 * starts.numel() + out_bytes)
    return roofline_ms(nbytes, int(ln.sum()) * m, spec)


def ablate_bound(debug_ablate: str, codes_tiled, tile_idx, out_bytes: int,
                 spec: GpuSpec = H100) -> Tuple[float, str]:
    """``adc_scan_tiles(debug_ablate=...)``: ``copy`` needs code row 0 of
    each distinct tile, ``nogather`` all m rows (and adds them); neither
    needs a LUT or lens."""
    n_t, m, seg = codes_tiled.shape
    tiles = int(torch.unique(tile_idx).numel())
    rows = 1 if debug_ablate == "copy" else m
    adds = 0 if debug_ablate == "copy" else tile_idx.numel() * seg * m
    return roofline_ms(tiles * rows * seg + 4 * tile_idx.numel() + out_bytes,
                       adds, spec)


def _union(starts: torch.Tensor, width: int) -> int:
    """Length of the union of ``[s, s + width)`` over ``starts``."""
    s = torch.sort(starts.long()).values
    return int(torch.clamp(s[1:] - s[:-1], max=width).sum()) + width


def variant_bound(variant: str, codes, starts, lut_idx, luts, *, seg: int,
                  out_bytes: int, spec: GpuSpec = H100) -> Tuple[float, str]:
    """The measurement variants of ``kernel_variants``: what each one's
    function depends on.  ``nosum`` needs code row 0 and LUT entries
    0..127 of row 0; ``dma_only`` code row 0 of each window's first 128
    columns and no LUT; ``nogather`` every code and no LUT;
    ``bf16_trim_nodma`` no code and word 0 of each LUT row's m sub-rows;
    ``i32codes`` reads 4 bytes a code; the rest every code (tiles for
    ``contig``/``block``) and whole LUT rows."""
    bw = starts.numel()
    tiled = variant.startswith(("contig", "block"))
    m = codes.shape[1] if tiled else codes.shape[0]
    rows_m = 1 if variant in ("nosum", "dma_only") else m
    width = LANES if variant == "dma_only" else seg
    if variant == "bf16_trim_nodma":
        code_bytes = 0
    elif tiled:
        code_bytes = int(torch.unique(starts // seg).numel()) * rows_m * seg
    else:
        elem = 4 if variant == "i32codes" else 1
        code_bytes = _union(starts, width) * rows_m * elem
    lut_row_bytes = {"nogather": 0, "dma_only": 0, "nosum": LANES * 4,
                     "bf16_trim_nodma": m * 4}.get(
                         variant, luts.shape[1] * luts.shape[2] * 4)
    lut_bytes = 0
    if lut_row_bytes:
        lut_bytes = (int(torch.unique(lut_idx).numel()) * lut_row_bytes
                     + 4 * bw)
    adds = 0 if variant in ("nosum", "dma_only") else bw * seg * m
    return roofline_ms(code_bytes + lut_bytes + 4 * bw + out_bytes, adds,
                       spec)


# threefry2x32 (csrc/threefry.cu) an output: each of its 20 rounds a funnel
# shift and an xor, and the closing bits1 ^ bits2, which only the integer
# pipe runs; an add each round, two at the start and two at each of the 5
# key injections, which the integer pipe or the FMA pipe (as IMAD) can run
THREEFRY_ROUNDS = 20
THREEFRY_INT_ONLY = 2 * THREEFRY_ROUNDS + 1
THREEFRY_ADDS = THREEFRY_ROUNDS + 2 + 2 * (THREEFRY_ROUNDS // 4)


def threefry_bound(n: int, out_bytes: int, spec: GpuSpec = H100
                   ) -> Tuple[float, str]:
    """A threefry draw of ``n`` outputs: ``out_bytes`` written (nothing is
    read) against the hash's integer instructions, which the function
    needs whatever the compiler emits: the integer pipe runs the rotations
    and xors, the adds go to whichever of the two 64-lane pipes (each at
    ``spec.int32_tops``) is less busy, so the busier one runs
    ``max(int_only, (int_only + adds) / 2)`` an output.  A float form adds
    work on other pipes, so this bounds every form from below."""
    per_output = max(THREEFRY_INT_ONLY,
                     (THREEFRY_INT_ONLY + THREEFRY_ADDS) / 2)
    return roofline_ms(out_bytes, n * per_output, spec,
                       tflops=spec.int32_tops)
