"""Segmented ADC scan over the seg-tiled code layout (the port of
``chamjax/ops/scan_seg_block.py``).

Codes are stored seg-tiled, ``(n_tiles, m, seg)`` with every inverted list
starting on a tile boundary, so a window is one contiguous ``m·seg``-byte
tile.  ``adc_scan_tiles`` scores a batch of windows: on a CUDA tensor it
launches the hand-written kernel ``chamjax_torch/csrc/adc_scan_tiles.cu``;
on a CPU tensor it runs the plain version ``adc_scan_tiles_reference``.
Its ``debug_ablate`` bodies (``copy``, ``nogather``) are the measurement
bodies of ``chamjax_torch/benchmarks/kernel_roofline.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from chamjax_torch.ops.scan_seg import (LANES, adc_windows_reference,
                                        expand_windows, prepare_luts,
                                        select_rows, select_rows_lane_l1)
from chamjax_torch.utils import cuda_lib, tracing

_OUT_F32, _OUT_BF16, _OUT_LANE_L1 = 0, 1, 2
# debug_ablate body → the kernel's ``body`` argument
_BODIES = {"": 0, "copy": 1, "nogather": 2}


def adc_scan_tiles_reference(
    codes_tiled: torch.Tensor,  # (n_tiles, m, seg) uint8
    tile_idx: torch.Tensor,     # (bW,) int32
    lens: torch.Tensor,         # (bW,) int32
    lut_idx: torch.Tensor,      # (bW,) int32
    luts: torch.Tensor,         # (n_lut, m, 256) f32 | (n_lut, m, 128) i32
    *,
    seg: int,
    lut_bf16: bool = False,
    lane_l1: bool = False,
    dist_bf16: bool = False,
    debug_ablate: str = "",
) -> torch.Tensor:
    """Plain version of the kernel: a gather, a sum over m in fp32 and a
    mask; for ``debug_ablate`` the first code row (``copy``) or the sum of
    the codes over m (``nogather``), lens ignored.  Same contract as
    :func:`adc_scan_tiles`."""
    if debug_ablate:
        tiles = codes_tiled[tile_idx.long()]
        dist = (tiles[:, 0] if debug_ablate == "copy"
                else tiles.sum(dim=1, dtype=torch.int32)).float()
        return dist.to(torch.bfloat16) if dist_bf16 else dist
    dist = adc_windows_reference(
        codes_tiled[tile_idx.long()], luts[lut_idx.long()], lens,
        lut_bf16=lut_bf16, lane_l1=lane_l1)
    return dist.to(torch.bfloat16) if dist_bf16 and not lane_l1 else dist


def _check_inputs(codes_tiled, tile_idx, lens, lut_idx, luts, *, seg, group,
                  lut_bf16, lane_l1, dist_bf16, debug_ablate) -> None:
    if debug_ablate not in _BODIES:
        raise ValueError(f"adc_scan_tiles: debug_ablate={debug_ablate!r}, "
                         f"one of 'copy', 'nogather' or ''")
    if debug_ablate and lane_l1:
        raise ValueError("adc_scan_tiles: debug_ablate writes (bW, seg) "
                         "rows, which the lane_l1 output (bW, 2, 128) does "
                         "not hold")
    if lane_l1 and dist_bf16:
        raise ValueError("adc_scan_tiles: lane_l1 and dist_bf16 exclude "
                         "each other (lane_l1 carries int32 bits through "
                         "an f32 output)")
    if codes_tiled.dim() != 3 or luts.dim() != 3:
        raise ValueError("adc_scan_tiles: codes_tiled and luts must be 3-D")
    _n_tiles, m, seg_t = codes_tiled.shape
    _n_lut, m2, ksub = luts.shape
    bw = tile_idx.shape[0]
    if seg_t != seg or seg % LANES:
        raise ValueError(f"adc_scan_tiles: tile width {seg_t} vs seg={seg} "
                         f"(must match and be a multiple of {LANES})")
    if m2 != m or ksub != (128 if lut_bf16 else 256):
        raise ValueError(f"adc_scan_tiles: luts {tuple(luts.shape)} do not "
                         f"fit m={m}, lut_bf16={lut_bf16} (8-bit PQ only)")
    if bw % group:
        raise ValueError(f"adc_scan_tiles: bW={bw} not a multiple of "
                         f"group={group}")
    if lens.shape != (bw,) or lut_idx.shape != (bw,) or tile_idx.dim() != 1:
        raise ValueError("adc_scan_tiles: tile_idx, lens, lut_idx must be "
                         "(bW,) each")
    want = {"codes_tiled": (codes_tiled, torch.uint8),
            "tile_idx": (tile_idx, torch.int32),
            "lens": (lens, torch.int32),
            "lut_idx": (lut_idx, torch.int32),
            "luts": (luts, torch.int32 if lut_bf16 else torch.float32)}
    for name, (t, dt) in want.items():
        if t.dtype != dt:
            raise ValueError(f"adc_scan_tiles: {name} is {t.dtype}, "
                             f"needs {dt}")
        if t.device != codes_tiled.device:
            raise ValueError(f"adc_scan_tiles: {name} on {t.device}, codes "
                             f"on {codes_tiled.device}")


def adc_scan_tiles(
    codes_tiled: torch.Tensor,  # (n_tiles, m, seg) uint8 — tile-major
    tile_idx: torch.Tensor,     # (bW,) int32 — tile row per window
    lens: torch.Tensor,         # (bW,) int32 — valid rows (0 = skip)
    lut_idx: torch.Tensor,      # (bW,) int32
    luts: torch.Tensor,         # (n_lut, m, 256) f32 | (n_lut, m, 128) i32
    *,
    seg: int,
    group: int = 8,
    lut_bf16: bool = False,
    lane_l1: bool = False,
    dist_bf16: bool = False,
    debug_ablate: str = "",
) -> torch.Tensor:
    """Returns ``dists (bW, seg) float32`` (+inf on padding/skips),
    bfloat16 with ``dist_bf16``, or with ``lane_l1`` ``(bW, 2, 128)``:
    per-lane min over the window's row groups plus the winning group
    index as int32 bits (read it with ``.view(torch.int32)``).

    ``debug_ablate`` (``"copy"`` or ``"nogather"``) swaps in a measurement
    body that reads the same bytes but gathers nothing, ignoring ``lens``
    (see :func:`adc_scan_tiles_reference`); it takes no ``lane_l1``.

    CPU tensors run :func:`adc_scan_tiles_reference`; CUDA tensors launch
    the kernel (or raise).  ``group`` is kept for the JAX package's
    contract (``bW % group == 0``); the kernel runs one window per CTA.
    """
    _check_inputs(codes_tiled, tile_idx, lens, lut_idx, luts, seg=seg,
                  group=group, lut_bf16=lut_bf16, lane_l1=lane_l1,
                  dist_bf16=dist_bf16, debug_ablate=debug_ablate)
    kw = dict(seg=seg, lut_bf16=lut_bf16, lane_l1=lane_l1,
              dist_bf16=dist_bf16, debug_ablate=debug_ablate)
    dev = codes_tiled.device
    if dev.type == "cpu":
        return adc_scan_tiles_reference(codes_tiled, tile_idx, lens, lut_idx,
                                        luts, **kw)
    if dev.type != "cuda":
        raise ValueError(f"adc_scan_tiles: unsupported device {dev}")
    bw, m = tile_idx.shape[0], codes_tiled.shape[1]
    tensors = (codes_tiled, tile_idx, lens, lut_idx, luts)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("adc_scan_tiles: inputs must be contiguous")
    if luts.data_ptr() % 16:
        raise ValueError("adc_scan_tiles: luts must be 16-byte aligned")
    if lane_l1:
        out = torch.empty((bw, 2, LANES), dtype=torch.float32, device=dev)
        mode = _OUT_LANE_L1
    else:
        out = torch.empty((bw, seg), device=dev,
                          dtype=torch.bfloat16 if dist_bf16 else torch.float32)
        mode = _OUT_BF16 if dist_bf16 else _OUT_F32
    if bw == 0:
        return out
    lib = cuda_lib.load("adc_scan_tiles")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chamjax_adc_scan_tiles(
            *(t.data_ptr() for t in tensors), out.data_ptr(), bw, m, seg,
            int(lut_bf16), mode, _BODIES[debug_ablate], 0, stream)
    cuda_lib.check(lib, err, "adc_scan_tiles")
    cuda_lib.launch_counts["adc_scan_tiles"] += 1
    return out


def scan_lists_seg_block(
    codes_tiled: torch.Tensor,  # (n_tiles, m, seg) uint8
    ids: torch.Tensor,          # (n_tiles * seg + pad,) int32 — tiled ids
    list_start: torch.Tensor,   # (nlist,) int32 — multiples of seg
    list_len: torch.Tensor,     # (nlist,) int32
    luts: torch.Tensor,         # (b, nprobe, ksub, m)
    list_ids: torch.Tensor,     # (b, nprobe)
    *,
    windows: int,
    seg: int,
    group: int = 8,
    k: int,
    use_approx: bool = True,
    recall_target: float = 0.99,
    lut_bf16: bool = False,
    select_l1: int = 0,
    lane_l1: bool = False,
    dist_bf16: bool = False,
    slot_major: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled-layout segmented scan + selection → ``(dists (b, k) f32,
    ids (b, k) int32)``; -1 wherever the distance is not finite.
    ``dist_bf16`` keeps the candidate buffer bfloat16 through selection and
    upcasts only the (b, k) result."""
    b = luts.shape[0]
    windows = -(-windows // group) * group
    with tracing.annotate("search.windows"):
        starts, lens, probe, _valid = expand_windows(
            list_ids, list_start, list_len, windows=windows, seg=seg)
        if slot_major and group > 1:
            # Slot-major window permutation, kept from the JAX package:
            # flat window i·G+j takes window j·(W/G)+i.  It does not change
            # the result set (``starts`` moves with the windows) and keeps
            # tie order comparable between the packages.
            def pm(x):
                return (x.reshape(b, group, windows // group)
                        .transpose(1, 2).reshape(b, windows))
            starts, lens, probe = pm(starts), pm(lens), pm(probe)
        tile_idx = (starts // seg).reshape(-1).contiguous()
        tile_lens = lens.reshape(-1).contiguous()
    with tracing.annotate("search.pack"):
        luts_k, lut_idx = prepare_luts(luts, probe, lut_bf16=lut_bf16)
    with tracing.annotate("search.scan"):
        dists = adc_scan_tiles(
            codes_tiled, tile_idx, tile_lens, lut_idx, luts_k, seg=seg,
            group=group, lut_bf16=lut_bf16, lane_l1=lane_l1,
            dist_bf16=dist_bf16 and not lane_l1)
    sel = dict(k=k, use_approx=use_approx, recall_target=recall_target,
               select_l1=select_l1)
    if lane_l1:
        return select_rows_lane_l1(dists, starts, ids, **sel)
    return select_rows(dists.reshape(b, windows * seg), starts, ids,
                       width=seg, **sel)
