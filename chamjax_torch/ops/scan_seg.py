"""Segmented ADC scan over the flat code layout, one window per launch
block, and the helpers every scan route shares (the port of
``chamjax/ops/scan_seg.py``).

Every inverted list is viewed as ``ceil(len/seg)`` uniform seg-row
*windows*; a query's probed lists expand into a flat, probe-major window
table padded/truncated to a static budget ``W``.  The LUTs move from the
``build_luts``' ``(b, nprobe, ksub, m)`` layout to the scan kernel's
``(b·nprobe, m, ksub)`` (or packed-bf16 ``(b·nprobe, m, 128)`` int32)
layout here only.

The three flat-layout scans — :func:`adc_scan_segments` here,
``scan_seg_multi.adc_scan_segments_multi`` and
``scan_pallas.adc_scan_distances`` — launch one CUDA kernel,
``chamjax_torch/csrc/adc_scan_flat.cu``, on CUDA tensors, and run the
plain version :func:`flat_scan_reference` on CPU tensors.
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import torch

from chamjax_torch.ops.topk import select_topk
from chamjax_torch.utils import cuda_lib, tracing

LANES = 128
SEG = 1024            # default rows per window
MAX_SEG = 4096        # DeviceIVF overread padding covers any seg <= this

# Window cost model constant of the JAX package's ``auto_seg``: every
# window costs a fixed ~2048 row-slots on top of its seg rows.  Kept as is
# so both packages choose the same seg; it has not been re-measured on a
# GPU.
WINDOW_FIXED_ROWS = 2048

# Elements of one chunk of windows in the flat plain version: its int64
# codes and f32 gathers stay a few hundred MB at any batch.
_PLAIN_CHUNK_ELEMS = 1 << 24


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


# ---------------------------------------------------------------------------
# plain versions of the scan kernels
# ---------------------------------------------------------------------------


def adc_windows_reference(codes: torch.Tensor, luts: torch.Tensor,
                          lens: torch.Tensor, *, lut_bf16: bool = False,
                          lane_l1: bool = False) -> torch.Tensor:
    """The ADC sum of every scan kernel, in plain PyTorch: ``codes`` (bW,
    m, width) integer codes, ``luts`` (bW, m, 256) f32 or (bW, m, 128)
    packed-bf16 int32 (each window's own LUT row), ``lens`` (bW,).
    Returns ``dist (bW, width)`` f32, +inf at rows ≥ lens, or with
    ``lane_l1`` ``(bW, 2, 128)``: the per-lane min over the row groups and
    the first winning group's index as int32 bits."""
    bw, _m, width = codes.shape
    if lut_bf16:
        # a packed int32 row is its bf16 pairs in memory (little-endian);
        # bf16 → f32 is exact, so this equals the kernel's bit decode
        luts = luts.contiguous().view(torch.bfloat16)
    dist = torch.gather(luts, 2, codes.long()).float().sum(dim=1)
    pos = torch.arange(width, device=dist.device)
    dist = torch.where(pos[None, :] < lens[:, None].long(), dist,
                       torch.full_like(dist, float("inf")))
    if not lane_l1:
        return dist
    rows = dist.reshape(bw, width // LANES, LANES)
    best = torch.full((bw, LANES), float("inf"), device=dist.device)
    best_t = torch.zeros((bw, LANES), dtype=torch.int32, device=dist.device)
    for t in range(width // LANES):
        take = rows[:, t] < best          # strict: first group wins ties
        best = torch.where(take, rows[:, t], best)
        best_t = torch.where(take, torch.full_like(best_t, t), best_t)
    return torch.stack([best, best_t.view(torch.float32)], dim=1)


def flat_scan_reference(
    codes_t: torch.Tensor,      # (m, n_cols) uint8
    starts: torch.Tensor,       # (bW,) int32
    lens: torch.Tensor,         # (bW,) int32
    lut_rows: torch.Tensor,     # (bW,) int32 — LUT row per window
    luts: torch.Tensor,         # (n_lut, m, 256) f32 | (n_lut, m, 128) i32
    *,
    width: int,
    lut_bf16: bool = False,
    lane_l1: bool = False,
) -> torch.Tensor:
    """Plain version of ``csrc/adc_scan_flat.cu``: window w scores columns
    ``[starts[w], starts[w] + width)`` of ``codes_t`` against LUT row
    ``lut_rows[w]``.  A row reads codes only below ``lens[w]`` and inside
    ``codes_t``; every other row is +inf.  Windows go in chunks, so the
    gathered codes stay a few hundred MB at any batch."""
    m, n_cols = codes_t.shape
    bw = starts.shape[0]
    dev = codes_t.device
    if bw == 0:
        shape = (0, 2, LANES) if lane_l1 else (0, width)
        return torch.empty(shape, dtype=torch.float32, device=dev)
    pos = torch.arange(width, device=dev)
    step = max(1, _PLAIN_CHUNK_ELEMS // (m * width))
    outs = []
    for w0 in range(0, bw, step):
        s = starts[w0:w0 + step].long()
        ln = torch.minimum(lens[w0:w0 + step].long(), n_cols - s)
        ln = torch.where(s < 0, torch.zeros_like(ln), ln)
        cols = torch.clamp(s[:, None] + pos, 0, n_cols - 1)   # (C, width)
        codes = codes_t[:, cols].permute(1, 0, 2)            # (C, m, width)
        outs.append(adc_windows_reference(
            codes, luts[lut_rows[w0:w0 + step].long()], ln,
            lut_bf16=lut_bf16, lane_l1=lane_l1))
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# the flat-layout kernel: input checks and launch
# ---------------------------------------------------------------------------


def check_flat_inputs(what: str, codes_t, starts, lens, lut_idx, luts, *,
                      lut_bf16: bool) -> None:
    """Raise ValueError on what ``adc_scan_flat.cu`` does not take;
    ``lut_idx`` is None where each window owns LUT row w."""
    if codes_t.dim() != 2 or luts.dim() != 3:
        raise ValueError(f"{what}: codes_t must be 2-D (m, n) and luts 3-D")
    m = codes_t.shape[0]
    _n_lut, m2, ksub = luts.shape
    if m2 != m or ksub != (128 if lut_bf16 else 256):
        raise ValueError(f"{what}: luts {tuple(luts.shape)} do not fit "
                         f"m={m}, lut_bf16={lut_bf16} (8-bit PQ only)")
    bw = starts.shape[0]
    idx = {"starts": starts, "lens": lens}
    if lut_idx is not None:
        idx["lut_idx"] = lut_idx
    for name, t in idx.items():
        if t.shape != (bw,):
            raise ValueError(f"{what}: starts, lens"
                             f"{', lut_idx' if lut_idx is not None else ''}"
                             f" must be (bW,) each ({name} is "
                             f"{tuple(t.shape)})")
    want = {"codes_t": (codes_t, torch.uint8),
            "luts": (luts, torch.int32 if lut_bf16 else torch.float32)}
    want.update({n: (t, torch.int32) for n, t in idx.items()})
    for name, (t, dt) in want.items():
        if t.dtype != dt:
            raise ValueError(f"{what}: {name} is {t.dtype}, needs {dt}")
        if t.device != codes_t.device:
            raise ValueError(f"{what}: {name} on {t.device}, codes on "
                             f"{codes_t.device}")
    if codes_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {codes_t.device}")
    if codes_t.device.type == "cuda":
        if not all(t.is_contiguous() for t, _ in want.values()):
            raise ValueError(f"{what}: inputs must be contiguous")
        if luts.data_ptr() % 16:
            raise ValueError(f"{what}: luts must be 16-byte aligned")


def launch_flat(name: str, codes_t: torch.Tensor, starts: torch.Tensor,
                lens: torch.Tensor, lut_idx: Optional[torch.Tensor],
                luts: torch.Tensor, out: torch.Tensor, *ints: int) -> None:
    """Launch entry point ``chamjax_<name>`` of ``adc_scan_flat.cu`` on the
    current stream and count the launch under ``name``."""
    lib = cuda_lib.load("adc_scan_flat")
    dev = codes_t.device
    ptrs = [t.data_ptr() for t in (starts, lens, lut_idx, luts, out)
            if t is not None]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"chamjax_{name}")(
            codes_t.data_ptr(), codes_t.shape[1], *ptrs, *ints, stream)
    cuda_lib.check(lib, err, name)
    cuda_lib.launch_counts[name] += 1


def check_seg(what: str, seg: int) -> None:
    if seg % LANES or not 0 < seg <= MAX_SEG:
        raise ValueError(f"{what}: seg={seg} must be a multiple of {LANES} "
                         f"in (0, {MAX_SEG}]")


# ---------------------------------------------------------------------------
# selection: candidate positions → rows → ids
# ---------------------------------------------------------------------------


def _ids_at(ids: torch.Tensor, row: torch.Tensor,
            best_d: torch.Tensor) -> torch.Tensor:
    # a non-finite slot may point past the id table (JAX clamps there)
    best_i = ids[torch.clamp(row, 0, ids.shape[0] - 1)]
    return torch.where(torch.isfinite(best_d), best_i,
                       torch.full_like(best_i, -1))


def select_rows(dists: torch.Tensor, starts: torch.Tensor, ids: torch.Tensor,
                *, k: int, width: int, use_approx: bool = True,
                recall_target: float = 0.99, select_l1: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over each query's window-major candidates ``dists (b,
    W·width)``, where candidate ``w·width + r`` is row ``starts[:, w] +
    r`` → ``(dists (b, k) f32, ids (b, k))``, -1 where not finite."""
    with tracing.annotate("search.topk"):
        best_d, pos = select_topk(dists, k, use_approx=use_approx,
                                  recall_target=recall_target, l1=select_l1)
        best_d = best_d.to(torch.float32)
        pos = pos.long()
        row = torch.gather(starts.long(), 1, pos // width) + pos % width
        return best_d, _ids_at(ids, row, best_d)


def select_rows_lane_l1(dists: torch.Tensor, starts: torch.Tensor,
                        ids: torch.Tensor, *, k: int, use_approx: bool = True,
                        recall_target: float = 0.99, select_l1: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`select_rows` over a lane_l1 kernel output ``(b·W, 2, 128)``:
    candidate ``w·128 + lane`` is row ``starts[:, w] + group·128 + lane``
    with ``group`` the winning row group the kernel recorded."""
    b, windows = starts.shape
    with tracing.annotate("search.topk"):
        flat = dists[:, 0, :].reshape(b, windows * LANES)
        group = dists[:, 1, :].contiguous().view(torch.int32).reshape(
            b, windows * LANES)
        best_d, pos = select_topk(flat, k, use_approx=use_approx,
                                  recall_target=recall_target, l1=select_l1)
        pos = pos.long()
        g_sel = torch.gather(group, 1, pos).long()
        row = (torch.gather(starts.long(), 1, pos // LANES)
               + g_sel * LANES + pos % LANES)
        return best_d, _ids_at(ids, row, best_d)


# ---------------------------------------------------------------------------
# adc_scan_segments: one window per launch block, flat layout
# ---------------------------------------------------------------------------


def adc_scan_segments_reference(codes_t, starts, lens, lut_idx, luts, *,
                                seg: int = SEG,
                                lut_bf16: bool = False) -> torch.Tensor:
    """Plain version of :func:`adc_scan_segments` (same contract)."""
    return flat_scan_reference(codes_t, starts, lens, lut_idx, luts,
                               width=seg, lut_bf16=lut_bf16)


def adc_scan_segments(
    codes_t: torch.Tensor,      # (m, n_pad_seg) uint8 — MAX_SEG-padded
    starts: torch.Tensor,       # (bW,) int32 — window start columns
    lens: torch.Tensor,         # (bW,) int32 — valid rows (0 = skip)
    lut_idx: torch.Tensor,      # (bW,) int32 — row into luts per window
    luts: torch.Tensor,         # (n_lut, m, 256) f32 | (n_lut, m, 128) i32
    *,
    seg: int = SEG,
    lut_bf16: bool = False,
) -> torch.Tensor:
    """Returns ``dists (bW, seg) float32`` (+inf on padding/skips).

    CPU tensors run :func:`adc_scan_segments_reference`; CUDA tensors
    launch ``adc_scan_flat.cu`` (or raise).  Starts need no alignment."""
    check_seg("adc_scan_segments", seg)
    check_flat_inputs("adc_scan_segments", codes_t, starts, lens, lut_idx,
                      luts, lut_bf16=lut_bf16)
    if codes_t.device.type == "cpu":
        return adc_scan_segments_reference(codes_t, starts, lens, lut_idx,
                                           luts, seg=seg, lut_bf16=lut_bf16)
    bw = starts.shape[0]
    out = torch.empty((bw, seg), dtype=torch.float32, device=codes_t.device)
    if bw:
        launch_flat("adc_scan_segments", codes_t, starts, lens, lut_idx,
                    luts, out, bw, codes_t.shape[0], seg, int(lut_bf16))
    return out


def scan_lists_seg(
    codes_t: torch.Tensor,      # (m, n_pad_seg) uint8
    ids: torch.Tensor,          # (n_pad_seg,) int32
    list_start: torch.Tensor,   # (nlist,) int32
    list_len: torch.Tensor,     # (nlist,) int32
    luts: torch.Tensor,         # (b, nprobe, ksub, m) float32
    list_ids: torch.Tensor,     # (b, nprobe) int32
    *,
    windows: int,
    seg: int = SEG,
    k: int,
    use_approx: bool = True,
    recall_target: float = 0.99,
    lut_bf16: bool = False,
    select_l1: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented scan + selection → ``(dists (b, k) f32, ids (b, k))``."""
    with tracing.annotate("search.windows"):
        starts, lens, probe, _valid = expand_windows(
            list_ids, list_start, list_len, windows=windows, seg=seg)
    with tracing.annotate("search.pack"):
        luts_k, lut_idx = prepare_luts(luts, probe, lut_bf16=lut_bf16)
    with tracing.annotate("search.scan"):
        dists = adc_scan_segments(
            codes_t, starts.reshape(-1), lens.reshape(-1), lut_idx, luts_k,
            seg=seg, lut_bf16=lut_bf16)
    return select_rows(dists.reshape(luts.shape[0], windows * seg), starts,
                       ids, k=k, width=seg, use_approx=use_approx,
                       recall_target=recall_target, select_l1=select_l1)
