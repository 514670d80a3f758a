"""The least time the card could take for a kernel's work, from the
inputs of one call: the bytes the function needs (each input byte it
depends on read once, each output byte written once) over the HBM rate,
against its operations over the card's rate for their type
(``perf_model.roofline_ms``): a scan's adds at the fp32 rate, the threefry
hash's integer operations at the integer rate (and a float draw's
instructions at the issue rate, ``threefry_form_bound``).  Where the work depends
on the data (window lengths, repeated tiles or LUT rows), the count is
what these inputs need."""

from __future__ import annotations

import math
from typing import Dict, Tuple

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


# The float work of an output of each form (csrc/threefry.cu, XLA's CPU
# code), in FMA-pipe operations (adds, multiplies, fused multiply-adds)
# and MUFU operations.  xla_log: the exponent as a float (2), t - 1,
# e - small, t + t1, x2, x3, three quadratics (6), their combination (2),
# e * q1 and its fma, the -x2/2 fma, t + y, the last fma: 20.  A correctly
# rounded division: a MUFU reciprocal and 5 fmas (Newton step, quotient,
# residual, correction); a square root: a MUFU reciprocal root and 3.
_LOG_FMA = 20
_DIV = (5, 1)
_SQRT = (3, 1)
# the uniform u of a normal is uniform on [-1, 1): log1p(-u^2) takes the
# rational form where u^2 < sqrt(2) - 1, and erf_inv its tail where
# w = -log1p(-u^2) >= 5, i.e. u^2 >= 1 - e^-5
_P_LOG1P_SMALL = math.sqrt(math.sqrt(2.0) - 1.0)
_P_ERFINV_TAIL = 1.0 - math.sqrt(1.0 - math.exp(-5.0))


def _normal_ops(uniform: int) -> Tuple[float, float]:
    small = 17 + _DIV[0]          # x^2, two Horner sums (12), x * x2, the
    large = 1 + _LOG_FMA          # ratio's multiply, fma, add; or 1 + x
    log1p = _P_LOG1P_SMALL * small + (1 - _P_LOG1P_SMALL) * large
    erfinv = 9 + _P_ERFINV_TAIL * _SQRT[0]      # w - c and 8 fmas
    fma = uniform + 1 + log1p + erfinv + 3      # -u*u; p*u, *sqrt2, *scale
    mufu = _P_LOG1P_SMALL * _DIV[1] + _P_ERFINV_TAIL * _SQRT[1]
    return fma, mufu


# form -> (FMA-pipe operations, MUFU operations) an output, beyond the hash
THREEFRY_FLOAT_OPS: Dict[str, Tuple[float, float]] = {
    "u32": (0, 0), "u16": (0, 0), "u8": (0, 0),
    "uniform_f32": (2, 0),        # f - 1, the fma
    "uniform_bf16": (3, 0),       # f - 1, f * span, + lo
    "normal_f32": _normal_ops(2),
    "normal_bf16": _normal_ops(3),
    "gumbel_f32": (2 + 2 * _LOG_FMA, 0),
}


def threefry_form_bound(n: int, out_bytes: int, form: str,
                        spec: GpuSpec = H100) -> Dict:
    """The least time for a threefry draw of ``n`` outputs in ``form``,
    from the work the function needs, whatever the compiler emits.  Each
    of these bounds it from below; the largest is the bound:

    - ``bytes``: ``out_bytes`` written at the HBM rate;
    - ``integer pipe``: the hash's 41 operations an output that only the
      integer pipe runs (``THREEFRY_INT_ONLY``), 64 lanes an SM a clock;
    - ``FMA pipe``: the form's float operations (``THREEFRY_FLOAT_OPS``)
      and the hash's 32 adds as IMADs beside them, at the float32 lanes'
      rate (128 an SM a clock, ``spec.f32_tflops / 2`` operations);
    - ``MUFU``: the reciprocals of the normal's divisions and square
      roots, 16 lanes an SM a clock;
    - ``issue``: every one of those instructions, at the 4
      warp-instructions an SM a clock its schedulers issue (128 lanes, the
      float32 lanes' rate).

    The normal's branches count what a uniform draw takes on average:
    64.4% of outputs take log1p's rational form, 0.34% erf_inv's tail.
    Returns the per-output counts, each term's ms, ``bound_ms``,
    ``bound_by`` ("bytes" or "operations") and ``limit`` (the term's
    name)."""
    fma, mufu = THREEFRY_FLOAT_OPS[form]
    lanes = spec.f32_tflops / 2 * 1e12          # lane-operations a second
    per = dict(int_only=THREEFRY_INT_ONLY, adds=THREEFRY_ADDS, float=fma,
               mufu=mufu)
    terms = {
        "bytes": out_bytes / (spec.hbm_gbps * 1e9) * 1e3,
        "integer pipe": n * THREEFRY_INT_ONLY / (spec.int32_tops * 1e12)
        * 1e3,
        "FMA pipe": n * (fma + THREEFRY_ADDS) / lanes * 1e3,
        "MUFU": n * mufu / (spec.int32_tops / 4 * 1e12) * 1e3,
        "issue": n * (THREEFRY_INT_ONLY + THREEFRY_ADDS + fma + mufu)
        / lanes * 1e3,
    }
    limit = max(terms, key=terms.get)
    return dict(per_output=per, terms_ms=terms, bound_ms=terms[limit],
                bound_by="bytes" if limit == "bytes" else "operations",
                limit=limit)


def decode_attend_bound(b: int, held: int, heads: int, head_dim: int,
                        elem: int, self_kv: bool, spec: GpuSpec = H100
                        ) -> Tuple[float, str]:
    """``decode_attend``: the held positions' K and V (b · held · heads ·
    head_dim values each), q, the current token's K and V where given, and
    the output, ``elem`` bytes a value; the scores' and p·V's multiply-adds
    (2 · 2 flops a value of a held position) at the fp32 rate."""
    row = b * heads * head_dim
    nbytes = (2 * held * row + (4 if self_kv else 2) * row) * elem
    return roofline_ms(nbytes, 4 * (held + int(self_kv)) * row, spec)


def latent_attend_bound(b: int, held: int, heads: int, latent: int,
                        v_dim: int, elem: int, self_lat: bool,
                        spec: GpuSpec = H100) -> Tuple[float, str]:
    """``latent_attend``: the held latents (b · held · latent values, read
    once for all heads), the current token's where given, q (b · heads ·
    latent) and the output (b · heads · v_dim), ``elem`` bytes a value;
    the scores' and p·V's multiply-adds (2 · (latent + v_dim) flops a head
    and position) at the bf16 tensor-core rate."""
    keys = held + int(self_lat)
    nbytes = (b * keys * latent + b * heads * (latent + v_dim)) * elem
    return roofline_ms(nbytes, 2 * b * heads * keys * (latent + v_dim), spec,
                       spec.bf16_tflops)


def encode_attend_bound(b: int, sq: int, sk: int, heads: int, head_dim: int,
                        elem: int, spec: GpuSpec = H100
                        ) -> Tuple[float, str]:
    """``encode_attend``: q and the output (b · sq · heads · head_dim values
    each) and the held keys' K and V (b · sk · heads · head_dim each),
    ``elem`` bytes a value, each read or written once; the scores' and
    p·V's multiply-adds (2 · 2 · head_dim flops a query and held key) at
    the bf16 tensor-core rate."""
    row = b * heads * head_dim
    nbytes = 2 * (sq + sk) * row * elem
    return roofline_ms(nbytes, 4 * sq * sk * row, spec, spec.bf16_tflops)


def kda_decode_bound(bh: int, head_dim: int, spec: GpuSpec = H100
                     ) -> Tuple[float, str]:
    """``kda_decode``: each of ``bh`` (row, head) states (head_dim² float32)
    read and written once, q, k, v and alpha (head_dim float32 each) and
    beta read, o (head_dim bfloat16) written; the decay, Sᵀk, the rank-1
    update and Sᵀq (7 flops a state entry) at the fp32 rate."""
    K = head_dim
    nbytes = bh * (2 * K * K * 4 + 4 * K * 4 + 4 + K * 2)
    return roofline_ms(nbytes, 7 * bh * K * K, spec)


def add_ln_bound(rows: int, width: int, delta: bool, bias: bool,
                 elem: int = 2, spec: GpuSpec = H100) -> Tuple[float, str]:
    """``add_ln``: x and ``delta`` (where given) read, ``x_new`` (where
    anything is added) and y written, ``rows · width`` values each, and the
    per-column scale, shift and ``bias`` (where given) once, ``elem`` bytes
    a value; the adds, the two sums and the normalisation (10 flops a
    value) at the fp32 rate."""
    n = rows * width
    full = 2 + int(delta) + int(delta or bias)
    return roofline_ms((full * n + (2 + int(bias)) * width) * elem, 10 * n,
                       spec)


def bias_gelu_bound(rows: int, width: int, elem: int = 2,
                    spec: GpuSpec = H100) -> Tuple[float, str]:
    """``bias_gelu``: g read and the output written (``rows · width``
    values each) and b once, ``elem`` bytes a value; the add and the tanh
    form (10 flops a value, the tanh counted as one) at the fp32 rate."""
    n = rows * width
    return roofline_ms((2 * n + width) * elem, 10 * n, spec)
