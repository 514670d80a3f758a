"""The JAX PRNG on torch: the counterpart of ``jax.random`` as the JAX
package draws from it, so a seed names the same corpus, the same k-means
seeding and the same initial model in both packages.

The generator is threefry2x32 with JAX's partitionable counters
(``jax_threefry_partitionable``, JAX's default): output ``i`` of a draw
hashes the 64-bit counter ``i``, split into its hi and lo words, under the
key, and keeps ``bits1 ^ bits2``.  The samplers follow ``jax/_src/random.py``
step for step: ``uniform`` fills the mantissa of a float in [1, 2) (8 random
bits for bfloat16, whose mantissa is shorter), ``normal`` is √2·erfinv of a
uniform on [nextafter(-1, 0), 1) with XLA's single-precision erfinv
polynomial (Giles), ``randint`` the two-key ``higher·multiplier + lower``
form, ``permutation`` rounds of a stable sort over 32-bit keys.

**Keys** are the reference's pair of uint32 words, held on the host as a
numpy ``uint32[2]``; an int is accepted wherever a key is and means
``key(seed)``, as ``jax.random.PRNGKey(seed)`` does.  ``split`` and
``fold_in`` hash on the host.

**Draws** take an explicit ``device``; ``None`` means the card
(``resolve_device``), which raises without one.  On a card the threefry
pass and the float forms run in the hand-written kernel
``chamjax_torch/csrc/threefry.cu`` (:func:`threefry_draw`), one launch a
draw; the sorts of ``permutation`` and the modular arithmetic of
``randint`` are torch ops on its bits.  k-means++'s Gumbel-max step
(:func:`gumbel_argmax`) is a second entry point of the same source: one
launch folds the key, draws the gumbels in registers and reduces to the
argmax on the card.  On the CPU the same functions run
the plain version (:func:`threefry_draw_reference`): torch ops on int32
words (torch's uint32 lacks them), whose adds wrap as uint32's do.  A
float form that passes through ``log`` or ``erf_inv`` depends on 23
(bfloat16: 7) random bits only, so the plain version evaluates it once on
every value of them and gathers.

The float forms carry XLA's own CPU ``log`` and ``log1p`` (Cephes'
polynomials, evaluated by fused multiply-adds) and its fused uniform
multiply-add, so they equal ``jax.random`` on the CPU bit for bit too, up
to a float64-emulated fused multiply-add rounding twice (never seen in
tests); ``tests/test_torch_random.py`` holds every sampler to JAX's.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from chamjax_torch.utils import cuda_lib
from chamjax_torch.utils.device import resolve_device

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Union[int, Sequence[int], np.ndarray]
Shape = Union[int, Sequence[int]]

# XLA's erf_inv for float32 (Giles' polynomial), w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

# the kernel's output forms: raw bits, uniforms, normals
FORMS = ("u32", "u16", "u8", "uniform_f32", "uniform_bf16", "normal_f32",
         "normal_bf16", "gumbel_f32")
_OUT_DTYPE = {"u32": torch.uint32, "u16": torch.uint16, "u8": torch.uint8,
              "uniform_f32": torch.float32, "uniform_bf16": torch.bfloat16,
              "normal_f32": torch.float32, "normal_bf16": torch.bfloat16,
              "gumbel_f32": torch.float32}
# the kernel writes u32 / u16 through a signed type of the same width
_STORE_DTYPE = dict(_OUT_DTYPE, u32=torch.int32, u16=torch.int16)
# rows of the plain version's work at a time.  On the CPU below torch's
# intra-op grain (32768 elements), so each of its hundreds of small passes
# runs on the calling thread: intra-op threads that share their cores with
# other processes stall on every pass far longer than the pass takes
_PLAIN_CHUNK = {"cpu": 1 << 14, "cuda": 1 << 24}


# ---------------------------------------------------------------------------
# keys (host)
# ---------------------------------------------------------------------------

def _threefry_host(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """threefry2x32 (20 rounds) of the counter words ``(x0, x1)`` under key
    ``(k0, k1)``, in Python ints under the mask (a key's hash is a few
    dozen operations: numpy's per-call cost would be most of it)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's hi and lo 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} must be in [0, 2**64)")
    return np.array([seed >> 32, seed & MASK], np.uint32)


def as_key(k: Key) -> np.ndarray:
    """``k`` as a key: an int is ``key(k)``, else two uint32 words."""
    if isinstance(k, (int, np.integer)):
        return key(int(k))
    a = np.asarray(k)
    if a.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {a.shape}")
    return a.astype(np.uint32)


def split(k: Key, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: ``(num, 2)`` uint32, key ``i`` the hash
    of counter ``(0, i)``."""
    k0, k1 = (int(w) for w in as_key(k))
    return np.array([_threefry_host(k0, k1, 0, i) for i in range(num)],
                    np.uint32).reshape(num, 2)


def fold_in(k: Key, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``: the hash of counter ``(0, data)``."""
    k = as_key(k)
    data = int(data)
    if not 0 <= data <= MASK:
        raise ValueError(f"fold_in data {data} must be a uint32")
    return np.array(_threefry_host(int(k[0]), int(k[1]), 0, data),
                    np.uint32)


# ---------------------------------------------------------------------------
# the draw: kernel and plain version
# ---------------------------------------------------------------------------

def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(
        int(s) for s in shape)


def _s32(v: int) -> int:
    """The uint32 ``v`` as the int32 of the same bits."""
    v &= MASK
    return v - (1 << 32) if v >> 31 else v


def _threefry_pair(k0: int, k1: int, hi: torch.Tensor, lo: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32's output pair of the counter words ``(hi, lo)`` (int64
    tensors of uint32 values) under key ``(k0, k1)``, as int32 bits: torch
    int32 ops, whose adds wrap as uint32's do; a logical right shift is the
    arithmetic one masked."""
    ks = (_s32(k0), _s32(k1), _s32(k0 ^ k1 ^ _PARITY))
    x0 = hi.to(torch.int32).add_(ks[0])
    x1 = lo.to(torch.int32).add_(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            low = (x1 >> (32 - r)).bitwise_and_((1 << r) - 1)
            x1.bitwise_left_shift_(r).bitwise_or_(low).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(_s32(ks[(i + 2) % 3] + i + 1))
    return x0, x1


def _threefry_words(k0: int, k1: int, start: int, n: int,
                    device: torch.device) -> torch.Tensor:
    """``bits1 ^ bits2`` of counters ``start .. start + n - 1`` as int32
    bits."""
    lo = torch.arange(n, dtype=torch.int64, device=device).add_(start & MASK)
    hi = ((lo >> 32) + (start >> 32)).bitwise_and_(MASK)
    x0, x1 = _threefry_pair(k0, k1, hi, lo.bitwise_and_(MASK))
    del hi, lo
    return x0.bitwise_xor_(x1)


def fold_in_reference(k: Key, data: torch.Tensor) -> torch.Tensor:
    """The plain version of the fold that the Gumbel-max kernel runs on the
    card: ``fold_in(k, d)`` for each uint32 ``d`` of ``data`` (an integer
    tensor), as ``(len(data), 2)`` int64 words: the output pair of counter
    ``(0, d)``."""
    kk = as_key(k)
    lo = data.to(torch.int64).reshape(-1)
    if lo.numel() and (int(lo.min()) < 0 or int(lo.max()) > MASK):
        raise ValueError("fold_in data must be uint32")
    x0, x1 = _threefry_pair(int(kk[0]), int(kk[1]), torch.zeros_like(lo), lo)
    return torch.stack([x0, x1], dim=1).to(torch.int64) & MASK


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 ``x`` to bfloat16 (to nearest even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def _fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a·b + c`` rounded once to float32 (a fused multiply-add; ``a`` a
    float32 tensor, ``b`` and ``c`` float32 tensors or values).  The
    product is exact in float64 and the sum rounds there; where that sum
    sits exactly on a float32 rounding midpoint, the exact sum's side of it
    (TwoSum's error term) decides, so the result never rounds twice."""
    prod = a.double() * b
    s = prod + c
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 1 << 28
    if bool(tie.any()):
        pt, st = prod.masked_select(tie), s.masked_select(tie)
        ct = (c.double().expand_as(s).masked_select(tie)
              if isinstance(c, torch.Tensor) else torch.full_like(st, c))
        z = st - pt
        err = (pt - (st - z)) + (ct - z)
        s = s.masked_scatter(tie, torch.where(err == 0, st, torch.nextafter(
            st, torch.where(err > 0, float("inf"), float("-inf")).double())))
    return s.float()


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (torch's CPU kernel is not):
    through float64, whose rounding to float32 is then exact."""
    return torch.sqrt(x.double()).float()


def _div_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 division, through float64."""
    return (a.double() / b.double()).float()


def _f32(x: float) -> float:
    return float(np.float32(x))


# XLA's CPU log (Cephes' logf, its polynomial in fused multiply-adds) and
# log1p (Cephes' rational form below sqrt(2) - 1): the functions whose last
# bit the reference's draws carry
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)
_MIN_NORMAL = float(np.finfo(np.float32).tiny)
_LOG1P_NUM = tuple(_f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_f32(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
_LOG1P_SMALL = _f32(0.41421356237309504880)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log on the CPU: ``x = m·2**e`` with ``m`` in
    [sqrt(1/2), sqrt(2)), Cephes' degree-8 polynomial in ``m - 1``, plus
    ``e·ln 2`` in two parts; -inf at 0, nan below."""
    t = torch.clamp(x, min=_MIN_NORMAL)
    bits = t.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    t = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = t < _SQRTHF
    t1 = torch.where(small, t, 0.0)
    t = t - 1.0
    e = e - small.to(torch.float32)
    t = t + t1
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma_f32(_fma_f32(t, p[0], p[1]), t, p[2])
    y1 = _fma_f32(_fma_f32(t, p[3], p[4]), t, p[5])
    y2 = _fma_f32(_fma_f32(t, p[6], p[7]), t, p[8])
    y = _fma_f32(_fma_f32(y, x3, y1), x3, y2)
    y = _fma_f32(y, x3, e * _LOG_Q1)
    t = _fma_f32(x2, -0.5, t)
    r = _fma_f32(e, _LOG_Q2, t + y)
    r = torch.where(x == 0, float("-inf"), r)
    r = torch.where(x == float("inf"), float("inf"), r)
    return torch.where((x < 0) | torch.isnan(x), float("nan"), r)


def _where_apply(x: torch.Tensor, cond: torch.Tensor, f_true, f_false
                 ) -> torch.Tensor:
    """``where(cond, f_true(x), f_false(x))``, each function evaluated only
    on its own elements."""
    out = torch.empty_like(x)
    out.masked_scatter_(cond, f_true(x.masked_select(cond)))
    return out.masked_scatter_(~cond, f_false(x.masked_select(~cond)))


def _horner(x: torch.Tensor, cs) -> torch.Tensor:
    p = torch.full_like(x, cs[0])
    for c in cs[1:]:
        p = _fma_f32(p, x, c)
    return p


def _log1p_small(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    r = (x * x2) * _div_f32(_horner(x, _LOG1P_NUM), _horner(x, _LOG1P_DEN))
    return x + _fma_f32(x2, -0.5, r)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p on the CPU: ``log_f32(1 + x)``, or for |x| below
    sqrt(2) - 1 ``x - x²/2 + x³·P(x)/Q(x)`` (Cephes)."""
    return _where_apply(x, x.abs() < _LOG1P_SMALL, _log1p_small,
                        lambda v: log_f32(v + 1.0))


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv (Giles): ``w = -log1p(-x²)``, a degree-8
    polynomial in ``w - 2.5`` (w < 5) or ``√w - 3``, evaluated by fused
    multiply-adds, times ``x``; ±inf at ±1."""
    w = -log1p_f32(x * -x)
    p = _where_apply(
        w, w < 5.0,
        lambda v: _horner(v - 2.5, tuple(map(_f32, _ERFINV_LT5))),
        lambda v: _horner(_sqrt_f32(v) - 3.0, tuple(map(_f32, _ERFINV_GE5))))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def _mantissa23(words: torch.Tensor) -> torch.Tensor:
    """The top 23 bits of each word (int32), which a float32 uniform
    keeps."""
    return (words >> 9) & 0x7FFFFF


def _uniform_f32(m23: torch.Tensor, lo: float, span: float
                 ) -> torch.Tensor:
    """``max(lo, f·span + lo)``, ``f`` in [0, 1) from 23 bits ``m23``, the
    multiply-add fused as XLA fuses it."""
    f = (m23 | 0x3F800000).view(torch.float32) - 1.0            # exact
    return torch.clamp(_fma_f32(f, span, lo), min=lo)


def _uniform_bf16(m7: torch.Tensor, lo: float, span: float
                  ) -> torch.Tensor:
    """float32 holding bfloat16 values: ``f`` from the 7 bits ``m7`` (the
    8 random bits shifted right once), every operation rounded to
    bfloat16."""
    f = ((m7 | 0x3F80) << 16).view(torch.float32) - 1.0        # exact
    u = _bf16_round(_bf16_round(f * span) + lo)
    return torch.clamp(u, min=lo)


_SQRT2_F32 = float(np.float32(np.sqrt(2)))
_SQRT2_BF16 = 1.4140625           # √2 rounded to bfloat16


def _normal_f32(m23, lo, span):
    return erf_inv_f32(_uniform_f32(m23, lo, span)) * _SQRT2_F32


def _gumbel_f32(m23, lo, span):
    return -log_f32(-log_f32(_uniform_f32(m23, lo, span)))


def _normal_bf16(m7, lo, span):
    e = _bf16_round(erf_inv_f32(_uniform_bf16(m7, lo, span)))
    return _bf16_round(e * _SQRT2_BF16)


# the float forms that pass through log / erf_inv: functions of 23 (float32)
# or 7 (bfloat16) random bits, evaluated once on every value of them
_TABLED = {"normal_f32": (_normal_f32, 23), "gumbel_f32": (_gumbel_f32, 23),
           "normal_bf16": (_normal_bf16, 7)}
_TABLES: dict = {}


def _table(form: str, lo: float, span: float, device: torch.device
           ) -> torch.Tensor:
    """``form``'s value at every value of its random bits, on ``device``,
    built at first use (2**23 float32: 32 MB)."""
    key_ = (form, lo, span, str(device))
    t = _TABLES.get(key_)
    if t is None:
        fn, nbits = _TABLED[form]
        t = torch.empty(1 << nbits, dtype=torch.float32, device=device)
        step = _PLAIN_CHUNK.get(device.type, 1 << 20)
        for s0 in range(0, 1 << nbits, step):
            m = torch.arange(s0, min(s0 + step, 1 << nbits),
                             dtype=torch.int32, device=device)
            t[s0:s0 + m.numel()] = fn(m, lo, span)
        _TABLES[key_] = t
    return t


def _plain_form(words: torch.Tensor, form: str, lo: float, span: float,
                scale: float) -> torch.Tensor:
    if form == "u32":
        return words
    if form == "u16":
        return words.to(torch.int16)
    if form == "u8":
        return words.to(torch.uint8)
    if form == "uniform_f32":
        return _uniform_f32(_mantissa23(words), lo, span)
    if form == "uniform_bf16":
        return _uniform_bf16((words & 0xFF) >> 1, lo, span).to(
            torch.bfloat16)
    table = _table(form, lo, span, words.device)
    if form == "normal_bf16":
        r = table.index_select(0, ((words & 0xFF) >> 1).long())
        return _bf16_round(r * scale).to(torch.bfloat16)
    r = table.index_select(0, _mantissa23(words).long())
    return r * scale if form == "normal_f32" else r


def _check_draw(k: Key, n: int, form: str, start: int):
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if n < 0 or start < 0 or start + n > 1 << 64:
        raise ValueError(f"counters [{start}, {start + n}) out of range")
    return as_key(k)


def threefry_draw_reference(k: Key, n: int, form: str, *, start: int = 0,
                            lo: float = 0.0, span: float = 1.0,
                            scale: float = 1.0, device=None
                            ) -> torch.Tensor:
    """The plain version of :func:`threefry_draw`: the same outputs from
    torch ops, ``n`` at a time in cache-sized pieces."""
    kk = _check_draw(k, n, form, start)
    dev = resolve_device(device)
    out = torch.empty(n, dtype=_STORE_DTYPE[form], device=dev)
    step = _PLAIN_CHUNK.get(dev.type, 1 << 20)
    for s in range(0, n, step):
        c = min(step, n - s)
        words = _threefry_words(int(kk[0]), int(kk[1]), start + s, c, dev)
        out[s:s + c] = _plain_form(words, form, lo, span, scale)
    return out.view(_OUT_DTYPE[form])


_FORM_IDS = {f: i for i, f in enumerate(FORMS)}


def threefry_draw(k: Key, n: int, form: str, *, start: int = 0,
                  lo: float = 0.0, span: float = 1.0, scale: float = 1.0,
                  device=None) -> torch.Tensor:
    """``n`` outputs of one draw, counters ``start .. start + n - 1``, in
    form ``form`` (``FORMS``): raw bits (``u32``, ``u16``, ``u8``: the low
    bits of ``bits1 ^ bits2``), a uniform ``max(lo, f·span + lo)`` over
    ``f`` in [0, 1) in float32 or bfloat16, a normal (the uniform's
    √2·erfinv) times ``scale``, or a gumbel (``-log(-log(u))``).
    :func:`draw_params` gives a sampler's ``lo``, ``span`` and ``scale``;
    for bfloat16 forms they are bfloat16 values and every step rounds to
    bfloat16.

    On a card: one launch of ``csrc/threefry.cu`` (or raises); on the CPU:
    :func:`threefry_draw_reference`."""
    kk = _check_draw(k, n, form, start)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return threefry_draw_reference(kk, n, form, start=start, lo=lo,
                                       span=span, scale=scale, device=dev)
    if dev.type != "cuda":
        raise ValueError(f"threefry_draw: unsupported device {dev}")
    out = torch.empty(n, dtype=_STORE_DTYPE[form], device=dev)
    if n:
        lib = cuda_lib.load("threefry")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.chamjax_threefry(
                out.data_ptr(), n, start, int(kk[0]), int(kk[1]),
                _FORM_IDS[form], lo, span, scale, stream)
        cuda_lib.check(lib, err, "threefry")
        cuda_lib.launch_counts["threefry"] += 1
    return out.view(_OUT_DTYPE[form])


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def bits(k: Key, shape: Shape = (), width: int = 32, device=None
         ) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint{width})``: uint32, uint16 or
    uint8."""
    form = {32: "u32", 16: "u16", 8: "u8"}.get(width)
    if form is None:
        raise ValueError(f"width must be 32, 16 or 8, got {width}")
    shape = _shape(shape)
    return threefry_draw(k, math.prod(shape), form,
                         device=device).reshape(shape)


def _bf16(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))


def _bounds(dtype: torch.dtype, lo: float, hi: float) -> Tuple[float, float]:
    """``lo`` and ``hi - lo`` in ``dtype``, as the reference converts and
    subtracts them."""
    if dtype == torch.float32:
        lo32, hi32 = np.float32(lo), np.float32(hi)
        return float(lo32), float(hi32 - lo32)
    if dtype == torch.bfloat16:
        lo16, hi16 = _bf16(lo), _bf16(hi)
        return lo16, _bf16(hi16 - lo16)
    raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")


_NORMAL_LO = {torch.float32: float(np.nextafter(np.float32(-1),
                                                np.float32(0))),
              torch.bfloat16: -1.0 + 2.0 ** -8}
_TINY_F32 = float(np.finfo(np.float32).tiny)


def draw_params(form: str, lo: float = 0.0, hi: float = 1.0,
                scale: float = 1.0) -> dict:
    """The ``lo``, ``span`` and ``scale`` that the sampler of ``form``
    hands :func:`threefry_draw`, in the form's float type: a uniform's
    bounds as given, a normal's uniform on [nextafter(-1, 0), 1), a
    gumbel's on [tiny, 1)."""
    dtype = torch.bfloat16 if form.endswith("bf16") else torch.float32
    if form.startswith("normal"):
        lo, hi = _NORMAL_LO[dtype], 1.0
    elif form == "gumbel_f32":
        lo, hi = _TINY_F32, 1.0
    lo_d, span = _bounds(dtype, lo, hi)
    scale = _bf16(scale) if dtype == torch.bfloat16 else _f32(scale)
    return dict(lo=lo_d, span=span, scale=scale)


def uniform(k: Key, shape: Shape = (), dtype: torch.dtype = torch.float32,
            lo: float = 0.0, hi: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, dtype, lo, hi)``: float32 (23 random
    bits) or bfloat16 (8 random bits)."""
    shape = _shape(shape)
    form = {torch.float32: "uniform_f32",
            torch.bfloat16: "uniform_bf16"}.get(dtype)
    if form is None:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    return threefry_draw(k, math.prod(shape), form,
                         **draw_params(form, lo, hi),
                         device=device).reshape(shape)


def normal(k: Key, shape: Shape = (), dtype: torch.dtype = torch.float32,
           *, scale: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape, dtype)``, times ``scale`` in ``dtype``
    (the reference's separate multiply by a constant of that dtype)."""
    shape = _shape(shape)
    form = {torch.float32: "normal_f32",
            torch.bfloat16: "normal_bf16"}.get(dtype)
    if form is None:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    return threefry_draw(k, math.prod(shape), form,
                         **draw_params(form, scale=scale),
                         device=device).reshape(shape)


def gumbel(k: Key, shape: Shape = (), device=None) -> torch.Tensor:
    """``jax.random.gumbel(k, shape)`` (float32, mode "low"):
    ``-log(-log(u))`` of a uniform on [tiny, 1), with XLA's log."""
    shape = _shape(shape)
    return threefry_draw(k, math.prod(shape), "gumbel_f32",
                         **draw_params("gumbel_f32"),
                         device=device).reshape(shape)


# the Gumbel-max step's logit floor, as the reference clamps D² before log
_LOGIT_FLOOR = 1e-30


def gumbel_argmax_reference(k: Key, step: int, d: torch.Tensor
                            ) -> torch.Tensor:
    """The plain version of :func:`gumbel_argmax`: the chain of torch ops,
    ``argmax(log(clamp(d, 1e-30)) + gumbel(fold_in(k, step), (n,)))``
    (0-d int64, the lowest index on ties), on ``d``'s device."""
    logits = torch.log(torch.clamp(d, min=_LOGIT_FLOOR))
    g = gumbel(fold_in(k, step), (d.numel(),), device=d.device)
    return torch.argmax(logits + g)


def argmax_scratch(device) -> torch.Tensor:
    """Scratch for :func:`gumbel_argmax` on ``device``: two zeroed int64
    words, which each launch leaves zeroed, so a loop allocates it once.
    One stream at a time may use a scratch."""
    return torch.zeros(2, dtype=torch.int64, device=resolve_device(device))


def gumbel_argmax(k: Key, step: int, d: torch.Tensor, *,
                  scratch: torch.Tensor = None) -> torch.Tensor:
    """One step of k-means++'s D² sampling by the Gumbel-max trick:
    ``argmax_j log(max(d_j, 1e-30)) + gumbel(fold_in(k, step), (n,))_j``
    as a 0-d int64 tensor on ``d``'s device, the lowest ``j`` on ties.

    On a card: one launch of ``csrc/threefry.cu``'s fused step (or
    raises), which folds the key, draws the gumbels and reduces them in
    registers, and leaves the index on the card; ``d`` is a contiguous
    float32 vector of 1 to 2**32 - 1 entries, and ``scratch``
    (:func:`argmax_scratch`) is allocated here where not given.  On the
    CPU: :func:`gumbel_argmax_reference`."""
    kk = as_key(k)
    step = int(step)
    if not 0 <= step <= MASK:
        raise ValueError(f"step {step} must be a uint32")
    if d.dim() != 1 or not 1 <= d.numel() <= MASK:
        raise ValueError(f"d must be a vector of 1 to 2**32 - 1 entries, "
                         f"got shape {tuple(d.shape)}")
    if d.device.type == "cpu":
        return gumbel_argmax_reference(kk, step, d)
    if d.device.type != "cuda":
        raise ValueError(f"gumbel_argmax: unsupported device {d.device}")
    if d.dtype != torch.float32 or not d.is_contiguous():
        raise ValueError("gumbel_argmax: d must be contiguous float32 on "
                         "the card")
    if scratch is None:
        scratch = argmax_scratch(d.device)
    if (scratch.dtype != torch.int64 or scratch.numel() != 2
            or scratch.device != d.device):
        raise ValueError("gumbel_argmax: scratch must be two int64 words on "
                         "d's device (argmax_scratch)")
    p = draw_params("gumbel_f32")
    out = torch.empty((), dtype=torch.int64, device=d.device)
    lib = cuda_lib.load("threefry")
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.chamjax_threefry_gumbel_argmax(
            d.data_ptr(), d.numel(), int(kk[0]), int(kk[1]), step, p["lo"],
            p["span"], scratch.data_ptr(), out.data_ptr(), stream)
    cuda_lib.check(lib, err, "threefry_gumbel_argmax")
    cuda_lib.launch_counts["threefry_gumbel_argmax"] += 1
    return out


def logit_on_card(d: torch.Tensor) -> torch.Tensor:
    """``log(max(d, 1e-30))`` as the fused step computes its logit (CUDA's
    ``logf``), for the check that it equals ``torch.log`` on the card bit
    for bit; ``d`` contiguous float32 on a card."""
    if d.device.type != "cuda" or d.dtype != torch.float32 \
            or not d.is_contiguous():
        raise ValueError("logit_on_card: d must be contiguous float32 on a "
                         "card")
    out = torch.empty_like(d)
    lib = cuda_lib.load("threefry")
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.chamjax_threefry_logit(d.data_ptr(), d.numel(),
                                         out.data_ptr(), stream)
    cuda_lib.check(lib, err, "threefry_logit")
    cuda_lib.launch_counts["threefry_logit"] += 1
    return out


def _words32(k: Key, n: int, device) -> torch.Tensor:
    """32-bit draws as int64 in [0, 2**32)."""
    return threefry_draw(k, n, "u32", device=device).view(
        torch.int32).to(torch.int64) & MASK


def randint(k: Key, shape: Shape, lo: int, hi: int,
            dtype: torch.dtype = torch.int32, device=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, lo, hi, dtype)`` for int32 or uint8:
    two 32-bit (8-bit) draws from ``split(k)``, ``(higher mod span) ·
    (2**nbits mod span) + lower mod span`` in wrapping unsigned arithmetic,
    mod ``span``.  A span that wraps to 0 (``hi`` one past the type's
    largest value) keeps the lower draw, as XLA's ``x % 0 = x`` does."""
    shape = _shape(shape)
    n = math.prod(shape)
    info = {torch.int32: (32, -(1 << 31), (1 << 31) - 1),
            torch.uint8: (8, 0, 255)}.get(dtype)
    if info is None:
        raise ValueError(f"dtype must be int32 or uint8, got {dtype}")
    nbits, tmin, tmax = info
    mask = (1 << nbits) - 1
    lo_c, hi_c = min(max(lo, tmin), tmax), min(max(hi, tmin), tmax)
    span = (hi_c - lo_c) & mask
    if hi <= lo:
        span = 1
    elif hi > tmax:
        span = (span + 1) & mask

    def rem(x, s):
        return x % s if s else x

    mult = rem(rem(1 << (nbits // 2), span) ** 2 & mask, span)
    k1, k2 = split(k)
    dev = resolve_device(device)
    if nbits == 32:
        higher, lower = _words32(k1, n, dev), _words32(k2, n, dev)
    else:
        higher, lower = (threefry_draw(kk, n, "u8", device=dev)
                         .to(torch.int64) for kk in (k1, k2))
    off = ((rem(higher, span) * mult) & mask) + rem(lower, span)
    off = rem(off & mask, span)
    return (off + lo_c).to(dtype).reshape(shape)


def permutation(k: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(k, n)`` (int64): ``ceil(3·ln n /
    ln(2**32 - 1))`` rounds, each a stable sort of the current order by
    fresh 32-bit keys from a new ``split``."""
    dev = resolve_device(device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    x = torch.arange(n, dtype=torch.int64, device=dev)
    kk = as_key(k)
    for _ in range(rounds):
        kk, sub = split(kk)
        order = torch.sort(_words32(sub, n, dev), stable=True).indices
        x = x.index_select(0, order)
    return x


def choice(k: Key, n: int, size: int, device=None) -> torch.Tensor:
    """``jax.random.choice(k, n, (size,), replace=False)``: the first
    ``size`` of ``permutation(k, n)``."""
    if size > n:
        raise ValueError(f"cannot take {size} of {n} without replacement")
    return permutation(k, n, device=device)[:size]
