"""Measurement variants of the ADC scan body (the port of
``benchmarks/kernel_variants.py``).

Each variant is the production scan's staged body
(``chamjax_torch/csrc/adc_scan_stage.cuh``) with one step changed, so that
the difference in time prices that step on the card (the table is in
``chamjax_torch/csrc/adc_scan_variants.cu``): the LUT gather
(``nogather``), the sum over m (``nosum``), the packed-bf16 decode
(``bf16`` against ``bf16_trim`` and ``bf16_nodecode``), int32 codes
(``i32codes``), the output order (``bytes_*``, ``i32view_*``), the code
traffic itself (``bf16_trim_nodma``, ``dma_only``), the output writes
(``bf16_min``), rows a thread (``bf16_trim_w4``), a two-pass decode and
reduce (``bf16_mxu``), and one bulk copy of a whole tile against the
``cp.async`` ring (``contig_bf16t`` against ``block_bf16t``).
``--same-lut`` gives every window LUT row 0.

:func:`run_variant` and :func:`run_block_variant` keep the JAX contracts:
on a CUDA tensor they launch ``adc_scan_variants.cu``, on a CPU tensor
they run the plain versions :func:`run_variant_reference` and
:func:`run_block_variant_reference`.  No variant reads ``lens``.

    python -m chamjax_torch.benchmarks.kernel_variants \\
        --variants f32 bf16 bf16_trim nogather --segs 2048

prints one JSON line per (seg, group, variant): the JAX keys (``variant,
seg, group, ms, grows, code_gbs``), ``bound_ms``, ``bound_by``,
``bound_share`` (bound over time), ``max_abs_err`` (the first output
against the plain version, at the same shape), the production
``counterpart`` over the same windows (``adc_scan_segments`` with the
variant's LUTs, ``adc_scan_tiles`` for the tiled layout; lens = seg), its
``counterpart_ms`` and ``minus_counterpart_ms`` (the variant's time less
the counterpart's), and the card's name and power limit.  It needs the
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Iterator, List, Optional

import torch

from chamjax_torch.benchmarks.bounds import variant_bound
from chamjax_torch.ops.scan_seg import adc_scan_segments, pack_luts_bf16
from chamjax_torch.ops.scan_seg_block import adc_scan_tiles
from chamjax_torch.perf_model import H100
from chamjax_torch.utils import cuda_lib
from chamjax_torch.utils.device import card_description, resolve_device

LANES = 128
# run_variant's names, in the order of the kernel's Variant enum
VARIANTS = ("f32", "i32codes", "bf16", "bf16_trim", "bf16_nodecode",
            "bf16_trim_w4", "bf16_trim_nodma", "bf16_min", "bf16_mxu",
            "nosum", "nogather", "dma_only", "bytes_f32", "bytes_bf16",
            "i32view_f32", "i32view_bf16", "contig_bf16t")
BLOCK_VARIANT = "block_bf16t"       # run_block_variant, in the CLI
# variants whose output is exact on the card: a code, an integer sum of
# codes, one LUT entry, or one repeated LUT row summed in the kernels' order
EXACT_VARIANTS = ("nogather", "nosum", "dma_only", "bf16_trim_nodma")
# the harness caps the int32 slab of ``i32codes`` (4x the bytes)
I32_CODES_CAP = 4_000_000
SMEM_LIMIT = int(H100.smem_kb * 1024)   # shared memory one block can use
_NEVER = 0                          # the kernels' sink switch: always 0


def packed(variant: str) -> bool:
    """The variant gathers from packed-bf16 LUTs ``(n_lut, m, 128)``
    int32, else from f32 LUTs ``(n_lut, m, 256)``."""
    return "bf16" in variant


def _tiled(variant: str) -> bool:
    return variant.startswith(("contig", "block"))


def start_multiple(variant: str, seg: int) -> int:
    """What every window start must be a multiple of."""
    if _tiled(variant):
        return seg
    if variant.startswith(("bytes_", "i32view_")):
        return 512
    return LANES


# ---------------------------------------------------------------------------
# input checks
# ---------------------------------------------------------------------------


def smem_bytes(variant: str, m: int, seg: int) -> int:
    """The least shared memory a CTA of ``variant`` runs with at (m, seg)
    (``launch_staged``): the LUT row; for ``contig_bf16t`` the whole tile
    and its mbarrier; else the code slots of the narrowest work item (128
    columns; two where the window is wider), 4 bytes a code for
    ``i32codes``, and ``bf16_min``'s lane buffer or ``bf16_mxu``'s decoded
    entries.  The kernel widens the item as far as the card allows."""
    lut = m * (128 if packed(variant) else 256) * 4
    if variant == "contig_bf16t":
        return lut + m * seg + 16
    elem = 4 if variant == "i32codes" else 1
    slots = 2 if seg > LANES else 1
    return (lut + slots * m * (LANES * elem + 16)
            + (4 * LANES if variant == "bf16_min" else 0)
            + (4 * m * LANES if variant == "bf16_mxu" else 0))


def _check(what: str, codes, starts, lens, lut_idx, luts, *, seg: int,
           group: int, variant: str) -> None:
    """Raise ValueError wherever the TPU kernel would leave output unwritten
    or compute something else, and on what the CUDA kernel does not take.
    Reads ``starts`` and ``lut_idx`` (one device sync)."""
    if variant not in VARIANTS and variant != BLOCK_VARIANT:
        raise ValueError(f"{what}: unknown variant {variant!r}")
    bw = starts.shape[0] if starts.dim() == 1 else -1
    if group < 1 or bw < 0 or bw % group:
        raise ValueError(f"{what}: bW={bw} not a multiple of group={group}")
    wide = variant in ("bf16_trim_w4",) or variant.startswith(
        ("bytes_", "i32view_"))
    if seg <= 0 or seg % LANES or (wide and seg % 512):
        raise ValueError(f"{what}: seg={seg} must be a multiple of "
                         f"{512 if wide else LANES} for {variant}")
    if lens.shape != (bw,) or lut_idx.shape != (bw,):
        raise ValueError(f"{what}: starts, lens, lut_idx must be (bW,) each")
    if _tiled(variant):
        cdt, ndim = torch.uint8, 3
    elif variant == "i32codes" or variant.startswith("i32view"):
        cdt, ndim = torch.int32, 2
    else:
        cdt, ndim = torch.uint8, 2
    if codes.dim() != ndim or codes.dtype != cdt:
        raise ValueError(f"{what}: {variant} takes {ndim}-D {cdt} codes, got "
                         f"{codes.dim()}-D {codes.dtype}")
    if _tiled(variant):
        n_tiles, m, seg_t = codes.shape
        if seg_t != seg:
            raise ValueError(f"{what}: tile width {seg_t} vs seg={seg}")
        n_rows = n_tiles * seg
    else:
        m, n_rows = codes.shape
        if variant.startswith("i32view"):
            n_rows *= 4                 # rows of the uint8 codes it views
    if luts.dim() != 3 or luts.shape[1] != m or luts.shape[2] != (
            128 if packed(variant) else 256) or luts.dtype != (
            torch.int32 if packed(variant) else torch.float32):
        want = ("packed (n_lut, m, 128) int32" if packed(variant)
                else "(n_lut, m, 256) float32")
        raise ValueError(f"{what}: {variant} takes {want} LUTs at m={m}, "
                         f"got {tuple(luts.shape)} {luts.dtype}")
    for name, t in (("starts", starts), ("lens", lens),
                    ("lut_idx", lut_idx)):
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: {name} is {t.dtype}, needs int32")
    for name, t in (("starts", starts), ("lens", lens), ("lut_idx", lut_idx),
                    ("luts", luts)):
        if t.device != codes.device:
            raise ValueError(f"{what}: {name} on {t.device}, codes on "
                             f"{codes.device}")
    dev = codes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda":
        if not all(t.is_contiguous() for t in (codes, starts, lut_idx, luts)):
            raise ValueError(f"{what}: inputs must be contiguous")
        if luts.data_ptr() % 16 or codes.data_ptr() % 16:
            raise ValueError(f"{what}: codes and luts must be 16-byte "
                             f"aligned")
        if variant.startswith("bytes_") and codes.shape[1] % 4:
            raise ValueError(f"{what}: {variant} reads code rows as 32-bit "
                             f"words; n={codes.shape[1]} is not a multiple "
                             f"of 4")
        smem = smem_bytes(variant, m, seg)
        if smem > SMEM_LIMIT:
            raise ValueError(f"{what}: {variant} needs {smem} bytes of "
                             f"shared memory at m={m}, seg={seg} (the card "
                             f"has {SMEM_LIMIT})")
    if bw == 0:
        return
    align = start_multiple(variant, seg)
    span = LANES if variant == "dma_only" else seg
    bad_start = ((starts % align != 0) | (starts < 0)
                 | (starts.long() + span > n_rows))
    bad_lut = (lut_idx < 0) | (lut_idx >= luts.shape[0])
    if bool(bad_start.any()):
        raise ValueError(f"{what}: window starts must be multiples of "
                         f"{align} in [0, {n_rows - span}] for {variant}")
    if bool(bad_lut.any()):
        raise ValueError(f"{what}: lut_idx outside [0, {luts.shape[0]})")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

# windows per chunk of the plain version: its int64 codes stay ~1 GB
_CHUNK_ELEMS = 1 << 27


def _window_codes(codes, st: torch.Tensor, seg: int, variant: str
                  ) -> torch.Tensor:
    """(c, m, seg) int64 codes of the windows starting at ``st`` (rows)."""
    if _tiled(variant):
        return codes[st // seg].long()
    if variant.startswith("i32view"):
        # the int32 words are the uint8 codes in memory (little-endian)
        codes = codes.contiguous().view(torch.uint8).reshape(
            codes.shape[0], -1)
    cols = st[:, None] + torch.arange(seg, device=st.device)
    return codes[:, cols].permute(1, 0, 2).long()


def _sum_m(g: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 in the kernels' order, j = 0, 1, ..., in fp32."""
    acc = g[:, 0].float()
    for j in range(1, g.shape[1]):
        acc = acc + g[:, j]
    return acc


def _variant_dists(c: torch.Tensor, lut: torch.Tensor, variant: str,
                   seg: int) -> torch.Tensor:
    """The function of ``variant`` on window codes ``c`` (w, m, seg) and
    LUT rows ``lut`` (w, m, 256|128)."""
    if variant == "nosum":
        return torch.gather(lut[:, 0], 1, c[:, 0] & (LANES - 1))
    if variant == "nogather":
        return c.sum(dim=1).float()
    if variant == "dma_only":
        return c[:, 0, :LANES].float().repeat(1, seg // LANES)
    if variant == "bf16_nodecode":
        return _sum_m(torch.gather(lut, 2, c >> 1).view(torch.float32))
    if variant == "bf16_trim_nodma":
        c = torch.zeros_like(c)
    if packed(variant):
        # a packed int32 row is its bf16 pairs in memory (little-endian),
        # and bf16 -> f32 is exact, so this is the kernels' bit decode
        lut = lut.contiguous().view(torch.bfloat16)
    dist = _sum_m(torch.gather(lut, 2, c).float())
    if variant == "bf16_min":
        return dist.reshape(dist.shape[0], seg // LANES, LANES).amin(dim=1)
    if variant.startswith(("bytes_", "i32view_")):
        # out[w, b*(seg/4) + f] = dist(row 4f + b)
        return dist.reshape(-1, seg // 4, 4).transpose(1, 2).reshape(-1, seg)
    return dist


def run_variant_reference(codes, starts, lens, lut_idx, luts, *, seg: int,
                          group: int, variant: str) -> torch.Tensor:
    """Plain version of :func:`run_variant` (same contract, no checks)."""
    bw = starts.shape[0]
    m = codes.shape[1] if _tiled(variant) else codes.shape[0]
    width = LANES if variant == "bf16_min" else seg
    if bw == 0:
        return torch.empty((0, width), dtype=torch.float32,
                           device=codes.device)
    step = max(1, _CHUNK_ELEMS // (m * seg))
    outs = []
    for w0 in range(0, bw, step):
        st = starts[w0:w0 + step].long()
        outs.append(_variant_dists(
            _window_codes(codes, st, seg, variant),
            luts[lut_idx[w0:w0 + step].long()], variant, seg))
    return torch.cat(outs)


def run_block_variant_reference(codes_tiled, starts, lens, lut_idx, luts, *,
                                seg: int, group: int) -> torch.Tensor:
    """Plain version of :func:`run_block_variant`: ``bf16_trim`` over the
    tiles ``starts // seg``."""
    return run_variant_reference(codes_tiled, starts, lens, lut_idx, luts,
                                 seg=seg, group=group, variant=BLOCK_VARIANT)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def launch(variant: str, codes, starts, lut_idx, luts, *, seg: int
           ) -> torch.Tensor:
    """Launch one variant on the current stream with no input checks (the
    timing loop's call, after :func:`run_variant` has checked the same
    inputs) and count the launch."""
    bw = starts.shape[0]
    dev = codes.device
    width = LANES if variant == "bf16_min" else seg
    out = torch.empty((bw, width), dtype=torch.float32, device=dev)
    lib = cuda_lib.load("adc_scan_variants")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if variant == BLOCK_VARIANT:
            err = lib.chamjax_run_block_variant(
                codes.data_ptr(), starts.data_ptr(), lut_idx.data_ptr(),
                luts.data_ptr(), out.data_ptr(), bw, codes.shape[1], seg,
                _NEVER, stream)
            name = "run_block_variant"
        else:
            m = codes.shape[1] if _tiled(variant) else codes.shape[0]
            stride = codes.shape[-1] if _tiled(variant) else codes.shape[1]
            if variant.startswith("bytes_"):
                stride //= 4            # uint8 rows read as 32-bit words
            err = lib.chamjax_run_variant(
                codes.data_ptr(), stride, starts.data_ptr(),
                lut_idx.data_ptr(), luts.data_ptr(), out.data_ptr(), bw, m,
                seg, VARIANTS.index(variant), _NEVER, stream)
            name = "run_variant"
    cuda_lib.check(lib, err, f"{name}[{variant}]")
    cuda_lib.launch_counts[name] += 1
    return out


def run_variant(codes, starts, lens, lut_idx, luts, *, seg: int, group: int,
                variant: str) -> torch.Tensor:
    """``(bW, seg)`` float32 (``(bW, 128)`` for ``bf16_min``): the
    function of ``variant`` over windows ``[starts[w], starts[w] + seg)``
    of ``codes`` with LUT row ``lut_idx[w]``; ``lens`` is not read.

    codes: (m, n) uint8; (m, n) int32 for ``i32codes``; the (m, n/4) int32
    view of the uint8 codes for ``i32view_*``; (n/seg, m, seg) uint8 for
    ``contig_bf16t``, window w reading tile ``starts[w] // seg``.  LUTs:
    packed bf16 ``(n_lut, m, 128)`` int32 for the names holding ``bf16``,
    else ``(n_lut, m, 256)`` float32.  Raises ValueError on an unknown
    variant, ``bW % group``, misaligned or out-of-range starts (multiples
    of 128; 512 for ``bytes_*``/``i32view_*``; seg for ``contig``), seg
    not a multiple of 512 for ``bf16_trim_w4``/``bytes_*``/``i32view_*``,
    and dtype or shape mismatches.  CPU tensors run
    :func:`run_variant_reference`; CUDA tensors launch the kernel."""
    if variant == BLOCK_VARIANT:
        raise ValueError(f"run_variant: {variant!r} is run_block_variant's")
    _check("run_variant", codes, starts, lens, lut_idx, luts, seg=seg,
           group=group, variant=variant)
    if codes.device.type == "cpu":
        return run_variant_reference(codes, starts, lens, lut_idx, luts,
                                     seg=seg, group=group, variant=variant)
    if starts.shape[0] == 0:
        width = LANES if variant == "bf16_min" else seg
        return torch.empty((0, width), dtype=torch.float32,
                           device=codes.device)
    return launch(variant, codes, starts, lut_idx, luts, seg=seg)


def run_block_variant(codes_tiled, starts, lens, lut_idx, luts, *, seg: int,
                      group: int) -> torch.Tensor:
    """``bf16_trim`` over the seg-tiled layout (n/seg, m, seg) uint8,
    window w reading tile ``starts[w] // seg`` (starts are row starts,
    multiples of seg) through the staged ``cp.async`` ring, as
    ``adc_scan_tiles`` reads its tiles; packed LUTs.  Same checks as
    :func:`run_variant`."""
    _check("run_block_variant", codes_tiled, starts, lens, lut_idx, luts,
           seg=seg, group=group, variant=BLOCK_VARIANT)
    if codes_tiled.device.type == "cpu":
        return run_block_variant_reference(codes_tiled, starts, lens,
                                           lut_idx, luts, seg=seg,
                                           group=group)
    if starts.shape[0] == 0:
        return torch.empty((0, seg), dtype=torch.float32,
                           device=codes_tiled.device)
    return launch(BLOCK_VARIANT, codes_tiled, starts, lut_idx, luts, seg=seg)


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


def hold(what: str, got: torch.Tensor, want: torch.Tensor, *, exact: bool,
         bf16: bool = False) -> float:
    """Max abs error of a kernel's output ``got`` against its plain
    version's ``want``; raises AssertionError where they disagree: not
    bit-equal where ``exact``, more than one bf16 ulp apart where ``bf16``,
    else outside rtol 1e-5 (atol 1e-5)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"the plain version's {tuple(want.shape)} "
                             f"{want.dtype}")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if exact:
        ok = torch.equal(got, want)
    elif bf16:
        ok = bool(((g - w).abs()
                   <= torch.maximum(g.abs(), w.abs()) * 2.0 ** -7).all())
    else:
        ok = bool(torch.allclose(g, w, rtol=1e-5, atol=1e-5))
    if not ok:
        raise AssertionError(f"{what} disagrees with its plain version (max "
                             f"abs err {err})")
    return err


def event_ms(fn, launches: int = 10, reps: int = 5, warmup: int = 3
             ) -> float:
    """Device ms of one call of ``fn``: CUDA events around ``launches``
    back-to-back calls after ``warmup`` calls, the median of ``reps``.

    A short kernel runs faster than the host enqueues it (a wrapper's
    checks and launch take tens of microseconds), so timed as it is
    enqueued the events would measure the host.  Each repetition first
    holds the card in a spin kernel (``torch.cuda._sleep``) for twice the
    time the host took to enqueue ``launches`` calls, and checks that the
    first event had not yet run when the host finished: the calls then run
    back to back on the device.  Where it had (a call that waits on the
    card, or a slow host), the spin is doubled, up to four times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # cycles at 2 GHz, above the card's clock: the spin lasts at least this
    cycles = int(4e9 * enqueue_s) + 100_000
    times = []
    for _ in range(reps):
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            a.record()
            for _ in range(launches):
                fn()
            b.record()
            held = not a.query()
            b.synchronize()
            if held:
                break
            cycles *= 2
        times.append(a.elapsed_time(b) / launches)
    times.sort()
    return times[len(times) // 2]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16_000_000)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--bw", type=int, default=4096)
    ap.add_argument("--n_lut", type=int, default=4096)
    ap.add_argument("--segs", type=int, nargs="+", default=[2048])
    ap.add_argument("--groups", type=int, nargs="+", default=[8])
    ap.add_argument("--variants", nargs="+",
                    default=["f32", "bf16", "bf16_trim", "i32codes",
                             "nosum", "nogather"])
    ap.add_argument("--same-lut", action="store_true",
                    help="lut_idx all zero: every window reads LUT row 0")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def make_data(args: argparse.Namespace, dev: torch.device) -> Dict:
    """The harness's slab, LUTs and LUT assignment, drawn on the card from
    ``args.seed``: codes (m, n) uint8, LUTs (n_lut, m, 256) f32 in [0, 1)
    and packed, lut_idx (bW,) (all 0 with ``--same-lut``)."""
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    m, n, bw = args.m, args.n, args.bw
    codes = torch.randint(0, 256, (m, n), generator=g, device=dev,
                          dtype=torch.uint8)
    luts = torch.rand((args.n_lut, m, 256), generator=g, device=dev)
    lut_idx = (torch.zeros(bw, dtype=torch.int32, device=dev)
               if args.same_lut else
               torch.randint(0, args.n_lut, (bw,), generator=g, device=dev,
                             dtype=torch.int32))
    return dict(codes=codes, luts=luts, luts_p=pack_luts_bf16(luts),
                lut_idx=lut_idx, gen=g, args=args, cache={})


def inputs_for(data: Dict, variant: str, seg: int, starts: torch.Tensor):
    """(codes, starts) for one variant, as the JAX harness lays them out:
    the u8 slab with 512-aligned starts; an int32 copy of its first
    ``I32_CODES_CAP`` columns with 128-aligned starts (``i32codes``); its
    int32 view (``i32view_*``); its seg-tiled twin with tile starts
    (``contig``/``block``)."""
    codes, g, cache = data["codes"], data["gen"], data["cache"]
    m, n = codes.shape
    bw, dev = starts.shape[0], codes.device
    if variant == "i32codes":
        if "i32" not in cache:
            cache["i32"] = codes[:, :min(n, I32_CODES_CAP)].to(torch.int32)
        cd = cache["i32"]
        st = torch.randint(0, (cd.shape[1] - seg) // LANES, (bw,),
                           generator=g, device=dev,
                           dtype=torch.int32) * LANES
        return cd, st
    if variant.startswith("i32view"):
        return codes.view(torch.int32), starts
    if _tiled(variant):
        if cache.get("tiled_seg") != seg:
            cache.pop("tiled", None)
            cache["tiled"] = (codes[:, :(n // seg) * seg]
                              .reshape(m, n // seg, seg).transpose(0, 1)
                              .contiguous())
            cache["tiled_seg"] = seg
        st = torch.randint(0, n // seg - 1, (bw,), generator=g, device=dev,
                           dtype=torch.int32) * seg
        return cache["tiled"], st
    return codes, starts


def counterpart(variant: str, data: Dict, cd, st, lens, lut_idx, luts, *,
                seg: int):
    """``(name, fn)``: the production scan over the variant's windows
    (lens = seg), the study's yardstick: ``adc_scan_tiles`` (packed LUTs,
    f32 out) over the tiles of ``contig``/``block``, else
    ``adc_scan_segments`` with the variant's LUTs over the same columns of
    the uint8 slab."""
    if _tiled(variant):
        tiles = st // seg
        return "adc_scan_tiles", lambda: adc_scan_tiles(
            cd, tiles, lens, lut_idx, luts, seg=seg, lut_bf16=True)
    codes = data["codes"]
    return "adc_scan_segments", lambda: adc_scan_segments(
        codes, st, lens, lut_idx, luts, seg=seg, lut_bf16=packed(variant))


def study(args: argparse.Namespace, dev: torch.device,
          card: str) -> Iterator[Dict]:
    """Yield one row per (seg, group, variant), its first output held
    against its plain version (:func:`hold`) before it is timed, then its
    production :func:`counterpart` timed over the same windows; a variant
    that raises or disagrees yields an ``error`` row and the study goes
    on."""
    data = make_data(args, dev)
    m, n, bw = args.m, args.n, args.bw
    for seg in args.segs:
        starts = torch.randint(0, (n - seg) // 512, (bw,),
                               generator=data["gen"], device=dev,
                               dtype=torch.int32) * 512
        lens = torch.full((bw,), seg, dtype=torch.int32, device=dev)
        for group in args.groups:
            for variant in args.variants:
                row = dict(variant=variant, seg=seg, group=group)
                try:
                    cd, st = inputs_for(data, variant, seg, starts)
                    lt = data["luts_p"] if packed(variant) else data["luts"]
                    li = data["lut_idx"]
                    call = (cd, st, lens, li, lt)
                    if variant == BLOCK_VARIANT:
                        out = run_block_variant(*call, seg=seg, group=group)
                        want = run_block_variant_reference(
                            *call, seg=seg, group=group)
                    else:
                        out = run_variant(*call, seg=seg, group=group,
                                          variant=variant)
                        want = run_variant_reference(
                            *call, seg=seg, group=group, variant=variant)
                    err = hold(f"{variant} seg {seg}", out, want,
                               exact=variant in EXACT_VARIANTS)
                    del want
                    ms = event_ms(lambda: launch(variant, cd, st, li, lt,
                                                 seg=seg))
                    bound_ms, bound_by = variant_bound(
                        variant, cd, st, li, lt, seg=seg,
                        out_bytes=out.numel() * 4)
                    prod, prod_fn = counterpart(variant, data, cd, st, lens,
                                                li, lt, seg=seg)
                    prod_ms = event_ms(prod_fn)
                except Exception as e:  # noqa: BLE001 — one variant's fault
                    yield dict(row, error=f"{type(e).__name__}: "
                                          f"{str(e)[:800]}")
                    continue
                grows = bw * seg / ms / 1e6
                yield dict(row, ms=ms, grows=grows, code_gbs=grows * m,
                           bound_ms=bound_ms, bound_by=bound_by,
                           bound_share=bound_ms / ms, max_abs_err=err,
                           counterpart=prod, counterpart_ms=prod_ms,
                           minus_counterpart_ms=ms - prod_ms,
                           same_lut=args.same_lut, card=card)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    dev = resolve_device(None)          # raises without a card
    card = card_description()
    failed = False
    for row in study(args, dev, card):
        failed |= "error" in row
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
