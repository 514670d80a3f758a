"""The kernel-study path on the CPU: every measurement variant of
``chamjax_torch.benchmarks.kernel_variants`` (its plain version) against
the Pallas kernels of ``benchmarks/kernel_variants.py`` in interpret mode,
the ``debug_ablate`` bodies of ``adc_scan_tiles`` against chamjax's, the
wrappers' refusals, the roofline harness's run layout and the bounds.  The
CUDA kernels are held against the same plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chamjax.ops.scan_seg import pack_luts_bf16 as j_pack
from chamjax.ops.scan_seg_block import adc_scan_tiles as j_adc

from chamjax_torch.benchmarks import bounds
from chamjax_torch.benchmarks import kernel_roofline as troof
from chamjax_torch.benchmarks import kernel_variants as tkv
from chamjax_torch.benchmarks import sass_report
from chamjax_torch.ops.scan_seg import pack_luts_bf16
from chamjax_torch.ops.scan_seg_block import (adc_scan_tiles,
                                              adc_scan_tiles_reference)
from chamjax_torch.perf_model import H100
from chamjax_torch.utils import cuda_lib

from test_torch_scan_kernel import make_inputs

_SPEC = importlib.util.spec_from_file_location(
    "jax_kernel_variants",
    Path(__file__).resolve().parents[1] / "benchmarks" / "kernel_variants.py")
jkv = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jkv)

M, N, SEG, BW, GROUP = 4, 8192, 512, 4, 2


def variant_inputs(seed=0, *, bw=BW):
    """Codes, 512-aligned starts, full lens, LUT rows and f32 LUTs."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (M, N)).astype(np.uint8)
    starts = (rng.integers(0, (N - SEG) // 512, bw) * 512).astype(np.int32)
    lens = np.full(bw, SEG, np.int32)
    lut_idx = rng.integers(0, 3, bw).astype(np.int32)
    luts = rng.random((3, M, 256)).astype(np.float32)
    return codes, starts, lens, lut_idx, luts


def layout(variant, codes):
    """The codes as each variant takes them."""
    if variant == "i32codes":
        return codes.astype(np.int32)
    if variant.startswith("i32view"):
        return codes.view(np.int32).reshape(codes.shape[0], -1)
    if variant.startswith(("contig", "block")):
        m, n = codes.shape
        return np.ascontiguousarray(
            codes.reshape(m, n // SEG, SEG).transpose(1, 0, 2))
    return codes


def both_luts(variant, luts):
    if "bf16" in variant:
        return j_pack(jnp.asarray(luts)), pack_luts_bf16(
            torch.from_numpy(luts))
    return jnp.asarray(luts), torch.from_numpy(luts)


def as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("variant",
                         list(tkv.VARIANTS) + [tkv.BLOCK_VARIANT])
def test_variant_matches_pallas_interpret(variant):
    codes, starts, lens, lut_idx, luts = variant_inputs(1)
    cd = layout(variant, codes)
    j_luts, t_luts = both_luts(variant, luts)
    j_args = (jnp.asarray(cd), jnp.asarray(starts), jnp.asarray(lens),
              jnp.asarray(lut_idx), j_luts)
    t_args = (*as_torch(cd, starts, lens, lut_idx), t_luts)
    cuda_lib.launch_counts.clear()
    if variant == tkv.BLOCK_VARIANT:
        want = jkv.run_block_variant(*j_args, seg=SEG, group=GROUP,
                                     interpret=True)
        got = tkv.run_block_variant(*t_args, seg=SEG, group=GROUP)
        ref = tkv.run_block_variant_reference(*t_args, seg=SEG, group=GROUP)
    else:
        want = jkv.run_variant(*j_args, seg=SEG, group=GROUP,
                               variant=variant, interpret=True)
        got = tkv.run_variant(*t_args, seg=SEG, group=GROUP, variant=variant)
        ref = tkv.run_variant_reference(*t_args, seg=SEG, group=GROUP,
                                        variant=variant)
    assert not cuda_lib.launch_counts        # the CPU runs the plain version
    assert torch.equal(got, ref)
    want, got = np.asarray(want), got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == ((BW, 128) if variant == "bf16_min" else (BW, SEG))
    if variant in tkv.EXACT_VARIANTS:
        np.testing.assert_array_equal(got, want)
    else:                                    # f32 sums over m
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dist_bf16", [False, True])
@pytest.mark.parametrize("lut_bf16", [False, True])
@pytest.mark.parametrize("body", ["copy", "nogather"])
def test_debug_ablate_matches_pallas_interpret(body, lut_bf16, dist_bf16):
    """Lens (some 0, some partial) are ignored; both bodies are exact (a
    code, or an integer sum).  chamjax's bodies store their f32 rows into
    the bf16 block of ``dist_bf16`` and so refuse it; the port writes the
    same rows rounded once to bf16, held here to chamjax's f32 rows
    rounded the same way."""
    codes, tile_idx, lens, lut_idx, luts = make_inputs(
        3, n_tiles=24, m=8, seg=256, bw=32, n_lut=12)
    j_luts = j_pack(jnp.asarray(luts)) if lut_bf16 else luts
    t_luts = (pack_luts_bf16(torch.from_numpy(luts)) if lut_bf16
              else torch.from_numpy(luts))
    j_args = [jnp.asarray(a) for a in (codes, tile_idx, lens, lut_idx,
                                       j_luts)]
    j_kw = dict(seg=256, group=8, interpret=True, lut_bf16=lut_bf16,
                debug_ablate=body)
    if dist_bf16:
        with pytest.raises(ValueError, match="dtype"):
            j_adc(*j_args, dist_bf16=True, **j_kw)
    want = torch.from_numpy(np.array(j_adc(*j_args, **j_kw)))
    if dist_bf16:
        want = want.to(torch.bfloat16)
    opt = dict(lut_bf16=lut_bf16, dist_bf16=dist_bf16, debug_ablate=body)
    args = (*as_torch(codes, tile_idx, lens, lut_idx), t_luts)
    got = adc_scan_tiles(*args, seg=256, group=8, **opt)
    assert torch.equal(got, adc_scan_tiles_reference(*args, seg=256, **opt))
    assert got.dtype == want.dtype and got.shape == want.shape == (32, 256)
    assert torch.equal(got, want)
    tiles = codes[tile_idx].astype(np.int64)
    defn = tiles[:, 0] if body == "copy" else tiles.sum(axis=1)
    np.testing.assert_allclose(got.float().numpy(), defn,
                               rtol=2.0 ** -8 if dist_bf16 else 0)


# one case per precondition: (what to change, message)
REFUSALS = {
    "unknown_variant": (dict(variant="bf16_wide"), "unknown variant"),
    "block_name": (dict(variant="block_bf16t"), "run_block_variant"),
    "group": (dict(group=3, bw=4), "multiple of group"),
    "start_128": (dict(start_delta=64), "multiples of 128"),
    "start_512_bytes": (dict(variant="bytes_f32", start_delta=128),
                        "multiples of 512"),
    "start_512_i32view": (dict(variant="i32view_bf16", start_delta=128),
                          "multiples of 512"),
    "start_seg_contig": (dict(variant="contig_bf16t", start_delta=128),
                         "multiples of 512"),
    "start_past_end": (dict(start_value=N - 256), r"in \[0, "),
    "seg_w4": (dict(variant="bf16_trim_w4", seg=384), "multiple of 512"),
    "seg_bytes": (dict(variant="bytes_bf16", seg=384), "multiple of 512"),
    "seg_i32view": (dict(variant="i32view_f32", seg=384), "multiple of 512"),
    "codes_dtype": (dict(variant="i32codes", codes_as="u8"), "int32 codes"),
    "lut_layout": (dict(variant="bf16_trim", luts_as="f32"), "packed"),
    "lut_idx_range": (dict(lut_value=3), "lut_idx outside"),
    "starts_dtype": (dict(starts_as=torch.int64), "starts is torch.int64"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_run_variant_refuses(case):
    change, msg = REFUSALS[case]
    variant = change.get("variant", "f32")
    seg = change.get("seg", SEG)
    codes, starts, lens, lut_idx, luts = variant_inputs(
        2, bw=change.get("bw", BW))
    starts = starts + change.get("start_delta", 0)
    if "start_value" in change:
        starts[0] = change["start_value"]
    if "lut_value" in change:
        lut_idx[1] = change["lut_value"]
    if change.get("codes_as") == "u8":
        cd = codes
    else:
        cd = layout(variant if seg == SEG else "f32", codes)
        if variant.startswith("i32view"):
            cd = codes.view(np.int32).reshape(M, -1)
    t_luts = both_luts(variant if change.get("luts_as") != "f32" else "f32",
                       luts)[1]
    st = torch.from_numpy(starts).to(change.get("starts_as", torch.int32))
    args = (torch.from_numpy(np.ascontiguousarray(cd)), st,
            *as_torch(lens, lut_idx), t_luts)
    with pytest.raises(ValueError, match=msg):
        tkv.run_variant(*args, seg=seg, group=change.get("group", GROUP),
                        variant=variant)


def test_run_block_variant_refuses_unaligned_tiles():
    codes, starts, lens, lut_idx, luts = variant_inputs(4)
    args = (torch.from_numpy(layout("block_bf16t", codes)),
            torch.from_numpy(starts + 128), *as_torch(lens, lut_idx),
            pack_luts_bf16(torch.from_numpy(luts)))
    with pytest.raises(ValueError, match="multiples of 512"):
        tkv.run_block_variant(*args, seg=SEG, group=GROUP)
    with pytest.raises(ValueError, match="packed"):
        tkv.run_block_variant(*args[:4], torch.from_numpy(luts), seg=SEG,
                              group=GROUP)


def test_debug_ablate_refuses_lane_l1_and_unknown_bodies():
    codes, tile_idx, lens, lut_idx, luts = make_inputs(
        5, n_tiles=4, m=4, seg=128, bw=8, n_lut=3)
    args = as_torch(codes, tile_idx, lens, lut_idx, luts)
    with pytest.raises(ValueError, match="lane_l1"):
        adc_scan_tiles(*args, seg=128, lane_l1=True, debug_ablate="copy")
    with pytest.raises(ValueError, match="debug_ablate"):
        adc_scan_tiles(*args, seg=128, debug_ablate="dma")


def test_run_streams_is_slot_major():
    """Flat window i·G + j is slot j's i-th window: runs of L consecutive
    tiles sharing one LUT row."""
    g = torch.Generator()
    g.manual_seed(0)
    bw, group, runlen = 64, 4, 3
    ti, li = troof.run_streams(bw, group, runlen, 100, 7, g, "cpu")
    assert ti.shape == li.shape == (bw,) and ti.dtype == torch.int32
    slots_t = ti.reshape(bw // group, group).T        # (G, steps)
    slots_l = li.reshape(bw // group, group).T
    for j in range(group):
        for i in range(bw // group):
            r0 = i - i % runlen
            assert slots_t[j, i] == slots_t[j, r0] + i % runlen
            assert slots_l[j, i] == slots_l[j, r0]
    assert int(ti.max()) < 100 and int(li.max()) < 7


ROOF_VARIANTS = ["seg_f32", "seg_bf16", "block_f32", "block_bf16",
                 "block_bf16d", "block_bf16copy", "block_f32nogather"]
ROOF_ARGV = ["--n", "4096", "--m", "4", "--bw", "16", "--n_lut", "5",
             "--segs", "256", "512", "--runlen", "0", "3"]


def no_timing(monkeypatch):
    """The harnesses on the CPU: no CUDA events (their kernels' wrappers
    run the plain versions)."""
    monkeypatch.setattr(troof, "event_ms", lambda fn, **kw: 1.0)
    monkeypatch.setattr(tkv, "event_ms", lambda fn, **kw: 1.0)


def test_roofline_rows_carry_their_bound(monkeypatch):
    """The measurement bodies' rows carry ``ablate_bound`` (no LUT, one
    code row for copy), the tiled scans' ``tile_scan_bound``, the flat
    scans' ``flat_scan_bound``; every row holds its first output against
    its plain version."""
    no_timing(monkeypatch)
    calls = []
    for name in ("ablate_bound", "tile_scan_bound", "flat_scan_bound"):
        def spy(*a, _fn=getattr(bounds, name), _name=name, **kw):
            r = _fn(*a, **kw)
            calls.append((_name, a[0] if _name == "ablate_bound" else None, r))
            return r
        monkeypatch.setattr(troof, name, spy)
    args = troof.parse_args(ROOF_ARGV + ["--variants", *ROOF_VARIANTS])
    rows = [r for r in troof.study(args, torch.device("cpu"), "cpu")
            if "best" not in r]
    assert len(rows) == len(calls) == 2 * 2 * len(ROOF_VARIANTS)
    for row, (name, body, (ms, by)) in zip(rows, calls):
        v = row["variant"]
        want = (("ablate_bound", "copy") if v.endswith("copy") else
                ("ablate_bound", "nogather") if v.endswith("nogather") else
                ("tile_scan_bound", None) if v.startswith("block") else
                ("flat_scan_bound", None))
        assert (name, body) == want, v
        assert (row["bound_ms"], row["bound_by"]) == (ms, by)
        assert row["max_abs_err"] == 0.0     # the CPU runs the plain version
    by_cfg = {(r["variant"], r["seg"], r["runlen"]): r["bound_ms"]
              for r in rows}
    for seg in (256, 512):
        assert (by_cfg[("block_bf16copy", seg, 0)]
                < by_cfg[("block_f32nogather", seg, 0)]
                < by_cfg[("block_bf16", seg, 0)])


@pytest.mark.parametrize("variant", ["seg_bf16", "block_f32",
                                     "block_bf16d", "block_bf16copy"])
def test_roofline_fails_a_kernel_that_disagrees(monkeypatch, variant):
    """A kernel off its plain version by one code (or one bf16 ulp step
    past the tolerance) stops the study before it is timed."""
    no_timing(monkeypatch)
    name = ("adc_scan_segments_multi" if variant.startswith("seg")
            else "adc_scan_tiles")
    real = getattr(troof, name)

    def off(*a, **kw):
        out = real(*a, **kw).clone()
        out[1, 3] = out[1, 3] * 1.02 + 1
        return out
    monkeypatch.setattr(troof, name, off)
    args = troof.parse_args(ROOF_ARGV + ["--variants", variant])
    with pytest.raises(AssertionError, match="plain version"):
        list(troof.study(args, torch.device("cpu"), "cpu"))


@pytest.mark.parametrize("variant", ["nogather", "bf16_trim", "bf16_min"])
def test_variant_study_reports_a_kernel_that_disagrees(monkeypatch, variant):
    """The variant harness holds each variant's first output against its
    plain version: a disagreement is an ``error`` row, an agreement a row
    with ``max_abs_err``."""
    no_timing(monkeypatch)
    argv = ["--n", "8192", "--m", "4", "--bw", "8", "--n_lut", "3",
            "--segs", "512", "--variants", variant]
    rows = list(tkv.study(tkv.parse_args(argv), torch.device("cpu"), "cpu"))
    assert [r.get("max_abs_err") for r in rows] == [0.0]
    real = tkv.run_variant

    def off(*a, **kw):
        out = real(*a, **kw).clone()
        out[0, 5] += 1e-3 + out[0, 5].abs() * 1e-4
        return out
    monkeypatch.setattr(tkv, "run_variant", off)
    rows = list(tkv.study(tkv.parse_args(argv), torch.device("cpu"), "cpu"))
    assert len(rows) == 1 and "plain version" in rows[0]["error"]


def test_cli_defaults_are_the_jax_harnesses():
    a = tkv.parse_args([])
    assert (a.n, a.m, a.bw, a.n_lut, a.segs, a.groups, a.same_lut) == (
        16_000_000, 16, 4096, 4096, [2048], [8], False)
    assert a.variants == ["f32", "bf16", "bf16_trim", "i32codes", "nosum",
                          "nogather"]
    r = troof.parse_args([])
    assert (r.n, r.m, r.bw, r.n_lut, r.segs, r.groups, r.reps, r.runlen) == (
        16_000_000, 16, 4096, 4096, [1024, 2048], [8], 1, [0])
    assert r.variants == ["seg_f32", "seg_bf16", "block_f32", "block_bf16"]
    # the 17 names of the JAX kernel body, each run against it above
    assert len(set(tkv.VARIANTS)) == len(tkv.VARIANTS) == 17
    assert tkv.BLOCK_VARIANT not in tkv.VARIANTS


@pytest.mark.parametrize("variant,bytes_per_col,lut_row_bytes", [
    ("f32", M, M * 256 * 4), ("bf16_trim", M, M * 128 * 4),
    ("nosum", 1, 128 * 4), ("nogather", M, 0),
    ("bf16_trim_nodma", 0, M * 4), ("i32codes", 4 * M, M * 256 * 4)])
def test_variant_bound_counts_what_the_function_needs(variant, bytes_per_col,
                                                      lut_row_bytes):
    """Two windows overlapping by 128 columns, one repeated LUT row: code
    bytes per distinct column, bytes per distinct LUT row."""
    starts = torch.tensor([0, 384], dtype=torch.int32)
    lut_idx = torch.tensor([1, 1], dtype=torch.int32)
    luts = torch.zeros((3, M, 128 if "bf16" in variant else 256))
    codes = torch.zeros((M, N), dtype=torch.uint8)
    ms, by = bounds.variant_bound(variant, codes, starts, lut_idx, luts,
                                  seg=SEG, out_bytes=2 * SEG * 4)
    cols = 384 + SEG
    nbytes = (cols * bytes_per_col + lut_row_bytes
              + (8 if lut_row_bytes else 0) + 8 + 2 * SEG * 4)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / (H100.hbm_gbps * 1e9) * 1e3,
                               rel=1e-12)


def test_ablate_bound_counts_distinct_tiles():
    codes = torch.zeros((10, 8, 256), dtype=torch.uint8)
    tile_idx = torch.tensor([1, 1, 4], dtype=torch.int32)
    for body, rows in (("copy", 1), ("nogather", 8)):
        ms, by = bounds.ablate_bound(body, codes, tile_idx, 3 * 256 * 4)
        nbytes = 2 * rows * 256 + 12 + 3 * 256 * 4
        assert by == "bytes"
        assert ms == pytest.approx(nbytes / (H100.hbm_gbps * 1e9) * 1e3)


def test_sass_report_counts_each_memory_instruction_once():
    """By full opcode and by kind, predicated or not; other opcodes and
    lines outside a function are not counted."""
    sass = """
        /*0000*/                   LDG.E R9, desc[UR4][R2.64] ;
        Function : _Z6kernelPKhPf
        /*0090*/                   LDG.E.U8.CONSTANT R2, desc[UR4][R2.64] ;
        /*00a0*/              @!P0 LDS R3, [R4] ;
        /*00b0*/                   LDS R5, [R4+0x4] ;
        /*00c0*/                   FADD R3, R3, R5 ;
        /*00d0*/               @P1 STG.E [R2.64], R3 ;
        Function : _Z5otherv
        /*0000*/                   LDGSTS.E.BYPASS.128 [R1], desc[UR4][R2.64] ;
    """
    counts = sass_report.parse_sass(sass)
    assert dict(counts["_Z6kernelPKhPf"]) == {
        "LDG": 1, "LDG.E.U8.CONSTANT": 1, "LDS": 2, "STG": 1, "STG.E": 1}
    assert dict(counts["_Z5otherv"]) == {"LDGSTS": 1,
                                         "LDGSTS.E.BYPASS.128": 1}


def test_sass_report_counts_bulk_copies_and_barriers():
    """The bulk copy (``UBLKCP``) and the mbarrier operations (``SYNCS``)
    of a TMA-fed kernel are counted beside its ``cp.async`` copies; uniform
    predicates are read as predicates."""
    sass = """
        Function : _Z6contigv
        /*0100*/                   SYNCS.EXCH.64 URZ, [UR4], UR6 ;
        /*0110*/              @!UP0 UBLKCP.S.G [UR8], [UR10], UR12 ;
        /*0120*/                   SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR4], RZ ;
        /*0130*/                   LDGSTS.E.BYPASS.128 [R1], desc[UR4][R2.64] ;
        /*0140*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R3 ;
        /*0150*/               @P0 LDS R5, [R4] ;
    """
    counts = sass_report.parse_sass(sass)["_Z6contigv"]
    assert dict(counts) == {
        "UBLKCP": 1, "UBLKCP.S.G": 1, "SYNCS": 3, "SYNCS.EXCH.64": 1,
        "SYNCS.ARRIVE.TRANS64.RED.A1T0": 1,
        "SYNCS.PHASECHK.TRANS64.TRYWAIT": 1, "LDGSTS": 1,
        "LDGSTS.E.BYPASS.128": 1, "LDS": 1}


def test_sass_report_sorts_integer_instructions_by_pipe():
    """``pipe_counts``: integer-pipe, IMAD, float32 and special-function
    instructions by pipe, predicated or not, every instruction but NOPs,
    and the funnel-shift rotations (threefry's hashes a kernel holds)."""
    sass = """
        Function : _Z6kernelv
        /*0000*/                   IADD3 R2, R2, R3, RZ ;
        /*0010*/                   SHF.L.W.U32.HI R3, R3, 0xd, R3 ;
        /*0020*/              @!P0 LOP3.LUT R3, R3, R2, RZ, 0x3c, !PT ;
        /*0030*/                   IMAD.IADD R2, R2, 0x1, R3 ;
        /*0040*/                   IMAD.WIDE R4, R0, 0x4, R4 ;
        /*0050*/                   FFMA R6, R6, R7, R8 ;
        /*0060*/                   MUFU.LG2 R6, R6 ;
        /*0070*/                   NOP ;
    """
    assert dict(sass_report.pipe_counts(sass)["_Z6kernelv"]) == {
        "alu": 3, "imad": 2, "fp32": 1, "mufu": 1, "all": 7,
        "rotations": 1}


def test_threefry_bound_counts_the_hash_operations():
    """20 rounds (5 groups of the 4 rotations), each a funnel shift and an
    xor on the integer pipe, plus bits1 ^ bits2: 41 an output, against
    (41 + 32 adds) / 2 were the adds shared; the bytes bound a draw that
    writes more than the hash can produce."""
    from chamjax_torch import random as jr
    assert bounds.THREEFRY_ROUNDS == 5 * len(jr._ROTATIONS[0])
    assert (bounds.THREEFRY_INT_ONLY, bounds.THREEFRY_ADDS) == (41, 32)
    n = 1 << 26
    ms, by = bounds.threefry_bound(n, 4 * n)
    assert by == "operations"
    assert ms == pytest.approx(n * 41 / (H100.int32_tops * 1e12) * 1e3,
                               rel=1e-12)
    ms, by = bounds.threefry_bound(1, 1 << 30)
    assert by == "bytes"
    assert ms == pytest.approx((1 << 30) / (H100.hbm_gbps * 1e9) * 1e3)


@pytest.mark.parametrize("form,nbytes,limit", [
    ("u32", 4, "integer pipe"), ("u8", 1, "integer pipe"),
    ("uniform_f32", 4, "integer pipe"), ("uniform_bf16", 2, "integer pipe"),
    ("normal_f32", 4, "issue"), ("normal_bf16", 2, "issue"),
    ("gumbel_f32", 4, "issue")])
def test_threefry_form_bound_at_phase_two(form, nbytes, limit):
    """The float-aware bound at phase 2's 2**26 outputs: the raw bits and
    uniforms stay bound by the integer pipe's 41 operations an output; a
    normal (its branches weighted as a uniform draw takes them) and a
    gumbel (two logs of 20 operations and the uniform's 2) by issue: the
    hash's 41 + 32 and the float work, 128 lanes an SM a clock."""
    n = 1 << 26
    r = bounds.threefry_form_bound(n, nbytes * n, form)
    lanes = H100.f32_tflops / 2 * 1e12
    assert r["limit"] == limit and r["bound_by"] == "operations"
    assert r["terms_ms"]["integer pipe"] == pytest.approx(
        bounds.threefry_bound(n, nbytes * n)[0], rel=1e-12)
    assert r["terms_ms"]["bytes"] == pytest.approx(
        nbytes * n / (H100.hbm_gbps * 1e9) * 1e3)
    fma, mufu = {"u32": (0, 0), "u8": (0, 0), "uniform_f32": (2, 0),
                 "uniform_bf16": (3, 0), "gumbel_f32": (42, 0)}.get(
                     form, (None, None))
    if form.startswith("normal"):
        small, tail = 0.6435942529056, 0.0033746676906   # u² < √2-1; w ≥ 5
        fma = ((2 if form == "normal_f32" else 3) + 1
               + small * 22 + (1 - small) * 21 + 9 + tail * 3 + 3)
        mufu = small + tail
    assert r["per_output"]["float"] == pytest.approx(fma, rel=1e-8)
    assert r["per_output"]["mufu"] == pytest.approx(mufu, rel=1e-8)
    assert r["terms_ms"]["issue"] == pytest.approx(
        n * (41 + 32 + fma + mufu) / lanes * 1e3, rel=1e-8)
    assert r["bound_ms"] == max(r["terms_ms"].values())
    assert (r["bound_ms"] > bounds.threefry_bound(n, nbytes * n)[0]) == (
        limit == "issue")


@pytest.mark.parametrize("variant,m,seg,want", [
    # LUT row + two 144-byte slot rows a code row (the narrowest item)
    ("f32", 16, 2048, 16 * 1024 + 2 * 16 * 144),
    ("bf16_trim", 16, 128, 16 * 512 + 16 * 144),
    ("i32codes", 16, 2048, 16 * 1024 + 2 * 16 * (4 * 128 + 16)),
    ("bf16_min", 8, 512, 8 * 512 + 2 * 8 * 144 + 4 * 128),
    ("bf16_mxu", 8, 512, 8 * 512 + 2 * 8 * 144 + 4 * 8 * 128),
    # the whole tile and its mbarrier
    ("contig_bf16t", 16, 2048, 16 * 512 + 16 * 2048 + 16)])
def test_smem_bytes_is_the_staged_launchs_least(variant, m, seg, want):
    assert tkv.smem_bytes(variant, m, seg) == want


@pytest.mark.parametrize("variant,name", [
    ("f32", "adc_scan_segments"), ("bf16_mxu", "adc_scan_segments"),
    ("i32codes", "adc_scan_segments"), ("block_bf16t", "adc_scan_tiles"),
    ("contig_bf16t", "adc_scan_tiles")])
def test_counterpart_is_the_production_scan_over_the_same_windows(variant,
                                                                  name):
    """The study's yardstick computes the function of f32 / bf16_trim /
    block_bf16t over the variant's windows (lens = seg), on the CPU its
    plain version."""
    args = tkv.parse_args(["--n", "8192", "--m", "4", "--bw", "8",
                           "--n_lut", "3", "--seed", "1"])
    dev = torch.device("cpu")
    data = tkv.make_data(args, dev)
    starts = torch.arange(8, dtype=torch.int32) * 512
    lens = torch.full((8,), SEG, dtype=torch.int32)
    cd, st = tkv.inputs_for(data, variant, SEG, starts)
    lt = data["luts_p"] if tkv.packed(variant) else data["luts"]
    got_name, fn = tkv.counterpart(variant, data, cd, st, lens,
                                   data["lut_idx"], lt, seg=SEG)
    assert got_name == name
    base = ("block_bf16t" if tkv._tiled(variant) else
            "bf16_trim" if tkv.packed(variant) else "f32")
    if variant == "i32codes":
        cd = data["codes"]
    want = tkv.run_variant_reference(cd, st, lens, data["lut_idx"], lt,
                                     seg=SEG, group=GROUP, variant=base)
    torch.testing.assert_close(fn(), want, rtol=1e-5, atol=1e-5)
