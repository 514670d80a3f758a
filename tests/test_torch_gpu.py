"""chamjax_torch on an NVIDIA card: the CUDA kernels (the scans, their
``debug_ablate`` bodies and the measurement variants) against their plain
versions, the query routes (tiled, flat, padded-window, host-streamed) on
the card against the same routes on the CPU, profiler tracing of the
card, the RALM path, the captured graphs (``utils/graphs.py``) against
their eager runs, and the index build (the hard stream, the bf16
shortlist, a preset-quantizer build against ``factory.populate``) and the
retrieval-quality path (the IR IVF-PQ search against the xla oracle, dual
encoder training against the CPU, the Hamming count, mining's IVF-PQ
branch, the RAG reader captured against eager).  Every test is marked ``gpu`` and skips where there
is no card.  This file imports neither jax nor chamjax, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import contextlib

import numpy as np
import pytest
import torch

from chamjax_torch import random as jr
from chamjax_torch.benchmarks import kernel_variants as kv
from chamjax_torch.config import IndexConfig, SearchConfig
from chamjax_torch.data import synthetic_dataset
from chamjax_torch.eval import tie_mismatches
from chamjax_torch.index import build_ivfpq
from chamjax_torch.ops.scan_pallas import (adc_scan_distances,
                                           adc_scan_distances_reference)
from chamjax_torch.ops.scan_seg import (adc_scan_segments,
                                        adc_scan_segments_reference,
                                        pack_luts_bf16)
from chamjax_torch.ops.scan_seg_block import (adc_scan_tiles,
                                              adc_scan_tiles_reference)
from chamjax_torch.ops.scan_seg_multi import (
    adc_scan_segments_multi, adc_scan_segments_multi_reference)
from chamjax_torch.searcher import IVFSearcher
from chamjax_torch.streamed import HostStreamedSearcher
from chamjax_torch.utils import cuda_lib, tracing

OPTION_SETS = {
    "f32_lut": dict(lut_bf16=False),
    "bf16_lut": dict(lut_bf16=True),
    "dist_bf16": dict(lut_bf16=False, dist_bf16=True),
    "lane_l1": dict(lut_bf16=True, lane_l1=True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda", 0)


def make_inputs(seed, *, n_tiles, m, seg, bw, n_lut):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (n_tiles, m, seg)).astype(np.uint8)
    tile_idx = rng.integers(0, n_tiles, bw).astype(np.int32)
    tile_idx[1::5] = tile_idx[0]                          # repeated tiles
    lens = rng.integers(1, seg, bw).astype(np.int32)       # partial
    lens[::3] = seg                                        # full
    lens[2::7] = 0                                         # empty
    lut_idx = rng.integers(0, n_lut, bw).astype(np.int32)
    luts = (rng.random((n_lut, m, 256)) * 4.0).astype(np.float32)
    return codes, tile_idx, lens, lut_idx, luts


@pytest.mark.gpu
@pytest.mark.parametrize("m", [16, 64])
@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_kernel_matches_plain_on_card(cuda_device, name, m):
    """Flagship widths (seg=512, bW=4096); m=64 with f32 LUTs needs 64 KB
    of shared memory, past the 48 KB default."""
    opt = OPTION_SETS[name]
    arrays = make_inputs(7, n_tiles=4096 if m == 16 else 512, m=m, seg=512,
                         bw=4096, n_lut=4096 if m == 16 else 512)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    if opt["lut_bf16"]:
        args[4] = pack_luts_bf16(args[4])
    before = cuda_lib.launch_counts["adc_scan_tiles"]
    got = adc_scan_tiles(*args, seg=512, group=8, **opt)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["adc_scan_tiles"] == before + 1
    want = adc_scan_tiles_reference(*args, seg=512, **opt)
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    if opt.get("lane_l1"):
        g, w = g[:, 0], w[:, 0]
        full = adc_scan_tiles_reference(*args, seg=512, lut_bf16=True)
        groups = full.reshape(4096, 4, 128).cpu().numpy()
        srt = np.sort(groups, axis=1)
        with np.errstate(invalid="ignore"):
            unique = np.isfinite(srt[:, 0]) & ~(
                srt[:, 1] - srt[:, 0] <= 1e-4 * np.abs(srt[:, 0]) + 1e-4)
        gt_ = got[:, 1].contiguous().view(torch.int32).cpu().numpy()
        wt = want[:, 1].contiguous().view(torch.int32).cpu().numpy()
        np.testing.assert_array_equal(gt_[unique], wt[unique])
    assert np.array_equal(np.isinf(g), np.isinf(w))
    fin = np.isfinite(w)
    if opt.get("dist_bf16"):      # one bf16 ulp
        mag = np.maximum(np.abs(g[fin]), np.abs(w[fin]))
        assert np.all(np.abs(g[fin] - w[fin]) <= mag * 2.0 ** -7)
    else:
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_empty_batch_launches_nothing(cuda_device):
    arrays = make_inputs(1, n_tiles=4, m=16, seg=512, bw=8, n_lut=4)
    args = [torch.from_numpy(a).to(cuda_device)[:0] if i in (1, 2, 3)
            else torch.from_numpy(a).to(cuda_device)
            for i, a in enumerate(arrays)]
    before = cuda_lib.launch_counts["adc_scan_tiles"]
    out = adc_scan_tiles(*args, seg=512)
    assert out.shape == (0, 512)
    assert cuda_lib.launch_counts["adc_scan_tiles"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("lut_bf16", [False, True])
def test_search_on_card_matches_cpu(cuda_device, lut_bf16):
    ds = synthetic_dataset(nb=20000, nq=64, nt=8000, d=32, seed=3,
                           n_clusters=64)
    cfg = IndexConfig(dim=32, nlist=64, m=8, opq=True, balanced=True,
                      balance_hard=True, balance_factor=2.0)
    idx = build_ivfpq(ds.xb, cfg, xt=ds.xt, kmeans_iters=4, pq_iters=4,
                      device=cuda_device)
    assert int(idx.list_len.max()) <= int(np.ceil(20000 / 64 * 2.0))
    scfg = SearchConfig(nprobe=8, k=10, seg=256, lut_bf16=lut_bf16)
    before = cuda_lib.launch_counts["adc_scan_tiles"]
    d_g, i_g = IVFSearcher(idx, scfg, device=cuda_device).search(ds.xq)
    assert cuda_lib.launch_counts["adc_scan_tiles"] == before + 1
    d_c, i_c = IVFSearcher(idx, scfg, device="cpu").search(ds.xq)
    # f32 LUTs: sum order only.  Packed bf16: the two devices' fp32 LUTs may
    # differ in the last bit, and an entry next to a bf16 rounding boundary
    # then rounds to the neighbouring bf16 — up to 2^-8 of that entry.
    rtol = 2.0 ** -8 if lut_bf16 else 1e-5
    np.testing.assert_allclose(d_g, d_c, rtol=rtol, atol=1e-5)
    assert not tie_mismatches(d_g, i_g, d_c, i_c, rtol=rtol, atol=1e-5)


FLAT_CASES = {
    "multi_f32": (adc_scan_segments_multi, adc_scan_segments_multi_reference,
                  dict(lut_bf16=False)),
    "multi_bf16": (adc_scan_segments_multi,
                   adc_scan_segments_multi_reference, dict(lut_bf16=True)),
    "multi_lane_l1": (adc_scan_segments_multi,
                      adc_scan_segments_multi_reference,
                      dict(lut_bf16=True, lane_l1=True)),
    "segments_f32": (adc_scan_segments, adc_scan_segments_reference,
                     dict(lut_bf16=False)),
    "segments_bf16": (adc_scan_segments, adc_scan_segments_reference,
                      dict(lut_bf16=True)),
}


def make_flat(seed, *, m, n_cols, width, bw, n_lut):
    """Flat codes, starts that are multiples of 64 (one at the tail of
    codes_t, one past it), full, partial and empty windows."""
    rng = np.random.default_rng(seed)
    codes_t = rng.integers(0, 256, (m, n_cols)).astype(np.uint8)
    starts = (rng.integers(0, (n_cols - width) // 64, bw) * 64).astype(
        np.int32)
    lens = rng.integers(1, width, bw).astype(np.int32)
    lens[::3] = width
    lens[2::7] = 0
    starts[3], lens[3] = n_cols - width, width       # ends at the tail
    starts[4], lens[4] = n_cols - 64, width          # runs past it
    lut_idx = rng.integers(0, n_lut, bw).astype(np.int32)
    luts = (rng.random((n_lut, m, 256)) * 4.0).astype(np.float32)
    return codes_t, starts, lens, lut_idx, luts


def assert_same_scan(got, want, full=None):
    """allclose(1e-5) with the same finite mask; for lane_l1 the winning
    group equal wherever the minimum is unique."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if full is not None:
        groups = full.reshape(full.shape[0], -1, 128).cpu().numpy()
        srt = np.sort(groups, axis=1)
        unique = np.isfinite(srt[:, 0])
        if groups.shape[1] > 1:                    # else one group: 0
            with np.errstate(invalid="ignore"):
                unique &= ~(srt[:, 1] - srt[:, 0]
                            <= 1e-4 * np.abs(srt[:, 0]) + 1e-4)
        np.testing.assert_array_equal(g[:, 1].view(np.int32)[unique],
                                      w[:, 1].view(np.int32)[unique])
        g, w = g[:, 0], w[:, 0]
    assert np.array_equal(np.isinf(g), np.isinf(w))
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [16, 64])
@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_kernel_matches_plain_on_card(cuda_device, case, m):
    """seg=512 windows over a flat layout; m=64 with f32 LUTs needs 64 KB
    of shared memory, past the 48 KB default."""
    fn, ref, opt = FLAT_CASES[case]
    arrays = make_flat(11, m=m, n_cols=200_000 + 64, width=512, bw=1024,
                       n_lut=512)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    if opt["lut_bf16"]:
        args[4] = pack_luts_bf16(args[4])
    extra = dict(group=8) if fn is adc_scan_segments_multi else {}
    before = sum(cuda_lib.launch_counts.values())
    got = fn(*args, seg=512, **extra, **opt)
    torch.cuda.synchronize()
    assert sum(cuda_lib.launch_counts.values()) == before + 1
    want = ref(*args, seg=512, **opt)
    full = (ref(*args, seg=512, lut_bf16=opt["lut_bf16"])
            if opt.get("lane_l1") else None)
    assert_same_scan(got, want, full)
    if not opt.get("lane_l1"):      # window 4: 64 rows, then past the tail
        assert torch.isfinite(got[4, :64]).all()
        assert torch.isinf(got[4, 64:]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("scan_len", [1024, 4096])
def test_distances_kernel_matches_plain_on_card(cuda_device, scan_len):
    """Lens from 0 to above scan_len, lists shorter than one chunk."""
    codes_t, starts, lens, _li, _l = make_flat(
        5, m=16, n_cols=300_000 + 64, width=scan_len, bw=512, n_lut=1)
    rng = np.random.default_rng(scan_len)
    lens = rng.integers(0, scan_len + 2000, 512).astype(np.int32)
    lens[::5] = rng.integers(0, 300, lens[::5].shape)
    lens[1::9] = 0
    luts = (rng.random((512, 16, 256)) * 4.0).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (codes_t, starts, lens, luts)]
    before = cuda_lib.launch_counts["adc_scan_distances"]
    got = adc_scan_distances(*args, scan_len=scan_len)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["adc_scan_distances"] == before + 1
    assert_same_scan(got, adc_scan_distances_reference(*args,
                                                       scan_len=scan_len))


STAGE_LENS = (0, 1, 15, 16, 17)      # with seg - 1 and seg


def stage_windows(rng, bw, width, n_lut):
    """Window lengths 0, 1, 15, 16, 17, width-1, width and random ones, and
    LUT rows in runs of repeats."""
    lens = rng.integers(0, width + 1, bw).astype(np.int32)
    fixed = [*STAGE_LENS, width - 1, width]
    lens[:len(fixed)] = fixed
    lut_idx = np.repeat(rng.integers(0, n_lut, bw), rng.integers(1, 9, bw))
    return lens, lut_idx[:bw].astype(np.int32)


def assert_bf16_scan(got, want):
    """bf16 distances within one bf16 ulp, +inf where the plain one is."""
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.array_equal(np.isinf(g), np.isinf(w))
    fin = np.isfinite(w)
    mag = np.maximum(np.abs(g[fin]), np.abs(w[fin]))
    assert np.all(np.abs(g[fin] - w[fin]) <= mag * 2.0 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("lut_bf16", [False, True])
@pytest.mark.parametrize("seg", [128, 512, 2048, 4096])
@pytest.mark.parametrize("m", [8, 16, 32, 64])
def test_staged_tiles_match_plain_on_card(cuda_device, m, seg, lut_bf16):
    """The staged tiled scan at every width and m (seg 2048 and 4096 go
    through the two-slot ring in chunks), lengths at the 16-byte copy
    edges, runs of one LUT row, bW = 37: f32, bf16 and lane_l1 outputs."""
    rng = np.random.default_rng(m * seg)
    bw, n_tiles, n_lut = 37, 24, 9
    codes = rng.integers(0, 256, (n_tiles, m, seg)).astype(np.uint8)
    tile_idx = rng.integers(0, n_tiles, bw).astype(np.int32)
    lens, lut_idx = stage_windows(rng, bw, seg, n_lut)
    luts = torch.from_numpy(
        (rng.random((n_lut, m, 256)) * 4.0).astype(np.float32))
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (codes, tile_idx, lens, lut_idx)]
    args.append((pack_luts_bf16(luts) if lut_bf16 else luts).to(cuda_device))
    kw = dict(seg=seg, group=1, lut_bf16=lut_bf16)
    full = adc_scan_tiles_reference(*args, seg=seg, lut_bf16=lut_bf16)
    assert_same_scan(adc_scan_tiles(*args, **kw), full)
    assert_bf16_scan(adc_scan_tiles(*args, dist_bf16=True, **kw),
                     adc_scan_tiles_reference(*args, seg=seg,
                                              lut_bf16=lut_bf16,
                                              dist_bf16=True))
    assert_same_scan(adc_scan_tiles(*args, lane_l1=True, **kw),
                     adc_scan_tiles_reference(*args, seg=seg,
                                              lut_bf16=lut_bf16,
                                              lane_l1=True), full)
    torch.cuda.synchronize()


def unaligned_flat(rng, *, m, width, bw, n_lut):
    """A codes_t whose n_cols is 7 mod 16 (so every code row has its own
    misalignment), window starts at every residue mod 16, one window ending
    on the last column and one running past it."""
    n_cols = 16 * 2500 + 7
    codes_t = rng.integers(0, 256, (m, n_cols)).astype(np.uint8)
    starts = (rng.integers(0, (n_cols - width) // 16, bw) * 16
              + np.arange(bw) % 16).astype(np.int32)
    lens, lut_idx = stage_windows(rng, bw, width, n_lut)
    starts[-1], lens[-1] = n_cols - 37, width     # runs past the end
    starts[-2], lens[-2] = n_cols - 100, 100      # ends on the last column
    return codes_t, starts, lens, lut_idx


@pytest.mark.gpu
@pytest.mark.parametrize("lut_bf16", [False, True])
@pytest.mark.parametrize("seg", [128, 512, 2048, 4096])
@pytest.mark.parametrize("m", [8, 16, 32, 64])
def test_staged_flat_match_plain_on_card(cuda_device, m, seg, lut_bf16):
    """The staged flat scans over unaligned starts and rows: both segment
    entry points and lane_l1 (bW = 41)."""
    rng = np.random.default_rng(m + seg)
    n_lut = 9
    arrays = unaligned_flat(rng, m=m, width=seg, bw=41, n_lut=n_lut)
    luts = torch.from_numpy(
        (rng.random((n_lut, m, 256)) * 4.0).astype(np.float32))
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    args.append((pack_luts_bf16(luts) if lut_bf16 else luts).to(cuda_device))
    full = adc_scan_segments_reference(*args, seg=seg, lut_bf16=lut_bf16)
    assert_same_scan(adc_scan_segments(*args, seg=seg, lut_bf16=lut_bf16),
                     full)
    assert_same_scan(adc_scan_segments_multi(*args, seg=seg, group=1,
                                             lut_bf16=lut_bf16), full)
    assert_same_scan(
        adc_scan_segments_multi(*args, seg=seg, group=1, lut_bf16=lut_bf16,
                                lane_l1=True),
        adc_scan_segments_multi_reference(*args, seg=seg, lut_bf16=lut_bf16,
                                          lane_l1=True), full)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 16, 32, 64])
@pytest.mark.parametrize("scan_len", [1024, 4096])
def test_staged_distances_match_plain_on_card(cuda_device, scan_len, m):
    """Lists empty, shorter than scan_len and longer, at unaligned starts."""
    rng = np.random.default_rng(scan_len + m)
    codes_t, starts, _l, _li = unaligned_flat(rng, m=m, width=scan_len,
                                              bw=53, n_lut=1)
    lens = rng.integers(0, scan_len + 500, 53).astype(np.int32)
    lens[:8] = [0, 1, 15, 16, 17, scan_len - 1, scan_len, scan_len + 1]
    luts = (rng.random((53, m, 256)) * 4.0).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (codes_t, starts, lens, luts)]
    assert_same_scan(adc_scan_distances(*args, scan_len=scan_len),
                     adc_scan_distances_reference(*args, scan_len=scan_len))


@pytest.mark.gpu
def test_staged_f32_lut_at_m128_on_card(cuda_device):
    """f32 LUTs at m=128: a 128 KB LUT row, 196 KB of shared memory with
    the code slot, above the 48 KB a launch gets without opting in; runs
    of one LUT row and changes between them."""
    rng = np.random.default_rng(128)
    m, seg, n_lut = 128, 512, 5
    lens, lut_idx = stage_windows(rng, 23, seg, n_lut)
    luts = torch.from_numpy(
        (rng.random((n_lut, m, 256)) * 4.0).astype(np.float32)).to(
            cuda_device)
    codes = rng.integers(0, 256, (6, m, seg)).astype(np.uint8)
    tiles = [torch.from_numpy(a).to(cuda_device)
             for a in (codes, rng.integers(0, 6, 23).astype(np.int32), lens,
                       lut_idx)]
    assert_same_scan(adc_scan_tiles(*tiles, luts, seg=seg, group=1),
                     adc_scan_tiles_reference(*tiles, luts, seg=seg))
    flat = [torch.from_numpy(a).to(cuda_device)
            for a in unaligned_flat(rng, m=m, width=seg, bw=23,
                                    n_lut=n_lut)]
    assert_same_scan(adc_scan_segments(*flat, luts, seg=seg),
                     adc_scan_segments_reference(*flat, luts, seg=seg))


@pytest.fixture(scope="module")
def card_index():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    ds = synthetic_dataset(nb=20000, nq=64, nt=8000, d=32, seed=3,
                           n_clusters=64)
    cfg = IndexConfig(dim=32, nlist=64, m=8, list_pad=64, opq=True,
                      balanced=True, balance_factor=1.5)
    idx = build_ivfpq(ds.xb, cfg, xt=ds.xt, kmeans_iters=4, pq_iters=4,
                      device="cuda")
    return ds, idx


ROUTES = {
    "flat_g8": (dict(tiled=False, seg_group=8), "adc_scan_segments_multi"),
    "flat_g1": (dict(tiled=False, seg_group=1), "adc_scan_segments"),
    "pallas": (dict(backend="pallas"), "adc_scan_distances"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_on_card_matches_cpu(card_index, route):
    """f32 LUTs: the card's route equals the same route on the CPU (sum
    order only)."""
    ds, idx = card_index
    kw, kernel = ROUTES[route]
    scfg = SearchConfig(nprobe=8, k=10, seg=256, lut_bf16=False, **kw)
    before = cuda_lib.launch_counts[kernel]
    d_g, i_g = IVFSearcher(idx, scfg, device="cuda").search(ds.xq)
    assert cuda_lib.launch_counts[kernel] == before + 1
    d_c, i_c = IVFSearcher(idx, scfg, device="cpu").search(ds.xq)
    np.testing.assert_allclose(d_g, d_c, rtol=1e-5, atol=1e-5)
    assert not tie_mismatches(d_g, i_g, d_c, i_c, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("tiled", [True, False])
def test_streamed_on_card_matches_cpu(card_index, tiled):
    ds, idx = card_index
    scfg = SearchConfig(nprobe=8, k=10, seg=256, lut_bf16=False,
                        tiled=tiled)
    kernel = "adc_scan_tiles" if tiled else "adc_scan_segments_multi"
    st = HostStreamedSearcher(idx, scfg, device="cuda")
    before = cuda_lib.launch_counts[kernel]
    d_g, i_g = st.search(ds.xq)
    assert cuda_lib.launch_counts[kernel] == before + 1
    d_c, i_c = HostStreamedSearcher(idx, scfg, device="cpu").search(ds.xq)
    np.testing.assert_allclose(d_g, d_c, rtol=1e-5, atol=1e-5)
    assert not tie_mismatches(d_g, i_g, d_c, i_c, rtol=1e-5, atol=1e-5)
    # two pinned buffers in turn: the pipelined stream equals search
    batches = [ds.xq[i:i + 16] for i in range(0, 64, 16)]
    for (d_p, i_p), q in zip(st.search_pipelined(batches), batches):
        d_s, i_s = st.search(q)
        np.testing.assert_array_equal(d_p, d_s)
        np.testing.assert_array_equal(i_p, i_s)


def variant_args(variant, seg, dev, *, m=16, n=1 << 18, bw=512, n_lut=64,
                 same_lut=False):
    """Codes in the layout the variant takes, window starts (multiples of
    512; tile starts for the tiled layouts; a third of the windows overlap
    the window before them, or repeat its tile), full lens, LUT rows (all
    0 with ``same_lut``) and LUTs (packed for the names holding bf16)."""
    rng = np.random.default_rng(seg)
    codes = rng.integers(0, 256, (m, n)).astype(np.uint8)
    align = kv.start_multiple(variant, seg)
    starts = (rng.integers(0, (n - seg) // 512, bw) * 512).astype(np.int32)
    if variant == "i32codes":
        codes = codes.astype(np.int32)
    elif variant.startswith("i32view"):
        codes = codes.view(np.int32).reshape(m, n // 4)
    elif variant.startswith(("contig", "block")):
        codes = np.ascontiguousarray(
            codes.reshape(m, n // seg, seg).transpose(1, 0, 2))
        starts = (rng.integers(0, n // seg, bw) * seg).astype(np.int32)
    over = starts[0:-1:3] + (0 if align == seg else align)
    starts[1::3] = np.minimum(over, (n - seg) // align * align)
    lens = np.full(bw, seg, np.int32)
    lut_idx = (np.zeros(bw, np.int32) if same_lut
               else rng.integers(0, n_lut, bw).astype(np.int32))
    luts = torch.from_numpy(
        (rng.random((n_lut, m, 256)) * 4.0).astype(np.float32)).to(dev)
    if kv.packed(variant):
        luts = pack_luts_bf16(luts)
    return [torch.from_numpy(a).to(dev)
            for a in (codes, starts, lens, lut_idx)] + [luts]


# seg 256 for the variants that take it (the others need multiples of 512)
VARIANT_CASES = [(v, seg) for v in (*kv.VARIANTS, kv.BLOCK_VARIANT)
                 for seg in (256, 512, 1024, 2048)
                 if seg % 512 == 0 or not (
                     v == "bf16_trim_w4" or v.startswith(("bytes_", "i32view_")))]


@pytest.mark.gpu
@pytest.mark.parametrize("same_lut", [False, True])
@pytest.mark.parametrize("variant,seg", VARIANT_CASES)
def test_variant_matches_plain_on_card(cuda_device, variant, seg, same_lut):
    args = variant_args(variant, seg, cuda_device, same_lut=same_lut)
    if variant == kv.BLOCK_VARIANT:
        name, fn, ref = ("run_block_variant", kv.run_block_variant,
                         kv.run_block_variant_reference)
        kw = dict(seg=seg, group=8)
    else:
        name, fn, ref = ("run_variant", kv.run_variant,
                         kv.run_variant_reference)
        kw = dict(seg=seg, group=8, variant=variant)
    before = cuda_lib.launch_counts[name]
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts[name] == before + 1
    want = ref(*args, **kw)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (512, 128 if variant == "bf16_min"
                                       else seg)
    if variant in kv.EXACT_VARIANTS:
        assert torch.equal(got, want)
    else:                                    # f32 sums over m
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("seg", [512, 2048])
@pytest.mark.parametrize("lut_bf16", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_production_scans_bit_equal_in_order_sums_on_card(cuda_device, tiled,
                                                          lut_bf16, seg):
    """adc_scan_tiles and adc_scan_segments at fixed inputs (full lens)
    are bit-equal to fp32 sums over j in order: the plain versions of the
    kernel study's f32 / bf16_trim bodies (run_variant_reference), which
    sum as the staged body does.  The study's hooks in the shared body
    must leave these outputs as they were."""
    variant = "bf16_trim" if lut_bf16 else "f32"
    codes, starts, lens, lut_idx, luts = variant_args(variant, seg,
                                                      cuda_device)
    if tiled:
        starts = starts // seg * seg
    want = kv.run_variant_reference(codes, starts, lens, lut_idx, luts,
                                    seg=seg, group=8, variant=variant)
    if tiled:
        m, n = codes.shape
        tiles = codes.reshape(m, n // seg, seg).transpose(0, 1).contiguous()
        got = adc_scan_tiles(tiles, starts // seg, lens, lut_idx, luts,
                             seg=seg, group=8, lut_bf16=lut_bf16)
    else:
        got = adc_scan_segments(codes, starts, lens, lut_idx, luts, seg=seg,
                                lut_bf16=lut_bf16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_variant_refuses_on_card(cuda_device):
    """The card's wrapper keeps the CPU one's checks, plus the card's."""
    args = variant_args("f32", 512, cuda_device)
    with pytest.raises(ValueError, match="multiples of 128"):
        kv.run_variant(args[0], args[1] + 64, *args[2:], seg=512, group=8,
                       variant="f32")
    with pytest.raises(ValueError, match="contiguous"):
        kv.run_variant(args[0][:, ::2], *args[1:], seg=512, group=8,
                       variant="f32")
    with pytest.raises(ValueError, match="shared memory"):
        # the whole (64, 4096) tile of one bulk copy is past 227 KB
        wide = variant_args("contig_bf16t", 4096, cuda_device, m=64,
                            n=1 << 16, bw=8)
        kv.run_variant(*wide, seg=4096, group=8, variant="contig_bf16t")


# each variant's instantiation of the staged body, as its demangled name
# gives it: <packed LUT, OutMode, Body, flat, lens read> (adc_scan_stage.cuh)
STAGED_BODY = {
    "f32": (0, 0, 0, 1), "i32codes": (0, 0, 8, 1), "bf16": (1, 0, 3, 1),
    "bf16_trim": (1, 0, 0, 1), "bf16_nodecode": (1, 0, 4, 1),
    "bf16_trim_w4": (1, 0, 9, 1), "bf16_trim_nodma": (1, 0, 7, 1),
    "bf16_min": (1, 3, 0, 1), "bf16_mxu": (1, 0, 10, 1),
    "nosum": (0, 0, 5, 1), "nogather": (0, 0, 2, 1), "dma_only": (0, 0, 6, 1),
    "bytes_f32": (0, 4, 0, 1), "bytes_bf16": (1, 4, 0, 1),
    "i32view_f32": (0, 4, 0, 1), "i32view_bf16": (1, 4, 0, 1),
    "contig_bf16t": (1, 0, 11, 0), "block_bf16t": (1, 0, 0, 0),
}


def staged_args(kernel: str):
    """The template arguments of a demangled ``adc_scan_staged_kernel``
    name as ints, bools as 0/1 (with or without ``(bool)`` casts)."""
    import re
    inner = re.search(r"adc_scan_staged_kernel<(.*?)>", kernel).group(1)
    args = [re.sub(r"^\(\w+\)", "", a.strip()) for a in inner.split(",")]
    return tuple(1 if a == "true" else 0 if a == "false" else int(a)
                 for a in args)


@pytest.mark.gpu
def test_variants_sass_on_card(cuda_device):
    """From the SASS (sass_report): no variant loads codes byte by byte;
    contig_bf16t issues a bulk copy on an mbarrier; bf16_trim_nodma copies
    only its LUT row (fewer cp.async than bf16_trim, which also copies the
    codes); every variant has its instantiation."""
    from chamjax_torch.benchmarks import sass_report
    rows = {staged_args(r["kernel"]): r["counts"]
            for r in sass_report.report("adc_scan_variants")}
    for variant, body in STAGED_BODY.items():
        counts = rows[(*body, 0)]
        assert not any(op.startswith("LDG.E.U8") for op in counts), variant
        assert counts.get("LDGSTS", 0) >= 1, variant      # the LUT row
    contig = rows[(*STAGED_BODY["contig_bf16t"], 0)]
    assert contig.get("UBLKCP", 0) >= 1 and contig.get("SYNCS", 0) >= 1
    for variant, body in STAGED_BODY.items():
        if variant != "contig_bf16t":
            assert not rows[(*body, 0)].get("UBLKCP"), variant
    assert (rows[(*STAGED_BODY["bf16_trim_nodma"], 0)]["LDGSTS"]
            < rows[(*STAGED_BODY["bf16_trim"], 0)]["LDGSTS"])


@pytest.mark.gpu
@pytest.mark.parametrize("dist_bf16", [False, True])
@pytest.mark.parametrize("lut_bf16", [False, True])
@pytest.mark.parametrize("body", ["copy", "nogather"])
@pytest.mark.parametrize("seg", [512, 1024, 2048])
def test_debug_ablate_matches_plain_on_card(cuda_device, seg, body, lut_bf16,
                                            dist_bf16):
    """Flagship widths and the roofline's segs; lens (some 0, some
    partial) are ignored and both bodies are exact."""
    arrays = make_inputs(9, n_tiles=(1 << 21) // seg, m=16, seg=seg,
                         bw=4096, n_lut=4096)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    if lut_bf16:
        args[4] = pack_luts_bf16(args[4])
    opt = dict(lut_bf16=lut_bf16, dist_bf16=dist_bf16, debug_ablate=body)
    before = cuda_lib.launch_counts["adc_scan_tiles"]
    got = adc_scan_tiles(*args, seg=seg, group=8, **opt)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["adc_scan_tiles"] == before + 1
    want = adc_scan_tiles_reference(*args, seg=seg, **opt)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_trace_records_the_kernel_on_card(cuda_device, tmp_path):
    arrays = make_inputs(2, n_tiles=64, m=16, seg=512, bw=256, n_lut=64)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    with tracing.trace(str(tmp_path)) as prof:
        with tracing.annotate("chamjax_scan"):
            adc_scan_tiles(*args, seg=512)
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("adc_scan_staged_kernel" in k for k in kernels), kernels
    (trace_file,) = tmp_path.glob("*.pt.trace.json")
    text = trace_file.read_text()
    assert "chamjax_scan" in text and "adc_scan_staged_kernel" in text


@pytest.mark.gpu
def test_device_memory_profile_on_card(cuda_device, tmp_path):
    x = torch.empty(1 << 20, device=cuda_device)
    path = tmp_path / "mem.pickle"
    tracing.device_memory_profile(str(path))
    assert path.stat().st_size > 0
    del x


# ---------------------------------------------------------------------------
# the RALM serving path: models, the retrieved-token hash, the fused loop
# ---------------------------------------------------------------------------

RALM_SHAPE = dict(embed_dim=64, ffn_embed_dim=128, layers=3,
                  attention_heads=4, vocab_size=97, max_seq_len=16)
RALM_FAMILIES = {"decoder": {}, "llama": dict(ffn_embed_dim=160, kv_heads=2),
                 "encoder-decoder": dict(encoder_layers=2)}


@pytest.mark.gpu
@pytest.mark.parametrize("vocab,tokens_per_doc", [(50000, 64), (97, 8)])
def test_ids_to_tokens_device_on_card(cuda_device, vocab, tokens_per_doc):
    """The uint32 wrapping hash on the card, bit-equal to numpy in uint64
    (every intermediate below 2^64, reduced mod 2^32); -1 hashes as
    4294967295."""
    from chamjax_torch.serving.ralm import _ids_to_tokens_device
    rng = np.random.default_rng(vocab)
    ids = np.concatenate([
        np.array([[-1, 0, 1, 2 ** 31 - 1], [-2 ** 31, 123456789, -7, 9]]),
        rng.integers(-2 ** 31, 2 ** 31 - 1, (30, 4))]).astype(np.int32)
    u = ids.astype(np.uint32).astype(np.uint64)
    base = (u[:, :, None] * np.uint64(2654435761) + np.uint64(7)
            + np.arange(tokens_per_doc, dtype=np.uint64)[None, None, :]
            * np.uint64(40503)) % np.uint64(2 ** 32)
    want = (base % np.uint64(vocab - 2)).astype(np.int32).reshape(
        len(ids), -1) + 1
    got = _ids_to_tokens_device(torch.from_numpy(ids).to(cuda_device),
                                tokens_per_doc, vocab)
    assert got.is_cuda and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def ralm_config(family, dtype="float32"):
    from chamjax_torch.config import ModelConfig
    return ModelConfig(model_type=family, dtype=dtype,
                       **dict(RALM_SHAPE, **RALM_FAMILIES[family]))


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(RALM_FAMILIES))
def test_model_steps_on_card_match_cpu(cuda_device, family):
    """Three decode steps (a cross-attention step over an encoded context
    for the encoder-decoder) on the card against the same f32 parameters
    on the CPU: rtol = atol = 2e-4, the JAX package's bar (TF32 is off by
    default for float32 matmuls)."""
    from chamjax_torch import models
    from chamjax_torch.benchmarks.ralm_device_bench import init_params
    from chamjax_torch.models.transformer import build_cross_kv
    from chamjax_torch.serving.ralm import step_fns
    cfg = ralm_config(family)
    card = init_params(cfg, 0, cuda_device)
    cpu = init_params(cfg, 1, "cpu")
    cards, cpus = ((card, cpu) if family == "encoder-decoder"
                   else ((card,), (cpu,)))
    for c, h in zip(cpus, cards):
        c.load_state_dict(h.state_dict())
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (3, 2)).astype(np.int32)
    step, cache_fn = step_fns(cfg)
    cross = {}
    if family == "encoder-decoder":
        src = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)).astype(
            np.int32))
        vl = torch.tensor([4, 6], dtype=torch.int32)
        for name, (enc, dec), dev in (("cpu", cpus, "cpu"),
                                      ("card", cards, cuda_device)):
            out = models.encoder_forward(enc, src.to(dev), 4,
                                         valid_len=vl.to(dev))
            cross[name] = dict(cross_kv=build_cross_kv(dec, out, 4),
                               cross_valid_len=vl.to(dev))
        np.testing.assert_allclose(cross["card"]["cross_kv"][0].cpu().numpy(),
                                   cross["cpu"]["cross_kv"][0].numpy(),
                                   rtol=2e-4, atol=2e-4)
    c_card = cache_fn(cfg, 2, device=cuda_device)
    c_cpu = cache_fn(cfg, 2, device="cpu")
    for t in toks:
        lg, hid, c_card = step(cards[-1], torch.from_numpy(t).to(cuda_device),
                               c_card, **cross.get("card", {}))
        lr, hr, c_cpu = step(cpus[-1], torch.from_numpy(t), c_cpu,
                             **cross.get("cpu", {}))
        np.testing.assert_allclose(lg.cpu().numpy(), lr.numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(hid.cpu().numpy(), hr.numpy(), rtol=2e-4,
                                   atol=2e-4)
    assert c_card.idx.is_cuda and int(c_card.idx) == 3
    np.testing.assert_allclose(c_card.k.cpu().numpy(), c_cpu.k.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def ralm_retriever():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    from chamjax_torch.retrieval import LocalRetriever
    d = RALM_SHAPE["embed_dim"]
    ds = synthetic_dataset(nb=20000, nq=8, nt=8000, d=d, seed=3,
                           n_clusters=64)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=d, nlist=64, m=8, list_pad=64,
                                         balanced=True),
                      xt=ds.xt, kmeans_iters=4, pq_iters=4, device="cuda")
    return LocalRetriever(idx, SearchConfig(nprobe=8, k=10), device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(RALM_FAMILIES))
def test_fused_ralm_on_card_makes_no_host_sync(ralm_retriever, family):
    """A short fused run (decode → hidden state → search on the card) under
    ``set_sync_debug_mode("error")``: no step reads a device value on the
    host, and every retrieval step launches the tiled kernel.  The last
    retrieval equals ``IVFSearcher.search`` of the same queries up to
    ties."""
    from chamjax_torch.benchmarks.ralm_device_bench import (init_params,
                                                            no_host_sync)
    from chamjax_torch.serving.ralm import RalmDecoder, RalmEncoderDecoder

    class Recorder:
        def __init__(self, inner):
            self.inner, self.queries = inner, None

        def retrieve_device(self, queries, nprobe, k):
            self.queries = queries
            return self.inner.retrieve_device(queries, nprobe, k)

    cfg = ralm_config(family, dtype="bfloat16")
    params = init_params(cfg, 0, "cuda")
    rec = Recorder(ralm_retriever)
    if family == "encoder-decoder":
        loop = RalmEncoderDecoder(*params, cfg, rec, 4, retrieval_interval=2,
                                  nprobe=8, k=10)
    else:
        loop = RalmDecoder(params, cfg, rec, 4, retrieval_interval=2,
                           nprobe=8, k=10)
    loop.multi_steps(2)                 # the kernels are built by now
    dev = torch.device("cuda", torch.cuda.current_device())
    with no_host_sync(dev):             # the check is not vacuous
        with pytest.raises(RuntimeError):
            torch.ones(1, device=dev).item()
    before = cuda_lib.launch_counts["adc_scan_tiles"]
    with no_host_sync(dev):
        loop.multi_steps(6)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["adc_scan_tiles"] == before + 3
    assert loop.tokens.is_cuda and int(loop.cache.idx) == 8
    res = loop.last_result
    d_s, i_s = ralm_retriever.searcher.search(rec.queries.cpu().numpy(),
                                              nprobe=8, k=10)
    assert not tie_mismatches(res.dists.cpu().numpy(),
                              res.ids.cpu().numpy().astype(np.int64), d_s,
                              i_s, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the captured step: each graph against its eager run (disable_capture)
# ---------------------------------------------------------------------------


def assert_close(got, want, rtol=1e-5):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=rtol,
                                   atol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(RALM_FAMILIES))
def test_captured_steps_equal_eager_on_card(cuda_device, family):
    """Four decode steps (with cross K/V over an encoded context for the
    encoder-decoder: encoder_forward and build_cross_kv captured too),
    captured and replayed, against the same steps under disable_capture,
    f32 (rtol = atol = 1e-5); one graph for the steps."""
    from chamjax_torch.benchmarks.ralm_device_bench import init_params
    from chamjax_torch.models.transformer import build_cross_kv
    from chamjax_torch.models import encoder_forward
    from chamjax_torch.serving.ralm import step_fns
    from chamjax_torch.utils import graphs
    cfg = ralm_config(family)
    params = init_params(cfg, 0, cuda_device)
    *enc, dec = params if family == "encoder-decoder" else (params,)
    step, cache_fn = step_fns(cfg)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2)).astype(
        np.int32)).to(cuda_device)
    src = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)).astype(
        np.int32)).to(cuda_device)
    runs = []
    for captured in (True, False):
        with (graphs.disable_capture() if not captured
              else contextlib.nullcontext()):
            cross = {}
            if enc:
                out = encoder_forward(enc[0], src, 4)
                cross = dict(cross_kv=build_cross_kv(dec, out, 4))
            cache = cache_fn(cfg, 2, device=cuda_device)
            outs = [out] if enc else []
            for t in toks:
                lg, hid, cache = step(dec, t, cache, **cross)
                outs += [lg, hid]
            outs += [cache.k, cache.v]
            runs.append(outs)
        assert len(cache.graphs) == int(captured)
        if enc:
            assert len(enc[0].graphs) == len(dec.graphs) == 1
    assert_close(runs[0], runs[1])
    assert int(cache.idx) == 4 and cache.host_idx == 4


SEARCH_ROUTES = {
    "tiled": dict(),
    "flat_g8": dict(tiled=False, seg_group=8),
    "flat_g1": dict(tiled=False, seg_group=1),
    "pallas": dict(backend="pallas"),
    "xla": dict(backend="xla"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(SEARCH_ROUTES))
def test_captured_search_equals_eager_on_card(card_index, route):
    """ivfpq_search on each backend and ivfpq_search_preassigned, captured
    and replayed (one graph each, owned by the DeviceIVF) against eager:
    distances rtol 1e-5, ids equal up to ties; each replay adds its
    kernel's launch, as an eager call does."""
    from chamjax_torch.searcher import ivfpq_search_preassigned
    from chamjax_torch.utils import graphs
    ds, idx = card_index
    scfg = SearchConfig(nprobe=8, k=10, seg=256, lut_bf16=False,
                        **SEARCH_ROUTES[route])
    s = IVFSearcher(idx, scfg, device="cuda")
    lists = np.random.default_rng(1).integers(0, 64, (len(ds.xq), 8))
    before = dict(cuda_lib.launch_counts)
    got = [s.search(ds.xq) for _ in range(3)]
    got_l = s.search_preassigned(ds.xq, lists)
    assert len(s.dev.graphs) == 2
    captured_launches = {k: v - before.get(k, 0)
                         for k, v in cuda_lib.launch_counts.items()}
    before = dict(cuda_lib.launch_counts)
    with graphs.disable_capture():
        want = [s.search(ds.xq) for _ in range(3)]
        want_l = s.search_preassigned(ds.xq, lists)
    eager_launches = {k: v - before.get(k, 0)
                      for k, v in cuda_lib.launch_counts.items()}
    assert captured_launches == eager_launches
    assert len(s.dev.graphs) == 2
    for (d_g, i_g), (d_e, i_e) in zip(got + [got_l], want + [want_l]):
        np.testing.assert_allclose(d_g, d_e, rtol=1e-5, atol=1e-5)
        assert not tie_mismatches(d_g, i_g, d_e, i_e, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_captured_search_keeps_tf32_off_on_card(card_index):
    """The search's matmuls replay as captured, with TF32 off, even when the
    caller turns TF32 on: the card still equals the CPU at rtol 1e-5."""
    ds, idx = card_index
    scfg = SearchConfig(nprobe=8, k=10, seg=256, lut_bf16=False,
                        backend="xla")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        s = IVFSearcher(idx, scfg, device="cuda")
        d_g, i_g = s.search(ds.xq)
        d_g, i_g = s.search(ds.xq)               # a replay
        assert len(s.dev.graphs) == 1
    finally:
        torch.set_float32_matmul_precision(prev)
    d_c, i_c = IVFSearcher(idx, scfg, device="cpu").search(ds.xq)
    np.testing.assert_allclose(d_g, d_c, rtol=1e-5, atol=1e-5)
    assert not tie_mismatches(d_g, i_g, d_c, i_c, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(RALM_FAMILIES))
def test_reset_does_not_capture_again_on_card(ralm_retriever, family):
    """A reset empties the loop's buffers in place: the run after it
    replays the graphs captured before it and repeats the first run."""
    from chamjax_torch.benchmarks.ralm_device_bench import init_params
    from chamjax_torch.serving.ralm import RalmDecoder, RalmEncoderDecoder
    cfg = ralm_config(family, dtype="bfloat16")
    params = init_params(cfg, 0, "cuda")
    cls = RalmEncoderDecoder if family == "encoder-decoder" else RalmDecoder
    loop = cls(*(params if family == "encoder-decoder" else (params,)), cfg,
               ralm_retriever, 4, retrieval_interval=2, nprobe=8, k=10)

    def n_graphs():
        owners = [loop.cache.graphs, ralm_retriever.searcher.dev.graphs]
        if family == "encoder-decoder":
            owners += [loop._cross.graphs, loop.enc.graphs]
        return [len(o) for o in owners]

    runs = []
    for _ in range(2):
        loop.multi_steps(4)
        runs.append((loop.tokens.clone(), loop.last_result.ids.clone(),
                     n_graphs()))
        loop.reset_inference_state()
        assert loop.cache.host_idx == 0 and int(loop.cache.idx) == 0
    assert runs[0][2] == runs[1][2]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["decoder", "encoder-decoder"])
def test_tiktok_states_do_not_alias_on_card(ralm_retriever, family):
    """Two tik-tok states seeded with different first tokens, each on its
    own graphs, equal to a sequential loop from the same tokens."""
    from chamjax_torch.benchmarks.ralm_device_bench import init_params
    from chamjax_torch.serving.ralm import RalmDecoder, RalmEncoderDecoder
    from chamjax_torch.serving.tiktok import (TikTokDecoder,
                                              TikTokEncoderDecoder)
    cfg = ralm_config(family, dtype="bfloat16")
    params = init_params(cfg, 0, "cuda")
    ps = params if family == "encoder-decoder" else (params,)
    kw = dict(retrieval_interval=2, nprobe=8, k=10)
    tik_cls, seq_cls = ((TikTokEncoderDecoder, RalmEncoderDecoder)
                        if family == "encoder-decoder"
                        else (TikTokDecoder, RalmDecoder))
    seeds = {"tik": torch.tensor([5, 9, 11, 3], dtype=torch.int32),
             "tok": torch.tensor([17, 2, 40, 8], dtype=torch.int32)}
    tt = tik_cls(*ps, cfg, ralm_retriever, 4, **kw)
    for name, seed in seeds.items():
        tt.states[name].tokens.copy_(seed)
    tt.batch_inference(5)
    for name, seed in seeds.items():
        seq = seq_cls(*ps, cfg, ralm_retriever, 4, **kw)
        seq.tokens.copy_(seed)
        seq.multi_steps(5)
        st = tt.states[name]
        assert torch.equal(st.tokens, seq.tokens), name
        assert torch.equal(st.last_result.ids, seq.last_result.ids), name


@pytest.mark.gpu
def test_failed_capture_raises_on_card(cuda_device):
    """A function that reads a device value on the host cannot be captured:
    the call raises, the owner keeps no graph, and the card still works."""
    from chamjax_torch.utils import graphs

    def reads_the_host(x):
        return x * float(x.sum())

    owner = graphs.Graphs()
    x = torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError):
        graphs.call(owner, reads_the_host, x)
    assert len(owner) == 0
    torch.cuda.synchronize()
    assert float(torch.ones(3, device=cuda_device).sum()) == 3.0


@pytest.mark.gpu
@pytest.mark.parametrize("coarse_cand", [0, 16])
def test_index_scanner_captured_equals_eager_on_card(card_index,
                                                     coarse_cand):
    """The scanner's graph replays the eager coarse scan bit for bit, and
    agrees with the scan on the CPU up to the order of ties."""
    from chamjax_torch.retrieval import IndexScanner
    from chamjax_torch.utils import graphs
    ds, idx = card_index
    sc = IndexScanner(idx.centroids, nprobe=8, coarse_cand=coarse_cand,
                      opq_R=idx.opq_R, device="cuda")
    sc.search(ds.xq)                        # captures
    lids, dists = sc.search(ds.xq)          # replays
    assert len(sc.graphs) == 1
    with graphs.disable_capture():
        lids_e, dists_e = sc.search(ds.xq)
    np.testing.assert_array_equal(lids, lids_e)
    np.testing.assert_array_equal(dists, dists_e)
    lids_c, dists_c = IndexScanner(idx.centroids, nprobe=8,
                                   coarse_cand=coarse_cand, opq_R=idx.opq_R,
                                   device="cpu").search(ds.xq)
    np.testing.assert_allclose(dists, dists_c, rtol=1e-5, atol=1e-4)
    assert not tie_mismatches(dists, lids, dists_c, lids_c, rtol=1e-5,
                              atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("tiled", [True, False])
def test_streamed_native_and_numpy_gathers_on_card(card_index, tiled):
    """The native gather writes the pinned staging buffer; the results
    equal the numpy gather's bit for bit, sequential and pipelined."""
    ds, idx = card_index
    scfg = SearchConfig(nprobe=8, k=10, seg=256, tiled=tiled)
    st_n = HostStreamedSearcher(idx, scfg, device="cuda", gather="native")
    st_p = HostStreamedSearcher(idx, scfg, device="cuda", gather="numpy")
    assert st_n.gather_path == "native"
    for a, b in zip(st_n.search(ds.xq), st_p.search(ds.xq)):
        np.testing.assert_array_equal(a, b)
    batches = [ds.xq[i:i + 16] for i in range(0, 64, 16)]
    for (d_n, i_n), (d_p, i_p) in zip(st_n.search_pipelined(batches),
                                      st_p.search_pipelined(batches)):
        np.testing.assert_array_equal(d_n, d_p)
        np.testing.assert_array_equal(i_n, i_p)
    assert st_n._bufs[0].is_pinned()


@pytest.mark.gpu
def test_spawned_engine_answers_preassigned_on_card(card_index, tmp_path):
    """An engine process (spawn) serving the index on the card answers a
    preassigned request as the in-process search does; its launch counts
    show the tiled kernel."""
    import multiprocessing
    import socket
    import time
    from chamjax_torch.retrieval import ExternalRetriever, IndexScanner
    from chamjax_torch.retrieval.engine import run_engine
    ds, idx = card_index
    path = str(tmp_path / "index.npz")
    idx.save(path)
    scfg = SearchConfig(nprobe=8, k=10, seg=256)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    report = ctx.Queue()
    proc = ctx.Process(target=run_engine, args=(path, port), kwargs=dict(
        backend="local", device="cuda", search_cfg=scfg, with_lists=True,
        warm=(16,), report=report), daemon=True)
    proc.start()
    try:
        client = None
        for _ in range(1200):
            try:
                client = ExternalRetriever("127.0.0.1", port, 16, 32, 10,
                                           timeout=120)
                break
            except OSError:
                assert proc.is_alive(), proc.exitcode
                time.sleep(0.1)
        assert client is not None
        q = ds.xq[:16]
        lids, _ = IndexScanner(idx.centroids, nprobe=8, opq_R=idx.opq_R,
                               device="cuda").search(q)
        res = client.retrieve_with_lists(q, lids, 10)
        client.close()
        d_r, i_r = IVFSearcher(idx, scfg, device="cuda").search(q)
        np.testing.assert_allclose(res.dists, d_r, rtol=1e-5, atol=1e-5)
        assert not tie_mismatches(res.dists, res.ids, d_r, i_r, rtol=1e-5,
                                  atol=1e-5)
        kind, out = report.get(timeout=120)
        assert kind == "done", out
        assert out["served"] == [1]
        assert out["launches"].get("adc_scan_tiles", 0) >= 1
    finally:
        proc.join(timeout=120)
        if proc.is_alive():
            proc.kill()
    assert proc.exitcode == 0


@pytest.mark.gpu
def test_hard_draw_chunk_invariant_on_card(cuda_device):
    """The hard-mode stream on the card: a two-chunk draw equals its two
    one-chunk draws, a second corpus from the seed draws the same rows, and
    (Philox, not MT19937) the card's rows differ from the CPU's."""
    from chamjax_torch.data.hard import GEN, make_hard_corpus
    hc = make_hard_corpus(d=32, n_clusters=4096, seed=7, device=cuda_device)
    a = hc.draw_base(0, 2 * GEN)
    assert a.device.type == "cuda" and a.dtype == torch.float32
    b = torch.cat([hc.draw_base(0, GEN), hc.draw_base(GEN, GEN)])
    assert torch.equal(a, b)
    again = make_hard_corpus(d=32, n_clusters=4096, seed=7,
                             device=cuda_device)
    assert torch.equal(again.draw_base(GEN, GEN), b[GEN:])
    cpu = make_hard_corpus(d=32, n_clusters=4096, seed=7, device="cpu")
    assert not torch.equal(cpu.draw_base(0, GEN), a[:GEN].cpu())
    q = hc.queries(64, jitter=0.3)
    assert q.shape == (64, 32) and bool(torch.isfinite(q).all())


@pytest.mark.gpu
def test_bf16_shortlist_assignment_on_card(cuda_device):
    """The build's two-stage assignment on the card (bf16 stage-1 GEMM with
    fp32 output, shortlist 8, fp32 re-rank) against the exact fp32 argmin
    (TF32 off): the same cell for ≥ 99.9% of 2^20 hard-mode rows over
    16384 cells; stage 1 really rounds (its scores differ from fp32)."""
    from chamjax_torch.data.hard import GEN, make_hard_corpus
    from chamjax_torch.index import device_build as db
    from chamjax_torch.utils.precision import fp32_matmul
    hc = make_hard_corpus(d=128, n_clusters=65536, seed=3,
                          device=cuda_device)
    x = hc.draw_base(0, GEN)
    cent = hc.draw_train(0, GEN)[:16384].contiguous()
    a = db._assign_blocked(x, cent, block=4096, cand=8).long()
    with fp32_matmul():
        exact = torch.cat([
            torch.argmax(2.0 * x[s:s + 4096] @ cent.T
                         - torch.sum(cent * cent, 1)[None], dim=1)
            for s in range(0, GEN, 4096)])
        s1 = db._stage1_scores(x[:4096], cent)
        s32 = 2.0 * x[:4096] @ cent.T - torch.sum(cent * cent, 1)[None]
    assert s1.dtype == torch.float32
    assert float((s1 - s32).abs().max()) > 0          # bf16 operands
    agree = float((a == exact).float().mean())
    assert agree >= 0.999, agree


@pytest.mark.gpu
def test_device_build_layout_equals_populate_on_card(cuda_device):
    """A device build with preset quantizers against ``factory.populate``
    (exact fp32 assignment) on the card: every row whose cell agrees has
    the same code, the lists agree except for the rows whose bf16
    shortlist flipped (counted, ≤ 0.1%)."""
    from chamjax_torch.data import synthetic_dataset
    from chamjax_torch.index import build_ivfpq_device
    from chamjax_torch.index import factory
    ds = synthetic_dataset(nb=200_000, nq=8, nt=50_000, d=64, seed=9,
                           n_clusters=1024)
    cfg = IndexConfig(dim=64, nlist=1024, m=16, list_pad=64)
    tq = factory.train_quantizers(ds.xt, cfg, kmeans_iters=4, pq_iters=4,
                                  device=cuda_device)
    packed = factory.populate(ds.xb, tq, device=cuda_device)
    dev, info = build_ivfpq_device(
        lambda s, c: torch.from_numpy(ds.xb[s:s + c]).to(cuda_device),
        ds.nb, cfg, None, quantizers=(tq.centroids, tq.codebooks, None),
        chunk=1 << 16, device=cuda_device)

    def rows(ids, codes, list_start, list_len):
        cell = np.full(ds.nb, -1, np.int64)
        code = np.zeros((ds.nb, cfg.m), np.uint8)
        for li in range(cfg.nlist):
            s, n = int(list_start[li]), int(list_len[li])
            cell[ids[s:s + n]] = li
            code[ids[s:s + n]] = codes[s:s + n]
        return cell, code

    c_p, k_p = rows(packed.ids, packed.codes, packed.list_start,
                    packed.list_len)
    c_d, k_d = rows(dev.ids.cpu().numpy(), dev.codes_t.cpu().numpy().T,
                    info["list_start"], info["list_len"])
    assert (c_p >= 0).all() and (c_d >= 0).all()
    flipped = c_p != c_d
    assert flipped.sum() <= 0.001 * ds.nb, int(flipped.sum())
    np.testing.assert_array_equal(k_d[~flipped], k_p[~flipped])
    moved = np.bincount(c_p[flipped], minlength=cfg.nlist) + np.bincount(
        c_d[flipped], minlength=cfg.nlist)
    same = moved == 0
    np.testing.assert_array_equal(info["list_len"][same],
                                  packed.list_len[same])


# ---------------------------------------------------------------------------
# the mesh tier: positions on one card, and on distinct cards
# ---------------------------------------------------------------------------

MESH_ROUTES = {
    "tiled": (dict(tile_seg=256), dict(backend="seg"), "adc_scan_tiles"),
    "flat": (dict(), dict(backend="seg"), "adc_scan_segments_multi"),
    "pallas": (dict(), dict(backend="pallas", scan_len=1024),
               "adc_scan_distances"),
}


def _mesh_search(idx, q, devices, axes, shard_kw, kw):
    from chamjax_torch.parallel import (make_mesh, place_sharded,
                                        shard_index, sharded_search,
                                        sharded_search_2d)
    mesh = make_mesh(axes, devices=devices)
    sh = place_sharded(shard_index(idx, mesh.shape["lists"], **shard_kw),
                       mesh)
    search = sharded_search_2d if "data" in mesh.shape else sharded_search
    return sh, search(sh, q.to(mesh.device_at()), mesh=mesh, **kw)


def _held(got, want, rtol=1e-5):
    d, i = (x.cpu().numpy() for x in got)
    dw, iw = (x.cpu().numpy() for x in want)
    np.testing.assert_allclose(d, dw, rtol=rtol, atol=rtol)
    bad = tie_mismatches(d, i.astype(np.int64), dw, iw.astype(np.int64),
                         rtol=rtol, atol=rtol)
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("axes", [(("lists", 4),),
                                  (("data", 2), ("lists", 2))])
@pytest.mark.parametrize("route", sorted(MESH_ROUTES))
def test_sharded_search_on_one_card(card_index, route, axes):
    """Every position on cuda:0: the route's kernel launches (counted by
    the replay), the search is one captured graph equal to its eager run,
    and both equal the same sharded search on CPU positions (f32 LUTs,
    rtol 1e-5, ids up to ties)."""
    from chamjax_torch.utils import graphs
    ds, idx = card_index
    shard_kw, kw, kernel = MESH_ROUTES[route]
    kw = dict(kw, nprobe=8, k=10, windows=48, seg=256, group=4,
              lut_bf16=False)
    q = torch.from_numpy(ds.xq[:16])
    n_pos = int(np.prod([s for _, s in axes]))
    before = cuda_lib.launch_counts[kernel]
    sh, got = _mesh_search(idx, q, ["cuda:0"] * n_pos, axes, shard_kw, kw)
    assert cuda_lib.launch_counts[kernel] > before
    assert len(sh.graphs) == 1
    with graphs.disable_capture():
        eager = _mesh_search(idx, q, ["cuda:0"] * n_pos, axes, shard_kw,
                             kw)[1]
    _held(got, eager)
    _, cpu = _mesh_search(idx, q, ["cpu"] * n_pos, axes, shard_kw, kw)
    _held(got, cpu)


TP_FAMILIES = {"decoder": "Dec", "llama": "Llama", "encoder-decoder": "Enc"}


def _tp_run(family, cfg, params, devices, steps=4, b=4):
    """``steps`` decode steps at batch ``b`` (cross attention over an
    encoded context for the encoder-decoder), tensor-parallel over
    ``devices`` (dp 2 × tp 2) or, ``devices=None``, unsharded."""
    from chamjax_torch.models import encoder_forward
    from chamjax_torch.models.transformer import build_cross_kv
    from chamjax_torch.parallel import (make_mesh, shard_decoder_params,
                                        shard_kv_cache, shard_llama_params)
    from chamjax_torch.serving.ralm import step_fns
    step, new_cache = step_fns(cfg)
    *enc, dec = params if family == "encoder-decoder" else (params,)
    dev = dec.embed.device
    cache = new_cache(cfg, b, device=dev)
    if devices is not None:
        mesh = make_mesh((("dp", 2), ("tp", 2)), devices=devices)
        dec = (shard_llama_params(dec, mesh, kv_heads=cfg.kv_heads)
               if family == "llama" else shard_decoder_params(dec, mesh))
        enc = [shard_decoder_params(e, mesh) for e in enc]
        cache = shard_kv_cache(cache, mesh)
    rng = np.random.default_rng(9)
    cross = {}
    if enc:
        src = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 6)).astype(
            np.int32)).to(dev)
        cross = dict(cross_kv=build_cross_kv(
            dec, encoder_forward(enc[0], src, cfg.attention_heads),
            cfg.attention_heads))
    outs = []
    for t in rng.integers(0, cfg.vocab_size, (steps, b)):
        lg, hid, cache = step(dec, torch.from_numpy(t.astype(np.int32)).to(
            dev), cache, **cross)
        outs += [lg, hid]
    return outs, cache


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(TP_FAMILIES))
def test_tp_step_on_one_card(cuda_device, family):
    """Tensor-parallel steps with every position on cuda:0 (f32): equal to
    the unsharded steps on the card (atol 1e-4), captured in one graph a
    step key on the sharded cache and equal to the eager run."""
    from chamjax_torch.benchmarks.ralm_device_bench import init_params
    from chamjax_torch.utils import graphs
    cfg = ralm_config(family)
    params = init_params(cfg, 0, cuda_device)
    ref, _ = _tp_run(family, cfg, params, None)
    got, cache = _tp_run(family, cfg, params, ["cuda:0"] * 4)
    assert len(cache.graphs) == 1
    assert_close(got, ref, rtol=1e-4)
    with graphs.disable_capture():
        eager, _ = _tp_run(family, cfg, params, ["cuda:0"] * 4)
    assert_close(got, eager)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards (positions on distinct cards)")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.gpu
def test_sharded_search_on_distinct_cards(card_index, two_cards):
    """lists 2 over cuda:0 and cuda:1 (peer copies, eager: one graph cannot
    span devices) against the same mesh on one card."""
    from chamjax_torch.parallel.sharded_search import captures
    from chamjax_torch.parallel import make_mesh
    ds, idx = card_index
    shard_kw, kw, _ = MESH_ROUTES["tiled"]
    kw = dict(kw, nprobe=8, k=10, windows=48, seg=256, group=4,
              lut_bf16=False)
    q = torch.from_numpy(ds.xq[:16])
    axes = (("lists", 2),)
    assert not captures(make_mesh(axes, devices=two_cards))
    sh, got = _mesh_search(idx, q, two_cards, axes, shard_kw, kw)
    assert len(sh.graphs) == 0
    assert {t.device for t in sh.codes_tiled} == set(two_cards)
    _held(got, _mesh_search(idx, q, ["cuda:0"] * 2, axes, shard_kw, kw)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(TP_FAMILIES))
def test_tp_step_on_distinct_cards(two_cards, family):
    """dp 2 × tp 2 with tp over two cards (the dp rows share them), eager,
    against the unsharded steps (f32, atol 1e-4)."""
    from chamjax_torch.benchmarks.ralm_device_bench import init_params
    cfg = ralm_config(family)
    params = init_params(cfg, 0, two_cards[0])
    ref, _ = _tp_run(family, cfg, params, None)
    got, cache = _tp_run(family, cfg, params, two_cards * 2)
    assert len(cache.graphs) == 0
    assert_close(got, ref, rtol=1e-4)


# --- the retrieval-quality path: ir and rag on the card ----------------------


@pytest.fixture(scope="module")
def ir_corpus():
    """A synth BEIR corpus of 5000 docs (enough for the mining's IVF-PQ
    branch), its train pairs and the corpus tokenized once."""
    from chamjax_torch.ir.models import _batch_ids, _doc_text
    from chamjax_torch.ir.synth import generate_beir_corpus
    corpus, queries, qrels, tq, tqr = generate_beir_corpus(
        n_docs=5000, n_queries=40, n_train_queries=60, n_topics=60, seed=2)
    dids = list(corpus)
    tokens = _batch_ids([_doc_text(corpus[d]) for d in dids], 4096, 24)
    return corpus, queries, qrels, tq, tqr, dids, tokens


def _dual(device, seed=0):
    from chamjax_torch.ir import DualEncoder
    return DualEncoder(vocab=4096, dim=64, emb_dim=32, max_len=24, seed=seed,
                       device=device)


@pytest.mark.gpu
def test_ir_ivfpq_search_on_card_matches_xla(cuda_device, ir_corpus):
    """``DenseRetrievalIVFPQSearch`` on the card launches the tiled kernel;
    its index searched with f32 LUTs equals the xla oracle up to ties."""
    from chamjax_torch.ir import DenseRetrievalIVFPQSearch
    from chamjax_torch.ir.dense import HashingEncoder
    corpus, queries = ir_corpus[:2]
    s = DenseRetrievalIVFPQSearch(HashingEncoder(dim=64), nprobe=16,
                                  device=cuda_device)
    before = cuda_lib.launch_counts["adc_scan_tiles"]
    res = s.search(corpus, queries, 10)
    assert cuda_lib.launch_counts["adc_scan_tiles"] > before
    assert all(len(r) == 10 for r in res.values())
    q = s.query_matrix(queries)
    d_f, i_f = IVFSearcher(s.index, SearchConfig(nprobe=16, k=10,
                                                 lut_bf16=False),
                           device=cuda_device).search(q)
    d_x, i_x = IVFSearcher(s.index, SearchConfig(nprobe=16, k=10,
                                                 backend="xla"),
                           device=cuda_device).search(q)
    assert not tie_mismatches(d_f, i_f, d_x, i_x, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_dual_encoder_fit_on_card_matches_cpu(cuda_device, ir_corpus):
    """Parameters copied off a CPU model: 10 steps on the card, in-batch
    and with mined negatives, give losses within 1e-3 (relative) of the
    CPU's."""
    from chamjax_torch.ir import training_pairs
    corpus, _q, _qr, tq, tqr, _dids, tokens = ir_corpus
    pairs = training_pairs(tq, tqr, corpus, min_score=2)
    neg = np.random.default_rng(0).integers(0, len(corpus), (len(pairs), 3))
    for kw in ({}, dict(neg_tokens=tokens, neg_idx=neg)):
        cpu = _dual("cpu")
        card = _dual(cuda_device)
        card.load_state_dict(cpu.state_dict())
        args = dict(steps=10, batch=32, lr=3e-3, seed=4, **kw)
        np.testing.assert_allclose(card.fit(pairs, **args),
                                   cpu.fit(pairs, **args), rtol=1e-3)


@pytest.mark.gpu
def test_binary_hamming_on_card_matches_numpy(cuda_device):
    from chamjax_torch.ir.ann import _words, hamming
    rng = np.random.default_rng(1)
    qb = rng.integers(0, 256, size=(7, 24), dtype=np.uint8)
    cb = rng.integers(0, 256, size=(300, 24), dtype=np.uint8)
    got = hamming(torch.from_numpy(_words(qb)).to(cuda_device),
                  torch.from_numpy(_words(cb)).to(cuda_device))
    want = np.unpackbits(qb[:, None] ^ cb[None], axis=-1).sum(-1)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
def test_mining_takes_the_ivfpq_branch_on_card(cuda_device, ir_corpus):
    """On the card the mining builds an IVF-PQ index and searches it with
    the tiled kernel; it never falls back to the exact branch, and a
    corpus too small for the index raises."""
    corpus, _q, _qr, tq, tqr, dids, tokens = ir_corpus
    enc = _dual(cuda_device)
    qs = sorted(tq)[:32]
    idx = {d: i for i, d in enumerate(dids)}
    positives = [{idx[d] for d in tqr[q]} for q in qs]
    before = cuda_lib.launch_counts["adc_scan_tiles"]
    neg = enc.mine_hard_negatives([tq[q] for q in qs], tokens,
                                  positives=positives, n_neg=4, depth=16)
    assert cuda_lib.launch_counts["adc_scan_tiles"] > before
    assert enc.mining[-1]["branch"] == "ivfpq"
    assert neg.shape == (32, 4)
    for row, pos in zip(neg, positives):
        assert not set(row.tolist()) & pos
    small = (tokens[0][:1000], tokens[1][:1000])
    with pytest.raises(ValueError, match="too few"):
        enc.mine_hard_negatives(["x"], small, positives=[set()])
    enc.mine_hard_negatives(["x"], small, positives=[set()],
                            use_ivfpq=False)
    assert enc.mining[-1]["branch"] == "exact"


@pytest.mark.gpu
def test_decoder_reader_captured_matches_eager(cuda_device):
    """The reader's decode replays one captured step graph (owned by its
    cache) and gives the eager tokens, bit for bit."""
    from chamjax_torch.config import ModelConfig
    from chamjax_torch.rag import DecoderReader
    from chamjax_torch.utils import graphs
    cfg = ModelConfig(model_type="decoder", embed_dim=128, ffn_embed_dim=256,
                      layers=2, attention_heads=4, vocab_size=1000,
                      max_seq_len=64)
    r = DecoderReader(cfg=cfg, max_new_tokens=16, device=cuda_device)
    prompts = ["what is a rocket?", "bake a pie", "", "bonds and yields"]
    got = [r.generate_ids(p) for p in prompts]
    assert len(r.cache.graphs) == 1
    with graphs.disable_capture():
        want = [r.generate_ids(p) for p in prompts]
    assert got == want


# --- the last unported modules: stage profile, diagnosis, card power --------


@pytest.mark.gpu
def test_stage_profile_on_card(cuda_device):
    """``profile_stages`` on the card over a random index: every time
    finite and > 0, and the scans it timed equal the plain version on the
    CPU (f32 LUTs rtol 1e-5, packed LUTs one bf16 ulp)."""
    import math
    from chamjax_torch.benchmarks import profiling_stages as ps
    index = ps.synthetic_index(262_144, 64, 1024, 16, 512, True,
                               device=cuda_device, seed=1)
    xq = np.random.default_rng(2).standard_normal((64, 64)).astype(
        np.float32)
    times, t = ps.profile_stages(index, xq, batch=64, nprobe=16, k=50,
                                 seg=512, group=8, lut_bf16=True,
                                 coarse_cand=64, lane_l1=True, select_l1=200)
    assert tuple(times) == ps.KEYS
    assert all(math.isfinite(v) and v > 0 for v in times.values()), times
    cpu = [x.cpu() for x in (index.codes_t, t["starts"], t["lens"],
                             t["lut_idx"])]
    want = adc_scan_segments_multi_reference(
        *cpu, t["luts_k"].cpu(), seg=512).reshape(64, -1)
    got = t["dists"].cpu()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    want_bf16 = adc_scan_segments_multi_reference(
        *cpu, pack_luts_bf16(t["luts_k"].cpu()), seg=512,
        lut_bf16=True).reshape(64, -1)
    assert_bf16_scan(t["dists_bf16"], want_bf16)


@pytest.mark.gpu
def test_recall_diagnosis_on_card_equals_cpu(cuda_device):
    """The diagnosis on the card's copy of an index equals the CPU's on the
    same index, queries and results."""
    from chamjax_torch.data import compute_ground_truth
    from chamjax_torch.eval import recall_diagnosis
    from chamjax_torch.searcher import DeviceIVF
    ds = synthetic_dataset(nb=20_000, nq=32, nt=6000, d=32, seed=9,
                           n_clusters=4)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=32, nlist=64, m=8, list_pad=64,
                                         opq=True),
                      xt=ds.xt, kmeans_iters=6, pq_iters=6, device="cpu")
    gt, _ = compute_ground_truth(ds.xb, ds.xq, k=10, device="cpu")
    s = IVFSearcher(idx, SearchConfig(nprobe=8, k=10, seg=256, seg_group=2,
                                      lut_bf16=False), device=cuda_device)
    d, i = s.search(ds.xq)
    for windows in (s.windows, max(3, s.windows // 4) | 1):
        kw = dict(nprobe=8, windows=windows, seg=256, group=2)
        got = recall_diagnosis(s.dev, ds.xq, gt, i, d, **kw)
        want = recall_diagnosis(DeviceIVF.from_packed(idx, device="cpu",
                                                      tile_seg=256),
                                ds.xq, gt, i, d, **kw)
        assert got == want
        assert abs(sum(got.values()) - 1.0) < 1e-9


@pytest.mark.gpu
def test_card_efficiency_reads_a_positive_power_limit(cuda_device):
    from chamjax_torch.utils.energy import card_efficiency
    eff = card_efficiency(100_000.0)
    assert eff["card"] and eff["assumed_watts"] > 0
    assert eff["qps_per_watt"] == round(100_000.0 / eff["assumed_watts"], 3)


# the threefry kernel (csrc/threefry.cu) against its plain version

THREEFRY_BOUNDS = {"uniform_f32": (-3.0, 5.5), "uniform_bf16": (-3.0, 5.5),
                   "normal_f32": (0.0, 1.0), "normal_bf16": (0.0, 1.0)}


def _bitwise(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as a signed integer tensor of the same width."""
    return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[t.element_size()])


@pytest.mark.gpu
@pytest.mark.parametrize("start", [0, (1 << 32) - 1000, 5 << 33])
@pytest.mark.parametrize("form", jr.FORMS)
def test_threefry_kernel_matches_plain_on_card(cuda_device, form, start):
    """Every form, bit-equal to the plain version, over counters that start
    at 0, cross 2**32 (the hi word) and start above it; a scaled normal
    too."""
    lo, hi = THREEFRY_BOUNDS.get(form, (0.0, 1.0))
    kw = jr.draw_params(form, lo, hi, scale=0.02 if "normal" in form
                        else 1.0)
    n = (1 << 20) + 3
    key = jr.fold_in(7, 11)
    cuda_lib.launch_counts.clear()
    got = jr.threefry_draw(key, n, form, start=start, device=cuda_device,
                           **kw)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["threefry"] == 1
    want = jr.threefry_draw_reference(key, n, form, start=start,
                                      device=cuda_device, **kw)
    assert got.dtype == want.dtype and got.shape == (n,)
    assert torch.equal(_bitwise(got), _bitwise(want))
    cpu = jr.threefry_draw_reference(key, 4099, form, start=start,
                                     device="cpu", **kw)
    assert torch.equal(_bitwise(got[:4099].cpu()), _bitwise(cpu))


@pytest.mark.gpu
def test_threefry_samplers_on_card_equal_cpu(cuda_device):
    """The samplers draw on the card what they draw on the CPU."""
    cases = [
        lambda d: jr.bits(3, (1000, 3), 8, device=d),
        lambda d: jr.uniform(3, (5000,), torch.bfloat16, -1.0, 2.0,
                             device=d),
        lambda d: jr.normal(3, (300, 70), device=d),
        lambda d: jr.normal(3, (300, 70), torch.bfloat16, scale=0.0625,
                            device=d),
        lambda d: jr.gumbel(3, (70000,), device=d),
        lambda d: jr.randint(3, (70000,), 0, 4096, device=d),
        lambda d: jr.randint(3, (7000,), 0, 256, torch.uint8, device=d),
        lambda d: jr.permutation(3, 100_003, device=d),
        lambda d: jr.choice(3, 1 << 20, 512, device=d),
    ]
    for i, case in enumerate(cases):
        got, want = case(cuda_device), case("cpu")
        assert got.device.type == "cuda"
        assert torch.equal(_bitwise(got.cpu()), _bitwise(want)), i


@pytest.mark.gpu
def test_threefry_empty_draw_launches_nothing(cuda_device):
    cuda_lib.launch_counts.clear()
    out = jr.normal(0, (0, 5), device=cuda_device)
    assert out.shape == (0, 5) and cuda_lib.launch_counts["threefry"] == 0
