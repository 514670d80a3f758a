"""chamjax_torch on an NVIDIA card: the CUDA kernels (the scans, their
``debug_ablate`` bodies and the measurement variants) against their plain
versions, the query routes (tiled, flat, padded-window, host-streamed) on
the card against the same routes on the CPU, and profiler tracing of the
card.  Every test is marked ``gpu`` and skips where there
is no card.  This file imports neither jax nor chamjax, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

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


def variant_args(variant, seg, dev, *, m=16, n=1 << 18, bw=512, n_lut=64):
    """Codes in the layout the variant takes, window starts (multiples of
    512; tile starts for the tiled layouts), full lens, LUT rows and LUTs
    (packed for the names holding bf16)."""
    rng = np.random.default_rng(seg)
    codes = rng.integers(0, 256, (m, n)).astype(np.uint8)
    starts = (rng.integers(0, (n - seg) // 512, bw) * 512).astype(np.int32)
    if variant == "i32codes":
        codes = codes.astype(np.int32)
    elif variant.startswith("i32view"):
        codes = codes.view(np.int32).reshape(m, n // 4)
    elif variant.startswith(("contig", "block")):
        codes = np.ascontiguousarray(
            codes.reshape(m, n // seg, seg).transpose(1, 0, 2))
        starts = (rng.integers(0, n // seg, bw) * seg).astype(np.int32)
    lens = np.full(bw, seg, np.int32)
    lut_idx = rng.integers(0, n_lut, bw).astype(np.int32)
    luts = torch.from_numpy(
        (rng.random((n_lut, m, 256)) * 4.0).astype(np.float32)).to(dev)
    if kv.packed(variant):
        luts = pack_luts_bf16(luts)
    return [torch.from_numpy(a).to(dev)
            for a in (codes, starts, lens, lut_idx)] + [luts]


@pytest.mark.gpu
@pytest.mark.parametrize("seg", [512, 2048])
@pytest.mark.parametrize("variant", [*kv.VARIANTS, kv.BLOCK_VARIANT])
def test_variant_matches_plain_on_card(cuda_device, variant, seg):
    args = variant_args(variant, seg, cuda_device)
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
        wide = variant_args("bf16_mxu", 2048, cuda_device, m=64, n=1 << 16,
                            bw=8)
        kv.run_variant(*wide, seg=2048, group=8, variant="bf16_mxu")


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
