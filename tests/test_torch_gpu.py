"""chamjax_torch on an NVIDIA card: the CUDA kernels against their plain
versions, and the query routes (tiled, flat, padded-window, host-streamed)
on the card against the same routes on the CPU.  Every test is marked ``gpu`` and skips where there
is no card.  This file imports neither jax nor chamjax, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

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
from chamjax_torch.utils import cuda_lib

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
        with np.errstate(invalid="ignore"):
            unique = np.isfinite(srt[:, 0]) & ~(
                srt[:, 1] - srt[:, 0] <= 1e-4 * np.abs(srt[:, 0]) + 1e-4)
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
