"""chamjax_torch on an NVIDIA card: the CUDA kernel against its plain
version at the flagship widths, and the query path on the card against the
same path on the CPU.  Every test is marked ``gpu`` and skips where there
is no card.  This file imports neither jax nor chamjax, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from chamjax_torch.config import IndexConfig, SearchConfig
from chamjax_torch.data import synthetic_dataset
from chamjax_torch.index import build_ivfpq
from chamjax_torch.ops.scan_seg import pack_luts_bf16
from chamjax_torch.ops.scan_seg_block import (adc_scan_tiles,
                                              adc_scan_tiles_reference)
from chamjax_torch.searcher import IVFSearcher
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
    rtol, tie = (2.0 ** -8, 2.0 ** -8 * np.abs(d_c)) if lut_bf16 else (
        1e-5, 1e-4)
    np.testing.assert_allclose(d_g, d_c, rtol=rtol, atol=1e-5)
    assert np.all((i_g == i_c) | (np.abs(d_g - d_c) <= tie))
