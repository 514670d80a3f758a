"""The tiled ADC scan: the port's plain version against the Pallas kernel
(interpret mode) on the same numpy inputs, and the wrapper's CPU contract.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chamjax.ops.scan_seg import pack_luts_bf16 as j_pack
from chamjax.ops.scan_seg_block import adc_scan_tiles as j_adc

from chamjax_torch.ops.scan_seg import pack_luts_bf16
from chamjax_torch.ops.scan_seg_block import (adc_scan_tiles,
                                              adc_scan_tiles_reference)
from chamjax_torch.utils import cuda_lib

OPTION_SETS = {
    "f32_lut": dict(lut_bf16=False),
    "bf16_lut": dict(lut_bf16=True),
    "dist_bf16": dict(lut_bf16=False, dist_bf16=True),
    "lane_l1": dict(lut_bf16=True, lane_l1=True),
}


def make_inputs(seed, *, n_tiles, m, seg, bw, n_lut):
    """Random tiles and LUTs with repeated tiles, empty, partial and full
    windows."""
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


def bf16_within_one_ulp(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    fin = np.isfinite(w)
    assert np.array_equal(fin, np.isfinite(g))
    mag = np.maximum(np.abs(g[fin]), np.abs(w[fin]))
    assert np.all(np.abs(g[fin] - w[fin]) <= mag * 2.0 ** -7)


def check_lane_l1(got, want, full):
    """mins within 1e-5; winning group equal wherever the minimum is
    unique.  ``full`` (bW, seg) holds the unreduced distances."""
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5, atol=1e-5)
    gt_ = got[:, 1].copy().view(np.int32)
    wt = want[:, 1].copy().view(np.int32)
    groups = full.reshape(full.shape[0], -1, 128)
    srt = np.sort(groups, axis=1)
    unique = np.isfinite(srt[:, 0])
    if groups.shape[1] > 1:
        with np.errstate(invalid="ignore"):           # inf - inf
            gap = srt[:, 1] - srt[:, 0]
        unique &= ~(gap <= 1e-4 * np.abs(srt[:, 0]) + 1e-4)
    np.testing.assert_array_equal(gt_[unique], wt[unique])


@pytest.mark.parametrize("seg", [128, 256])
@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_reference_matches_pallas_interpret(name, seg):
    opt = OPTION_SETS[name]
    codes, tile_idx, lens, lut_idx, luts = make_inputs(
        seg, n_tiles=24, m=8, seg=seg, bw=32, n_lut=12)
    j_luts = j_pack(jnp.asarray(luts)) if opt["lut_bf16"] else luts
    t_luts = (pack_luts_bf16(torch.from_numpy(luts)) if opt["lut_bf16"]
              else torch.from_numpy(luts))
    want = np.asarray(j_adc(
        *map(jnp.asarray, (codes, tile_idx, lens, lut_idx, j_luts)),
        seg=seg, group=8, interpret=True, **opt).astype(jnp.float32))
    got = adc_scan_tiles_reference(
        *map(torch.from_numpy, (codes, tile_idx, lens, lut_idx)), t_luts,
        seg=seg, **opt)
    if opt.get("dist_bf16"):
        assert got.dtype == torch.bfloat16
        bf16_within_one_ulp(got.float().numpy(), want)
        return
    got = got.numpy()
    assert got.shape == want.shape
    if opt.get("lane_l1"):
        full = adc_scan_tiles_reference(
            *map(torch.from_numpy, (codes, tile_idx, lens, lut_idx)),
            t_luts, seg=seg, lut_bf16=True).numpy()
        check_lane_l1(got, want, full)
        return
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # empty windows are all +inf; partial windows +inf past their length
    assert np.all(np.isinf(got[lens == 0]))
    pos = np.arange(seg)[None, :]
    assert np.all(np.isinf(got)[pos >= lens[:, None]])
    assert np.all(np.isfinite(got)[pos < lens[:, None]])


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    codes, tile_idx, lens, lut_idx, luts = make_inputs(
        1, n_tiles=6, m=4, seg=128, bw=16, n_lut=5)
    args = [torch.from_numpy(a) for a in (codes, tile_idx, lens, lut_idx,
                                          luts)]
    cuda_lib.launch_counts.clear()
    for opt in OPTION_SETS.values():
        a = list(args)
        if opt["lut_bf16"]:
            a[4] = pack_luts_bf16(a[4])
        got = adc_scan_tiles(*a, seg=128, group=8, **opt)
        want = adc_scan_tiles_reference(*a, seg=128, **opt)
        assert torch.equal(got.view(torch.int16) if opt.get("dist_bf16")
                           else got.view(torch.int32),
                           want.view(torch.int16) if opt.get("dist_bf16")
                           else want.view(torch.int32))
    assert cuda_lib.launch_counts["adc_scan_tiles"] == 0


def test_wrapper_rejects_bad_inputs():
    codes, tile_idx, lens, lut_idx, luts = (torch.from_numpy(a) for a in
                                            make_inputs(2, n_tiles=4, m=4,
                                                        seg=128, bw=8,
                                                        n_lut=3))
    ok = (codes, tile_idx, lens, lut_idx, luts)
    with pytest.raises(ValueError, match="exclude"):
        adc_scan_tiles(*ok, seg=128, lane_l1=True, dist_bf16=True)
    with pytest.raises(ValueError, match="tile width"):
        adc_scan_tiles(*ok, seg=256)
    with pytest.raises(ValueError, match="lut_bf16"):
        adc_scan_tiles(*ok, seg=128, lut_bf16=True)   # f32 LUT given
    with pytest.raises(ValueError, match="multiple of group"):
        adc_scan_tiles(*ok, seg=128, group=3)
    with pytest.raises(ValueError, match="tile_idx is torch.int64"):
        adc_scan_tiles(codes, tile_idx.long(), lens, lut_idx, luts, seg=128)
    # the debug_ablate bodies write (bW, seg) rows: no lane_l1 output, and
    # no body by another name
    for body in ("copy", "nogather"):
        with pytest.raises(ValueError, match="lane_l1"):
            adc_scan_tiles(*ok, seg=128, lane_l1=True, debug_ablate=body)
    with pytest.raises(ValueError, match="debug_ablate"):
        adc_scan_tiles(*ok, seg=128, debug_ablate="dma_only")


def test_cuda_loader_layout():
    """Every kernel source is where the loader looks, and builds for
    sm_90a into the package's build directory."""
    assert cuda_lib.SOURCES == ("adc_scan_tiles", "adc_scan_flat",
                                "adc_scan_variants", "threefry")
    for name in cuda_lib.SOURCES:
        src = (cuda_lib.CSRC_DIR / f"{name}.cu").read_text()
        assert cuda_lib.library_path(name).parent == cuda_lib.BUILD_DIR
        # every bound entry point is defined with a plain C interface
        for fn in cuda_lib.SIGNATURES[name]:
            assert f'extern "C" int {fn}(' in src, fn
        assert 'extern "C" const char* chamjax_cuda_error_string' in src
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edit to the shared staged body (adc_scan_stage.cuh) names a new
    library for every source that includes it (the two scans and the
    kernel study's variants, instantiations of the same body); an edit to
    a source names a new library for that source alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", csrc)
    before = {n: cuda_lib.library_path(n) for n in cuda_lib.SOURCES}
    header = csrc / "adc_scan_stage.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: cuda_lib.library_path(n) for n in cuda_lib.SOURCES}
    for name in ("adc_scan_tiles", "adc_scan_flat", "adc_scan_variants"):
        assert after[name] != before[name], name
        assert after[name].parent == cuda_lib.BUILD_DIR
    assert after["threefry"] == before["threefry"]    # includes no header
    src = csrc / "adc_scan_flat.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    again = {n: cuda_lib.library_path(n) for n in cuda_lib.SOURCES}
    assert again["adc_scan_flat"] != after["adc_scan_flat"]
    assert again["adc_scan_tiles"] == after["adc_scan_tiles"]
    assert again["adc_scan_variants"] == after["adc_scan_variants"]
