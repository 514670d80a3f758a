"""The flat-layout ADC scans (``adc_scan_segments_multi``,
``adc_scan_segments``, ``adc_scan_distances``): the port's plain versions
against the Pallas kernels (interpret mode) on the same numpy inputs, and
the wrappers' CPU contract.  The CUDA kernel itself is held against the
plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chamjax.ops.scan_pallas import adc_scan_distances as j_dist
from chamjax.ops.scan_seg import adc_scan_segments as j_seg
from chamjax.ops.scan_seg import pack_luts_bf16 as j_pack
from chamjax.ops.scan_seg_multi import adc_scan_segments_multi as j_multi

from chamjax_torch.ops.scan_pallas import (GROUP, adc_scan_distances,
                                           adc_scan_distances_reference,
                                           resolve_chunk)
from chamjax_torch.ops.scan_seg import (adc_scan_segments,
                                        adc_scan_segments_reference,
                                        pack_luts_bf16)
from chamjax_torch.ops.scan_seg_multi import (
    adc_scan_segments_multi, adc_scan_segments_multi_reference)
from chamjax_torch.utils import cuda_lib

from test_torch_scan_kernel import check_lane_l1

M = 8
OPTIONS = {"f32_lut": dict(lut_bf16=False),
           "bf16_lut": dict(lut_bf16=True),
           "lane_l1": dict(lut_bf16=True, lane_l1=True)}


def make_flat_inputs(seed, *, n_cols, width, bw, n_lut, m=M):
    """Random flat codes and LUTs; window starts are multiples of 64 (not
    only 128), one window ends exactly at the tail of ``codes_t``; full,
    partial and empty windows (empty ones start at 0, as padding windows
    do)."""
    rng = np.random.default_rng(seed)
    assert (n_cols - width) % 64 == 0
    codes_t = rng.integers(0, 256, (m, n_cols)).astype(np.uint8)
    starts = (rng.integers(0, (n_cols - width) // 64 + 1, bw) * 64).astype(
        np.int32)
    starts[1::4] |= 64                    # odd multiples of 64
    starts = np.minimum(starts, n_cols - width).astype(np.int32)
    lens = rng.integers(1, width, bw).astype(np.int32)      # partial
    lens[::3] = width                                        # full
    lens[2::7] = 0                                           # empty
    starts[lens == 0] = 0
    starts[3], lens[3] = n_cols - width, width               # tail, full
    lut_idx = rng.integers(0, n_lut, bw).astype(np.int32)
    luts = (rng.random((n_lut, m, 256)) * 4.0).astype(np.float32)
    return codes_t, starts, lens, lut_idx, luts


def both_luts(luts, lut_bf16):
    if not lut_bf16:
        return luts, torch.from_numpy(luts)
    return j_pack(jnp.asarray(luts)), pack_luts_bf16(torch.from_numpy(luts))


def check_dists(got, want, lens):
    """f32 and packed: allclose(1e-5) with the same finite mask; +inf past
    every window's length."""
    assert got.shape == want.shape
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pos = np.arange(got.shape[1])[None, :]
    assert np.all(np.isinf(got)[pos >= lens[:, None]])
    assert np.all(np.isfinite(got)[pos < lens[:, None]])


@pytest.mark.parametrize("seg", [128, 256])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_segments_multi_matches_pallas_interpret(name, group, seg):
    opt = OPTIONS[name]
    codes_t, starts, lens, lut_idx, luts = make_flat_inputs(
        seg + group, n_cols=2048 + seg, width=seg, bw=16, n_lut=12)
    j_luts, t_luts = both_luts(luts, opt["lut_bf16"])
    want = np.asarray(j_multi(
        *map(jnp.asarray, (codes_t, starts, lens, lut_idx)), j_luts,
        seg=seg, group=group, interpret=True, **opt))
    t_args = [torch.from_numpy(a) for a in (codes_t, starts, lens, lut_idx)]
    got = adc_scan_segments_multi_reference(*t_args, t_luts, seg=seg,
                                            **opt).numpy()
    if opt.get("lane_l1"):
        full = adc_scan_segments_multi_reference(
            *t_args, t_luts, seg=seg, lut_bf16=True).numpy()
        assert got.shape == want.shape == (16, 2, 128)
        check_lane_l1(got, want, full)
    else:
        check_dists(got, want, lens)


@pytest.mark.parametrize("seg", [128, 256])
@pytest.mark.parametrize("lut_bf16", [False, True])
def test_segments_matches_pallas_interpret(lut_bf16, seg):
    codes_t, starts, lens, lut_idx, luts = make_flat_inputs(
        seg + 1, n_cols=1536 + seg, width=seg, bw=12, n_lut=9)
    j_luts, t_luts = both_luts(luts, lut_bf16)
    want = np.asarray(j_seg(
        *map(jnp.asarray, (codes_t, starts, lens, lut_idx)), j_luts,
        seg=seg, interpret=True, lut_bf16=lut_bf16))
    got = adc_scan_segments_reference(
        *(torch.from_numpy(a) for a in (codes_t, starts, lens, lut_idx)),
        t_luts, seg=seg, lut_bf16=lut_bf16).numpy()
    check_dists(got, want, lens)


@pytest.mark.parametrize("scan_len", [1024, 2048])
def test_distances_matches_pallas_interpret(scan_len):
    """Lens of 0, partial, exactly one chunk and ≥ scan_len; a short window
    whose start lies less than scan_len before the end of ``codes_t``
    (the TPU kernel skips the chunks past its length)."""
    bp, n_cols = 10, 4096 + 64
    rng = np.random.default_rng(scan_len)
    codes_t = rng.integers(0, 256, (M, n_cols)).astype(np.uint8)
    starts = (rng.integers(0, (n_cols - scan_len) // 64, bp) * 64).astype(
        np.int32)
    lens = np.array([0, 300, 1024, scan_len, scan_len + 700, 1023, 5000, 1,
                     700, 0], np.int32)
    starts[8] = n_cols - 1024                 # short window near the tail
    luts = (rng.random((bp, M, 256)) * 4.0).astype(np.float32)
    want = np.asarray(j_dist(*map(jnp.asarray, (codes_t, starts, lens,
                                                luts)),
                             scan_len=scan_len, chunk=1024, interpret=True))
    got = adc_scan_distances_reference(
        *(torch.from_numpy(a) for a in (codes_t, starts, lens, luts)),
        scan_len=scan_len).numpy()
    check_dists(got, want, np.minimum(lens, scan_len))


def test_flat_wrappers_on_cpu_are_the_plain_versions():
    codes_t, starts, lens, lut_idx, luts = (torch.from_numpy(a) for a in
                                            make_flat_inputs(
                                                3, n_cols=640, width=128,
                                                bw=8, n_lut=5))
    packed = pack_luts_bf16(luts)
    cuda_lib.launch_counts.clear()
    for lut_bf16, lu in ((False, luts), (True, packed)):
        args = (codes_t, starts, lens, lut_idx, lu)
        for lane_l1 in (False, True):
            got = adc_scan_segments_multi(*args, seg=128, group=4,
                                          lut_bf16=lut_bf16, lane_l1=lane_l1)
            want = adc_scan_segments_multi_reference(
                *args, seg=128, lut_bf16=lut_bf16, lane_l1=lane_l1)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(
            adc_scan_segments(*args, seg=128, lut_bf16=lut_bf16),
            adc_scan_segments_reference(*args, seg=128, lut_bf16=lut_bf16))
    d_luts = luts[torch.arange(8) % 5]
    assert torch.equal(
        adc_scan_distances(codes_t, starts, lens, d_luts, scan_len=1024),
        adc_scan_distances_reference(codes_t, starts, lens, d_luts,
                                     scan_len=1024))
    for name in ("adc_scan_segments_multi", "adc_scan_segments",
                 "adc_scan_distances"):
        assert cuda_lib.launch_counts[name] == 0


def test_flat_reference_reads_only_inside_codes_t():
    """A window running past the end of ``codes_t`` scores +inf there (the
    kernel reads nothing out of range); a negative start reads nothing."""
    codes_t, starts, lens, lut_idx, luts = (torch.from_numpy(a) for a in
                                            make_flat_inputs(
                                                4, n_cols=512, width=128,
                                                bw=4, n_lut=2))
    starts[0], lens[0] = 448, 128             # 64 rows inside, 64 past
    starts[1], lens[1] = -64, 128
    got = adc_scan_segments_reference(codes_t, starts, lens, lut_idx, luts,
                                      seg=128)
    assert torch.isfinite(got[0, :64]).all() and torch.isinf(got[0, 64:]).all()
    assert torch.isinf(got[1]).all()


def test_plain_version_chunks_windows(monkeypatch):
    """The plain version goes over windows in chunks; the chunking does
    not change the result."""
    import chamjax_torch.ops.scan_seg as ss
    args = [torch.from_numpy(a) for a in make_flat_inputs(
        5, n_cols=1152, width=128, bw=24, n_lut=6)]
    whole = ss.flat_scan_reference(*args, width=128)
    monkeypatch.setattr(ss, "_PLAIN_CHUNK_ELEMS", M * 128 * 5)  # 5 windows
    assert torch.equal(ss.flat_scan_reference(*args, width=128), whole)


def test_flat_wrappers_reject_bad_inputs():
    codes_t, starts, lens, lut_idx, luts = (torch.from_numpy(a) for a in
                                            make_flat_inputs(
                                                6, n_cols=640, width=128,
                                                bw=8, n_lut=3))
    ok = (codes_t, starts, lens, lut_idx, luts)
    with pytest.raises(ValueError, match="multiple of group"):
        adc_scan_segments_multi(*ok, seg=128, group=3)
    with pytest.raises(ValueError, match="seg=200"):
        adc_scan_segments(*ok, seg=200)
    with pytest.raises(ValueError, match="seg=8192"):
        adc_scan_segments_multi(*ok, seg=8192, group=1)
    with pytest.raises(ValueError, match="lut_bf16"):
        adc_scan_segments(*ok, seg=128, lut_bf16=True)   # f32 LUT given
    with pytest.raises(ValueError, match="starts is torch.int64"):
        adc_scan_segments(codes_t, starts.long(), lens, lut_idx, luts,
                          seg=128)
    with pytest.raises(ValueError, match="must be"):
        adc_scan_segments(codes_t, starts, lens[:4], lut_idx, luts, seg=128)
    with pytest.raises(ValueError, match=f"multiple of {GROUP}"):
        adc_scan_distances(codes_t, starts, lens, luts[:1].expand(8, -1, -1),
                           scan_len=1000)
    with pytest.raises(ValueError, match="one LUT per window"):
        adc_scan_distances(codes_t, starts, lens, luts, scan_len=1024)


@pytest.mark.parametrize("scan_len,chunk,want", [
    (1024, 0, 1024), (2048, 0, 2048), (3072, 0, 1024), (8192, 0, 4096),
    (4096, 2048, 2048), (4096, 1536, 4096), (6144, 4096, 2048)])
def test_resolve_chunk_is_the_jax_rule(scan_len, chunk, want):
    assert resolve_chunk(scan_len, chunk) == want
