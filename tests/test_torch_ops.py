"""chamjax_torch query-path ops against chamjax on the same numpy inputs:
coarse scan, LUTs, window expansion, LUT packing, top-k and the xla scan."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chamjax.ops import coarse as jcoarse
from chamjax.ops import lut as jlut
from chamjax.ops import scan_seg as jseg
from chamjax.ops import scan_xla as jxla
from chamjax.ops import topk as jtopk

from chamjax_torch.eval import tie_mismatches
from chamjax_torch.ops import coarse as tcoarse
from chamjax_torch.ops import lut as tlut
from chamjax_torch.ops import scan_seg as tseg
from chamjax_torch.ops import scan_xla as txla
from chamjax_torch.ops import topk as ttopk


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_ids_equal_except_ties(ids_a, ids_b, d_a, d_b, tol=1e-5):
    bad = tie_mismatches(d_a, ids_a, d_b, ids_b, rtol=tol, atol=tol)
    assert not bad, bad


@pytest.fixture(scope="module")
def coarse_inputs():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    cent = rng.standard_normal((64, 32)).astype(np.float32) * 2.0
    return q, cent


@pytest.mark.parametrize("use_approx", [False, True])
def test_coarse_scan_matches(coarse_inputs, use_approx):
    q, cent = coarse_inputs
    ji, jd = jcoarse.coarse_scan(jnp.asarray(q), jnp.asarray(cent), 8,
                                 use_approx=use_approx)
    ti, td = tcoarse.coarse_scan(t(q), t(cent), 8, use_approx=use_approx)
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    assert_ids_equal_except_ties(ti.numpy(), ji, td.numpy(), jd)


@pytest.mark.parametrize("coarse_cand", [0, 16, 200])
def test_select_probes_matches(coarse_inputs, coarse_cand):
    q, cent = coarse_inputs
    ji, jd = jcoarse.select_probes(jnp.asarray(q), jnp.asarray(cent), 8,
                                   coarse_cand=coarse_cand)
    ti, td = tcoarse.select_probes(t(q), t(cent), 8, coarse_cand=coarse_cand)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    assert_ids_equal_except_ties(ti.numpy(), ji, td.numpy(), jd)


@pytest.mark.parametrize("by_residual", [True, False])
def test_build_luts_matches(coarse_inputs, by_residual):
    q, cent = coarse_inputs
    rng = np.random.default_rng(1)
    cb = rng.standard_normal((8, 256, 4)).astype(np.float32)
    lids = rng.integers(0, 64, (16, 6)).astype(np.int32)
    want = np.asarray(jlut.build_luts(jnp.asarray(q), jnp.asarray(cent),
                                      jnp.asarray(cb), jnp.asarray(lids),
                                      by_residual=by_residual))
    got = tlut.build_luts(t(q), t(cent), t(cb), t(lids),
                          by_residual=by_residual).numpy()
    assert got.shape == want.shape == (16, 6, 256, 8)
    # the sums run in another order than XLA's
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _list_table(rng, nlist, max_len, pad=128):
    list_len = rng.integers(0, max_len, nlist).astype(np.int32)
    list_len[3] = 0
    list_start = np.zeros(nlist, np.int32)
    pos = 0
    for i in range(nlist):
        list_start[i] = pos
        pos += int(np.ceil(max(list_len[i], 1) / pad) * pad)
    return list_start, list_len


@pytest.mark.parametrize("seg,windows", [(256, 12), (128, 40), (1024, 6)])
def test_expand_windows_exact(seg, windows):
    rng = np.random.default_rng(seg)
    nlist, b, nprobe = 16, 3, 5
    list_start, list_len = _list_table(rng, nlist, 3 * seg)
    list_ids = np.stack([rng.permutation(nlist)[:nprobe]
                         for _ in range(b)]).astype(np.int32)
    want = jseg.expand_windows(jnp.asarray(list_ids), jnp.asarray(list_start),
                               jnp.asarray(list_len), windows=windows,
                               seg=seg)
    got = tseg.expand_windows(t(list_ids), t(list_start), t(list_len),
                              windows=windows, seg=seg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [g.dtype for g in got] == [torch.int32] * 3 + [torch.bool]


@pytest.mark.parametrize("lut_bf16", [False, True])
def test_prepare_luts_exact(lut_bf16):
    rng = np.random.default_rng(2)
    luts = rng.standard_normal((3, 4, 256, 8)).astype(np.float32)
    probe = rng.integers(0, 4, (3, 10)).astype(np.int32)
    wk, wi = jseg.prepare_luts(jnp.asarray(luts), jnp.asarray(probe),
                               lut_bf16=lut_bf16)
    gk, gi = tseg.prepare_luts(t(luts), t(probe), lut_bf16=lut_bf16)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gk.is_contiguous() and gi.dtype == torch.int32


def test_pack_luts_bf16_bit_exact():
    rng = np.random.default_rng(3)
    luts = (rng.standard_normal((5, 8, 256)) * 10.0 ** rng.integers(
        -30, 30, (5, 8, 256))).astype(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 65504.0,
                         3.0e38, 1e-40, -1e-40, 1.00390625, 1.01171875,
                         -2.00390625, 7.0e-39], np.float32)
    luts[0, 0, :specials.size] = specials
    # ties for round-to-nearest-even: exactly halfway between two bf16s
    halfway = (np.arange(1, 65, dtype=np.uint32) << 16) | 0x8000
    luts[1, 1, :64] = (halfway + (0x3F80 << 16)).view(np.float32)
    want = np.asarray(jseg.pack_luts_bf16(jnp.asarray(luts)))
    got = tseg.pack_luts_bf16(t(luts)).numpy()
    assert got.dtype == np.int32 and got.shape == (5, 8, 128)
    np.testing.assert_array_equal(got, want)


def test_select_topk_matches():
    rng = np.random.default_rng(4)
    d = rng.standard_normal((6, 500)).astype(np.float32)
    d[:, ::7] = np.inf
    for use_approx in (False, True):
        jv, jp = jtopk.select_topk(jnp.asarray(d), 20, use_approx=use_approx,
                                   recall_target=0.9)
        tv, tp = ttopk.select_topk(t(d), 20, use_approx=use_approx,
                                   recall_target=0.9)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert_ids_equal_except_ties(tp.numpy(), jp, tv.numpy(), jv)
        assert tp.dtype == torch.int32


def test_select_topk_pads_when_n_below_k():
    d = np.array([[3.0, 1.0, 2.0], [0.5, np.inf, 0.25]], np.float32)
    jv, jp = jtopk.select_topk(jnp.asarray(d), 5, use_approx=False)
    tv, tp = ttopk.select_topk(t(d), 5, use_approx=False)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert np.all(np.isinf(tv.numpy()[:, 3:])) and np.all(tp.numpy()[:, 3:] == 0)


def test_select_topk_ties_keep_distances():
    d = np.zeros((2, 40), np.float32)
    d[:, 20:] = 1.0
    jv, _ = jtopk.select_topk(jnp.asarray(d), 25, use_approx=False)
    tv, tp = ttopk.select_topk(t(d), 25, use_approx=False)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.all(np.take_along_axis(d, tp.numpy().astype(int), 1)
                  == tv.numpy())


def test_merge_topk_matches():
    rng = np.random.default_rng(5)
    d1, d2 = rng.random((4, 10), np.float32), rng.random((4, 12), np.float32)
    i1 = rng.integers(0, 1000, (4, 10)).astype(np.int32)
    i2 = rng.integers(0, 1000, (4, 12)).astype(np.int32)
    jv, ji = jtopk.merge_topk(*map(jnp.asarray, (d1, i1, d2, i2)), k=8)
    tv, ti = ttopk.merge_topk(t(d1), t(i1), t(d2), t(i2), 8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("probe_chunk", [1, 3, 8])
def test_scan_lists_xla_matches(probe_chunk):
    rng = np.random.default_rng(6)
    m, nlist, b, nprobe, scan_len = 4, 12, 3, 5, 256
    list_start, list_len = _list_table(rng, nlist, 250)
    n_pad = int(list_start[-1]) + 256 + 64
    codes_t = rng.integers(0, 256, (m, n_pad)).astype(np.uint8)
    ids = np.arange(n_pad, dtype=np.int32)
    luts = rng.random((b, nprobe, 256, m)).astype(np.float32)
    list_ids = np.stack([rng.permutation(nlist)[:nprobe]
                         for _ in range(b)]).astype(np.int32)
    kw = dict(scan_len=scan_len, probe_chunk=probe_chunk, k=10,
              use_approx=False)
    jd, ji = jxla.scan_lists_xla(*map(jnp.asarray, (
        codes_t, ids, list_start, list_len, luts, list_ids)), **kw)
    td, ti = txla.scan_lists_xla(*map(t, (
        codes_t, ids, list_start, list_len, luts, list_ids)), **kw)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    assert_ids_equal_except_ties(ti.numpy(), ji, td.numpy(), jd)
    assert ti.dtype == torch.int32


def test_scan_xla_short_tail_list_no_foreign_rows():
    """Mirror of the chamjax test: a short list near the packed tail must
    not score earlier lists' rows as its own."""
    m, ksub, n_pad = 4, 256, 112
    codes_t = np.zeros((m, n_pad), np.uint8)
    codes_t[:, :100] = 1                # foreign rows: lut[1] = 0.0 → best
    codes_t[:, 100:104] = 2             # true rows:    lut[2] = 1.0
    ids = np.arange(n_pad, dtype=np.int32)
    ids[104:] = -1
    list_start = np.asarray([0, 100], np.int32)
    list_len = np.asarray([100, 4], np.int32)
    luts = np.full((1, 1, ksub, m), 9.0, np.float32)
    luts[:, :, 1, :] = 0.0
    luts[:, :, 2, :] = 1.0
    list_ids = np.asarray([[1]], np.int32)
    d, i = txla.scan_lists_xla(*map(t, (
        codes_t, ids, list_start, list_len, luts, list_ids)),
        scan_len=64, probe_chunk=1, k=8, use_approx=False)
    i, d = i.numpy(), d.numpy()
    assert set(i[0][i[0] >= 0].tolist()) == {100, 101, 102, 103}
    np.testing.assert_allclose(d[0][:4], 4.0)
    assert np.all(i[0][4:] == -1) and np.all(np.isinf(d[0][4:]))
