"""The stage profile (``chamjax_torch.benchmarks.profiling_stages``) on the
CPU at a tiny synthetic shape: it returns the JAX profile's keys, and each
stage's output equals chamjax's function on the same inputs (Pallas in
interpret mode); the CLI writes a ``ResultStore``.  Times here are the
host's clock, never a device figure."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chamjax.ops.coarse import coarse_scan as j_coarse_scan
from chamjax.ops.lut import build_luts as j_build_luts
from chamjax.ops.scan_seg import expand_windows as j_expand_windows
from chamjax.ops.scan_seg import pack_luts_bf16 as j_pack_luts_bf16
from chamjax.ops.scan_seg_multi import (
    adc_scan_segments_multi as j_adc_scan_segments_multi)
from chamjax.ops.topk import select_topk as j_select_topk
from chamjax.utils import ResultStore as JResultStore

from chamjax_torch.benchmarks import profiling_stages as ps
from chamjax_torch.ops.topk import select_topk

from test_torch_scan_kernel import bf16_within_one_ulp

SHAPE = dict(nb=32 * 100, d=32, nlist=32, m=8, seg=128)
RUN = dict(batch=4, nprobe=4, k=10, seg=128, group=2)


@pytest.fixture(scope="module")
def index():
    return ps.synthetic_index(**SHAPE, tiled=True, device="cpu", seed=3)


@pytest.fixture(scope="module")
def xq():
    return np.random.default_rng(5).standard_normal((8, 32)).astype(
        np.float32)


@pytest.fixture(scope="module")
def profiled(index, xq):
    return ps.profile_stages(index, xq, **RUN, lut_bf16=True, coarse_cand=8,
                             lane_l1=True, select_l1=16)


def test_every_key_positive_and_finite(profiled):
    times, _t = profiled
    assert tuple(times) == ps.KEYS
    assert all(math.isfinite(v) and v > 0 for v in times.values()), times
    assert times["qps"] == pytest.approx(RUN["batch"] / times["full_ms"]
                                         * 1e3)


def test_optional_keys_follow_the_options(index, xq):
    times, t = ps.profile_stages(index, xq, **RUN)
    assert set(ps.KEYS) - set(times) == {"coarse2_ms", "scan_bf16_ms",
                                         "full_lane_l1_ms",
                                         "full_select_l1_ms"}
    assert "dists_bf16" not in t


def test_window_budget_is_the_jax_profiles_rule():
    lens = np.array([0, 100, 128, 129, 700, 3000], np.float64)
    for seg, nprobe, group in ((128, 4, 2), (512, 32, 8), (256, 7, 1)):
        # profiling_stages.py:196-199 of the JAX package
        segs = np.ceil(lens / seg)
        w_mean = float((lens * segs).sum() / lens.sum())
        W = int(np.ceil(nprobe * w_mean * 1.2)) + 4
        W = -(-W // group) * group
        assert ps.window_budget(lens, seg, nprobe, group) == W


def test_stage_outputs_equal_chamjax(index, profiled):
    _times, t = profiled
    b, nprobe, seg = RUN["batch"], RUN["nprobe"], RUN["seg"]
    q = jnp.asarray(t["q"].numpy())
    c = jnp.asarray(index.centroids.numpy())
    li, _ = j_coarse_scan(q, c, nprobe)
    np.testing.assert_array_equal(t["li"].numpy(), np.asarray(li))
    luts = j_build_luts(q, c, jnp.asarray(index.codebooks.numpy()), li,
                        by_residual=True)
    np.testing.assert_allclose(t["luts"].numpy(), np.asarray(luts),
                               rtol=1e-5, atol=1e-5)
    starts, lens, probe, _ = j_expand_windows(
        li, jnp.asarray(index.list_start.numpy()),
        jnp.asarray(index.list_len.numpy()), windows=t["W"], seg=seg)
    np.testing.assert_array_equal(t["starts"].numpy(),
                                  np.asarray(starts).reshape(-1))
    np.testing.assert_array_equal(t["lens"].numpy(),
                                  np.asarray(lens).reshape(-1))
    lut_idx = (jnp.arange(b, dtype=jnp.int32)[:, None] * nprobe
               + probe).reshape(-1)
    np.testing.assert_array_equal(t["lut_idx"].numpy(), np.asarray(lut_idx))
    # the scan on the same kernel-layout LUTs (the port's, so that the
    # comparison is of the scans alone)
    luts_k = jnp.asarray(t["luts_k"].numpy())
    codes_t = jnp.asarray(index.codes_t.numpy())
    args = (codes_t, jnp.asarray(t["starts"].numpy()),
            jnp.asarray(t["lens"].numpy()), lut_idx)
    want = np.asarray(j_adc_scan_segments_multi(
        *args, luts_k, seg=seg, group=RUN["group"],
        interpret=True)).reshape(b, -1)
    np.testing.assert_allclose(t["dists"].numpy(), want, rtol=1e-5,
                               atol=1e-5)
    want_bf16 = np.asarray(j_adc_scan_segments_multi(
        *args, j_pack_luts_bf16(luts_k), seg=seg, group=RUN["group"],
        interpret=True, lut_bf16=True)).reshape(b, -1)
    bf16_within_one_ulp(t["dists_bf16"].numpy(), want_bf16)
    # top-k over the scan's distances: values within rtol 1e-5, the same
    # positions wherever the value is not tied
    vals, pos = select_topk(t["dists"], RUN["k"])
    j_vals, j_pos = j_select_topk(jnp.asarray(t["dists"].numpy()), RUN["k"],
                                  use_approx=False)
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=1e-5)
    d = t["dists"].numpy()
    ties = np.array([[np.sum(row == v) > 1 for v in vr]
                     for row, vr in zip(d, vals.numpy())])
    np.testing.assert_array_equal(pos.numpy()[~ties],
                                  np.asarray(j_pos)[~ties])


def test_cli_writes_a_result_store_read_by_chamjax(tmp_path):
    out = str(tmp_path / "stages.pkl")
    ps.main(["--synthetic", "--nb", "3200", "--d", "32", "--nlist", "32",
             "--m", "8", "--seg", "128", "--group", "2", "--nprobe", "4",
             "--k", "10", "--values", "2", "4", "--lut-bf16",
             "--device", "cpu", "--out", out])
    leaves = dict(JResultStore(out).walk())
    assert set(leaves) == {("nb3200", "batch", "2"), ("nb3200", "batch",
                                                      "4")}
    for res in leaves.values():
        assert set(res) == set(ps.KEYS) - {"coarse2_ms", "full_lane_l1_ms",
                                           "full_select_l1_ms"}


def test_synthetic_index_layout(index):
    L, seg = SHAPE["nb"] // SHAPE["nlist"], SHAPE["seg"]
    assert index.codes_tiled.shape == (SHAPE["nlist"], SHAPE["m"], seg)
    np.testing.assert_array_equal(index.list_start.numpy(),
                                  np.arange(SHAPE["nlist"]) * seg)
    assert (index.list_len.numpy() == L).all()
    # the tiled twin is the flat codes cut at seg
    np.testing.assert_array_equal(
        index.codes_tiled[1].numpy(), index.codes_t[:, seg:2 * seg].numpy())
    again = ps.synthetic_index(**SHAPE, tiled=True, device="cpu", seed=3)
    assert torch.equal(again.codes_t, index.codes_t)
