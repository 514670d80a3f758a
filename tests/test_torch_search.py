"""The slice end to end: chamjax_torch's IVFSearcher (on the CPU, where the
ADC scan runs its plain version) against chamjax's IVFSearcher (Pallas in
interpret mode) on one index carried across, in the flagship's search
shape (seg-tiled, slot-major groups, packed-bf16 LUTs on and off)."""

import dataclasses

import numpy as np
import pytest
import torch

from chamjax.config import IndexConfig, SearchConfig
from chamjax.data import synthetic_dataset
from chamjax.data.ground_truth import compute_ground_truth
from chamjax.eval import recall_at_k
from chamjax.index import build_ivfpq
from chamjax.searcher import IVFSearcher

from chamjax_torch import searcher as tsearcher
from chamjax_torch.config import SearchConfig as TSearchConfig
from chamjax_torch.eval import tie_mismatches
from chamjax_torch.index.ivf import PackedIVF as TPackedIVF
from chamjax_torch.utils import cuda_lib


def carry(idx) -> TPackedIVF:
    return TPackedIVF.from_arrays(
        dataclasses.asdict(idx.cfg), centroids=idx.centroids,
        codebooks=idx.codebooks, codes=idx.codes, ids=idx.ids,
        list_start=idx.list_start, list_len=idx.list_len, ntotal=idx.ntotal,
        opq_R=idx.opq_R)


@pytest.fixture(scope="module")
def setup():
    """A small OPQ + hard-balanced index (the flagship's build shape) whose
    lists span several seg=128 windows."""
    ds = synthetic_dataset(nb=12000, nq=32, nt=6000, d=32, seed=7,
                           n_clusters=32)
    cfg = IndexConfig(dim=32, nlist=32, m=8, list_pad=64, opq=True,
                      balanced=True, balance_hard=True, balance_factor=1.6)
    idx = build_ivfpq(ds.xb, cfg, xt=ds.xt, kmeans_iters=4, pq_iters=4)
    gt, _ = compute_ground_truth(ds.xb, ds.xq, k=10)
    return ds, idx, carry(idx), gt


def same_up_to_ties(dt, it, dj, ij, *, rtol=1e-5, atol=1e-5):
    """Dists allclose; ids equal except in the order of distance ties."""
    np.testing.assert_allclose(dt, dj, rtol=rtol, atol=atol)
    bad = tie_mismatches(dt, it, dj, ij, rtol=rtol, atol=atol)
    assert not bad, bad


def compare(dj, ij, dt, it, gt, *, rtol=1e-5):
    assert it.dtype == np.int64
    same_up_to_ties(dt, it, dj, ij, rtol=rtol)
    assert abs(recall_at_k(it, gt, 10) - recall_at_k(ij, gt, 10)) <= 0.005


FLAGSHIP_SHAPE = dict(nprobe=8, k=10, seg=128, approx_recall_target=0.9,
                      coarse_cand=0)


@pytest.mark.parametrize("group,lut_bf16", [(8, True), (8, False),
                                            (4, True), (4, False)])
def test_searcher_matches_chamjax(setup, group, lut_bf16):
    ds, idx, tidx, gt = setup
    kw = dict(FLAGSHIP_SHAPE, seg_group=group, lut_bf16=lut_bf16)
    dj, ij = IVFSearcher(idx, SearchConfig(**kw)).search(ds.xq)
    cuda_lib.launch_counts.clear()
    ts = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw), device="cpu")
    assert ts.seg == 128 and ts.dev.codes_tiled is not None
    dt, it = ts.search(ds.xq)
    assert cuda_lib.launch_counts["adc_scan_tiles"] == 0   # CPU: plain path
    compare(dj, ij, dt, it, gt)
    assert (it[np.isfinite(dt)] >= 0).all() and (it[~np.isfinite(dt)] == -1).all()


def test_searcher_lane_l1_matches_chamjax(setup):
    ds, idx, tidx, gt = setup
    kw = dict(FLAGSHIP_SHAPE, seg_group=8, lut_bf16=True, lane_l1=True,
              use_approx_topk=False)
    dj, ij = IVFSearcher(idx, SearchConfig(**kw)).search(ds.xq)
    dt, it = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw),
                                   device="cpu").search(ds.xq)
    compare(dj, ij, dt, it, gt)


def test_searcher_xla_backend_matches_chamjax(setup):
    ds, idx, tidx, gt = setup
    kw = dict(FLAGSHIP_SHAPE, backend="xla", use_approx_topk=False)
    dj, ij = IVFSearcher(idx, SearchConfig(**kw)).search(ds.xq)
    ts = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw), device="cpu")
    assert ts.dev.codes_tiled is None
    dt, it = ts.search(ds.xq)
    compare(dj, ij, dt, it, gt)


@pytest.mark.parametrize("lut_bf16", [True, False])
def test_search_preassigned_matches_chamjax(setup, lut_bf16):
    ds, idx, tidx, gt = setup
    kw = dict(FLAGSHIP_SHAPE, seg_group=8, lut_bf16=lut_bf16)
    rng = np.random.default_rng(0)
    list_ids = np.stack([rng.permutation(32)[:6]
                         for _ in range(len(ds.xq))]).astype(np.int32)
    dj, ij = IVFSearcher(idx, SearchConfig(**kw)).search_preassigned(
        ds.xq, list_ids)
    dt, it = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw),
                                   device="cpu").search_preassigned(
        ds.xq, list_ids)
    same_up_to_ties(dt, it, dj, ij)


def test_search_takes_any_strides(setup):
    """Reversed (negative-stride) and read-only query and probe arrays
    search like their contiguous copies, as they do in chamjax."""
    ds, idx, tidx, _gt = setup
    kw = dict(FLAGSHIP_SHAPE, seg_group=8)
    ts = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw), device="cpu")
    rev = ds.xq[::-1]
    ro = np.array(ds.xq)
    ro.flags.writeable = False
    d, i = ts.search(rev)
    d_c, i_c = ts.search(np.ascontiguousarray(rev))
    np.testing.assert_array_equal(d, d_c)
    np.testing.assert_array_equal(i, i_c)
    np.testing.assert_array_equal(ts.search(ro)[1], ts.search(ds.xq)[1])
    dj, ij = IVFSearcher(idx, SearchConfig(**kw)).search(rev)
    np.testing.assert_allclose(d, dj, rtol=1e-5, atol=1e-5)
    lids = np.tile(np.arange(6, dtype=np.int32), (len(ds.xq), 1))[:, ::-1]
    d_p, i_p = ts.search_preassigned(rev, lids)
    d_q, i_q = ts.search_preassigned(np.ascontiguousarray(rev),
                                     np.ascontiguousarray(lids))
    np.testing.assert_array_equal(d_p, d_q)
    np.testing.assert_array_equal(i_p, i_q)


def test_seg_and_xla_backends_agree(setup):
    """The port's tiled kernel path and its xla oracle on one index."""
    ds, _idx, tidx, gt = setup
    kw = dict(FLAGSHIP_SHAPE, lut_bf16=False)
    d_s, i_s = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw),
                                     device="cpu").search(ds.xq)
    d_x, i_x = tsearcher.IVFSearcher(
        tidx, TSearchConfig(**kw, backend="xla"), device="cpu").search(ds.xq)
    same_up_to_ties(d_s, i_s, d_x, i_x)
    assert recall_at_k(i_s, gt, 10) == recall_at_k(i_x, gt, 10)


def test_nprobe_and_k_overrides(setup):
    ds, idx, tidx, _gt = setup
    kw = dict(FLAGSHIP_SHAPE, seg_group=8)
    dj, ij = IVFSearcher(idx, SearchConfig(**kw)).search(ds.xq, nprobe=4,
                                                          k=5)
    dt, it = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw),
                                   device="cpu").search(ds.xq, nprobe=4, k=5)
    assert dt.shape == (32, 5)
    same_up_to_ties(dt, it, dj, ij)


def test_unported_routes_raise(setup):
    """The one refusal left on the scan routes: the ``debug_ablate``
    measurement bodies of the tiled kernel (queued with the measurement
    variants); every backend and layout of the searcher now runs."""
    _ds, _idx, tidx, _gt = setup
    from chamjax_torch.ops.scan_seg_block import adc_scan_tiles
    dev = tsearcher.DeviceIVF.from_packed(tidx, device="cpu", tile_seg=128)
    n = 8
    args = (dev.codes_tiled, torch.zeros(n, dtype=torch.int32),
            torch.full((n,), 128, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32),
            torch.zeros((1, tidx.cfg.m, 256)))
    for body in ("copy", "nogather"):
        with pytest.raises(NotImplementedError, match="debug_ablate"):
            adc_scan_tiles(*args, seg=128, debug_ablate=body)
    assert adc_scan_tiles(*args, seg=128).shape == (n, 128)
    assert not hasattr(tsearcher, "_not_ported")


@pytest.mark.parametrize("list_len,nprobe", [
    (np.full(1024, 100), 32), (np.full(64, 1536), 8),
    (np.array([0, 5, 700, 3000, 12000]), 3), (np.zeros(4), 2)])
def test_auto_seg_and_windows_match_chamjax(list_len, nprobe):
    from chamjax import searcher as js
    assert tsearcher.auto_seg(list_len) == js.auto_seg(list_len)
    for seg in (256, 512, 1024):
        assert (tsearcher.auto_windows(list_len, seg, nprobe)
                == js.auto_windows(list_len, seg, nprobe))
    for cand in (-1, 0, 5, 100000):
        for nlist in (4096, 65536):
            assert (tsearcher.resolve_coarse_cand(cand, nlist, nprobe)
                    == js.resolve_coarse_cand(cand, nlist, nprobe))


def test_ivfpq_search_on_device_tensors(setup):
    """The tensor-level entry point returns int32 ids on the index's
    device, -1 where nothing was found."""
    ds, _idx, tidx, _gt = setup
    dev = tsearcher.DeviceIVF.from_packed(tidx, device="cpu", tile_seg=128)
    d, i = tsearcher.ivfpq_search(dev, torch.from_numpy(ds.xq[:4]),
                                  nprobe=1, k=2000, seg=128, group=8,
                                  windows=8, lut_bf16=True)
    assert d.shape == (4, 2000) and i.dtype == torch.int32
    fin = torch.isfinite(d)
    assert (~fin).any() and (i[~fin] == -1).all() and (i[fin] >= 0).all()
