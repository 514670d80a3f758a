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


def compare(dj, ij, dt, it, gt, *, rtol=1e-5):
    np.testing.assert_allclose(dt, dj, rtol=rtol, atol=1e-5)
    assert it.dtype == np.int64
    # ids equal except among distance ties
    assert np.all((ij == it) | (np.abs(dj - dt) < 1e-4))
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
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
    assert np.all((ij == it) | (np.abs(dj - dt) < 1e-4))


def test_seg_and_xla_backends_agree(setup):
    """The port's tiled kernel path and its xla oracle on one index."""
    ds, _idx, tidx, gt = setup
    kw = dict(FLAGSHIP_SHAPE, lut_bf16=False)
    d_s, i_s = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw),
                                     device="cpu").search(ds.xq)
    d_x, i_x = tsearcher.IVFSearcher(
        tidx, TSearchConfig(**kw, backend="xla"), device="cpu").search(ds.xq)
    np.testing.assert_allclose(d_s, d_x, rtol=1e-5, atol=1e-5)
    assert np.all((i_s == i_x) | (np.abs(d_s - d_x) < 1e-4))
    assert recall_at_k(i_s, gt, 10) == recall_at_k(i_x, gt, 10)


def test_nprobe_and_k_overrides(setup):
    ds, idx, tidx, _gt = setup
    kw = dict(FLAGSHIP_SHAPE, seg_group=8)
    dj, ij = IVFSearcher(idx, SearchConfig(**kw)).search(ds.xq, nprobe=4,
                                                          k=5)
    dt, it = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw),
                                   device="cpu").search(ds.xq, nprobe=4, k=5)
    assert dt.shape == (32, 5)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
    assert np.all((ij == it) | (np.abs(dj - dt) < 1e-4))


def test_unported_routes_raise(setup):
    ds, _idx, tidx, _gt = setup
    with pytest.raises(NotImplementedError, match="adc_scan_distances"):
        tsearcher.IVFSearcher(tidx, TSearchConfig(backend="pallas"),
                              device="cpu")
    flat = tsearcher.IVFSearcher(tidx, TSearchConfig(nprobe=4, k=5,
                                                     tiled=False),
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="adc_scan_segments"):
        flat.search(ds.xq)


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
