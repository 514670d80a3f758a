"""The searcher's flat-layout and padded-window routes end to end:
chamjax_torch's IVFSearcher (on the CPU, where the scans run their plain
versions) against chamjax's IVFSearcher (Pallas in interpret mode) on one
index carried across — ``tiled=False`` at group 8 (multi-window scan) and
group 1 (single-window scan), and ``backend="pallas"``."""

import warnings

import numpy as np
import pytest
import torch

from chamjax.config import IndexConfig, SearchConfig
from chamjax.data import synthetic_dataset
from chamjax.data.ground_truth import compute_ground_truth
from chamjax.index import build_ivfpq
from chamjax.searcher import IVFSearcher

from chamjax_torch import searcher as tsearcher
from chamjax_torch.config import SearchConfig as TSearchConfig
from chamjax_torch.utils import cuda_lib

from test_torch_search import FLAGSHIP_SHAPE, carry, compare, same_up_to_ties

INDEXES = {
    # the flagship's build shape: OPQ + hard-balanced, list_pad=64
    "opq_hard": dict(opq=True, balanced=True, balance_hard=True,
                     balance_factor=1.6),
    # soft-balanced, no OPQ: uneven lists of several seg=128 windows each
    "soft": dict(opq=False, balanced=True, balance_hard=False,
                 balance_factor=1.3),
}


@pytest.fixture(scope="module")
def corpus():
    ds = synthetic_dataset(nb=12000, nq=16, nt=6000, d=32, seed=7,
                           n_clusters=32)
    gt, _ = compute_ground_truth(ds.xb, ds.xq, k=10)
    return ds, gt


@pytest.fixture(scope="module")
def indexes(corpus):
    ds, _gt = corpus
    out = {}
    for name, kw in INDEXES.items():
        cfg = IndexConfig(dim=32, nlist=32, m=8, list_pad=64, **kw)
        idx = build_ivfpq(ds.xb, cfg, xt=ds.xt, kmeans_iters=4, pq_iters=4)
        out[name] = (idx, carry(idx))
    return out


ROUTES = {
    "flat_g8_bf16": dict(tiled=False, seg_group=8, lut_bf16=True),
    "flat_g8_f32": dict(tiled=False, seg_group=8, lut_bf16=False),
    "flat_g1_bf16": dict(tiled=False, seg_group=1, lut_bf16=True),
    "flat_g1_f32": dict(tiled=False, seg_group=1, lut_bf16=False),
    "pallas": dict(backend="pallas"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("index_name", sorted(INDEXES))
def test_route_matches_chamjax(corpus, indexes, index_name, route):
    ds, gt = corpus
    idx, tidx = indexes[index_name]
    kw = dict(FLAGSHIP_SHAPE, **ROUTES[route])
    js = IVFSearcher(idx, SearchConfig(**kw))
    dj, ij = js.search(ds.xq)
    cuda_lib.launch_counts.clear()
    ts = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw), device="cpu")
    assert ts.dev.codes_tiled is None           # the flat layout alone
    assert (ts.backend, ts.scan_len, ts.tile) == (js.backend, js.scan_len,
                                                  js.tile)
    if route != "pallas":
        assert int(tidx.list_len.max()) > ts.seg    # lists span windows
    dt, it = ts.search(ds.xq)
    assert sum(cuda_lib.launch_counts.values()) == 0    # CPU: plain path
    compare(dj, ij, dt, it, gt)
    assert (it[np.isfinite(dt)] >= 0).all()
    assert (it[~np.isfinite(dt)] == -1).all()


def test_flat_lane_l1_matches_chamjax(corpus, indexes):
    ds, gt = corpus
    idx, tidx = indexes["soft"]
    kw = dict(FLAGSHIP_SHAPE, tiled=False, seg_group=8, lut_bf16=True,
              lane_l1=True, use_approx_topk=False)
    dj, ij = IVFSearcher(idx, SearchConfig(**kw)).search(ds.xq)
    dt, it = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw),
                                   device="cpu").search(ds.xq)
    compare(dj, ij, dt, it, gt)


@pytest.mark.parametrize("route", ["flat_g8_bf16", "flat_g1_f32", "pallas"])
def test_search_preassigned_matches_chamjax(corpus, indexes, route):
    ds, _gt = corpus
    idx, tidx = indexes["opq_hard"]
    kw = dict(FLAGSHIP_SHAPE, **ROUTES[route])
    rng = np.random.default_rng(1)
    list_ids = np.stack([rng.permutation(32)[:6]
                         for _ in range(len(ds.xq))]).astype(np.int32)
    dj, ij = IVFSearcher(idx, SearchConfig(**kw)).search_preassigned(
        ds.xq, list_ids)
    dt, it = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw),
                                   device="cpu").search_preassigned(
        ds.xq, list_ids)
    same_up_to_ties(dt, it, dj, ij)


def test_flat_routes_equal_tiled_route(corpus, indexes):
    """One index, f32 LUTs: the tiled twin, the flat multi-window and
    single-window scans and the padded-window scan find the same
    neighbours at the same distances (the xla oracle too)."""
    ds, gt = corpus
    _idx, tidx = indexes["soft"]
    kw = dict(FLAGSHIP_SHAPE, lut_bf16=False, use_approx_topk=False)
    d0, i0 = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw),
                                   device="cpu").search(ds.xq)
    for route in ("flat_g8_f32", "flat_g1_f32", "pallas"):
        d, i = tsearcher.IVFSearcher(
            tidx, TSearchConfig(**dict(kw, **ROUTES[route])),
            device="cpu").search(ds.xq)
        same_up_to_ties(d, i, d0, i0)
    d_x, i_x = tsearcher.IVFSearcher(
        tidx, TSearchConfig(**dict(kw, backend="xla")),
        device="cpu").search(ds.xq)
    np.testing.assert_allclose(d_x, d0, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("preassigned", [False, True])
def test_pallas_downgrade_warns(corpus, indexes, preassigned):
    """Mirror of tests/test_search.py::test_backend_downgrade_warns: a
    scan_len that is not a GROUP multiple falls back to the xla scan with a
    warning, and returns what the xla backend returns."""
    ds, _gt = corpus
    _idx, tidx = indexes["soft"]
    dev = tsearcher.DeviceIVF.from_packed(tidx, device="cpu")
    q = torch.from_numpy(ds.xq[:4])
    kw = dict(nprobe=4, k=5, scan_len=777)
    lids = torch.arange(16, dtype=torch.int32).reshape(4, 4)

    def run(backend):
        if preassigned:
            return tsearcher.ivfpq_search_preassigned(
                dev, q, lids, backend=backend, **kw)
        return tsearcher.ivfpq_search(dev, q, backend=backend, **kw)

    with pytest.warns(UserWarning, match="falling back"):
        d, i = run("pallas")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        d_x, i_x = run("xla")
    assert torch.equal(d, d_x) and torch.equal(i, i_x)


@pytest.mark.parametrize("backend", ["seg", "pallas"])
def test_nbits_not_8_falls_back_to_xla(corpus, backend):
    """Both kernel backends take 8-bit codes; a 6-bit index warns and
    searches with the xla scan, as chamjax does."""
    ds, gt = corpus
    cfg = IndexConfig(dim=32, nlist=16, m=8, nbits=6, list_pad=64)
    idx6 = build_ivfpq(ds.xb[:4000], cfg, xt=ds.xt[:2000], kmeans_iters=2,
                       pq_iters=2)
    kw = dict(nprobe=4, k=10, backend=backend, use_approx_topk=False)
    with pytest.warns(UserWarning, match="falling back"):
        js = IVFSearcher(idx6, SearchConfig(**kw))
    with pytest.warns(UserWarning, match="falling back"):
        ts = tsearcher.IVFSearcher(carry(idx6), TSearchConfig(**kw),
                                   device="cpu")
    assert ts.backend == js.backend == "xla"
    dj, ij = js.search(ds.xq)
    dt, it = ts.search(ds.xq)
    same_up_to_ties(dt, it, dj, ij)


@pytest.mark.parametrize("scan_quantile", [1.0, 0.5])
def test_pallas_scan_len_and_tile_match_chamjax(indexes, scan_quantile):
    for idx, tidx in indexes.values():
        kw = dict(nprobe=8, k=10, backend="pallas")
        js = IVFSearcher(idx, SearchConfig(**kw),
                         scan_quantile=scan_quantile)
        ts = tsearcher.IVFSearcher(tidx, TSearchConfig(**kw),
                                   scan_quantile=scan_quantile, device="cpu")
        assert ts.scan_len % 1024 == 0
        assert (ts.scan_len, ts.tile) == (js.scan_len, js.tile)

