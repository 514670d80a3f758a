"""The mesh-sharded search and the sharded streamed build
(``chamjax_torch/parallel/sharded_search.py``,
``index/device_build.py::build_ivfpq_device_sharded``) against the JAX
package's, on the CPU.

Counterparts of ``tests/test_sharded.py`` (one a test, in its order) and of
``tests/test_device_build.py::test_sharded_streamed_build_matches_unsharded``.
Both packages get the same numpy inputs: the JAX package runs on its
8-virtual-device CPU mesh (``tests/conftest.py``), with Pallas in interpret
mode; the port on a mesh of CPU positions (``make_mesh(axes,
devices=["cpu"] * n)``).  Tolerances: ``shard_index`` and the sharded
pack are bit-equal; a search is held to the reference test's tolerance
(distances rtol 1e-4 / atol 1e-3) with ids equal up to the order of ties
(``tie_mismatches``), against the JAX package's sharded search and the
port's single-device search.
"""

import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from chamjax.config import IndexConfig
from chamjax.data import synthetic_dataset
from chamjax.data.ground_truth import compute_ground_truth
from chamjax.eval import recall_at_k
from chamjax.index import build_ivfpq
from chamjax.index import device_build as jdb
from chamjax.parallel import make_mesh as j_make_mesh
from chamjax.parallel import shard_index as j_shard_index
from chamjax.parallel import sharded_search as j_sharded_search
from chamjax.parallel.sharded_search import place_sharded as j_place
from chamjax.parallel.sharded_search import sharded_search_2d as j_search_2d

from chamjax_torch.config import IndexConfig as TIndexConfig
from chamjax_torch.config import SearchConfig as TSearchConfig
from chamjax_torch.eval import tie_mismatches
from chamjax_torch.index import build_ivfpq_device_sharded
from chamjax_torch.index import device_build as tdb
from chamjax_torch.index.ivf import PackedIVF as TPackedIVF
from chamjax_torch.ops.scan_seg import MAX_SEG
from chamjax_torch.parallel import (make_mesh, place_sharded, shard_index,
                                    sharded_search, sharded_search_2d)
from chamjax_torch.searcher import IVFSearcher, auto_seg, auto_windows

# the module (the package's ``sharded_search`` is the function)
tss = importlib.import_module("chamjax_torch.parallel.sharded_search")
RTOL, ATOL = 1e-4, 1e-3       # the reference tests' distance tolerance


def carry(idx) -> TPackedIVF:
    return TPackedIVF.from_arrays(
        dataclasses.asdict(idx.cfg), centroids=idx.centroids,
        codebooks=idx.codebooks, codes=idx.codes, ids=idx.ids,
        list_start=idx.list_start, list_len=idx.list_len, ntotal=idx.ntotal,
        opq_R=idx.opq_R)


def n(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def stacked(seq):
    return np.stack([n(t) for t in seq])


def held(got, want, rtol=RTOL, atol=ATOL):
    """``got``/``want`` = (dists, ids): distances allclose, ids equal up to
    the order of ties."""
    d, i = n(got[0]), n(got[1]).astype(np.int64)
    dw, iw = n(want[0]), n(want[1]).astype(np.int64)
    np.testing.assert_allclose(d, dw, rtol=rtol, atol=atol)
    bad = tie_mismatches(d, i, dw, iw, rtol=rtol, atol=atol)
    assert not bad, bad


def port_mesh(axes):
    return make_mesh(axes, devices=["cpu"] * math.prod(s for _, s in axes))


def jax_mesh(axes):
    return j_make_mesh(axes,
                       devices=jax.devices()[:math.prod(s for _, s in axes)])


def tq(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def single(t_idx, **kw):
    return IVFSearcher(t_idx, TSearchConfig(use_approx_topk=False, **kw),
                       device="cpu")


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_dataset(nb=20000, nq=16, nt=8000, d=32, seed=3,
                           n_clusters=64)
    cfg = IndexConfig(dim=32, nlist=64, m=8, list_pad=128)
    idx = build_ivfpq(ds.xb, cfg, xt=ds.xt, kmeans_iters=6, pq_iters=6)
    return ds, idx, carry(idx)


SEG_KW = dict(nprobe=8, k=10, windows=32, seg=256, group=4, use_approx=False,
              backend="seg", lut_bf16=True)


@pytest.fixture(scope="module")
def jax_2d_tiled(setup):
    """The JAX package's 2-D search (data 2 × lists 4, tiled, packed-bf16
    LUTs) of the first 8 queries, shared by the 2-D tests."""
    ds, idx, _ = setup
    mesh = jax_mesh((("data", 2), ("lists", 4)))
    sh = j_place(j_shard_index(idx, 4, tile_seg=256), mesh)
    q = jax.device_put(jnp.asarray(ds.xq[:8]), NamedSharding(mesh, P("data")))
    return j_search_2d(sh, q, mesh=mesh, interpret=True, **SEG_KW)


@pytest.mark.parametrize("tile_seg", [0, 256])
def test_shard_index_partitions_everything(setup, tile_seg):
    _, idx, t_idx = setup
    sh = shard_index(t_idx, 4, tile_seg=tile_seg)
    jsh = j_shard_index(idx, 4, tile_seg=tile_seg)
    for f in ("codes_t", "ids", "list_start", "list_len", "codes_tiled"):
        if getattr(jsh, f) is None:
            assert getattr(sh, f) is None, f
        else:
            np.testing.assert_array_equal(stacked(getattr(sh, f)),
                                          np.asarray(getattr(jsh, f)), f)
    assert sh.n_shards == 4
    lens = stacked(sh.list_len)
    assert np.all((lens > 0).sum(axis=0) <= 1)
    np.testing.assert_array_equal(lens.sum(axis=0), t_idx.list_len)
    all_ids = stacked(sh.ids).ravel()
    np.testing.assert_array_equal(np.sort(all_ids[all_ids >= 0]),
                                  np.arange(t_idx.ntotal))


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_matches_single_device(setup, n_shards):
    ds, idx, t_idx = setup
    scan_len = idx.suggest_scan_len(8)
    kw = dict(nprobe=8, k=10, scan_len=scan_len, use_approx=False,
              backend="xla")
    mesh = port_mesh((("lists", n_shards),))
    sh = place_sharded(shard_index(t_idx, n_shards), mesh)
    got = sharded_search(sh, tq(ds.xq), mesh=mesh, **kw)
    jm = jax_mesh((("lists", n_shards),))
    want = j_sharded_search(j_place(j_shard_index(idx, n_shards), jm),
                            jnp.asarray(ds.xq), mesh=jm, **kw)
    held(got, want)
    held(got, single(t_idx, nprobe=8, k=10, backend="xla").search(ds.xq))


def test_sharded_search_is_replicated(setup):
    ds, idx, t_idx = setup
    kw = dict(nprobe=4, k=5, scan_len=idx.suggest_scan_len(4),
              use_approx=False, backend="xla")
    mesh = port_mesh((("lists", 4),))
    sh = place_sharded(shard_index(t_idx, 4), mesh)
    q = tq(ds.xq[:4])
    d, i = sharded_search(sh, q, mesh=mesh, **kw)
    assert d.shape == (4, 5) and i.shape == (4, 5)
    assert d.device == q.device and i.dtype == torch.int32
    assert np.all(np.diff(n(d), axis=1) >= -1e-5)
    jm = jax_mesh((("lists", 4),))
    held((d, i), j_sharded_search(j_place(j_shard_index(idx, 4), jm),
                                  jnp.asarray(ds.xq[:4]), mesh=jm, **kw))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_seg_backend_matches_single_device(setup, n_shards):
    ds, idx, t_idx = setup
    mesh = port_mesh((("lists", n_shards),))
    sh = place_sharded(shard_index(t_idx, n_shards), mesh)
    got = sharded_search(sh, tq(ds.xq[:8]), mesh=mesh, **SEG_KW)
    jm = jax_mesh((("lists", n_shards),))
    want = j_sharded_search(j_place(j_shard_index(idx, n_shards), jm),
                            jnp.asarray(ds.xq[:8]), mesh=jm, interpret=True,
                            **SEG_KW)
    held(got, want)
    held(got, single(t_idx, nprobe=8, k=10, backend="seg").search(ds.xq[:8]))


def test_sharded_coarse_cand_matches_exact(setup):
    ds, idx, t_idx = setup
    kw = dict(SEG_KW, lut_bf16=False)
    mesh = port_mesh((("lists", 2),))
    sh = place_sharded(shard_index(t_idx, 2), mesh)
    exact = sharded_search(sh, tq(ds.xq[:8]), mesh=mesh, **kw)
    two = sharded_search(sh, tq(ds.xq[:8]), mesh=mesh, coarse_cand=32, **kw)
    held(two, exact, rtol=1e-5, atol=1e-4)
    jm = jax_mesh((("lists", 2),))
    held(two, j_sharded_search(j_place(j_shard_index(idx, 2), jm),
                               jnp.asarray(ds.xq[:8]), mesh=jm,
                               coarse_cand=32, interpret=True, **kw))


def test_sharded_2d_data_and_lists(setup):
    ds, idx, t_idx = setup
    mesh = port_mesh((("data", 2), ("lists", 4)))
    sh = place_sharded(shard_index(t_idx, 4), mesh)
    got = sharded_search_2d(sh, tq(ds.xq[:8]), mesh=mesh, **SEG_KW)
    jm = jax_mesh((("data", 2), ("lists", 4)))
    q = jax.device_put(jnp.asarray(ds.xq[:8]), NamedSharding(jm, P("data")))
    held(got, j_search_2d(j_place(j_shard_index(idx, 4), jm), q, mesh=jm,
                          interpret=True, **SEG_KW))
    held(got, single(t_idx, nprobe=8, k=10, backend="seg").search(ds.xq[:8]))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_tiled_matches_single_device(setup, n_shards):
    ds, idx, t_idx = setup
    sh = shard_index(t_idx, n_shards, tile_seg=256)
    assert sh.codes_t is None and sh.codes_tiled is not None
    assert all(t.shape[1:] == (8, 256) for t in sh.codes_tiled)
    assert np.all(stacked(sh.list_start) % 256 == 0)
    mesh = port_mesh((("lists", n_shards),))
    sh = place_sharded(sh, mesh)
    got = sharded_search(sh, tq(ds.xq[:8]), mesh=mesh, **SEG_KW)
    jm = jax_mesh((("lists", n_shards),))
    want = j_sharded_search(
        j_place(j_shard_index(idx, n_shards, tile_seg=256), jm),
        jnp.asarray(ds.xq[:8]), mesh=jm, interpret=True, **SEG_KW)
    held(got, want)
    held(got, single(t_idx, nprobe=8, k=10, backend="seg").search(ds.xq[:8]))


def test_sharded_2d_tiled_production_layout(setup, jax_2d_tiled):
    """2-D mesh, tiled scan, packed-bf16 LUTs, hierarchical L1 selection
    (exact here, as on the JAX package's CPU)."""
    ds, idx, t_idx = setup
    mesh = port_mesh((("data", 2), ("lists", 4)))
    sh = place_sharded(shard_index(t_idx, 4, tile_seg=256), mesh)
    got = sharded_search_2d(sh, tq(ds.xq[:8]), mesh=mesh,
                            **dict(SEG_KW, use_approx=True, select_l1=256))
    held(got, jax_2d_tiled)
    held(got, single(t_idx, nprobe=8, k=10, backend="seg").search(ds.xq[:8]))


def test_sharded_2d_coarse_is_batch_sharded(setup, jax_2d_tiled,
                                            monkeypatch):
    """The rotation, coarse scan and LUTs run once per data row, on that
    row's b/dp queries: never on the whole batch, never once a list
    shard."""
    ds, _, t_idx = setup
    calls = []
    real = tss.select_probes

    def spy(q, *a, **k):
        calls.append(tuple(q.shape))
        return real(q, *a, **k)
    monkeypatch.setattr(tss, "select_probes", spy)
    mesh = port_mesh((("data", 2), ("lists", 4)))
    sh = place_sharded(shard_index(t_idx, 4, tile_seg=256), mesh)
    got = sharded_search_2d(sh, tq(ds.xq[:8]), mesh=mesh, **SEG_KW)
    assert calls == [(4, 32), (4, 32)]
    held(got, jax_2d_tiled)


def test_sharded_2d_merge_collective_shapes(setup, jax_2d_tiled,
                                            monkeypatch):
    """The only gathers are the merge's: each row's S local (b/dp, k)
    dists and ids to the row's first position (the payload
    ``perf_model.mesh_search_model`` prices), then the rows' (b/dp, k)
    results in order."""
    ds, _, t_idx = setup
    S, dp, b, k = 4, 2, 8, 10
    gathered = []
    real = tss.all_gather_to

    def spy(tensors, device):
        gathered.append([(t.dtype, tuple(t.shape)) for t in tensors])
        return real(tensors, device)
    monkeypatch.setattr(tss, "all_gather_to", spy)
    mesh = port_mesh((("data", dp), ("lists", S)))
    sh = place_sharded(shard_index(t_idx, S, tile_seg=256), mesh)
    got = sharded_search_2d(sh, tq(ds.xq[:b]), mesh=mesh, **SEG_KW)
    merge = [[(torch.float32, (b // dp, k))] * S,
             [(torch.int32, (b // dp, k))] * S]
    out = [[(torch.float32, (b // dp, k))] * dp,
           [(torch.int32, (b // dp, k))] * dp]
    assert gathered == merge * dp + out
    held(got, jax_2d_tiled)


def test_sharded_device_build_tiled(setup):
    ds, _, _ = setup
    cfg = IndexConfig(dim=32, nlist=16, m=8, list_pad=64)
    kw = dict(kmeans_iters=2, pq_iters=2, chunk=4096, block=256,
              tile_seg=256)
    xb = ds.xb[:8192]
    sh, info = build_ivfpq_device_sharded(
        lambda s, c: tq(xb[s:s + c]), 8192, TIndexConfig(**vars(cfg)),
        tq(ds.xt[:4000]), 2, device="cpu", **kw)
    jsh, jinfo = jdb.build_ivfpq_device_sharded(
        lambda s, c: jnp.asarray(xb[s:s + c]), 8192, cfg,
        jnp.asarray(ds.xt[:4000]), 2, **kw)
    for got in (sh, jsh):
        assert got.codes_t is None and got.codes_tiled is not None
        assert len(got.codes_tiled) == 2
        assert all(t.shape[1:] == (8, 256) for t in got.codes_tiled)
        assert np.all(stacked(got.list_start) % 256 == 0)
        all_ids = stacked(got.ids).ravel()
        np.testing.assert_array_equal(np.sort(all_ids[all_ids >= 0]),
                                      np.arange(8192))
    assert sorted(info) == sorted(jinfo)
    mesh = port_mesh((("lists", 2),))
    d, i = sharded_search(place_sharded(sh, mesh), tq(ds.xq[:4]), mesh=mesh,
                          nprobe=4, k=5, windows=16, seg=256, group=2,
                          use_approx=False, backend="seg")
    assert d.shape == (4, 5)
    assert bool(torch.isfinite(d).all()) and bool((i >= 0).all())


def test_sharded_opq_matches_single_device(setup):
    ds, _, _ = setup
    cfg = IndexConfig(dim=32, nlist=64, m=8, list_pad=128, opq=True)
    idx = build_ivfpq(ds.xb, cfg, xt=ds.xt, kmeans_iters=4, pq_iters=4)
    t_idx = carry(idx)
    mesh = port_mesh((("lists", 2),))
    sh = place_sharded(shard_index(t_idx, 2, tile_seg=256), mesh)
    assert sh.opq_R is not None
    got = sharded_search(sh, tq(ds.xq[:8]), mesh=mesh, **SEG_KW)
    jm = jax_mesh((("lists", 2),))
    want = j_sharded_search(j_place(j_shard_index(idx, 2, tile_seg=256), jm),
                            jnp.asarray(ds.xq[:8]), mesh=jm, interpret=True,
                            **SEG_KW)
    held(got, want)
    held(got, single(t_idx, nprobe=8, k=10, backend="seg").search(ds.xq[:8]))


def test_sharded_device_build_opq(setup):
    ds, _, _ = setup
    cfg = IndexConfig(dim=32, nlist=16, m=8, list_pad=64, opq=True)
    kw = dict(kmeans_iters=2, pq_iters=2, chunk=4096, block=256,
              tile_seg=256)
    xb = ds.xb[:8192]
    sh, _ = build_ivfpq_device_sharded(
        lambda s, c: tq(xb[s:s + c]), 8192, TIndexConfig(**vars(cfg)),
        tq(ds.xt[:4000]), 2, device="cpu", **kw)
    jsh, _ = jdb.build_ivfpq_device_sharded(
        lambda s, c: jnp.asarray(xb[s:s + c]), 8192, cfg,
        jnp.asarray(ds.xt[:4000]), 2, **kw)
    assert sh.opq_R is not None and tuple(sh.opq_R.shape) == (32, 32)
    assert jsh.opq_R.shape == sh.opq_R.shape
    mesh = port_mesh((("lists", 2),))
    d, i = sharded_search(place_sharded(sh, mesh), tq(ds.xq[:4]), mesh=mesh,
                          nprobe=4, k=5, windows=16, seg=256, group=2,
                          use_approx=False, backend="seg")
    assert bool(torch.isfinite(d).all()) and bool((i >= 0).all())


def test_shard_index_many_empty_lists():
    ds = synthetic_dataset(nb=40_000, nq=4, nt=20_000, d=16, seed=11,
                           n_clusters=512)
    from chamjax.index.factory import populate, train_quantizers
    cfg = IndexConfig(dim=16, nlist=512, m=4, list_pad=64)
    tq_ = train_quantizers(ds.xt, cfg, kmeans_iters=6, pq_iters=4)
    idx = populate(ds.xb[:200], tq_)
    assert int((idx.list_len == 0).sum()) > 256
    sh = shard_index(carry(idx), 4)
    jsh = j_shard_index(idx, 4)
    for f in ("codes_t", "ids", "list_start", "list_len"):
        np.testing.assert_array_equal(stacked(getattr(sh, f)),
                                      np.asarray(getattr(jsh, f)), f)
    lens = stacked(sh.list_len)
    np.testing.assert_array_equal(lens.sum(axis=0), idx.list_len)
    all_ids = stacked(sh.ids).ravel()
    np.testing.assert_array_equal(np.sort(all_ids[all_ids >= 0]),
                                  np.arange(idx.ntotal))
    # the empty lists spread over the shards: each holds fewer than all
    owner_has_empty = ((lens == 0) & (stacked(sh.list_start) >= 0)).sum(1)
    assert int(owner_has_empty.max()) < 512


@pytest.fixture(scope="module")
def concentrated():
    """Few large lists (~550-2350 rows): probes concentrate on the lists
    one shard owns, and at seg 512 each list spans 2-5 segments."""
    ds = synthetic_dataset(nb=24_000, nq=16, nt=6000, d=16, seed=13,
                           n_clusters=3)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=16, nlist=16, m=4, list_pad=64),
                      xt=ds.xt, kmeans_iters=4, pq_iters=4)
    return ds, idx, carry(idx)


def test_sharded_seg_probe_concentration_matches_single(concentrated):
    """All probes land on multi-segment lists one shard owns: the full
    global window budget on every shard covers them."""
    ds, idx, t_idx = concentrated
    seg = auto_seg(idx.list_len)
    W = auto_windows(idx.list_len, seg, 4)
    kw = dict(nprobe=4, k=10, windows=W, seg=seg, group=2, use_approx=False,
              backend="seg")
    mesh = port_mesh((("lists", 4),))
    got = sharded_search(place_sharded(shard_index(t_idx, 4), mesh),
                         tq(ds.xq), mesh=mesh, **kw)
    jm = jax_mesh((("lists", 4),))
    held(got, j_sharded_search(j_place(j_shard_index(idx, 4), jm),
                               jnp.asarray(ds.xq), mesh=jm, interpret=True,
                               **kw))
    held(got, single(t_idx, nprobe=4, k=10, backend="seg", seg_group=2,
                     lut_bf16=False).search(ds.xq))


WS_SEG, WS_NPROBE, WS_GROUP = 512, 4, 2


def shard_demand(t_idx, sh, xq, nprobe, seg):
    """Each query's largest window demand over the shards: the segments of
    its probed lists that one shard owns."""
    from chamjax_torch.ops.coarse import select_probes
    lists, _ = select_probes(tq(xq), tq(np.array(t_idx.centroids)), nprobe)
    segs = -(-stacked(sh.list_len) // seg)                  # (S, nlist)
    return segs[:, lists.numpy()].sum(axis=2).max(axis=0)   # (b,)


def _ws_search(t_idx, idx, xq, route, axes, **kw):
    """The port's and the JAX package's search over ``axes`` on ``route``
    ("tiled" or "flat"), both with ``kw``."""
    shard_kw = dict(tile_seg=WS_SEG) if route == "tiled" else {}
    kw = dict(nprobe=WS_NPROBE, k=10, windows=auto_windows(
        t_idx.list_len, WS_SEG, WS_NPROBE), seg=WS_SEG, group=WS_GROUP,
        use_approx=False, backend="seg", **kw)
    mesh, jm = port_mesh(axes), jax_mesh(axes)
    S = mesh.shape["lists"]
    sh = place_sharded(shard_index(t_idx, S, **shard_kw), mesh)
    jsh = j_place(j_shard_index(idx, S, **shard_kw), jm)
    if "data" in mesh.shape:
        q = jax.device_put(jnp.asarray(xq), NamedSharding(jm, P("data")))
        return (sharded_search_2d(sh, tq(xq), mesh=mesh, **kw),
                j_search_2d(jsh, q, mesh=jm, interpret=True, **kw), sh)
    return (sharded_search(sh, tq(xq), mesh=mesh, **kw),
            j_sharded_search(jsh, jnp.asarray(xq), mesh=jm, interpret=True,
                             **kw), sh)


WS_LAYOUTS = [("tiled", (("lists", 4),)), ("flat", (("lists", 4),)),
              ("tiled", (("data", 2), ("lists", 2))),
              ("flat", (("data", 2), ("lists", 2)))]


@pytest.mark.parametrize("route,axes", WS_LAYOUTS,
                         ids=["tiled_1d", "flat_1d", "tiled_2d", "flat_2d"])
def test_windows_shard_truncates_as_jax(concentrated, route, axes):
    """A per-shard window budget below some queries' demand: both seg
    routes (the tiled scan and the flat multi-window scan), 1-D and 2-D,
    drop the same windows as the JAX package's search (results up to
    ties), and the truncation changes the answer."""
    ds, idx, t_idx = concentrated
    budget = 2 * WS_GROUP
    got, want, sh = _ws_search(t_idx, idx, ds.xq, route, axes,
                               windows_shard=budget)
    demand = shard_demand(t_idx, sh, ds.xq, WS_NPROBE, WS_SEG)
    assert (demand > budget).sum() >= 4, demand
    held(got, want)
    full = _ws_search(t_idx, idx, ds.xq, route, axes)[0]
    assert not np.array_equal(n(got[1]), n(full[1]))


@pytest.mark.parametrize("route", ["tiled", "flat"])
def test_windows_shard_default_and_covering_budget_are_full(concentrated,
                                                            route):
    """The default (``windows_shard=0``) is the full budget, today's
    result and the JAX package's; a budget that covers every query's
    largest shard demand gives the full budget's result bit for bit."""
    ds, idx, t_idx = concentrated
    axes = (("lists", 4),)
    got, want, sh = _ws_search(t_idx, idx, ds.xq, route, axes)
    held(got, want)
    cover = int(shard_demand(t_idx, sh, ds.xq, WS_NPROBE, WS_SEG).max())
    assert cover < max(WS_GROUP, auto_windows(t_idx.list_len, WS_SEG,
                                              WS_NPROBE), WS_NPROBE)
    tight = _ws_search(t_idx, idx, ds.xq, route, axes,
                       windows_shard=cover)[0]
    for a, b in zip(tight, got):
        np.testing.assert_array_equal(n(a), n(b))


# ---------------------------------------------------------------------------
# beyond the reference tests
# ---------------------------------------------------------------------------


def test_sharded_pallas_matches_single_device(setup):
    """The padded-window route per shard (``adc_scan_distances``)."""
    ds, idx, t_idx = setup
    kw = dict(nprobe=8, k=10, scan_len=1024, use_approx=False,
              backend="pallas")
    mesh = port_mesh((("lists", 4),))
    got = sharded_search(place_sharded(shard_index(t_idx, 4), mesh),
                         tq(ds.xq[:8]), mesh=mesh, **kw)
    jm = jax_mesh((("lists", 4),))
    held(got, j_sharded_search(j_place(j_shard_index(idx, 4), jm),
                               jnp.asarray(ds.xq[:8]), mesh=jm,
                               interpret=True, **kw))
    held(got, single(t_idx, nprobe=8, k=10, backend="xla").search(ds.xq[:8]))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_tiled_only_refuses_flat_backends(setup, backend):
    ds, idx, t_idx = setup
    kw = dict(nprobe=4, k=5, scan_len=1024, backend=backend)
    mesh = port_mesh((("lists", 2),))
    sh = place_sharded(shard_index(t_idx, 2, tile_seg=256), mesh)
    with pytest.raises(ValueError, match="tiled-only"):
        sharded_search(sh, tq(ds.xq[:4]), mesh=mesh, **kw)
    jm = jax_mesh((("lists", 2),))
    with pytest.raises(ValueError, match="tiled-only"):
        j_sharded_search(j_place(j_shard_index(idx, 2, tile_seg=256), jm),
                         jnp.asarray(ds.xq[:4]), mesh=jm, **kw)


def test_sharded_routes_go_through_the_searchers_dispatch(setup,
                                                         monkeypatch):
    """Each shard's scan is one ``searcher._dispatch_scan`` call, so the
    mesh picks routes as the single-device searcher does: at group 1 the
    flat route is ``scan_lists_seg`` (the JAX package's mesh calls the
    multi-window scan there; both are exact, so the answers agree)."""
    import chamjax_torch.searcher as tsearcher
    ds, idx, t_idx = setup
    calls = {"dispatch": 0, "seg": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(tss, "_dispatch_scan",
                        spy("dispatch", tsearcher._dispatch_scan))
    monkeypatch.setattr(tsearcher, "scan_lists_seg",
                        spy("seg", tsearcher.scan_lists_seg))
    kw = dict(SEG_KW, group=1)
    mesh = port_mesh((("data", 2), ("lists", 4)))
    sh = place_sharded(shard_index(t_idx, 4), mesh)
    got = sharded_search_2d(sh, tq(ds.xq[:8]), mesh=mesh, **kw)
    assert calls == {"dispatch": 8, "seg": 8}
    jm = jax_mesh((("data", 2), ("lists", 4)))
    q = jax.device_put(jnp.asarray(ds.xq[:8]), NamedSharding(jm, P("data")))
    held(got, j_search_2d(j_place(j_shard_index(idx, 4), jm), q, mesh=jm,
                          interpret=True, **kw))
    held(got, single(t_idx, nprobe=8, k=10, backend="seg").search(ds.xq[:8]))


def test_tiled_refuses_a_seg_other_than_its_tile(setup):
    ds, _, t_idx = setup
    mesh = port_mesh((("lists", 2),))
    sh = place_sharded(shard_index(t_idx, 2, tile_seg=256), mesh)
    with pytest.raises(ValueError, match="tiled at 256"):
        sharded_search(sh, tq(ds.xq[:4]), mesh=mesh, **dict(SEG_KW, seg=512))


def test_search_needs_a_placed_index_and_a_whole_split(setup):
    ds, _, t_idx = setup
    mesh = port_mesh((("data", 2), ("lists", 2)))
    sh = shard_index(t_idx, 2)
    with pytest.raises(ValueError, match="place_sharded"):
        sharded_search(sh, tq(ds.xq[:4]), mesh=mesh, **SEG_KW)
    sh = place_sharded(sh, mesh)
    with pytest.raises(ValueError, match="does not split"):
        sharded_search_2d(sh, tq(ds.xq[:3]), mesh=mesh, **SEG_KW)
    with pytest.raises(ValueError, match="3 shards"):
        place_sharded(shard_index(t_idx, 3), mesh)
    assert not tss.captures(mesh)       # CPU positions run eagerly


@pytest.mark.parametrize("tile_seg,n_shards", [(0, 3), (256, 2)])
def test_sharded_pack_bit_equal_to_jax(monkeypatch, tile_seg, n_shards):
    """Given the same assignment and codes (each package's
    ``_train_encode_stream`` stood in for), the sharded pack's layout and
    ``info`` equal the JAX package's bit for bit; tiled, a shard's codes
    hold ``cap`` rows while its ids keep the ``MAX_SEG`` tail."""
    rng = np.random.default_rng(21)
    nrows, nlist, m, d = 5000, 24, 8, 16
    a = rng.integers(0, nlist, nrows)
    a[a == 5] = 6                                       # an empty list
    a[:900] = 3                                         # a long one
    codes = rng.integers(0, 256, (nrows, m)).astype(np.uint8)
    cent = rng.standard_normal((nlist, d)).astype(np.float32)
    cb = rng.standard_normal((m, 256, d // m)).astype(np.float32)

    def j_stream(*args, **kw):
        return (jnp.asarray(cent), jnp.asarray(cb), None,
                jnp.asarray(a.astype(np.int32)), jnp.asarray(codes), {})

    def t_stream(*args, **kw):
        return (torch.from_numpy(cent), torch.from_numpy(cb), None,
                torch.from_numpy(a.astype(np.int32)),
                torch.from_numpy(codes), {})
    monkeypatch.setattr(jdb, "_train_encode_stream", j_stream)
    monkeypatch.setattr(tdb, "_train_encode_stream", t_stream)
    cfg = IndexConfig(dim=d, nlist=nlist, m=m, list_pad=64)
    kw = dict(tile_seg=tile_seg, tail_pad=1000)
    jsh, jinfo = jdb.build_ivfpq_device_sharded(None, nrows, cfg, None,
                                                n_shards, **kw)
    sh, info = build_ivfpq_device_sharded(None, nrows,
                                          TIndexConfig(**vars(cfg)), None,
                                          n_shards, device="cpu", **kw)
    for f in ("codes_t", "ids", "list_start", "list_len", "codes_tiled"):
        if getattr(jsh, f) is None:
            assert getattr(sh, f) is None, f
        else:
            np.testing.assert_array_equal(stacked(getattr(sh, f)),
                                          np.asarray(getattr(jsh, f)), f)
    for key in jinfo:
        np.testing.assert_array_equal(np.asarray(info[key]),
                                      np.asarray(jinfo[key]), key)
    cap = info["n_pad"]
    assert all(len(t) == cap + MAX_SEG for t in sh.ids)
    if tile_seg:
        assert all(t.shape[0] * tile_seg == cap for t in sh.codes_tiled)
        assert cap % tile_seg == 0
    else:
        assert all(t.shape[1] == cap + MAX_SEG for t in sh.codes_t)


def test_sharded_streamed_build_matches_unsharded():
    """The counterpart of ``test_device_build.py::
    test_sharded_streamed_build_matches_unsharded``: the sharded streamed
    build reaches the recall of the single-device streamed build, with
    shards row-balanced and partitioning every list; the port's sharded
    recall within 0.05 of the JAX package's (their k-means seeds differ)."""
    ds = synthetic_dataset(nb=20_000, nq=32, nt=6000, d=32, seed=3,
                           n_clusters=64)
    cfg = IndexConfig(dim=32, nlist=64, m=8, list_pad=64)
    common = dict(kmeans_iters=6, pq_iters=6, chunk=8192, block=256)
    S = 4
    sh, info = build_ivfpq_device_sharded(
        lambda s, c: tq(ds.xb[s:s + c]), ds.nb, TIndexConfig(**vars(cfg)),
        tq(ds.xt), S, device="cpu", **common)
    assert len(sh.codes_t) == S
    assert int(info["list_len"].sum()) == ds.nb
    np.testing.assert_array_equal(stacked(sh.list_len).sum(axis=0),
                                  info["list_len"])
    rows = np.asarray(info["shard_rows"], np.float64)
    assert (rows > 0).all() and rows.max() <= 2.0 * rows.mean()
    kw = dict(nprobe=16, k=10, windows=40, seg=256, group=2,
              use_approx=False, backend="seg")
    mesh = port_mesh((("lists", S),))
    _, i_s = sharded_search(place_sharded(sh, mesh), tq(ds.xq), mesh=mesh,
                            **kw)
    gt, _ = compute_ground_truth(ds.xb, ds.xq, k=10)
    r_sh = recall_at_k(n(i_s), gt, 10)

    from chamjax_torch.index import build_ivfpq_device
    from chamjax_torch.searcher import ivfpq_search
    dev, dinfo = build_ivfpq_device(
        lambda s, c: tq(ds.xb[s:s + c]), ds.nb, TIndexConfig(**vars(cfg)),
        tq(ds.xt), device="cpu", **common)
    seg = auto_seg(dinfo["list_len"])
    _, i_u = ivfpq_search(dev, tq(ds.xq), nprobe=16, k=10,
                          windows=auto_windows(dinfo["list_len"], seg, 16),
                          seg=seg, group=2, use_approx=False, backend="seg")
    r_un = recall_at_k(n(i_u), gt, 10)
    assert r_sh >= r_un - 0.02, (r_sh, r_un)

    jm = jax_mesh((("lists", S),))
    jsh, _ = jdb.build_ivfpq_device_sharded(
        lambda s, c: jnp.asarray(ds.xb[s:s + c]), ds.nb, cfg,
        jnp.asarray(ds.xt), S, **common)
    _, i_j = j_sharded_search(j_place(jsh, jm), jnp.asarray(ds.xq), mesh=jm,
                              interpret=True, **kw)
    assert abs(r_sh - recall_at_k(np.asarray(i_j), gt, 10)) <= 0.05
