"""The streamed device build (``chamjax_torch/index/device_build.py``) and
``searcher.retile_device_ivf`` against the JAX package's, on the CPU.

Each test makes its inputs with numpy from a seed and runs both packages
on them.  On the CPU both packages' stage-1 shortlist is fp32, so cells are
compared for equality; distances that go through a different GEMM are held
to rtol 1e-5.  Blocks and pack chunks are forced small so that several of
them and a ragged tail run.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chamjax.config import IndexConfig
from chamjax.data import synthetic_dataset
from chamjax.data.ground_truth import compute_ground_truth
from chamjax.eval import recall_at_k
from chamjax.index import device_build as jdb
from chamjax.searcher import ivfpq_search as j_search
from chamjax.searcher import retile_device_ivf as j_retile

from chamjax_torch import searcher as tsearcher
from chamjax_torch.config import IndexConfig as TIndexConfig
from chamjax_torch.eval import tie_mismatches
from chamjax_torch.index import device_build as tdb
from chamjax_torch.utils import graphs

BLOCK = 256


def t(a):
    return torch.from_numpy(np.array(a))


def n(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def tcfg(cfg: IndexConfig) -> TIndexConfig:
    return TIndexConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(nb=20_000, nq=32, nt=6000, d=32, seed=3,
                             n_clusters=64)


def j_draw(xb):
    return lambda s, c: jnp.asarray(xb[s:s + c], jnp.float32)


def t_draw(xb):
    return lambda s, c: torch.from_numpy(np.array(xb[s:s + c]))


def clustered(rng, n_rows, k, d, spread=0.3):
    centers = rng.standard_normal((k, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, k, n_rows)]
            + rng.standard_normal((n_rows, d)).astype(np.float32) * spread)


def test_assign_and_topc_blocked_match_jax():
    """Both blocked assignments, with a 1000 % 256 tail: cells equal,
    exact d² within rtol 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    cent = rng.standard_normal((64, 16)).astype(np.float32)
    a_j = n(jdb._assign_blocked(jnp.asarray(x), jnp.asarray(cent),
                                block=BLOCK, cand=8))
    a_t = n(tdb._assign_blocked(t(x), t(cent), block=BLOCK, cand=8))
    np.testing.assert_array_equal(a_t, a_j)
    exact = np.argmin(((x[:, None] - cent[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(a_t, exact)
    c_j, d_j = jdb._topc_blocked(jnp.asarray(x), jnp.asarray(cent),
                                 block=BLOCK, c=4)
    c_t, d_t = tdb._topc_blocked(t(x), t(cent), block=BLOCK, c=4)
    np.testing.assert_array_equal(n(c_t), n(c_j))
    assert c_t.dtype == torch.int32
    np.testing.assert_allclose(n(d_t), n(d_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("empty", [False, True])
def test_lloyd_iter_matches_jax(empty):
    """One Lloyd iteration from the same centroids and key: centroids
    within rtol 1e-5 and counts equal; with a cell no row reaches, the
    same cell is reseeded from the same donor with the same jitter
    (``normal(key)`` in both packages)."""
    import jax
    rng = np.random.default_rng(2)
    x = clustered(rng, 2 * BLOCK + 100, 8, 16)
    cent = x[rng.choice(x.shape[0], 12, replace=False)].copy()
    if empty:
        cent[5] = 1e3                  # nearest to no row
    c_j, n_j = jdb._lloyd_iter(jnp.asarray(x), jnp.asarray(cent),
                               jax.random.PRNGKey(0), block=BLOCK, cand=8)
    c_t, n_t = tdb._lloyd_iter(t(x), t(cent), 0, block=BLOCK, cand=8)
    c_j, c_t = n(c_j), n(c_t)
    np.testing.assert_array_equal(n(n_t), n(n_j))
    full = n(n_j) > 0
    assert (~full).sum() == int(empty)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split", [1.0, 0.0])
def test_update_from_assignment_matches_jax(split):
    """The balanced-Lloyd update on the same (x, a, nat, cent, cap, split,
    deadband), with tied natural counts (27 cells of 9 rows, 4 of 1): the
    stable sorts pick the same victims, donors and member points."""
    import jax
    rng = np.random.default_rng(3)
    k, d, cap = 32, 8, 10
    sizes = [40] + [9] * 27 + [1] * 4
    cent = rng.standard_normal((k, d)).astype(np.float32) * 10
    xs, nat = [], []
    for j, s in enumerate(sizes):
        xs.append(cent[j] + rng.standard_normal((s, d)).astype(np.float32))
        nat += [j] * s
    x = np.concatenate(xs)
    nat = np.array(nat, np.int32)
    perm = rng.permutation(x.shape[0])         # members not in cell order
    x, nat = x[perm], nat[perm]
    a = nat.copy()
    a[:5] = (a[:5] + 1) % k                    # a constrained assignment
    args_j = (jnp.asarray(x), jnp.asarray(a), jnp.asarray(nat),
              jnp.asarray(cent), jax.random.PRNGKey(0), jnp.float32(cap),
              jnp.float32(split), jnp.float32(1.75))
    c_j, n_j = jdb._update_from_assignment(*args_j)
    c_t, n_t = tdb._update_from_assignment(t(x), t(a), t(nat), t(cent), None,
                                           cap, split, 1.75)
    np.testing.assert_array_equal(n(n_t), n(n_j))
    np.testing.assert_allclose(n(c_t), n(c_j), rtol=1e-5, atol=1e-5)


def _rebalance_case(kind, rng):
    n_rows, k, C = 4000, 32, 5
    cells = np.stack([rng.permutation(k)[:C]
                      for _ in range(n_rows)]).astype(np.int32)
    d2 = np.sort(rng.random((n_rows, C)).astype(np.float32), axis=1)
    if kind == "scalar":
        cap = int(np.ceil(n_rows / k * 1.1))
    elif kind == "tight":                # stragglers: every candidate full
        cap = int(np.floor(n_rows / k * 0.9))
    else:                                # per-cell, one cell closed
        cap = rng.integers(130, 200, k).astype(np.int32)
        cap[3] = 0
    return cells, d2, cap, k


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("kind", ["scalar", "tight", "per_cell"])
def test_rebalance_matches_jax(kind, hard):
    """The eviction rounds on JAX's own (cand, cd, cap): the assignment
    bit-equal, the same straggler count, and the cap warning (hard mode
    with stragglers) from both or neither."""
    import warnings
    rng = np.random.default_rng({"scalar": 4, "tight": 5,
                                 "per_cell": 6}[kind])
    cells, d2, cap, k = _rebalance_case(kind, rng)
    cap_j = cap if np.ndim(cap) == 0 else jnp.asarray(cap)
    cap_t = cap if np.ndim(cap) == 0 else t(cap)
    with warnings.catch_warnings(record=True) as w_j:
        warnings.simplefilter("always")
        a_j, s_j = jdb.rebalance_assignment_device(
            jnp.asarray(cells), jnp.asarray(d2), cap_j, nlist=k, hard=hard,
            return_stats=True)
    with warnings.catch_warnings(record=True) as w_t:
        warnings.simplefilter("always")
        a_t, s_t = tdb.rebalance_assignment_device(
            t(cells), t(d2), cap_t, nlist=k, hard=hard, return_stats=True)
    np.testing.assert_array_equal(n(a_t), n(a_j))
    assert a_t.dtype == torch.int32
    assert s_t == s_j
    if kind == "tight":
        assert s_t > 0
    if kind == "scalar":
        assert s_t == 0
        assert np.bincount(n(a_t), minlength=k).max() <= cap
    if kind == "per_cell":
        counts = np.bincount(n(a_t), minlength=k)
        assert s_t == 0 and counts[3] == 0     # the closed cell
        assert (counts <= cap).all()
    warned = [sum("exhausted" in str(x.message) for x in w)
              for w in (w_j, w_t)]
    assert warned[1] == warned[0] == int(hard and s_t > 0)


def test_pack_layout_matches_jax():
    rng = np.random.default_rng(7)
    n_rows, nlist, list_pad = 3000, 16, 32
    assignment = rng.integers(0, nlist, n_rows).astype(np.int32)
    assignment[assignment == 5] = 6                   # an empty list
    cap = n_rows + nlist * list_pad + 64
    out_j = jdb._pack_layout(jnp.asarray(assignment), nlist=nlist,
                             list_pad=list_pad, cap=cap)
    out_t = tdb._pack_layout(t(assignment), nlist=nlist, list_pad=list_pad,
                             cap=cap)
    for a_t, a_j in zip(out_t, out_j):
        assert a_t.dtype == torch.int32
        np.testing.assert_array_equal(n(a_t), n(a_j))


@pytest.fixture
def pack_case():
    rng = np.random.default_rng(8)
    n_rows, m, cap = 5000, 4, 6208                    # 97 tiles of 64
    codes = rng.integers(0, 256, (n_rows, m)).astype(np.uint8)
    gids = rng.integers(-1, n_rows, cap).astype(np.int32)
    gids[cap - 7:] = -1
    return codes, gids


def test_pack_codes_t_matches_jax(pack_case, monkeypatch):
    """One-shot and chunked (7 chunks of 1024 columns, the last ragged):
    both bit-equal to JAX's one-shot pack."""
    codes, gids = pack_case
    want = n(jdb._pack_codes_t_oneshot(jnp.asarray(codes),
                                       jnp.asarray(gids)))
    np.testing.assert_array_equal(n(tdb._pack_codes_t(t(codes), t(gids))),
                                  want)
    monkeypatch.setattr(tdb, "_PACK_CHUNK_BYTES", 0)
    monkeypatch.setattr(tdb, "_PACK_CHUNK_COLS", 1 << 10)
    calls = []
    real = tdb._pack_codes_t_chunk
    monkeypatch.setattr(tdb, "_pack_codes_t_chunk",
                        lambda *a: calls.append(a[2].shape[0]) or real(*a))
    np.testing.assert_array_equal(n(tdb._pack_codes_t(t(codes), t(gids))),
                                  want)
    assert calls == [1024] * 6 + [6208 - 6 * 1024]


def test_pack_codes_tiled_matches_jax(pack_case, monkeypatch):
    """The direct-to-tiled pack in 20 steps of 5 tiles (the last ragged)
    is bit-equal to JAX's."""
    codes, gids = pack_case
    seg = 64
    want = n(jdb._pack_codes_tiled(jnp.asarray(codes), jnp.asarray(gids),
                                   seg))
    monkeypatch.setattr(tdb, "_PACK_TILED_BYTES", 4 * seg * 5)
    calls = []
    real = tdb._pack_codes_tiled_chunk
    monkeypatch.setattr(tdb, "_pack_codes_tiled_chunk",
                        lambda *a: calls.append(a[2].shape[0]) or real(*a))
    got = n(tdb._pack_codes_tiled(t(codes), t(gids), seg))
    np.testing.assert_array_equal(got, want)
    assert len(calls) == 20 and calls[-1] == 6208 - 19 * 320


@pytest.mark.parametrize("by_residual", [True, False])
def test_encode_chunks_match_jax(by_residual):
    rng = np.random.default_rng(9)
    x = clustered(rng, 1024, 16, 32)
    cent = rng.standard_normal((16, 32)).astype(np.float32) * 3
    books = rng.standard_normal((8, 256, 4)).astype(np.float32)
    a_j, c_j = jdb._assign_encode_chunk(jnp.asarray(x), jnp.asarray(cent),
                                        jnp.asarray(books), block=BLOCK,
                                        cand=8, by_residual=by_residual)
    a_t, c_t = tdb._assign_encode_chunk(t(x), t(cent), t(books),
                                        block=BLOCK, cand=8,
                                        by_residual=by_residual)
    np.testing.assert_array_equal(n(a_t), n(a_j))
    np.testing.assert_array_equal(n(c_t), n(c_j))
    assert c_t.dtype == torch.uint8
    c2_j = jdb._encode_assigned_chunk(jnp.asarray(x), a_j, jnp.asarray(cent),
                                      jnp.asarray(books), block=BLOCK,
                                      by_residual=by_residual)
    c2_t = tdb._encode_assigned_chunk(t(x), a_t, t(cent), t(books),
                                      block=BLOCK, by_residual=by_residual)
    np.testing.assert_array_equal(n(c2_t), n(c2_j))


@pytest.fixture(scope="module")
def quantizers(ds):
    """JAX-trained quantizers (IVF64, PQ8) for the preset builds."""
    cfg = IndexConfig(dim=32, nlist=64, m=8, list_pad=64)
    dev, _ = jdb.build_ivfpq_device(j_draw(ds.xb), ds.nb, cfg,
                                    jnp.asarray(ds.xt), kmeans_iters=4,
                                    pq_iters=4, chunk=8192, block=BLOCK)
    return n(dev.centroids), n(dev.codebooks)


PRESET_CASES = {
    "unbalanced": (dict(), dict()),
    "balanced_parts2": (dict(balanced=True, balance_hard=True,
                             balance_factor=1.6, balance_parts=2), dict()),
    "tile_seg": (dict(), dict(tile_seg=128)),
    "tile_only": (dict(balanced=True, balance_hard=True,
                       balance_factor=1.6), dict(tile_seg=128,
                                                 tile_only=True)),
}


@pytest.mark.parametrize("case", sorted(PRESET_CASES))
def test_build_with_preset_quantizers_bit_equal(ds, quantizers, case):
    """``build_ivfpq_device(quantizers=JAX's)`` over a draw serving the same
    numpy rows to both packages (chunks of 8192 rows, a 20000 % 256 tail):
    a bit-equal DeviceIVF."""
    cfg_kw, kw = PRESET_CASES[case]
    cfg = IndexConfig(dim=32, nlist=64, m=8, list_pad=64, **cfg_kw)
    cent, books = quantizers
    common = dict(chunk=8192, block=BLOCK, **kw)
    d_j, i_j = jdb.build_ivfpq_device(
        j_draw(ds.xb), ds.nb, cfg, None,
        quantizers=(jnp.asarray(cent), jnp.asarray(books), None), **common)
    d_t, i_t = tdb.build_ivfpq_device(
        t_draw(ds.xb), ds.nb, tcfg(cfg), None,
        quantizers=(cent, books, None), device="cpu", **common)
    for name in ("codes_t", "codes_tiled", "ids", "list_start", "list_len"):
        a_j, a_t = getattr(d_j, name), getattr(d_t, name)
        assert (a_j is None) == (a_t is None), name
        if a_j is not None:
            np.testing.assert_array_equal(n(a_t), n(a_j), err_msg=name)
            assert a_t.is_contiguous(), name
    assert set(i_t) == set(i_j)
    for key in ("list_len", "list_start", "ntotal", "n_pad", "stragglers",
                "cap"):
        if key in i_j:
            np.testing.assert_array_equal(i_t[key], i_j[key])


def test_trained_build_recall_matches_jax():
    """OPQ + hard-balanced builds trained by each package from seed 0 on
    the same data (both draw the seed's threefry streams): coarse
    centroids within atol 0.02 (the fp32 k-means statistics are summed in
    other orders, which moves a centroid by up to 0.011 here, on data of
    scale ~3), list lengths within 1% of the cap (equal here), and R@10
    (256 queries, nprobe 16) within 0.005 (equal here)."""
    ds = synthetic_dataset(nb=20_000, nq=256, nt=6000, d=32, seed=3,
                           n_clusters=64)
    gt, _ = compute_ground_truth(ds.xb, ds.xq, k=10)
    cfg = IndexConfig(dim=32, nlist=64, m=8, list_pad=64, opq=True,
                      balanced=True, balance_hard=True, balance_factor=1.6)
    cap = int(np.ceil(ds.nb / cfg.nlist * cfg.balance_factor))
    kw = dict(kmeans_iters=6, pq_iters=6, chunk=8192, block=BLOCK,
              tile_seg=128, seed=0)
    d_j, i_j = jdb.build_ivfpq_device(j_draw(ds.xb), ds.nb, cfg,
                                      jnp.asarray(ds.xt), **kw)
    d_t, i_t = tdb.build_ivfpq_device(t_draw(ds.xb), ds.nb, tcfg(cfg),
                                      t(ds.xt), device="cpu", **kw)
    assert d_t.opq_R is not None
    assert int(i_t["list_len"].max()) <= cap + i_t["stragglers"]
    assert int(i_t["list_len"].sum()) == ds.nb
    np.testing.assert_allclose(n(d_t.centroids), n(d_j.centroids),
                               rtol=0, atol=0.02)
    assert np.abs(n(i_t["list_len"]).astype(int)
                  - n(i_j["list_len"]).astype(int)).max() <= 0.01 * cap
    # each searched by its own plain (xla) scan over whole lists
    s_kw = dict(nprobe=16, k=10, backend="xla", use_approx=False,
                scan_len=-(-int(max(i_j["list_len"].max(),
                                    i_t["list_len"].max())) // 128) * 128)
    _, ids_j = j_search(d_j, jnp.asarray(ds.xq), **s_kw)
    _, ids_t = tsearcher.ivfpq_search(d_t, t(ds.xq), **s_kw)
    r_j, r_t = recall_at_k(n(ids_j), gt, 10), recall_at_k(n(ids_t), gt, 10)
    assert r_t > 0.9, r_t
    assert abs(r_t - r_j) <= 0.005, (r_t, r_j)


def test_gt_streamed_matches_jax(ds):
    """Streamed exact top-k (chunks of 4096, blocks of 1024, a 20000 %
    1024 tail): ids equal up to the order of ties, distances rtol 1e-5,
    and the exact host ground truth's ids."""
    kw = dict(k=10, chunk=4096, block=1024)
    i_j, d_j = jdb.compute_ground_truth_streamed(j_draw(ds.xb), ds.nb,
                                                 jnp.asarray(ds.xq), **kw)
    i_t, d_t = tdb.compute_ground_truth_streamed(t_draw(ds.xb), ds.nb, ds.xq,
                                                 device="cpu", **kw)
    assert i_t.dtype == np.int64 and d_t.dtype == np.float32
    # d² = ||x||² - 2 q·x + ||q||² cancels: rtol 1e-5 is taken of the
    # terms' scale, ||q||² + the largest ||x||² (two fp32 GEMMs summed in
    # other orders differ by ~1e-5 of it, not of d²)
    scale = (np.sum(ds.xq ** 2, axis=1, keepdims=True)
             + np.max(np.sum(ds.xb ** 2, axis=1)))
    assert np.all(np.abs(d_t - d_j) <= 1e-5 * scale)
    assert not tie_mismatches(d_t, i_t, d_j, i_j, rtol=0,
                              atol=float(1e-5 * scale.max()))
    gt, _ = compute_ground_truth(ds.xb, ds.xq, k=10)
    np.testing.assert_array_equal(i_t, gt)


def test_retile_matches_jax_and_drops_graphs(ds, quantizers):
    """``retile_device_ivf`` of one flat index in both packages: a
    bit-equal layout; the port's result owns a fresh ``graphs``."""
    cent, books = quantizers
    cfg = IndexConfig(dim=32, nlist=64, m=8, list_pad=64)
    d_j, _ = jdb.build_ivfpq_device(
        j_draw(ds.xb), ds.nb, cfg, None, chunk=8192, block=BLOCK,
        quantizers=(jnp.asarray(cent), jnp.asarray(books), None))
    flat = tsearcher.DeviceIVF(
        centroids=t(d_j.centroids), codebooks=t(d_j.codebooks),
        codes_t=t(d_j.codes_t), ids=t(d_j.ids),
        list_start=t(d_j.list_start), list_len=t(d_j.list_len))
    flat.graphs._graphs["stand-in"] = object()     # a capture of the old
    for seg in (128, 256):
        r_j = j_retile(d_j, seg)
        r_t = tsearcher.retile_device_ivf(flat, seg)
        for name in ("codes_t", "codes_tiled", "ids", "list_start",
                     "list_len", "centroids"):
            np.testing.assert_array_equal(n(getattr(r_t, name)),
                                          n(getattr(r_j, name)),
                                          err_msg=f"{name} seg {seg}")
        assert r_t.codes_tiled.is_contiguous()
        assert isinstance(r_t.graphs, graphs.Graphs)
        assert r_t.graphs is not flat.graphs and len(r_t.graphs) == 0
    assert len(flat.graphs) == 1


def test_int32_id_space_raises():
    cfg = TIndexConfig(dim=8, nlist=1024, m=2, list_pad=128)

    def draw(s, c):
        raise AssertionError("no row may be drawn")
    with pytest.raises(ValueError, match="int32"):
        tdb.build_ivfpq_device(draw, 2 ** 31 - 1024 * 64, cfg, None,
                               device="cpu")


def test_lloyd_device_recovers_clusters_with_a_tail():
    """Plain Lloyd over n < block and over a ragged tail finds the 8 true
    centres (the JAX package's own bar)."""
    rng = np.random.default_rng(10)
    centers = rng.standard_normal((8, 16)).astype(np.float32) * 10
    for n_rows in (BLOCK - 56, 2 * BLOCK + 100):
        x = (centers[rng.integers(0, 8, n_rows)]
             + rng.standard_normal((n_rows, 16)).astype(np.float32) * 0.1)
        cent = n(tdb.lloyd_device(t(x), 8, iters=8, block=BLOCK))
        d = ((centers[:, None] - cent[None]) ** 2).sum(-1).min(1)
        assert np.all(d < 1.0), (n_rows, d)


def test_lloyd_balanced_split_reseed_converges():
    """Balanced Lloyd on a smooth skewed density (half the mass in a tight
    blob): max cell within 1.15× cap after the follow-up hard rebalance."""
    rng = np.random.default_rng(11)
    n_rows, k, d = 16384, 64, 16
    x = t(np.concatenate([
        rng.standard_normal((n_rows // 2, d)).astype(np.float32) * 0.3,
        rng.standard_normal((n_rows // 2, d)).astype(np.float32) * 4.0]))
    cap = int(np.ceil(n_rows / k * 1.3))
    cent = tdb.lloyd_device(x, k, iters=5, seed=0, block=BLOCK,
                            balance_cap=cap, balance_iters=8)
    cells, d2 = tdb._topc_blocked(x, cent, block=BLOCK, c=8)
    a = n(tdb.rebalance_assignment_device(cells, d2, cap, hard=True,
                                          warn=False))
    counts = np.bincount(a, minlength=k)
    assert counts.sum() == n_rows
    assert counts.max() <= int(cap * 1.15), (counts.max(), cap)
