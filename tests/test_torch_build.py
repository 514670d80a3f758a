"""chamjax_torch index build against chamjax on the same numpy corpus: PQ
training/encoding, (balanced) assignment, OPQ, k-means quality, a whole
build_ivfpq, and exact ground truth."""

import importlib

import numpy as np
import pytest

from chamjax.config import IndexConfig
from chamjax.data import synthetic_dataset
from chamjax.data.ground_truth import compute_ground_truth
from chamjax.eval import recall_at_k
from chamjax.index import build_ivfpq
from chamjax.index import pq as jpq
from chamjax.searcher import IVFSearcher
from chamjax.config import SearchConfig

from chamjax_torch.config import IndexConfig as TIndexConfig
from chamjax_torch.config import SearchConfig as TSearchConfig
from chamjax_torch.data import compute_ground_truth as t_ground_truth
from chamjax_torch.index import build_ivfpq as t_build
from chamjax_torch.index import pq as tpq
from chamjax_torch.searcher import IVFSearcher as TIVFSearcher

# the package __init__s export functions named like their modules
jk = importlib.import_module("chamjax.index.kmeans")
tk = importlib.import_module("chamjax_torch.index.kmeans")


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(nb=8000, nq=32, nt=4000, d=32, seed=5,
                             n_clusters=48)


@pytest.fixture(scope="module")
def centroids(ds):
    return jk.kmeans(ds.xt, 32, iters=4, seed=0)


def sq_dist(x, c):
    return ((x[:, None, :] - c[None]) ** 2).sum(-1)


def test_train_pq_matches(ds):
    """Same numpy subsample and initial codewords; the Lloyd steps agree
    unless an fp32 argmax near-tie moves a point (none at this size)."""
    want = jpq.train_pq(ds.xt, 8, iters=4, seed=1)
    got = tpq.train_pq(ds.xt, 8, iters=4, seed=1, device="cpu")
    assert got.shape == (8, 256, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_train_pq_subsamples_like_chamjax(ds):
    want = jpq.train_pq(ds.xt, 4, iters=2, seed=3, max_train=1500)
    got = tpq.train_pq(ds.xt, 4, iters=2, seed=3, max_train=1500,
                       device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_pq_encode_decode_match(ds):
    cb = jpq.train_pq(ds.xt, 8, iters=3, seed=0)
    want = jpq.pq_encode(ds.xb, cb)
    got = tpq.pq_encode(ds.xb, cb, device="cpu", chunk=3000)
    diff = np.argwhere(got != want)
    for r, j in diff:              # allowed only at a distance tie
        x = ds.xb[r, j * 4:(j + 1) * 4]
        dg = ((x - cb[j, got[r, j]]) ** 2).sum()
        dw = ((x - cb[j, want[r, j]]) ** 2).sum()
        assert abs(dg - dw) < 1e-4
    np.testing.assert_array_equal(tpq.pq_decode(got, cb),
                                  jpq.pq_decode(got, cb))


def test_assign_matches(ds, centroids):
    want = jk.assign(ds.xb, centroids)
    got = tk.assign(ds.xb, centroids, chunk=4096, device="cpu")
    d = sq_dist(ds.xb, centroids)
    rows = np.arange(len(got))
    assert np.all((got == want) | (np.abs(d[rows, got] - d[rows, want])
                                   < 1e-3))


@pytest.mark.filterwarnings("ignore:assign_balanced")
@pytest.mark.parametrize("hard,cap", [(True, 300), (True, 260),
                                      (False, 280)])
def test_assign_balanced_matches(ds, centroids, hard, cap):
    want = jk.assign_balanced(ds.xb, centroids, cap=cap, hard=hard)
    with pytest.warns(UserWarning, match="overflowed"):
        got = tk.assign_balanced(ds.xb, centroids, cap=cap, hard=hard,
                                 device="cpu")
    # same confident-first order and greedy loop: equal unless an fp32
    # distance tie reorders two points (none at this size)
    assert np.mean(got == want) >= 0.995
    counts = np.bincount(got, minlength=32)
    if hard:
        assert counts.max() <= cap                 # the cap holds exactly
    assert counts.sum() == len(ds.xb) and got.min() >= 0


def test_assign_balanced_rejects_infeasible_cap(ds, centroids):
    with pytest.raises(ValueError, match="infeasible cap"):
        tk.assign_balanced(ds.xb, centroids, cap=100, hard=True,
                           device="cpu")


def test_kmeans_quality_and_determinism(ds):
    """k-means++ seeding draws the JAX package's threefry streams, so one
    seed gives chamjax's centroids (rtol 1e-5; equal bit for bit here),
    at the same SSE, and repeats itself."""
    got = tk.kmeans(ds.xt, 32, iters=4, seed=0, device="cpu")
    np.testing.assert_array_equal(
        got, tk.kmeans(ds.xt, 32, iters=4, seed=0, device="cpu"))
    assert got.shape == (32, 32) and got.dtype == np.float32
    want = jk.kmeans(ds.xt, 32, iters=4, seed=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    sse_t = sq_dist(ds.xb, got).min(1).sum()
    sse_j = sq_dist(ds.xb, want).min(1).sum()
    assert abs(sse_t - sse_j) <= 1e-5 * sse_j, (sse_t, sse_j)


def test_kmeanspp_picks_equal_chamjax(ds):
    """k-means++ seeding picks the JAX package's rows for a key: the first
    from ``randint``, each next the argmax of log D² plus
    ``gumbel(fold_in(key, i))``."""
    import jax
    import jax.numpy as jnp
    import torch
    from chamjax_torch import random as jr
    for seed in (0, 5):
        want = np.asarray(jk._kmeanspp_init(jnp.asarray(ds.xt), 32,
                                            jax.random.PRNGKey(seed)))
        got = tk._kmeanspp_init(torch.from_numpy(ds.xt), 32,
                                jr.key(seed)).numpy()
        np.testing.assert_array_equal(got, want)


def test_kmeans_more_clusters_than_points():
    x = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    c = tk.kmeans(x, 8, iters=1, seed=0, device="cpu")
    assert c.shape == (8, 4) and np.isfinite(c).all()


def test_train_opq_matches(ds):
    R_j, cb_j = jpq.train_opq(ds.xt, 8, outer_iters=2, pq_iters=3)
    R_t, cb_t = tpq.train_opq(ds.xt, 8, outer_iters=2, pq_iters=3,
                              device="cpu")
    np.testing.assert_allclose(R_t @ R_t.T, np.eye(32), atol=1e-5)
    np.testing.assert_allclose(R_t, R_j, atol=1e-4)
    np.testing.assert_allclose(cb_t, cb_j, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def recall_ds():
    ds = synthetic_dataset(nb=8000, nq=2000, nt=4000, d=32, seed=5,
                           n_clusters=256)
    gt, _ = compute_ground_truth(ds.xb, ds.xq, k=10)
    return ds, gt


@pytest.mark.parametrize("opq", [True, False])
def test_build_ivfpq_recall_close_to_chamjax(recall_ds, opq):
    """Whole builds from the two packages on the same corpus and build
    seed (0): both draw the seed's threefry streams, so the coarse
    centroids and PQ codebooks agree (rtol 1e-5; equal here), the lists
    hold the same numbers of rows, and R@10 is within 0.005 (0 with OPQ,
    0.0005 without).  Both are searched by the exact xla backend."""
    ds, gt = recall_ds
    kw = dict(dim=32, nlist=32, m=8, list_pad=64, opq=opq, balanced=True,
              balance_hard=True, balance_factor=1.6)
    s = dict(nprobe=16, k=10, backend="xla", use_approx_topk=False,
             coarse_cand=0)
    cap = int(np.ceil(len(ds.xb) / 32 * 1.6))
    j_idx = build_ivfpq(ds.xb, IndexConfig(**kw), xt=ds.xt,
                        kmeans_iters=8, pq_iters=6, seed=0)
    t_idx = t_build(ds.xb, TIndexConfig(**kw), xt=ds.xt,
                    kmeans_iters=8, pq_iters=6, seed=0, device="cpu")
    assert int(t_idx.list_len.max()) <= cap          # hard cap exact
    assert int(t_idx.list_len.sum()) == len(ds.xb) == t_idx.ntotal
    real = np.sort(t_idx.ids[t_idx.ids >= 0])
    np.testing.assert_array_equal(real, np.arange(len(ds.xb)))
    assert np.all(t_idx.list_start % 64 == 0)
    assert (t_idx.opq_R is not None) == opq
    np.testing.assert_allclose(t_idx.centroids, j_idx.centroids, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(t_idx.codebooks, j_idx.codebooks, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(t_idx.list_len, j_idx.list_len)
    r_j = recall_at_k(
        IVFSearcher(j_idx, SearchConfig(**s)).search(ds.xq)[1], gt, 10)
    r_t = recall_at_k(
        TIVFSearcher(t_idx, TSearchConfig(**s),
                     device="cpu").search(ds.xq)[1], gt, 10)
    assert abs(r_t - r_j) <= 0.005, (r_t, r_j)


def test_build_ivfpq_imi_not_ported(ds):
    """IMI is ported now: ``build_ivfpq`` routes ``cfg.imi`` through the
    factory, as the JAX package does (the name is kept from when it raised
    NotImplementedError).  A config whose nlist is not 4^imi is refused; a
    consistent one builds the product grid (row i·4+j = [a_i ‖ b_j])."""
    with pytest.raises(ValueError, match="IMI2x2"):
        t_build(ds.xb, TIndexConfig(dim=32, m=8, imi=2), device="cpu")
    idx = t_build(ds.xb, TIndexConfig(dim=32, nlist=16, m=8, imi=2),
                  xt=ds.xt, kmeans_iters=2, pq_iters=2, device="cpu")
    assert idx.cfg.imi == 2 and idx.centroids.shape == (16, 32)
    np.testing.assert_array_equal(idx.centroids[:4, :16],
                                  np.broadcast_to(idx.centroids[0, :16],
                                                  (4, 16)))
    assert int(idx.list_len.sum()) == ds.nb


@pytest.mark.parametrize("chunk", [1_000_000, 3000])
def test_compute_ground_truth_matches(ds, chunk):
    want_i, want_d = compute_ground_truth(ds.xb, ds.xq, k=20)
    got_i, got_d = t_ground_truth(ds.xb, ds.xq, k=20, chunk=chunk,
                                  query_chunk=16, device="cpu")
    assert got_i.dtype == np.int64 and got_d.dtype == np.float32
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-3)
    assert np.all((got_i == want_i) | (np.abs(got_d - want_d) < 1e-3))
