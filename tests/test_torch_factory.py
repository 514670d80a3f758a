"""The index factory, IMI and sizing of the port (``chamjax_torch/index/
factory.py``, ``imi.py``, ``sizing.py``) against the JAX package's, on the
CPU: key parsing, the ``TrainedQuantizers`` npz across packages, populate
and merge from JAX-trained quantizers, the factored IMI scan and
assignment on the same half centroids, ``build_ivfpq``'s IMI route."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chamjax.config import IndexConfig
from chamjax.data import synthetic_dataset
from chamjax.index import factory as jf
from chamjax.index import imi as jimi
from chamjax.index import sizing as jsizing

from chamjax_torch.config import IndexConfig as TIndexConfig
from chamjax_torch.config import SearchConfig as TSearchConfig
from chamjax_torch.data import compute_ground_truth
from chamjax_torch.eval import recall_at_k
from chamjax_torch.index import build_ivfpq
from chamjax_torch.index import factory as tf
from chamjax_torch.index import imi as timi
from chamjax_torch.index import sizing as tsizing
from chamjax_torch.index.kmeans import assign as t_assign
from chamjax_torch.ops.coarse import select_probes
from chamjax_torch.searcher import IVFSearcher


def tq_from_jax(tq) -> tf.TrainedQuantizers:
    return tf.TrainedQuantizers(
        cfg=TIndexConfig(**dataclasses.asdict(tq.cfg)),
        centroids=np.asarray(tq.centroids), codebooks=np.asarray(
            tq.codebooks),
        opq_R=None if tq.opq_R is None else np.asarray(tq.opq_R))


def assert_packed_equal(a, b):
    for name in ("centroids", "codebooks", "codes", "ids", "list_start",
                 "list_len"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
    assert a.ntotal == b.ntotal
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
    assert (a.opq_R is None) == (b.opq_R is None)
    if a.opq_R is not None:
        np.testing.assert_array_equal(a.opq_R, b.opq_R)


@pytest.fixture(scope="module")
def corpus():
    return synthetic_dataset(nb=12000, nq=16, nt=6000, d=32, seed=5,
                             n_clusters=32)


KEYS = ["OPQ16,IVF4096,PQ16", "IVF1024,PQ32", "OPQ32,IVF4096,PQ16",
        "IMI2x5,PQ16", "OPQ8,IMI2x4,PQ8"]


@pytest.mark.parametrize("key", KEYS)
def test_parse_index_key_matches_jax(key):
    dim = 64 if "OPQ8" in key else 128
    want = dataclasses.asdict(jf.parse_index_key(key, dim=dim))
    got = tf.parse_index_key(key, dim=dim)
    assert dataclasses.asdict(got) == want
    assert got.key == jf.parse_index_key(key, dim=dim).key


@pytest.mark.parametrize("key", ["IVF4096", "OPQ16,PQ16"])
def test_parse_index_key_refusals(key):
    for parse in (jf.parse_index_key, tf.parse_index_key):
        with pytest.raises(ValueError):
            parse(key, dim=128)


@pytest.mark.parametrize("opq", [False, True])
def test_trained_quantizers_npz_across_packages(corpus, tmp_path, opq):
    """Quantizers saved by either package load in the other, bit-equal."""
    cfg = IndexConfig(dim=32, nlist=16, m=8, list_pad=64, opq=opq)
    tq_j = jf.train_quantizers(corpus.xt, cfg, kmeans_iters=2, pq_iters=2)
    p_j = str(tmp_path / "jax.npz")
    tq_j.save(p_j)
    got = tf.TrainedQuantizers.load(p_j)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(cfg)
    np.testing.assert_array_equal(got.centroids, tq_j.centroids)
    np.testing.assert_array_equal(got.codebooks, tq_j.codebooks)
    assert (got.opq_R is None) == (not opq)
    p_t = str(tmp_path / "torch.npz")
    got.save(p_t)
    back = jf.TrainedQuantizers.load(p_t)
    assert back.cfg == cfg
    np.testing.assert_array_equal(back.centroids, tq_j.centroids)
    np.testing.assert_array_equal(back.codebooks, tq_j.codebooks)
    if opq:
        np.testing.assert_array_equal(back.opq_R, tq_j.opq_R)
    else:
        assert back.opq_R is None


@pytest.mark.parametrize("variant", ["ivf", "opq", "balanced", "imi"])
def test_populate_from_jax_quantizers_equals_jax(corpus, variant):
    """``populate`` from JAX-trained quantizers gives the JAX package's
    ``PackedIVF``, bit-equal."""
    cfg = {"ivf": IndexConfig(dim=32, nlist=16, m=8, list_pad=64),
           "opq": IndexConfig(dim=32, nlist=16, m=8, list_pad=64, opq=True),
           "balanced": IndexConfig(dim=32, nlist=16, m=8, list_pad=64,
                                   balanced=True, balance_hard=True,
                                   balance_factor=1.2),
           "imi": jf.parse_index_key("IMI2x3,PQ8", dim=32)}[variant]
    tq_j = jf.train_quantizers(corpus.xt, cfg, kmeans_iters=3, pq_iters=3)
    want = jf.populate(corpus.xb, tq_j, id_offset=7)
    got = tf.populate(corpus.xb, tq_from_jax(tq_j), id_offset=7,
                      device="cpu")
    assert_packed_equal(got, want)


def test_merge_equals_single_populate(corpus):
    """Three populated slices merged equal one populate of the whole corpus
    (per-list content, ids exactly once), and JAX's merge of the same
    slices, bit-equal."""
    cfg = IndexConfig(dim=32, nlist=16, m=8, list_pad=64)
    tq = tq_from_jax(jf.train_quantizers(corpus.xt, cfg, kmeans_iters=3,
                                         pq_iters=3))
    n = corpus.nb
    single = tf.populate(corpus.xb, tq, device="cpu")
    bounds = [(n * s // 3, n * (s + 1) // 3) for s in range(3)]
    parts = [tf.populate(corpus.xb[lo:hi], tq, id_offset=lo, device="cpu")
             for lo, hi in bounds]
    merged = tf.merge_indexes(parts)
    assert_packed_equal(merged, single)
    j_tq = jf.TrainedQuantizers(cfg=cfg, centroids=tq.centroids,
                                codebooks=tq.codebooks)
    j_parts = [jf.populate(corpus.xb[lo:hi], j_tq, id_offset=lo)
               for lo, hi in bounds]
    assert_packed_equal(merged, jf.merge_indexes(j_parts))
    with pytest.raises(ValueError):
        tf.merge_indexes([])


def test_imi_matches_jax_on_the_same_halves(corpus):
    """``imi_centroids``, ``assign_imi`` and ``coarse_scan_imi`` on the JAX
    package's half codebooks: the grid bit-equal, the assignment equal,
    probes equal and distances within rtol 1e-5; the factored scan also
    ranks as the port's flat coarse scan over the grid."""
    cents_a, cents_b = jimi.train_imi(corpus.xt, bits=3, iters=3)
    grid = timi.imi_centroids(cents_a, cents_b)
    np.testing.assert_array_equal(grid, jimi.imi_centroids(cents_a, cents_b))
    assert grid.shape == (64, 32)
    a_t = timi.assign_imi(corpus.xb[:3000], cents_a, cents_b, chunk=1000,
                          device="cpu")
    a_j = jimi.assign_imi(corpus.xb[:3000], cents_a, cents_b, chunk=1000)
    assert a_t.dtype == np.int64
    np.testing.assert_array_equal(a_t, a_j)
    assert (a_t == t_assign(corpus.xb[:3000], grid, device="cpu")).mean() \
        > 0.999
    q = corpus.xq
    i_t, d_t = timi.coarse_scan_imi(torch.from_numpy(q),
                                    torch.from_numpy(cents_a),
                                    torch.from_numpy(cents_b), nprobe=8)
    i_j, d_j = jimi.coarse_scan_imi(jnp.asarray(q), jnp.asarray(cents_a),
                                    jnp.asarray(cents_b), nprobe=8)
    assert i_t.dtype == torch.int32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-3)
    i_f, _ = select_probes(torch.from_numpy(q), torch.from_numpy(grid), 8)
    np.testing.assert_array_equal(i_t.numpy(), i_f.numpy())


def test_build_ivfpq_imi_routes_to_the_factory(corpus):
    """``build_ivfpq(cfg.imi)`` trains a product-structured quantizer
    through the factory (row i·8+j = [a_i ‖ b_j]) and searches."""
    cfg = tf.parse_index_key("IMI2x3,PQ8", dim=32)
    idx = build_ivfpq(corpus.xb, cfg, xt=corpus.xt, kmeans_iters=4,
                      pq_iters=4, device="cpu")
    assert idx.cfg.imi == 3 and idx.centroids.shape == (64, 32)
    k, h = 8, 16
    np.testing.assert_array_equal(
        idx.centroids[:k, :h], np.broadcast_to(idx.centroids[0, :h], (k, h)))
    np.testing.assert_array_equal(idx.centroids[::k, h:],
                                  np.broadcast_to(idx.centroids[0, h:],
                                                  (k, h)))
    trained = tf.train_quantizers(corpus.xt, cfg, kmeans_iters=4,
                                  pq_iters=4, device="cpu")
    assert_packed_equal(idx, tf.populate(corpus.xb, trained, device="cpu"))
    gt, _ = compute_ground_truth(corpus.xb, corpus.xq, k=10, device="cpu")
    s = IVFSearcher(idx, TSearchConfig(nprobe=16, k=10), device="cpu")
    assert recall_at_k(s.search(corpus.xq)[1], gt, 10) > 0.4


SIZING_CASES = [(100, 32), (100, 1), (10, 8), (1000, 64), (16, 128)]


@pytest.mark.parametrize("k,parts", SIZING_CASES)
def test_sizing_equals_jax(k, parts):
    """Every sizing function of the port equals the JAX package's to 1e-12
    (a copy of the same numpy/math code)."""
    assert tsizing.partial_k(k, parts) == jsizing.partial_k(k, parts)
    kp = max(1, k // max(parts, 1) + 2)
    for fn, args in ((tsizing.overflow_probability, (k, parts, kp)),
                     (tsizing.expected_recall_loss, (k, max(parts, 1), kp)),
                     (tsizing.binom_tail, (k, 1.0 / max(parts, 2), kp)),
                     (tsizing.lane_l1_loss, (k, parts))):
        want = getattr(jsizing, fn.__name__)(*args)
        assert abs(fn(*args) - want) <= 1e-12, fn.__name__
    sizes = np.random.default_rng(k).integers(0, 5000, 257)
    for q in (0.5, 0.999):
        assert tsizing.scan_len_for_quantile(sizes, parts, q) == \
            jsizing.scan_len_for_quantile(sizes, parts, q)
    for scan in (128, 1024, 8192):
        assert abs(tsizing.truncated_mass(sizes, scan)
                   - jsizing.truncated_mass(sizes, scan)) <= 1e-12
