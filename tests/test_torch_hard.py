"""The port's hard-mode corpus (``chamjax_torch/data/hard.py``) on the CPU,
against the JAX package's: both draw the same threefry streams, so the
rows, the training rows and both kinds of queries are the JAX package's
(rtol 1e-5, atol 1e-5: the fp32 projection runs in another order), the
Zipf mass CDF bit for bit (the port sums it in XLA's CPU order); plus the
corpus statistics ``tests/test_hard_corpus.py`` gates the JAX package's
on."""

import jax.numpy as jnp
import numpy as np
import pytest

from chamjax.data.hard import make_hard_corpus as j_make_hard_corpus
from chamjax.data.hard import synthetic_dataset_hard as j_dataset_hard

from chamjax_torch.config import IndexConfig, SearchConfig
from chamjax_torch.data import compute_ground_truth
from chamjax_torch.data.hard import (GEN, make_hard_corpus,
                                     synthetic_dataset_hard)
from chamjax_torch.eval import recall_at_k
from chamjax_torch.index import build_ivfpq
from chamjax_torch.searcher import IVFSearcher


@pytest.fixture(scope="module")
def hc():
    return make_hard_corpus(d=32, n_clusters=4096, seed=7, device="cpu")


def test_hard_draw_deterministic_and_chunk_invariant(hc):
    a = hc.draw_base(0, 2 * GEN).numpy()
    b0 = hc.draw_base(0, GEN).numpy()
    b1 = hc.draw_base(GEN, GEN).numpy()
    np.testing.assert_array_equal(a, np.concatenate([b0, b1]))
    # a fresh corpus from the same seed draws the same rows
    again = make_hard_corpus(d=32, n_clusters=4096, seed=7, device="cpu")
    np.testing.assert_array_equal(again.draw_base(GEN, GEN).numpy(), b1)
    # the train stream differs from the base stream
    tr = hc.draw_train(0, GEN).numpy()
    assert not np.allclose(tr[:100], b0[:100])
    assert a.dtype == np.float32 and np.isfinite(a).all()


def test_hard_corpus_equals_chamjax():
    """The same rows as the JAX package's corpus from the same seed: a
    chunk past the first of the base stream, the training stream, jittered
    queries (``choice`` without replacement, the jitter normal) and
    independent queries; the wrapper's dataset too."""
    kw = dict(d=16, n_clusters=512, seed=7, n_banks=8)
    j = j_make_hard_corpus(**kw)
    hc = make_hard_corpus(**kw, device="cpu")
    for name, want, got in (
            ("base", j.draw_base(GEN, GEN), hc.draw_base(GEN, GEN)),
            ("train", j.draw_train(0, GEN), hc.draw_train(0, GEN)),
            ("jittered", j.queries(64, jitter=0.3),
             hc.queries(64, jitter=0.3)),
            ("independent", j.queries(64), hc.queries(64))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    want = j_dataset_hard(nb=3000, nq=16, nt=2000, d=16, n_clusters=512,
                          seed=3)
    got = synthetic_dataset_hard(nb=3000, nq=16, nt=2000, d=16,
                                 n_clusters=512, seed=3, device="cpu")
    for part in ("xb", "xt", "xq"):
        np.testing.assert_allclose(getattr(got, part), getattr(want, part),
                                   rtol=1e-5, atol=1e-5, err_msg=part)


@pytest.mark.parametrize("span", [(0, 1000), (1000, GEN), (0, 0)])
def test_hard_draw_rejects_misaligned(span):
    hc = make_hard_corpus(d=16, n_clusters=256, seed=1, device="cpu")
    with pytest.raises(ValueError, match="GEN"):
        hc.draw_base(*span)


def test_hard_mass_is_heavy_tailed(hc):
    """The top 1% of clusters hold far more than 1% of the mass (~1/4 at
    zipf_a 1.05), and the tail still matters."""
    cdf = hc.params["mass_cdf"]
    top1pct_mass = float(cdf[max(cdf.shape[0] // 100, 1) - 1])
    assert 0.15 < top1pct_mass < 0.9, top1pct_mass


@pytest.mark.parametrize("n_clusters,zipf_a", [(4096, 1.05), (262_144, 1.05),
                                               (512, 1.3)])
def test_rng_free_parameters_equal_jax(n_clusters, zipf_a):
    """The mass CDF equals the JAX package's bit for bit (its prefix sums
    and total in XLA's CPU order; one ulp would move rows across a cluster
    boundary) and the eigenvalue profile ``lam`` to 16 float32 ulps (XLA's
    and torch's ``exp`` round differently in the last bits)."""
    d = 32
    hc = make_hard_corpus(d=d, n_clusters=n_clusters, seed=0,
                          zipf_a=zipf_a, n_banks=4, device="cpu")
    j = j_make_hard_corpus(d=d, n_clusters=n_clusters, seed=0,
                           zipf_a=zipf_a, n_banks=4)
    np.testing.assert_array_equal(hc.params["mass_cdf"], j.params["mass_cdf"])
    # chamjax/data/hard.py builds lam inside make_hard_corpus: the same
    # two lines in jnp
    rank = j.params["rank"]
    tau = j.params["spectrum_tau"]
    lam = jnp.exp(-jnp.arange(rank, dtype=jnp.float32) / tau)
    lam = np.asarray(lam * jnp.sqrt(rank / jnp.sum(lam * lam)))
    np.testing.assert_allclose(hc.params["lam"], lam, rtol=16 * 2.0 ** -24,
                               atol=0)
    for key in ("rank", "spectrum_tau", "zipf_a", "center_scale", "noise",
                "n_banks"):
        assert hc.params[key] == j.params[key], key


def test_hard_queries_are_near_corpus_rows(hc):
    """Jittered queries: each one's nearest corpus row is far nearer than a
    random row; drawn without replacement (distinct sources)."""
    q = hc.queries(64, jitter=0.3).numpy()
    base = hc.draw_base(0, GEN).numpy()
    rnd = float(np.median(((base[None, :2048] - q[:8, None]) ** 2).sum(-1)))
    mins = [float(((base - q[i]) ** 2).sum(-1).min()) for i in range(8)]
    assert np.median(mins) < 0.25 * rnd, (np.median(mins), rnd)
    src = [int(((base - q[i]) ** 2).sum(-1).argmin()) for i in range(16)]
    assert len(set(src)) == 16
    ind = hc.queries(8).numpy()               # independent draws
    assert ind.shape == (8, 32) and np.isfinite(ind).all()
    with pytest.raises(ValueError):
        hc.queries(GEN + 1)


def test_hard_dataset_wrapper_shapes():
    ds = synthetic_dataset_hard(nb=1000, nq=16, nt=500, d=16,
                                n_clusters=512, seed=3, device="cpu")
    assert ds.xb.shape == (1000, 16)
    assert ds.xq.shape == (16, 16)
    assert ds.xt.shape == (500, 16)
    assert np.isfinite(ds.xb).all()


def test_hard_recall_does_not_saturate_at_low_nprobe():
    """The defining property: with nlist ≪ n_clusters and overlapping
    clusters, R@10 at nprobe=1 stays well below nprobe=16 (the JAX
    package's bars: r[16] − r[1] > 0.1, r[1] < 0.85)."""
    hc = make_hard_corpus(d=32, n_clusters=8192, seed=5, device="cpu")
    xb = hc.draw_base(0, GEN)[:120_000].numpy()
    xt = hc.draw_train(0, GEN)[:40_000].numpy()
    xq = hc.queries(64, jitter=0.35).numpy()
    gt, _ = compute_ground_truth(xb, xq, k=10, device="cpu")
    idx = build_ivfpq(xb, IndexConfig(dim=32, nlist=256, m=8, list_pad=64),
                      xt=xt, kmeans_iters=6, pq_iters=6, device="cpu")
    r = {}
    for nprobe in (1, 16):
        s = IVFSearcher(idx, SearchConfig(nprobe=nprobe, k=10,
                                          use_approx_topk=False),
                        device="cpu")
        r[nprobe] = recall_at_k(s.search(xq)[1], gt, 10)
    assert r[16] - r[1] > 0.1, r
    assert r[1] < 0.85, r
