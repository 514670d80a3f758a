"""chamjax_torch.ir on the CPU: one counterpart for each test of
``tests/test_ir.py`` (retrieval, metrics, loader, ANN family) and
``tests/test_ir_synth.py``, then parity with the JAX package on the same
inputs.

Tolerances: the framework-free modules (metrics, synth, BM25, sparse) are
the same code, so their results are equal; a search is held to the JAX
package's up to the order of distance ties (``tie_mismatches``) at rtol
1e-5 on its scores.  The encoder models are in ``test_torch_ir_models.py``,
the rerankers in ``test_torch_rerank.py``."""

import math

import numpy as np
import pytest
import torch

from chamjax_torch.eval import tie_mismatches
from chamjax_torch.ir import (
    BM25Search, DenseRetrievalExactSearch, DenseRetrievalIVFPQSearch,
    EvaluateRetrieval, GenericDataLoader, MaxSimReranker,
)
from chamjax_torch.ir import metrics as M
from chamjax_torch.ir.dataloader import save_beir_dataset
from chamjax_torch.ir.dense import HashingEncoder

from test_ir import QRELS, RESULTS, _make_corpus

CPU = dict(device="cpu")


def ranked_arrays(results, qids, k):
    """Result dicts → (scores, row-of-doc ids) arrays, best first; a short
    row is padded with -inf and -1."""
    d = np.full((len(qids), k), -np.inf, np.float32)
    i = np.full((len(qids), k), -1, np.int64)
    for r, q in enumerate(qids):
        items = sorted(results[q].items(), key=lambda kv: -kv[1])[:k]
        for c, (did, s) in enumerate(items):
            d[r, c], i[r, c] = s, hash(did) % (1 << 40)
    return d, i


def same_results_up_to_ties(got, want, k, rtol=1e-5):
    """Two result dicts: the same queries, scores within rtol rank by rank,
    docs equal except in the order of ties.  Scores are negated so that
    ascending order is best first, as ``tie_mismatches`` reads them."""
    assert got.keys() == want.keys()
    qids = list(want)
    dg, ig = ranked_arrays(got, qids, k)
    dw, iw = ranked_arrays(want, qids, k)
    bad = tie_mismatches(-dg, ig, -dw, iw, rtol=rtol, atol=rtol)
    assert not bad, bad


# --- counterparts of tests/test_ir.py ----------------------------------------


def test_ndcg_hand_computed():
    dcg1 = 2.0 + 1.0 / math.log2(4)
    idcg1 = 2.0 + 1.0 / math.log2(3)
    expected = (dcg1 / idcg1 + 1.0 / math.log2(3)) / 2
    assert M.ndcg_at_k(QRELS, RESULTS, 10) == pytest.approx(expected)


def test_map_recall_precision_mrr():
    assert M.map_at_k(QRELS, RESULTS, 10) == pytest.approx(
        ((1 + 2 / 3) / 2 + 0.5) / 2)
    assert M.recall_at_k(QRELS, RESULTS, 1) == pytest.approx(0.25)
    assert M.recall_at_k(QRELS, RESULTS, 10) == 1.0
    assert M.precision_at_k(QRELS, RESULTS, 2) == pytest.approx(0.5)
    assert M.mrr_at_k(QRELS, RESULTS, 10) == pytest.approx(0.75)
    assert M.top_k_accuracy(QRELS, RESULTS, 1) == pytest.approx(0.5)
    assert M.hole_at_k(QRELS, RESULTS, 3) == pytest.approx(
        (1 / 3 + 1 / 2) / 2)


def test_evaluate_retrieval_surface():
    ndcg, _map, recall, precision = EvaluateRetrieval.evaluate(
        QRELS, RESULTS, [1, 10])
    assert set(ndcg) == {"NDCG@1", "NDCG@10"}
    assert recall["Recall@10"] == 1.0
    mrr = EvaluateRetrieval.evaluate_custom(QRELS, RESULTS, [10], "mrr")
    assert mrr["MRR@10"] == pytest.approx(0.75)


def test_map_at_k_uses_total_relevant_denominator():
    qrels = {"q": {f"d{i}": 1 for i in range(50)}}
    results = {"q": {f"d{i}": float(50 - i) for i in range(10)}}
    assert M.map_at_k(qrels, results, 10) == pytest.approx(10 / 50)


def test_dataloader_roundtrip(tmp_path):
    corpus, queries, qrels = _make_corpus(5)
    save_beir_dataset(str(tmp_path), corpus, queries, qrels)
    c2, q2, r2 = GenericDataLoader(str(tmp_path)).load("test")
    assert c2.keys() == corpus.keys()
    assert q2 == queries
    assert r2 == qrels


def ndcg10(qrels, results):
    return EvaluateRetrieval.evaluate(qrels, results, [10])[0]["NDCG@10"]


def test_dense_exact_search_quality():
    corpus, queries, qrels = _make_corpus()
    s = DenseRetrievalExactSearch(HashingEncoder(dim=128),
                                  corpus_chunk_size=50, **CPU)
    assert ndcg10(qrels, s.search(corpus, queries, top_k=10)) > 0.9


def ivfpq_searcher(**kw):
    from chamjax_torch.config import IndexConfig
    return DenseRetrievalIVFPQSearch(
        HashingEncoder(dim=128),
        IndexConfig(dim=128, nlist=8, m=16, list_pad=64), nprobe=8, **kw)


def test_ann_ivfpq_search_matches_topics():
    corpus, queries, qrels = _make_corpus(n_per_topic=64)
    results = ivfpq_searcher(**CPU).search(corpus, queries, top_k=10)
    assert ndcg10(qrels, results) > 0.8


def test_ann_save_load(tmp_path):
    corpus, queries, _ = _make_corpus(n_per_topic=64)
    s = ivfpq_searcher(**CPU)
    s.index_corpus(corpus)
    s.save(str(tmp_path))
    s2 = DenseRetrievalIVFPQSearch(HashingEncoder(dim=128), nprobe=8, **CPU)
    s2.load(str(tmp_path))
    r1 = s.search(corpus, queries, top_k=5)
    r2 = s2.search(corpus, queries, top_k=5)
    assert r1.keys() == r2.keys()
    for qid in r1:
        assert list(r1[qid]) == list(r2[qid])


def test_bm25_search_quality():
    corpus, queries, qrels = _make_corpus()
    results = BM25Search().search(corpus, queries, top_k=10)
    assert ndcg10(qrels, results) > 0.9
    for docs in results.values():
        vals = list(docs.values())
        assert vals == sorted(vals, reverse=True)


def test_maxsim_rerank_improves_noisy_firststage():
    corpus, queries, qrels = _make_corpus()
    rng = np.random.default_rng(3)
    bm25 = BM25Search().search(corpus, queries, top_k=20)
    noisy = {qid: {d: float(rng.random()) for d in docs}
             for qid, docs in bm25.items()}
    all_dids = list(corpus.keys())
    for qid in noisy:
        for d in rng.choice(all_dids, size=10, replace=False):
            noisy[qid][str(d)] = float(rng.random() + 0.5)
    rer = MaxSimReranker(dim=64, max_tokens=16, **CPU)
    reranked = rer.rerank(corpus, queries, noisy, top_k=10)
    before, after = ndcg10(qrels, noisy), ndcg10(qrels, reranked)
    assert after > before and after > 0.8


def test_sparse_search_quality():
    from chamjax_torch.ir.sparse import SparseSearch
    corpus, queries, qrels = _make_corpus()
    results = SparseSearch().search(corpus, queries, top_k=10)
    assert ndcg10(qrels, results) > 0.9


QUANTIZED = [
    ("FlatIPSearch", {}, 0.9),
    ("PQSearch", {"m": 16}, 0.8),
    ("SQSearch", {}, 0.85),
    ("PCASearch", {"output_dim": 32}, 0.8),
    ("BinarySearch", {}, 0.7),
]


@pytest.mark.parametrize("cls,kw,floor", QUANTIZED)
def test_quantized_search_quality(cls, kw, floor):
    import chamjax_torch.ir as ir
    corpus, queries, qrels = _make_corpus(n_per_topic=40)
    searcher = getattr(ir, cls)(HashingEncoder(dim=128),
                                corpus_chunk_size=64, **kw, **CPU)
    ndcg = ndcg10(qrels, searcher.search(corpus, queries, top_k=10))
    assert ndcg > floor, f"{cls}: {ndcg}"


@pytest.mark.parametrize("cls,kw", [
    ("SQSearch", {}), ("BinarySearch", {}), ("PCASearch", {"output_dim": 32}),
])
def test_quantized_search_save_load(cls, kw, tmp_path):
    import chamjax_torch.ir as ir
    corpus, queries, _ = _make_corpus(n_per_topic=20)
    model = HashingEncoder(dim=128)
    s = getattr(ir, cls)(model, corpus_chunk_size=64, **kw, **CPU)
    s.index_corpus(corpus)
    s.save(str(tmp_path))
    s2 = getattr(ir, cls)(model, corpus_chunk_size=64, **kw, **CPU)
    s2.load(str(tmp_path))
    assert s.search(corpus, queries, 5) == s2.search(corpus, queries, 5)


def test_flat_ip_matches_exact_search():
    from chamjax_torch.ir import FlatIPSearch
    corpus, queries, _ = _make_corpus(n_per_topic=25)
    model = HashingEncoder(dim=64)
    r_e = DenseRetrievalExactSearch(model, corpus_chunk_size=30,
                                    **CPU).search(corpus, queries, top_k=5)
    r_f = FlatIPSearch(model, corpus_chunk_size=30,
                       **CPU).search(corpus, queries, top_k=5)
    for qid in r_e:
        assert list(r_e[qid]) == list(r_f[qid])
        for did in r_e[qid]:
            assert r_e[qid][did] == pytest.approx(r_f[qid][did], abs=1e-4)


def test_hnsw_search_quality(tmp_path):
    import chamjax_torch.ir as ir
    corpus, queries, qrels = _make_corpus(n_per_topic=40)
    model = HashingEncoder(dim=64)
    for cls in (ir.HNSWSearch, ir.HNSWSQSearch):
        s = cls(model, M=12, ef_construction=80, ef_search=64, **CPU)
        ndcg = ndcg10(qrels, s.search(corpus, queries, top_k=10))
        assert ndcg > 0.85, (cls.__name__, ndcg)
    s.save(str(tmp_path))
    s2 = ir.HNSWSQSearch(model, **CPU)
    s2.load(str(tmp_path))
    assert s.search(corpus, queries, 5) == s2.search(corpus, queries, 5)


def cpu_mesh(n=2):
    from chamjax_torch.parallel import make_mesh
    return make_mesh((("shard", n),), devices=["cpu"] * n)


def test_dense_exact_multi_matches_single():
    """Mesh-sharded exact search returns the same ranking as one device
    (a port mesh of 2 CPU positions)."""
    from chamjax_torch.ir.dense import DenseRetrievalExactSearchMulti
    corpus, queries, qrels = _make_corpus(n_per_topic=33)   # non-divisible
    model = HashingEncoder(dim=64)
    r_s = DenseRetrievalExactSearch(model, corpus_chunk_size=64,
                                    **CPU).search(corpus, queries, top_k=10)
    r_m = DenseRetrievalExactSearchMulti(model, mesh=cpu_mesh()).search(
        corpus, queries, top_k=10)
    for qid in r_s:
        assert list(r_s[qid]) == list(r_m[qid])
        for did in r_s[qid]:
            assert r_s[qid][did] == pytest.approx(r_m[qid][did], abs=1e-4)
    assert ndcg10(qrels, r_m) > 0.9


def test_learned_sparse_encoder_splade_contract():
    from chamjax_torch.ir.sparse import LearnedSparseEncoder, SparseSearch
    corpus, queries, qrels = _make_corpus()
    enc = LearnedSparseEncoder(n_buckets=2048, max_expansion=48)
    w1 = enc.encode_query("solar panels energy")
    w2 = LearnedSparseEncoder(n_buckets=2048, max_expansion=48
                              ).encode_query("solar panels energy")
    assert w1 == w2 and isinstance(w1, dict) and len(w1) > 0
    results = SparseSearch(sparse_encoder=enc).search(corpus, queries,
                                                      top_k=10)
    assert ndcg10(qrels, results) > 0.5


# --- counterparts of tests/test_ir_synth.py ----------------------------------


@pytest.fixture(scope="module")
def small():
    from chamjax_torch.ir.synth import generate_beir_corpus
    return generate_beir_corpus(n_docs=1200, n_queries=20,
                                n_train_queries=40, n_topics=40, seed=1)


def test_synth_shapes_and_grades(small):
    corpus, queries, qrels, tq, tqr = small
    assert len(corpus) == 1200
    assert len(queries) == 20 and len(tq) == 40
    grades = {s for rel in qrels.values() for s in rel.values()}
    assert grades == {1, 2}, grades
    assert all(any(s == 2 for s in rel.values()) for rel in qrels.values())


def test_synth_vocabulary_mismatch(small):
    corpus, queries, qrels, *_ = small
    overlaps = []
    for qid, q in queries.items():
        qtok = set(q.split())
        rel2 = [d for d, s in qrels[qid].items() if s == 2]
        dtok = set()
        for did in rel2[:5]:
            dtok |= set((corpus[did]["title"] + " "
                         + corpus[did]["text"]).split())
        overlaps.append(len(qtok & dtok) / len(qtok))
    assert 0.02 < float(np.mean(overlaps)) < 0.7


def test_synth_deterministic(small):
    from chamjax_torch.ir.synth import generate_beir_corpus
    again = generate_beir_corpus(n_docs=1200, n_queries=20,
                                 n_train_queries=40, n_topics=40, seed=1)
    assert again[0] == small[0]
    assert again[1] == small[1]


def test_synth_roundtrip_via_loader(tmp_path):
    from chamjax_torch.ir.synth import write_beir_dataset
    kw = dict(n_docs=300, n_queries=8, n_train_queries=10, n_topics=10,
              seed=2)
    path = write_beir_dataset(str(tmp_path / "ds"), **kw)
    corpus, queries, qrels = GenericDataLoader(path).load("test")
    _c, tq, tqr = GenericDataLoader(path).load("train")
    assert len(corpus) == 300 and len(queries) == 8 and len(tq) == 10
    assert all(isinstance(s, int) for rel in qrels.values()
               for s in rel.values())
    assert write_beir_dataset(str(tmp_path / "ds"), **kw) == path


# --- parity with the JAX package ---------------------------------------------


def test_synth_identical_to_chamjax(small, tmp_path):
    """The same generator code and numpy stream: the corpus, both query
    splits and both qrels are identical, and so are the files written."""
    from chamjax.ir.synth import generate_beir_corpus, write_beir_dataset
    from chamjax_torch.ir.synth import write_beir_dataset as t_write
    want = generate_beir_corpus(n_docs=1200, n_queries=20,
                                n_train_queries=40, n_topics=40, seed=1)
    assert small == want
    kw = dict(n_docs=200, n_queries=5, n_train_queries=6, n_topics=8, seed=4)
    a, b = tmp_path / "jax", tmp_path / "torch"
    write_beir_dataset(str(a), **kw)
    t_write(str(b), **kw)
    for f in ("corpus.jsonl", "queries.jsonl", "qrels/test.tsv",
              "qrels/train.tsv", ".synth_meta.json"):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.fixture(scope="module")
def synth_small():
    from chamjax_torch.ir.synth import generate_beir_corpus
    corpus, queries, qrels, _tq, _tqr = generate_beir_corpus(
        n_docs=600, n_queries=12, n_train_queries=2, n_topics=20, seed=3)
    return corpus, queries, qrels


def test_metrics_equal_chamjax(synth_small):
    """Every metric over BM25's results on a synth corpus equals the JAX
    package's, to the last bit."""
    from chamjax.ir import metrics as JM
    from chamjax.ir.evaluation import EvaluateRetrieval as JEval
    corpus, queries, qrels = synth_small
    res = BM25Search().search(corpus, queries, top_k=100)
    for k in (1, 10, 100):
        for name in ("ndcg_at_k", "map_at_k", "recall_at_k",
                     "precision_at_k", "mrr_at_k", "recall_cap_at_k",
                     "hole_at_k", "top_k_accuracy"):
            assert getattr(M, name)(qrels, res, k) == \
                getattr(JM, name)(qrels, res, k), (name, k)
    assert EvaluateRetrieval.evaluate(qrels, res, [10, 100]) == \
        JEval.evaluate(qrels, res, [10, 100])


def test_bm25_and_sparse_equal_chamjax(synth_small):
    from chamjax.ir.lexical import BM25Search as JBM25
    from chamjax.ir.sparse import LearnedSparseEncoder as JLSE
    from chamjax.ir.sparse import SparseSearch as JSparse
    from chamjax_torch.ir.sparse import LearnedSparseEncoder, SparseSearch
    corpus, queries, _ = synth_small
    assert BM25Search().search(corpus, queries, 50) == \
        JBM25().search(corpus, queries, 50)
    assert SparseSearch().search(corpus, queries, 50) == \
        JSparse().search(corpus, queries, 50)
    enc = LearnedSparseEncoder(n_buckets=512, max_expansion=32)
    jenc = JLSE(n_buckets=512, max_expansion=32)
    assert SparseSearch(sparse_encoder=enc).search(corpus, queries, 20) == \
        JSparse(sparse_encoder=jenc).search(corpus, queries, 20)


def test_dense_exact_equal_chamjax():
    from chamjax.ir.dense import DenseRetrievalExactSearch as JExact
    from chamjax.ir.dense import HashingEncoder as JHash
    corpus, queries, _ = _make_corpus(n_per_topic=30)
    for fn in ("cos_sim", "dot"):
        got = DenseRetrievalExactSearch(HashingEncoder(dim=64),
                                        corpus_chunk_size=50, **CPU).search(
            corpus, queries, 10, score_function=fn)
        want = JExact(JHash(dim=64), corpus_chunk_size=50).search(
            corpus, queries, 10, score_function=fn)
        same_results_up_to_ties(got, want, 10)


def test_dense_exact_multi_equal_chamjax():
    """The port's mesh of 2 CPU positions against the JAX package's
    8-device CPU mesh."""
    from chamjax.ir.dense import DenseRetrievalExactSearchMulti as JMulti
    from chamjax.ir.dense import HashingEncoder as JHash
    from chamjax_torch.ir.dense import DenseRetrievalExactSearchMulti
    corpus, queries, _ = _make_corpus(n_per_topic=33)
    got = DenseRetrievalExactSearchMulti(
        HashingEncoder(dim=64), mesh=cpu_mesh()).search(corpus, queries, 10)
    want = JMulti(JHash(dim=64)).search(corpus, queries, 10)
    same_results_up_to_ties(got, want, 10)


@pytest.mark.parametrize("cls,kw", [
    ("FlatIPSearch", {}), ("PQSearch", {"m": 16}), ("SQSearch", {}),
    ("PCASearch", {"output_dim": 32}), ("BinarySearch", {}),
])
def test_quantized_search_equal_chamjax(cls, kw, tmp_path):
    """Each quantized search over the JAX package's saved ``_state()``
    (its codebooks, codes, affine, basis, bits) answers as the JAX
    package's does, up to ties."""
    import chamjax.ir as jir
    import chamjax_torch.ir as ir
    from chamjax.ir.dense import HashingEncoder as JHash
    corpus, queries, _ = _make_corpus(n_per_topic=40)
    j = getattr(jir, cls)(JHash(dim=128), corpus_chunk_size=64, **kw)
    j.index_corpus(corpus)
    j.save(str(tmp_path))
    t = getattr(ir, cls)(HashingEncoder(dim=128), corpus_chunk_size=64, **kw,
                         **CPU)
    t.load(str(tmp_path))
    same_results_up_to_ties(t.search(corpus, queries, 10),
                            j.search(corpus, queries, 10), 10)


def test_hnsw_equal_chamjax(tmp_path):
    """The same native graph code: a graph saved by the JAX package
    answers identically in the port, and the port's own build equals it."""
    import chamjax.ir as jir
    import chamjax_torch.ir as ir
    from chamjax.ir.dense import HashingEncoder as JHash
    corpus, queries, _ = _make_corpus(n_per_topic=30)
    j = jir.HNSWSearch(JHash(dim=64), M=12, ef_construction=80, ef_search=64)
    want = j.search(corpus, queries, 10)
    j.save(str(tmp_path))
    t = ir.HNSWSearch(HashingEncoder(dim=64), M=12, ef_construction=80,
                      ef_search=64, **CPU)
    assert t.search(corpus, queries, 10) == want
    t2 = ir.HNSWSearch(HashingEncoder(dim=64), ef_search=64, **CPU)
    t2.load(str(tmp_path))
    assert t2.search(corpus, queries, 10) == want


def test_binary_hamming_count_exact():
    """``popcount64`` over random words (sign bits set too) equals a
    bit-by-bit count, and ``hamming`` equals numpy's over unpacked bits."""
    from chamjax_torch.ir.ann import _words, hamming, popcount64
    rng = np.random.default_rng(0)
    w = rng.integers(-2 ** 63, 2 ** 63 - 1, size=4096, dtype=np.int64)
    w[:4] = [0, -1, -2 ** 63, 2 ** 63 - 1]
    want = np.array([bin(int(x) & (2 ** 64 - 1)).count("1") for x in w])
    np.testing.assert_array_equal(popcount64(torch.from_numpy(w)).numpy(),
                                  want)
    qb = rng.integers(0, 256, size=(5, 13), dtype=np.uint8)   # 13 bytes
    cb = rng.integers(0, 256, size=(9, 13), dtype=np.uint8)
    got = hamming(torch.from_numpy(_words(qb)), torch.from_numpy(_words(cb)))
    ref = (np.unpackbits(qb[:, None] ^ cb[None], axis=-1)).sum(-1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_ivfpq_search_equal_chamjax(tmp_path):
    """``DenseRetrievalIVFPQSearch`` over the same saved ``PackedIVF``
    (built by the JAX package, ~2k docs) and 20 queries: the raw
    ``(dists, ids)`` of both searchers agree up to ties (rtol 1e-5), and
    so do the result dicts.  The JAX searcher runs its Pallas scan in
    interpret mode."""
    from chamjax.config import IndexConfig
    from chamjax.ir.ann import DenseRetrievalIVFPQSearch as JIVF
    from chamjax.ir.dense import HashingEncoder as JHash
    corpus, queries, _ = _make_corpus(n_per_topic=500)       # 2000 docs
    rng = np.random.default_rng(5)
    words = " ".join(corpus[d]["text"] for d in list(corpus)[::97]).split()
    queries = {f"q{i}": " ".join(rng.choice(words, size=6))
               for i in range(20)}
    j = JIVF(JHash(dim=64), IndexConfig(dim=64, nlist=32, m=8, list_pad=64),
             nprobe=8)
    j.index_corpus(corpus)
    j.save(str(tmp_path))
    t = DenseRetrievalIVFPQSearch(HashingEncoder(dim=64), nprobe=8, **CPU)
    t.load(str(tmp_path))
    r_t = t.search(corpus, queries, 10)
    r_j = j.search(corpus, queries, 10)
    q = t.query_matrix(queries)
    dt, it = t.searcher.search(q, k=10)
    dj, ij = j.searcher.search(q, k=10)
    bad = tie_mismatches(dt, it, np.asarray(dj), np.asarray(ij), rtol=1e-5,
                         atol=1e-5)
    assert not bad, bad
    same_results_up_to_ties(r_t, r_j, 10)


def test_ivfpq_npz_from_the_port_loads_in_chamjax(tmp_path):
    """The other direction: an index the port builds and saves loads in
    the JAX package, whose search (Pallas in interpret mode) answers as
    the port's does, up to ties."""
    from chamjax.ir.ann import DenseRetrievalIVFPQSearch as JIVF
    from chamjax.ir.dense import HashingEncoder as JHash
    corpus, queries, _ = _make_corpus(n_per_topic=64)
    t = ivfpq_searcher(**CPU)
    t.index_corpus(corpus)
    t.save(str(tmp_path))
    j = JIVF(JHash(dim=128), nprobe=8)
    j.load(str(tmp_path))
    same_results_up_to_ties(t.search(corpus, queries, 10),
                            j.search(corpus, queries, 10), 10)
