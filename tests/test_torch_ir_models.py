"""chamjax_torch.ir.train and ir.models on the CPU: counterparts of the
training tests of ``tests/test_ir.py``, then parity with the JAX package
from carried parameters (``models/convert.py``).

Tolerances: losses and their gradients within 1e-6 (absolute and
relative); encodings within 1e-5; 5 Adam steps (plain and with mined hard
negatives) give losses and parameters within 1e-4; mined negatives and
training pairs are equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chamjax_torch.ir import (DenseRetrievalExactSearch, DualEncoder,
                              EvaluateRetrieval, SparseEncoder, SparseSearch,
                              training_pairs)
from chamjax_torch.ir.dense import HashingEncoder
from chamjax_torch.ir.models import (DualEncoderTokenAdapter, _batch_ids,
                                     _doc_text)
from chamjax_torch.ir.train import (bpr_loss, cos_sim, margin_mse_loss,
                                    multiple_negatives_ranking_loss)
from chamjax_torch.models.convert import (dual_encoder_from_numpy,
                                          sparse_encoder_from_numpy)

from test_ir import _cross_vocab_dataset

CPU = dict(device="cpu")
T = torch.from_numpy


def ndcg10(qrels, results):
    return EvaluateRetrieval.evaluate(qrels, results, [10])[0]["NDCG@10"]


def host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# --- counterparts of tests/test_ir.py ----------------------------------------


def test_training_losses_gradients_point_right_way():
    rng = np.random.default_rng(0)
    q = T(rng.standard_normal((8, 16)).astype(np.float32))
    aligned = q + 0.05 * T(rng.standard_normal((8, 16)).astype(np.float32))
    random = T(rng.standard_normal((8, 16)).astype(np.float32))
    assert multiple_negatives_ranking_loss(q, aligned) < \
        multiple_negatives_ranking_loss(q, random)
    assert bpr_loss(q, aligned, random) < bpr_loss(q, random, aligned)
    s_q, s_p, s_n = torch.ones(8, 4), torch.ones(8, 4), torch.ones(8, 4) * .5
    exact = margin_mse_loss(s_q, s_p, s_n,
                            (s_q * s_p).sum(-1) - (s_q * s_n).sum(-1))
    assert float(exact) == pytest.approx(0.0, abs=1e-6)
    p = random.clone().requires_grad_(True)
    multiple_negatives_ranking_loss(q, p).backward()
    assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0


def test_trained_dual_encoder_beats_hashing():
    corpus, queries, qrels, tq, tqr = _cross_vocab_dataset()
    pairs = training_pairs(tq, tqr, corpus)
    enc = DualEncoder(dim=64, emb_dim=32, max_len=16, **CPU)
    curve = enc.fit(pairs, steps=120, batch=24, seed=1)
    assert curve[-1] < curve[0]

    def ndcg_of(model):
        s = DenseRetrievalExactSearch(model, corpus_chunk_size=50, **CPU)
        return ndcg10(qrels, s.search(corpus, queries, top_k=10))

    trained, hashing = ndcg_of(enc), ndcg_of(HashingEncoder(dim=128))
    assert trained > hashing + 0.2, (trained, hashing)
    assert trained > 0.8, trained


def doc_tokens_of(corpus, enc):
    doc_ids = list(corpus.keys())
    return doc_ids, _batch_ids([_doc_text(corpus[d]) for d in doc_ids],
                               enc.vocab, enc.max_len)


def test_dual_encoder_hard_negative_round():
    corpus, queries, qrels, tq, tqr = _cross_vocab_dataset()
    pairs = training_pairs(tq, tqr, corpus)
    enc = DualEncoder(dim=64, emb_dim=32, max_len=16, **CPU)
    enc.fit(pairs, steps=100, batch=24, seed=1)
    doc_ids, doc_tokens = doc_tokens_of(corpus, enc)
    did2idx = {d: i for i, d in enumerate(doc_ids)}
    qid_list = sorted(tqr.keys())
    positives = [{did2idx[d] for d, s in tqr[q].items()
                  if s > 0 and d in did2idx} for q in qid_list]
    neg = enc.mine_hard_negatives([tq[q] for q in qid_list], doc_tokens,
                                  positives=positives, n_neg=3, depth=12,
                                  use_ivfpq=False)
    assert neg.shape == (len(qid_list), 3)
    assert enc.mining[-1]["branch"] == "exact"
    for qi in range(len(qid_list)):
        assert not (set(neg[qi].tolist()) & positives[qi])
    q_of = {q: i for i, q in enumerate(qid_list)}
    pair_q = np.asarray([q_of[q] for q in tqr for _ in tqr[q]
                         if q in tq])[: len(pairs)]
    curve = enc.fit(pairs, steps=80, batch=24, seed=2,
                    neg_tokens=doc_tokens, neg_idx=neg[pair_q])
    assert curve[-1] < 5.0
    s = DenseRetrievalExactSearch(enc, corpus_chunk_size=50, **CPU)
    assert ndcg10(qrels, s.search(corpus, queries, top_k=10)) > 0.75


def test_trained_sparse_encoder_learns_alignment():
    corpus, queries, qrels, tq, tqr = _cross_vocab_dataset()
    pairs = training_pairs(tq, tqr, corpus)
    enc = SparseEncoder(n_buckets=512, latent=32, max_len=16, **CPU)
    curve = enc.fit(pairs, steps=150, batch=24, seed=2)
    assert curve[-1] < curve[0]
    res = SparseSearch(sparse_encoder=enc).search(corpus, queries, top_k=10)
    assert ndcg10(qrels, res) > 0.6


def test_training_pairs_extraction():
    corpus = {"d1": {"title": "t", "text": "x"}, "d2": {"text": "y"}}
    queries = {"q1": "alpha", "q2": "beta"}
    qrels = {"q1": {"d1": 1, "d2": 0}, "q2": {"d2": 2, "missing": 1}}
    pairs = training_pairs(queries, qrels, corpus)
    assert ("alpha", "t x") in pairs and ("beta", "y") in pairs
    assert len(pairs) == 2


# --- parity with the JAX package ---------------------------------------------


def test_losses_and_gradients_equal_chamjax():
    from chamjax.ir import train as J
    rng = np.random.default_rng(1)
    q, p, n = (rng.standard_normal((12, 24)).astype(np.float32)
               for _ in range(3))
    margin = rng.standard_normal(12).astype(np.float32)
    cases = [
        ("mnrl", lambda a, b, c, m, L: L.multiple_negatives_ranking_loss(
            a, b, scale=20.0)),
        ("margin_mse", lambda a, b, c, m, L: L.margin_mse_loss(a, b, c, m)),
        ("bpr", lambda a, b, c, m, L: L.bpr_loss(a, b, c)),
        ("cos_sim", lambda a, b, c, m, L: L.cos_sim(a, b).sum()),
    ]
    import chamjax_torch.ir.train as PT
    for name, f in cases:
        want, grads = jax.value_and_grad(
            lambda a, b, c: f(a, b, c, jnp.asarray(margin), J),
            argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(p),
                               jnp.asarray(n))
        ts = [T(x.copy()).requires_grad_(True) for x in (q, p, n)]
        got = f(*ts, T(margin), PT)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        for t, g in zip(ts, grads):
            gt = np.zeros_like(q) if t.grad is None else t.grad.numpy()
            np.testing.assert_allclose(gt, np.asarray(g), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    np.testing.assert_allclose(cos_sim(T(q), T(p)).numpy(),
                               np.asarray(J.cos_sim(q, p)), rtol=1e-6,
                               atol=1e-6)


def test_tokenizer_equal_chamjax():
    from chamjax.ir import models as JM
    from chamjax_torch.ir import models as TM
    texts = ["The cat sat", "", "a " * 40, "Ünïcode wörds here"]
    ids, mask = TM._batch_ids(texts, 977, 16)
    jids, jmask = JM._batch_ids(texts, 977, 16)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(mask, np.asarray(jmask))


@pytest.fixture(scope="module")
def dual_pair():
    """A JAX dual encoder and the port's, carried across."""
    from chamjax.ir import JaxDualEncoder
    j = JaxDualEncoder(vocab=512, dim=32, emb_dim=16, max_len=12, seed=4)
    return j, dual_encoder_from_numpy(host(j.params), max_len=12, **CPU)


def test_dual_encoder_init_and_conversion(dual_pair):
    """The port's own init from a seed is the JAX package's from that seed,
    bit for bit (both draw ``split(key(seed), 3)`` and a split a tower);
    ``shared_towers`` starts both towers from the query tower's keys, as
    there; the converter copies every parameter."""
    from chamjax.ir import JaxDualEncoder
    j, t = dual_pair
    own = DualEncoder(vocab=512, dim=32, emb_dim=16, max_len=12, seed=4,
                      **CPU)
    flat = jax.tree_util.tree_flatten_with_path(host(j.params))[0]
    params = dict(own.named_parameters())
    assert len(params) == len(flat)
    for path, a in flat:
        name = ".".join(k.key for k in path)
        np.testing.assert_array_equal(params[name].detach().numpy(), a,
                                      err_msg=name)
    shared = DualEncoder(vocab=64, dim=8, emb_dim=8, shared_towers=True,
                         **CPU)
    j_shared = JaxDualEncoder(vocab=64, dim=8, emb_dim=8, shared_towers=True)
    assert torch.equal(shared.q.w1, shared.d.w1)
    np.testing.assert_array_equal(shared.d.w2.detach().numpy(),
                                  np.asarray(j_shared.params["d"]["w2"]))
    np.testing.assert_array_equal(t.q.w2.detach().numpy(),
                                  np.asarray(j.params["q"]["w2"]))


def test_sparse_encoder_init_equals_chamjax():
    """``SparseEncoder(seed)`` starts from the JAX package's parameters for
    that seed, bit for bit (``split(key(seed))``: embed, head)."""
    from chamjax.ir import JaxSparseEncoder
    for seed in (3, 8):
        j = JaxSparseEncoder(vocab=256, n_buckets=128, latent=16,
                             max_len=12, seed=seed)
        t = SparseEncoder(vocab=256, n_buckets=128, latent=16, max_len=12,
                          seed=seed, **CPU)
        for name in ("embed", "head"):
            np.testing.assert_array_equal(getattr(t, name).detach().numpy(),
                                          np.asarray(j.params[name]),
                                          err_msg=name)


def test_dual_encoder_encodings_equal_chamjax(dual_pair):
    j, t = dual_pair
    texts = ["alpha beta gamma", "delta", "", "alpha alpha beta zeta eta"]
    docs = [{"title": "t", "text": "body words"}, "plain doc"]
    np.testing.assert_allclose(t.encode_queries(texts),
                               j.encode_queries(texts), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t.encode_corpus(docs), j.encode_corpus(docs),
                               atol=1e-5, rtol=1e-5)
    from chamjax.ir.models import DualEncoderTokenAdapter as JAdapter
    e, m = DualEncoderTokenAdapter(t, max_tokens=8).encode_tokens(texts)
    je, jm = JAdapter(j, max_tokens=8).encode_tokens(texts)
    np.testing.assert_allclose(e, je, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(m, jm)


def pairs_and_negs():
    corpus, _q, _qr, tq, tqr = _cross_vocab_dataset(n_per_topic=12,
                                                    n_train_q=5)
    pairs = training_pairs(tq, tqr, corpus)
    rng = np.random.default_rng(7)
    return corpus, pairs, rng.integers(0, len(corpus), (len(pairs), 2))


@pytest.mark.parametrize("hard", [False, True])
def test_dual_encoder_fit_equal_chamjax(hard):
    """5 Adam steps from carried parameters, in-batch and with mined
    negatives (``step_hard``'s candidates [positives; mined]): the loss
    curve and every parameter after within 1e-4."""
    from chamjax.ir import JaxDualEncoder
    corpus, pairs, neg = pairs_and_negs()
    j = JaxDualEncoder(vocab=256, dim=32, emb_dim=16, max_len=12, seed=2)
    t = dual_encoder_from_numpy(host(j.params), max_len=12, **CPU)
    kw = dict(steps=5, batch=8, lr=3e-3, seed=3)
    if hard:
        _ids, tokens = doc_tokens_of(corpus, t)
        kw.update(neg_tokens=tokens, neg_idx=neg)
    want = j.fit(pairs, **kw)
    got = t.fit(pairs, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    flat = jax.tree_util.tree_flatten_with_path(host(j.params))[0]
    params = dict(t.named_parameters())
    for path, a in flat:
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(params[name].detach().numpy(), a,
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_sparse_encoder_equal_chamjax():
    """Activations of carried parameters within 1e-5, the weighted bucket
    dicts the same buckets, 5 Adam steps (the FLOPS term in) within
    1e-4."""
    from chamjax.ir import JaxSparseEncoder
    _c, pairs, _n = pairs_and_negs()
    j = JaxSparseEncoder(vocab=256, n_buckets=128, latent=16, max_len=12,
                         max_expansion=16)
    t = sparse_encoder_from_numpy(host(j.params), max_len=12,
                                  max_expansion=16, **CPU)
    texts = ["alpha beta gamma", "delta", "", "zeta eta theta iota"]
    ids, mask = _batch_ids(texts, 256, 12)
    np.testing.assert_allclose(
        t.activations(texts),
        np.asarray(j._activate(j.params, jnp.asarray(ids),
                               jnp.asarray(mask))), rtol=1e-5, atol=1e-5)
    for text in texts:
        got, want = t.encode_query(text), j.encode_query(text)
        assert got.keys() == want.keys()
        np.testing.assert_allclose([got[k] for k in want],
                                   list(want.values()), rtol=1e-5, atol=1e-5)
    kw = dict(steps=5, batch=8, lr=3e-3, flops_lambda=1e-2, seed=5)
    np.testing.assert_allclose(t.fit(pairs, **kw), j.fit(pairs, **kw),
                               rtol=1e-4, atol=1e-4)
    for name in ("embed", "head"):
        np.testing.assert_allclose(getattr(t, name).detach().numpy(),
                                   np.asarray(j.params[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_minibatch_draws_equal_chamjax():
    """The port draws each step's rows as the reference does, call for
    call (replace=True once batch > n // 2)."""
    from chamjax_torch.ir.models import _draws
    for n, batch in ((100, 8), (10, 8), (7, 7)):
        rng = np.random.default_rng(9)
        want = [rng.choice(n, size=batch, replace=batch > n // 2)
                for _ in range(6)]
        np.testing.assert_array_equal(_draws(n, batch, 6, 9),
                                      np.stack(want))


def test_mine_hard_negatives_equal_chamjax(dual_pair):
    """The exact branch on the CPU, from carried parameters: the same
    negatives, padding draws included."""
    j, t = dual_pair
    corpus, _q, _qr, tq, tqr = _cross_vocab_dataset(n_per_topic=20)
    _ids, tokens = doc_tokens_of(corpus, t)
    qs = sorted(tq)
    positives = [set(range(i, len(corpus), 7)) for i in range(len(qs))]
    kw = dict(positives=positives, n_neg=4, depth=6, seed=1)
    got = t.mine_hard_negatives([tq[q] for q in qs], tokens, **kw)
    want = j.mine_hard_negatives([tq[q] for q in qs],
                                 (np.asarray(tokens[0]),
                                  np.asarray(tokens[1])),
                                 use_ivfpq=True, **kw)
    np.testing.assert_array_equal(got, want)
    assert t.mining[-1]["branch"] == "exact"


def test_encoders_need_card_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from chamjax_torch.ir import DenseRetrievalIVFPQSearch, MaxSimReranker
    from chamjax_torch.rag import DecoderReader, VectorStore
    for make in (lambda: DualEncoder(vocab=16, dim=8, emb_dim=8),
                 lambda: SparseEncoder(vocab=16, n_buckets=8, latent=4),
                 lambda: DenseRetrievalExactSearch(HashingEncoder(8)),
                 lambda: DenseRetrievalIVFPQSearch(HashingEncoder(8)),
                 lambda: MaxSimReranker(),
                 lambda: VectorStore(HashingEncoder(8)),
                 lambda: DecoderReader()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
