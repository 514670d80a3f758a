"""chamjax_torch.ir.rerank on the CPU: the counterpart of
``tests/test_ir.py::test_seq2seq_reranker_contract``, then parity with the
JAX package: ``maxsim_scores`` and ``Seq2SeqReranker.predict`` (weights
carried across by ``models/convert.py``) within 1e-5, and the rerankers'
result dicts up to the order of score ties."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chamjax_torch.config import ModelConfig
from chamjax_torch.ir import MaxSimReranker, Rerank, Seq2SeqReranker
from chamjax_torch.ir.rerank import maxsim_scores
from chamjax_torch.models.convert import decoder_from_numpy, encoder_from_numpy

from test_ir import _make_corpus
from test_torch_ir import same_results_up_to_ties

CPU = dict(device="cpu")


def test_seq2seq_reranker_contract():
    corpus, queries, _ = _make_corpus()
    model = Seq2SeqReranker(**CPU)
    pairs = [("what is solar", "solar energy panels"),
             ("what is solar", "cooking pasta recipes")]
    s1, s2 = model.predict(pairs), model.predict(pairs)
    assert len(s1) == 2 and np.allclose(s1, s2)
    first = {qid: {did: 1.0 for did in list(corpus)[:8]}
             for qid in list(queries)[:2]}
    out = Rerank(model).rerank(corpus, queries, first, top_k=5)
    assert all(len(v) == 5 for v in out.values())


def test_maxsim_scores_equal_chamjax():
    """Random token sets with padding, one doc all padding (its score 0:
    the -inf mask first, then non-finite → 0)."""
    from chamjax.ir.rerank import maxsim_scores as jmaxsim
    rng = np.random.default_rng(0)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    d = rng.standard_normal((5, 9, 16)).astype(np.float32)
    mask = (rng.random((5, 9)) > 0.3).astype(np.float32)
    mask[2] = 0.0
    got = maxsim_scores(torch.from_numpy(q), torch.from_numpy(d),
                        torch.from_numpy(mask)).numpy()
    want = np.asarray(jmaxsim(jnp.asarray(q), jnp.asarray(d),
                              jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[2] == 0.0


def test_maxsim_reranker_equal_chamjax():
    from chamjax.ir.rerank import MaxSimReranker as JMaxSim
    corpus, queries, _ = _make_corpus()
    rng = np.random.default_rng(4)
    dids = list(corpus)
    first = {q: {str(d): float(rng.random())
                 for d in rng.choice(dids, 25, replace=False)}
             for q in queries}
    got = MaxSimReranker(dim=32, max_tokens=12, **CPU).rerank(
        corpus, queries, first, 10)
    want = JMaxSim(dim=32, max_tokens=12).rerank(corpus, queries, first, 10)
    same_results_up_to_ties(got, want, 10)


@pytest.fixture(scope="module")
def seq2seq_pair():
    from chamjax.ir.rerank import Seq2SeqReranker as JSeq
    j = JSeq(seed=3, max_len=32)
    t = Seq2SeqReranker(cfg=ModelConfig(**dataclasses.asdict(j.cfg)),
                        max_len=32, **CPU)
    host = lambda p: jax.tree.map(lambda a: np.asarray(a, np.float32), p)  # noqa: E731
    t.enc_params = encoder_from_numpy(host(j.enc_params), t.cfg, **CPU)
    t.dec_params = decoder_from_numpy(host(j.dec_params), t.cfg, **CPU)
    return j, t


def test_seq2seq_predict_equal_chamjax(seq2seq_pair):
    """Carried weights: every pair's log-odds within 1e-5, over a batch
    size that leaves a short last batch (the cache of each size reused)."""
    j, t = seq2seq_pair
    corpus, queries, _ = _make_corpus(n_per_topic=6)
    q = list(queries.values())
    pairs = [(q[i % len(q)], corpus[d]["text"])
             for i, d in enumerate(corpus)]
    got = t.predict(pairs, batch_size=10)
    again = t.predict(pairs, batch_size=10)
    want = j.predict(pairs, batch_size=10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got == again
    assert sorted(t._caches) == [4, 10]


def test_seq2seq_rerank_equal_chamjax(seq2seq_pair):
    from chamjax.ir.rerank import Rerank as JRerank
    j, t = seq2seq_pair
    corpus, queries, _ = _make_corpus(n_per_topic=6)
    first = {qid: {did: 1.0 for did in list(corpus)[::3]}
             for qid in queries}
    same_results_up_to_ties(Rerank(t).rerank(corpus, queries, first, 5),
                            JRerank(j).rerank(corpus, queries, first, 5), 5)
