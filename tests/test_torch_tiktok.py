"""chamjax_torch.serving.tiktok against chamjax.serving.tiktok on the CPU,
case for case with ``tests/test_tiktok.py``: both loops finish, the recv
order is the send order, the scheduler reaches two requests in flight where
the sequential loop stays at one, the host pulls (one query a send plus one
completion pull a batch with a host retriever, only the completion pulls on
the fused path), the encoder-decoder refreshes its cross K/V, and the llama
family runs.

Both packages run the same parameters (JAX's, carried across in f32 by
``models/convert.py``) against the same retriever class, so the per-state
tokens and the send/recv event sequence must be equal; the fused path's
last retrieval equal up to the order of distance ties (rtol = atol = 1e-5,
``chamjax_torch.eval.tie_mismatches``).
"""

import time

import jax
import numpy as np
import pytest
import torch

from chamjax import models as jm
from chamjax.config import IndexConfig, ModelConfig, SearchConfig
from chamjax.data import synthetic_dataset
from chamjax.index import build_ivfpq
from chamjax.retrieval.local import LocalRetriever as JLocalRetriever
from chamjax.serving import ralm as jralm
from chamjax.serving import tiktok as jtiktok

from chamjax_torch import config as tconfig
from chamjax_torch.eval import tie_mismatches
from chamjax_torch.index.ivf import PackedIVF as TPackedIVF
from chamjax_torch.models.convert import (decoder_from_numpy,
                                          encoder_from_numpy,
                                          llama_from_numpy)
from chamjax_torch.retrieval import LocalRetriever
from chamjax_torch.retrieval.interface import BaseRetriever, RetrievalResult
from chamjax_torch.serving import ralm as tralm
from chamjax_torch.serving import tiktok as ttiktok

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = dict(model_type="decoder", embed_dim=32, ffn_embed_dim=64, layers=2,
             attention_heads=2, vocab_size=64, max_seq_len=32,
             retrieval_interval=2, k=5, dtype="float32")
ENCDEC = dict(SHAPE, model_type="encoder-decoder", encoder_layers=1,
              retrieval_token_len=4, k=3)
LLAMA = dict(model_type="llama", embed_dim=64, ffn_embed_dim=160, layers=2,
             attention_heads=4, kv_heads=2, vocab_size=97, max_seq_len=16,
             dtype="float32", retrieval_interval=4)


class DelayedRetriever(BaseRetriever):
    """Answers become ready only after delay_s (poll() honors it); the host
    retriever both packages' loops are run against."""

    def __init__(self, k: int = 5, delay_s: float = 0.01):
        self.k = k
        self.delay_s = delay_s
        self._pending = []
        self.sent_count = 0
        self.recv_count = 0

    def retrieve_send(self, queries, nprobe, k):
        self._pending.append((time.perf_counter() + self.delay_s,
                              np.asarray(queries).shape[0], k))
        self.sent_count += 1

    def poll(self):
        return bool(self._pending) and \
            time.perf_counter() >= self._pending[0][0]

    def retrieve_recv(self, batch=None, k=None):
        ready, b, kk = self._pending.pop(0)
        while time.perf_counter() < ready:
            time.sleep(0.001)
        self.recv_count += 1
        ids = np.broadcast_to(np.arange(kk, dtype=np.int64), (b, kk)).copy()
        return RetrievalResult(ids=ids,
                               dists=np.zeros((b, kk), np.float32))

    def retrieve(self, queries, nprobe, k):
        self.retrieve_send(queries, nprobe, k)
        return self.retrieve_recv(np.asarray(queries).shape[0], k)


class EventRetriever(DelayedRetriever):
    """Records the send/recv event sequence (order, not wall-clock)."""

    def __init__(self, k: int = 5, delay_s: float = 0.0):
        super().__init__(k=k, delay_s=delay_s)
        self.events = []

    def retrieve_send(self, queries, nprobe, k):
        self.events.append(("send", self.sent_count))
        super().retrieve_send(queries, nprobe, k)

    def retrieve_recv(self, batch=None, k=None):
        self.events.append(("recv", self.recv_count))
        return super().retrieve_recv(batch, k)


def f32_tree(p):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def models(shape, seed=0):
    """(chamjax config, port config, chamjax params, port params); the
    params of an encoder-decoder are pairs."""
    jcfg, tcfg = ModelConfig(**shape), tconfig.ModelConfig(**shape)
    key = jax.random.PRNGKey(seed)
    family = shape["model_type"]
    if family == "encoder-decoder":
        enc, dec = jm.init_encoder_decoder(key, jcfg)
        return jcfg, tcfg, (enc, dec), (
            encoder_from_numpy(f32_tree(enc), tcfg, device="cpu"),
            decoder_from_numpy(f32_tree(dec), tcfg, device="cpu"))
    if family == "llama":
        p = jm.init_llama(key, jcfg)
        return jcfg, tcfg, (p,), (llama_from_numpy(f32_tree(p), tcfg,
                                                   device="cpu"),)
    p = jm.init_decoder(key, jcfg)
    return jcfg, tcfg, (p,), (decoder_from_numpy(f32_tree(p), tcfg,
                                                 device="cpu"),)


def loops(shape, retrievers, **kw):
    """The chamjax loop and the port's loop, each on its retriever."""
    jcfg, tcfg, jp, tp = models(shape)
    cls = ("TikTokEncoderDecoder" if shape["model_type"] == "encoder-decoder"
           else "TikTokDecoder")
    return (getattr(jtiktok, cls)(*jp, jcfg, retrievers[0], **kw),
            getattr(ttiktok, cls)(*tp, tcfg, retrievers[1], **kw))


def same_states(jloop, tloop):
    for name in ("tik", "tok"):
        js, ts = jloop.states[name], tloop.states[name]
        np.testing.assert_array_equal(ts.tokens.numpy(),
                                      np.asarray(js.tokens))
        assert ts.step == js.step and ts.finished and not ts.sent


def max_depth(events):
    depth = deepest = 0
    for kind, _ in events:
        depth += 1 if kind == "send" else -1
        deepest = max(deepest, depth)
    return deepest


def test_tiktok_decoder_completes_and_counts():
    """The reference case with a delayed engine (5 ms): both batches
    finish, retrievals at steps 0, 2, 4 of each give 6 send/recv pairs."""
    _j, tcfg, _jp, tp = models(SHAPE)
    r = DelayedRetriever(k=5, delay_s=0.005)
    loop = ttiktok.TikTokDecoder(*tp, tcfg, r, batch_size=2,
                                 retrieval_interval=2, k=5)
    loop.batch_inference(6)
    assert all(s.finished for s in loop.states.values())
    assert all(s.step >= 6 for s in loop.states.values())
    assert r.sent_count == 6 and r.recv_count == 6
    assert not loop.in_flight
    assert loop.throughput_tokens_per_sec(6) > 0


@pytest.mark.parametrize("shape", [SHAPE, ENCDEC],
                         ids=["decoder", "encoder-decoder"])
def test_tokens_and_events_match_chamjax(shape):
    """The same engine (no delay, so the order is the state machine's):
    the same send/recv events, in order, and the same tokens in each
    state; the enc-dec cross K/V refreshed, equal to chamjax's."""
    k = shape["k"]
    rs = (EventRetriever(k=k), EventRetriever(k=k))
    jloop, tloop = loops(shape, rs, batch_size=2, retrieval_interval=2, k=k)
    steps = 6 if shape is SHAPE else 5
    jloop.batch_inference(steps)
    tloop.batch_inference(steps)
    assert rs[1].events == rs[0].events
    # retrieval due at steps 0, 2, 4 → 3 per batch, 6 in all
    assert rs[1].sent_count == rs[1].recv_count == 6
    same_states(jloop, tloop)
    assert not tloop.in_flight and tloop.throughput_tokens_per_sec(steps) > 0
    if shape is ENCDEC:
        for name in ("tik", "tok"):
            js, ts = jloop.states[name], tloop.states[name]
            assert ts.cross_kv is not None
            np.testing.assert_allclose(ts.cross_kv[0].numpy(),
                                       np.asarray(js.cross_kv[0]),
                                       rtol=2e-4, atol=2e-4)


def test_tiktok_overlap_properties():
    """Depth 2 for tik-tok (a request hidden behind the other batch), FIFO
    recv order, depth 1 for the sequential loop; the event sequences equal
    chamjax's."""
    jcfg, tcfg, jp, tp = models(SHAPE)
    events = []
    for tik, seq, cfg, p in (
            (jtiktok.TikTokDecoder, jralm.RalmDecoder, jcfg, jp[0]),
            (ttiktok.TikTokDecoder, tralm.RalmDecoder, tcfg, tp[0])):
        r = EventRetriever(k=5)
        tik(p, cfg, r, batch_size=2, retrieval_interval=1,
            k=5).batch_inference(8)
        assert max_depth(r.events) >= 2, r.events
        recvs = [i for kind, i in r.events if kind == "recv"]
        assert recvs == sorted(recvs)
        r_seq = EventRetriever(k=5)
        seq(p, cfg, r_seq, batch_size=2, retrieval_interval=1,
            k=5).batch_inference(8)
        assert max_depth(r_seq.events) == 1, r_seq.events
        events.append((r.events, r_seq.events))
    assert events[1] == events[0]


class _NpSpy:
    """Counts the np.asarray calls a tiktok module makes (each one a host
    pull of a device value)."""

    def __init__(self, real):
        self._real = real
        self.asarray_calls = 0

    def asarray(self, *a, **k):
        self.asarray_calls += 1
        return self._real.asarray(*a, **k)

    def __getattr__(self, name):
        return getattr(self._real, name)


def pulls(monkeypatch, loop, module, steps):
    spy = _NpSpy(np)
    monkeypatch.setattr(module, "np", spy)
    loop.batch_inference(steps)
    monkeypatch.setattr(module, "np", np)
    return spy.asarray_calls


def test_tiktok_host_syncs_only_on_sends(monkeypatch):
    """Plain steps pull nothing: one pull a send plus one completion pull a
    batch, as in chamjax."""
    rs = (DelayedRetriever(k=5, delay_s=0.0), DelayedRetriever(k=5,
                                                                delay_s=0.0))
    jloop, tloop = loops(SHAPE, rs, batch_size=2, retrieval_interval=4, k=5)
    steps = 8
    counts = [pulls(monkeypatch, loop, mod, steps)
              for loop, mod in ((jloop, jtiktok), (tloop, ttiktok))]
    n_sends = 2 * (steps // 4)      # 2 batches, every 4th step
    assert rs[1].sent_count == n_sends
    assert counts == [n_sends + 2, n_sends + 2], counts
    same_states(jloop, tloop)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """One chamjax index per width (the decoder's 32), saved by chamjax
    and loaded by the port: (chamjax retriever, port retriever)."""
    ds = synthetic_dataset(nb=4000, nq=4, nt=2000, d=32, seed=2,
                           n_clusters=16)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=32, nlist=16, m=8, list_pad=64),
                      xt=ds.xt, kmeans_iters=2, pq_iters=2)
    path = str(tmp_path_factory.mktemp("tiktok") / "index.npz")
    idx.save(path)
    scfg = dict(nprobe=4, k=5, use_approx_topk=False)
    return (JLocalRetriever(idx, SearchConfig(**scfg)),
            LocalRetriever(TPackedIVF.load(path), tconfig.SearchConfig(**scfg),
                           device="cpu"))


@pytest.mark.parametrize("shape,steps", [(SHAPE, 8), (dict(
    ENCDEC, max_seq_len=16, k=5, encoder_layers=2), 6)],
    ids=["decoder", "encoder-decoder"])
def test_tiktok_device_path_fully_fused(monkeypatch, indexes, shape, steps):
    """With a retrieve_device retriever the loop is fused: only the
    completion pulls (tokens + the last retrieval's ids, per batch); the
    tokens equal chamjax's and the last retrievals equal up to ties."""
    jloop, tloop = loops(shape, indexes, batch_size=2, retrieval_interval=2,
                         nprobe=4, k=5)
    assert jloop._device_path and tloop._device_path
    counts = [pulls(monkeypatch, loop, mod, steps)
              for loop, mod in ((jloop, jtiktok), (tloop, ttiktok))]
    assert counts == [4, 4], counts
    same_states(jloop, tloop)
    for name in ("tik", "tok"):
        js, ts = jloop.states[name], tloop.states[name]
        ids = ts.last_result.ids.numpy()
        assert ids.shape == (2, 5) and (ids >= 0).all()
        if shape is not SHAPE:
            assert ts.cross_kv is not None
        bad = tie_mismatches(ts.last_result.dists.numpy(),
                             ids.astype(np.int64),
                             np.asarray(js.last_result.dists),
                             np.asarray(js.last_result.ids, np.int64), **TOL)
        assert not bad, bad


def test_tiktok_runs_llama_family():
    rs = (DelayedRetriever(delay_s=0.0), DelayedRetriever(delay_s=0.0))
    jcfg, tcfg, jp, tp = models(LLAMA, seed=8)
    jloop = jtiktok.TikTokDecoder(*jp, jcfg, rs[0], batch_size=2)
    tloop = ttiktok.TikTokDecoder(*tp, tcfg, rs[1], batch_size=2)
    for loop in (jloop, tloop):
        loop.batch_inference(num_step=8)
        assert all(st.step >= 8 for st in loop.states.values())
    assert rs[1].sent_count == rs[1].recv_count == 2 * (8 // 4)
    same_states(jloop, tloop)


def test_reset_keeps_the_states_buffers():
    """A reset empties each state in place (the graphs captured on its
    cache and tokens stay valid) and a second run repeats the first."""
    r = EventRetriever(k=5)
    _j, tcfg, _jp, tp = models(SHAPE)
    loop = ttiktok.TikTokDecoder(*tp, tcfg, r, batch_size=2,
                                 retrieval_interval=2, k=5)
    ptrs = {n: (s.tokens.data_ptr(), s.cache.k.data_ptr())
            for n, s in loop.states.items()}
    loop.batch_inference(6)
    first = {n: s.tokens.clone() for n, s in loop.states.items()}
    loop.reset_inference_state()
    for n, s in loop.states.items():
        assert (s.tokens.data_ptr(), s.cache.k.data_ptr()) == ptrs[n]
        assert s.step == 0 and s.cache.host_idx == 0 and not s.finished
    loop.batch_inference(6)
    for n, s in loop.states.items():
        assert torch.equal(s.tokens, first[n])


class _DeviceRetriever:
    """A fused-path retriever: the same ids for every query."""

    def retrieve_device(self, q, nprobe, k):
        ids = torch.zeros((q.shape[0], k), dtype=torch.int64)
        return RetrievalResult(ids=ids, dists=ids.float())


def test_tiktok_runs_deepseek_v3_family():
    """The ``deepseek_v3`` family (its latent cache and its own rewind)
    through the tik-tok loop: each state's tokens and latent cache equal a
    ``RalmDecoder``'s greedy run over the same parameters (neither loop
    feeds retrieval back into the model), and a reset keeps each state's
    latent storage and repeats the run."""
    from chamjax_torch.models.mla_moe import init_mla_moe
    from test_torch_mla_moe import TINY
    p = init_mla_moe(11, TINY, device="cpu")
    first = torch.tensor([5, 9], dtype=torch.int32)
    seq = tralm.RalmDecoder(p, TINY, _DeviceRetriever(), 2,
                            retrieval_interval=2, k=2)
    seq.tokens.copy_(first)
    seq.batch_inference(8)
    loop = ttiktok.TikTokDecoder(p, TINY, _DeviceRetriever(), batch_size=2,
                                 retrieval_interval=2, k=2)
    ptrs = {n: s.cache.lat.data_ptr() for n, s in loop.states.items()}
    for _ in range(2):
        for s in loop.states.values():
            s.tokens.copy_(first)
        loop.batch_inference(8)
        for n, s in loop.states.items():
            assert s.step == 8 and s.cache.host_idx == int(s.cache.idx) == 8
            assert torch.equal(s.tokens, seq.tokens)
            assert torch.equal(s.cache.lat, seq.cache.lat)
        loop.reset_inference_state()
        for n, s in loop.states.items():
            assert s.cache.lat.data_ptr() == ptrs[n]
            assert s.cache.host_idx == 0 and not s.cache.lat.any()
