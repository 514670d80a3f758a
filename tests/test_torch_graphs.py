"""The captured step (``chamjax_torch/utils/graphs.py``) on the CPU.

A CUDA graph needs the card, so these tests stand a CPU graph class in
(``ReplayStandIn``): it records the function once at capture and replays it
by running it again into the captured outputs, as a graph replays its
kernels into its own output buffers, and makes no launch count of its own.
Through it the CPU tests reach what the card runs: the keys, the copies
into the graph's inputs, the state read in place, the fresh outputs, the
launch counts added a replay, the warm-up's state put back, and the four
repairs a replay needs:

- (a) the cache-full check and ``host_idx`` live in the host shell of a
  step, so they hold under replay;
- (b) a replay adds the launches its capture recorded;
- (c) ``reset_inference_state`` empties the cache and the token buffer in
  place, so the graphs captured on them stay valid;
- (d) a step writes the next tokens into the fixed token buffer.

Bars: a replayed run equals the eager one exactly (the same ops on the
same values).
"""

import collections
import contextlib

import numpy as np
import pytest
import torch

from chamjax_torch.config import IndexConfig, ModelConfig, SearchConfig
from chamjax_torch.data import synthetic_dataset
from chamjax_torch.index import build_ivfpq
from chamjax_torch.models import transformer as tt
from chamjax_torch.models.llama import (init_llama, init_llama_kv_cache,
                                        llama_step)
from chamjax_torch.retrieval import LocalRetriever
from chamjax_torch.searcher import ivfpq_search, ivfpq_search_preassigned
from chamjax_torch.serving.ralm import RalmDecoder, RalmEncoderDecoder
from chamjax_torch.serving.tiktok import TikTokDecoder, TikTokEncoderDecoder
from chamjax_torch.utils import cuda_lib, graphs

D = 32
MODEL = dict(embed_dim=D, ffn_embed_dim=64, layers=2, attention_heads=4,
             vocab_size=61, max_seq_len=8, dtype="float32", k=4,
             retrieval_token_len=3)
H = MODEL["attention_heads"]


def copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            copy_into(d, s)


class ReplayStandIn:
    """CPU stand-in for ``graphs.CudaGraph``: records the function at
    capture and replays it by running it again into the captured outputs,
    with no launch count of its own."""

    made = []

    def __init__(self, device):
        self.device = device
        self.replays = 0
        ReplayStandIn.made.append(self)

    def warm_up(self, run):
        run()

    def capture(self, run):
        self.run = run
        self.outputs = run()
        return self.outputs

    def replay(self):
        counts = collections.Counter(cuda_lib.launch_counts)
        with graphs.disable_capture():    # a replay runs no Python
            new = self.run()
        cuda_lib.launch_counts.clear()
        cuda_lib.launch_counts.update(counts)
        copy_into(self.outputs, new)
        self.replays += 1


@pytest.fixture
def stand_in(monkeypatch):
    """Capture calls on CPU tensors with ``ReplayStandIn``."""
    ReplayStandIn.made.clear()
    monkeypatch.setattr(graphs, "Graph", ReplayStandIn)
    monkeypatch.setattr(graphs, "CAPTURE_DEVICES", ("cpu",))
    return ReplayStandIn


def decoder(family="decoder", **kw):
    cfg = ModelConfig(model_type=family, **dict(MODEL, **kw))
    if family == "llama":
        return cfg, init_llama(3, cfg, device="cpu")
    return cfg, tt.init_decoder(3, cfg, device="cpu")


def step_tokens(n, b=2, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, MODEL["vocab_size"], (n, b)).astype(np.int32))


def eager_unless(captured):
    return contextlib.nullcontext() if captured else graphs.disable_capture()


def run_steps(step, params, cache, toks, **kw):
    out = []
    for t in toks:
        lg, hid, cache = step(params, t, cache, **kw)
        out.append((lg, hid))
    return out, cache


# ---------------------------------------------------------------------------
# the wrapper's bookkeeping
# ---------------------------------------------------------------------------


def test_cpu_calls_run_eagerly():
    """On the CPU (no stand-in) nothing is captured."""
    cfg, p = decoder()
    cache = tt.init_kv_cache(cfg, 2, device="cpu")
    tt.decoder_step(p, step_tokens(1)[0], cache, H)
    assert len(cache.graphs) == 0


@pytest.mark.parametrize("family", ["decoder", "llama"])
def test_replayed_steps_equal_eager(stand_in, family):
    """8 steps captured once and replayed equal 8 eager steps, outputs and
    cache; one graph, captured on the first call and replayed by every
    call."""
    cfg, p = decoder(family)
    step = (tt.decoder_step if family == "decoder" else llama_step)
    kw = dict(heads=H) if family == "decoder" else dict(
        heads=H, kv_heads=cfg.kv_heads, theta=cfg.rope_theta)
    toks = step_tokens(8)
    eager_cache = tt.init_kv_cache(cfg, 2, device="cpu")
    with graphs.disable_capture():
        want, eager_cache = run_steps(step, p, eager_cache, toks, **kw)
    assert len(eager_cache.graphs) == 0
    cache = tt.init_kv_cache(cfg, 2, device="cpu")
    got, cache = run_steps(step, p, cache, toks, **kw)
    assert len(cache.graphs) == 1 and len(stand_in.made) == 1
    assert stand_in.made[0].replays == 8
    for (lg, hid), (wl, wh) in zip(got, want):
        assert torch.equal(lg, wl) and torch.equal(hid, wh)
    assert torch.equal(cache.k, eager_cache.k)
    assert torch.equal(cache.v, eager_cache.v)
    # the warm-up ran the step: its cache column and idx were put back
    assert int(cache.idx) == 8 and cache.host_idx == 8


def test_outputs_are_fresh(stand_in):
    """Each call returns new tensors: a kept result is not overwritten by
    the next replay (jit returns new arrays)."""
    cfg, p = decoder()
    cache = tt.init_kv_cache(cfg, 2, device="cpu")
    toks = step_tokens(2)
    lg0, hid0, cache = tt.decoder_step(p, toks[0], cache, H)
    kept = lg0.clone()
    lg1, hid1, cache = tt.decoder_step(p, toks[1], cache, H)
    assert lg0.data_ptr() != lg1.data_ptr()
    assert torch.equal(lg0, kept) and not torch.equal(lg0, lg1)
    g = stand_in.made[0]
    assert all(o.data_ptr() not in (lg0.data_ptr(), lg1.data_ptr())
               for o in g.outputs)


def test_inputs_are_copied_state_is_not(stand_in):
    """A tensor argument is copied into the graph's own input before every
    replay (the caller's tensor is never written); the state tensors (the
    cache) are the captured storage, read and written in place."""
    cfg, p = decoder()
    cache = tt.init_kv_cache(cfg, 2, device="cpu")
    toks = step_tokens(3)
    first = toks[0].clone()
    tt.decoder_step(p, toks[0], cache, H)
    (entry,) = cache.graphs._graphs.values()
    (static_tokens,) = entry.inputs
    assert static_tokens.data_ptr() != toks[0].data_ptr()
    assert torch.equal(toks[0], first)
    assert {id(t) for t in (cache.k, cache.v, cache.idx)} <= {
        id(x) for x in entry.held}
    tt.decoder_step(p, toks[1], cache, H)
    assert torch.equal(static_tokens, toks[1])


def test_keys(stand_in):
    """A new graph for a new shape, static argument, cross K/V or not,
    cross valid lengths or not, or a new cache (state by identity); the
    same call again reuses its graph."""
    cfg, p = decoder()
    enc_cfg = ModelConfig(model_type="encoder-decoder", **MODEL)
    enc, dec = tt.init_encoder_decoder(4, enc_cfg, device="cpu")
    cache = tt.init_kv_cache(enc_cfg, 2, device="cpu")
    toks = step_tokens(6)
    src = step_tokens(5, b=2, seed=1).T.contiguous()        # (2, 5)
    cross = tt.build_cross_kv(dec, tt.encoder_forward(enc, src, H), H)
    assert len(enc.graphs) == 1 and len(dec.graphs) == 1
    vl = torch.tensor([3, 5], dtype=torch.int32)
    tt.decoder_step(dec, toks[0], cache, H)
    tt.decoder_step(dec, toks[1], cache, H, cross_kv=cross)
    tt.decoder_step(dec, toks[2], cache, H, cross_kv=cross,
                    cross_valid_len=vl)
    tt.decoder_step(dec, toks[3], cache, H, cross_kv=cross,
                    cross_valid_len=vl)
    assert len(cache.graphs) == 3
    owner = graphs.Graphs()                                 # static values
    for scale in (2, 3, 2, 2.0):
        got = graphs.call(owner, torch.mul, torch.ones(2), scale)
        assert torch.equal(got, torch.full((2,), float(scale)))
    assert len(owner) == 3
    tt.encoder_forward(enc, src[:, :4], H)                  # a new shape
    tt.encoder_forward(enc, src[:, :4], H)
    assert len(enc.graphs) == 2
    other = tt.init_kv_cache(cfg, 2, device="cpu")          # other state
    tt.decoder_step(p, toks[5], other, H)
    assert len(other.graphs) == 1


def test_disable_capture_runs_eagerly(stand_in):
    cfg, p = decoder()
    cache = tt.init_kv_cache(cfg, 2, device="cpu")
    toks = step_tokens(2)
    with graphs.disable_capture():
        with graphs.disable_capture():
            tt.decoder_step(p, toks[0], cache, H)
        tt.decoder_step(p, toks[1], cache, H)
    assert len(cache.graphs) == 0 and not stand_in.made
    tt.decoder_step(p, toks[0], cache, H)
    assert len(cache.graphs) == 1


def test_a_call_without_an_owner_raises(stand_in):
    with pytest.raises(ValueError, match="no Graphs"):
        graphs.call(None, torch.neg, torch.ones(2))
    assert torch.equal(graphs.call(graphs.Graphs(), torch.neg,
                                   torch.ones(2)), -torch.ones(2))


def test_a_failed_capture_raises_and_keeps_nothing(monkeypatch):
    """A capture that fails raises, and the owner keeps no graph: nothing
    falls back to running eagerly."""

    class Failing(ReplayStandIn):
        def capture(self, run):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    monkeypatch.setattr(graphs, "Graph", Failing)
    monkeypatch.setattr(graphs, "CAPTURE_DEVICES", ("cpu",))
    owner = graphs.Graphs()
    with pytest.raises(RuntimeError, match="capturing"):
        graphs.call(owner, torch.neg, torch.ones(2))
    assert len(owner) == 0


@pytest.mark.parametrize("fails", [False, True])
def test_cuda_capture_runs_without_garbage_collection(monkeypatch, fails):
    """``CudaGraph.capture`` turns the garbage collector off while the
    function runs under ``torch.cuda.graph`` (a dead cycle collected there
    can free CUDA objects with calls a capture forbids) and on again after,
    also when the capture fails; the CUDA contexts are stood in here."""
    import gc
    seen = []
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kw: contextlib.nullcontext())
    g = graphs.CudaGraph.__new__(graphs.CudaGraph)
    g.device, g.graph = torch.device("cuda", 0), None

    def run():
        seen.append(gc.isenabled())
        if fails:
            raise RuntimeError("capture failed")
        return "out"

    assert gc.isenabled()
    if fails:
        with pytest.raises(RuntimeError, match="capture failed"):
            g.capture(run)
    else:
        assert g.capture(run) == "out"
    assert seen == [False] and gc.isenabled()


def test_nested_calls_join_the_outer_graph(stand_in):
    """A captured function called inside another's warm-up or capture runs
    inline (its kernels join the outer graph) and captures nothing."""
    enc_cfg = ModelConfig(model_type="encoder-decoder", **MODEL)
    enc, dec = tt.init_encoder_decoder(4, enc_cfg, device="cpu")
    src = step_tokens(5, seed=2).T.contiguous()
    owner = graphs.Graphs()

    def both(enc, dec, src):
        return tt.build_cross_kv(dec, tt.encoder_forward(enc, src, H), H)

    got = graphs.call(owner, both, enc, dec, src)
    assert len(owner) == 1 and len(enc.graphs) == len(dec.graphs) == 0
    with graphs.disable_capture():
        want = both(enc, dec, src)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# (a) the cache-full check and host_idx under replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["decoder", "llama"])
def test_cache_full_raises_under_replay(stand_in, family):
    """(a) The host shell checks the room left and advances host_idx on
    every call, replayed or not: the step past max_seq_len raises, at the
    same step as eagerly."""
    cfg, p = decoder(family)
    step = tt.decoder_step if family == "decoder" else llama_step
    raised_at = {}
    for captured in (True, False):
        new_cache = (tt.init_kv_cache if family == "decoder"
                     else init_llama_kv_cache)
        cache = new_cache(cfg, 2, device="cpu")
        with eager_unless(captured):
            for i, t in enumerate(step_tokens(cfg.max_seq_len + 1)):
                try:
                    _, _, cache = step(p, t, cache, H)
                except IndexError as e:
                    assert "KV cache full" in str(e)
                    raised_at[captured] = i
                    break
                assert cache.host_idx == i + 1
        assert int(cache.idx) == cfg.max_seq_len
        assert len(cache.graphs) == int(captured)
    assert raised_at == {True: cfg.max_seq_len, False: cfg.max_seq_len}
    assert stand_in.made[0].replays == cfg.max_seq_len


def test_prefill_sets_host_idx_under_replay(stand_in):
    cfg, p = decoder()
    cache = tt.init_kv_cache(cfg, 2, device="cpu")
    prompt = step_tokens(3).T.contiguous()
    _, _, cache = tt.decoder_prefill(p, prompt, cache, H)
    assert cache.host_idx == 3 and int(cache.idx) == 3
    _, _, cache = tt.decoder_step(p, step_tokens(1)[0], cache, H)
    assert cache.host_idx == 4 and int(cache.idx) == 4
    with pytest.raises(IndexError, match="prompt of 9 tokens"):
        tt.decoder_prefill(p, step_tokens(9).T.contiguous(), cache, H)


# ---------------------------------------------------------------------------
# (b) launch counts added per replay
# ---------------------------------------------------------------------------


def fake_kernel(x):
    """Stands for a kernel's wrapper: one count where it launches."""
    cuda_lib.launch_counts["fake_kernel"] += 1
    return x * 2


def test_replays_add_the_captured_launches(stand_in):
    """(b) The warm-up's and the capture's launches are taken back out;
    every replay adds what the capture recorded, the first call's
    included."""
    owner = graphs.Graphs()
    cuda_lib.launch_counts.clear()

    def two_launches(x):
        return fake_kernel(fake_kernel(x))

    for n in range(1, 4):
        graphs.call(owner, two_launches, torch.ones(3))
        assert cuda_lib.launch_counts["fake_kernel"] == 2 * n
    (entry,) = owner._graphs.values()
    assert entry.launches == {"fake_kernel": 2}
    with graphs.disable_capture():
        graphs.call(owner, two_launches, torch.ones(3))
    assert cuda_lib.launch_counts["fake_kernel"] == 8


# ---------------------------------------------------------------------------
# (c) reset in place, (d) fixed buffers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def retriever():
    ds = synthetic_dataset(nb=3000, nq=8, nt=3000, d=D, seed=5,
                           n_clusters=16)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=D, nlist=16, m=8, list_pad=64),
                      xt=ds.xt, kmeans_iters=3, pq_iters=3, device="cpu")
    return ds, LocalRetriever(idx, SearchConfig(nprobe=4, k=4,
                                                use_approx_topk=False),
                              device="cpu")


def storage(loop):
    return [t.data_ptr() for t in (loop.tokens, loop.cache.k, loop.cache.v,
                                   loop.cache.idx)]


def test_reset_in_place_keeps_the_graphs(stand_in, retriever):
    """(c) A reset zeroes the cache and idx, sets host_idx to 0 and the
    tokens to 1, in the same storage: the run after it replays the graphs
    captured before it (no new capture) and repeats the first run."""
    _ds, r = retriever
    cfg, p = decoder()
    loop = RalmDecoder(p, cfg, r, 2, retrieval_interval=2, nprobe=4, k=4)
    before = storage(loop)
    loop.multi_steps(4)
    first = loop.tokens.clone(), loop.last_result.ids.clone()
    n_graphs = len(loop.cache.graphs), len(r.searcher.dev.graphs)
    assert n_graphs == (1, 1)
    loop.reset_inference_state()
    assert storage(loop) == before
    assert loop.cache.host_idx == 0 and int(loop.cache.idx) == 0
    assert not loop.cache.k.any() and not loop.cache.v.any()
    assert (loop.tokens == 1).all() and loop.step_count == 0
    made = len(stand_in.made)
    loop.multi_steps(4)
    assert len(stand_in.made) == made
    assert (len(loop.cache.graphs), len(r.searcher.dev.graphs)) == n_graphs
    assert torch.equal(loop.tokens, first[0])
    assert torch.equal(loop.last_result.ids, first[1])


@pytest.mark.parametrize("family", ["decoder", "encoder-decoder"])
def test_steps_write_fixed_buffers(stand_in, retriever, family):
    """(d) A step writes the next tokens into the token buffer and the
    cache in place (the buffers a replay reads); the enc-dec cross K/V is
    one pair of buffers, refilled in place by each retrieval step."""
    _ds, r = retriever
    if family == "decoder":
        cfg, p = decoder()
        loop = RalmDecoder(p, cfg, r, 2, retrieval_interval=2, nprobe=4, k=4)
    else:
        cfg = ModelConfig(model_type="encoder-decoder", **MODEL)
        loop = RalmEncoderDecoder(*tt.init_encoder_decoder(4, cfg,
                                                           device="cpu"),
                                  cfg, r, 2, retrieval_interval=2, nprobe=4,
                                  k=4)
    ids, ptrs, cross = id(loop.tokens), storage(loop), set()
    for _ in range(5):
        loop.single_step()
        assert id(loop.tokens) == ids and storage(loop) == ptrs
        if family == "encoder-decoder":
            cross.add(tuple(t.data_ptr() for t in loop.cross_kv))
    if family == "encoder-decoder":
        assert len(cross) == 1 and len(loop._cross.graphs) == 1


# ---------------------------------------------------------------------------
# captured loops against eager ones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["decoder", "llama", "encoder-decoder"])
def test_captured_loop_equals_eager(stand_in, retriever, family):
    """A fused RALM loop replaying its graphs gives the eager loop's tokens
    and retrievals at every step."""
    _ds, r = retriever
    if family == "encoder-decoder":
        cfg = ModelConfig(model_type=family, **MODEL)
        params = tt.init_encoder_decoder(4, cfg, device="cpu")

        def make():
            return RalmEncoderDecoder(*params, cfg, r, 2,
                                      retrieval_interval=3, nprobe=4, k=4)
    else:
        cfg, p = decoder(family)

        def make():
            return RalmDecoder(p, cfg, r, 2, retrieval_interval=3, nprobe=4,
                               k=4)
    runs = []
    made = len(stand_in.made)
    for captured in (True, False):
        loop = make()
        toks, res = [], []
        with eager_unless(captured):
            for _ in range(7):
                loop.single_step()
                toks.append(loop.tokens.clone())
                res.append(loop.last_result)
        runs.append((toks, res))
    (tc, rc), (te, re_) = runs
    assert all(torch.equal(a, b) for a, b in zip(tc, te))
    for a, b in zip(rc, re_):
        assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    assert len(stand_in.made) > made       # the captured run captured


def test_search_captured_equals_eager(stand_in, retriever):
    """ivfpq_search on every backend and ivfpq_search_preassigned, captured
    (one graph each, owned by the DeviceIVF) against eager."""
    ds, r = retriever
    s = r.searcher
    q = torch.from_numpy(ds.xq)
    base = dict(nprobe=4, k=4, seg=s.seg, windows=s.windows,
                scan_len=s.scan_len, use_approx=False)
    cases = [dict(backend="seg", group=8), dict(backend="seg", group=1),
             dict(backend="xla"), dict(backend="seg", group=8,
                                       lut_bf16=True)]
    lists = torch.from_numpy(np.random.default_rng(0).integers(
        0, 16, (len(ds.xq), 4)).astype(np.int32))
    n0 = len(s.dev.graphs)
    for kw in cases:
        got = ivfpq_search(s.dev, q, **base, **kw)
        with graphs.disable_capture():
            want = ivfpq_search(s.dev, q, **base, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), kw
    got = ivfpq_search_preassigned(s.dev, q, lists, **base)
    with graphs.disable_capture():
        want = ivfpq_search_preassigned(s.dev, q, lists, **base)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert len(s.dev.graphs) == n0 + len(cases) + 1
    # IVFSearcher.search: numpy in, numpy out, through the graphs
    d, i = s.search(ds.xq)
    assert len(s.dev.graphs) == n0 + len(cases) + 2
    with graphs.disable_capture():
        d_e, i_e = s.search(ds.xq)
    np.testing.assert_array_equal(d, d_e)
    np.testing.assert_array_equal(i, i_e)


@pytest.mark.parametrize("kind", ["decoder", "encoder-decoder"])
def test_tiktok_states_do_not_alias(stand_in, retriever, kind):
    """Two tik-tok states seeded with different first tokens, replaying
    their own graphs (the search's shared, its outputs fresh), each equal
    to a sequential loop run from the same tokens."""
    _ds, r = retriever
    seeds = {"tik": torch.tensor([5, 9], dtype=torch.int32),
             "tok": torch.tensor([17, 2], dtype=torch.int32)}
    if kind == "decoder":
        cfg, p = decoder()
        tik = TikTokDecoder(p, cfg, r, 2, retrieval_interval=1, nprobe=4, k=4)

        def twin():
            return RalmDecoder(p, cfg, r, 2, retrieval_interval=1, nprobe=4,
                               k=4)
    else:
        cfg = ModelConfig(model_type=kind, **MODEL)
        params = tt.init_encoder_decoder(4, cfg, device="cpu")
        tik = TikTokEncoderDecoder(*params, cfg, r, 2, retrieval_interval=2,
                                   nprobe=4, k=4)

        def twin():
            return RalmEncoderDecoder(*params, cfg, r, 2,
                                      retrieval_interval=2, nprobe=4, k=4)
    # enc-dec: two steps, one retrieval (this tiny model soon sends both
    # states to one token)
    steps = 5 if kind == "decoder" else 2
    for name, seed in seeds.items():
        tik.states[name].tokens.copy_(seed)
    tik.batch_inference(steps)
    assert tik.states["tik"].cache.graphs is not tik.states["tok"].cache.graphs
    for name, seed in seeds.items():
        seq = twin()
        seq.tokens.copy_(seed)
        with graphs.disable_capture():
            seq.multi_steps(steps)
        st = tik.states[name]
        assert torch.equal(st.tokens, seq.tokens), name
        assert torch.equal(st.last_result.ids, seq.last_result.ids), name
        assert torch.equal(st.last_result.dists, seq.last_result.dists)
        if kind != "decoder":
            assert all(torch.equal(a, b)
                       for a, b in zip(st.cross_kv, seq.cross_kv))
    # the two states hold different results (an alias would make them one)
    tik_st, tok_st = tik.states["tik"], tik.states["tok"]
    assert not torch.equal(tik_st.last_result.dists, tok_st.last_result.dists)
    if kind == "decoder":
        assert not torch.equal(tik_st.tokens, tok_st.tokens)
    else:
        assert not torch.equal(tik_st.cross_kv[0], tok_st.cross_kv[0])


def test_bench_warmup_reaches_every_graph(stand_in, monkeypatch):
    """The bench's warm-up captures every graph its timed steps replay,
    even with one warmup step (EncDec-S at interval 8: the timed steps'
    plain steps replay the decode graph of the retrieval step).  On the
    card a capture in the timed steps fails their sync check; here the
    stand-in counts the graphs made inside them."""
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    late = []

    @contextlib.contextmanager
    def timed(device):
        made = len(stand_in.made)
        yield
        late.append(len(stand_in.made) - made)

    monkeypatch.setattr(bench, "no_host_sync", timed)
    args = bench.parse_args(["--presets", "EncDec-S", "--interval", "8",
                             "--nb", "2048", "--nlist", "16", "--nprobe",
                             "4", "--batch", "2", "--warmup", "1",
                             "--steps", "9"])
    rows = list(bench.run(args, device="cpu", inspect=lambda p, i, loop: dict(
        cache_graphs=len(loop.cache.graphs))))
    assert late == [0] and rows[0]["cache_graphs"] == 1
    assert rows[0]["tok_per_s"] > 0
