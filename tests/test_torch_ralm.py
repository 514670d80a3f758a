"""The RALM serving slice on the CPU, chamjax_torch against chamjax: the
retrieved-token hash, ``StepProfiler``, ``LocalRetriever`` and
``DeviceRetriever`` over one ``PackedIVF`` (saved by chamjax, loaded by the
port), and the ``RalmDecoder`` (decoder and llama) and
``RalmEncoderDecoder`` loops over 8 steps with converted parameters.

Bars: the hash bit-equal; search distances ``rtol = atol = 1e-5`` and ids
equal except in the order of distance ties
(``chamjax_torch.eval.tie_mismatches``); the loops' tokens equal at every
step (f32 models, so no argmax sits on a rounding tie).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chamjax import models as jm
from chamjax.config import IndexConfig, ModelConfig, SearchConfig
from chamjax.data import synthetic_dataset
from chamjax.index import build_ivfpq
from chamjax.retrieval import interface as jinterface
from chamjax.retrieval import local as jlocal
from chamjax.searcher import DeviceIVF as JDeviceIVF
from chamjax.serving import profiling as jprofiling
from chamjax.serving import ralm as jralm

from chamjax_torch import config as tconfig
from chamjax_torch.eval import tie_mismatches
from chamjax_torch.index.ivf import PackedIVF as TPackedIVF
from chamjax_torch.models import transformer as tt
from chamjax_torch.models.convert import (decoder_from_numpy,
                                          encoder_from_numpy,
                                          llama_from_numpy)
from chamjax_torch.models.llama import init_llama
from chamjax_torch.retrieval import DeviceRetriever, DummyRetriever
from chamjax_torch.retrieval import LocalRetriever
from chamjax_torch.searcher import DeviceIVF, IVFSearcher
from chamjax_torch.serving import ralm as tralm
from chamjax_torch.serving.profiling import StepProfiler
from chamjax_torch.utils import cuda_lib

D = 64
SCFG = dict(nprobe=4, k=10, use_approx_topk=False)
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(embed_dim=D, ffn_embed_dim=128, layers=2, attention_heads=4,
             vocab_size=97, max_seq_len=16, dtype="float32")


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """One chamjax index at the models' hidden width (nb 4000, nlist 16),
    saved by chamjax and loaded by the port."""
    ds = synthetic_dataset(nb=4000, nq=16, nt=4000, d=D, seed=3,
                           n_clusters=16)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=D, nlist=16, m=8, list_pad=64),
                      xt=ds.xt, kmeans_iters=4, pq_iters=4)
    path = str(tmp_path_factory.mktemp("ralm") / "index.npz")
    idx.save(path)
    return ds, idx, TPackedIVF.load(path), path


@pytest.fixture(scope="module")
def retrievers(index):
    _ds, idx, tidx, _path = index
    return (jlocal.LocalRetriever(idx, SearchConfig(**SCFG)),
            LocalRetriever(tidx, tconfig.SearchConfig(**SCFG), device="cpu"))


def same_up_to_ties(d, i, d_ref, i_ref):
    d, i = np.asarray(d), np.asarray(i, np.int64)
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref, np.int64)
    np.testing.assert_allclose(d, d_ref, **TOL)
    bad = tie_mismatches(d, i, d_ref, i_ref, **TOL)
    assert not bad, bad


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# retrieved-token hash, profiler
# ---------------------------------------------------------------------------

HASH_IDS = np.array([[-1, 0, 1, 2 ** 31 - 1],
                     [-2 ** 31, 123456789, -7, 999_999]], np.int32)


def test_ids_to_tokens_matches_chamjax():
    ids = np.concatenate([HASH_IDS, np.random.default_rng(0).integers(
        0, 2 ** 31 - 1, (3, 4)).astype(np.int32)])
    for vocab in (97, 50000, 2):
        np.testing.assert_array_equal(
            tralm._ids_to_tokens(ids, 16, vocab),
            jralm._ids_to_tokens(ids, 16, vocab))


@pytest.mark.parametrize("vocab,tokens_per_doc", [(97, 8), (50000, 64),
                                                  (3, 5)])
def test_ids_to_tokens_device_bit_equal(vocab, tokens_per_doc):
    """JAX's uint32 wrapping hash, bit for bit, -1 (padding) included: an
    int64 hash without the reduction mod 2^32 gives other tokens."""
    rng = np.random.default_rng(vocab)
    ids = np.concatenate([HASH_IDS, rng.integers(
        -2 ** 31, 2 ** 31 - 1, (6, 4)).astype(np.int32)])
    want = np.asarray(jralm._ids_to_tokens_device(
        jnp.asarray(ids), tokens_per_doc, vocab))
    got = tralm._ids_to_tokens_device(torch.from_numpy(ids), tokens_per_doc,
                                      vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the uint32 product without 64-bit overflow, against Python integers
    x = torch.tensor([0, 1, 2 ** 32 - 1, 2 ** 31, 3_000_000_019],
                     dtype=torch.int64)
    np.testing.assert_array_equal(
        tralm._mul_u32(x, 2654435761).numpy(),
        [(int(v) * 2654435761) % 2 ** 32 for v in x])


def test_step_profiler_matches_chamjax():
    times = {"time_model": [0.004, 0.002, 0.003, 0.010],
             "time_retriever": [0.001, 0.0, 0.002, 0.0],
             "time_step": [0.006, 0.003, 0.005, 0.011]}
    profs = (StepProfiler(), jprofiling.StepProfiler())
    for prof in profs:
        for name, ts in times.items():
            getattr(prof, name).extend(ts)
    for warmup in (0, 1):
        assert profs[0].stats(64, warmup) == profs[1].stats(64, warmup)
    got, want = profs[0].get_profiling(), profs[1].get_profiling()
    for name in times:
        np.testing.assert_array_equal(got[name], want[name])
    profs[0].reset()
    assert profs[0].stats() == {}
    with profs[0].step_span(), profs[0].model_span():
        pass
    assert len(profs[0].time_step) == 1 and profs[0].time_step[0] >= 0


# ---------------------------------------------------------------------------
# retrievers
# ---------------------------------------------------------------------------


def test_local_retriever_matches_chamjax(index, retrievers):
    ds, _idx, _tidx, _path = index
    jr, tr = retrievers
    cuda_lib.launch_counts.clear()
    want = jr.retrieve(ds.xq, 4, 10)
    got = tr.retrieve(ds.xq, 4, 10)
    assert got.ids.dtype == np.int64
    same_up_to_ties(got.dists, got.ids, want.dists, want.ids)
    # the fused path: tensors in, tensors out, on the index's device
    got_d = tr.retrieve_device(torch.from_numpy(ds.xq), 4, 10)
    want_d = jr.retrieve_device(jnp.asarray(ds.xq), 4, 10)
    assert isinstance(got_d.ids, torch.Tensor)
    assert got_d.ids.device.type == "cpu" and got_d.ids.dtype == torch.int32
    same_up_to_ties(got_d.dists.numpy(), got_d.ids.numpy(),
                    np.asarray(want_d.dists), np.asarray(want_d.ids))
    # the preassigned split: externally chosen lists
    lists = np.random.default_rng(1).integers(0, 16, (len(ds.xq), 4))
    got_l = tr.retrieve_with_lists(ds.xq, lists, 10)
    want_l = jr.retrieve_with_lists(ds.xq, lists, 10)
    same_up_to_ties(got_l.dists, got_l.ids, want_l.dists, want_l.ids)
    assert cuda_lib.launch_counts["adc_scan_tiles"] == 0   # CPU: plain path


def test_from_file_loads_chamjax_index(index):
    ds, _idx, tidx, path = index
    r = LocalRetriever.from_file(path, tconfig.SearchConfig(**SCFG),
                                 device="cpu")
    np.testing.assert_array_equal(r.searcher.packed.codes, tidx.codes)
    assert r.searcher.device.type == "cpu"


def test_retrieve_device_resizes_windows_with_nprobe(index):
    """An nprobe override resizes the window budget (as search does); a
    budget sized for scfg.nprobe would truncate the scan."""
    ds, idx, tidx, _path = index
    small = dict(SCFG, nprobe=2)
    tr = LocalRetriever(tidx, tconfig.SearchConfig(**small), device="cpu")
    jr = jlocal.LocalRetriever(idx, SearchConfig(**small))
    got = tr.retrieve_device(torch.from_numpy(ds.xq), 16, 10)
    want = jr.retrieve_device(jnp.asarray(ds.xq), 16, 10)
    ref = IVFSearcher(tidx, tconfig.SearchConfig(**dict(SCFG, nprobe=16)),
                      device="cpu").search(ds.xq)
    assert tr.searcher._windows(16) > tr.searcher.windows
    same_up_to_ties(got.dists.numpy(), got.ids.numpy(), *ref)
    same_up_to_ties(got.dists.numpy(), got.ids.numpy(),
                    np.asarray(want.dists), np.asarray(want.ids))


def test_set_nprobe_keeps_searcher_kwargs(index):
    """set_nprobe rebuilds the searcher with the constructor's kwargs:
    dropping device="cpu" would move the index to the card (or raise)."""
    _ds, _idx, tidx, _path = index
    r = LocalRetriever(tidx, tconfig.SearchConfig(**SCFG), scan_quantile=0.5,
                       device="cpu")
    r.set_nprobe(8)
    want = IVFSearcher(tidx, tconfig.SearchConfig(**dict(SCFG, nprobe=8)),
                       scan_quantile=0.5, device="cpu")
    assert r.searcher.scfg.nprobe == 8
    assert r.searcher.device.type == "cpu"
    assert r.searcher.scan_len == want.scan_len
    assert r.searcher.windows == want.windows


def test_device_retriever_matches_chamjax(index):
    """DeviceRetriever over a tiled DeviceIVF: seg from the tiles, results
    equal to chamjax's DeviceRetriever on the same index."""
    ds, idx, tidx, _path = index
    seg = 256
    tdev = DeviceIVF.from_packed(tidx, device="cpu", tile_seg=seg)
    tr = DeviceRetriever(tdev, tidx.list_len, tconfig.SearchConfig(**SCFG),
                         device="cpu")
    jr = jlocal.DeviceRetriever(JDeviceIVF.from_packed(idx, tile_seg=seg),
                                idx.list_len, SearchConfig(**SCFG))
    assert tr.seg == jr.seg == seg and tr.windows == jr.windows
    for nprobe in (4, 8):
        got = tr.retrieve(ds.xq, nprobe, 10)
        want = jr.retrieve(ds.xq, nprobe, 10)
        assert got.ids.dtype == np.int64
        same_up_to_ties(got.dists, got.ids, want.dists, want.ids)
        got_d = tr.retrieve_device(torch.from_numpy(ds.xq), nprobe, 10)
        same_up_to_ties(got_d.dists.numpy(), got_d.ids.numpy(), want.dists,
                        want.ids)


def test_device_retriever_checks_backend_and_device(index):
    _ds, _idx, tidx, _path = index
    tdev = DeviceIVF.from_packed(tidx, device="cpu", tile_seg=256)
    with pytest.warns(UserWarning, match="backend='seg'"):
        DeviceRetriever(tdev, tidx.list_len,
                        tconfig.SearchConfig(backend="xla"), device="cpu")
    with pytest.raises(ValueError, match="index on cpu"):
        DeviceRetriever(tdev, tidx.list_len, device="meta")


def test_entry_points_raise_without_a_card(index):
    """With no card and no explicit CPU device every entry point raises;
    none carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    _ds, _idx, tidx, _path = index
    cfg = tconfig.ModelConfig(**MODEL)
    tdev = DeviceIVF.from_packed(tidx, device="cpu", tile_seg=256)
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    for call in (lambda: LocalRetriever(tidx),
                 lambda: DeviceRetriever(tdev, tidx.list_len),
                 lambda: tt.init_decoder(0, cfg),
                 lambda: tt.init_encoder_decoder(0, cfg),
                 lambda: tt.init_kv_cache(cfg, 2),
                 lambda: init_llama(0, dataclasses.replace(
                     cfg, model_type="llama")),
                 lambda: decoder_from_numpy({}, cfg),
                 lambda: next(bench.run(bench.parse_args(["--nb", "1000"])))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# RALM loops
# ---------------------------------------------------------------------------


class Recording:
    """A fused-path retriever that keeps every result it returns."""

    def __init__(self, inner):
        self.inner = inner
        self.results = []

    def retrieve_device(self, queries, nprobe, k):
        res = self.inner.retrieve_device(queries, nprobe, k)
        self.results.append(res)
        return res


def f32_tree(p):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def decoder_models(family):
    kw = dict(MODEL, model_type=family)
    if family == "llama":
        kw.update(ffn_embed_dim=160, kv_heads=2)
    jcfg, tcfg = ModelConfig(**kw), tconfig.ModelConfig(**kw)
    if family == "llama":
        p = jm.init_llama(jax.random.PRNGKey(1), jcfg)
        return jcfg, tcfg, p, llama_from_numpy(f32_tree(p), tcfg,
                                               device="cpu")
    p = jm.init_decoder(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, p, decoder_from_numpy(f32_tree(p), tcfg, device="cpu")


def check_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        same_up_to_ties(g.dists.numpy(), g.ids.numpy(), np.asarray(w.dists),
                        np.asarray(w.ids))


@pytest.mark.parametrize("interval", [2, 4])
@pytest.mark.parametrize("family", ["decoder", "llama"])
def test_ralm_decoder_matches_chamjax(retrievers, family, interval):
    """8 fused steps over one index: the same token at every step, the same
    retrieval (up to ties) at every retrieval step."""
    jr, tr = (Recording(r) for r in retrievers)
    jcfg, tcfg, p, tp = decoder_models(family)
    jloop = jralm.RalmDecoder(p, jcfg, jr, 3, retrieval_interval=interval,
                              nprobe=4, k=10)
    tloop = tralm.RalmDecoder(tp, tcfg, tr, 3, retrieval_interval=interval,
                              nprobe=4, k=10)
    assert tloop._device_path
    cuda_lib.launch_counts.clear()
    for _ in range(8):
        jloop.single_step()
        tloop.single_step()
        np.testing.assert_array_equal(tloop.tokens.numpy(),
                                      np.asarray(jloop.tokens))
        check_results(tr.results, jr.results)
    assert len(tr.results) == 8 // interval
    assert tloop.last_result is tr.results[-1]
    assert int(tloop.cache.idx) == 8 and tloop.cache.host_idx == 8
    assert cuda_lib.launch_counts["adc_scan_tiles"] == 0
    prof = tloop.get_profiling()
    assert len(prof["time_step"]) == len(prof["time_retriever"]) == 8
    assert (prof["time_retriever"][1::interval] == 0).all()
    tloop.reset_inference_state()
    tloop.batch_inference(4)
    assert tloop.step_count == 4 and tloop.throughput_tokens_per_sec(4) > 0


@pytest.mark.parametrize("interval", [2, 4])
def test_ralm_encoder_decoder_matches_chamjax(retrievers, interval):
    jr, tr = (Recording(r) for r in retrievers)
    kw = dict(MODEL, model_type="encoder-decoder", encoder_layers=2)
    jcfg, tcfg = ModelConfig(**kw), tconfig.ModelConfig(**kw)
    enc, dec = jm.init_encoder_decoder(jax.random.PRNGKey(2), jcfg)
    tenc = encoder_from_numpy(f32_tree(enc), tcfg, device="cpu")
    tdec = decoder_from_numpy(f32_tree(dec), tcfg, device="cpu")
    jloop = jralm.RalmEncoderDecoder(enc, dec, jcfg, jr, 3,
                                     retrieval_interval=interval, nprobe=4,
                                     k=10)
    tloop = tralm.RalmEncoderDecoder(tenc, tdec, tcfg, tr, 3,
                                     retrieval_interval=interval, nprobe=4,
                                     k=10)
    for step in range(8):
        jloop.single_step()
        tloop.single_step()
        np.testing.assert_array_equal(tloop.tokens.numpy(),
                                      np.asarray(jloop.tokens))
        check_results(tr.results, jr.results)
        if step % interval == 0:
            # the retrieved tokens the cross K/V is built from
            want = jralm._ids_to_tokens_device(
                jnp.asarray(jr.results[-1].ids), tcfg.retrieval_token_len,
                tcfg.vocab_size)
            got = tralm._ids_to_tokens_device(
                tr.results[-1].ids, tcfg.retrieval_token_len,
                tcfg.vocab_size)
            if np.array_equal(tr.results[-1].ids.numpy(),
                              np.asarray(jr.results[-1].ids)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_allclose(tloop.cross_kv[0].numpy(),
                                       np.asarray(jloop.cross_kv[0]),
                                       rtol=2e-4, atol=2e-4)
    assert len(tr.results) == 8 // interval
    assert tloop.cross_kv[0].shape == (tcfg.layers, 3, tcfg.max_seq_len, 4,
                                       16)


def test_ralm_host_path_with_dummy_retriever():
    """A retriever without retrieve_device takes the host path (numpy
    queries, numpy ids → host token synthesis), as in chamjax."""
    jcfg, tcfg, p, tp = decoder_models("decoder")
    jloop = jralm.RalmDecoder(p, jcfg, jinterface.DummyRetriever(), 2,
                              retrieval_interval=2)
    tloop = tralm.RalmDecoder(tp, tcfg, DummyRetriever(), 2,
                              retrieval_interval=2)
    assert not tloop._device_path
    kw = dict(MODEL, model_type="encoder-decoder")
    ejcfg, etcfg = ModelConfig(**kw), tconfig.ModelConfig(**kw)
    enc, dec = jm.init_encoder_decoder(jax.random.PRNGKey(3), ejcfg)
    ejloop = jralm.RalmEncoderDecoder(enc, dec, ejcfg,
                                      jinterface.DummyRetriever(), 2)
    etloop = tralm.RalmEncoderDecoder(
        encoder_from_numpy(f32_tree(enc), etcfg, device="cpu"),
        decoder_from_numpy(f32_tree(dec), etcfg, device="cpu"), etcfg,
        DummyRetriever(), 2)
    for j, t in ((jloop, tloop), (ejloop, etloop)):
        j.batch_inference(4)
        t.batch_inference(4)
        np.testing.assert_array_equal(as_np(t.tokens), np.asarray(j.tokens))
        assert len(t.get_profiling()["time_step"]) == 4
    np.testing.assert_array_equal(tloop.last_result.ids,
                                  jloop.last_result.ids)


def test_bench_runs_on_cpu_at_a_tiny_size():
    """The bench end to end on the CPU: the full-width presets over a tiny
    index, two timed steps each, ``inspect`` seeing each loop."""
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    args = bench.parse_args(["--presets", "Dec-S,Llama-S", "--nb", "2048",
                             "--nlist", "16", "--nprobe", "4", "--batch",
                             "2", "--warmup", "1", "--steps", "2"])
    assert bench.model_configs(args)["Llama-S"].max_seq_len == 2 + 1 + 8
    rows = list(bench.run(args, device="cpu", inspect=lambda preset, i, loop:
                          dict(cached=int(loop.cache.idx))))
    assert [r["preset"] for r in rows] == ["Dec-S", "Llama-S"]
    for r in rows:
        assert r["cached"] == 2 and r["tok_per_s"] > 0 and r["card"] == "cpu"
        assert r["launches_adc_scan_tiles"] == 0     # CPU: the plain path
        assert not r["no_host_sync_checked"]
    with pytest.raises(ValueError, match="embed_dim"):
        bench.model_configs(bench.parse_args(["--presets", "Dec-S,Dec-L"]))


STREAMED_LEGS = {
    # Dec-S at full width: one easy draw chunk is 131072 rows of 512
    "streamed": ("Dec-S", ["--nb", "131072"]),
    "streamed_balance": ("Dec-S", ["--nb", "131072", "--balance", "1.3"]),
    # the hard stream draws 2^20-row chunks: a narrow decoder keeps a
    # chunk at 128 MB
    "streamed_hard_balance": ("Dec-T", ["--nb", "1048576", "--hard",
                                        "--balance", "1.3"]),
}


@pytest.mark.parametrize("leg", sorted(STREAMED_LEGS))
def test_bench_streamed_legs_run_on_cpu(leg, monkeypatch):
    """``--streamed`` (the clustered stream), with ``--balance`` and with
    ``--hard``: the corpus drawn and built by the streamed device builder
    into a tile-only index behind a ``DeviceRetriever`` at the seg
    ``auto_seg`` picks, then two timed steps; the fused retrievals equal
    the retriever's own search of the same hidden states."""
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    from chamjax_torch.config import MODEL_PRESETS, ModelConfig
    monkeypatch.setitem(MODEL_PRESETS, "Dec-T", ModelConfig(
        model_type="decoder", embed_dim=32, ffn_embed_dim=64, layers=2,
        attention_heads=2, vocab_size=512))
    preset, flags = STREAMED_LEGS[leg]
    args = bench.parse_args(["--streamed", "--preset", preset, "--nlist",
                             "16", "--nprobe", "4", "--batch", "2",
                             "--warmup", "1", "--steps", "2"] + flags)

    class Recorder:            # the built retriever, keeping its queries
        def __init__(self, inner):
            self.inner, self.queries = inner, None

        def retrieve_device(self, queries, nprobe, k):
            self.queries = queries.clone()
            return self.inner.retrieve_device(queries, nprobe, k)

    build = bench.build_streamed_retriever
    monkeypatch.setattr(bench, "build_streamed_retriever",
                        lambda *a: Recorder(build(*a)))
    # two k-means, PQ and balanced-Lloyd iterations (the bench runs 8, 8
    # and 12): CPU time, not what the leg exercises
    builder = bench.build_ivfpq_device
    monkeypatch.setattr(bench, "build_ivfpq_device", lambda draw, n, cfg, *a,
                        **kw: builder(draw, n, dataclasses.replace(
                            cfg, balance_train_iters=2), *a,
                            **dict(kw, kmeans_iters=2, pq_iters=2)))

    def inspect(preset, interval, loop):
        r = loop.retriever.inner
        res = r.retrieve_device(loop.retriever.queries, args.nprobe, args.k)
        return dict(retriever=type(r).__name__, seg=r.seg,
                    tiled=r.dev.codes_t is None,
                    lens=r.list_len.copy(),
                    same=bool(np.array_equal(np.asarray(res.ids),
                                             np.asarray(
                                                 loop.last_result.ids))))
    rows = list(bench.run(args, device="cpu", inspect=inspect))
    assert len(rows) == 1
    r = rows[0]
    assert r["retriever"] == "DeviceRetriever" and r["tiled"]
    nb = args.nb
    assert r["seg"] == bench.auto_seg(np.full(16, nb // 16))
    assert r["tok_per_s"] > 0
    assert r["same"]
    lens = r["lens"]
    assert lens.sum() == nb
    if "--balance" in flags:
        assert lens.max() <= int(np.ceil(nb / 16 * 1.3))


@pytest.mark.parametrize("flags,gen", [(["--hard"], 1 << 20),
                                       ([], (1 << 26) // 32)])
def test_bench_streamed_refuses_a_corpus_under_one_chunk(flags, gen,
                                                         monkeypatch):
    """``--nb`` rounds down to whole draw chunks; below one chunk the
    reference's bench goes on with 0 rows (its default ``--nb 1000000``
    with ``--hard``), the port's raises before it draws."""
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    args = bench.parse_args(["--streamed", "--nb", str(gen - 1),
                             "--nlist", "16"] + flags)
    with pytest.raises(ValueError, match="at least one draw chunk"):
        bench.build_streamed_retriever(args, 32, torch.device("cpu"))
