"""The port's spans on the CPU (``chamjax_torch/utils/tracing.py``) and
the benchmark's readers of them (``portbench/spans.py``,
``portbench/metrics``).

- with no profiler, ``annotate`` is one shared null context and builds no
  ``record_function`` (``StepProfiler`` and ``StageTimer`` go through it);
- under ``tracing.trace`` the host and stage spans of a search and of a
  RALM step are ranges, nested as the layers are;
- ``StepProfiler`` on a card's fused path times a step between CUDA
  events at the step ends (the events are stood in here);
- each new reader on a hand-made ``Trace``: the split of a replay by its
  stage map, the division by batches, steps or refills, and None where a
  replay's activities do not number its map's total or there is nothing
  to read.  The stage maps themselves are in ``test_torch_graphs.py``, the
  card's side in ``test_torch_gpu.py``.
"""

import json
from types import SimpleNamespace

import pytest
import torch

from chamjax_torch.config import IndexConfig, ModelConfig, SearchConfig
from chamjax_torch.data import synthetic_dataset
from chamjax_torch.index import build_ivfpq
from chamjax_torch.models import transformer as tt
from chamjax_torch.rag.pipeline import StageTimer
from chamjax_torch.retrieval import LocalRetriever
from chamjax_torch.serving.profiling import StepProfiler
from chamjax_torch.serving.ralm import RalmDecoder, RalmEncoderDecoder
from chamjax_torch.utils import tracing
from portbench import spans
from portbench.spec import Registry
from portbench.trace import Trace

D = 32
MODEL = dict(embed_dim=D, ffn_embed_dim=64, layers=2, attention_heads=4,
             vocab_size=61, max_seq_len=8, dtype="float32", k=4,
             retrieval_token_len=3)
SEARCH_STAGES = ("search.coarse", "search.lut", "search.windows",
                 "search.pack", "search.scan", "search.topk")


def _raise(*args, **kwargs):
    raise AssertionError("record_function built with no profiler running")


def test_annotate_without_a_profiler_builds_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    a, b = tracing.annotate("a"), tracing.annotate("b")
    assert a is b
    with a, b:
        pass
    prof = StepProfiler()
    with prof.step_span(), prof.model_span():
        with prof.retriever_span():
            pass
    assert [len(x) for x in (prof.time_step, prof.time_model,
                             prof.time_retriever)] == [1, 1, 1]
    timer = StageTimer()
    with timer.span("retrieval"):
        pass
    assert len(timer.times["retrieval"]) == 1


@pytest.fixture(scope="module")
def retriever():
    ds = synthetic_dataset(nb=3000, nq=8, nt=3000, d=D, seed=5,
                           n_clusters=16)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=D, nlist=16, m=8, list_pad=64),
                      xt=ds.xt, kmeans_iters=3, pq_iters=3, device="cpu")
    return ds, LocalRetriever(idx, SearchConfig(nprobe=4, k=4),
                              device="cpu")


def _ranges(path):
    """The trace's ``user_annotation`` ranges: ``[(name, start, end)]``
    in start order."""
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("cat") == "user_annotation"),
                  key=lambda r: r[1])


def _traced(tmp_path, fn):
    with tracing.trace(str(tmp_path)):
        fn()
    (path,) = tmp_path.glob("*.pt.trace.json")
    return _ranges(path)


def _inside(ranges, outer, inner):
    """Every ``inner`` range lies inside an ``outer`` one; their count."""
    outs = [(s, e) for n, s, e in ranges if n == outer]
    ins = [(s, e) for n, s, e in ranges if n == inner]
    assert all(any(os_ <= s and e <= oe for os_, oe in outs)
               for s, e in ins), (outer, inner)
    return len(ins)


def test_search_spans_nest_under_the_profiler(retriever, tmp_path):
    ds, r = retriever
    q = torch.from_numpy(ds.xq[:4])
    ranges = _traced(tmp_path, lambda: r.retrieve_device(q, 4, 4))
    assert [n for n, _, _ in ranges if n.startswith("search.")] == list(
        SEARCH_STAGES)
    for stage in SEARCH_STAGES:
        assert _inside(ranges, "retrieve", stage) == 1


@pytest.mark.parametrize("enc_dec", [False, True])
def test_ralm_step_spans_nest_under_the_profiler(retriever, tmp_path,
                                                 enc_dec):
    """A fused RALM retrieval step: ``ralm.step`` holds ``ralm.model`` and
    ``ralm.retrieve``; the retriever's ``retrieve`` and the search's stages
    sit in ``ralm.retrieve``, the decode step's ``decode.attend`` (and
    ``decode.cross``) a layer in ``ralm.model``, and the encoder-decoder's
    ``ralm.refill`` in ``ralm.model``, with an ``encode.attend`` an encoder
    layer for the query encoder and for the refill."""
    _, r = retriever
    kw = dict(MODEL, model_type="encoder-decoder" if enc_dec else "decoder",
              encoder_layers=1)
    cfg = ModelConfig(**kw)
    if enc_dec:
        enc, dec = tt.init_encoder_decoder(2, cfg, device="cpu")
        loop = RalmEncoderDecoder(enc, dec, cfg, r, 2, retrieval_interval=2,
                                  nprobe=4, k=4)
    else:
        loop = RalmDecoder(tt.init_decoder(2, cfg, device="cpu"), cfg, r, 2,
                           retrieval_interval=2, nprobe=4, k=4)
    ranges = _traced(tmp_path, loop.single_step)
    assert _inside(ranges, "ralm.step", "ralm.model") == (3 if enc_dec
                                                          else 1)
    assert _inside(ranges, "ralm.step", "ralm.retrieve") == 1
    assert _inside(ranges, "ralm.retrieve", "retrieve") == 1
    assert _inside(ranges, "retrieve", "search.scan") == 1
    assert _inside(ranges, "ralm.model", "decode.attend") == cfg.layers
    assert _inside(ranges, "ralm.model", "decode.cross") == (
        cfg.layers if enc_dec else 0)
    assert _inside(ranges, "ralm.model", "ralm.refill") == int(enc_dec)
    assert _inside(ranges, "ralm.model", "encode.attend") == 2 * int(enc_dec)
    assert len(loop.get_profiling()["time_step"]) == 1


class _Clock:
    now = 0.0           # ms


class _FakeEvent:
    """A CUDA event stood in: ``record`` reads the fake clock."""

    made = 0

    def __init__(self, enable_timing=False):
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = _Clock.now

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_step_profiler_times_steps_between_step_end_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    _FakeEvent.made = 0
    prof = StepProfiler(torch.device("cuda", 0))
    assert StepProfiler(torch.device("cpu")).device is None

    def steps(gaps_ms):
        for gap in gaps_ms:
            with prof.step_span():
                _Clock.now += gap       # the card's time for the step

    steps([5.0, 7.0, 4.0])
    assert prof.time_step == []                     # resolved on demand
    assert prof.get_profiling()["time_step"] == pytest.approx(
        [0.005, 0.007, 0.004])
    _Clock.now += 100.0                             # the host waits
    steps([2.0])
    assert prof.stats(8)["steps"] == 4
    assert prof.time_step[-1] == pytest.approx(0.102)   # gap to the last end
    prof.reset()
    steps([3.0, 1.0])
    assert prof.get_profiling()["time_step"] == pytest.approx([0.003, 0.001])
    assert _FakeEvent.made == 4          # events reused, also after a reset


# ---------------------------------------------------------------------------
# the readers, on hand-made traces
# ---------------------------------------------------------------------------


def _replays(fn, runs, starts, durs, corr0=1, spacing=1000.0):
    """A trace piece: one replay of ``fn``'s graph at each of ``starts``
    (host µs), each with the activities ``durs`` in capture order,
    shuffled in the list; the replay range's name carries ``runs``."""
    name = "chamjax.graph " + fn + ": " + ", ".join(
        f"{s} {n}" for s, n in runs)
    ranges, runtime, device = {name: []}, [], []
    for j, s in enumerate(starts):
        corr = corr0 + j
        ranges[name].append((s, 5.0))
        runtime.append(("cudaGraphLaunch", s + 1.0, 3.0, corr))
        t, acts = s + 10.0, []
        for i, d in enumerate(durs):
            acts.append((f"k{i}", t, d, corr))
            t += d + 0.5
        device += acts[::-1]
    return ranges, runtime, device


def _trace(ranges, runtime, device, window=(0.0, 1e6)):
    return Trace(window=window, device=device, runtime=runtime,
                 ranges=ranges)


def _read(metric, kind, t, counts=None):
    ctx = SimpleNamespace(kind=kind, trace=t, counts=counts or {},
                          cfg={}, traffic={})
    return Registry().reader(metric)(ctx)


SEARCH_RUNS = [("search.coarse", 2), ("search.lut", 3), ("search.pack", 1),
               ("search.windows", 2), ("search.scan", 1),
               ("search.topk", 2), ("ivfpq_search", 1)]
SEARCH_DURS = [1.0, 2.0, 10.0, 20.0, 30.0, 5.0, 3.0, 4.0, 40.0, 6.0, 7.0,
               0.5]


def test_search_stage_readers_divide_by_batches():
    t = _trace(*_replays("ivfpq_search", SEARCH_RUNS, [0.0, 2000.0, 4000.0],
                         SEARCH_DURS))
    assert _read("lut_ms.search", "search", t) == pytest.approx(0.065)
    assert _read("windows_ms.search", "search", t) == pytest.approx(0.007)
    assert _read("topk_ms.search", "search", t) == pytest.approx(0.013)
    (split,) = {tuple((s, len(a)) for s, a in runs)
                for _, runs in spans.split_replays(t, "ivfpq_search")}
    assert split == tuple(SEARCH_RUNS)
    assert _read("lut_ms.search", "ralm", t) is None    # not its cell


def test_stage_readers_leave_out_a_replay_off_its_map():
    """A replay whose activities do not number its map's total (a record
    the profiler lost, one too many, no launch in its range) is not split
    but left out; under half the replays whole, the reader says None."""
    good = _replays("ivfpq_search", SEARCH_RUNS, [0.0, 2000.0], SEARCH_DURS)
    slow = _replays("ivfpq_search", SEARCH_RUNS, [4000.0, 6000.0],
                    [10 * d for d in SEARCH_DURS], corr0=10)
    ranges = {k: good[0][k] + slow[0][k] for k in good[0]}
    runtime = good[1] + slow[1]
    lost_one = [a for a in slow[2] if a[3] != 10 or a[0] != "k3"]
    extra = [a for a in lost_one if a[3] == 11] + [("k0", 9000.0, 1.0, 11)]
    t = _trace(ranges, runtime, good[2] + lost_one + extra)
    reps = spans.split_replays(t, "ivfpq_search")
    assert [runs is None for _, runs in reps] == [False, False, True, True]
    for metric, want in (("lut_ms.search", 0.065),
                         ("windows_ms.search", 0.007),
                         ("topk_ms.search", 0.013)):
        assert _read(metric, "search", t) == pytest.approx(want)
    t = _trace(ranges, runtime, good[2][1:] + lost_one + extra)
    assert _read("lut_ms.search", "search", t) is None      # 1 of 4 whole
    t = _trace(good[0], good[1][1:], good[2])   # a range with no launch
    assert [runs is None for _, runs in
            spans.split_replays(t, "ivfpq_search")] == [True, False]
    assert _read("lut_ms.search", "search", t) == pytest.approx(0.065)
    assert _read("lut_ms.search", "search", _trace({}, [], [])) is None
    assert _read("lut_ms.search", "search", None) is None
    # a trace of a program without stage maps: device work, no map
    assert _read("lut_ms.search", "search",
                 _trace({}, good[1], good[2])) is None


def test_attend_reader_divides_by_steps():
    runs = [("_decoder_step", 2), ("decode.attend", 2), ("_decoder_step", 1),
            ("decode.cross", 1), ("_decoder_step", 1), ("decode.attend", 2),
            ("_decoder_step", 1), ("decode.cross", 1), ("_decoder_step", 2)]
    durs = [1.0, 1.0, 100.0, 200.0, 1.0, 50.0, 1.0, 300.0, 400.0, 1.0, 60.0,
            1.0, 1.0]
    search = _replays("ivfpq_search", SEARCH_RUNS, [500.0], SEARCH_DURS,
                      corr0=50)
    step = _replays("_decoder_step", runs, [0.0, 1000.0, 2000.0, 3000.0],
                    durs)
    t = _trace({**search[0], **step[0]}, search[1] + step[1],
               search[2] + step[2])
    assert _read("attend_ms.ralm", "ralm", t) == pytest.approx(1.11)
    assert _read("attend_ms.ralm", "search", t) is None
    one_lost = _trace(step[0], step[1], step[2][:-1])
    assert _read("attend_ms.ralm", "ralm", one_lost) == pytest.approx(1.11)
    three_lost = [a for a in step[2] if a[3] == 4 or a[0] != "k5"]
    assert _read("attend_ms.ralm", "ralm",
                 _trace(step[0], step[1], three_lost)) is None


def test_refill_reader_divides_by_refills():
    ranges = {"ralm.refill": [(100.0, 20.0), (900.0, 20.0)],
              "ralm.model": [(90.0, 40.0)]}
    runtime = [("cudaMemcpyAsync", 105.0, 2.0, 1),
               ("cudaGraphLaunch", 110.0, 3.0, 2),
               ("cudaGraphLaunch", 905.0, 3.0, 3),
               ("cudaGraphLaunch", 2000.0, 3.0, 4)]      # a decode step
    device = [("copy", 120.0, 1.0, 1), ("enc", 121.0, 300.0, 2),
              ("kv", 421.0, 99.0, 2), ("enc", 921.0, 380.0, 3),
              ("step", 2010.0, 900.0, 4)]
    t = _trace(ranges, runtime, device)
    assert _read("refill_ms.ralm", "ralm", t) == pytest.approx(0.39)
    del ranges["ralm.refill"]                       # a decoder-only loop
    assert _read("refill_ms.ralm", "ralm", t) is None


def test_encode_attend_reader_divides_by_refills():
    """The ``encode.attend`` runs of each whole refill replay, a refill: 0.24
    ms here (100 + 140 µs); a refill map with no such run (a program whose
    encoder opens no span) and a decoder-only cell give nothing."""
    runs = [("_fill_cross_kv_from_ids", 2), ("_encoder_forward", 3),
            ("encode.attend", 1), ("_encoder_forward", 2),
            ("encode.attend", 1), ("_encoder_forward", 1),
            ("_build_cross_kv", 2), ("_fill_cross_kv_from_ids", 1)]
    durs = [5.0, 1.0, 2.0, 3.0, 4.0, 100.0, 6.0, 7.0, 140.0, 8.0, 300.0,
            400.0, 9.0]
    refill = _replays("_fill_cross_kv_from_ids", runs, [0.0, 3000.0], durs)
    step = _replays("_decoder_step", [("_decoder_step", 1)], [1500.0],
                    [50.0], corr0=10)
    t = _trace({**refill[0], **step[0]}, refill[1] + step[1],
               refill[2] + step[2])
    assert _read("encode_attend_ms.ralm", "ralm", t) == pytest.approx(0.24)
    assert _read("encode_attend_ms.ralm", "search", t) is None
    assert _read("encode_attend_ms.ralm", "ralm", None) is None
    bare = [(s if s != "encode.attend" else "_encoder_forward", n)
            for s, n in runs]
    before = _replays("_fill_cross_kv_from_ids", bare, [0.0, 3000.0], durs)
    assert _read("encode_attend_ms.ralm", "ralm", _trace(*before)) is None
    assert _read("encode_attend_ms.ralm", "ralm", _trace(*step)) is None


def test_cross_kv_reader_divides_by_refills():
    """The ``cross_kv.write`` runs of each whole refill replay, a refill:
    0.7 ms here (300 + 400 µs, the K and V GEMMs of two layers); the
    parent's map, whose K/V sits in ``_build_cross_kv`` and a copy at the
    root, and a decoder-only cell give nothing."""
    runs = [("_fill_cross_kv_from_ids", 2), ("_encoder_forward", 3),
            ("encode.attend", 1), ("_encoder_forward", 2),
            ("encode.attend", 1), ("_encoder_forward", 1),
            ("cross_kv.write", 4)]
    durs = [5.0, 1.0, 2.0, 3.0, 4.0, 100.0, 6.0, 7.0, 140.0, 8.0, 100.0,
            200.0, 150.0, 250.0]
    refill = _replays("_fill_cross_kv_from_ids", runs, [0.0, 3000.0], durs)
    step = _replays("_decoder_step", [("_decoder_step", 1)], [1500.0],
                    [50.0], corr0=10)
    t = _trace({**refill[0], **step[0]}, refill[1] + step[1],
               refill[2] + step[2])
    assert _read("cross_kv_ms.ralm", "ralm", t) == pytest.approx(0.7)
    assert _read("cross_kv_ms.ralm", "search", t) is None
    assert _read("cross_kv_ms.ralm", "ralm", None) is None
    parent = runs[:-1] + [("_build_cross_kv", 3),
                          ("_fill_cross_kv_from_ids", 1)]
    before = _replays("_fill_cross_kv_from_ids", parent, [0.0, 3000.0], durs)
    assert _read("cross_kv_ms.ralm", "ralm", _trace(*before)) is None
    assert _read("cross_kv_ms.ralm", "ralm", _trace(*step)) is None


def test_host_idle_reader_takes_the_median_batch():
    """The card's idle µs inside each ``retrieve`` range that starts in the
    window and holds a whole search replay: 30 and 50 here (busy 10 + 20
    µs of 60 and of 80); the third replay lost a record and the range
    before the window does not count; the median of 30 and 50."""
    rep = _replays("ivfpq_search", [("ivfpq_search", 2)],
                   [100.0, 300.0, 500.0], [10.0, 20.0])
    retrieve = [(95.0, 60.0), (295.0, 80.0), (495.0, 60.0), (-50.0, 20.0)]
    lost = [a for a in rep[2] if a[3] != 3 or a[0] != "k1"]
    t = _trace({**rep[0], "retrieve": retrieve}, rep[1],
               lost + [("start", 0.0, 1.0, 99)], window=(0.0, 1000.0))
    assert _read("host_idle_us.search", "search", t) == pytest.approx(40.0)
    assert _read("host_idle_us.search", "ralm", t) is None
    assert _read("host_idle_us.search", "search",
                 _trace(rep[0], rep[1], rep[2])) is None     # no span
    assert _read("host_idle_us.search", "search",
                 _trace({**rep[0], "retrieve": retrieve}, rep[1],
                        [])) is None                         # no device
    most_lost = [a for a in lost if a[3] == 1]
    assert _read("host_idle_us.search", "search",
                 _trace({**rep[0], "retrieve": retrieve}, rep[1],
                        most_lost, window=(0.0, 1000.0))) is None
