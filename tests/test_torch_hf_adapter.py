"""chamjax_torch.serving.hf_adapter on the CPU: the counterparts of
``tests/test_hf_adapter.py`` on a locally constructed (no download) GPT-2,
then the same loop in both packages from the same model: equal tokens,
queries and retrieval answers step by step."""

import numpy as np
import pytest

pytest.importorskip("transformers")

import torch  # noqa: E402

from chamjax_torch.retrieval.interface import DummyRetriever  # noqa: E402
from chamjax_torch.serving.hf_adapter import (  # noqa: E402
    RalmHFDecoder, tiny_hf_model)

CPU = dict(device="cpu")


def test_ralm_hf_decoder_steps():
    model = tiny_hf_model(hidden=32, layers=2, heads=2, vocab=128)
    loop = RalmHFDecoder(model, DummyRetriever(default_k=5), batch_size=3,
                         retrieval_interval=2, k=5, **CPU)
    loop.batch_inference(5)
    assert loop.step_count == 5 and loop.past is not None
    prof = loop.get_profiling()
    assert (prof["time_retriever"] > 0).sum() == 3
    assert loop.last_result.ids.shape == (3, 5)
    stats = loop.prof.stats(batch_size=3)
    assert stats["steps"] == 5 and stats["throughput_tokens_per_sec"] > 0
    loop.reset_inference_state()
    assert loop.step_count == 0 and loop.past is None


def test_query_vector_pads_narrow_hidden():
    model = tiny_hf_model(hidden=32, layers=1, heads=2, vocab=64)

    class ShapeCheckRetriever(DummyRetriever):
        def retrieve(self, queries, nprobe, k):
            assert queries.shape[1] == 48, queries.shape
            np.testing.assert_array_equal(queries[:, 32:], 0.0)
            return super().retrieve(queries, nprobe, k)

    loop = RalmHFDecoder(model, ShapeCheckRetriever(default_k=5),
                         batch_size=2, retrieval_interval=1, k=5,
                         query_dim=48, **CPU)
    loop.batch_inference(2)
    assert loop.last_result.ids.shape == (2, 5)


class Recorder(DummyRetriever):
    def __init__(self):
        super().__init__(default_k=4)
        self.queries = []

    def retrieve(self, queries, nprobe, k):
        self.queries.append(np.array(queries))
        return super().retrieve(queries, nprobe, k)


def test_hf_loop_equal_chamjax():
    """One model, both packages' loops: the same tokens after every step
    and the same retrieval queries."""
    from chamjax.serving.hf_adapter import RalmHFDecoder as JLoop
    torch.manual_seed(0)
    model = tiny_hf_model(hidden=32, layers=2, heads=2, vocab=96)
    rt, rj = Recorder(), Recorder()
    t = RalmHFDecoder(model, rt, batch_size=2, retrieval_interval=2, k=4,
                      query_dim=40, **CPU)
    j = JLoop(model, rj, batch_size=2, retrieval_interval=2, k=4,
              device="cpu", query_dim=40)
    for _ in range(5):
        t.single_step()
        j.single_step()
        assert torch.equal(t.tokens, j.tokens)
    assert len(rt.queries) == len(rj.queries) == 3
    for a, b in zip(rt.queries, rj.queries):
        np.testing.assert_array_equal(a, b)


def test_hf_loop_needs_card_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RalmHFDecoder(tiny_hf_model(hidden=16, layers=1, heads=2, vocab=32),
                      DummyRetriever(), batch_size=1)
