"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a tiny size, once for each fault a cell can have (one card: no exchange
between chips to leave out), and once with the index build broken."""

import argparse
import time

import pytest
import torch

from portbench import calibrate, run
from portbench.tests import tiny

FAULTS = ("unchanged", "half", "altered")


def _break_step(monkeypatch, fault):
    import chamjax_torch.serving.ralm as loops
    real = loops.decoder_step
    calls = {"n": 0}

    def step(params, tokens, cache, heads, **kw):
        calls["n"] += 1
        if fault == "unchanged":          # the state comes back as it was
            logits = torch.nn.functional.one_hot(
                tokens.long(), params.embed.shape[0]).float()
            hidden = torch.zeros(tokens.shape[0], params.embed.shape[1])
            return logits, hidden, cache._replace(host_idx=cache.host_idx + 1)
        logits, hidden, cache = real(params, tokens, cache, heads, **kw)
        logits = logits.clone()
        if fault == "half":               # the second half left out
            logits[logits.shape[0] // 2:] = 0.0
        elif calls["n"] % 5 == 3:         # one row's token altered
            logits[1, logits[1].argmin()] = 1e9
        return logits, hidden, cache

    monkeypatch.setattr(loops, "decoder_step", step)


def _break_search(monkeypatch, fault):
    from chamjax_torch.retrieval.local import LocalRetriever
    from chamjax_torch.retrieval.interface import RetrievalResult
    real = LocalRetriever.retrieve_device
    last = {}

    def retrieve(self, q, nprobe, k):
        res = real(self, q, nprobe, k)
        ids, dists = res.ids.clone(), res.dists.clone()
        if fault == "unchanged":          # the previous answer again
            if "res" in last:
                return last["res"]
            last["res"] = res
            return res
        if fault == "half":
            h = ids.shape[0] // 2
            ids[h:], dists[h:] = ids[:ids.shape[0] - h], dists[:dists.shape[0] - h]
        else:
            ids[0, 0] = ids[1, 0]
        return RetrievalResult(ids=ids, dists=dists)

    monkeypatch.setattr(LocalRetriever, "retrieve_device", retrieve)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", ["tiny-dec.ralm", "tiny-encdec.ralm",
                                      "tiny-dec.search"])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, workload,
                                          fault):
    reg = tiny.registry(tmp_path)
    if workload.endswith("search"):
        _break_search(monkeypatch, fault)
    else:
        _break_step(monkeypatch, fault)
    args = argparse.Namespace(workload=workload, seed=11, seconds=0.5,
                              trace=0)
    out = run.execute(args, reg, torch.device("cpu"), time.time())
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", ["tiny-dec.ralm", "tiny-dec.search"])
def test_sound_run_is_correct(tmp_path, workload):
    reg = tiny.registry(tmp_path)
    args = argparse.Namespace(workload=workload, seed=11, seconds=0.5,
                              trace=0)
    out = run.execute(args, reg, torch.device("cpu"), time.time())
    assert out["correct"] is True, out["checks"]


def test_broken_build_is_not_correct(tmp_path, monkeypatch):
    """Rows in arbitrary lists, encoded consistently: the search follows
    the program's tables faithfully, and only the exact neighbours in the
    corpus (``kth_excess``) tell."""
    import chamjax_torch.index.ivf as ivf
    name, fn = calibrate.FAULTS["random_lists"]
    monkeypatch.setattr(ivf, name, fn)
    reg = tiny.registry(tmp_path)
    args = argparse.Namespace(workload="tiny-dec.search", seed=11,
                              seconds=0.5, trace=0)
    out = run.execute(args, reg, torch.device("cpu"), time.time())
    assert out["correct"] is False
    assert out["checks"]["kth_excess"]["value"] > \
        out["checks"]["kth_excess"]["limit"]
    assert out["checks"]["dist_err"]["value"] <= \
        out["checks"]["dist_err"]["limit"]
