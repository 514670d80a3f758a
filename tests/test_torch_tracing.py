"""Profiler tracing on the CPU: ``trace`` writes a Chrome trace holding an
``annotate`` range; what needs the card (a device memory snapshot, the two
kernel-study CLIs) raises without one instead of running on the CPU.  The
card's side is in ``tests/test_torch_gpu.py``."""

import json

import pytest
import torch

from chamjax_torch.benchmarks import kernel_roofline, kernel_variants
from chamjax_torch.utils import tracing


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_trace_writes_a_chrome_trace_with_the_annotated_range(tmp_path):
    with tracing.trace(str(tmp_path / "traces")) as prof:
        with tracing.annotate("chamjax_scan_window"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "traces").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "chamjax_scan_window" in names
    assert any(e.name == "chamjax_scan_window" for e in prof.events())


def test_two_traces_do_not_overwrite_each_other(tmp_path):
    for _ in range(2):
        with tracing.trace(str(tmp_path)):
            torch.zeros(8).sum()
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 2


def test_device_memory_profile_needs_the_card(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="card"):
        tracing.device_memory_profile(str(tmp_path / "mem.pickle"))
    assert not (tmp_path / "mem.pickle").exists()


@pytest.mark.parametrize("cli", [kernel_variants, kernel_roofline])
def test_kernel_study_clis_need_the_card(no_card, capsys, cli):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--n", "4096", "--bw", "8", "--n_lut", "2", "--segs",
                  "512"])
    assert capsys.readouterr().out == ""      # no row, no result
