"""The last line's keys, and no result where there is no card or no
program."""

import argparse
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import run
from portbench.spec import ROOT
from portbench.tests import tiny


@pytest.mark.parametrize("workload", ["tiny-dec.ralm", "tiny-dec.search"])
@pytest.mark.parametrize("traced", [0, 1])
def test_result_keys(tmp_path, workload, traced):
    reg = tiny.registry(tmp_path)
    args = argparse.Namespace(workload=workload, seed=2 ** 31 + 77,
                              seconds=0.3, trace=traced)
    out = run.execute(args, reg, torch.device("cpu"), time.time())
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    names = {m["name"] for m in (reg.per_layer(workload) if traced
                                 else reg.end_to_end(workload))}
    assert set(out["metrics"]) <= names
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in out["metrics"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "dec-s.ralm",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "from portbench.run import main; sys.exit(main())")
    out = subprocess.run(
        [sys.executable, "-c", code, "--workload", "dec-s.ralm", "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "chamjax_torch" in out.stderr
