"""Nothing the benchmark runs loads JAX, Flax or the JAX package: the
top-level module names compared whole (``chamjax_torch`` is not
``chamjax``)."""

import subprocess
import sys

from portbench.spec import ROOT

PROBE = r"""
import sys, time, argparse, pathlib, tempfile
import torch
from portbench import run, calibrate, ralm, search, program, trace, work
from portbench.reference import model, search as rs
from portbench.tests import tiny
reg = tiny.registry(pathlib.Path(tempfile.mkdtemp()))
for wl in ("tiny-dec.ralm", "tiny-encdec.ralm", "tiny-dec.search"):
    for tr in (0, 1):
        args = argparse.Namespace(workload=wl, seed=3, seconds=0.3, trace=tr)
        out = run.execute(args, reg, torch.device("cpu"), time.time())
        assert out["correct"], out
names = {m.split(".")[0] for m in sys.modules}
print("TOP", sorted(names & {"jax", "jaxlib", "flax", "chamjax"}))
print("PORT", "chamjax_torch" in names)
print("FORBIDDEN", run.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "TOP []" in lines
    assert "PORT True" in lines
    assert "FORBIDDEN []" in lines


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "chamjaxx_probe", sys)
    assert "chamjax" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "chamjax.probe", sys)
    assert run.forbidden_modules() == ["chamjax"]
