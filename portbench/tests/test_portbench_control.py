"""The control, the reference in the nearest precision below the
configuration's put in the program's place, reads above the program:
on the CPU at a tiny size, and on the card at a cell's own size against
the cell's limits."""

import json

import pytest
import torch

from portbench import run
from portbench.spec import Registry
from portbench.tests import tiny


def _readings(reg, workload, seed, device, seconds):
    w = reg.workload(workload)
    cfg, traffic = reg.config(w["config"]), reg.traffic(w["traffic"])
    r = run.runner(traffic["kind"])(cfg, traffic, seed, device, False)
    r.setup()
    r.window(seconds)
    got = r.collect()
    r.free()
    return r.judge(got), r.judge(got, control=True)


@pytest.mark.parametrize("workload", ["tiny-dec.ralm", "tiny-encdec.ralm",
                                      "tiny-dec.search"])
def test_control_reads_above_the_program(tmp_path, workload):
    reg = tiny.registry(tmp_path)
    prog, ctrl = _readings(reg, workload, 21, torch.device("cpu"), 0.5)
    limits = reg.limits(workload)
    assert all(prog[k] <= v for k, v in limits.items()), prog
    assert any(ctrl[k] > v for k, v in limits.items()), ctrl
    assert ctrl["dist_err"] > 10 * max(prog["dist_err"], 1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["dec-s.ralm", "dec-s.search",
                                      "encdec-s.ralm"])
def test_control_fails_the_cells_limits(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    reg = Registry()
    prog, ctrl = _readings(reg, workload, 4242, torch.device("cuda", 0),
                           12.0)
    limits = reg.limits(workload)
    print(json.dumps({"program": prog, "control": ctrl}))
    assert all(prog[k] <= v for k, v in limits.items()), prog
    assert any(ctrl[k] > v for k, v in limits.items()), ctrl
