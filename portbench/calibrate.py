"""The readings that the limits of ``correct`` are set from.

    python3 -m portbench.calibrate --workload dec-s.ralm \\
        --seeds 101,102,... --control-seeds 101,102,103 --seconds 8

For each seed, in one process: the cell's set-up, a short window at the
cell's own load (long enough to finish a generation, or some batches),
and the numbers that ``check.py`` compares, read on the program's
answers; on the control seeds also the same numbers read on the
reference's own answers in the nearest precision below the
configuration's (float8 weights and float8 ADC tables, and a bfloat16
encoding for the build's check).  One JSON line a seed and side, then a
summary line: the largest and smallest reading of each number, and the
control's smallest.

With ``--fault``, a fault is planted in the program's index build for
every seed (``FAULTS``), and the readings are of the program so broken:
the upper readings of the numbers that judge the build against the
corpus itself.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench.run import _environment, forbidden_modules, runner


def _random_lists(x, centroids, cap=None, **kw):
    """Every row in a list drawn at random, not its nearest."""
    import numpy as np
    rng = np.random.default_rng(len(x))
    return rng.integers(0, len(centroids), len(x)).astype(np.int32)


def _random_centroids(x, k, iters=15, seed=0, **kw):
    """Centroids drawn at random at the rows' scale, not trained."""
    import numpy as np
    import torch
    scale = float(torch.as_tensor(x).float().std())
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, x.shape[1])) * scale).astype(np.float32)


FAULTS = {
    # rows in arbitrary lists, encoded against those lists consistently
    "random_lists": ("assign_balanced", _random_lists),
    # the coarse quantizer's centroids random rather than trained
    "random_centroids": ("kmeans", _random_centroids),
    # no Lloyd and no PQ iterations: the seeding's centroids and codebooks
    "untrained": None,
}


def plant(fault: str, cfg: dict) -> dict:
    """Break the program's build as ``fault`` says; returns the
    configuration to run."""
    import chamjax_torch.index.ivf as ivf
    if FAULTS[fault] is None:
        return {**cfg, "index": {**cfg["index"], "kmeans_iters": 0,
                                 "pq_iters": 0}}
    name, fn = FAULTS[fault]
    setattr(ivf, name, fn)
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from portbench.spec import Registry

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    reg = Registry()
    w = reg.workload(args.workload)
    cfg, traffic = reg.config(w["config"]), reg.traffic(w["traffic"])
    side = "program"
    if args.fault:
        cfg, side = plant(args.fault, cfg), "fault:" + args.fault
    control = {int(s) for s in args.control_seeds.split(",") if s}
    largest, smallest, ctrl_smallest = {}, {}, {}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        run = runner(traffic["kind"])(cfg, traffic, seed,
                                      torch.device("cuda", 0), False)
        run.setup()
        run.window(args.seconds)
        got = run.collect()
        run.free()
        nums = run.judge(got)
        print(json.dumps({"seed": seed, "side": side, **nums}), flush=True)
        for k, v in nums.items():
            largest[k] = max(largest.get(k, v), v)
            smallest[k] = min(smallest.get(k, v), v)
        if seed in control:
            ctrl = run.judge(got, control=True)
            print(json.dumps({"seed": seed, "side": "control", **ctrl}),
                  flush=True)
            for k, v in ctrl.items():
                ctrl_smallest[k] = min(ctrl_smallest.get(k, v), v)
        del run, got
        torch.cuda.empty_cache()
    print(json.dumps({"side": side, "largest": largest,
                      "smallest": smallest, "control_smallest": ctrl_smallest,
                      "forbidden": forbidden_modules()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
