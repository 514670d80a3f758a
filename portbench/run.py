"""One run of one cell of the port's benchmark.

    python3 -m portbench --workload dec-s.ralm --seed 7 --seconds 20 --trace 0

Loads the cell's configuration and traffic mix by name (``spec.py``),
sets the program up (corpus, index, weights, warm-up of the cell's own
graph keys), measures for ``--seconds``, judges what the timed path
produced against the plain reference, and prints one JSON object as the
last line of standard output: the end-to-end metrics with ``--trace 0``,
the per-layer metrics of a traced stretch with ``--trace 1``.  The numbers
compared for ``correct`` are the last lines of standard error and the last
key of that object.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "chamjax")


def process_start() -> float:
    """The wall-clock time this process started (Linux), else the time
    this module was first imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_START


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; keep
    libraries from loading JAX."""
    build = ROOT / "chamjax_torch" / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def runner(kind: str):
    """The runner of a traffic kind: ``Run`` of the module
    ``portbench/<kind>.py``, so that a new kind is a new module."""
    return importlib.import_module(f"portbench.{kind}").Run


def execute(args, registry, device, started: float) -> dict:
    """Set up, measure, judge: the result object (without the device's
    name), or raise."""
    from portbench import check

    w = registry.workload(args.workload)
    cfg = registry.config(w["config"])
    traffic = registry.traffic(w["traffic"])
    limits = registry.limits(args.workload)
    run = runner(traffic["kind"])(cfg, traffic, args.seed, device,
                                  bool(args.trace))
    run.setup()
    gc.collect()
    gc.freeze()     # the set-up's objects out of the collector's scans
    if device.type == "cuda":       # the peak the window itself reaches
        import torch
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - started
    run.window(args.seconds)
    e2e = run.end_to_end()
    e2e["setup_s"] = setup_s
    got = run.collect()
    counts = run.counts(got)
    tr = run.stretch.read() if args.trace else None
    distinct = run.distinct(got) if args.trace and hasattr(
        run, "distinct") else None
    run.free()
    numbers = run.judge(got)
    correct, checks = check.compare(numbers, limits)
    if distinct is not None:
        print(json.dumps({"distinct": distinct}), flush=True)
    out = {"correct": correct, "attempted": run.attempted(), "failed": 0}
    units = {m["name"]: m["unit"] for m in
             registry.bench["end_to_end"] + registry.bench["per_layer"]}
    metrics = {}
    if args.trace:
        ctx = SimpleNamespace(kind=traffic["kind"], cfg=cfg,
                              traffic=traffic, trace=tr, counts=counts)
        for m in registry.per_layer(args.workload):
            v = registry.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in registry.end_to_end(args.workload):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": units[m["name"]]}
    out["metrics"] = metrics
    out["device"] = {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "count": 1, "memory_peak_bytes": int(run.peak)}
    if tr is not None:
        out["device"]["busy_s"] = tr.busy_s()
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    if args.trace:      # the traced window's own rate: tracing's overhead
        out["traced_rate"] = e2e.get("tok_s") or e2e.get("qps")
    out["checks"] = {k: {"value": check.finite(c["value"]),
                         "limit": c["limit"]} for k, c in checks.items()}
    check.print_checks(checks)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    started = process_start()
    _environment()
    import torch

    from portbench.spec import Registry

    registry = Registry()
    w = registry.workload(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w["chips"]:
        print(f"portbench: {w['name']} needs {w['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = execute(args, registry, device, started)
    out["device"]["kind"] = torch.cuda.get_device_name(device)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
