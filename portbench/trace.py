"""The traced stretch: a ``torch.profiler`` trace (CUPTI) over a steady
stretch of the window, exported as a Chrome trace into a temporary
directory (under ``TMPDIR``), read back and deleted.

The stretch is bracketed by device syncs and a ``record_function`` range
named ``STRETCH``; its window runs from the first device activity that
starts in that range to the end of the last, on the trace's clock (the
profiler's own start and the closing sync left out).  From
the trace: device activities (kernels, copies, sets), host runtime calls
with their correlation ids, and the host's ``record_function`` ranges, so
that a reader can take the device time of the kernels launched under a
range of its own.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

STRETCH = "portbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpy",
            "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemset")


@dataclass
class Trace:
    """What the stretch recorded, in microseconds on the trace's clock."""

    window: Tuple[float, float]
    device: List[Tuple[str, float, float, int]]   # (name, start, dur, corr)
    runtime: List[Tuple[str, float, float, int]]  # host launch calls
    ranges: Dict[str, List[Tuple[float, float]]]  # record_function ranges
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity inside the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(s + d, hi))
                       for _, s, d, _ in self.device
                       if s + d > lo and s < hi)
        merged: List[Tuple[float, float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def launches(self) -> int:
        return sum(1 for n, *_ in self.runtime if n in LAUNCHES)

    def device_us_under(self, range_name: str) -> float:
        """Device time of the activities launched by host calls made
        inside the ranges named ``range_name``."""
        spans = self.ranges.get(range_name, [])
        corrs = {c for _, ts, _, c in self.runtime
                 if any(s <= ts <= s + d for s, d in spans)}
        return sum(d for _, _, d, c in self.device if c in corrs)

    def device_us_where(self, pick) -> Tuple[float, int]:
        """Device time and count of the activities inside the window whose
        name ``pick`` accepts."""
        lo, hi = self.window
        hits = [d for n, s, d, _ in self.device
                if pick(n) and lo <= s < hi]
        return sum(hits), len(hits)

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The device operations that took the most time, and the longest
        idle gaps named by the innermost host operation at their start."""
        lo, hi = self.window
        by_name: Dict[str, float] = {}
        for name, s, d, _ in self.device:
            if lo <= s < hi:
                by_name[name] = by_name.get(name, 0.0) + d
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:n]
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        named = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            inner = [(name, hs, hd) for name, hs, hd in self.host_ops
                     if hs <= s < hs + hd]
            name = (min(inner, key=lambda x: x[2])[0] if inner
                    else "host idle")
            named.append([name, (e - s) * 1e-6])
        return {"device_ops": [[k, v * 1e-6] for k, v in ops],
                "idle_gaps": named}


def parse(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, runtime, host_ops = [], [], []
    ranges: Dict[str, List[Tuple[float, float]]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        corr = int(ev.get("args", {}).get("correlation", -1))
        if cat in DEVICE_CATS:
            device.append((ev["name"], ts, dur, corr))
        elif cat in ("cuda_runtime", "cuda_driver"):
            runtime.append((ev["name"], ts, dur, corr))
            host_ops.append((ev["name"], ts, dur))
        elif cat == "user_annotation":
            ranges.setdefault(ev["name"], []).append((ts, dur))
            host_ops.append((ev["name"], ts, dur))
        elif cat in ("cpu_op", "python_function"):
            host_ops.append((ev["name"], ts, dur))
    s, d = ranges.get(STRETCH, [(0.0, 0.0)])[0]
    inside = [(ts, ts + dur) for _, ts, dur, _ in device
              if s <= ts <= s + d]
    window = ((min(a for a, _ in inside), max(b for _, b in inside))
              if inside else (s, s))
    return Trace(window=window, device=device, runtime=runtime,
                 ranges=ranges, host_ops=host_ops)


class Stretch:
    """``start()`` and ``stop()`` bracket the traced stretch; ``read()``,
    after the window, exports and parses the trace."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self._range = None

    def start(self) -> None:
        self.prof.start()
        self._range = torch.profiler.record_function(STRETCH)
        self._range.__enter__()

    def stop(self, sync) -> None:
        sync()
        self._range.__exit__(None, None, None)
        self.prof.stop()

    def read(self) -> Trace:
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            return parse(path)


def warm_profiler() -> None:
    """Start the profiler once in set-up, so that the first stretch does
    not pay CUPTI's start."""
    s = Stretch()
    s.start()
    x = torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu")
    (x + 1).sum()
    s.stop(torch.cuda.synchronize if torch.cuda.is_available()
           else (lambda: None))
