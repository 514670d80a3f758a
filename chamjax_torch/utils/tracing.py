"""Profiler tracing (the port of ``chamjax/utils/tracing.py``):
``torch.profiler`` in place of ``jax.profiler``.

    with trace("traces/") as prof:     # a Chrome trace lands in traces/
        searcher.search(q)
    prof.key_averages()                # sums by op and by kernel

    with annotate("adc_scan"):         # a named range on the timeline
        ...
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile host ops and, where there is a card, CUDA kernels and
    copies; on exit write a Chrome trace (``*.pt.trace.json``, for
    Perfetto or ``chrome://tracing``) into ``log_dir``.  Yields the
    ``torch.profiler.profile``, whose events are readable after exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"chamjax_torch_{os.getpid()}_{time.time_ns()}"
                 f".pt.trace.json"))


def annotate(name: str):
    """Named range on the trace timeline (``record_function``)."""
    return torch.profiler.record_function(name)


def device_memory_profile(path: str) -> None:
    """Write a snapshot of the CUDA caching allocator's memory (segments,
    blocks and, where history recording is on, their allocation stacks) to
    ``path`` (a pickle, readable with ``torch.cuda._memory_viz``).  Needs
    the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile needs an NVIDIA card "
                           "(CUDA); there is none")
    torch.cuda.memory._dump_snapshot(path)
