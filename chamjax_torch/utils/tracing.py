"""Profiler tracing and the port's spans (the port of
``chamjax/utils/tracing.py``): ``torch.profiler`` in place of
``jax.profiler``.

    with trace("traces/") as prof:     # a Chrome trace lands in traces/
        searcher.search(q)
    prof.key_averages()                # sums by op and by kernel

    with annotate("search.lut"):       # a span
        ...

``annotate`` is the port's one span.  What it is depends on the moment it
opens:

- no profiler recording and no stage map open (every untraced run): a
  shared null context, after two flag checks; nothing is built;
- a profiler recording: a ``record_function`` range, a
  ``user_annotation`` event in the Chrome trace, on the clock of CUPTI's
  device records;
- inside a capture of ``utils/graphs.py`` (a :class:`StageMap` open on
  this thread): a boundary in the capture's stage map, which counts the
  graph's device nodes captured so far.  It adds no node to the graph, so
  a replay pays nothing for it.

Host spans sit at layer boundaries (``retrieve``, ``ralm.step``,
``ralm.refill``, ...); stage spans inside captured functions
(``search.lut``, ``decode.attend``, ...).  ``graphs.call`` names each
replay after its stage map, so a reader of the trace splits a replay's
device activities by stage.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

_NULL = contextlib.nullcontext()


class _Local(threading.local):
    stage_map: Optional["StageMap"] = None     # open inside a capture


_local = _Local()


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


class StageMap:
    """The stage map of one capture: its device nodes in capture order, as
    runs of ``(span, nodes)``, ``span`` the innermost span open when the
    nodes were captured, ``root`` where none was.

    ``count()`` gives the device nodes the capture holds so far; it is
    read at every span's entry and exit.  A span that captured nothing
    leaves no run; two neighbouring runs of one span are one."""

    def __init__(self, root: str, count: Callable[[], int]):
        self.count = count
        self.stack: List[str] = [root]
        self.runs: List[List] = []
        self.seen = 0

    def _mark(self) -> None:
        n = self.count()
        if n > self.seen:
            name = self.stack[-1]
            if self.runs and self.runs[-1][0] == name:
                self.runs[-1][1] += n - self.seen
            else:
                self.runs.append([name, n - self.seen])
            self.seen = n

    @contextlib.contextmanager
    def span(self, name: str):
        self._mark()
        self.stack.append(name)
        try:
            yield
        finally:
            self._mark()
            self.stack.pop()

    def record(self, fn: Callable[[], object]):
        """Run ``fn`` (the function being captured) with this map open on
        this thread; its runs are in ``runs`` after."""
        outer = _local.stage_map
        _local.stage_map = self
        try:
            out = fn()
            self._mark()
        finally:
            _local.stage_map = outer
        return out

    def result(self) -> Tuple[Tuple[str, int], ...]:
        return tuple((name, n) for name, n in self.runs)


def open_stage_map() -> Optional[StageMap]:
    """The stage map open on this thread (inside a capture), else None."""
    return _local.stage_map


def annotate(name: str):
    """A span named ``name``: a stage boundary inside a capture, a
    ``record_function`` range while a profiler records, else a shared null
    context (no ``record_function`` is built)."""
    stages = _local.stage_map
    if stages is not None:
        return stages.span(name)
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
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
