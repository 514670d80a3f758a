"""Per-step profiling for generation loops (the port's copy of
``chamjax/serving/profiling.py``).

Parity with the reference's hand-rolled instrumentation
(``ralm/ralm/ralm.py:69-72, 174-200``): per-step arrays for model time,
retriever time, and total step time, plus a stats printer with the same
latency/throughput summary surface, exportable for benchmark pickles.

Each timer is also a span of ``utils/tracing.py``: ``ralm.step``,
``ralm.model`` and ``ralm.retrieve`` in a profiler trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from chamjax_torch.utils import tracing


class StepProfiler:
    """The timers of one loop, in seconds.

    ``time_model`` and ``time_retriever`` are on the host clock
    (``perf_counter`` around a span's body): on the card's fused path the
    host only enqueues there, so they time the enqueue.  ``time_step`` is
    on the host clock too, except for a profiler given a CUDA ``device``
    (the RALM loops' fused path on the card): there it is the card's clock,
    the gap between the CUDA events recorded at consecutive step ends
    (the first step's from an event at its start), recorded with no host
    sync and resolved in :meth:`get_profiling` and :meth:`stats`."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.device = (torch.device(device) if device is not None
                       and torch.device(device).type == "cuda" else None)
        self.time_model: List[float] = []
        self.time_retriever: List[float] = []
        self.time_step: List[float] = []
        self._events: List[torch.cuda.Event] = []   # recorded, unresolved
        self._spare: List[torch.cuda.Event] = []

    def reset(self) -> None:
        self.time_model.clear()
        self.time_retriever.clear()
        self.time_step.clear()
        self._spare += self._events
        self._events = []

    class _Span:
        """A span of ``name`` whose host time goes to ``sink``."""

        def __init__(self, sink: List[float], name: str):
            self.sink, self.range = sink, tracing.annotate(name)

        def __enter__(self):
            self.range.__enter__()
            self.t = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.sink.append(time.perf_counter() - self.t)
            return self.range.__exit__(*exc)

    def model_span(self):
        return self._Span(self.time_model, "ralm.model")

    def retriever_span(self):
        return self._Span(self.time_retriever, "ralm.retrieve")

    def step_span(self):
        if self.device is None:
            return self._Span(self.time_step, "ralm.step")
        return self._device_step()

    def _record(self) -> None:
        e = (self._spare.pop() if self._spare
             else torch.cuda.Event(enable_timing=True))
        e.record(torch.cuda.current_stream(self.device))
        self._events.append(e)

    @contextlib.contextmanager
    def _device_step(self):
        with tracing.annotate("ralm.step"):
            if not self._events:
                self._record()          # the first step's start
            yield
            self._record()

    def _resolve(self) -> None:
        """Move the recorded steps' gaps into ``time_step`` (waits for the
        last step's event); the last event starts the next step."""
        if len(self._events) < 2:
            return
        self._events[-1].synchronize()
        for a, b in zip(self._events, self._events[1:]):
            self.time_step.append(a.elapsed_time(b) * 1e-3)
        self._spare += self._events[:-1]
        self._events = self._events[-1:]

    def get_profiling(self) -> Dict[str, np.ndarray]:
        self._resolve()
        return {
            "time_model": np.asarray(self.time_model),
            "time_retriever": np.asarray(self.time_retriever),
            "time_step": np.asarray(self.time_step),
        }

    def stats(self, batch_size: int = 1, warmup: int = 0) -> Dict[str, float]:
        self._resolve()
        ts = np.asarray(self.time_step[warmup:])
        if ts.size == 0:
            return {}
        out = {
            "steps": int(ts.size),
            "p50_step_ms": float(np.median(ts) * 1e3),
            "p95_step_ms": float(np.percentile(ts, 95) * 1e3),
            "mean_step_ms": float(ts.mean() * 1e3),
            "throughput_tokens_per_sec": float(batch_size / ts.mean()),
        }
        for name, arr in (("model", self.time_model),
                          ("retriever", self.time_retriever)):
            a = np.asarray(arr[warmup:])
            if a.size:
                out[f"p50_{name}_ms"] = float(np.median(a) * 1e3)
        return out

    def print_stats(self, batch_size: int = 1, warmup: int = 0) -> None:
        for k, v in self.stats(batch_size, warmup).items():
            print(f"  {k}: {v:.3f}" if isinstance(v, float) else f"  {k}: {v}",
                  flush=True)
