"""Per-step wall-clock profiling for generation loops (the port's copy of
``chamjax/serving/profiling.py``).

Parity with the reference's hand-rolled instrumentation
(``ralm/ralm/ralm.py:69-72, 174-200``): per-step arrays for model time,
retriever time, and total step time, plus a stats printer with the same
latency/throughput summary surface, exportable for benchmark pickles.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np


class StepProfiler:
    def __init__(self) -> None:
        self.time_model: List[float] = []
        self.time_retriever: List[float] = []
        self.time_step: List[float] = []

    def reset(self) -> None:
        self.time_model.clear()
        self.time_retriever.clear()
        self.time_step.clear()

    class _Span:
        def __init__(self, sink: List[float]):
            self.sink = sink

        def __enter__(self):
            self.t = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.sink.append(time.perf_counter() - self.t)
            return False

    def model_span(self):
        return self._Span(self.time_model)

    def retriever_span(self):
        return self._Span(self.time_retriever)

    def step_span(self):
        return self._Span(self.time_step)

    def get_profiling(self) -> Dict[str, np.ndarray]:
        return {
            "time_model": np.asarray(self.time_model),
            "time_retriever": np.asarray(self.time_retriever),
            "time_step": np.asarray(self.time_step),
        }

    def stats(self, batch_size: int = 1, warmup: int = 0) -> Dict[str, float]:
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
