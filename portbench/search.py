"""The ``search`` traffic: one closed-loop client of the index alone.

Each batch is ``batch`` query vectors taken in turn from a pool of
``pool`` drawn from the seed off the corpus distribution and held on the
card; the client calls ``LocalRetriever.retrieve_device`` and reads the
batch's ids and distances back on the host before it sends the next.  A
batch's latency is the host clock from the call to its results on the
host.  The answers of ``check_batches`` batches, drawn from the seed as
the window goes (a reservoir), are judged once it has closed: against
the configuration's search over the program's tables, and against the
exact nearest neighbours in the corpus, drawn again from the seed.
"""

from __future__ import annotations

import random
import statistics
import time
from collections import Counter
from typing import Dict

import torch

from portbench import check, inputs, program, trace
from portbench.reference import search as ref_search

RETRIEVE = "portbench.retrieve"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Run:
    """One run of a ``search`` cell, with the same steps as ``ralm.Run``."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 tracing: bool):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev, self.tracing = device, tracing
        self.batch = traffic["batch"]
        self.sc = cfg["search"]

    def setup(self) -> None:
        self.retriever, self.tables, self.pool = program.build(
            self.cfg, self.seed, self.dev, queries=self.traffic["pool"])
        self.n_pool = self.pool.shape[0] // self.batch
        for j in range(2):                    # the one graph key
            self._one(j)
        if self.tracing:
            trace.warm_profiler()
            self.stretch = trace.Stretch()
        _sync(self.dev)

    def _one(self, j: int):
        q = self.pool[j * self.batch:(j + 1) * self.batch]
        res = self.retriever.retrieve_device(q, self.sc["nprobe"],
                                             self.sc["k"])
        return res.ids.cpu(), res.dists.cpu()

    def _batch(self, counter: Counter) -> None:
        j = self.i % self.n_pool
        ts = time.perf_counter()
        if self.tracing and self.in_stretch:
            with torch.profiler.record_function(RETRIEVE):
                ids, dists = self._one(j)
        else:
            ids, dists = self._one(j)
        self.lat.append(time.perf_counter() - ts)
        counter[j] += 1
        # reservoir sample of the window's batches, drawn from the seed
        if len(self.kept) < self.traffic["check_batches"]:
            self.kept.append((j, ids, dists))
        else:
            r = self.rng.randrange(self.i + 1)
            if r < len(self.kept):
                self.kept[r] = (j, ids, dists)
        self.i += 1

    def window(self, seconds: float) -> None:
        self.i, self.lat, self.kept = 0, [], []
        self.rng = random.Random(inputs.sub_seed(self.seed, "check_batches"))
        self.out, self.inn = Counter(), Counter()
        self.in_stretch = False
        traced_span = 0.0
        self.t0 = time.perf_counter()
        while True:
            self._batch(self.out)
            now = time.perf_counter()
            if self.tracing and not self.inn and now - self.t0 >= seconds / 2:
                ta = time.perf_counter()
                self.in_stretch = True
                self.stretch.start()
                for _ in range(self.traffic["trace_batches"]):
                    self._batch(self.inn)
                self.stretch.stop(lambda: _sync(self.dev))
                self.in_stretch = False
                traced_span = time.perf_counter() - ta
                now = time.perf_counter()
            if now - self.t0 >= seconds:
                break
        self.wall = time.perf_counter() - self.t0
        self.wall_out = self.wall - traced_span
        self.peak = (torch.cuda.max_memory_allocated(self.dev)
                     if self.dev.type == "cuda" else 0)

    def attempted(self) -> int:
        return self.i * self.batch

    def end_to_end(self) -> Dict[str, float]:
        return {"qps": self.i * self.batch / self.wall,
                "search_p95_ms": statistics.quantiles(
                    self.lat, n=20)[-1] * 1e3}

    def collect(self) -> Dict:
        return {"kept": self.kept}

    def free(self) -> None:
        del self.retriever
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _index(self):
        return ref_search.Index.from_tables(
            self.tables, self.sc["nprobe"], self.sc["k"],
            self.sc["seg_group"], self.dev)

    def judge(self, got: Dict, control: bool = False) -> Dict[str, float]:
        """Over the kept batches' answers (with ``control``, the
        reference's float8 answers in their place): ``dist_err`` and
        ``miss`` against the configuration's search, ``kth_excess``, the
        mean over their queries of the exact k-th distance's excess
        (``recall``, their exact R@k, beside it); and the build's
        ``encode_gap``/``id_coverage``."""
        ix = self._index()
        xb = program.corpus(self.cfg, self.seed, self.dev)
        nums = {"dist_err": 0.0, "miss": 0.0}
        excess, recall = [], []
        with torch.no_grad():
            for j, ids, dists in got["kept"]:
                q = self.pool[j * self.batch:(j + 1) * self.batch]
                if control:
                    ids, dists = ref_search.control_answers(ix, q)
                for key, v in ref_search.judge(ix, q, ids, dists).items():
                    nums[key] = max(nums[key], v)
                t = ref_search.truth(xb, q, ids)
                excess.append(t["kth_excess"])
                recall.append(t["recall"])
            nums["kth_excess"] = float(torch.cat(excess).mean())
            nums["recall"] = float(torch.cat(recall).mean())
            nums.update(check.build_numbers(ix, self.tables, xb, self.seed,
                                            control))
        return nums

    def counts(self, got: Dict) -> Dict:
        ix = self._index()
        rows = {}
        used = set(self.out) | set(self.inn)
        for j in used:
            q = self.pool[j * self.batch:(j + 1) * self.batch]
            rows[j] = ref_search.probed_rows(ix, ref_search.probe_sets(ix, q))
        return {"batch": self.batch, "batch_rows": rows,
                "batches_out": dict(self.out), "batches_in": dict(self.inn),
                "units_in": sum(self.inn.values()),
                "units_out": sum(self.out.values()),
                "wall_out_s": self.wall_out}
