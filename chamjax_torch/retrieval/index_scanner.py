"""IVF coarse scanner and the disaggregated index server (the port of
``chamjax/retrieval/index_scanner.py``).

- ``IndexScanner`` (reference ``ralm/index_scanner/index_scanner.py``): the
  coarse quantizer as a service of its own.  Its centroid table stays on
  the card; a search is ``ops/coarse.py::select_probes`` (a GEMM and a
  top-k) replayed from a CUDA graph the scanner owns (``utils/graphs.py``),
  the port's counterpart of the reference's jitted ``coarse_scan`` /
  ``coarse_scan_2stage``.
- ``IndexServer`` (reference ``ralm/index_scanner/index_server.py``): the
  coarse scan here, the PQ scan on a remote engine through
  ``retrieve_with_lists``; ``search_multi_batch`` (latency mode) and
  ``search_multi_batch_tiktok`` (throughput mode: the coarse scan of batch
  i+1 overlaps the engine's scan of batch i).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from chamjax_torch.ops.coarse import select_probes
from chamjax_torch.retrieval.interface import BaseRetriever, RetrievalResult
from chamjax_torch.searcher import resolve_coarse_cand
from chamjax_torch.utils import graphs
from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul


@graphs.captured
@fp32_matmul()
def _probe(scanner: "IndexScanner", queries, nprobe: int, coarse_cand: int):
    q = queries if scanner.opq_R is None else queries @ scanner.opq_R
    return select_probes(q, scanner.centroids, nprobe,
                         coarse_cand=coarse_cand)


class IndexScanner:
    def __init__(self, centroids: np.ndarray, nprobe: int = 32,
                 coarse_cand: int = -1, opq_R: Optional[np.ndarray] = None,
                 device=None):
        """``coarse_cand``: the two-stage shortlist width
        (``SearchConfig.coarse_cand``: -1 auto, engaged at large nlist; 0
        exact).  ``opq_R``: an OPQ index's rotation, applied to the queries
        first, as the searcher does (the reference's scanner has none: over
        an OPQ index it would probe with unrotated queries).  Runs on the
        card unless ``device="cpu"``."""
        self.device = resolve_device(device)
        self.centroids = as_f32(centroids, self.device)
        self.opq_R = None if opq_R is None else as_f32(opq_R, self.device)
        self.nprobe = nprobe
        self._cfg_cand = coarse_cand
        self.graphs = graphs.Graphs()

    def search(self, queries: np.ndarray, nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns ``(list_ids (b, nprobe) int64, dists (b, nprobe))``."""
        np_ = nprobe or self.nprobe
        cand = resolve_coarse_cand(self._cfg_cand, self.centroids.shape[0],
                                   np_)
        lids, dists = _probe(self, as_f32(queries, self.device), np_, cand)
        return lids.cpu().numpy().astype(np.int64), dists.cpu().numpy()


class IndexServer:
    """Coarse scan here, PQ scan on a remote engine (the reference's
    CPU/GPU ↔ FPGA pairing)."""

    def __init__(self, scanner: IndexScanner, retriever: BaseRetriever,
                 k: int = 100):
        self.scanner = scanner
        self.retriever = retriever
        self.k = k
        self.batch_latency_s: List[float] = []

    def search(self, queries: np.ndarray, k: Optional[int] = None
               ) -> RetrievalResult:
        lids, _ = self.scanner.search(queries)
        return self.retriever.retrieve_with_lists(queries, lids, k or self.k)

    def search_multi_batch(self, query_batches: List[np.ndarray],
                           k: Optional[int] = None) -> List[RetrievalResult]:
        """Latency mode: strictly sequential."""
        out = []
        self.batch_latency_s.clear()
        for q in query_batches:
            t0 = time.perf_counter()
            out.append(self.search(q, k))
            self.batch_latency_s.append(time.perf_counter() - t0)
        return out

    def search_multi_batch_tiktok(self, query_batches: List[np.ndarray],
                                  k: Optional[int] = None
                                  ) -> List[RetrievalResult]:
        """Throughput mode: the coarse scan of batch i+1 overlaps the remote
        PQ scan of batch i (the tik-tok state machine applied to vector
        search)."""
        k = k or self.k
        out: List[Optional[RetrievalResult]] = [None] * len(query_batches)
        t_start = time.perf_counter()
        pending = None   # the batch whose answer is outstanding
        for i, q in enumerate(query_batches):
            lids, _ = self.scanner.search(q)          # overlaps remote scan
            if pending is not None:
                out[pending] = self.retriever.retrieve_recv(
                    query_batches[pending].shape[0], k)
            self.retriever.retrieve_with_lists_send(q, lids, k)
            pending = i
        if pending is not None:
            out[pending] = self.retriever.retrieve_recv(
                query_batches[pending].shape[0], k)
        self.total_time_s = time.perf_counter() - t_start
        return out   # type: ignore[return-value]

    def latency_stats_ms(self):
        a = np.asarray(self.batch_latency_s) * 1e3
        return {"p50": float(np.median(a)), "p95": float(np.percentile(a, 95))}

    def throughput_qps(self, query_batches) -> float:
        n = sum(q.shape[0] for q in query_batches)
        return n / self.total_time_s
