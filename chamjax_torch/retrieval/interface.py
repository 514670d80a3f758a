"""Retriever interface — the L5↔L3 contract of the system (the port's
copy of ``chamjax/retrieval/interface.py``).

Parity with the reference's duck-typed ``BaseRetriever``
(``ralm/retriever/retriever.py:20-66``): the RALM loop only sees
``retrieve(queries, nprobe, k)`` / ``retrieve_with_lists(queries, list_ids, k)``
returning ``(ids, dists)``, plus the non-blocking send/poll/recv split the
tik-tok scheduler needs.  Dummy / Local / External implementations are
interchangeable.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np


@dataclass
class RetrievalResult:
    ids: np.ndarray      # (batch, k) int64 — int32 tensors on the fused path
    dists: np.ndarray    # (batch, k) float32 — tensors on the fused path


class BaseRetriever:
    """Abstract retriever. Sync API plus an async split for pipelining."""

    def retrieve(self, queries: np.ndarray, nprobe: int, k: int) -> RetrievalResult:
        raise NotImplementedError

    def retrieve_with_lists(
        self, queries: np.ndarray, list_ids: np.ndarray, k: int
    ) -> RetrievalResult:
        raise NotImplementedError

    # --- async split (tik-tok). Default: buffer sync results FIFO. ---

    def retrieve_send(self, queries: np.ndarray, nprobe: int, k: int) -> None:
        self._pending = getattr(self, "_pending", [])
        self._pending.append(self.retrieve(queries, nprobe, k))

    def retrieve_with_lists_send(
        self, queries: np.ndarray, list_ids: np.ndarray, k: int
    ) -> None:
        self._pending = getattr(self, "_pending", [])
        self._pending.append(self.retrieve_with_lists(queries, list_ids, k))

    def poll(self) -> bool:
        """True if a previously sent request's answer is ready."""
        return bool(getattr(self, "_pending", []))

    def retrieve_recv(self, batch: int, k: int) -> RetrievalResult:
        return self._pending.pop(0)

    def close(self) -> None:
        pass


class DummyRetriever(BaseRetriever):
    """Deterministic mock for inference-only baselines and tests
    (reference ``retriever.py:28-66`` returns None; we return well-formed
    arrays so downstream code paths run unchanged)."""

    def __init__(self, default_k: int = 10, seed: int = 0):
        self.default_k = default_k
        self._seed = seed

    def _answer(self, batch: int, k: int) -> RetrievalResult:
        ids = np.broadcast_to(np.arange(k, dtype=np.int64), (batch, k)).copy()
        rng = np.random.default_rng(self._seed)
        dists = rng.random((batch, k)).astype(np.float32)
        dists.sort(axis=1)
        return RetrievalResult(ids=ids, dists=dists)

    def retrieve(self, queries, nprobe, k):
        return self._answer(np.asarray(queries).shape[0], k or self.default_k)

    def retrieve_with_lists(self, queries, list_ids, k):
        return self._answer(np.asarray(queries).shape[0], k or self.default_k)
