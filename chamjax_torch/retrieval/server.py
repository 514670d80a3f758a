"""Retrieval servers: mock + real engines behind the wire protocol (the
port's copy of ``chamjax/retrieval/server.py``).

Parity with the reference's server tier:
- ``RandomAnswerServer`` (reference ``ralm/server/server.py:18-107``):
  deterministic ids + random dists with injectable ``delay_ms`` — the
  latency-injection fake used to emulate an engine of arbitrary speed.
- ``RetrievalServer`` (reference ``ralm/server/faiss_server.py:26-277``):
  serves a real index (here: the captured search on the card via the
  port's ``LocalRetriever``) over one persistent connection, handling both
  request flavors (plain / with-lists).

Servers are single-threaded accept-then-serve loops exactly like the
reference — concurrency correctness by construction.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import List, Optional

import numpy as np

from chamjax_torch.retrieval import wire
from chamjax_torch.retrieval.external import recv_exact, send_all
from chamjax_torch.retrieval.interface import BaseRetriever


def _make_listener(host: str, port: int) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    # SO_REUSEADDR only: SO_REUSEPORT (which the reference also sets) makes
    # the kernel load-balance incoming connections across every process
    # listening on the port — a stale process then silently steals
    # connections.
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.listen(16)
    return s


class BaseServer:
    """Accepts one client and answers retrieval requests until EOF."""

    def __init__(self, host: str, port: int, batch_size: int, dim: int,
                 nprobe: int = 32):
        self.host, self.port = host, port
        self.batch = batch_size
        self.dim = dim
        self.nprobe = nprobe
        self.served: List[int] = []      # batches answered, a connection
        self._stop = threading.Event()

    # subclass hook ------------------------------------------------------
    def answer(self, queries: np.ndarray, k: int,
               list_ids: Optional[np.ndarray] = None):
        raise NotImplementedError

    # plumbing -----------------------------------------------------------
    def serve_connection(self, conn: socket.socket, with_lists: bool = False
                         ) -> int:
        """Serve one connection; returns number of batches answered."""
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        served = 0
        try:
            while not self._stop.is_set():
                if with_lists:
                    hdr = recv_exact(conn, 16)
                    b, dim, npb, k = struct.unpack(">iiii", hdr)
                    body = recv_exact(
                        conn,
                        wire.request_with_lists_nbytes(b, dim, npb) - 16)
                    q, lids, k = wire.decode_request_with_lists(hdr + body)
                    ids, dists = self.answer(q, k, lids)
                else:
                    buf = recv_exact(conn,
                                     wire.request_nbytes(self.batch, self.dim))
                    q, k = wire.decode_request(buf, self.batch, self.dim)
                    ids, dists = self.answer(q, k)
                send_all(conn, wire.encode_answer(ids, dists))
                served += 1
        except (ConnectionError, OSError):
            pass
        return served

    def start(self, n_connections: int = 1, with_lists: bool = False) -> None:
        listener = _make_listener(self.host, self.port)
        try:
            for _ in range(n_connections):
                conn, _ = listener.accept()
                self.served.append(self.serve_connection(
                    conn, with_lists=with_lists))
                conn.close()
        finally:
            listener.close()

    def stop(self) -> None:
        self._stop.set()


class RandomAnswerServer(BaseServer):
    """Mock engine: deterministic ids, random sorted dists, optional
    injected latency (reference ``RandomAnswerServer``)."""

    def __init__(self, *args, delay_ms: float = 0.0, seed: int = 0, **kw):
        super().__init__(*args, **kw)
        self.delay_ms = delay_ms
        self._rng = np.random.default_rng(seed)

    def answer(self, queries, k, list_ids=None):
        if self.delay_ms:
            time.sleep(self.delay_ms / 1e3)
        b = queries.shape[0]
        ids = np.broadcast_to(np.arange(k, dtype=np.int64), (b, k)).copy()
        dists = np.sort(self._rng.random((b, k)).astype(np.float32), axis=1)
        return ids, dists


class RetrievalServer(BaseServer):
    """Real engine: IVF-PQ search on the card behind the wire protocol (the
    ChamVS-node / FaissServer counterpart)."""

    def __init__(self, retriever: BaseRetriever, *args, **kw):
        super().__init__(*args, **kw)
        self.retriever = retriever

    def answer(self, queries, k, list_ids=None):
        if list_ids is not None:
            res = self.retriever.retrieve_with_lists(queries, list_ids, k)
        else:
            res = self.retriever.retrieve(queries, self.nprobe, k)
        return res.ids, res.dists
