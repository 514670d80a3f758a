"""Coordinator: the multi-client ↔ multi-engine retrieval multiplexer (the
port's copy of ``chamjax/retrieval/coordinator.py``).

Parity with the reference's ``RetrieveCoordinator``
(``ralm/coordinator/retriever_coordinator_server.py:26-285``): accepts
``n_clients`` LM-worker connections, barrier-syncs them with the 4-byte echo
handshake, then runs a single-threaded poll loop that

- receives fixed-size query batches from any ready client,
- forwards each batch **round-robin** across the retrieval engines
  (``assign = received_query_cnt % n_engines``, reference :236),
- remembers each request's origin client (FIFO per engine), and
- routes answers back to the owning client as engines become readable.

A ``start_dummy_answer`` mode answers locally without any engine — the
stand-in for the whole retrieval tier used in scheduler tests
(reference :138-196).
"""

from __future__ import annotations

import select
import socket
import struct
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from chamjax_torch import native
from chamjax_torch.retrieval import wire
from chamjax_torch.retrieval.external import recv_exact, send_all
from chamjax_torch.retrieval.server import _make_listener


class RetrieveCoordinator:
    def __init__(
        self,
        host: str,
        port: int,
        n_clients: int,
        batch_size: int,
        dim: int,
        k: int,
        engine_addrs: Optional[List[tuple]] = None,
        queries_per_client: Optional[int] = None,
    ):
        self.host, self.port = host, port
        self.n_clients = n_clients
        self.batch = batch_size
        self.dim = dim
        self.k = k
        self.engine_addrs = engine_addrs or []
        self.queries_per_client = queries_per_client
        self.clients: List[socket.socket] = []
        self.engines: List[socket.socket] = []
        self.received_query_cnt = 0
        self.answered_query_cnt = 0

    # --- setup (reference accept_connections / connect_to_search_server) ---

    def accept_connections(self) -> None:
        listener = _make_listener(self.host, self.port)
        for _ in range(self.n_clients):
            conn, _ = listener.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.clients.append(conn)
        listener.close()

    def barrier_sync(self) -> None:
        """4-byte echo to every client (reference :106-122)."""
        for c in self.clients:
            payload = recv_exact(c, 4)
            send_all(c, payload)

    def connect_to_engines(self, deadline_s: float = 600.0) -> None:
        """Connect to every engine, retrying each until ``deadline_s``.

        Engines load their index and capture their graphs on the card
        before they listen, so a one-shot connect races their startup —
        the same retry discipline the reference's clients use against slow
        search servers.
        """
        import time
        t0 = time.time()
        for host, port in self.engine_addrs:
            while True:
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    s.connect((host, port))
                    break
                except (ConnectionRefusedError, OSError):
                    s.close()
                    if time.time() - t0 > deadline_s:
                        raise
                    time.sleep(0.5)
            self.engines.append(s)

    # --- main loop ---

    def start(self) -> None:
        """Relay until every client has had ``queries_per_client`` answers
        (or until all clients disconnect).

        Engine failure (the pitfall class the reference documents at
        ``retriever_coordinator_server.py:145-150``) is survivable: each
        engine's origin FIFO remembers the request *bytes*, so when an
        engine dies mid-run its unanswered requests re-issue round-robin to
        the surviving engines.  Only if *every* engine is gone do the
        affected clients fail (coordinator closes all sockets and raises).
        """
        self.accept_connections()
        self.connect_to_engines()
        self.barrier_sync()

        poller = select.poll()
        fd_map: Dict[int, tuple] = {}
        for ci, c in enumerate(self.clients):
            poller.register(c, select.POLLIN)
            fd_map[c.fileno()] = ("client", ci)
        for ei, e in enumerate(self.engines):
            poller.register(e, select.POLLIN)
            fd_map[e.fileno()] = ("engine", ei)

        # FIFO of (origin client, request bytes) per engine (reference
        # query_gpu_ids — bytes kept so engine death can re-issue)
        origin: List[deque] = [deque() for _ in self.engines]
        unsent: deque = deque()          # (ci, buf) awaiting a live engine
        live_engines = set(range(len(self.engines)))
        rr = 0                           # round-robin cursor over engines
        req_bytes = wire.request_nbytes(self.batch, self.dim)
        ans_bytes = wire.answer_nbytes(self.batch, self.k)
        total = (self.queries_per_client * self.n_clients
                 if self.queries_per_client else None)
        live_clients = set(range(self.n_clients))

        def mark_engine_dead(ei: int) -> None:
            if ei not in live_engines:
                return
            live_engines.discard(ei)
            try:
                poller.unregister(self.engines[ei])
            except (KeyError, OSError):
                pass
            # unanswered requests go back to the dispatch queue, FIFO order
            unsent.extendleft(reversed(origin[ei]))
            origin[ei].clear()

        def dispatch() -> None:
            nonlocal rr
            while unsent and live_engines:
                ci, buf = unsent[0]
                ei = rr % len(self.engines)
                rr += 1
                if ei not in live_engines:
                    continue
                try:
                    send_all(self.engines[ei], buf)
                except (ConnectionError, OSError):
                    mark_engine_dead(ei)
                    continue
                origin[ei].append((ci, buf))
                unsent.popleft()
            if unsent and not live_engines:
                self.close()
                raise RuntimeError(
                    "all retrieval engines failed with "
                    f"{len(unsent)} requests outstanding")

        def drop_client(ci: int) -> None:
            if ci not in live_clients:
                return
            live_clients.discard(ci)
            try:
                poller.unregister(self.clients[ci])
            except (KeyError, OSError):
                pass
            try:
                self.clients[ci].close()
            except OSError:
                pass

        while live_clients and (total is None
                                or self.answered_query_cnt < total):
            for fd, _ev in poller.poll(100):
                kind, idx = fd_map[fd]
                if kind == "client":
                    try:
                        buf = recv_exact(self.clients[idx], req_bytes)
                    except ConnectionError:
                        drop_client(idx)
                        continue
                    # answers are framed with the CONFIGURED k (fixed-size
                    # relay, same as the native plane) — a request carrying
                    # a different k would desync the engine byte stream, so
                    # fail that client loudly instead
                    (req_k,) = struct.unpack(">i", buf[:4])
                    if req_k != self.k:
                        import warnings
                        warnings.warn(
                            f"coordinator: client {idx} requested k={req_k} "
                            f"but the coordinator frames answers with "
                            f"k={self.k} — dropping the client (per-request "
                            "k is not supported through the coordinator)",
                            stacklevel=2)
                        drop_client(idx)
                        continue
                    unsent.append((idx, buf))
                    self.received_query_cnt += 1
                    dispatch()
                else:
                    try:
                        buf = recv_exact(self.engines[idx], ans_bytes)
                    except (ConnectionError, OSError):
                        mark_engine_dead(idx)
                        dispatch()
                        continue
                    ci, _req = origin[idx].popleft()
                    try:
                        send_all(self.clients[ci], buf)
                    except (ConnectionError, OSError):
                        # the engine did answer — count it, lose only the
                        # dead client (a crash here would kill every other
                        # client's relay)
                        drop_client(ci)
                    self.answered_query_cnt += 1
        self.close()

    def start_dummy_answer(self, delay_ms: float = 0.0) -> None:
        """Answer locally without engines (reference :138-196)."""
        import time

        self.accept_connections()
        self.barrier_sync()
        poller = select.poll()
        fd_map = {}
        for ci, c in enumerate(self.clients):
            poller.register(c, select.POLLIN)
            fd_map[c.fileno()] = ci
        req_bytes = wire.request_nbytes(self.batch, self.dim)
        total = (self.queries_per_client * self.n_clients
                 if self.queries_per_client else None)
        live = set(range(self.n_clients))
        while live and (total is None or self.answered_query_cnt < total):
            for fd, _ev in poller.poll(100):
                ci = fd_map[fd]
                try:
                    buf = recv_exact(self.clients[ci], req_bytes)
                except ConnectionError:
                    poller.unregister(self.clients[ci])
                    live.discard(ci)
                    continue
                _q, k = wire.decode_request(buf, self.batch, self.dim)
                if delay_ms:
                    time.sleep(delay_ms / 1e3)
                ids = np.broadcast_to(np.arange(k, dtype=np.int64),
                                      (self.batch, k))
                dists = np.zeros((self.batch, k), np.float32)
                send_all(self.clients[ci], wire.encode_answer(ids, dists))
                self.answered_query_cnt += 1
        self.close()

    def close(self) -> None:
        for s in self.clients + self.engines:
            try:
                s.close()
            except OSError:
                pass


class NativeCoordinator:
    """Drop-in replacement for ``RetrieveCoordinator.start()`` backed by the
    C++ epoll data plane (``chamjax_torch/native/src/chamnet.cpp``).

    The Python coordinator relays every frame through the interpreter — the
    same serialization point the reference notes in its poll loop.  The
    native loop does accept/barrier/round-robin-scatter/origin-gather with
    zero per-frame Python involvement.  Same wire format, same topology.
    Like the Python relay, framing is fixed-size: every client must request
    the coordinator's configured ``k`` (the native plane is a pure byte
    relay and cannot detect a mismatch).
    """

    def __init__(self, host: str, port: int, n_clients: int,
                 batch_size: int, dim: int, k: int,
                 engine_addrs: List[tuple],
                 queries_per_client: Optional[int] = None):
        self.host, self.port = host, port
        self.n_clients = n_clients
        self.request_bytes = wire.request_nbytes(batch_size, dim)
        self.answer_bytes = wire.answer_nbytes(batch_size, k)
        self.engine_addrs = engine_addrs
        self.queries_per_client = queries_per_client or 0
        self.answered_query_cnt = 0

    def start(self) -> None:
        self.answered_query_cnt = native.coordinator_run(
            self.host, self.port, self.n_clients,
            self.request_bytes, self.answer_bytes,
            self.engine_addrs, self.queries_per_client)
