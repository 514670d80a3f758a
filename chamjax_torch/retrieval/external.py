"""TCP retrieval client — the cross-node leg of the disaggregated design
(the port's copy of ``chamjax/retrieval/external.py``).

Parity with the reference's ``ExternalRetriever``
(``ralm/retriever/retriever.py:68-185``): blocking connect with
``TCP_NODELAY``, loop-until-n-bytes send/recv, a split
``retrieve_send`` / ``poll`` / ``retrieve_recv`` API for the tik-tok
scheduler, and the 4-byte echo barrier used to sync all clients with the
coordinator before timing starts (``retriever.py:89-107``)."""

from __future__ import annotations

import select
import socket
import struct
import time
from collections import deque
from typing import Optional

import numpy as np

from chamjax_torch.retrieval import wire
from chamjax_torch.retrieval.interface import BaseRetriever, RetrievalResult


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("socket closed mid-message")
        got += r
    return bytes(buf)


def send_all(sock: socket.socket, data: bytes) -> None:
    sock.sendall(data)


class ExternalRetriever(BaseRetriever):
    """Client for a remote retrieval engine (server or coordinator)."""

    def __init__(self, host: str, port: int, batch_size: int, dim: int,
                 k: int, nprobe: int = 32, timeout: Optional[float] = None,
                 retry_s: float = 0.0):
        self.batch = batch_size
        self.dim = dim
        self.k = k
        self.nprobe = nprobe
        deadline = time.time() + retry_s
        while True:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if timeout:
                self.sock.settimeout(timeout)
            try:
                self.sock.connect((host, port))
                break
            except OSError:
                # sweep mode: the launcher restarts the coordinator between
                # configs; retry until its listener is back up
                self.sock.close()
                if time.time() >= deadline:
                    raise
                time.sleep(0.25)
        self._poller = select.poll()
        self._poller.register(self.sock, select.POLLIN)
        self._inflight: deque = deque()   # (batch, k) of outstanding sends

    # --- barrier (4-byte echo handshake, reference :89-107) ---

    def sync_with_coordinator(self, payload: int = 0xC0DE) -> None:
        send_all(self.sock, struct.pack(">i", payload))
        echo = struct.unpack(">i", recv_exact(self.sock, 4))[0]
        assert echo == payload, f"barrier echo mismatch: {echo:#x}"

    # --- sync API ---

    def retrieve(self, queries: np.ndarray, nprobe: int, k: int
                 ) -> RetrievalResult:
        self.retrieve_send(queries, nprobe, k)
        return self.retrieve_recv(np.asarray(queries).shape[0], k)

    def retrieve_with_lists(self, queries: np.ndarray, list_ids: np.ndarray,
                            k: int) -> RetrievalResult:
        self.retrieve_with_lists_send(queries, list_ids, k)
        return self.retrieve_recv(np.asarray(queries).shape[0], k)

    # --- async split (tik-tok) ---

    def retrieve_send(self, queries: np.ndarray, nprobe: int, k: int) -> None:
        q = np.asarray(queries, np.float32)
        send_all(self.sock, wire.encode_request(q, k or self.k))
        self._inflight.append((q.shape[0], k or self.k))

    def retrieve_with_lists_send(self, queries: np.ndarray,
                                 list_ids: np.ndarray, k: int) -> None:
        q = np.asarray(queries, np.float32)
        send_all(self.sock,
                 wire.encode_request_with_lists(q, list_ids, k or self.k))
        self._inflight.append((q.shape[0], k or self.k))

    def poll(self) -> bool:
        return bool(self._poller.poll(0))

    def retrieve_recv(self, batch: Optional[int] = None,
                      k: Optional[int] = None) -> RetrievalResult:
        if self._inflight:
            batch, k = self._inflight.popleft()
        buf = recv_exact(self.sock, wire.answer_nbytes(batch, k))
        ids, dists = wire.decode_answer(buf, batch, k)
        return RetrievalResult(ids=ids, dists=dists)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
