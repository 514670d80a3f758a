"""Binary wire format for the retrieval service mesh (the port's copy of
``chamjax/retrieval/wire.py``; the bytes are the same).

Semantics-compatible with the reference protocol
(``ralm/retriever/serialization_utils.py:17-94``): big-endian framing,

- plain request            : int32 k  ||  batch*dim float32 queries
- request with lists       : header (batch, dim, nprobe, k : int32)
                             ||  batch*dim float32 queries
                             ||  batch*nprobe int64 list IDs
- answer                   : batch*k int64 ids  ||  batch*k float32 dists

The reference fixes (batch, dim) out-of-band via config; we keep that
contract (decoders take batch/dim as arguments) so the two framings stay
byte-compatible in spirit.  All helpers are pure numpy.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

BE_I32 = np.dtype(">i4")
BE_I64 = np.dtype(">i8")
BE_F32 = np.dtype(">f4")


def request_nbytes(batch: int, dim: int) -> int:
    return 4 + batch * dim * 4


def request_with_lists_nbytes(batch: int, dim: int, nprobe: int) -> int:
    return 16 + batch * dim * 4 + batch * nprobe * 8


def answer_nbytes(batch: int, k: int) -> int:
    return batch * k * 8 + batch * k * 4


def encode_request(queries: np.ndarray, k: int) -> bytes:
    """Plain retrieval request: the engine does its own coarse scan."""
    q = np.ascontiguousarray(queries, dtype=np.float32)
    return struct.pack(">i", k) + q.astype(BE_F32).tobytes()


def decode_request(buf: bytes, batch: int, dim: int) -> Tuple[np.ndarray, int]:
    (k,) = struct.unpack(">i", buf[:4])
    q = np.frombuffer(buf, dtype=BE_F32, count=batch * dim, offset=4)
    return q.astype(np.float32).reshape(batch, dim), k


def encode_request_with_lists(
    queries: np.ndarray, list_ids: np.ndarray, k: int
) -> bytes:
    """Request carrying pre-computed IVF cell IDs (disaggregated coarse scan,
    the path that pairs an index scanner with a remote PQ engine)."""
    q = np.ascontiguousarray(queries, dtype=np.float32)
    lids = np.ascontiguousarray(list_ids, dtype=np.int64)
    batch, dim = q.shape
    nprobe = lids.shape[1]
    hdr = struct.pack(">iiii", batch, dim, nprobe, k)
    return hdr + q.astype(BE_F32).tobytes() + lids.astype(BE_I64).tobytes()


def decode_request_with_lists(buf: bytes):
    batch, dim, nprobe, k = struct.unpack(">iiii", buf[:16])
    off = 16
    q = np.frombuffer(buf, dtype=BE_F32, count=batch * dim, offset=off)
    off += batch * dim * 4
    lids = np.frombuffer(buf, dtype=BE_I64, count=batch * nprobe, offset=off)
    return (
        q.astype(np.float32).reshape(batch, dim),
        lids.astype(np.int64).reshape(batch, nprobe),
        k,
    )


def encode_answer(ids: np.ndarray, dists: np.ndarray) -> bytes:
    i = np.ascontiguousarray(ids, dtype=np.int64)
    d = np.ascontiguousarray(dists, dtype=np.float32)
    assert i.shape == d.shape
    return i.astype(BE_I64).tobytes() + d.astype(BE_F32).tobytes()


def decode_answer(buf: bytes, batch: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    n = batch * k
    ids = np.frombuffer(buf, dtype=BE_I64, count=n).astype(np.int64)
    dists = np.frombuffer(buf, dtype=BE_F32, count=n, offset=n * 8).astype(np.float32)
    return ids.reshape(batch, k), dists.reshape(batch, k)
