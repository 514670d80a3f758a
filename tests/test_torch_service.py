"""The port's retrieval service (``chamjax_torch/retrieval/wire.py``,
``external.py``, ``server.py``) against chamjax's on the CPU: the wire bytes
equal, each package's client served by the other's server over loopback,
and the send/poll/recv cases of ``tests/test_service.py``.  The port's
``RetrievalServer`` hosts the port's ``LocalRetriever``; its answers must
equal the same search run in process (distances rtol = atol = 1e-5, ids
equal up to the order of ties)."""

import socket
import threading
import time

import numpy as np
import pytest

from chamjax.retrieval import external as jexternal
from chamjax.retrieval import server as jserver
from chamjax.retrieval import wire as jwire

from chamjax_torch.config import IndexConfig, SearchConfig
from chamjax_torch.data import synthetic_dataset
from chamjax_torch.eval import tie_mismatches
from chamjax_torch.index import build_ivfpq
from chamjax_torch.retrieval import LocalRetriever
from chamjax_torch.retrieval import external as texternal
from chamjax_torch.retrieval import server as tserver
from chamjax_torch.retrieval import wire as twire

HOST = "127.0.0.1"
TOL = dict(rtol=1e-5, atol=1e-5)


def free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def connect_retry(make, attempts=100):
    for _ in range(attempts):
        try:
            return make()
        except OSError:
            time.sleep(0.05)
    raise ConnectionError("server never came up")


def serve(srv, **kw) -> threading.Thread:
    t = threading.Thread(target=srv.start, kwargs=kw, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,dim,nprobe,k", [(8, 128, 32, 100),
                                                (1, 16, 1, 1), (3, 96, 7, 10)])
def test_wire_bytes_equal_chamjax(batch, dim, nprobe, k):
    rng = np.random.default_rng(batch * dim)
    q = rng.standard_normal((batch, dim)).astype(np.float32)
    lids = rng.integers(0, 2 ** 40, (batch, nprobe)).astype(np.int64)
    ids = rng.integers(-1, 10 ** 9, (batch, k)).astype(np.int64)
    dists = rng.random((batch, k)).astype(np.float32)
    for enc, args in (("encode_request", (q, k)),
                      ("encode_request_with_lists", (q, lids, k)),
                      ("encode_answer", (ids, dists))):
        assert getattr(twire, enc)(*args) == getattr(jwire, enc)(*args), enc
    assert (twire.request_nbytes(batch, dim), twire.answer_nbytes(batch, k),
            twire.request_with_lists_nbytes(batch, dim, nprobe)) == (
        jwire.request_nbytes(batch, dim), jwire.answer_nbytes(batch, k),
        jwire.request_with_lists_nbytes(batch, dim, nprobe))
    buf = jwire.encode_request(q, k)
    q2, k2 = twire.decode_request(buf, batch, dim)
    np.testing.assert_array_equal(q2, q)
    assert k2 == k
    q3, l3, k3 = twire.decode_request_with_lists(
        jwire.encode_request_with_lists(q, lids, k))
    np.testing.assert_array_equal(q3, q)
    np.testing.assert_array_equal(l3, lids)
    assert k3 == k
    i4, d4 = twire.decode_answer(jwire.encode_answer(ids, dists), batch, k)
    np.testing.assert_array_equal(i4, ids)
    np.testing.assert_array_equal(d4, dists)


# ---------------------------------------------------------------------------
# the send/poll/recv cases of tests/test_service.py
# ---------------------------------------------------------------------------


def test_random_server_roundtrip():
    port = free_port()
    serve(tserver.RandomAnswerServer(HOST, port, batch_size=4, dim=16))
    r = connect_retry(lambda: texternal.ExternalRetriever(HOST, port, 4, 16,
                                                          k=10))
    q = np.random.default_rng(0).standard_normal((4, 16)).astype(np.float32)
    res = r.retrieve(q, nprobe=8, k=10)
    assert res.ids.shape == (4, 10)
    assert res.dists.shape == (4, 10)
    assert np.all(np.diff(res.dists, axis=1) >= 0)   # sorted answers
    r.close()


def test_send_poll_recv_split_with_delay():
    """The split the tik-tok scheduler depends on: poll() is False while
    the delayed answer is in flight, then recv drains FIFO."""
    port = free_port()
    serve(tserver.RandomAnswerServer(HOST, port, batch_size=2, dim=8,
                                     delay_ms=200))
    r = connect_retry(lambda: texternal.ExternalRetriever(HOST, port, 2, 8,
                                                          k=5))
    q = np.zeros((2, 8), np.float32)
    t0 = time.perf_counter()
    r.retrieve_send(q, nprobe=4, k=5)
    assert time.perf_counter() - t0 < 0.1   # send is non-blocking
    assert not r.poll()                      # answer not ready yet
    while not r.poll():
        time.sleep(0.01)
    res = r.retrieve_recv()
    assert res.ids.shape == (2, 5)
    assert time.perf_counter() - t0 >= 0.2   # delay was actually injected
    r.close()


def test_port_client_with_chamjax_server():
    """The port's client against chamjax's mock engine: two requests in
    flight, answered in order, the same answers as chamjax's client gets
    from an engine with the same seed."""
    answers = []
    for client in (texternal.ExternalRetriever, jexternal.ExternalRetriever):
        port = free_port()
        t = serve(jserver.RandomAnswerServer(HOST, port, batch_size=3, dim=8,
                                             seed=4))
        r = connect_retry(lambda: client(HOST, port, 3, 8, k=6))
        q = np.ones((3, 8), np.float32)
        r.retrieve_send(q, nprobe=4, k=6)
        r.retrieve_send(q, nprobe=4, k=6)
        answers.append([r.retrieve_recv() for _ in range(2)])
        r.close()
        t.join(timeout=10)
        assert not t.is_alive()
    for got, want in zip(*answers):
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.dists, want.dists)


@pytest.fixture(scope="module")
def engine():
    ds = synthetic_dataset(nb=4000, nq=12, nt=3000, d=32, seed=6,
                           n_clusters=16)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=32, nlist=16, m=8, list_pad=64),
                      xt=ds.xt, kmeans_iters=3, pq_iters=3, device="cpu")
    return ds, LocalRetriever(idx, SearchConfig(nprobe=4, k=5,
                                                use_approx_topk=False),
                              device="cpu")


def same_up_to_ties(got, want):
    np.testing.assert_allclose(got.dists, want.dists, **TOL)
    bad = tie_mismatches(got.dists, got.ids, want.dists, want.ids, **TOL)
    assert not bad, bad


@pytest.mark.parametrize("with_lists", [False, True])
def test_chamjax_client_with_port_server(engine, with_lists):
    """chamjax's client against the port's RetrievalServer hosting the
    port's LocalRetriever, both request flavours: the answers equal the
    same search in process."""
    ds, r = engine
    port = free_port()
    t = serve(tserver.RetrievalServer(r, HOST, port, batch_size=4, dim=32,
                                      nprobe=4), with_lists=with_lists)
    c = connect_retry(lambda: jexternal.ExternalRetriever(HOST, port, 4, 32,
                                                          k=5, nprobe=4))
    lists = np.random.default_rng(2).integers(0, 16, (12, 4))
    for i in range(0, 12, 4):
        q = ds.xq[i:i + 4]
        if with_lists:
            got = c.retrieve_with_lists(q, lists[i:i + 4], 5)
            want = r.retrieve_with_lists(q, lists[i:i + 4], 5)
        else:
            got = c.retrieve(q, 4, 5)
            want = r.retrieve(q, 4, 5)
        assert got.ids.dtype == np.int64 and got.ids.shape == (4, 5)
        same_up_to_ties(got, want)
    c.close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_port_client_pipelines_against_port_server(engine):
    """Two requests in flight on one connection (the tik-tok pattern):
    recv drains them in send order."""
    ds, r = engine
    port = free_port()
    t = serve(tserver.RetrievalServer(r, HOST, port, batch_size=4, dim=32,
                                      nprobe=4))
    c = connect_retry(lambda: texternal.ExternalRetriever(HOST, port, 4, 32,
                                                          k=5, nprobe=4))
    c.retrieve_send(ds.xq[:4], 4, 5)
    c.retrieve_send(ds.xq[4:8], 4, 5)
    for i in (0, 4):
        same_up_to_ties(c.retrieve_recv(), r.retrieve(ds.xq[i:i + 4], 4, 5))
    c.close()
    t.join(timeout=10)
    assert not t.is_alive()
