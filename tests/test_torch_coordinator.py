"""The port's coordinator and index server (``chamjax_torch/retrieval/
coordinator.py``, ``index_scanner.py``, ``engine.py``) on the CPU: the
coordinator and index-server cases of ``tests/test_service.py``, each
package's clients through the other's coordinator, ``IndexScanner`` against
chamjax's, and an engine started as a process of its own.  Ports are
ephemeral loopback ports; every client has a socket timeout and every
thread and process is joined with one, so no case can hang the suite."""

import multiprocessing
import socket
import threading
import time
import warnings

import numpy as np
import pytest

from chamjax.config import IndexConfig
from chamjax.data import synthetic_dataset
from chamjax.index import build_ivfpq
from chamjax.ops.coarse import coarse_scan
from chamjax.retrieval import coordinator as jcoordinator
from chamjax.retrieval import external as jexternal
from chamjax.retrieval import server as jserver
from chamjax.retrieval.index_scanner import IndexScanner as JIndexScanner

from chamjax_torch.config import SearchConfig as TSearchConfig
from chamjax_torch.eval import tie_mismatches
from chamjax_torch.index.ivf import PackedIVF as TPackedIVF
from chamjax_torch.retrieval import coordinator as tcoordinator
from chamjax_torch.retrieval import engine as tengine
from chamjax_torch.retrieval import external as texternal
from chamjax_torch.retrieval import server as tserver
from chamjax_torch.retrieval.index_scanner import IndexScanner, IndexServer
from chamjax_torch.retrieval.local import NativeCPURetriever

from test_torch_search import carry

HOST = "127.0.0.1"
WAIT_S = 30          # every socket wait and thread join


def free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def connect_retry(make, attempts=200):
    for _ in range(attempts):
        try:
            return make()
        except OSError:
            time.sleep(0.05)
    raise ConnectionError("server never came up")


def start(target, **kw) -> threading.Thread:
    t = threading.Thread(target=target, kwargs=kw, daemon=True)
    t.start()
    return t


def client(external, port, batch, dim, k):
    return connect_retry(lambda: external.ExternalRetriever(
        HOST, port, batch, dim, k=k, timeout=WAIT_S))


def joined(t) -> None:
    t.join(timeout=WAIT_S)
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# test_service.py's coordinator cases, on the port
# ---------------------------------------------------------------------------


def round_robin(coordinator, server, external):
    """2 clients → coordinator → 2 mock engines, the clients in threads;
    every client gets exactly its own answers back (origin routing)."""
    e_ports = [free_port(), free_port()]
    engines = [server.RandomAnswerServer(HOST, p, batch_size=2, dim=8,
                                         seed=i)
               for i, p in enumerate(e_ports)]
    e_threads = [start(e.start) for e in engines]
    c_port = free_port()
    coord = coordinator.RetrieveCoordinator(
        HOST, c_port, n_clients=2, batch_size=2, dim=8, k=5,
        engine_addrs=[(HOST, p) for p in e_ports], queries_per_client=3)
    ct = start(coord.start)
    clients = [client(external, c_port, 2, 8, 5) for _ in range(2)]
    for c in clients:
        c.sync_with_coordinator()
    results = {}

    def run_client(ci):
        q = np.full((2, 8), ci, np.float32)
        results[ci] = [clients[ci].retrieve(q, nprobe=4, k=5)
                       for _ in range(3)]

    ts = [start(run_client, ci=ci) for ci in range(2)]
    for t in ts:
        joined(t)
    assert set(results) == {0, 1}
    for outs in results.values():
        assert len(outs) == 3
        for res in outs:
            assert res.ids.shape == (2, 5)
            np.testing.assert_array_equal(res.ids[0], np.arange(5))
            assert np.all(np.diff(res.dists, axis=1) >= 0)
    for c in clients:
        c.close()
    joined(ct)
    assert coord.answered_query_cnt == 6
    for t in e_threads:
        joined(t)
    assert [e.served for e in engines] == [[3], [3]]     # round robin


def test_coordinator_round_robin_two_clients_two_engines():
    round_robin(tcoordinator, tserver, texternal)


def test_coordinator_dummy_answer_mode():
    c_port = free_port()
    coord = tcoordinator.RetrieveCoordinator(
        HOST, c_port, n_clients=1, batch_size=2, dim=8, k=5,
        queries_per_client=2)
    ct = start(coord.start_dummy_answer)
    c = client(texternal, c_port, 2, 8, 5)
    c.sync_with_coordinator()
    q = np.zeros((2, 8), np.float32)
    for _ in range(2):
        res = c.retrieve(q, nprobe=4, k=5)
        np.testing.assert_array_equal(res.ids[0], np.arange(5))
        np.testing.assert_array_equal(res.dists, 0)
    c.close()
    joined(ct)
    assert coord.answered_query_cnt == 2


def test_index_server_tiktok_overlaps_latency():
    """Throughput mode: batch i+1's coarse scan lands between batch i's
    send and its recv (an event-order property, not wall clock)."""
    port = free_port()
    srv = tserver.RandomAnswerServer(HOST, port, batch_size=4, dim=16,
                                     delay_ms=20)
    st = start(srv.start, with_lists=True)
    r = client(texternal, port, 4, 16, 5)
    events = []

    class EventScanner(IndexScanner):
        def search(self, queries, nprobe=None):
            events.append("scan")
            return super().search(queries, nprobe)

    class EventRetriever:
        def __init__(self, inner):
            self._r = inner

        def retrieve_with_lists_send(self, q, lids, k):
            events.append("send")
            return self._r.retrieve_with_lists_send(q, lids, k)

        def retrieve_recv(self, batch, k):
            events.append("recv")
            return self._r.retrieve_recv(batch, k)

    rng = np.random.default_rng(0)
    centroids = rng.standard_normal((32, 16)).astype(np.float32)
    scanner = EventScanner(centroids, nprobe=4, device="cpu")
    server = IndexServer(scanner, EventRetriever(r), k=5)
    batches = [rng.standard_normal((4, 16)).astype(np.float32)
               for _ in range(4)]
    out = server.search_multi_batch_tiktok(batches)
    assert all(o is not None and o.ids.shape == (4, 5) for o in out)
    assert server.throughput_qps(batches) > 0
    n = len(batches)
    sends = [i for i, e in enumerate(events) if e == "send"]
    recvs = [i for i, e in enumerate(events) if e == "recv"]
    scans = [i for i, e in enumerate(events) if e == "scan"]
    assert len(sends) == len(recvs) == len(scans) == n
    for i in range(n - 1):
        assert sends[i] < scans[i + 1] < recvs[i], events
    # latency mode over the same connection
    lat = IndexServer(IndexScanner(centroids, nprobe=4, device="cpu"), r, k=5)
    assert len(lat.search_multi_batch(batches)) == n
    stats = lat.latency_stats_ms()
    assert stats["p95"] >= stats["p50"] >= 20.0    # the injected delay
    r.close()
    joined(st)


def test_coordinator_survives_engine_death():
    """An engine dying mid-run: its unanswered requests re-issue to the
    surviving engine."""

    class DyingServer(tserver.RandomAnswerServer):
        def __init__(self, *args, die_after=1, **kw):
            super().__init__(*args, **kw)
            self._answered = 0
            self._die_after = die_after

        def answer(self, queries, k, list_ids=None):
            if self._answered >= self._die_after:
                raise ConnectionError("engine crash (injected)")
            self._answered += 1
            return super().answer(queries, k, list_ids)

    e_ports = [free_port(), free_port()]
    dying = DyingServer(HOST, e_ports[0], batch_size=2, dim=8, die_after=1)
    healthy = tserver.RandomAnswerServer(HOST, e_ports[1], batch_size=2,
                                         dim=8)
    threads = [start(dying.start), start(healthy.start)]
    c_port = free_port()
    coord = tcoordinator.RetrieveCoordinator(
        HOST, c_port, n_clients=1, batch_size=2, dim=8, k=5,
        engine_addrs=[(HOST, p) for p in e_ports], queries_per_client=6)
    ct = start(coord.start)
    c = client(texternal, c_port, 2, 8, 5)
    c.sync_with_coordinator()
    q = np.zeros((2, 8), np.float32)
    answers = [c.retrieve(q, nprobe=4, k=5) for _ in range(6)]
    assert len(answers) == 6
    for res in answers:
        assert res.ids.shape == (2, 5)
        assert np.all(np.diff(res.dists, axis=1) >= 0)
    joined(ct)
    assert coord.answered_query_cnt == 6
    c.close()
    for t in threads:
        joined(t)
    assert (dying.served, healthy.served) == ([1], [5])


def test_coordinator_survives_client_death_on_answer():
    """A client that dies with a request in flight costs only that client;
    the other client's relay keeps running."""
    e_port = free_port()
    engine = tserver.RandomAnswerServer(HOST, e_port, batch_size=2, dim=8,
                                        delay_ms=150)
    et = start(engine.start)
    c_port = free_port()
    coord = tcoordinator.RetrieveCoordinator(
        HOST, c_port, n_clients=2, batch_size=2, dim=8, k=5,
        engine_addrs=[(HOST, e_port)])
    ct = start(coord.start)
    doomed = client(texternal, c_port, 2, 8, 5)
    survivor = client(texternal, c_port, 2, 8, 5)
    for c in (doomed, survivor):
        c.sync_with_coordinator()
    q = np.zeros((2, 8), np.float32)
    doomed.retrieve_send(q, nprobe=4, k=5)
    doomed.close()
    for _ in range(4):
        assert survivor.retrieve(q, nprobe=4, k=5).ids.shape == (2, 5)
    survivor.close()
    joined(ct)
    assert coord.answered_query_cnt == 5   # 1 bounced + 4 delivered
    joined(et)


def test_coordinator_rejects_k_mismatch():
    """A client requesting another k than the coordinator frames answers
    with is dropped loudly, not mis-framed."""
    e_port = free_port()
    engine = tserver.RandomAnswerServer(HOST, e_port, batch_size=2, dim=8)
    et = start(engine.start)
    c_port = free_port()
    coord = tcoordinator.RetrieveCoordinator(
        HOST, c_port, n_clients=1, batch_size=2, dim=8, k=5,
        engine_addrs=[(HOST, e_port)])
    ct = start(coord.start)
    c = client(texternal, c_port, 2, 8, 7)
    c.sync_with_coordinator()
    q = np.zeros((2, 8), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # fires on the coordinator thread
        c.retrieve_send(q, nprobe=4, k=7)
        with pytest.raises((ConnectionError, OSError)):
            c.retrieve_recv()
    c.close()
    joined(ct)
    assert coord.answered_query_cnt == 0
    joined(et)


# ---------------------------------------------------------------------------
# each package's clients through the other's coordinator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coord_pkg,client_pkg", [
    ("chamjax_torch", "chamjax"), ("chamjax", "chamjax_torch")])
@pytest.mark.parametrize("native", [False, True])
def test_clients_through_the_other_packages_coordinator(coord_pkg,
                                                        client_pkg, native):
    """Two clients taking turns through a coordinator and two engines of the
    other package: request j reaches engine j mod 2, so every answer is the
    engines' own (seeded) answer."""
    coordinator, server = ((tcoordinator, tserver)
                           if coord_pkg == "chamjax_torch"
                           else (jcoordinator, jserver))
    external = texternal if client_pkg == "chamjax_torch" else jexternal
    batch, dim, k, n_req = 3, 8, 4, 3
    e_ports = [free_port(), free_port()]
    engines = [server.RandomAnswerServer(HOST, p, batch_size=batch, dim=dim,
                                         seed=i)
               for i, p in enumerate(e_ports)]
    e_threads = [start(e.start) for e in engines]
    c_port = free_port()
    cls = (coordinator.NativeCoordinator if native
           else coordinator.RetrieveCoordinator)
    coord = cls(HOST, c_port, 2, batch, dim, k,
                engine_addrs=[(HOST, p) for p in e_ports],
                queries_per_client=None)
    ct = start(coord.start)
    clients = [client(external, c_port, batch, dim, k) for _ in range(2)]
    for c in clients:
        c.sync_with_coordinator()
    rngs = [np.random.default_rng(i) for i in range(2)]   # the engines'
    q = np.zeros((batch, dim), np.float32)
    for j in range(2 * n_req):
        res = clients[j % 2].retrieve(q, nprobe=4, k=k)
        want = np.sort(rngs[j % 2].random((batch, k)).astype(np.float32),
                       axis=1)
        np.testing.assert_array_equal(res.dists, want)
        np.testing.assert_array_equal(res.ids,
                                      np.broadcast_to(np.arange(k),
                                                      (batch, k)))
    for c in clients:
        c.close()
    joined(ct)
    assert coord.answered_query_cnt == 2 * n_req
    for t in e_threads:
        joined(t)


def test_round_robin_through_chamjax_coordinator_with_port_parts():
    """chamjax's coordinator relaying the port's engines and clients."""
    round_robin(jcoordinator, tserver, texternal)


# ---------------------------------------------------------------------------
# IndexScanner against chamjax's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scan_setup():
    ds = synthetic_dataset(nb=6000, nq=24, nt=3000, d=32, seed=3,
                           n_clusters=64)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=32, nlist=64, m=8, list_pad=64,
                                         opq=True),
                      xt=ds.xt, kmeans_iters=4, pq_iters=4)
    return ds, idx


def same_probes(lids_t, d_t, lids_j, d_j):
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-4)
    bad = tie_mismatches(np.asarray(d_t), lids_t, np.asarray(d_j), lids_j,
                         rtol=1e-5, atol=1e-4)
    assert not bad, bad


@pytest.mark.parametrize("coarse_cand", [0, 16, -1])
def test_index_scanner_matches_chamjax(scan_setup, coarse_cand):
    """List ids equal up to ties and distances close, with the exact and
    the two-stage selection; the graph-owned call runs eagerly on the
    CPU."""
    ds, idx = scan_setup
    ts = IndexScanner(idx.centroids, nprobe=8, coarse_cand=coarse_cand,
                      device="cpu")
    js = JIndexScanner(idx.centroids, nprobe=8, coarse_cand=coarse_cand)
    lt, dt = ts.search(ds.xq)
    lj, dj = js.search(ds.xq)
    assert lt.dtype == np.int64 and lt.shape == (24, 8)
    same_probes(lt, dt, lj, dj)
    assert len(ts.graphs) == 0          # CPU: nothing captured
    for nprobe in (4, 12):              # a per-call override
        lt, dt = ts.search(ds.xq[:5], nprobe=nprobe)
        lj, dj = js.search(ds.xq[:5], nprobe=nprobe)
        assert lt.shape == (5, nprobe)
        same_probes(lt, dt, lj, dj)


def test_index_scanner_narrow_cand_floors_at_nprobe(scan_setup):
    """test_search.py's narrow-shortlist case: a configured width below a
    runtime nprobe floors at nprobe and returns the exact probe set."""
    ds, idx = scan_setup
    sc = IndexScanner(idx.centroids, nprobe=8, coarse_cand=4, device="cpu")
    lids, dists = sc.search(ds.xq[:4], nprobe=32)
    assert lids.shape == (4, 32)
    exact, d_exact = coarse_scan(ds.xq[:4], idx.centroids, 32)
    same_probes(lids, dists, np.asarray(exact, np.int64), d_exact)


def test_index_scanner_rotates_an_opq_index(scan_setup):
    """With ``opq_R`` the scanner probes the lists the searcher probes
    (rotated queries); without it, chamjax's unrotated probes."""
    ds, idx = scan_setup
    tidx = carry(idx)
    rot = IndexScanner(tidx.centroids, nprobe=8, opq_R=tidx.opq_R,
                       device="cpu")
    lt, dt = rot.search(ds.xq)
    lj, dj = coarse_scan(ds.xq @ idx.opq_R, idx.centroids, 8)
    same_probes(lt, dt, np.asarray(lj, np.int64), np.asarray(dj))


# ---------------------------------------------------------------------------
# an engine as a process of its own
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_index(tmp_path_factory):
    ds = synthetic_dataset(nb=8000, nq=16, nt=4000, d=16, seed=2,
                           n_clusters=32)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=16, nlist=32, m=4, list_pad=64),
                      xt=ds.xt, kmeans_iters=3, pq_iters=3)
    path = str(tmp_path_factory.mktemp("engine") / "index.npz")
    carry(idx).save(path)
    return ds, path


def test_spawned_engine_serves_an_index_server(engine_index):
    """``run_engine`` in a spawned process (the CPU engine): an
    IndexServer's preassigned requests at two batch sizes, both modes,
    answered as the engine answers in process; the engine reports the
    batches it served."""
    ds, path = engine_index
    scfg = TSearchConfig(nprobe=4, k=5)
    ctx = multiprocessing.get_context("spawn")
    report = ctx.Queue()
    port = free_port()
    proc = ctx.Process(target=tengine.run_engine, args=(path, port),
                       kwargs=dict(backend="native", search_cfg=scfg,
                                   with_lists=True, warm=(4, 1),
                                   report=report), daemon=True)
    proc.start()
    try:
        r = connect_retry(lambda: texternal.ExternalRetriever(
            HOST, port, 4, 16, 5, timeout=WAIT_S), attempts=600)
        packed = TPackedIVF.load(path)
        server = IndexServer(IndexScanner(packed.centroids, nprobe=4,
                                          device="cpu"), r, k=5)
        local = NativeCPURetriever(packed, scfg)
        for b in (4, 1):
            batches = [ds.xq[i:i + b] for i in range(0, 8, b)]
            for out in (server.search_multi_batch(batches),
                        server.search_multi_batch_tiktok(batches)):
                for q, res in zip(batches, out):
                    lids, _ = server.scanner.search(q)
                    want = local.retrieve_with_lists(q, lids, 5)
                    np.testing.assert_array_equal(res.ids, want.ids)
                    np.testing.assert_array_equal(res.dists, want.dists)
        r.close()
        kind, out = report.get(timeout=WAIT_S)
        assert kind == "done", out
        assert out["served"] == [2 * (2 + 8)]
        assert out["launches"] == {}      # the CPU engine launches nothing
    finally:
        proc.join(timeout=WAIT_S)
        if proc.is_alive():
            proc.kill()
    assert proc.exitcode == 0


def test_spawned_engine_reports_a_failure(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    report = ctx.Queue()
    proc = ctx.Process(target=tengine.run_engine,
                       args=(str(tmp_path / "missing.npz"), free_port()),
                       kwargs=dict(backend="native", report=report),
                       daemon=True)
    proc.start()
    try:
        kind, tb = report.get(timeout=WAIT_S)
    finally:
        proc.join(timeout=WAIT_S)
        if proc.is_alive():
            proc.kill()
    assert kind == "failed" and "missing.npz" in tb
    assert proc.exitcode != 0


def test_scanner_and_engine_need_the_card_or_explicit_cpu(engine_index,
                                                          monkeypatch):
    """Without a card, the scanner and a local engine raise unless given
    ``device="cpu"``; nothing falls back to the CPU by itself."""
    import torch
    _ds, path = engine_index
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    centroids = TPackedIVF.load(path).centroids
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IndexScanner(centroids)
    assert IndexScanner(centroids, device="cpu").centroids.device.type == \
        "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.run_engine(path, free_port(), backend="local")
    with pytest.raises(ValueError, match="backend"):
        tengine.run_engine(path, free_port(), backend="card")
