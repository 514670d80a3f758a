"""The port's host runtime (``chamjax_torch/native``, built from its own copy
of the C++ sources) against chamjax's (``chamjax/native``) on the CPU: each
case of ``tests/test_native.py`` run through both packages, the window
gathers inside every window's length, and the streamed tier bit-equal with
the native and the numpy gather.  Sockets are ephemeral loopback ports;
every client wait has a timeout and every thread is joined with one."""

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from chamjax import native as jnative
from chamjax.config import IndexConfig, SearchConfig
from chamjax.data import synthetic_dataset
from chamjax.data.datasets import write_fvecs
from chamjax.index import build_ivfpq
from chamjax.ops.coarse import coarse_scan
from chamjax.retrieval import coordinator as jcoordinator
from chamjax.retrieval import external as jexternal
from chamjax.retrieval import server as jserver
from chamjax.retrieval.local import NativeCPURetriever as JNativeCPURetriever

from chamjax_torch import native as tnative
from chamjax_torch import streamed as tstreamed
from chamjax_torch.config import SearchConfig as TSearchConfig
from chamjax_torch.data import datasets as tdatasets
from chamjax_torch.eval import tie_mismatches
from chamjax_torch.retrieval import coordinator as tcoordinator
from chamjax_torch.retrieval import external as texternal
from chamjax_torch.retrieval import server as tserver
from chamjax_torch.retrieval.local import NativeCPURetriever
from chamjax_torch.searcher import IVFSearcher as TIVFSearcher

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


PACKAGES = {
    "chamjax": (jnative, jcoordinator, jserver, jexternal),
    "chamjax_torch": (tnative, tcoordinator, tserver, texternal),
}


# ---------------------------------------------------------------------------
# build, load, vecs
# ---------------------------------------------------------------------------


def test_native_builds_and_loads():
    assert tnative.available(), "libchamnet must compile here"
    lib = tnative.load()
    assert lib.cham_vecs_dim(b"/nonexistent") < 0
    assert jnative.load().cham_vecs_dim(b"/nonexistent") < 0
    # the port loads its own build of its own sources
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.parent.name == "chamjax_torch"
    assert lib._name == str(path)
    for name in tnative.SOURCES:
        src = (tnative.SRC_DIR / name).read_text().splitlines()
        ref = os.path.join(os.path.dirname(jnative.__file__), "src", name)
        want = open(ref).read().splitlines()
        assert f"chamjax/native/src/{name}" in src[0]
        assert src[1:] == want, f"{name} is not a verbatim copy"


def test_library_name_hashes_sources_and_flags(monkeypatch):
    """An edit to a source or to the flags names another library."""
    path = tnative.library_path()
    monkeypatch.setattr(tnative, "GXX_FLAGS", tnative.GXX_FLAGS + ("-g",))
    assert tnative.library_path() != path


def test_native_read_vecs_parity(tmp_path):
    x = np.random.default_rng(0).standard_normal((100, 24)).astype(np.float32)
    path = str(tmp_path / "x.fvecs")
    write_fvecs(path, x)
    got = tnative.read_vecs(path, "f")
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(got, jnative.read_vecs(path, "f"))
    np.testing.assert_array_equal(tdatasets.read_fvecs(path), x)
    np.testing.assert_array_equal(tnative.read_vecs(path, "f", max_rows=7),
                                  jnative.read_vecs(path, "f", max_rows=7))
    with pytest.raises(IOError):
        tnative.read_vecs(str(tmp_path / "missing.fvecs"))


# ---------------------------------------------------------------------------
# the native coordinator, each package's topology
# ---------------------------------------------------------------------------


def relay(pkg: str, n_requests: int = 6):
    """2 clients -> the package's native coordinator -> 2 of its random-
    answer engines; the clients take turns, so request j goes to engine j
    mod 2 and every answer is determined by the engines' seeds."""
    native, coordinator, server, external = PACKAGES[pkg]
    batch, dim, k, n_clients = 4, 16, 10, 2
    eng_ports = [free_port(), free_port()]
    coord_port = free_port()
    engines = [server.RandomAnswerServer(HOST, p, batch_size=batch, dim=dim,
                                         seed=s)
               for s, p in enumerate(eng_ports)]
    threads = [start(e.start) for e in engines]
    coord = coordinator.NativeCoordinator(
        HOST, coord_port, n_clients, batch, dim, k,
        engine_addrs=[(HOST, p) for p in eng_ports],
        queries_per_client=n_requests)
    ct = start(coord.start)
    clients = [connect_retry(lambda: external.ExternalRetriever(
        HOST, coord_port, batch, dim, k, timeout=WAIT_S))
        for _ in range(n_clients)]
    for c in clients:
        c.sync_with_coordinator()
    rng = np.random.default_rng(0)
    answers = []
    for _ in range(n_requests):
        for c in clients:
            q = rng.standard_normal((batch, dim)).astype(np.float32)
            res = c.retrieve(q, nprobe=8, k=k)
            assert res.ids.shape == (batch, k)
            assert np.all(np.diff(res.dists, axis=1) >= 0)
            answers.append(res)
    for c in clients:
        c.close()
    ct.join(timeout=WAIT_S)
    assert not ct.is_alive(), "native coordinator must terminate"
    assert coord.answered_query_cnt == n_clients * n_requests
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    return answers


def test_native_coordinator_relay():
    """Every client gets its own answers back in FIFO order, the same
    answers through either package's relay."""
    got, want = relay("chamjax_torch"), relay("chamjax")
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.dists, w.dists)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_native_coordinator_runs_until_disconnect(pkg):
    """queries_per_client=0: relay until the clients hang up."""
    native, coordinator, server, external = PACKAGES[pkg]
    batch, dim, k = 2, 8, 5
    eng_port, coord_port = free_port(), free_port()
    eng = server.RandomAnswerServer(HOST, eng_port, batch_size=batch,
                                    dim=dim)
    et = start(eng.start)
    coord = coordinator.NativeCoordinator(HOST, coord_port, 1, batch, dim,
                                          k, engine_addrs=[(HOST, eng_port)])
    ct = start(coord.start)
    c = connect_retry(lambda: external.ExternalRetriever(
        HOST, coord_port, batch, dim, k, timeout=WAIT_S))
    c.sync_with_coordinator()
    res = c.retrieve(np.zeros((batch, dim), np.float32), nprobe=4, k=k)
    assert res.ids.shape == (batch, k)
    c.close()
    ct.join(timeout=WAIT_S)
    assert not ct.is_alive()
    assert coord.answered_query_cnt == 1
    et.join(timeout=WAIT_S)
    assert not et.is_alive()


# ---------------------------------------------------------------------------
# HNSW
# ---------------------------------------------------------------------------


def test_hnsw_recall_and_saveload(tmp_path):
    """R@10 >= 0.95 against brute force, nearest first, save/load keeps the
    results, incremental adds keep their labels; the same ids and
    distances as chamjax's HNSWIndex built with the same seed."""
    rng = np.random.default_rng(7)
    xb = rng.standard_normal((2500, 24)).astype(np.float32)
    xq = rng.standard_normal((40, 24)).astype(np.float32)
    out = {}
    for name, mod in (("t", tnative), ("j", jnative)):
        idx = mod.HNSWIndex(24, M=16, ef_construction=120, seed=42)
        idx.add(xb[:2000])
        idx.add(xb[2000:], labels=np.arange(2000, 2500))
        assert len(idx) == 2500
        out[name] = idx.search(xq, k=10, ef=120)
        p = str(tmp_path / f"{name}.hnsw")
        idx.save(p)
        lab2, _ = mod.HNSWIndex.load_file(p, 24).search(xq, k=10, ef=120)
        np.testing.assert_array_equal(out[name][0], lab2)
    lab, dist = out["t"]
    np.testing.assert_array_equal(lab, out["j"][0])
    np.testing.assert_array_equal(dist, out["j"][1])
    gt = np.argsort(((xq[:, None] - xb[None]) ** 2).sum(-1), axis=1)[:, :10]
    rec = np.mean([len(set(lab[i]) & set(gt[i])) / 10
                   for i in range(len(xq))])
    assert rec >= 0.95, rec
    assert np.all(np.diff(dist, axis=1) >= 0)
    assert (tmp_path / "t.hnsw").read_bytes() == \
        (tmp_path / "j.hnsw").read_bytes()


@pytest.mark.parametrize("mod", [tnative, jnative],
                         ids=["chamjax_torch", "chamjax"])
def test_hnsw_load_rejects_inconsistent_graph(tmp_path, mod):
    """A file whose layer structure is inconsistent (the entry node missing
    its top list) or truncated is rejected at load."""
    rng = np.random.default_rng(3)
    idx = mod.HNSWIndex(8, M=4, ef_construction=32)
    idx.add(rng.standard_normal((200, 8)).astype(np.float32))
    p = str(tmp_path / "g.hnsw")
    idx.save(p)
    raw = bytearray(open(p, "rb").read())
    # header: [magic, dim, M, Mmax0, efc, n, entry+1, max_level+1] u64le
    (maxl,) = struct.unpack_from("<Q", raw, 7 * 8)
    struct.pack_into("<Q", raw, 7 * 8, maxl + 1)
    bad = str(tmp_path / "bad.hnsw")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        mod.HNSWIndex.load_file(bad, 8)
    open(bad, "wb").write(bytes(raw[: len(raw) // 2]))
    with pytest.raises(IOError):
        mod.HNSWIndex.load_file(bad, 8)


# ---------------------------------------------------------------------------
# the CPU IVF-PQ engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_setup():
    ds = synthetic_dataset(nb=20000, nq=16, nt=8000, d=32, seed=7,
                           n_clusters=64)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=32, nlist=64, m=8, list_pad=64),
                      xt=ds.xt, kmeans_iters=5, pq_iters=5)
    return ds, idx, carry(idx)


def held_to_searcher(d_n, i_n, d_r, i_r):
    """The engine's bar against the port's searcher with f32 LUTs:
    distances within rtol 1e-4, ids equal except at ties."""
    np.testing.assert_allclose(d_n, d_r, rtol=1e-4, atol=1e-4)
    assert not tie_mismatches(d_n, i_n, d_r, i_r, rtol=1e-4, atol=1e-4)


def test_native_ivfpq_matches_searcher(engine_setup):
    """The port's engine against the port's IVFSearcher on the CPU (f32
    LUTs, exact selection), on the full and the preassigned paths, and
    bit-equal to chamjax's engine on both."""
    ds, idx, tidx = engine_setup
    ref = TIVFSearcher(tidx, TSearchConfig(nprobe=8, k=10, lut_bf16=False),
                       device="cpu")
    d_r, i_r = ref.search(ds.xq)
    eng = tnative.NativeIVFPQ(tidx)
    jeng = jnative.NativeIVFPQ(idx)
    d_n, i_n = eng.search(ds.xq, nprobe=8, k=10)
    held_to_searcher(d_n, i_n, d_r, i_r)
    d_j, i_j = jeng.search(ds.xq, nprobe=8, k=10)
    np.testing.assert_array_equal(d_n, d_j)
    np.testing.assert_array_equal(i_n, i_j)

    lids, _ = coarse_scan(ds.xq, idx.centroids, 8)
    lids = np.asarray(lids)
    d_p, i_p = eng.search_preassigned(ds.xq, lids, k=10)
    held_to_searcher(d_p, i_p, d_r, i_r)
    d_pj, i_pj = jeng.search_preassigned(ds.xq, lids, k=10)
    np.testing.assert_array_equal(d_p, d_pj)
    np.testing.assert_array_equal(i_p, i_pj)
    # the searcher's own preassigned path on the same lists
    d_s, i_s = ref.search_preassigned(ds.xq, lids)
    held_to_searcher(d_p, i_p, d_s, i_s)
    eng.close()
    jeng.close()


def test_native_ivfpq_opq_rotation():
    """An OPQ index: the engine rotates the queries as the searcher does."""
    ds = synthetic_dataset(nb=10000, nq=8, nt=6000, d=32, seed=13,
                           n_clusters=32)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=32, nlist=32, m=8, list_pad=64,
                                         opq=True),
                      xt=ds.xt, kmeans_iters=4, pq_iters=4)
    tidx = carry(idx)
    assert tidx.opq_R is not None
    d_r, i_r = TIVFSearcher(tidx, TSearchConfig(nprobe=8, k=10,
                                                lut_bf16=False),
                            device="cpu").search(ds.xq)
    eng = tnative.NativeIVFPQ(tidx)
    d_n, i_n = eng.search(ds.xq, nprobe=8, k=10)
    held_to_searcher(d_n, i_n, d_r, i_r)
    d_j, i_j = jnative.NativeIVFPQ(idx).search(ds.xq, nprobe=8, k=10)
    np.testing.assert_array_equal(d_n, d_j)
    np.testing.assert_array_equal(i_n, i_j)
    eng.close()


@pytest.fixture(scope="module")
def small_index():
    ds = synthetic_dataset(nb=8000, nq=8, nt=4000, d=16, seed=1,
                           n_clusters=32)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=16, nlist=32, m=4, list_pad=64),
                      xt=ds.xt, kmeans_iters=3, pq_iters=3)
    return ds, idx, carry(idx)


def test_native_cpu_retriever_contract(small_index):
    ds, idx, tidx = small_index
    r = NativeCPURetriever(tidx, TSearchConfig(nprobe=4, k=5))
    res = r.retrieve(ds.xq[:4], nprobe=4, k=5)
    assert res.ids.shape == (4, 5) and res.dists.shape == (4, 5)
    assert res.ids.dtype == np.int64
    assert (np.diff(res.dists, axis=1) >= -1e-5).all()
    want = JNativeCPURetriever(idx, SearchConfig(nprobe=4, k=5)).retrieve(
        ds.xq[:4], nprobe=4, k=5)
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_array_equal(res.dists, want.dists)
    # nprobe / k of 0 take the config's
    res0 = r.retrieve(ds.xq[:4], nprobe=0, k=0)
    np.testing.assert_array_equal(res0.ids, res.ids)
    # the async split inherited from BaseRetriever
    r.retrieve_send(ds.xq[:4], 4, 5)
    assert r.poll()
    np.testing.assert_array_equal(r.retrieve_recv(4, 5).ids, res.ids)
    lids = np.asarray(coarse_scan(ds.xq[:4], idx.centroids, 4)[0])
    pre = r.retrieve_with_lists(ds.xq[:4], lids, 5)
    np.testing.assert_array_equal(pre.ids, res.ids)
    r.set_nprobe(8)
    assert r.scfg.nprobe == 8
    r.close()


@pytest.mark.parametrize("with_lists", [False, True])
def test_native_engine_behind_tcp_server(small_index, with_lists):
    """NativeCPURetriever served over the wire by the port's
    RetrievalServer; chamjax's client gets the engine's direct answer."""
    ds, idx, tidx = small_index
    retr = NativeCPURetriever(tidx, TSearchConfig(nprobe=4, k=5))
    port = free_port()
    srv = tserver.RetrievalServer(retr, HOST, port, batch_size=8, dim=16,
                                  nprobe=4)
    th = start(srv.start, n_connections=1, with_lists=with_lists)
    cli = connect_retry(lambda: jexternal.ExternalRetriever(
        HOST, port, 8, 16, 5, nprobe=4, timeout=WAIT_S))
    if with_lists:
        lids = np.asarray(coarse_scan(ds.xq, idx.centroids, 4)[0])
        res = cli.retrieve_with_lists(ds.xq, lids, k=5)
        direct = retr.retrieve_with_lists(ds.xq, lids, k=5)
    else:
        res = cli.retrieve(ds.xq, nprobe=4, k=5)
        direct = retr.retrieve(ds.xq, nprobe=4, k=5)
    np.testing.assert_array_equal(res.ids, direct.ids)
    np.testing.assert_allclose(res.dists, direct.dists, rtol=1e-6)
    cli.close()
    th.join(timeout=WAIT_S)
    assert not th.is_alive()
    assert srv.served == [1]


# ---------------------------------------------------------------------------
# the window gathers and the streamed tier
# ---------------------------------------------------------------------------


WINDOWS = dict(
    # a window cut at the array's end, an empty one, a negative length, a
    # start past the end, a start 0, one of length seg
    starts=np.array([[37, 0, 5, 44, 0, 12]], np.int32),
    lens=np.array([[3, 0, -2, 1, 1, 8]], np.int32),
)


def test_gather_codes_equal_chamjax_inside_every_window():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 256, (40, 6)).astype(np.uint8)
    seg = 8
    got = tnative.gather_codes(codes, WINDOWS["starts"], WINDOWS["lens"], seg)
    want = jnative.gather_codes(codes, WINDOWS["starts"], WINDOWS["lens"],
                                seg)
    assert got.shape == (6, seg, 6)
    for w, (s, ln) in enumerate(zip(WINDOWS["starts"][0],
                                    WINDOWS["lens"][0])):
        n = max(0, min(int(ln), 40 - int(s)))
        np.testing.assert_array_equal(got[w, :n], want[w, :n])
        np.testing.assert_array_equal(got[w, :n], codes[s:s + n])
    # the reference fills the same way: the whole slab equal
    np.testing.assert_array_equal(got, want)
    assert not got[1].any() and not got[2].any() and not got[3].any()


def test_gather_codes_writes_into_out():
    codes = np.arange(40 * 4, dtype=np.uint8).reshape(40, 4)
    out = np.full((6, 8, 4), 7, np.uint8)
    res = tnative.gather_codes(codes, WINDOWS["starts"], WINDOWS["lens"], 8,
                               out=out)
    assert res is out
    np.testing.assert_array_equal(out, tnative.gather_codes(
        codes, WINDOWS["starts"], WINDOWS["lens"], 8))
    for bad in (np.empty((6, 8, 4), np.int32), np.empty((6, 8, 5), np.uint8),
                np.empty((6, 4, 8), np.uint8).transpose(0, 2, 1)):
        with pytest.raises(ValueError, match="out"):
            tnative.gather_codes(codes, WINDOWS["starts"], WINDOWS["lens"],
                                 8, out=bad)


def test_gather_windows_equal_chamjax():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 256, (40, 6)).astype(np.uint8)
    ids = rng.integers(0, 1 << 30, 40).astype(np.int32)
    got = tnative.gather_windows(codes, ids, WINDOWS["starts"],
                                 WINDOWS["lens"], 8)
    want = jnative.gather_windows(codes, ids, WINDOWS["starts"],
                                  WINDOWS["lens"], 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1][1] == -1).all()


@pytest.fixture(scope="module")
def streamed_index():
    ds = synthetic_dataset(nb=20000, nq=16, nt=8000, d=32, seed=11,
                           n_clusters=64)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=32, nlist=64, m=8, list_pad=64),
                      xt=ds.xt, kmeans_iters=6, pq_iters=6)
    return ds, carry(idx)


@pytest.mark.parametrize("tiled", [True, False])
def test_streamed_native_and_numpy_gathers_bit_equal(streamed_index, tiled):
    """The searcher's results with the native gather equal those with the
    numpy gather bit for bit, sequential and pipelined; the slabs agree
    inside every window's length."""
    ds, tidx = streamed_index
    cfg = TSearchConfig(nprobe=8, k=10, tiled=tiled)
    st_n = tstreamed.HostStreamedSearcher(tidx, cfg, device="cpu",
                                          gather="native")
    st_p = tstreamed.HostStreamedSearcher(tidx, cfg, device="cpu",
                                          gather="numpy")
    assert (st_n.gather_path, st_p.gather_path) == ("native", "numpy")
    for a, b in ((st_n.search(ds.xq), st_p.search(ds.xq)),):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    batches = [ds.xq[:8], ds.xq[8:], ds.xq[3:7]]
    for a, b in zip(st_n.search_pipelined(batches),
                    st_p.search_pipelined(batches)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    plan = st_n._plan(ds.xq)
    starts, lens = st_n._pull_windows(plan)
    slab_n = st_n._gather(starts, lens, 0).numpy()
    slab_p = st_p._gather(starts, lens, 0).numpy()
    for w, (s, ln) in enumerate(zip(starts.reshape(-1), lens.reshape(-1))):
        n = max(0, min(int(ln), st_n.n_pad - int(s)))
        np.testing.assert_array_equal(slab_n[w, :n], slab_p[w, :n])
        assert n == 0 or np.array_equal(slab_n[w, :n], tidx.codes[s:s + n])


def test_streamed_gather_choice(streamed_index, monkeypatch):
    """``auto`` takes the native gather where the library builds, numpy
    where it cannot; ``native`` then raises instead of falling back."""
    _ds, tidx = streamed_index
    cfg = TSearchConfig(nprobe=8, k=10)
    assert tstreamed.HostStreamedSearcher(tidx, cfg, device="cpu"
                                          ).gather_path == "native"
    with pytest.raises(ValueError, match="gather"):
        tstreamed.HostStreamedSearcher(tidx, cfg, device="cpu", gather="c")

    def unavailable():
        raise tnative.NativeUnavailable("no g++")

    monkeypatch.setattr(tnative, "load", unavailable)
    assert tstreamed.HostStreamedSearcher(tidx, cfg, device="cpu"
                                          ).gather_path == "numpy"
    with pytest.raises(tnative.NativeUnavailable):
        tstreamed.HostStreamedSearcher(tidx, cfg, device="cpu",
                                       gather="native")
