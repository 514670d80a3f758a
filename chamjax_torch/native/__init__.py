"""The host (C++) runtime, bound with ctypes: the port's copy of
``chamjax/native``.

The sources in ``src/`` are copies of the JAX package's (each names its
origin on its first line):

- ``chamnet.cpp``: the epoll relay of the coordinator (``coordinator_run``)
  and the sequential vecs-file reader (``read_vecs``);
- ``gather.cpp``: the window gathers of the host-streamed tier
  (``gather_windows``, ``gather_codes``);
- ``ivfpq.cpp``: the CPU IVF-PQ engine (``NativeIVFPQ``);
- ``hnsw.cpp``: the HNSW graph index (``HNSWIndex``);
- ``adc_bench.cpp``: a standalone program, not in the library, that
  measures one core's ADC scan rate (``run_adc_bench``).

``load`` compiles them with ``g++`` on first use, into
``chamjax_torch/build/native/`` (git-ignored), as one library named by a
hash of the sources and the flags, so an edit to either builds a new one;
nothing is built when the module is imported.  Callers handle
``NativeUnavailable`` where a Python fallback exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
SOURCES = ("chamnet.cpp", "hnsw.cpp", "gather.cpp", "ivfpq.cpp")
# the JAX package's flags (chamjax/native/__init__.py): -march=native is
# safe because the library is built on the host it runs on, never shipped;
# -O3 vectorises the CPU engine's LUT and dot-product loops
GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-pthread",
             "-std=c++17", "-shared", "-fPIC")
# the ADC microbenchmark: a program of its own, with its source's build line
ADC_BENCH = "adc_bench.cpp"
ADC_BENCH_FLAGS = ("-O3", "-march=native")
ADC_BENCH_VARIANTS = ("scalar", "unrolled", "soa")

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _hashed(stem: str, flags, sources, suffix: str = "") -> Path:
    """``BUILD_DIR/<stem>-<hash><suffix>``, the hash of the flags and the
    sources' names and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources:
        h.update(name.encode() + b"\0" + (SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{suffix}"


def _gxx(out: Path, flags, sources, what: str) -> Path:
    """Compile ``sources`` into ``out`` unless it exists.  The compiler
    writes a file of its own, renamed into place, so processes that build
    at once never load or run a half-written file."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = ["g++", *flags, "-o", str(tmp), *(str(SRC_DIR / s) for s in sources)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise NativeUnavailable(f"{what} build failed: {detail}") from e
    os.replace(tmp, out)
    return out


def library_path() -> Path:
    """Where the library is built: named by a hash of the sources and the
    flags."""
    return _hashed("libchamnet", GXX_FLAGS, SOURCES, ".so")


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    return _gxx(library_path(), GXX_FLAGS, SOURCES, "chamnet")


def build_adc_bench() -> Path:
    """Compile the host ADC microbenchmark (``src/adc_bench.cpp``, a
    standalone program outside the library) unless it is built; returns
    the executable's path, named by a hash of the source and the flags."""
    return _gxx(_hashed("adc_bench", ADC_BENCH_FLAGS, (ADC_BENCH,)),
                ADC_BENCH_FLAGS, (ADC_BENCH,), "adc_bench")


def run_adc_bench(n_rows: int = 1 << 20, m: int = 16,
                  timeout: float = 600.0) -> Dict[str, float]:
    """Build and run the host ADC microbenchmark over ``n_rows`` random
    rows of ``m`` code bytes on one core: ``{"scalar", "unrolled", "soa"}``
    → Mrows/s, as it prints them.  Raises ``NativeUnavailable`` where
    ``g++`` fails and ``RuntimeError`` where the program fails or prints
    no rate for a variant."""
    exe = build_adc_bench()
    r = subprocess.run([str(exe), str(int(n_rows)), str(int(m))],
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode:
        raise RuntimeError(f"adc_bench exited {r.returncode}: {r.stderr}")
    rates = {}
    for line in r.stdout.splitlines():
        parts = line.split()
        if (len(parts) == 5 and parts[0] in ADC_BENCH_VARIANTS
                and parts[4] == "Mrows/s"):
            rates[parts[0]] = float(parts[3])
    if set(rates) != set(ADC_BENCH_VARIANTS):
        raise RuntimeError(f"adc_bench printed no rate for "
                           f"{sorted(set(ADC_BENCH_VARIANTS) - set(rates))}"
                           f":\n{r.stdout}")
    return rates


_VP, _I, _LL, _U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_uint64)
_CP = ctypes.c_char_p
# (argtypes, restype) of every C entry point
SIGNATURES = {
    "cham_coordinator_run": ([_CP, _I, _I, _LL, _LL, _CP, _LL], _LL),
    "cham_read_vecs": ([_CP, _I, _LL, _LL, _VP], _LL),
    "cham_vecs_dim": ([_CP], _LL),
    "cham_hnsw_create": ([_I, _I, _I, _U64], _LL),
    "cham_hnsw_add": ([_LL, _LL, _VP, _VP], _LL),
    "cham_hnsw_search": ([_LL, _LL, _VP, _I, _I, _VP, _VP], _LL),
    "cham_hnsw_size": ([_LL], _LL),
    "cham_hnsw_save": ([_LL, _CP], _LL),
    "cham_hnsw_load": ([_CP], _LL),
    "cham_hnsw_free": ([_LL], None),
    "cham_gather_windows": ([_VP, _VP, _LL, _I, _I, _VP, _VP, _LL, _VP,
                             _VP], _LL),
    "cham_gather_codes": ([_VP, _LL, _I, _I, _VP, _VP, _LL, _VP], _LL),
    "cham_ivfpq_create": ([_I, _I, _I, _LL] + [_VP] * 6 + [_LL, _I], _LL),
    "cham_ivfpq_search": ([_LL, _LL, _VP, _I, _I, _VP, _VP, _I], _LL),
    "cham_ivfpq_search_preassigned": ([_LL, _LL, _VP, _VP, _I, _I, _VP, _VP,
                                       _I], _LL),
    "cham_ivfpq_free": ([_LL], None),
}


def load() -> ctypes.CDLL:
    """Build (if needed) and load libchamnet; raises NativeUnavailable."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, (argtypes, restype) in SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _lib = lib
    return _lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# --- high-level wrappers -----------------------------------------------------

def coordinator_run(host: str, port: int, n_clients: int,
                    request_bytes: int, answer_bytes: int,
                    engine_addrs, queries_per_client: int = 0) -> int:
    """Blocking native coordinator (the interpreter lock is released while
    it runs).  ``engine_addrs``: ``[(host, port), ...]``.  Returns the
    answered queries."""
    lib = load()
    spec = ";".join(f"{h}:{p}" for h, p in engine_addrs)
    rc = lib.cham_coordinator_run(
        host.encode(), port, n_clients, request_bytes, answer_bytes,
        spec.encode(), queries_per_client)
    if rc < 0:
        raise RuntimeError(f"native coordinator failed: code {rc}")
    return int(rc)


def read_vecs(path: str, elem: str = "f", max_rows: int = -1) -> np.ndarray:
    """Read an fvecs/bvecs/ivecs file into a contiguous array."""
    lib = load()
    dim = lib.cham_vecs_dim(path.encode())
    if dim <= 0:
        raise IOError(f"cannot read vecs header from {path} (code {dim})")
    elem_size, dtype = {"f": (4, np.float32), "b": (1, np.uint8),
                        "i": (4, np.int32)}[elem]
    if max_rows < 0:
        max_rows = os.path.getsize(path) // (4 + dim * elem_size)
    out = np.empty((max_rows, dim), dtype)
    rows = lib.cham_read_vecs(path.encode(), elem_size, dim, max_rows,
                              _ptr(out))
    if rows < 0:
        raise IOError(f"native vecs read failed: code {rows}")
    return out[:rows]


def _windows(starts, lens):
    starts = np.ascontiguousarray(starts, np.int32).reshape(-1)
    lens = np.ascontiguousarray(lens, np.int32).reshape(-1)
    if starts.shape != lens.shape:
        raise ValueError(f"starts {starts.shape} and lens {lens.shape}")
    return starts, lens


def gather_windows(codes, ids, starts, lens, seg: int):
    """Window-slab gather of codes and ids (``src/gather.cpp``).  ``codes
    (n_pad, m) u8`` / ``ids (n_pad,) i32`` may be arrays or memmaps.
    Returns ``(slab_codes (bw, seg, m) u8, slab_ids (bw, seg) i32)``: a
    window of length > 0 takes ``seg`` rows from its start (cut at the
    array's end); the rest is 0 / -1."""
    lib = load()
    codes = np.ascontiguousarray(codes, np.uint8)
    ids = np.ascontiguousarray(ids, np.int32)
    starts, lens = _windows(starts, lens)
    n_pad, m = codes.shape
    if ids.shape != (n_pad,):
        raise ValueError(f"ids {ids.shape} for {n_pad} code rows")
    bw = starts.size
    slab_c = np.empty((bw, seg, m), np.uint8)
    slab_i = np.empty((bw, seg), np.int32)
    rc = lib.cham_gather_windows(_ptr(codes), _ptr(ids), n_pad, m, seg,
                                 _ptr(starts), _ptr(lens), bw, _ptr(slab_c),
                                 _ptr(slab_i))
    if rc < 0:
        raise RuntimeError(f"cham_gather_windows failed: code {rc}")
    return slab_c, slab_i


def gather_codes(codes, starts, lens, seg: int, out=None) -> np.ndarray:
    """Codes-only slab gather, the streamed tier's host half
    (``src/gather.cpp::cham_gather_codes``).  Returns ``slab_codes (bw,
    seg, m) u8``: a window of length > 0 takes ``seg`` rows from its start
    (cut at the array's end); the rest is zero.  ``out``, when given,
    receives the slab (the streamed tier passes its pinned staging buffer)
    and must be a C-contiguous uint8 array of that shape."""
    lib = load()
    codes = np.ascontiguousarray(codes, np.uint8)
    starts, lens = _windows(starts, lens)
    n_pad, m = codes.shape
    bw = starts.size
    if out is None:
        out = np.empty((bw, seg, m), np.uint8)
    elif not (isinstance(out, np.ndarray) and out.dtype == np.uint8
              and out.shape == (bw, seg, m) and out.flags.c_contiguous
              and out.flags.writeable):
        raise ValueError(
            f"gather_codes: out must be a writeable C-contiguous uint8 "
            f"array of shape {(bw, seg, m)}, got "
            f"{getattr(out, 'dtype', type(out))} {getattr(out, 'shape', '')}")
    rc = lib.cham_gather_codes(_ptr(codes), n_pad, m, seg, _ptr(starts),
                               _ptr(lens), bw, _ptr(out))
    if rc < 0:
        raise RuntimeError(f"cham_gather_codes failed: code {rc}")
    return out


class NativeIVFPQ:
    """Host (CPU) IVF-PQ query engine over the packed CSR layout
    (``src/ivfpq.cpp``): the reference's Faiss-CPU ``FaissServer`` mode.
    Exact coarse top-nprobe, residual ADC with f32 LUTs, exact top-k:
    squared-L2 distances equal to ``IVFSearcher``'s with f32 LUTs to float
    tolerance.

    The engine borrows the PackedIVF's arrays: the instance keeps them
    alive while its handle lives.  The OPQ rotation, when present, is
    applied to the queries here.  A handle is single-threaded."""

    def __init__(self, packed):
        self._lib = load()
        cfg = packed.cfg
        self.dim, self.m, self.nprobe_max = cfg.dim, cfg.m, cfg.nlist
        if cfg.nbits != 8:
            raise ValueError("the native engine takes 8-bit PQ codes only")
        # the arrays the handle points into, kept alive with it
        self._cent = np.ascontiguousarray(packed.centroids, np.float32)
        self._cb = np.ascontiguousarray(packed.codebooks, np.float32)
        self._codes = np.ascontiguousarray(packed.codes, np.uint8)
        self._ids = np.ascontiguousarray(packed.ids, np.int32)
        self._ls = np.ascontiguousarray(packed.list_start, np.int32)
        self._ll = np.ascontiguousarray(packed.list_len, np.int32)
        self._opq_R = (np.ascontiguousarray(packed.opq_R, np.float32)
                       if packed.opq_R is not None else None)
        self._h = self._lib.cham_ivfpq_create(
            cfg.dim, cfg.m, 256, cfg.nlist, _ptr(self._cent),
            _ptr(self._cb), _ptr(self._codes), _ptr(self._ids),
            _ptr(self._ls), _ptr(self._ll), self._codes.shape[0],
            int(cfg.by_residual))
        if self._h < 0:
            raise ValueError("cham_ivfpq_create failed")

    def _prep(self, queries) -> np.ndarray:
        q = np.ascontiguousarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries {q.shape}, dim {self.dim}")
        if self._opq_R is not None:
            q = np.ascontiguousarray(q @ self._opq_R)
        return q

    def search(self, queries, nprobe: int, k: int, n_threads: int = 0):
        """Returns ``(dists (nq, k) f32, ids (nq, k) i64)`` ascending.
        ``n_threads`` 0: every core (queries fan out over a pool)."""
        q = self._prep(queries)
        nq = q.shape[0]
        out_i = np.empty((nq, k), np.int64)
        out_d = np.empty((nq, k), np.float32)
        rc = self._lib.cham_ivfpq_search(self._h, nq, _ptr(q), nprobe, k,
                                         _ptr(out_i), _ptr(out_d), n_threads)
        if rc < 0:
            raise RuntimeError(f"cham_ivfpq_search failed: {rc}")
        return out_d, out_i

    def search_preassigned(self, queries, list_ids, k: int,
                           n_threads: int = 0):
        """As :meth:`search`, over the given ``(nq, nprobe)`` lists (a
        negative id is skipped)."""
        q = self._prep(queries)
        nq = q.shape[0]
        li = np.ascontiguousarray(list_ids, np.int32)
        if li.ndim != 2 or li.shape[0] != nq:
            raise ValueError(f"list ids {li.shape} for {nq} queries")
        out_i = np.empty((nq, k), np.int64)
        out_d = np.empty((nq, k), np.float32)
        rc = self._lib.cham_ivfpq_search_preassigned(
            self._h, nq, _ptr(q), _ptr(li), li.shape[1], k, _ptr(out_i),
            _ptr(out_d), n_threads)
        if rc < 0:
            raise RuntimeError(f"cham_ivfpq_search_preassigned failed: {rc}")
        return out_d, out_i

    def close(self) -> None:
        if getattr(self, "_h", -1) >= 0:
            self._lib.cham_ivfpq_free(self._h)
            self._h = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class HNSWIndex:
    """Host HNSW graph index (``src/hnsw.cpp``), L2 metric (normalised
    vectors make it rank-equivalent to cosine).  A handle is
    single-threaded: searches share its visited-stamp scratch, and ctypes
    releases the interpreter lock, so use one handle a thread."""

    def __init__(self, dim: int, M: int = 16, ef_construction: int = 200,
                 seed: int = 42, _handle: int = 0):
        self._lib = load()
        self.dim = dim
        if _handle:
            self._h = _handle
        else:
            self._h = self._lib.cham_hnsw_create(dim, M, ef_construction,
                                                 seed)
            if self._h < 0:
                raise ValueError("cham_hnsw_create failed")

    def __len__(self) -> int:
        return int(self._lib.cham_hnsw_size(self._h))

    def add(self, vecs, labels=None) -> int:
        vecs = np.ascontiguousarray(vecs, np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"vectors {vecs.shape}, dim {self.dim}")
        lab_ptr = None
        if labels is not None:
            labels = np.ascontiguousarray(labels, np.int64)
            if labels.shape != (vecs.shape[0],):
                raise ValueError(f"labels {labels.shape}")
            lab_ptr = _ptr(labels)
        rc = self._lib.cham_hnsw_add(self._h, vecs.shape[0], _ptr(vecs),
                                     lab_ptr)
        if rc < 0:
            raise RuntimeError(f"cham_hnsw_add failed: {rc}")
        return int(rc)

    def search(self, queries, k: int, ef: int = 0):
        """Returns ``(labels (n, k) int64, dists (n, k) float32)``,
        nearest first (squared L2)."""
        queries = np.ascontiguousarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        n = queries.shape[0]
        labels = np.empty((n, k), np.int64)
        dists = np.empty((n, k), np.float32)
        rc = self._lib.cham_hnsw_search(self._h, n, _ptr(queries), k,
                                        ef or max(2 * k, 64), _ptr(labels),
                                        _ptr(dists))
        if rc < 0:
            raise RuntimeError(f"cham_hnsw_search failed: {rc}")
        return labels, dists

    def save(self, path: str) -> None:
        rc = self._lib.cham_hnsw_save(self._h, path.encode())
        if rc < 0:
            raise IOError(f"cham_hnsw_save failed: {rc}")

    @staticmethod
    def load_file(path: str, dim: int) -> "HNSWIndex":
        h = load().cham_hnsw_load(path.encode())
        if h < 0:
            raise IOError(f"cham_hnsw_load failed: {h}")
        return HNSWIndex(dim, _handle=h)

    def close(self) -> None:
        if getattr(self, "_h", 0):
            self._lib.cham_hnsw_free(self._h)
            self._h = 0

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
