"""Build and load the port's CUDA kernels.

Each ``chamjax_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface (its entry
points in ``SIGNATURES``; the ``launch.cuh`` it includes gives it the
error string ``check`` reads), at first use, into
``chamjax_torch/build/`` (named by a hash of the source, the local
headers it includes and the flags, so an edit to any of them rebuilds),
and loaded with ``ctypes``.  Nothing is built at import time: the CPU
tests import every module on a machine with no ``nvcc``.

``launch_counts`` counts kernel launches by name; each wrapper adds one
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
# one library a source: the stems of csrc/*.cu (a .cuh is included)
SOURCES = tuple(sorted(p.stem for p in CSRC_DIR.glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U32, _U64, _F = ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_float
# (argtypes, restype) of each library's C entry points
SIGNATURES = {
    "adc_scan_tiles": {
        "chamjax_adc_scan_tiles": ([_VP] * 6 + [_I] * 7 + [_VP], _I),
    },
    "adc_scan_flat": {
        "chamjax_adc_scan_segments_multi": (
            [_VP, _I64] + [_VP] * 5 + [_I] * 5 + [_VP], _I),
        "chamjax_adc_scan_segments": (
            [_VP, _I64] + [_VP] * 5 + [_I] * 4 + [_VP], _I),
        "chamjax_adc_scan_distances": (
            [_VP, _I64] + [_VP] * 4 + [_I] * 3 + [_VP], _I),
    },
    "adc_scan_variants": {
        "chamjax_run_variant": ([_VP, _I64] + [_VP] * 4 + [_I] * 5 + [_VP],
                                _I),
        "chamjax_run_block_variant": ([_VP] * 5 + [_I] * 4 + [_VP], _I),
    },
    "threefry": {
        "chamjax_threefry": (
            [_VP, _I64, _U64, _U32, _U32, _I, _F, _F, _F, _VP], _I),
        "chamjax_threefry_gumbel_argmax": (
            [_VP, _I64, _U32, _U32, _U32, _F, _F, _VP, _VP, _VP], _I),
        "chamjax_threefry_logit": ([_VP, _I64, _VP, _VP], _I),
    },
    "decode_attend": {
        "chamjax_decode_attend": (
            [_VP, _I64, _VP, _I64, _I64, _VP, _I64, _I64, _VP, _I64, _VP,
             _I64, _VP, _I, _VP] + [_I] * 6 + [_F, _VP], _I),
        "chamjax_decode_attend_chunks": ([_I] * 4 + [_VP], _I),
    },
    "latent_attend": {
        "chamjax_latent_attend": (
            [_VP, _I64, _I64, _VP, _I64, _I64, _VP, _I64, _VP, _I, _VP]
            + [_I] * 4 + [_F, _VP], _I),
        "chamjax_latent_attend_chunks": ([_I, _I, _VP], _I),
    },
    "kda_decode": {
        "chamjax_kda_decode": ([_VP] * 7 + [_I, _VP], _I),
    },
    "encode_attend": {
        "chamjax_encode_attend": (
            [_VP, _I64, _I64, _I64] * 3 + [_VP, _I, _I, _VP] + [_I] * 5
            + [_F, _VP], _I),
    },
    "block_norm": {
        "chamjax_add_ln": ([_VP] * 7 + [_I64, _I, _F, _VP], _I),
        "chamjax_bias_gelu": ([_VP] * 3 + [_I64, _I, _VP], _I),
    },
}

launch_counts: collections.Counter = collections.Counter()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _source_bytes(path: Path, seen: set) -> bytes:
    """``path`` followed by every local header it includes (``#include
    "x.cuh"``, found beside it), recursively, each once."""
    if path in seen:
        return b""
    seen.add(path)
    src = path.read_bytes()
    parts = [src]
    for inc in _INCLUDE.findall(src):
        header = path.parent / inc.decode()
        if header.exists():
            parts.append(_source_bytes(header, seen))
    return b"".join(parts)


def library_path(name: str) -> Path:
    """Where library ``name`` is built: named by a hash of its source, the
    headers it includes and the compiler flags, so an edit to any of them
    builds a new library."""
    src = _source_bytes(CSRC_DIR / f"{name}.cu", set())
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet — one
    ``nvcc`` per source, all started together.  Returns each compiled
    source's compiler output (``-Xptxas -v``: registers, shared memory,
    spills); raises with that output if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n} ---\n{logs[n]}" for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiling it first if needed."""
    path = library_path(name)
    if not path.exists():
        build((name,))
    lib = ctypes.CDLL(str(path))
    lib.chamjax_cuda_error_string.argtypes = [ctypes.c_int]
    lib.chamjax_cuda_error_string.restype = ctypes.c_char_p
    # an earlier source directory (benchmarks/threefry_timing.py's
    # baseline) may lack a later entry point: a call to it then fails
    for fn, (argtypes, restype) in SIGNATURES.get(name, {}).items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if err:
        msg = lib.chamjax_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# -- the driver's view of a stream capture (for utils/graphs.py's stage
# maps): cuStreamGetCaptureInfo, cuGraphGetNodes and cuGraphNodeGetType of
# libcuda, which every CUDA process has loaded, called with ctypes
_CAPTURE_ACTIVE = 1             # CU_STREAM_CAPTURE_STATUS_ACTIVE
# the node types that run on the device: kernel, memcpy, memset
# (CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET)
DEVICE_NODE_TYPES = (0, 1, 2)


@functools.lru_cache(maxsize=None)
def _driver():
    """libcuda and its capture-info entry: ``_v3`` (CUDA 12.3 on, with
    edge data) where the driver has it, else ``_v2``."""
    lib = ctypes.CDLL("libcuda.so.1")
    ref = ctypes.POINTER
    v3 = hasattr(lib, "cuStreamGetCaptureInfo_v3")
    info = (lib.cuStreamGetCaptureInfo_v3 if v3
            else lib.cuStreamGetCaptureInfo_v2)
    info.argtypes = ([_VP, ref(_I), ref(_U64), ref(_VP), _VP]
                     + ([_VP] if v3 else []) + [ref(ctypes.c_size_t)])
    info.restype = _I
    lib.cuGraphGetNodes.argtypes = [_VP, _VP, ref(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = _I
    lib.cuGraphNodeGetType.argtypes = [_VP, ref(_I)]
    lib.cuGraphNodeGetType.restype = _I
    lib.cuGetErrorString.argtypes = [_I, ref(ctypes.c_char_p)]
    lib.cuGetErrorString.restype = _I
    return lib, info, v3


def _driver_check(lib, err: int, what: str) -> None:
    if err:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(err, ctypes.byref(msg))
        raise RuntimeError(f"{what}: CUDA driver error {err} "
                           f"({(msg.value or b'?').decode()})")


def capture_nodes(stream: int) -> list:
    """The nodes (``CUgraphNode`` handles) of the graph that ``stream``
    is capturing into, in no set order; raises where it captures
    nothing."""
    lib, info, v3 = _driver()
    status, graph = _I(), _VP()
    args = [stream, ctypes.byref(status), None, ctypes.byref(graph), None]
    err = info(*args, *([None] if v3 else []), None)
    _driver_check(lib, err, "cuStreamGetCaptureInfo")
    if status.value != _CAPTURE_ACTIVE:
        raise RuntimeError("capture_nodes: the stream is not capturing")
    n = ctypes.c_size_t()
    _driver_check(lib, lib.cuGraphGetNodes(graph, None, ctypes.byref(n)),
                  "cuGraphGetNodes")
    if not n.value:             # an array of no node is refused
        return []
    nodes = (_VP * n.value)()
    _driver_check(lib, lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
                  "cuGraphGetNodes")
    return list(nodes[:n.value])


def node_type(node: int) -> int:
    """A graph node's ``CUgraphNodeType``."""
    lib, _info, _v3 = _driver()
    kind = _I()
    _driver_check(lib, lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
                  "cuGraphNodeGetType")
    return kind.value
