"""Build and load the port's CUDA kernels.

Each ``chamjax_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first use,
into ``chamjax_torch/build/`` (named by a hash of the source and flags, so
an edited source rebuilds), and loaded with ``ctypes``.  Nothing here runs
at import time: the CPU tests import every module on a machine with no
``nvcc``.

``launch_counts`` counts kernel launches by name; each wrapper adds one
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("adc_scan_tiles", "adc_scan_flat")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (argtypes, restype) of each library's C entry points
SIGNATURES = {
    "adc_scan_tiles": {
        "chamjax_adc_scan_tiles": ([_VP] * 6 + [_I] * 5 + [_VP], _I),
    },
    "adc_scan_flat": {
        "chamjax_adc_scan_segments_multi": (
            [_VP, _I64] + [_VP] * 5 + [_I] * 5 + [_VP], _I),
        "chamjax_adc_scan_segments": (
            [_VP, _I64] + [_VP] * 5 + [_I] * 4 + [_VP], _I),
        "chamjax_adc_scan_distances": (
            [_VP, _I64] + [_VP] * 4 + [_I] * 3 + [_VP], _I),
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


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
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
    for fn, (argtypes, restype) in SIGNATURES.get(name, {}).items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if err:
        msg = lib.chamjax_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
