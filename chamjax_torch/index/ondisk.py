"""On-disk index build and load: corpora larger than host RAM (the port of
``chamjax/index/ondisk.py``).

The packed code and id arrays live in raw memmap files; the build is two
passes (assign every chunk → list sizes → layout; encode every chunk →
scatter into per-list cursors), so host memory holds one chunk whatever
the corpus size.  ``load_ondisk`` returns a ``PackedIVF`` whose big arrays
are read-only memmaps, which ``streamed.HostStreamedSearcher`` serves
without copying.  The files (``codes.raw``, ``ids.raw``, ``meta.npz``,
``ondisk.json``) are the JAX package's: an index written by either package
loads in the other.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import time
import warnings
from typing import Iterator

import numpy as np
import torch

from chamjax_torch.config import IndexConfig
from chamjax_torch.index.factory import TrainedQuantizers, imi_halves
from chamjax_torch.index.ivf import INVALID_ID, PackedIVF
from chamjax_torch.index.kmeans import assign
from chamjax_torch.index.pq import pq_encode
from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul


def _chunks(xb, chunk: int) -> Iterator[tuple]:
    for i in range(0, xb.shape[0], chunk):
        yield i, np.ascontiguousarray(xb[i:i + chunk], np.float32)


def _layout(assignment: np.ndarray, cfg: IndexConfig, tail_pad: int):
    list_len = np.bincount(assignment, minlength=cfg.nlist).astype(np.int64)
    padded = (np.maximum(-(-list_len // cfg.list_pad), 1)
              * cfg.list_pad).astype(np.int64)
    list_start = np.zeros(cfg.nlist, np.int64)
    list_start[1:] = np.cumsum(padded)[:-1]
    return list_len, list_start, int(padded.sum()) + tail_pad


def _open_raw(out_dir: str, n_pad: int, m: int):
    codes = np.memmap(os.path.join(out_dir, "codes.raw"), np.uint8,
                      mode="w+", shape=(n_pad, m))
    ids = np.memmap(os.path.join(out_dir, "ids.raw"), np.int32, mode="w+",
                    shape=(n_pad,))
    ids[:] = INVALID_ID
    return codes, ids


def _scatter(codes_mm, ids_mm, cursor, a: np.ndarray, codes: np.ndarray,
             row0: int, nlist: int) -> None:
    """Append one chunk's rows (global ids ``row0 + i``) to their lists."""
    order = np.argsort(a, kind="stable")
    a_s = a[order]
    bounds = np.searchsorted(a_s, np.arange(nlist + 1))
    for li in np.unique(a_s):
        lo, hi = bounds[li], bounds[li + 1]
        d = int(cursor[li])
        rows = order[lo:hi]
        codes_mm[d:d + len(rows)] = codes[rows]
        ids_mm[d:d + len(rows)] = (row0 + rows).astype(np.int32)
        cursor[li] += len(rows)


def _finish(out_dir, codes_mm, ids_mm, trained, list_start, list_len,
            n_pad, n) -> str:
    codes_mm.flush()
    ids_mm.flush()
    cfg = trained.cfg
    np.savez_compressed(
        os.path.join(out_dir, "meta.npz"),
        centroids=np.asarray(trained.centroids),
        codebooks=np.asarray(trained.codebooks),
        list_start=list_start.astype(np.int32),
        list_len=list_len.astype(np.int32),
        opq_R=(np.asarray(trained.opq_R) if trained.opq_R is not None
               else np.zeros((0, 0), np.float32)),
        cfg=np.frombuffer(repr(dataclasses.asdict(cfg)).encode(), np.uint8))
    with open(os.path.join(out_dir, "ondisk.json"), "w") as f:
        json.dump({"n_pad": n_pad, "m": cfg.m, "ntotal": int(n)}, f)
    return out_dir


def populate_on_disk(
    xb,                              # may be a memmap
    trained: TrainedQuantizers,
    out_dir: str,
    chunk: int = 1 << 19,
    id_offset: int = 0,
    tail_pad: int = 8192,
    device=None,
) -> str:
    """Two-pass on-disk populate from a host corpus; assignment and
    encoding of each chunk run on ``device``.  Returns ``out_dir``."""
    dev = resolve_device(device)
    cfg = trained.cfg
    os.makedirs(out_dir, exist_ok=True)
    n = xb.shape[0]
    if cfg.balanced:
        warnings.warn(
            "populate_on_disk: cfg.balanced is IGNORED — the chunked "
            "two-pass assigner is nearest-cell only, so the hard-cap list "
            "invariant (auto_windows' worst-query bound) will not hold. "
            "Use factory.populate or the device builder for balanced "
            "builds.", stacklevel=2)

    def rotate(x):
        return x @ trained.opq_R if trained.opq_R is not None else x

    def cells(xr):
        if cfg.imi:
            from chamjax_torch.index.imi import assign_imi
            return assign_imi(xr, *imi_halves(trained), device=dev)
        return assign(xr, trained.centroids, device=dev)

    # pass 1: assignment (chunked) → list sizes → packed layout
    assignment = np.empty(n, np.int32)
    for i, x in _chunks(xb, chunk):
        assignment[i:i + x.shape[0]] = cells(rotate(x))
    list_len, list_start, n_pad = _layout(assignment, cfg, tail_pad)
    codes_mm, ids_mm = _open_raw(out_dir, n_pad, cfg.m)

    # pass 2: encode (chunked) → scatter into per-list cursors
    cursor = list_start.copy()
    for i, x in _chunks(xb, chunk):
        xr = rotate(x)
        a = assignment[i:i + x.shape[0]]
        enc = xr - trained.centroids[a] if cfg.by_residual else xr
        codes = pq_encode(enc, trained.codebooks, device=dev)
        _scatter(codes_mm, ids_mm, cursor, a, codes, i + id_offset,
                 cfg.nlist)
    return _finish(out_dir, codes_mm, ids_mm, trained, list_start, list_len,
                   n_pad, n)


@fp32_matmul()
def populate_on_disk_device(
    draw,                           # draw(start, count) -> (count, d)
    n: int,
    trained: TrainedQuantizers,
    out_dir: str,
    chunk: int = 1 << 20,
    id_offset: int = 0,
    tail_pad: int = 8192,
    verbose: bool = False,
    device=None,
) -> str:
    """Two-pass on-disk populate with each chunk drawn, assigned (the
    device builder's two-stage assignment) and encoded on ``device``; only
    the (n,) int32 assignment and the (n, m) u8 codes cross to the host,
    which scatters them into the memmap layout (build on the card, serve
    from the host)."""
    from chamjax_torch.index.device_build import _assign_blocked, _encode

    dev = resolve_device(device)
    cfg = trained.cfg
    os.makedirs(out_dir, exist_ok=True)
    cent = as_f32(trained.centroids, dev)
    books = as_f32(trained.codebooks, dev)
    R = as_f32(trained.opq_R, dev) if trained.opq_R is not None else None

    def rotated(s: int, c: int) -> torch.Tensor:
        x = as_f32(draw(s, c), dev)
        return torch.matmul(x, R) if R is not None else x

    def chunk_assign(x):
        return _assign_blocked(x, cent, block=4096, cand=8)

    # pass 1: assignment only (4 B a row to the host)
    assignment = np.empty(n, np.int32)
    t0 = time.time()
    for i in range(0, n, chunk):
        c = min(chunk, n - i)
        assignment[i:i + c] = chunk_assign(rotated(i, c)).cpu().numpy()
        if verbose and (i // chunk) % 8 == 0:
            print(f"[ondisk] pass1 {i + c}/{n} rows "
                  f"(+{time.time() - t0:.0f}s)", flush=True)
    list_len, list_start, n_pad = _layout(assignment, cfg, tail_pad)
    codes_mm, ids_mm = _open_raw(out_dir, n_pad, cfg.m)

    # pass 2: encode (m B a row to the host) → host scatter; the
    # assignment is derived again on the device (the draw is deterministic)
    cursor = list_start.copy()
    for i in range(0, n, chunk):
        c = min(chunk, n - i)
        x = rotated(i, c)
        codes = _encode(x, chunk_assign(x), cent, books,
                        cfg.by_residual).cpu().numpy()
        _scatter(codes_mm, ids_mm, cursor, assignment[i:i + c], codes,
                 i + id_offset, cfg.nlist)
        if verbose and (i // chunk) % 8 == 0:
            print(f"[ondisk] pass2 {i + c}/{n} rows "
                  f"(+{time.time() - t0:.0f}s)", flush=True)
    return _finish(out_dir, codes_mm, ids_mm, trained, list_start, list_len,
                   n_pad, n)


def load_ondisk(out_dir: str) -> PackedIVF:
    """Open an on-disk index; the code and id arrays are read-only
    memmaps."""
    with open(os.path.join(out_dir, "ondisk.json")) as f:
        info = json.load(f)
    with np.load(os.path.join(out_dir, "meta.npz"),
                 allow_pickle=False) as z:
        meta = {k: z[k] for k in z.files}
    cfg = IndexConfig(**ast.literal_eval(bytes(meta["cfg"]).decode()))
    codes = np.memmap(os.path.join(out_dir, "codes.raw"), np.uint8,
                      mode="r", shape=(info["n_pad"], info["m"]))
    ids = np.memmap(os.path.join(out_dir, "ids.raw"), np.int32,
                    mode="r", shape=(info["n_pad"],))
    opq_R = meta["opq_R"]
    return PackedIVF(
        cfg=cfg, centroids=meta["centroids"], codebooks=meta["codebooks"],
        codes=codes, ids=ids, list_start=meta["list_start"],
        list_len=meta["list_len"], ntotal=info["ntotal"],
        opq_R=opq_R if opq_R.size else None)
