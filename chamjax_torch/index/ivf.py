"""Packed IVF-PQ index: build, padded CSR layout, save/load (the port of
``chamjax/index/ivf.py``).

Inverted lists are concatenated into one contiguous code array padded to
``list_pad``-row multiples with a per-list (start, len) table.  ``save`` and
``load`` use the JAX package's npz format, so an index built by either
package searches in the other.
"""

from __future__ import annotations

import ast
import dataclasses
import sys
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from chamjax_torch.config import IndexConfig
from chamjax_torch.index.kmeans import assign, assign_balanced, kmeans
from chamjax_torch.index.pq import pq_encode_tensor, train_opq, train_pq
from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul

INVALID_ID = np.int32(-1)


@dataclass
class PackedIVF:
    """A populated IVF-PQ index in packed (padded CSR) layout.  Arrays are
    host numpy; ``searcher.DeviceIVF`` moves them to a device once."""

    cfg: IndexConfig
    centroids: np.ndarray     # (nlist, d)   float32 — coarse quantizer
    codebooks: np.ndarray     # (m, ksub, dsub) float32 — product quantizer
    codes: np.ndarray         # (n_pad, m)   uint8   — grouped by list, padded
    ids: np.ndarray           # (n_pad,)     int32   — INVALID_ID on padding
    list_start: np.ndarray    # (nlist,)     int32   — row offset per list
    list_len: np.ndarray      # (nlist,)     int32   — true rows per list
    ntotal: int
    opq_R: Optional[np.ndarray] = None  # (d, d) float32 — rotation, or None

    @property
    def n_pad(self) -> int:
        return self.codes.shape[0]

    def suggest_scan_len(self, nprobe: int, quantile: float = 1.0) -> int:
        """Static per-probe scan length covering ``quantile`` of lists,
        rounded up to a ``list_pad`` multiple."""
        q = float(np.quantile(self.list_len, quantile))
        pad = self.cfg.list_pad
        return max(pad, int(-(-q // pad) * pad))

    def memory_bytes(self) -> int:
        return (self.codes.nbytes + self.ids.nbytes + self.centroids.nbytes
                + self.codebooks.nbytes + self.list_start.nbytes
                + self.list_len.nbytes)

    @staticmethod
    def from_arrays(cfg_dict: dict, *, centroids, codebooks, codes, ids,
                    list_start, list_len, ntotal,
                    opq_R=None) -> "PackedIVF":
        """Build from plain numpy arrays and a config dict (e.g.
        ``dataclasses.asdict`` of another package's ``IndexConfig``)."""
        return PackedIVF(
            cfg=IndexConfig(**cfg_dict),
            centroids=np.asarray(centroids, np.float32),
            codebooks=np.asarray(codebooks, np.float32),
            codes=np.asarray(codes, np.uint8),
            ids=np.asarray(ids, np.int32),
            list_start=np.asarray(list_start, np.int32),
            list_len=np.asarray(list_len, np.int32),
            ntotal=int(ntotal),
            opq_R=(None if opq_R is None or np.size(opq_R) == 0
                   else np.asarray(opq_R, np.float32)))

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            centroids=self.centroids,
            codebooks=self.codebooks,
            codes=self.codes,
            ids=self.ids,
            list_start=self.list_start,
            list_len=self.list_len,
            ntotal=np.int64(self.ntotal),
            opq_R=(self.opq_R if self.opq_R is not None
                   else np.zeros((0, 0), np.float32)),
            cfg=np.frombuffer(repr(dataclasses.asdict(self.cfg)).encode(),
                              dtype=np.uint8),
        )

    @staticmethod
    def load(path: str) -> "PackedIVF":
        with np.load(path, allow_pickle=False) as z:
            return PackedIVF.from_arrays(
                ast.literal_eval(bytes(z["cfg"]).decode()),
                centroids=z["centroids"], codebooks=z["codebooks"],
                codes=z["codes"], ids=z["ids"], list_start=z["list_start"],
                list_len=z["list_len"], ntotal=int(z["ntotal"]),
                opq_R=z["opq_R"])


def _pack_lists(
    assignment: np.ndarray,
    codes: np.ndarray,
    nlist: int,
    list_pad: int,
    tail_pad: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Group codes by list with per-list padding to ``list_pad`` multiples.

    Returns (packed_codes, packed_ids, list_start, list_len).  Padding rows
    carry id = INVALID_ID and code 0; ``tail_pad`` extra rows keep any
    fixed-length scan window starting inside a list in bounds.
    """
    n, m = codes.shape
    order = np.argsort(assignment, kind="stable")
    sorted_codes = codes[order]
    sorted_ids = order.astype(np.int32)
    list_len = np.bincount(assignment, minlength=nlist).astype(np.int32)
    padded_len = ((list_len + list_pad - 1) // list_pad) * list_pad
    padded_len = np.maximum(padded_len, list_pad)
    list_start = np.zeros(nlist, np.int32)
    list_start[1:] = np.cumsum(padded_len)[:-1]
    n_pad = int(padded_len.sum()) + tail_pad

    packed_codes = np.zeros((n_pad, m), np.uint8)
    packed_ids = np.full((n_pad,), INVALID_ID, np.int32)
    src_start = np.zeros(nlist, np.int64)
    src_start[1:] = np.cumsum(list_len.astype(np.int64))[:-1]
    for li in range(nlist):
        s, ln = int(src_start[li]), int(list_len[li])
        ds = int(list_start[li])
        packed_codes[ds:ds + ln] = sorted_codes[s:s + ln]
        packed_ids[ds:ds + ln] = sorted_ids[s:s + ln]
    return packed_codes, packed_ids, list_start, list_len


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _opq_subsample_idx(n: int, seed: int, cap: int = 1 << 17) -> np.ndarray:
    """Uniform OPQ-training row subsample (sorted); identity when the
    training set already fits the cap."""
    if n <= cap:
        return np.arange(n)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=cap, replace=False))


@fp32_matmul()
def build_ivfpq(
    xb,
    cfg: IndexConfig,
    xt=None,
    seed: int = 0,
    kmeans_iters: int = 15,
    pq_iters: int = 20,
    tail_pad: int = 8192,
    verbose: bool = False,
    device=None,
) -> PackedIVF:
    """Train + populate an IVF-PQ index.

    ``xb``/``xt`` are host numpy arrays (or tensors).  The corpus moves to
    ``device`` once; k-means, assignment, rotation and encoding run there
    and only the small artifacts and the codes come back.
    """
    dev = resolve_device(device)
    if cfg.imi:
        # IMI needs product-structured training (train_imi + the factored
        # assignment): the factory owns it, as in the JAX package
        from chamjax_torch.index import factory
        xt_np = xb if xt is None else xt
        trained = factory.train_quantizers(
            _host(xt_np), cfg, seed=seed, kmeans_iters=kmeans_iters,
            pq_iters=pq_iters, device=dev)
        return factory.populate(_host(xb), trained, tail_pad=tail_pad,
                                device=dev)

    def log(msg):
        if verbose:
            print(f"[build] {msg}", file=sys.stderr, flush=True)

    xb_h = xb if isinstance(xb, torch.Tensor) else np.ascontiguousarray(
        xb, np.float32)
    xt_h = xb_h if xt is None else (
        xt if isinstance(xt, torch.Tensor)
        else np.ascontiguousarray(xt, np.float32))
    xt_d = as_f32(xt_h, dev)
    xb_d = as_f32(xb_h, dev)

    opq_R = None
    centroids = None
    train_assign = None
    if cfg.opq:
        if cfg.by_residual:
            # Residual-OPQ: train the rotation on coarse residuals (L2 is
            # rotation-invariant, so raw-space cells are the same), then
            # fold it into the centroids.
            log(f"kmeans nlist={cfg.nlist} (pre-OPQ)")
            cent_raw = kmeans(xt_d, cfg.nlist, iters=kmeans_iters, seed=seed,
                              device=dev)
            train_assign = assign(xt_d, cent_raw, device=dev)
            sub = _opq_subsample_idx(xt_d.shape[0], seed)
            sub_t = torch.from_numpy(sub).to(dev)
            resid = (xt_d[sub_t] - as_f32(cent_raw, dev)[
                torch.from_numpy(train_assign).to(dev)[sub_t].long()])
            opq_R, _ = train_opq(resid.cpu().numpy(), cfg.m,
                                 nbits=cfg.nbits, seed=seed, device=dev)
            centroids = cent_raw @ opq_R
        else:
            sub = _opq_subsample_idx(xt_d.shape[0], seed)
            opq_R, _ = train_opq(
                xt_d[torch.from_numpy(sub).to(dev)].cpu().numpy(), cfg.m,
                nbits=cfg.nbits, seed=seed, device=dev)
        R = as_f32(opq_R, dev)
        xt_d = torch.matmul(xt_d, R)
        xb_d = torch.matmul(xb_d, R)

    if centroids is None:
        log(f"kmeans nlist={cfg.nlist} on {tuple(xt_d.shape)}")
        centroids = kmeans(xt_d, cfg.nlist, iters=kmeans_iters, seed=seed,
                           device=dev)
        train_assign = assign(xt_d, centroids, device=dev)
    cent_d = as_f32(centroids, dev)
    if cfg.by_residual:
        train_vecs = xt_d - cent_d[torch.from_numpy(train_assign).to(
            dev).long()]
    else:
        train_vecs = xt_d
    log(f"PQ m={cfg.m} nbits={cfg.nbits}")
    codebooks = train_pq(train_vecs, cfg.m, nbits=cfg.nbits, iters=pq_iters,
                         seed=seed, device=dev)
    del train_vecs, xt_d

    if cfg.balanced:
        cap = int(np.ceil(xb_d.shape[0] / cfg.nlist * cfg.balance_factor))
        assignment = assign_balanced(xb_d, centroids, cap=cap,
                                     hard=cfg.balance_hard, device=dev)
    else:
        assignment = assign(xb_d, centroids, device=dev)
    # fused residual + encode, chunked on the device
    cb_d = as_f32(codebooks, dev)
    asg_d = torch.from_numpy(assignment).to(dev).long()
    codes = np.empty((xb_d.shape[0], cfg.m), np.uint8)
    enc_chunk = 1 << 18
    for i in range(0, xb_d.shape[0], enc_chunk):
        xi = xb_d[i:i + enc_chunk]
        if cfg.by_residual:
            xi = xi - cent_d[asg_d[i:i + enc_chunk]]
        codes[i:i + xi.shape[0]] = pq_encode_tensor(xi, cb_d).cpu().numpy()

    packed_codes, packed_ids, list_start, list_len = _pack_lists(
        assignment, codes, cfg.nlist, cfg.list_pad, tail_pad)
    log(f"packed n_pad={packed_codes.shape[0]} "
        f"util={xb_d.shape[0] / max(packed_codes.shape[0], 1):.2%}")
    return PackedIVF(
        cfg=cfg,
        centroids=np.ascontiguousarray(centroids, np.float32),
        codebooks=codebooks,
        codes=packed_codes,
        ids=packed_ids,
        list_start=list_start,
        list_len=list_len,
        ntotal=int(xb_d.shape[0]),
        opq_R=opq_R,
    )
