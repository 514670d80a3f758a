"""Index factory: the train/populate split, sharded populates, merging (the
port of ``chamjax/index/factory.py``).

The train step (k-means or IMI, PQ, optionally OPQ) runs once on the
training sample; ``populate`` encodes any corpus slice against those
quantizers, so a large corpus builds as independent slice jobs merged at
the end.  ``TrainedQuantizers.save``/``load`` use the JAX package's npz
format: quantizers trained by either package populate in the other.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from chamjax_torch.config import IndexConfig
from chamjax_torch.index.ivf import INVALID_ID, PackedIVF, _pack_lists
from chamjax_torch.index.kmeans import assign, assign_balanced, kmeans
from chamjax_torch.index.pq import pq_encode, train_opq, train_pq
from chamjax_torch.utils.device import resolve_device


def parse_index_key(key: str, dim: int) -> IndexConfig:
    """Faiss-style key → IndexConfig: ``"OPQ16,IVF4096,PQ16"`` or the
    multi-index form ``"IMI2x10,PQ16"``.  ``m`` comes from the ``PQ<m>``
    token, never from inside an ``OPQ<w>`` one."""
    parts = [p.strip() for p in key.split(",")]
    opq = any(re.fullmatch(r"OPQ\d+", p) for p in parts)
    pq = [p for p in (re.fullmatch(r"PQ(\d+)", p) for p in parts) if p]
    if not pq:
        raise ValueError(f"index key {key!r} has no PQ<m> token")
    m = int(pq[0].group(1))
    imi = re.search(r"IMI2x(\d+)", key)
    if imi:
        bits = int(imi.group(1))
        return IndexConfig(dim=dim, nlist=1 << (2 * bits), m=m, opq=opq,
                           imi=bits)
    ivf = re.search(r"IVF(\d+)", key)
    if ivf is None:
        raise ValueError(
            f"index key {key!r} has no IVF<nlist>/IMI2x<b> coarse-"
            "quantizer token (flat-PQ keys are not supported)")
    return IndexConfig(dim=dim, nlist=int(ivf.group(1)), m=m, opq=opq)


@dataclass
class TrainedQuantizers:
    """The train-once artifacts: coarse + product quantizer [+ rotation]."""

    cfg: IndexConfig
    centroids: np.ndarray               # (nlist, d)
    codebooks: np.ndarray               # (m, ksub, dsub)
    opq_R: Optional[np.ndarray] = None  # (d, d) or None

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, centroids=self.centroids, codebooks=self.codebooks,
            opq_R=(self.opq_R if self.opq_R is not None
                   else np.zeros((0, 0), np.float32)),
            cfg=np.frombuffer(repr(dataclasses.asdict(self.cfg)).encode(),
                              np.uint8))

    @staticmethod
    def load(path: str) -> "TrainedQuantizers":
        with np.load(path, allow_pickle=False) as z:
            cfg = IndexConfig(**ast.literal_eval(bytes(z["cfg"]).decode()))
            opq_R = z["opq_R"]
            return TrainedQuantizers(
                cfg=cfg, centroids=z["centroids"], codebooks=z["codebooks"],
                opq_R=opq_R if opq_R.size else None)


def train_quantizers(xt, cfg: IndexConfig, seed: int = 0,
                     kmeans_iters: int = 15, pq_iters: int = 20,
                     device=None) -> TrainedQuantizers:
    """The ``index.train()`` stage alone, on ``device``."""
    dev = resolve_device(device)
    xt = np.ascontiguousarray(xt, np.float32)
    opq_R = None
    if cfg.opq:
        opq_R, _ = train_opq(xt, cfg.m, nbits=cfg.nbits, seed=seed,
                             device=dev)
        xt = xt @ opq_R
    if cfg.imi:
        if cfg.nlist != 1 << (2 * cfg.imi):
            raise ValueError(f"IMI2x{cfg.imi} has {1 << (2 * cfg.imi)} "
                             f"cells, cfg.nlist={cfg.nlist}")
        from chamjax_torch.index.imi import imi_centroids, train_imi
        cents_a, cents_b = train_imi(xt, cfg.imi, iters=kmeans_iters,
                                     seed=seed, device=dev)
        centroids = imi_centroids(cents_a, cents_b)
    else:
        centroids = kmeans(xt, cfg.nlist, iters=kmeans_iters, seed=seed,
                           device=dev)
    a = assign(xt, centroids, device=dev)
    train_vecs = xt - centroids[a] if cfg.by_residual else xt
    codebooks = train_pq(train_vecs, cfg.m, nbits=cfg.nbits, iters=pq_iters,
                         seed=seed, device=dev)
    return TrainedQuantizers(cfg=cfg, centroids=centroids,
                             codebooks=codebooks, opq_R=opq_R)


def imi_halves(trained: TrainedQuantizers):
    """The two half codebooks recovered from an IMI grid (row i·K+j =
    [a_i ‖ b_j])."""
    k, h = 1 << trained.cfg.imi, trained.cfg.dim // 2
    return trained.centroids[::k, :h], trained.centroids[:k, h:]


def populate(xb, trained: TrainedQuantizers, id_offset: int = 0,
             tail_pad: int = 8192, device=None) -> PackedIVF:
    """Encode a corpus slice against trained quantizers → packed index.
    ``id_offset`` is the slice's global id base."""
    dev = resolve_device(device)
    cfg = trained.cfg
    xb = np.ascontiguousarray(xb, np.float32)
    xb_r = xb @ trained.opq_R if trained.opq_R is not None else xb
    if cfg.balanced:
        cap = int(np.ceil(xb.shape[0] / cfg.nlist * cfg.balance_factor))
        assignment = assign_balanced(xb_r, trained.centroids, cap=cap,
                                     hard=cfg.balance_hard, device=dev)
    elif cfg.imi:
        from chamjax_torch.index.imi import assign_imi
        assignment = assign_imi(xb_r, *imi_halves(trained), device=dev)
    else:
        assignment = assign(xb_r, trained.centroids, device=dev)
    enc = (xb_r - trained.centroids[assignment] if cfg.by_residual
           else xb_r)
    codes = pq_encode(enc, trained.codebooks, device=dev)
    packed_codes, packed_ids, list_start, list_len = _pack_lists(
        assignment, codes, cfg.nlist, cfg.list_pad, tail_pad)
    if id_offset:
        packed_ids = np.where(packed_ids >= 0, packed_ids + id_offset,
                              packed_ids).astype(np.int32)
    return PackedIVF(cfg=cfg, centroids=trained.centroids,
                     codebooks=trained.codebooks, codes=packed_codes,
                     ids=packed_ids, list_start=list_start,
                     list_len=list_len, ntotal=int(xb.shape[0]),
                     opq_R=trained.opq_R)


def merge_indexes(parts: List[PackedIVF], tail_pad: int = 8192
                  ) -> PackedIVF:
    """Merge per-slice populated indexes sharing one set of quantizers: per
    cell, every part's list in turn.  Parts come from ``populate`` with
    disjoint ``id_offset`` ranges."""
    if not parts:
        raise ValueError("nothing to merge")
    cfg = parts[0].cfg
    for p in parts[1:]:
        if p.cfg != cfg or not np.array_equal(p.centroids,
                                              parts[0].centroids):
            raise ValueError("all parts must share one IndexConfig and one "
                             "set of quantizers")
    nlist = cfg.nlist
    m = parts[0].codes.shape[1]
    list_len = np.sum([p.list_len for p in parts], axis=0).astype(np.int64)
    padded = (np.maximum(-(-list_len // cfg.list_pad), 1)
              * cfg.list_pad).astype(np.int64)
    list_start = np.zeros(nlist, np.int64)
    list_start[1:] = np.cumsum(padded)[:-1]
    n_pad = int(padded.sum()) + tail_pad
    codes = np.zeros((n_pad, m), np.uint8)
    ids = np.full((n_pad,), INVALID_ID, np.int32)
    cursor = list_start.copy()
    for p in parts:
        for li in range(nlist):
            s, ln = int(p.list_start[li]), int(p.list_len[li])
            d = int(cursor[li])
            codes[d:d + ln] = p.codes[s:s + ln]
            ids[d:d + ln] = p.ids[s:s + ln]
            cursor[li] += ln
    return PackedIVF(cfg=cfg, centroids=parts[0].centroids,
                     codebooks=parts[0].codebooks, codes=codes, ids=ids,
                     list_start=list_start.astype(np.int32),
                     list_len=list_len.astype(np.int32),
                     ntotal=int(sum(p.ntotal for p in parts)),
                     opq_R=parts[0].opq_R)
