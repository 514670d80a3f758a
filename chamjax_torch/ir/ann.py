"""ANN retrieval over the port's quantized indexes for IR benchmarks (the
port of ``chamjax/ir/ann.py``).

Parity with the reference's Faiss-backed search family
(``beir/beir/retrieval/search/dense/faiss_search.py:14-458`` — each variant
with index/save/load/search):

- ``DenseRetrievalIVFPQSearch``  ↔ IVF-PQ through the serving engine
  (``IVFSearcher``: on the card the ``adc_scan_tiles`` kernel)
- ``FlatIPSearch``               ↔ ``FlatIPFaissSearch`` (exact, chunked)
- ``PQSearch``                   ↔ ``PQFaissSearch`` (whole-corpus ADC)
- ``SQSearch``                   ↔ ``SQFaissSearch`` (per-dim affine uint8)
- ``PCASearch``                  ↔ ``PCAFaissSearch`` (PCA → base search)
- ``BinarySearch``               ↔ ``BinaryFaissSearch`` (sign bits, an
  exact Hamming count, float rescore of the candidate pool)
- ``HNSWSearch`` / ``HNSWSQSearch`` ↔ the HNSW variants, on the port's
  native ``HNSWIndex``

L2 distance over normalized embeddings is rank-equivalent to cosine.  The
scorers are torch ops (the JAX package's are ``jnp`` ops, not Pallas):
fp32 matmuls with TF32 off, exact ``torch.topk``.  Saved files are the JAX
package's (npz, ``*_dids.npy``, the HNSW graph), so an index saved by one
package loads in the other.  ``device=None`` means the card.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from chamjax_torch.config import IndexConfig, SearchConfig
from chamjax_torch.index import build_ivfpq
from chamjax_torch.index.ivf import PackedIVF
from chamjax_torch.index.pq import train_pq, pq_encode
from chamjax_torch.ir.dense import _merge_topk, _results
from chamjax_torch.searcher import IVFSearcher
from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)


def _save_dids(output_dir: str, prefix: str, dids) -> None:
    np.save(os.path.join(output_dir, f"{prefix}_dids.npy"),
            np.asarray(dids, dtype=object), allow_pickle=True)


def _load_dids(input_dir: str, prefix: str) -> List[str]:
    return list(np.load(os.path.join(input_dir, f"{prefix}_dids.npy"),
                        allow_pickle=True))


class DenseRetrievalIVFPQSearch:
    """BEIR-style search backed by the port's IVF-PQ engine."""

    def __init__(self, model, index_cfg: Optional[IndexConfig] = None,
                 nprobe: int = 32, batch_size: int = 128,
                 normalize: bool = True, device=None):
        self.model = model
        self.index_cfg = index_cfg
        self.nprobe = nprobe
        self.batch_size = batch_size
        self.normalize = normalize
        self.device = resolve_device(device)
        self.index: Optional[PackedIVF] = None
        self.searcher: Optional[IVFSearcher] = None
        self._dids: list = []

    # --- index lifecycle (reference faiss_search index/save/load) ---------

    def index_corpus(self, corpus: Dict[str, Dict[str, str]]) -> None:
        self._dids = list(corpus.keys())
        emb = np.asarray(self.model.encode_corpus(
            [corpus[d] for d in self._dids], batch_size=self.batch_size),
            np.float32)
        if self.normalize:
            emb = _normalize(emb)
        d = emb.shape[1]
        cfg = self.index_cfg or IndexConfig(
            dim=d, nlist=max(16, min(4096, len(self._dids) // 64)),
            m=max(4, d // 16))
        self.index = build_ivfpq(emb, cfg, device=self.device)

    def save(self, output_dir: str, prefix: str = "ivfpq") -> None:
        assert self.index is not None
        os.makedirs(output_dir, exist_ok=True)
        self.index.save(os.path.join(output_dir, f"{prefix}.npz"))
        _save_dids(output_dir, prefix, self._dids)

    def load(self, input_dir: str, prefix: str = "ivfpq") -> None:
        self.index = PackedIVF.load(os.path.join(input_dir, f"{prefix}.npz"))
        self._dids = _load_dids(input_dir, prefix)
        self.searcher = None

    # --- search -------------------------------------------------------------

    def query_matrix(self, queries: Dict[str, str]) -> np.ndarray:
        """The queries' embeddings as the search takes them."""
        q = np.asarray(self.model.encode_queries(
            list(queries.values()), batch_size=self.batch_size), np.float32)
        return _normalize(q) if self.normalize else q

    def search(self, corpus, queries: Dict[str, str], top_k: int,
               score_function: str = "cos_sim", **kwargs
               ) -> Dict[str, Dict[str, float]]:
        if self.index is None:
            self.index_corpus(corpus)
        if self.searcher is None:
            self.searcher = IVFSearcher(
                self.index, SearchConfig(nprobe=self.nprobe, k=top_k),
                device=self.device)
        dists, ids = self.searcher.search(self.query_matrix(queries),
                                          k=top_k)
        # negate L2: higher = better, rank-equivalent to cosine on
        # normalized vectors
        return _results(list(queries), self._dids, -dists, ids)


# --- quantized / flat search family -----------------------------------------


class _EncodedSearchBase:
    """Shared encode → build → score → results plumbing.

    Mirrors the shape of the reference's ``DenseRetrievalFaissSearch`` base
    (``faiss_search.py:14-100``): subclasses provide ``_build(emb)``,
    ``_score_all(q, top_k) -> (scores, idx)`` (higher = better), and the
    ``_state()/_restore(state)`` pair used by save/load.
    """

    _prefix = "encoded"

    def __init__(self, model, batch_size: int = 128, normalize: bool = True,
                 corpus_chunk_size: int = 16384, device=None):
        self.model = model
        self.batch_size = batch_size
        self.normalize = normalize
        self.corpus_chunk_size = corpus_chunk_size
        self.device = resolve_device(device)
        self._dids: List[str] = []

    # -- index lifecycle ----------------------------------------------------

    def index_corpus(self, corpus: Dict[str, Dict[str, str]]) -> None:
        self._dids = list(corpus.keys())
        emb = np.asarray(self.model.encode_corpus(
            [corpus[d] for d in self._dids], batch_size=self.batch_size),
            np.float32)
        if self.normalize:
            emb = _normalize(emb)
        self._build(emb)

    def save(self, output_dir: str, prefix: Optional[str] = None) -> None:
        prefix = prefix or self._prefix
        os.makedirs(output_dir, exist_ok=True)
        state = {k: np.asarray(v) for k, v in self._state().items()}
        np.savez_compressed(
            os.path.join(output_dir, f"{prefix}.npz"), **state)
        _save_dids(output_dir, prefix, self._dids)

    def load(self, input_dir: str, prefix: Optional[str] = None) -> None:
        prefix = prefix or self._prefix
        z = np.load(os.path.join(input_dir, f"{prefix}.npz"))
        self._restore({k: z[k] for k in z.files})
        self._dids = _load_dids(input_dir, prefix)

    # -- search ---------------------------------------------------------------

    def search(self, corpus, queries: Dict[str, str], top_k: int,
               score_function: str = "cos_sim", **kwargs
               ) -> Dict[str, Dict[str, float]]:
        if not self._dids:
            self.index_corpus(corpus)
        qids = list(queries.keys())
        q = np.asarray(self.model.encode_queries(
            [queries[qid] for qid in qids], batch_size=self.batch_size),
            np.float32)
        if self.normalize:
            q = _normalize(q)
        with fp32_matmul():
            scores, idx = self._score_all(q, top_k)
        if isinstance(scores, torch.Tensor):
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        return _results(qids, self._dids, np.asarray(scores),
                        np.asarray(idx))

    def _chunked_topk(self, n_total: int, score_fn, top_k: int):
        """Running top-k merge over corpus chunks (higher = better):
        ``score_fn(start, n, k)`` scores rows ``[start, start + n)``."""
        best_v = best_i = None
        for start in range(0, n_total, self.corpus_chunk_size):
            v, i = score_fn(start, min(self.corpus_chunk_size,
                                       n_total - start), top_k)
            i = i + start
            if best_v is None:
                best_v, best_i = v, i
            else:
                best_v, best_i = _merge_topk(best_v, best_i, v, i, top_k)
        return best_v, best_i

    def _on(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- subclass hooks -------------------------------------------------------

    def _build(self, emb: np.ndarray) -> None:
        raise NotImplementedError

    def _score_all(self, q: np.ndarray, top_k: int):
        raise NotImplementedError

    def _state(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _restore(self, state: Dict[str, np.ndarray]) -> None:
        raise NotImplementedError


def _topk(s: torch.Tensor, top_k: int):
    return torch.topk(s, min(top_k, s.shape[1]), dim=1)


class FlatIPSearch(_EncodedSearchBase):
    """Exact inner-product search (``FlatIPFaissSearch``): the corpus matrix
    lives on the device; scoring = chunked matmul + running top-k."""

    _prefix = "flat_ip"

    def _build(self, emb: np.ndarray) -> None:
        self._emb = emb

    def _score_all(self, q: np.ndarray, top_k: int):
        emb, qd = self._on(self._emb), as_f32(q, self.device)
        return self._chunked_topk(
            emb.shape[0], lambda s, n, k: _topk(qd @ emb[s:s + n].T, k),
            top_k)

    def _state(self):
        return {"emb": self._emb}

    def _restore(self, state):
        self._emb = state["emb"]


class PQSearch(_EncodedSearchBase):
    """Whole-corpus PQ with ADC scoring (``PQFaissSearch``): no coarse
    quantizer — every query scans all N codes through its LUT (a gather
    and a sum over the sub-quantizers, torch ops as the JAX package's are
    ``jnp`` ops)."""

    _prefix = "pq"

    def __init__(self, model, m: int = 16, nbits: int = 8, **kw):
        super().__init__(model, **kw)
        self.m, self.nbits = m, nbits

    def _build(self, emb: np.ndarray) -> None:
        self._codebooks = train_pq(emb, self.m, nbits=self.nbits, iters=12,
                                   device=self.device)
        self._codes = pq_encode(emb, self._codebooks, device=self.device)

    def _score_all(self, q: np.ndarray, top_k: int):
        m, ksub, dsub = self._codebooks.shape
        qs = q.reshape(q.shape[0], m, 1, dsub)
        cb = self._codebooks[None]                       # (1, m, ksub, dsub)
        # negated squared L2 per subspace → higher = better
        luts = self._on(-((qs - cb) ** 2).sum(-1))       # (b, m, ksub)
        codes = self._on(self._codes)

        def score(s, n, k):
            c = codes[s:s + n].T.long()                  # (m, C)
            g = torch.gather(luts, 2, c[None].expand(luts.shape[0], -1, -1))
            return _topk(g.sum(dim=1), k)

        return self._chunked_topk(codes.shape[0], score, top_k)

    def _state(self):
        return {"codebooks": self._codebooks, "codes": self._codes}

    def _restore(self, state):
        self._codebooks, self._codes = state["codebooks"], state["codes"]


class SQSearch(_EncodedSearchBase):
    """Scalar-quantized flat search (``SQFaissSearch``, QT_8bit): per-dim
    affine uint8 codes, 4× smaller than f32.  IP against the decode is exact
    in the quantized domain: ``q·(vmin + scale∘c) = q·vmin + (q∘scale)·c``,
    so scoring is one matmul over the codes a chunk — no decode kept."""

    _prefix = "sq8"

    def _build(self, emb: np.ndarray) -> None:
        self._vmin = emb.min(axis=0)
        scale = (emb.max(axis=0) - self._vmin) / 255.0
        self._scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        self._codes = np.clip(np.rint(
            (emb - self._vmin) / self._scale), 0, 255).astype(np.uint8)

    def _score_all(self, q: np.ndarray, top_k: int):
        q_scaled = self._on(q * self._scale)
        q_off = self._on(q @ self._vmin)
        codes = self._on(self._codes)
        return self._chunked_topk(
            codes.shape[0],
            lambda s, n, k: _topk(q_scaled @ codes[s:s + n].T.float()
                                  + q_off[:, None], k),
            top_k)

    def _state(self):
        return {"vmin": self._vmin, "scale": self._scale,
                "codes": self._codes}

    def _restore(self, state):
        self._vmin, self._scale = state["vmin"], state["scale"]
        self._codes = state["codes"]


class PCASearch(FlatIPSearch):
    """PCA dimensionality reduction in front of flat search
    (``PCAFaissSearch``: PCAMatrix → base index).  Fit = centered SVD on the
    corpus sample (numpy, as in the JAX package); queries are projected
    through the same matrix."""

    _prefix = "pca"

    def __init__(self, model, output_dim: int = 64, fit_sample: int = 65536,
                 **kw):
        super().__init__(model, **kw)
        self.output_dim = output_dim
        self.fit_sample = fit_sample

    def _build(self, emb: np.ndarray) -> None:
        rs = np.random.default_rng(0)
        sample = emb if emb.shape[0] <= self.fit_sample else \
            emb[rs.choice(emb.shape[0], self.fit_sample, replace=False)]
        self._mean = sample.mean(axis=0)
        _, _, vt = np.linalg.svd(sample - self._mean, full_matrices=False)
        self._components = vt[:self.output_dim].T.astype(np.float32)
        self._emb = (emb - self._mean) @ self._components

    def _score_all(self, q: np.ndarray, top_k: int):
        q_r = (q - self._mean) @ self._components
        return super()._score_all(q_r, top_k)

    def _state(self):
        return {"emb": self._emb, "mean": self._mean,
                "components": self._components}

    def _restore(self, state):
        self._emb = state["emb"]
        self._mean, self._components = state["mean"], state["components"]


_M1, _M2, _M4 = 0x5555555555555555, 0x3333333333333333, 0x0F0F0F0F0F0F0F0F


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 (SWAR; torch has no popcount).  The masks
    drop the bits an arithmetic shift copies in, so signed words count
    right; exact."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4               # a count a byte, each ≤ 8
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def _words(bits: np.ndarray) -> np.ndarray:
    """Packed sign bits (n, nbytes) uint8 → (n, ceil(nbytes/8)) int64 words
    (zero bytes pad the last word, and count nothing)."""
    pad = (-bits.shape[1]) % 8
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    return np.ascontiguousarray(bits).view(np.int64)


def hamming(q_words: torch.Tensor, c_words: torch.Tensor) -> torch.Tensor:
    """(b, w) and (C, w) int64 words → (b, C) int64 Hamming distances."""
    return popcount64(q_words[:, None, :] ^ c_words[None]).sum(dim=-1)


class BinarySearch(_EncodedSearchBase):
    """Sign-binarized search (``BinaryFaissSearch``): per-dim mean-centered
    sign bits packed 8/byte (32× smaller than f32); candidate generation by
    an exact Hamming count (``popcount64`` over int64 words, the port of
    ``lax.population_count``), then float rescoring of a
    ``rescore_factor·top_k`` pool, the reference's two-phase binary flow.
    Among equal Hamming distances the lower row wins, as under
    ``lax.top_k``: the pool is the JAX package's."""

    _prefix = "binary"

    def __init__(self, model, rescore_factor: int = 8, **kw):
        super().__init__(model, **kw)
        self.rescore_factor = rescore_factor

    def _build(self, emb: np.ndarray) -> None:
        self._mean = emb.mean(axis=0)
        centered = emb - self._mean
        self._sigma = np.abs(centered).mean(axis=0).astype(np.float32)
        self._bits = self._pack(centered > 0)

    @staticmethod
    def _pack(signs: np.ndarray) -> np.ndarray:
        bits = signs.astype(np.uint8)
        pad = (-bits.shape[1]) % 8
        if pad:
            bits = np.pad(bits, ((0, 0), (0, pad)))
        return np.packbits(bits, axis=1, bitorder="little")

    def _score_all(self, q: np.ndarray, top_k: int):
        n = self._bits.shape[0]
        c_words = self._on(_words(self._bits))
        q_words = self._on(_words(self._pack(q - self._mean > 0)))
        pool = min(n, max(top_k * self.rescore_factor, top_k))
        rows = torch.arange(n, device=self.device)

        def score(s, m, k):
            # one key a row: distance first, then the row (the lower wins)
            key = hamming(q_words, c_words[s:s + m]) * n + rows[s:s + m]
            return _topk(-key, k)

        _, cand = self._chunked_topk(n, score, pool)
        scores = self._rescore(as_f32(q, self.device),
                               self._on(self._bits)[cand])
        v, sel = _topk(scores, top_k)
        return v, torch.gather(cand, 1, sel)

    def _rescore(self, q: torch.Tensor, cand_bits: torch.Tensor
                 ) -> torch.Tensor:
        """Float query · sign-decode of candidate bits (the reference
        rescores hamming candidates against ``index.reconstruct``)."""
        b, r, nbytes = cand_bits.shape
        shifts = torch.arange(8, dtype=torch.uint8, device=q.device)
        bits = (cand_bits[..., None] >> shifts) & 1     # (b, r, bytes, 8)
        signs = bits.reshape(b, r, nbytes * 8)[..., :q.shape[1]].float()
        dec = (self._on(self._mean)
               + self._on(self._sigma) * (signs * 2.0 - 1.0))
        return torch.einsum("bd,brd->br", q, dec)

    def _state(self):
        return {"bits": self._bits, "mean": self._mean,
                "sigma": self._sigma}

    def _restore(self, state):
        self._bits, self._mean = state["bits"], state["mean"]
        self._sigma = state["sigma"]


class HNSWSearch(_EncodedSearchBase):
    """Graph-ANN search (``HNSWFaissSearch``) on the native HNSW index
    (``chamjax_torch/native/src/hnsw.cpp`` — the capability the reference
    vendors hnswlib for).  Host-side C++: the graph walk is pointer-chasing,
    so it stays on the host."""

    _prefix = "hnsw"

    def __init__(self, model, M: int = 16, ef_construction: int = 200,
                 ef_search: int = 128, **kw):
        super().__init__(model, **kw)
        self.M, self.efc, self.ef_search = M, ef_construction, ef_search
        self._index = None

    def _build(self, emb: np.ndarray) -> None:
        from chamjax_torch.native import HNSWIndex
        self._dim = emb.shape[1]
        self._index = HNSWIndex(self._dim, M=self.M,
                                ef_construction=self.efc)
        self._index.add(emb)

    def _score_all(self, q: np.ndarray, top_k: int):
        labels, dists = self._index.search(
            q, k=top_k, ef=max(self.ef_search, top_k))
        return -dists, labels          # negate L2: higher = better

    # HNSW has its own binary format — override save/load wholesale.
    def save(self, output_dir: str, prefix: Optional[str] = None) -> None:
        prefix = prefix or self._prefix
        os.makedirs(output_dir, exist_ok=True)
        self._index.save(os.path.join(output_dir, f"{prefix}.hnsw"))
        np.save(os.path.join(output_dir, f"{prefix}_meta.npy"),
                np.asarray([self._dim], np.int64))
        _save_dids(output_dir, prefix, self._dids)

    def load(self, input_dir: str, prefix: Optional[str] = None) -> None:
        from chamjax_torch.native import HNSWIndex
        prefix = prefix or self._prefix
        self._dim = int(np.load(os.path.join(
            input_dir, f"{prefix}_meta.npy"))[0])
        self._index = HNSWIndex.load_file(
            os.path.join(input_dir, f"{prefix}.hnsw"), self._dim)
        self._dids = _load_dids(input_dir, prefix)


class HNSWSQSearch(HNSWSearch):
    """Scalar-quantized HNSW (``HNSWSQFaissSearch``): embeddings pass
    through the 8-bit per-dim affine quantizer before entering the graph, so
    the stored vectors (and the saved artifact) carry SQ8 precision."""

    _prefix = "hnsw_sq"

    def _build(self, emb: np.ndarray) -> None:
        vmin = emb.min(axis=0)
        scale = (emb.max(axis=0) - vmin) / 255.0
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        codes = np.clip(np.rint((emb - vmin) / scale), 0, 255)
        super()._build((codes * scale + vmin).astype(np.float32))
