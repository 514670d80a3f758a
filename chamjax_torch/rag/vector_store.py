"""Embedding vector store for RAG pipelines (the port of
``chamjax/rag/vector_store.py``).

Parity with the reference's LangChain-FAISS store
(``reranker_hf/advanced_rag.py:138-148``: GTE-small embeddings, normalized,
cosine): encode chunks once, keep embeddings on the device, answer
``similarity_search`` with one fp32 matmul and top-k (``backend="exact"``,
the dense module's ``_chunk_scores``) or through the IVF-PQ engine
(``backend="ivfpq"``: ``build_ivfpq`` and ``IVFSearcher``, the
``adc_scan_tiles`` kernel on the card) when the corpus is large.  Save/load
writes the JAX package's files (``embeddings.npy``, ``docs.jsonl``), so a
store saved by one package loads in the other.  ``device=None`` means the
card.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from chamjax_torch.ir.dense import _chunk_scores
from chamjax_torch.utils.device import as_f32, resolve_device


class VectorStore:
    def __init__(self, encoder, backend: str = "exact",
                 index_cfg=None, nprobe: int = 32, device=None):
        self.encoder = encoder
        self.backend = backend
        self.index_cfg = index_cfg
        self.nprobe = nprobe
        self.device = resolve_device(device)
        self.docs: List[Dict[str, str]] = []
        self.emb: Optional[np.ndarray] = None
        # the ivfpq backend's PackedIVF: built on first use from the
        # embeddings, or given (a PackedIVF over them, e.g. loaded)
        self.index = None
        self._searcher = None
        self._emb_dev: Optional[torch.Tensor] = None

    # --- build ---------------------------------------------------------

    @staticmethod
    def from_documents(docs: List[Dict[str, str]], encoder,
                       backend: str = "exact", **kw) -> "VectorStore":
        store = VectorStore(encoder, backend=backend, **kw)
        store.add_documents(docs)
        return store

    def add_documents(self, docs: List[Dict[str, str]]) -> None:
        emb = np.asarray(self.encoder.encode_corpus(docs), np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9
        self.docs.extend(docs)
        self.emb = emb if self.emb is None else np.vstack([self.emb, emb])
        self.index = self._searcher = self._emb_dev = None

    def _build_ann(self):
        from chamjax_torch.config import IndexConfig, SearchConfig
        from chamjax_torch.index import build_ivfpq
        from chamjax_torch.searcher import IVFSearcher
        if self.index is None:
            n, d = self.emb.shape
            cfg = self.index_cfg or IndexConfig(
                dim=d, nlist=max(16, min(4096, n // 64)), m=max(4, d // 16))
            self.index = build_ivfpq(self.emb, cfg, device=self.device)
        self._searcher = IVFSearcher(
            self.index, SearchConfig(nprobe=self.nprobe, k=100),
            device=self.device)

    @property
    def searcher(self):
        """The ivfpq backend's ``IVFSearcher`` (built on first use)."""
        if self._searcher is None:
            self._build_ann()
        return self._searcher

    # --- query ---------------------------------------------------------

    def similarity_search(self, query: str, k: int = 5
                          ) -> List[Tuple[Dict[str, str], float]]:
        """Returns [(doc, score)] best-first, cosine similarity."""
        q = np.asarray(self.encoder.encode_queries([query]), np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True) + 1e-9
        if self.backend == "ivfpq":
            dists, ids = self.searcher.search(q, k=min(k, len(self.docs)))
            # L2 on unit vectors → cosine = 1 - d/2
            return [(self.docs[int(i)], float(1.0 - d_ / 2.0))
                    for i, d_ in zip(ids[0], dists[0]) if i >= 0]
        if self._emb_dev is None:
            self._emb_dev = as_f32(self.emb, self.device)
        v, i = _chunk_scores(as_f32(q, self.device), self._emb_dev,
                             min(k, len(self.docs)), True)
        v, i = v.cpu().numpy(), i.cpu().numpy()
        return [(self.docs[int(di)], float(sv))
                for di, sv in zip(i[0], v[0])]

    # --- persistence (reference prebuilt stores) ------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "embeddings.npy"), self.emb)
        with open(os.path.join(path, "docs.jsonl"), "w") as f:
            for d in self.docs:
                f.write(json.dumps(d) + "\n")

    @staticmethod
    def load(path: str, encoder, **kw) -> "VectorStore":
        store = VectorStore(encoder, **kw)
        store.emb = np.load(os.path.join(path, "embeddings.npy"))
        with open(os.path.join(path, "docs.jsonl")) as f:
            store.docs = [json.loads(line) for line in f]
        return store
