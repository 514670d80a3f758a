"""Dense exact retrieval: chunked fp32 matmul and top-k on the card (the port
of ``chamjax/ir/dense.py``).

Parity with the reference's ``DenseRetrievalExactSearch``
(``beir/beir/retrieval/search/dense/exact_search.py:12-93``): encode queries
and corpus with a duck-typed model (``encode_queries`` / ``encode_corpus``),
score by cosine or dot product in corpus chunks, keep a running top-k on the
device.  The JAX package scores at ``Precision.HIGHEST``; here the matmul is
float32 with TF32 off (``fp32_matmul``) and the top-k is ``torch.topk``,
exact.  ``HFEncoder`` mean-pools a ``transformers`` checkpoint; it needs
``transformers``, imported when one is made.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from chamjax_torch.utils.collectives import all_gather_to
from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-9)


@fp32_matmul()
def _chunk_scores(q: torch.Tensor, c: torch.Tensor, top_k: int,
                  cosine: bool):
    """Scores (b, chunk) → per-chunk top-k (vals, idx)."""
    if cosine:
        q, c = _unit(q), _unit(c)
    s = q @ c.T
    return torch.topk(s, min(top_k, s.shape[1]), dim=1)


def _merge_topk(vals_a, idx_a, vals_b, idx_b, top_k: int):
    vals = torch.cat([vals_a, vals_b], dim=1)
    idx = torch.cat([idx_a, idx_b], dim=1)
    v, sel = torch.topk(vals, min(top_k, vals.shape[1]), dim=1)
    return v, torch.gather(idx, 1, sel)


def _results(qids, dids, vals: np.ndarray, idx: np.ndarray
             ) -> Dict[str, Dict[str, float]]:
    """BEIR's result dicts; drops padding (idx past the corpus, -inf) and
    self-retrieval."""
    results: Dict[str, Dict[str, float]] = {}
    for qi, qid in enumerate(qids):
        results[qid] = {
            dids[int(di)]: float(sv)
            for di, sv in zip(idx[qi], vals[qi])
            if 0 <= di < len(dids) and np.isfinite(sv)
            and dids[int(di)] != qid
        }
    return results


class DenseRetrievalExactSearch:
    """``device=None`` means the card; pass ``device="cpu"`` to run on the
    CPU."""

    def __init__(self, model, batch_size: int = 128,
                 corpus_chunk_size: int = 50_000, device=None):
        self.model = model
        self.batch_size = batch_size
        self.corpus_chunk_size = corpus_chunk_size
        self.device = resolve_device(device)

    def search(self, corpus: Dict[str, Dict[str, str]],
               queries: Dict[str, str], top_k: int,
               score_function: str = "cos_sim", **kwargs
               ) -> Dict[str, Dict[str, float]]:
        assert score_function in ("cos_sim", "dot")
        cosine = score_function == "cos_sim"
        qids = list(queries.keys())
        dids = list(corpus.keys())
        q_emb = as_f32(self.model.encode_queries(
            [queries[q] for q in qids], batch_size=self.batch_size),
            self.device)

        best_v = best_i = None
        for start in range(0, len(dids), self.corpus_chunk_size):
            chunk_ids = dids[start:start + self.corpus_chunk_size]
            c_emb = as_f32(self.model.encode_corpus(
                [corpus[d] for d in chunk_ids], batch_size=self.batch_size),
                self.device)
            v, i = _chunk_scores(q_emb, c_emb, top_k, cosine)
            i = i + start
            if best_v is None:
                best_v, best_i = v, i
            else:
                best_v, best_i = _merge_topk(best_v, best_i, v, i, top_k)
        return _results(qids, dids, best_v.cpu().numpy(),
                        best_i.cpu().numpy())


class HashingEncoder:
    """Deterministic text → vector encoder with no model weights.

    Token-hash random-feature embedding: each whitespace token seeds an RNG
    that draws a unit vector; a text embeds as the normalized sum.  Shares
    tokens ⇒ nearby embeddings, so retrieval quality is meaningfully testable
    hermetically (the reference's test bed relies on downloadable SBERT
    weights instead).  numpy on the host, the JAX package's code unchanged,
    so both packages embed a text to the same bits.
    """

    def __init__(self, dim: int = 256):
        self.dim = dim
        self._cache: Dict[str, np.ndarray] = {}

    def _token_vec(self, tok: str) -> np.ndarray:
        v = self._cache.get(tok)
        if v is None:
            import zlib
            # crc32, not hash(): hash() is salted per process
            seed = zlib.crc32(tok.encode()) & 0x7FFFFFFF
            v = np.random.default_rng(seed).standard_normal(self.dim)
            v /= np.linalg.norm(v) + 1e-9
            self._cache[tok] = v
        return v

    def _embed(self, text: str) -> np.ndarray:
        toks = text.lower().split()
        if not toks:
            return np.zeros(self.dim, np.float32)
        v = np.sum([self._token_vec(t) for t in toks], axis=0)
        return (v / (np.linalg.norm(v) + 1e-9)).astype(np.float32)

    def encode_queries(self, texts: List[str], batch_size: int = 0,
                       **kw) -> np.ndarray:
        return np.stack([self._embed(t) for t in texts])

    def encode_corpus(self, docs, batch_size: int = 0, **kw) -> np.ndarray:
        texts = [(d.get("title", "") + " " + d.get("text", "")).strip()
                 if isinstance(d, dict) else str(d) for d in docs]
        return np.stack([self._embed(t) for t in texts])


class HFEncoder:
    """Sentence-embedding adapter over a HuggingFace model (mean pooling),
    the reference's SBERT-model equivalent
    (``beir/beir/retrieval/models/``).  Needs ``transformers`` (imported
    here); ``model_name`` is a hub name or a local checkpoint directory.
    ``device=None`` means the card, and raises without one before anything
    loads."""

    def __init__(self, model_name: str = "sentence-transformers/all-MiniLM-L6-v2",
                 device=None, max_length: int = 256):
        self.device = resolve_device(device)
        from transformers import AutoModel, AutoTokenizer   # gated import
        self.tok = AutoTokenizer.from_pretrained(model_name)
        self.model = AutoModel.from_pretrained(model_name).to(
            self.device).eval()
        self.max_length = max_length

    def _encode(self, texts: List[str], batch_size: int) -> np.ndarray:
        out = []
        with torch.no_grad():
            for i in range(0, len(texts), batch_size):
                enc = self.tok(texts[i:i + batch_size], padding=True,
                               truncation=True, max_length=self.max_length,
                               return_tensors="pt").to(self.device)
                h = self.model(**enc).last_hidden_state
                mask = enc["attention_mask"].unsqueeze(-1)
                emb = (h * mask).sum(1) / mask.sum(1).clamp(min=1)
                out.append(emb.cpu().numpy())
        return np.concatenate(out, axis=0).astype(np.float32)

    def encode_queries(self, texts, batch_size: int = 32, **kw):
        return self._encode(list(texts), batch_size)

    def encode_corpus(self, docs, batch_size: int = 32, **kw):
        texts = [(d.get("title", "") + " " + d.get("text", "")).strip()
                 if isinstance(d, dict) else str(d) for d in docs]
        return self._encode(texts, batch_size)


class DenseRetrievalExactSearchMulti:
    """Mesh-parallel exact search — the reference's multi-GPU variant
    (``beir/beir/retrieval/search/dense/exact_search_multi_gpu.py``).

    The corpus embedding matrix is split row-wise over the positions of one
    mesh axis (``parallel.make_mesh``; ``mesh=None`` means every card, and
    raises where there is none); each position scores its shard and keeps
    a local top-k, and the merge gathers k·positions candidates onto the
    first position: the same shard-then-merge shape as the list-sharded
    IVF search (``parallel/sharded_search.py``), on the exact scorer.
    Rows that pad the corpus to a multiple of the positions score -inf.
    """

    def __init__(self, model, mesh=None, axis: str = "shard",
                 batch_size: int = 128):
        from chamjax_torch.parallel.mesh import make_mesh
        self.model = model
        self.batch_size = batch_size
        self.axis = axis
        self.mesh = mesh if mesh is not None else make_mesh(((axis, -1),))

    def search(self, corpus: Dict[str, Dict[str, str]],
               queries: Dict[str, str], top_k: int,
               score_function: str = "cos_sim", **kwargs
               ) -> Dict[str, Dict[str, float]]:
        assert score_function in ("cos_sim", "dot")
        cosine = score_function == "cos_sim"
        qids = list(queries.keys())
        dids = list(corpus.keys())
        q = np.asarray(self.model.encode_queries(
            [queries[qq] for qq in qids], batch_size=self.batch_size),
            np.float32)
        emb = np.asarray(self.model.encode_corpus(
            [corpus[dd] for dd in dids], batch_size=self.batch_size),
            np.float32)
        # one position a shard: the first along every other axis
        grid = np.moveaxis(self.mesh.devices,
                           self.mesh.axis_names.index(self.axis), 0)
        positions = list(grid.reshape(grid.shape[0], -1)[:, 0])
        n_dev = len(positions)
        rows = -(-emb.shape[0] // n_dev)
        vals, idx = [], []
        for j, dev in enumerate(positions):
            shard = emb[j * rows:(j + 1) * rows]
            n_valid = shard.shape[0]
            if n_valid < rows:                      # pad rows score -inf
                shard = np.pad(shard, ((0, rows - n_valid), (0, 0)))
            with fp32_matmul():
                qd, c = as_f32(q, dev), as_f32(shard, dev)
                if cosine:
                    qd, c = _unit(qd), _unit(c)
                s = qd @ c.T
            s[:, n_valid:] = float("-inf")
            v, i = torch.topk(s, min(top_k, rows), dim=1)
            vals.append(v)
            idx.append(i + j * rows)
        head = positions[0]
        v = torch.cat(all_gather_to(vals, head), dim=1)
        i = torch.cat(all_gather_to(idx, head), dim=1)
        v, sel = torch.topk(v, min(top_k, v.shape[1]), dim=1)
        i = torch.gather(i, 1, sel)
        return _results(qids, dids, v.cpu().numpy(), i.cpu().numpy())
