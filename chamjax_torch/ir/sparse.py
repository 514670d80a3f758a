"""Sparse retrieval: learned term-weight search (SPARTA-style).

Parity with the reference's sparse search
(``beir/beir/retrieval/search/sparse/sparse_search.py`` — SPARTA: documents
encode to sparse term→weight vectors, queries score by summing their
tokens' weights).  The engine here is a term→(doc, weight) inverted index
scored with numpy, duck-typed over any ``sparse_encoder``:

- ``encode_corpus(docs) -> list[dict[token, weight]]``
- ``encode_query(text) -> list[token]`` (query tokens; weights are looked
  up from the document side, as in SPARTA)

The default ``TfidfSparseEncoder`` makes the stage hermetic; plug a learned
encoder (SPLADE/UniCOIL-style) through the same contract.

The port's own copy of ``chamjax/ir/sparse.py``, which imports no
framework: the same code, so results equal the JAX package's to the last bit.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List

import numpy as np

from chamjax_torch.ir.lexical import tokenize


class TfidfSparseEncoder:
    """Hermetic sparse encoder: tf·idf document term weights."""

    def fit(self, texts: List[str]) -> None:
        df: Counter = Counter()
        for t in texts:
            df.update(set(tokenize(t)))
        self.n = len(texts)
        self.df = df

    def encode_corpus(self, docs) -> List[Dict[str, float]]:
        texts = [(d.get("title", "") + " " + d.get("text", "")).strip()
                 if isinstance(d, dict) else str(d) for d in docs]
        if not hasattr(self, "df"):
            self.fit(texts)
        out = []
        for t in texts:
            tf = Counter(tokenize(t))
            out.append({
                tok: (1 + math.log(c)) * math.log(
                    1 + self.n / (self.df.get(tok, 1)))
                for tok, c in tf.items()})
        return out

    def encode_query(self, text: str) -> List[str]:
        return tokenize(text)


class SparseSearch:
    """Term-weight retrieval over an inverted index (reference
    ``SparseSearch``)."""

    def __init__(self, sparse_encoder=None, batch_size: int = 128):
        self.encoder = sparse_encoder or TfidfSparseEncoder()
        self.batch_size = batch_size
        self._built = False

    def _build(self, corpus: Dict[str, Dict[str, str]]) -> None:
        self.dids = list(corpus.keys())
        weights = self.encoder.encode_corpus(
            [corpus[d] for d in self.dids])
        postings: Dict[str, Dict[int, float]] = {}
        for i, w in enumerate(weights):
            for tok, val in w.items():
                postings.setdefault(tok, {})[i] = float(val)
        self.postings = {
            t: (np.fromiter(p.keys(), np.int64, len(p)),
                np.fromiter(p.values(), np.float64, len(p)))
            for t, p in postings.items()}
        self._built = True

    def search(self, corpus, queries: Dict[str, str], top_k: int,
               score_function: str = "dot", **kwargs
               ) -> Dict[str, Dict[str, float]]:
        if not self._built:
            self._build(corpus)
        n = len(self.dids)
        results: Dict[str, Dict[str, float]] = {}
        for qid, qtext in queries.items():
            scores = np.zeros(n, np.float64)
            q = self.encoder.encode_query(qtext)
            # list[token] → SPARTA semantics (doc-side weights only);
            # dict[token, weight] → UniCOIL/SPLADE semantics (q_w · d_w)
            q_items = q.items() if isinstance(q, dict) else \
                [(tok, 1.0) for tok in q]
            for tok, qw in q_items:
                post = self.postings.get(tok)
                if post is not None:
                    idx, w = post
                    scores[idx] += qw * w
            k = min(top_k, n)
            top = np.argpartition(-scores, k - 1)[:k]
            top = top[np.argsort(-scores[top], kind="stable")]
            results[qid] = {self.dids[int(i)]: float(scores[int(i)])
                            for i in top if scores[int(i)] > 0
                            and self.dids[int(i)] != qid}
        return results


class LearnedSparseEncoder:
    """SPLADE/UniCOIL-style learned sparse encoder, hermetic edition.

    Parity target: the reference's neural sparse models
    (``beir/beir/retrieval/models/{splade,unicoil}.py``) — documents and
    queries expand to weighted vocab-bucket vectors via
    ``log1p(relu(proj(tok)))`` with max-pooling over token positions (the
    SPLADE aggregation).  Here the projection is a deterministic hashed
    random matrix so the component runs without checkpoints or downloads;
    swap ``_tok_project`` with an HF MLM head for trained quality.  Emits
    *weighted* queries (dict), which ``SparseSearch`` scores as q_w · d_w.
    """

    def __init__(self, n_buckets: int = 4096, latent_dim: int = 64,
                 max_expansion: int = 64, seed: int = 11):
        self.n_buckets = n_buckets
        self.latent = latent_dim
        self.max_expansion = max_expansion
        self.seed = seed
        rng = np.random.default_rng(seed)
        # shared "vocabulary head": latent → buckets
        self.head = rng.standard_normal(
            (latent_dim, n_buckets)).astype(np.float32) / np.sqrt(latent_dim)
        self._tok_cache: Dict[str, np.ndarray] = {}

    def _tok_vec(self, tok: str) -> np.ndarray:
        v = self._tok_cache.get(tok)
        if v is None:
            import zlib
            s = zlib.crc32(tok.encode()) & 0x7FFFFFFF
            v = np.random.default_rng(s ^ self.seed).standard_normal(
                self.latent).astype(np.float32)
            self._tok_cache[tok] = v
        return v

    def _expand(self, text: str) -> Dict[str, float]:
        toks = tokenize(text)
        if not toks:
            return {}
        emb = np.stack([self._tok_vec(t) for t in toks])       # (t, latent)
        act = np.log1p(np.maximum(emb @ self.head, 0.0))       # (t, buckets)
        pooled = act.max(axis=0)                               # SPLADE max-pool
        top = np.argsort(-pooled)[: self.max_expansion]
        return {f"b{int(i)}": float(pooled[i]) for i in top if pooled[i] > 0}

    def encode_corpus(self, docs) -> List[Dict[str, float]]:
        texts = [(d.get("title", "") + " " + d.get("text", "")).strip()
                 if isinstance(d, dict) else str(d) for d in docs]
        return [self._expand(t) for t in texts]

    def encode_query(self, text: str) -> Dict[str, float]:
        return self._expand(text)
