"""Lexical BM25 retrieval — self-contained (no Elasticsearch).

Parity with the reference's BM25 baseline
(``beir/beir/retrieval/search/lexical/bm25_search.py``, which shells out to
an Elasticsearch cluster): same scoring (BM25 Okapi, k1=1.5 b=0.75, multi-
field title+text), implemented as a numpy CSR inverted index scored per
query term — sufficient for the benchmark harness without a search daemon.

The port's own copy of ``chamjax/ir/lexical.py``, which imports no
framework: the same code, so results equal the JAX package's to the last bit.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List

import numpy as np

_TOKEN = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> List[str]:
    return _TOKEN.findall(text.lower())


class BM25Search:
    def __init__(self, k1: float = 1.5, b: float = 0.75,
                 title_weight: float = 1.0):
        self.k1 = k1
        self.b = b
        self.title_weight = title_weight
        self._index_built = False

    def _build(self, corpus: Dict[str, Dict[str, str]]) -> None:
        self.dids = list(corpus.keys())
        # term -> {doc_idx: tf}
        postings: Dict[str, Dict[int, float]] = {}
        doc_len = np.zeros(len(self.dids), np.float64)
        for i, did in enumerate(self.dids):
            doc = corpus[did]
            toks = tokenize(doc.get("text", ""))
            ttoks = tokenize(doc.get("title", ""))
            counts = Counter(toks)
            for t, c in Counter(ttoks).items():
                counts[t] = counts.get(t, 0) + self.title_weight * c
            doc_len[i] = sum(counts.values())
            for t, c in counts.items():
                postings.setdefault(t, {})[i] = float(c)
        self.doc_len = doc_len
        self.avgdl = float(doc_len.mean()) if len(doc_len) else 1.0
        self.N = len(self.dids)
        # freeze postings into arrays for fast scoring
        self.postings = {
            t: (np.fromiter(p.keys(), np.int64, len(p)),
                np.fromiter(p.values(), np.float64, len(p)))
            for t, p in postings.items()
        }
        self._index_built = True

    def _idf(self, df: int) -> float:
        return math.log(1.0 + (self.N - df + 0.5) / (df + 0.5))

    def search(self, corpus, queries: Dict[str, str], top_k: int,
               score_function: str = "bm25", **kwargs
               ) -> Dict[str, Dict[str, float]]:
        if not self._index_built:
            self._build(corpus)
        results: Dict[str, Dict[str, float]] = {}
        for qid, qtext in queries.items():
            scores = np.zeros(self.N, np.float64)
            for t in tokenize(qtext):
                post = self.postings.get(t)
                if post is None:
                    continue
                idx, tf = post
                idf = self._idf(len(idx))
                denom = tf + self.k1 * (1 - self.b + self.b *
                                        self.doc_len[idx] / self.avgdl)
                scores[idx] += idf * tf * (self.k1 + 1) / denom
            k = min(top_k, self.N)
            top = np.argpartition(-scores, k - 1)[:k]
            top = top[np.argsort(-scores[top], kind="stable")]
            results[qid] = {self.dids[int(i)]: float(scores[int(i)])
                            for i in top if scores[int(i)] > 0
                            and self.dids[int(i)] != qid}
        return results
