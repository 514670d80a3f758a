"""Rank-based IR metrics over qrels, implemented directly (no pytrec_eval).

Metric definitions match the reference's evaluation surface
(``beir/beir/retrieval/evaluation.py:41-67`` via pytrec_eval's
``ndcg_cut/map_cut/recall/P`` measures, and ``custom_metrics.py`` for
mrr / recall_cap / hole / top_k_accuracy).  Conventions follow trec_eval:

- results: {qid: {docid: score}} — higher score = better.
- qrels:   {qid: {docid: relevance int}} — relevance > 0 counts as relevant.
- Ties broken by (score desc, docid asc) for determinism.
- Queries absent from qrels are skipped; metrics average over evaluated
  queries.

The port's own copy of ``chamjax/ir/metrics.py``, which imports no
framework: the same code, so results equal the JAX package's to the last bit.
"""

from __future__ import annotations

import math
from typing import Dict, List

Qrels = Dict[str, Dict[str, int]]
Results = Dict[str, Dict[str, float]]


def _ranked(doc_scores: Dict[str, float], k: int) -> List[str]:
    return [d for d, _ in sorted(doc_scores.items(),
                                 key=lambda kv: (-kv[1], kv[0]))[:k]]


def _dcg(rels: List[int]) -> float:
    return sum(r / math.log2(i + 2) for i, r in enumerate(rels))


def ndcg_at_k(qrels: Qrels, results: Results, k: int) -> float:
    vals = []
    for qid, rel in qrels.items():
        ranked = _ranked(results.get(qid, {}), k)
        gains = [rel.get(d, 0) for d in ranked]
        ideal = sorted(rel.values(), reverse=True)[:k]
        idcg = _dcg(ideal)
        vals.append(_dcg(gains) / idcg if idcg > 0 else 0.0)
    return float(sum(vals) / max(len(vals), 1))


def map_at_k(qrels: Qrels, results: Results, k: int) -> float:
    vals = []
    for qid, rel in qrels.items():
        relevant = {d for d, r in rel.items() if r > 0}
        if not relevant:
            continue
        ranked = _ranked(results.get(qid, {}), k)
        hits, ap = 0, 0.0
        for i, d in enumerate(ranked):
            if d in relevant:
                hits += 1
                ap += hits / (i + 1)
        # trec_eval map_cut divides by the TOTAL relevant count, not
        # min(R, k) — min(R, k) would report MAP@10 = 1.0 on a query with
        # 50 relevant docs and a perfect top-10, 5x the pytrec_eval value
        vals.append(ap / len(relevant))
    return float(sum(vals) / max(len(vals), 1))


def recall_at_k(qrels: Qrels, results: Results, k: int) -> float:
    vals = []
    for qid, rel in qrels.items():
        relevant = {d for d, r in rel.items() if r > 0}
        if not relevant:
            continue
        ranked = set(_ranked(results.get(qid, {}), k))
        vals.append(len(ranked & relevant) / len(relevant))
    return float(sum(vals) / max(len(vals), 1))


def precision_at_k(qrels: Qrels, results: Results, k: int) -> float:
    vals = []
    for qid, rel in qrels.items():
        relevant = {d for d, r in rel.items() if r > 0}
        if not relevant:
            continue
        ranked = _ranked(results.get(qid, {}), k)
        vals.append(len(set(ranked) & relevant) / k)
    return float(sum(vals) / max(len(vals), 1))


# --- custom metrics (reference beir custom_metrics.py) ----------------------

def mrr_at_k(qrels: Qrels, results: Results, k: int) -> float:
    vals = []
    for qid, rel in qrels.items():
        relevant = {d for d, r in rel.items() if r > 0}
        if not relevant:
            continue
        rr = 0.0
        for i, d in enumerate(_ranked(results.get(qid, {}), k)):
            if d in relevant:
                rr = 1.0 / (i + 1)
                break
        vals.append(rr)
    return float(sum(vals) / max(len(vals), 1))


def recall_cap_at_k(qrels: Qrels, results: Results, k: int) -> float:
    """Recall with denominator capped at k (``capped_recall``)."""
    vals = []
    for qid, rel in qrels.items():
        relevant = {d for d, r in rel.items() if r > 0}
        if not relevant:
            continue
        ranked = set(_ranked(results.get(qid, {}), k))
        vals.append(len(ranked & relevant) / min(len(relevant), k))
    return float(sum(vals) / max(len(vals), 1))


def hole_at_k(qrels: Qrels, results: Results, k: int) -> float:
    """Fraction of retrieved@k docs with NO judgment at all (unjudged)."""
    vals = []
    for qid, rel in qrels.items():
        ranked = _ranked(results.get(qid, {}), k)
        if not ranked:
            vals.append(0.0)
            continue
        unjudged = sum(1 for d in ranked if d not in rel)
        vals.append(unjudged / len(ranked))
    return float(sum(vals) / max(len(vals), 1))


def top_k_accuracy(qrels: Qrels, results: Results, k: int) -> float:
    """1 if any relevant doc appears in the top-k, else 0 (per query)."""
    vals = []
    for qid, rel in qrels.items():
        relevant = {d for d, r in rel.items() if r > 0}
        if not relevant:
            continue
        ranked = set(_ranked(results.get(qid, {}), k))
        vals.append(1.0 if ranked & relevant else 0.0)
    return float(sum(vals) / max(len(vals), 1))
