"""Retrieval evaluation orchestrator.

Parity with the reference's ``EvaluateRetrieval``
(``beir/beir/retrieval/evaluation.py:9-67``): wraps any retriever exposing
``search(corpus, queries, top_k, ...) -> results`` and computes
NDCG@k / MAP@k / Recall@k / P@k (plus the custom metrics) over qrels.

The port's own copy of ``chamjax/ir/evaluation.py``, which imports no
framework: the same code, so results equal the JAX package's to the last bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from chamjax_torch.ir import metrics as M


class EvaluateRetrieval:
    def __init__(self, retriever=None, k_values: Optional[List[int]] = None,
                 score_function: str = "cos_sim"):
        self.retriever = retriever
        self.k_values = k_values or [1, 3, 5, 10, 100]
        self.top_k = max(self.k_values)
        self.score_function = score_function

    def retrieve(self, corpus, queries, **kwargs) -> Dict[str, Dict[str, float]]:
        assert self.retriever is not None, "no retriever set"
        return self.retriever.search(corpus, queries, self.top_k,
                                     score_function=self.score_function,
                                     **kwargs)

    def rerank(self, corpus, queries, results, top_k: int
               ) -> Dict[str, Dict[str, float]]:
        assert self.retriever is not None
        return self.retriever.rerank(corpus, queries, results, top_k)

    @staticmethod
    def evaluate(qrels, results, k_values
                 ) -> Tuple[Dict[str, float], Dict[str, float],
                            Dict[str, float], Dict[str, float]]:
        """Returns (ndcg, map, recall, precision) dicts keyed like BEIR:
        ``{"NDCG@10": ..}, {"MAP@10": ..}, {"Recall@10": ..}, {"P@10": ..}``."""
        ndcg = {f"NDCG@{k}": round(M.ndcg_at_k(qrels, results, k), 5)
                for k in k_values}
        _map = {f"MAP@{k}": round(M.map_at_k(qrels, results, k), 5)
                for k in k_values}
        recall = {f"Recall@{k}": round(M.recall_at_k(qrels, results, k), 5)
                  for k in k_values}
        precision = {f"P@{k}": round(M.precision_at_k(qrels, results, k), 5)
                     for k in k_values}
        return ndcg, _map, recall, precision

    @staticmethod
    def evaluate_custom(qrels, results, k_values, metric: str
                        ) -> Dict[str, float]:
        """Custom metrics by name (reference ``custom_metrics.py``):
        mrr | recall_cap | hole | top_k_accuracy."""
        fns = {
            "mrr": ("MRR", M.mrr_at_k),
            "recall_cap": ("R_cap", M.recall_cap_at_k),
            "hole": ("Hole", M.hole_at_k),
            "top_k_accuracy": ("Accuracy", M.top_k_accuracy),
        }
        name, fn = fns[metric]
        return {f"{name}@{k}": round(fn(qrels, results, k), 5)
                for k in k_values}
