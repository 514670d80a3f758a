"""Recall metrics (numpy copy of ``chamjax/eval/recall.py``).

``R@k``: fraction of queries whose true nearest neighbour (gt column 0)
appears in the top-k returned ids; ``mode="intersection"`` gives the
set-overlap variant.
"""

from __future__ import annotations

import numpy as np


def recall_at_k(
    ids: np.ndarray,          # (nq, >=k) returned neighbour ids
    gt: np.ndarray,           # (nq, >=1) ground-truth ids (nearest first)
    k: int,
    mode: str = "nn",
) -> float:
    ids_k = ids[:, :k]
    if mode == "nn":
        return float(np.mean((ids_k == gt[:, :1]).any(axis=1)))
    if mode == "intersection":
        nq = ids.shape[0]
        inter = sum(
            len(np.intersect1d(ids_k[i], gt[i, :k])) for i in range(nq)
        )
        return inter / (nq * k)
    raise ValueError(mode)
