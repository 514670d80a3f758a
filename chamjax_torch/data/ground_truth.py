"""Exact k-NN ground truth: chunked fp32 matmul plus a running top-k merge
(the port of ``chamjax/data/ground_truth.py``)."""

from __future__ import annotations

import numpy as np
import torch

from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul


@fp32_matmul()
def compute_ground_truth(
    xb,
    xq,
    k: int = 100,
    chunk: int = 1_000_000,
    query_chunk: int = 4096,
    device=None,
):
    """Exact squared-L2 top-k over the full database.

    Returns ``(ids (nq, k) int64, dists (nq, k) float32)`` with true squared
    distances (the per-query ``||q||²`` term added back).
    """
    dev = resolve_device(device)
    nq = xq.shape[0]
    all_ids, all_d = [], []
    for q0 in range(0, nq, query_chunk):
        q = as_f32(xq[q0:q0 + query_chunk], dev)
        best_d = best_i = None
        for b0 in range(0, xb.shape[0], chunk):
            db = as_f32(xb[b0:b0 + chunk], dev)
            # ||q||² omitted inside the loop (rank-invariant per query)
            d = (torch.sum(db * db, dim=1)[None, :]
                 - 2.0 * torch.matmul(q, db.T))
            cd, ci = torch.topk(d, min(k, db.shape[0]), dim=1,
                                largest=False, sorted=True)
            ci = ci + b0
            if best_d is None:
                best_d, best_i = cd, ci
            else:
                md = torch.cat([best_d, cd], dim=1)
                mi = torch.cat([best_i, ci], dim=1)
                best_d, pos = torch.topk(md, k, dim=1, largest=False,
                                         sorted=True)
                best_i = torch.gather(mi, 1, pos)
        qn = torch.sum(q * q, dim=1, keepdim=True)
        all_d.append((best_d + qn).cpu().numpy())
        all_ids.append(best_i.cpu().numpy().astype(np.int64))
    return np.concatenate(all_ids, 0), np.concatenate(all_d, 0)
