"""IVF coarse scan: one fp32 matmul + top-k over the centroid table (the
port of ``chamjax/ops/coarse.py``).

The JAX package may select probes with ``approx_max_k``; the port always
selects exactly with ``torch.topk`` (what JAX itself does off the TPU), so
``use_approx`` and the two-stage shortlist keep their contracts and never
lose a probe.
"""

from __future__ import annotations

from typing import Tuple

import torch

from chamjax_torch.utils.precision import fp32_matmul


def _scores(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    cn = torch.sum(centroids * centroids, dim=1)
    return 2.0 * torch.matmul(queries, centroids.T) - cn[None, :]  # ||q||²-d²


@fp32_matmul()
def coarse_scan(
    queries: torch.Tensor,      # (b, d) float32
    centroids: torch.Tensor,    # (nlist, d) float32
    nprobe: int,
    use_approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(list_ids (b, nprobe) int32, dists (b, nprobe) float32)``,
    nearest-first.  Distances are true squared L2.  ``use_approx`` is
    accepted for the JAX package's contract; selection is exact."""
    top, idx = torch.topk(_scores(queries, centroids), nprobe, dim=1,
                          largest=True, sorted=True)
    qn = torch.sum(queries * queries, dim=1, keepdim=True)
    return idx.to(torch.int32), qn - top


@fp32_matmul()
def coarse_scan_2stage(
    queries: torch.Tensor,
    centroids: torch.Tensor,
    nprobe: int,
    cand: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage coarse scan: a ``cand``-wide shortlist, then an exact
    re-sort — the same contract as :func:`coarse_scan`.  The shortlist is
    exact here, so the result equals the exact scan's."""
    assert nprobe <= cand <= centroids.shape[0], (nprobe, cand)
    vals, short = torch.topk(_scores(queries, centroids), cand, dim=1,
                             largest=True, sorted=False)
    top, order = torch.topk(vals, nprobe, dim=1, largest=True, sorted=True)
    idx = torch.gather(short, 1, order)
    qn = torch.sum(queries * queries, dim=1, keepdim=True)
    return idx.to(torch.int32), qn - top


def select_probes(
    queries: torch.Tensor,
    centroids: torch.Tensor,
    nprobe: int,
    coarse_cand: int = 0,
    use_approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe-selection dispatch: ``coarse_cand`` > 0 → two-stage scan
    with the width clamped to [nprobe, nlist]; else :func:`coarse_scan`."""
    if coarse_cand > 0:
        cand = min(max(coarse_cand, nprobe), centroids.shape[0])
        return coarse_scan_2stage(queries, centroids, nprobe, cand=cand)
    return coarse_scan(queries, centroids, nprobe, use_approx=use_approx)
