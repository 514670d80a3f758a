"""Synthetic corpora: the port's copy of ``chamjax/data/datasets.py``'s
``Dataset`` and ``synthetic_dataset``.

Pure numpy with the same draws in the same order, so both packages build
bit-identical corpora from the same arguments.  The fvecs/bin file readers
wait for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Dataset:
    name: str
    xb: np.ndarray        # (nb, d) float32 — database vectors
    xq: np.ndarray        # (nq, d) float32 — query vectors
    xt: np.ndarray        # (nt, d) float32 — training vectors
    gt: Optional[np.ndarray] = None   # (nq, k) int — ground-truth neighbour ids

    @property
    def d(self) -> int:
        return self.xb.shape[1]

    @property
    def nb(self) -> int:
        return self.xb.shape[0]


def synthetic_dataset(
    name: str = "SYN",
    nb: int = 100_000,
    nq: int = 1000,
    nt: int = 50_000,
    d: int = 128,
    seed: int = 0,
    n_clusters: int = 0,
    rank: Optional[int] = None,
    spectrum_tau: float = 0.0,
) -> Dataset:
    """Deterministic synthetic dataset.

    ``n_clusters > 0`` draws vectors around cluster centers near a rank-
    ``rank`` (default d//4) manifold, so IVF and PQ recall curves are
    meaningful; ``0`` gives iid normal vectors.  ``spectrum_tau > 0`` makes
    the within-cluster spectrum decay as ``exp(-j / tau)``.
    """
    rng = np.random.default_rng(seed)
    if n_clusters > 0:
        rank = rank or max(4, d // 4)
        centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 4.0
        proj = rng.standard_normal((rank, d)).astype(np.float32) / np.sqrt(rank)
        if spectrum_tau > 0:
            lam = np.exp(-np.arange(rank, dtype=np.float32) / spectrum_tau)
            lam *= np.sqrt(rank / np.sum(lam * lam))
            proj = proj * lam[:, None]

        def draw(n, salt):
            r = np.random.default_rng(seed + salt)
            asg = r.integers(0, n_clusters, size=n)
            z = r.standard_normal((n, rank)).astype(np.float32)
            noise = r.standard_normal((n, d)).astype(np.float32) * 0.05
            return (centers[asg] + z @ proj + noise).astype(np.float32)

        xb, xt, xq = draw(nb, 1), draw(nt, 2), draw(nq, 3)
    else:
        xb = rng.standard_normal((nb, d)).astype(np.float32)
        xt = rng.standard_normal((nt, d)).astype(np.float32)
        xq = rng.standard_normal((nq, d)).astype(np.float32)
    return Dataset(name=name, xb=xb, xq=xq, xt=xt)
