"""Probabilistic sizing of partial top-k buffers (the port's copy of
``chamjax/index/sizing.py``: pure numpy, the same values).

TPU analogue of the reference's L1 priority-queue sizing model
(``python_probablistic_priority_queue/probablistic_priority_queue.py:11-60``):
there, top-k results spread over 2N truncated hardware queues and a binomial
argument bounds the shortened queue length; here, the scan is split over
``n_parts`` partitions (mesh list-shards, probe chunks, Pallas tiles) and each
partition keeps only ``k_part`` candidates before the global merge
(`jax.lax.top_k` — the L2 queue equivalent).

Model: assuming the global top-k items land in partitions uniformly at
random, the count in one partition is Binomial(k, 1/n_parts).  By union
bound, P(any partition overflows k_part) <= n_parts · P(B > k_part).
``partial_k`` returns the smallest k_part with that bound < ``p_fail``.

Also sizes ``approx_min_k`` recall targets and scan-length truncation from a
list-length histogram.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def _binom_pmf_ln(k: int, n: int, p: float) -> float:
    """log PMF of Binomial(n, p) at k."""
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
            + k * math.log(p) + (n - k) * math.log1p(-p))


def binom_tail(n: int, p: float, kmax: int) -> float:
    """P(Binomial(n, p) > kmax), exact summation."""
    if kmax >= n:
        return 0.0
    return float(sum(math.exp(_binom_pmf_ln(i, n, p))
                     for i in range(kmax + 1, n + 1)))


def overflow_probability(k: int, n_parts: int, k_part: int) -> float:
    """Union-bound P(some partition holds more than k_part of the top-k)."""
    if k_part >= k:
        return 0.0
    return min(1.0, n_parts * binom_tail(k, 1.0 / n_parts, k_part))


def partial_k(k: int, n_parts: int, p_fail: float = 1e-4) -> int:
    """Smallest per-partition candidate count with overflow prob < p_fail.

    Matches the reference's table shape (``constants.hpp:22-31``): e.g.
    k=100 over 32 partitions needs ~15 per partition, not 100 — a 6.7x
    reduction in merge traffic, same argument as the FPGA's shortened L1
    queues.
    """
    if n_parts <= 1:
        return k
    for k_part in range(1, k + 1):
        if overflow_probability(k, n_parts, k_part) < p_fail:
            return k_part
    return k


def expected_recall_loss(k: int, n_parts: int, k_part: int) -> float:
    """Expected fraction of the top-k lost to truncation:
    E[sum over partitions of max(0, B - k_part)] / k."""
    p = 1.0 / n_parts
    loss = 0.0
    for i in range(k_part + 1, k + 1):
        loss += (i - k_part) * math.exp(_binom_pmf_ln(i, k, p))
    return n_parts * loss / k


def scan_len_for_quantile(list_sizes: Sequence[int], nprobe: int,
                          quantile: float = 0.999, pad: int = 128) -> int:
    """Static scan length covering `quantile` of probed-list mass.

    The fixed-shape scan truncates lists longer than scan_len; choosing the
    (probe-weighted) quantile of the list-size distribution bounds the
    truncated mass.  Padded up to a tile multiple.  The dynamic-shape
    analogue in the reference is the per-cell iteration table
    (``DRAM_utils.hpp:45-102``)."""
    sizes = np.asarray(list_sizes)
    q = float(np.quantile(sizes, quantile)) if sizes.size else pad
    return int(math.ceil(max(q, 1) / pad) * pad)


def truncated_mass(list_sizes: Sequence[int], scan_len: int) -> float:
    """Fraction of database rows beyond scan_len (upper bound on recall loss
    from truncation, before accounting for rank)."""
    sizes = np.asarray(list_sizes, dtype=np.float64)
    total = sizes.sum()
    if total == 0:
        return 0.0
    return float(np.maximum(sizes - scan_len, 0).sum() / total)


def lane_l1_loss(k: int, windows: int, lanes: int = 128) -> float:
    """Expected fraction of the true top-k lost to in-kernel lane-L1
    bucketing (``SearchConfig.lane_l1``).

    The kernel keeps one winner per (window, lane) bucket; a true top-k
    row is lost iff a *better* top-k row lands in its bucket.  With top-k
    rows spread uniformly over ``B = windows·lanes`` buckets (they come
    from different database rows, so bucket assignment is effectively
    random), the expected number of losing rows is
    ``Σ_{j<k} j/B = C(k,2)/B`` — the same binomial-collision argument the
    FPGA's shortened L1 queues are sized by
    (``python_probablistic_priority_queue/probablistic_priority_queue.py``).
    Returned as a fraction of k."""
    buckets = windows * lanes
    if buckets <= 0:
        return 1.0
    return min(1.0, (k * (k - 1) / 2.0) / buckets / k)
