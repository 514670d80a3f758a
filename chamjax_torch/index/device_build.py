"""Device-resident IVF-PQ build for corpora larger than the host can feed
(the port of ``chamjax/index/device_build.py``).

``build_ivfpq_device`` streams deterministic corpus chunks from a
``draw(start, count)`` function and trains, assigns, encodes and packs on
the device, so the corpus never exists whole on the host or on the card;
the result is a ``DeviceIVF`` whose arrays are born on the device.

Assignment is two-stage: a low-precision candidate GEMM → top-``cand``
shortlist → exact fp32 re-rank.  On a card stage 1 is a bf16 GEMM with fp32
accumulation and output (the TPU's default precision, which the JAX package
leaves stage 1 at); on the CPU it is fp32, as JAX's default is there, so
CPU results can be compared for equality.  Stage 2 and every distance that
ranks run in fp32 with TF32 off.  JAX's ``approx_max_k`` becomes an exact
``torch.topk``; ``lax.scan`` over blocks becomes a Python loop.

Differences from the JAX package, kept on purpose:

- ``.at[].add`` is ``index_add_``, an atomic add on a card: centroids and
  k-means statistics are not bit-reproducible from run to run there (they
  are on the CPU).
- Every ``argsort`` is stable, as ``jnp.argsort`` is; ``lax.sort`` on
  (cell, dist) keys is a stable sort by dist, then a stable sort by cell.
- The stage profile (``CHAMJAX_BUILD_PROFILE=1``, synchronising the device
  after each stage) also times training and the pack, for both the
  balanced and the unbalanced path.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from chamjax_torch.config import IndexConfig
from chamjax_torch import random as jr
from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul

DrawFn = Callable[[int, int], torch.Tensor]   # (start, count) -> (count, d)


# ---------------------------------------------------------------------------
# two-stage exact assignment
# ---------------------------------------------------------------------------

def _stage1_scores(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """``2 x·c - ||c||²`` (b, nlist) f32: bf16 operands with fp32
    accumulation on a card, fp32 on the CPU."""
    cn = torch.sum(cent * cent, dim=1)
    if x.device.type == "cuda":
        s = torch.mm(x.to(torch.bfloat16), cent.to(torch.bfloat16).T,
                     out_dtype=torch.float32)
    else:
        s = torch.mm(x, cent.T)
    return s.mul_(2.0).sub_(cn[None, :])


def _exact_partial(x: torch.Tensor, cent: torch.Tensor, top: torch.Tensor
                   ) -> torch.Tensor:
    """``||c||² - 2 x·c`` (fp32) over the shortlisted cells ``top``."""
    cc = cent[top]                                        # (b, w, d)
    return (torch.sum(cc * cc, dim=2)
            - 2.0 * torch.bmm(cc, x[:, :, None])[:, :, 0])


def _assign_exact_2stage(x: torch.Tensor, cent: torch.Tensor, cand: int
                         ) -> torch.Tensor:
    """argmin_c ||x - cent_c||² via a low-precision shortlist + fp32
    re-rank.  x: (b, d) f32; cent: (nlist, d) f32 → (b,) int64."""
    _, top = torch.topk(_stage1_scores(x, cent), min(cand, cent.shape[0]),
                        dim=1)
    best = torch.argmin(_exact_partial(x, cent, top), dim=1)
    return top.gather(1, best[:, None])[:, 0]


def _topc_exact_2stage(x: torch.Tensor, cent: torch.Tensor, c: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``c`` nearest cells + exact squared distances per row, nearest
    first: ``(cells (b, c) int32, d2 (b, c) f32)`` with the ||x||² term
    (the eviction rounds compare different points' distances to a cell).
    The shortlist is 2c wide so the exact top-c survives bf16 flips."""
    _, top = torch.topk(_stage1_scores(x, cent),
                        min(2 * c, cent.shape[0]), dim=1)
    best_d, best = torch.topk(-_exact_partial(x, cent, top), c, dim=1)
    cells = top.gather(1, best).to(torch.int32)
    xn = torch.sum(x * x, dim=1, keepdim=True)
    return cells, xn - best_d


def _blocks(n: int, block: int):
    return [(s, min(block, n - s)) for s in range(0, n, block)]


@fp32_matmul()
def _assign_blocked(x: torch.Tensor, cent: torch.Tensor, block: int,
                    cand: int) -> torch.Tensor:
    """Blocked two-stage assignment: (n, d) → (n,) int32, never holding
    more than a (block, nlist) score matrix; the n % block tail included."""
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    for s, c in _blocks(x.shape[0], block):
        out[s:s + c] = _assign_exact_2stage(x[s:s + c], cent, cand)
    return out


@fp32_matmul()
def _topc_blocked(x: torch.Tensor, cent: torch.Tensor, block: int, c: int):
    """Blocked ``_topc_exact_2stage``: (n, d) → ((n, c) int32, (n, c) f32)."""
    n = x.shape[0]
    cells = torch.empty((n, c), dtype=torch.int32, device=x.device)
    d2 = torch.empty((n, c), dtype=torch.float32, device=x.device)
    for s, b in _blocks(n, block):
        cells[s:s + b], d2[s:s + b] = _topc_exact_2stage(x[s:s + b], cent, c)
    return cells, d2


# ---------------------------------------------------------------------------
# device Lloyd (training sample resident on the device)
# ---------------------------------------------------------------------------

def _counts(a: torch.Tensor, k: int) -> torch.Tensor:
    out = torch.zeros((k,), dtype=torch.float32, device=a.device)
    return out.index_add_(0, a.long(), torch.ones(a.shape[0],
                                                  device=a.device))


@fp32_matmul()
def _lloyd_iter(xb: torch.Tensor, cent: torch.Tensor, key: jr.Key,
                block: int, cand: int):
    """One Lloyd iteration over every row (the n % block tail included):
    mean update, then empty cells reseeded at the heaviest cells'
    centroids plus a jitter ``normal(key)``.  Returns (centroids,
    counts)."""
    k, d = cent.shape
    a = _assign_blocked(xb, cent, block=block, cand=cand).long()
    sums = torch.zeros((k, d), dtype=torch.float32,
                       device=xb.device).index_add_(0, a, xb)
    counts = _counts(a, k)
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts, min=1.0)[:, None], cent)
    empty = counts <= 0
    heavy = torch.argsort(-counts, stable=True)
    rank = torch.cumsum(empty.long(), 0) - 1            # index among empties
    donor = heavy[rank % k]
    scale = torch.mean(torch.abs(new[donor]), dim=1,
                       keepdim=True) * 1e-3 + 1e-6
    jitter = jr.normal(key, (k, d), device=xb.device) * scale
    new = torch.where(empty[:, None], new[donor] + jitter, new)
    return new, counts


def _lexsort_cell_dist(cell: torch.Tensor, dist: torch.Tensor
                       ) -> torch.Tensor:
    """Permutation sorting by (cell, dist), ties by position: the JAX
    package's ``lax.sort((cell, dist, iota), num_keys=2)``."""
    o = torch.argsort(dist, stable=True)
    return o[torch.argsort(cell[o], stable=True)]


@fp32_matmul()
def _update_from_assignment(x: torch.Tensor, a: torch.Tensor,
                            nat: torch.Tensor, cent: torch.Tensor, key,
                            cap, split, deadband):
    """Centroid update for a GIVEN assignment — the balanced-Lloyd step.

    Means from the capacity-constrained assignment ``a``; with ``split``
    truthy, cells whose NATURAL demand (``nat`` counts) exceeds
    ``cap · deadband`` get ``ceil(nat_count/cap) - 1`` extra centroids,
    respawned from the lightest cells (natural demand < cap/2) AT MEMBER
    POINTS of the donor spread over its distance-sorted run; empty cells
    beyond the budget take the heavy-donor reseed.  ``key`` is unused, as
    in the JAX package.  Returns (centroids, counts)."""
    del key
    dev = x.device
    k, d = cent.shape
    f32 = dict(dtype=torch.float32, device=dev)
    cap = torch.as_tensor(cap, **f32)
    split = torch.as_tensor(split, **f32)
    deadband = torch.as_tensor(deadband, **f32)
    a, nat = a.long(), nat.long()
    sums = torch.zeros((k, d), **f32).index_add_(0, a, x)
    counts = _counts(a, k)
    nat_counts = _counts(nat, k)
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts, min=1.0)[:, None], cent)
    empty = counts <= 0
    cap = torch.clamp(cap, min=1.0)
    zero = torch.zeros((), **f32)
    needed = torch.where(nat_counts > cap * deadband,
                         torch.ceil(nat_counts / cap) - 1.0, zero) * split
    n_seeds = torch.minimum(torch.sum(needed),
                            torch.tensor(float(max(k // 8, 1)), **f32))
    light = nat_counts < cap * 0.5
    victim_key = torch.where(light, nat_counts,
                             torch.tensor(float("inf"), **f32))
    order = torch.argsort(victim_key, stable=True)
    inv = torch.empty((k,), dtype=torch.int64, device=dev)
    inv[order] = torch.arange(k, device=dev)            # eligibility rank
    n_seeds = torch.minimum(n_seeds, torch.sum(light).to(torch.float32))
    rank_f = inv.to(torch.float32)
    seeding = rank_f < n_seeds
    is_victim = seeding | empty
    heavy = torch.argsort(-nat_counts, stable=True)
    cum = torch.cumsum(needed[heavy], 0)
    pos = torch.clamp(torch.searchsorted(cum, rank_f, right=True),
                      max=k - 1)
    seed_donor = heavy[pos]
    erank = torch.cumsum(empty.long(), 0) - 1           # legacy reseed
    legacy_donor = heavy[erank % k]
    donor = torch.where(seeding, seed_donor, legacy_donor)
    n = x.shape[0]
    dist2 = torch.sum((x - cent[nat]) ** 2, dim=1)
    sidx = _lexsort_cell_dist(nat, dist2)               # members grouped
    run_start = torch.full((k,), n - 1, dtype=torch.int64, device=dev)
    run_start.scatter_reduce_(0, nat[sidx], torch.arange(n, device=dev),
                              "amin", include_self=True)
    c_donor = nat_counts[donor]
    cum_prev = torch.where(pos > 0, cum[torch.clamp(pos - 1, min=0)], zero)
    s_within = torch.where(seeding, rank_f - cum_prev,
                           (erank % k).to(torch.float32))
    denom = torch.where(seeding, needed[donor] + 1.0,
                        torch.clamp(c_donor, min=1.0))
    off = torch.floor((s_within + 1.0) * c_donor
                      / torch.clamp(denom, min=1.0))
    off = torch.minimum(torch.clamp(off, min=0.0),
                        torch.clamp(c_donor - 1.0, min=0.0)).long()
    seed_point = x[sidx[torch.clamp(run_start[donor] + off, 0, n - 1)]]
    return torch.where(is_victim[:, None], seed_point, new), counts


@fp32_matmul()
def lloyd_device(x: torch.Tensor, k: int, iters: int = 10, seed: int = 0,
                 block: int = 4096, cand: int = 8, init: str = "auto",
                 init_sample: int = 1 << 17,
                 balance_cap: int = 0, balance_iters: int = 0,
                 balance_cand: int = 16, balance_deadband: float = 1.75,
                 verbose: bool = False) -> torch.Tensor:
    """Lloyd k-means on ``x``'s device; centroids never visit the host.

    ``init``: ``"kmeans++"`` (on a subsample of ``init_sample`` rows),
    ``"random"`` (distinct sample rows) or ``"auto"`` (k-means++ up to
    4096 cells).  ``balance_cap > 0`` appends ``balance_iters`` balanced
    iterations: a capacity-constrained assignment
    (``rebalance_assignment_device`` over the top-``balance_cand`` cells)
    before each centroid update, heavy cells split at the source.
    Returns (k, d) f32 on the device."""
    from chamjax_torch.index.kmeans import _kmeanspp_init

    n = x.shape[0]
    if n < k:
        raise ValueError(f"lloyd_device: {n} rows < {k} clusters")
    dev = x.device
    key = jr.key(seed)
    if init == "auto":
        init = "kmeans++" if k <= 4096 else "random"
    if init == "kmeans++":
        sample = x if n <= init_sample else x[
            jr.permutation(key, n, device=dev)[:init_sample]]
        cent = _kmeanspp_init(sample, k, key)
    else:
        cent = x[jr.permutation(key, n, device=dev)[:k]]
    for it in range(iters):
        cent, counts = _lloyd_iter(x, cent, jr.fold_in(key, it),
                                   block=block, cand=cand)
        if verbose:
            nz = int(torch.sum(counts > 0))
            print(f"[lloyd] iter {it}: nonempty {nz}/{k}", flush=True)
    if balance_cap and balance_iters:
        for it in range(balance_iters):
            cells, d2 = _topc_blocked(x, cent, block=block, c=balance_cand)
            a = rebalance_assignment_device(cells, d2, balance_cap,
                                            nlist=k, hard=True, warn=False)
            nat = cells[:, 0]
            del cells, d2
            # last iteration: no split-reseed — end on an assignment-
            # validated centroid state, not freshly respawned twins
            split = float(it < balance_iters - 1)
            cent, counts = _update_from_assignment(
                x, a, nat, cent, jr.fold_in(key, 1000 + it),
                float(balance_cap), split, float(balance_deadband))
            if verbose:
                mx = int(torch.max(counts))
                print(f"[lloyd] balance iter {it}: max cell {mx} "
                      f"(cap {balance_cap})", flush=True)
    return cent


# ---------------------------------------------------------------------------
# device-native capacity-balanced assignment
# ---------------------------------------------------------------------------

def _claims(r, cand, cd):
    rr = r.long()[:, None]
    return cand.gather(1, rr)[:, 0].long(), cd.gather(1, rr)[:, 0]


def _runs(sa: torch.Tensor) -> torch.Tensor:
    """Position of each sorted element within its run of equal cells."""
    n = sa.shape[0]
    iota = torch.arange(n, device=sa.device)
    boundary = torch.ones((n,), dtype=torch.bool, device=sa.device)
    boundary[1:] = sa[1:] != sa[:-1]
    run_start = torch.cummax(torch.where(boundary, iota, 0), 0).values
    return iota - run_start


def _rebalance_round(r: torch.Tensor, cand: torch.Tensor, cd: torch.Tensor,
                     cap: torch.Tensor):
    """One keep-cap-best eviction round with τ-threshold skipping: every
    point claims its rank-``r`` candidate, each cell keeps its ``cap``
    nearest claimants (one (cell, dist) sort), and an evicted point jumps
    to its first later candidate whose cell's cap-th-best distance τ does
    not already reject it.  Returns ``(r', moved, overflow)`` as 0-d
    device tensors."""
    n, c = cand.shape
    nlist = cap.shape[0]
    a, d = _claims(r, cand, cd)
    sidx = _lexsort_cell_dist(a, d)
    sa, sd = a[sidx], d[sidx]
    pos_in_run = _runs(sa)
    cap_s = cap.long()[sa]
    evict = torch.zeros((n,), dtype=torch.bool, device=r.device)
    evict[sidx] = pos_in_run >= cap_s
    inf = torch.tensor(float("inf"), dtype=cd.dtype, device=cd.device)
    tau = torch.full((nlist,), float("inf"), dtype=cd.dtype,
                     device=cd.device)
    tau.scatter_reduce_(0, sa, torch.where(pos_in_run == cap_s - 1, sd, inf),
                        "amin", include_self=True)
    tau = torch.where(cap <= 0, -inf, tau)
    can_move = evict & (r < c - 1)
    # first later candidate τ does not certainly reject, with (n,)-shaped
    # ops only (no (n, c) temporary)
    first_ok = torch.full((n,), c - 1, dtype=r.dtype, device=r.device)
    has = torch.zeros((n,), dtype=torch.bool, device=r.device)
    for j in range(c - 1, 0, -1):      # keep the LOWEST qualifying j
        okj = (cd[:, j] <= tau[cand[:, j].long()]) & (j > r)
        first_ok = torch.where(okj, j, first_ok)
        has = has | okj
    r_new = torch.where(can_move, torch.where(has, first_ok, c - 1), r)
    return r_new, torch.sum(can_move & (r_new != r)), torch.sum(evict)


def _evicted_mask(r: torch.Tensor, cand: torch.Tensor, cd: torch.Tensor,
                  cap: torch.Tensor) -> torch.Tensor:
    """The fixpoint's evicted set (the straggler fallback's selection)."""
    a, d = _claims(r, cand, cd)
    sidx = _lexsort_cell_dist(a, d)
    out = torch.zeros((cand.shape[0],), dtype=torch.bool, device=r.device)
    out[sidx] = _runs(a[sidx]) >= cap.long()[a[sidx]]
    return out


def rebalance_assignment_device(
    cand: torch.Tensor,       # (n, c) int32 — nearest-first candidate cells
    cd: torch.Tensor,         # (n, c) f32 — exact ||x - cent||² per cell
    cap,                      # int scalar or (nlist,) per-cell capacities
    *,
    nlist: Optional[int] = None,
    hard: bool = True,
    max_rounds: int = 32,
    warn: bool = True,
    verbose: bool = False,
    return_stats: bool = False,
):
    """Capacity-balanced assignment from a candidate table, on the device:
    parallel eviction rounds (every point claims its best not-yet-refused
    candidate, full cells keep their ``cap`` nearest claimants) until no
    point moves, or fewer than n·1e-5 move after round 2 (one host read a
    round).  ``cap`` may be per cell (the part-split path's remaining
    capacities).  Stragglers, refused by all ``c`` candidates, go to their
    NEAREST cell; ``hard`` mode warns that the cap was not met.  Returns
    the (n,) int32 assignment, and with ``return_stats`` the overflow
    count."""
    n, c = cand.shape
    cap_desc = "per-cell"
    if np.ndim(cap) == 0:
        cap_desc = str(int(cap))
        if nlist is None:
            nlist = int(torch.max(cand)) + 1
        cap = torch.full((nlist,), int(cap), dtype=torch.int32,
                         device=cand.device)
    else:
        cap = torch.as_tensor(cap, dtype=torch.int32, device=cand.device)
    r = torch.zeros((n,), dtype=torch.int32, device=cand.device)
    overflow = 0
    thr = int(n * 1e-5)     # tail cutoff: a round costs a full-table sort
    for rnd in range(max_rounds):
        r, moved, overflow = _rebalance_round(r, cand, cd, cap)
        moved, overflow = int(moved), int(overflow)
        if verbose:
            print(f"[rebalance] round {rnd}: moved {moved} "
                  f"overflow {overflow}", flush=True)
        if moved == 0 or (moved < thr and rnd >= 2):
            break
    a = cand.gather(1, r.long()[:, None])[:, 0]
    if overflow:
        if hard and warn:
            warnings.warn(
                f"rebalance_assignment_device: {overflow}/{n} points "
                f"exhausted all {c} candidate cells — the cap ({cap_desc}) "
                f"binds against natural cluster sizes; those cells exceed "
                f"the cap and auto_windows' worst-query bound will not "
                f"fully collapse. Raise balance_factor, nlist, or cand — "
                f"or train with balanced Lloyd iterations (lloyd_device "
                f"balance_cap), which removes the heavy cells at the "
                f"source.", stacklevel=2)
        a = torch.where(_evicted_mask(r, cand, cd, cap), cand[:, 0], a)
    a = a.to(torch.int32)
    return (a, overflow) if return_stats else a


# ---------------------------------------------------------------------------
# streamed assign + PQ encode
# ---------------------------------------------------------------------------

def _encode(x: torch.Tensor, a: torch.Tensor, cent: torch.Tensor,
            cbooks: torch.Tensor, by_residual: bool) -> torch.Tensor:
    from chamjax_torch.index.pq import pq_encode_tensor
    v = x - cent[a.long()] if by_residual else x
    return pq_encode_tensor(v, cbooks)


@fp32_matmul()
def _assign_encode_chunk(x: torch.Tensor, cent: torch.Tensor,
                         cbooks: torch.Tensor, block: int, cand: int,
                         by_residual: bool):
    """x: (C, d) → (assignment (C,) int32, codes (C, m) uint8)."""
    a = _assign_blocked(x, cent, block=block, cand=cand)
    return a, _encode(x, a, cent, cbooks, by_residual)


@fp32_matmul()
def _encode_assigned_chunk(x: torch.Tensor, a: torch.Tensor,
                           cent: torch.Tensor, cbooks: torch.Tensor,
                           block: int, by_residual: bool) -> torch.Tensor:
    """PQ-encode against a FIXED assignment (the balanced two-pass path):
    x (C, d), a (C,) → codes (C, m) uint8.  ``block`` is the JAX package's
    scan block; ``pq_encode_tensor`` chunks on its own."""
    del block
    return _encode(x, a, cent, cbooks, by_residual)


# ---------------------------------------------------------------------------
# device packing (CSR layout with per-list padding, computed on the device)
# ---------------------------------------------------------------------------

def _exclusive_cumsum(v: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(v)
    out[1:] = torch.cumsum(v, 0)[:-1]
    return out


def _pack_layout_core(order: torch.Tensor, list_len: torch.Tensor,
                      src_start: torch.Tensor, own: torch.Tensor,
                      list_pad: int, cap: int):
    """Gather map into a padded CSR layout covering the ``own``-masked
    lists (others collapse to zero width).  Owned lists pad to
    ``list_pad`` multiples (min one block); the boundary mark + cumsum
    resolves each slot's list.  Returns (gather_ids (cap,) int32 with -1
    on padding, list_start int32, list_len int32)."""
    dev = order.device
    n = order.shape[0]
    eff = torch.where(own, list_len, 0).long()
    padded = torch.where(
        own, torch.clamp((eff + list_pad - 1) // list_pad * list_pad,
                         min=list_pad), 0)
    list_start = _exclusive_cumsum(padded)
    # a start at/after cap (JAX drops that update) adds nothing
    mark = torch.zeros((cap,), dtype=torch.int64, device=dev)
    mark.index_add_(0, torch.clamp(list_start, max=cap - 1),
                    (list_start < cap).long())
    list_of = torch.cumsum(mark, 0) - 1
    offset = torch.arange(cap, device=dev) - list_start[list_of]
    valid = offset < eff[list_of]
    src = torch.clamp(src_start.long()[list_of] + offset, 0, n - 1)
    gather_ids = torch.where(valid, order[src].to(torch.int32), -1)
    return (gather_ids.to(torch.int32), list_start.to(torch.int32),
            eff.to(torch.int32))


def _pack_layout(assignment: torch.Tensor, nlist: int, list_pad: int,
                 cap: int):
    """Sorted order + gather map into the padded CSR layout (the host
    ``_pack_lists``'s invariants, with the static capacity ``cap``)."""
    order = torch.argsort(assignment, stable=True)
    list_len = torch.bincount(assignment.long(), minlength=nlist)
    src_start = _exclusive_cumsum(list_len)
    own = torch.ones((nlist,), dtype=torch.bool, device=assignment.device)
    return _pack_layout_core(order, list_len, src_start, own,
                             list_pad=list_pad, cap=cap)


def _gather_rows(codes: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """(c, m) rows ``codes[gidx]``, zero where ``gidx`` is -1."""
    rows = codes[torch.clamp(gidx, min=0).long()]
    return torch.where(gidx[:, None] >= 0, rows, 0).to(torch.uint8)


def _pack_codes_t_oneshot(codes: torch.Tensor, gather_ids: torch.Tensor
                          ) -> torch.Tensor:
    return _gather_rows(codes, gather_ids).T.contiguous()


def _pack_codes_t_chunk(acc: torch.Tensor, codes: torch.Tensor,
                        gidx: torch.Tensor, start: int) -> torch.Tensor:
    acc[:, start:start + gidx.shape[0]] = _gather_rows(codes, gidx).T
    return acc


# Above this many packed bytes, gather in column chunks into one
# accumulator: the one-shot pack's live set is codes + the (cap, m) gather
# + its (m, cap) transpose (~3× the corpus); the chunked peak is codes +
# the accumulator + one chunk.
_PACK_CHUNK_BYTES = 1 << 30
_PACK_CHUNK_COLS = 1 << 24
# the tiled pack's step, in bytes of packed codes
_PACK_TILED_BYTES = 256 << 20


def _pack_codes_tiled_chunk(acc: torch.Tensor, codes: torch.Tensor,
                            gidx: torch.Tensor, tile0: int, seg: int
                            ) -> torch.Tensor:
    part = _gather_rows(codes, gidx).T                    # (m, c)
    m = part.shape[0]
    part = part.reshape(m, part.shape[1] // seg, seg).permute(1, 0, 2)
    acc[tile0:tile0 + part.shape[0]] = part
    return acc


def _pack_codes_tiled(codes: torch.Tensor, gather_ids: torch.Tensor,
                      seg: int) -> torch.Tensor:
    """codes (n, m) u8 + a seg-aligned gather map (cap_t,) → tiled packed
    (cap_t/seg, m, seg) u8, gathered straight into the tile-major layout
    (peak: codes + one slab + a step of ``_PACK_TILED_BYTES``)."""
    n, m = codes.shape
    cap = gather_ids.shape[0]
    if cap % seg:
        raise ValueError(f"gather map of {cap} rows is not a multiple of "
                         f"seg={seg}")
    acc = torch.zeros((cap // seg, m, seg), dtype=torch.uint8,
                      device=codes.device)
    step = max(seg, (_PACK_TILED_BYTES // m // seg) * seg)
    for s in range(0, cap, step):
        e = min(s + step, cap)
        acc = _pack_codes_tiled_chunk(acc, codes, gather_ids[s:e],
                                      s // seg, seg)
    return acc


def _pack_codes_t(codes: torch.Tensor, gather_ids: torch.Tensor
                  ) -> torch.Tensor:
    """codes (n, m) u8 + gather map (cap,) → transposed packed (m, cap) u8,
    in ``_PACK_CHUNK_COLS`` column chunks past ``_PACK_CHUNK_BYTES``."""
    n, m = codes.shape
    cap = gather_ids.shape[0]
    if cap * m <= _PACK_CHUNK_BYTES:
        return _pack_codes_t_oneshot(codes, gather_ids)
    acc = torch.zeros((m, cap), dtype=torch.uint8, device=codes.device)
    for s in range(0, cap, _PACK_CHUNK_COLS):
        e = min(s + _PACK_CHUNK_COLS, cap)
        acc = _pack_codes_t_chunk(acc, codes, gather_ids[s:e], s)
    return acc


# ---------------------------------------------------------------------------
# the full streamed build
# ---------------------------------------------------------------------------

class _Stages:
    """The stage profile: with ``CHAMJAX_BUILD_PROFILE=1`` the device is
    synchronised at the end of each stage and its seconds accumulate;
    otherwise nothing waits."""

    def __init__(self, dev: torch.device):
        self.on = os.environ.get("CHAMJAX_BUILD_PROFILE", "0") == "1"
        self.dev = dev
        self.s = {}
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if not self.on:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + now - self.t
        self.t = now


def _rotated(draw, dev, R):
    def rot(s, c):
        with fp32_matmul():
            return torch.matmul(as_f32(draw(s, c), dev), R)
    return rot


def _train_encode_stream(draw, n, cfg, xt, *, kmeans_iters, pq_iters, seed,
                         chunk, block, cand, verbose, dev, stages,
                         quantizers=None):
    """The front half of the streamed build: (optionally OPQ-)train the
    quantizers and stream-assign/encode the corpus.  Returns ``(cent,
    cbooks, opq_R, assignment, codes, stats)``, device tensors.
    ``quantizers=(cent, cbooks, opq_R)`` skips training."""
    from chamjax_torch.index.pq import train_opq, train_pq

    chunk = max((chunk // block) * block, block)
    if cfg.nbits != 8:
        raise ValueError("the streamed device build is specialised for "
                         "8-bit PQ")
    src = draw

    def draw(s, c):      # noqa: F811 — every draw lands on dev as f32
        return as_f32(src(s, c), dev)

    if quantizers is not None:
        cent, cbooks, opq_R = quantizers
        cent, cbooks = as_f32(cent, dev), as_f32(cbooks, dev)
        if opq_R is not None:
            opq_R = as_f32(opq_R, dev)
            draw = _rotated(draw, dev, opq_R)
    else:
        if callable(xt):
            # lazy sample: made here and freed right after training
            xt = xt()
        xt = as_f32(xt, dev)
        opq_R = None
        if cfg.opq:
            # OPQ trains on the host over a ≤131k-row sample
            sample = xt[: 1 << 17].cpu().numpy()
            if verbose:
                print(f"[build-dev] OPQ on {sample.shape}", flush=True)
            R_host, _ = train_opq(sample, cfg.m, nbits=cfg.nbits, seed=seed,
                                  device=dev)
            opq_R = as_f32(R_host, dev)
            with fp32_matmul():
                xt = torch.matmul(xt, opq_R)
            draw = _rotated(draw, dev, opq_R)
        if verbose:
            print(f"[build-dev] lloyd nlist={cfg.nlist} on "
                  f"{tuple(xt.shape)}", flush=True)
        bal_cap = (int(np.ceil(xt.shape[0] / cfg.nlist * cfg.balance_factor))
                   if cfg.balanced else 0)
        cent = lloyd_device(xt, cfg.nlist, iters=kmeans_iters, seed=seed,
                            block=block, cand=cand, verbose=verbose,
                            balance_cap=bal_cap,
                            balance_iters=(cfg.balance_train_iters
                                           if bal_cap else 0),
                            balance_deadband=cfg.balance_deadband)
        a_t = _assign_blocked(xt, cent, block=block, cand=cand)
        train_vecs = xt - cent[a_t.long()] if cfg.by_residual else xt
        if verbose:
            print(f"[build-dev] PQ m={cfg.m}", flush=True)
        cbooks = as_f32(train_pq(train_vecs, cfg.m, nbits=cfg.nbits,
                                 iters=pq_iters, seed=seed, device=dev), dev)
        del xt, train_vecs, a_t      # free the sample before the encode
    stages.lap("train")

    n_use = (n // block) * block
    tail = n - n_use

    if cfg.balanced:
        # Two-pass balanced build: pass 1 streams a top-``cand`` candidate
        # table (cells + exact d²), the eviction rounds rebalance it under
        # the cap, pass 2 re-streams to encode against the FINAL cells.
        cap_list = int(np.ceil(n / cfg.nlist * cfg.balance_factor))
        # peak-memory bound: split the corpus into contiguous parts, each
        # rebalanced under the cells' REMAINING capacity
        parts = cfg.balance_parts or max(1, -(-(n * cand * 8) // (7 << 30)))
        ranges = [(s, min(chunk, n_use - s)) for s in range(0, n_use, chunk)]
        if tail:
            ranges.append((n_use, tail))
        groups = [g for g in np.array_split(np.arange(len(ranges)), parts)
                  if len(g)]
        assignment, n_stragglers = [], 0
        # bound the (block, nlist) stage-1 scores to ~1 GB
        blk_t = min(block, max(256, (1 << 30) // (4 * cfg.nlist)))
        used = torch.zeros((cfg.nlist,), dtype=torch.int32, device=dev)
        rows_done = 0
        for g in groups:
            cands, cds = [], []
            for gi in g:
                s, c = ranges[gi]
                cell_c, d2_c = _topc_blocked(draw(s, c), cent, block=blk_t,
                                             c=cand)
                cands.append(cell_c)
                cds.append(d2_c)
                if verbose:
                    print(f"[build-dev] candidates {s + c}/{n}", flush=True)
            cand_t = torch.cat(cands) if len(cands) > 1 else cands[0]
            cd_t = torch.cat(cds) if len(cds) > 1 else cds[0]
            del cands, cds
            stages.lap("candidates")
            rows_done += int(cand_t.shape[0])
            budget = int(np.ceil(cap_list * rows_done / n))
            cap_arr = torch.clamp(min(budget, cap_list) - used, min=0)
            a_part, strag = rebalance_assignment_device(
                cand_t, cd_t, cap_arr, hard=cfg.balance_hard,
                verbose=verbose, return_stats=True)
            del cand_t, cd_t
            stages.lap("rebalance")
            assignment.append(a_part)
            n_stragglers += strag
            if len(groups) > 1:
                used = used + torch.bincount(
                    a_part.long(), minlength=cfg.nlist).to(torch.int32)
        assignment = (torch.cat(assignment) if len(assignment) > 1
                      else assignment[0])
        codes = []
        for s in range(0, n_use, chunk):
            c = min(chunk, n_use - s)
            codes.append(_encode_assigned_chunk(
                draw(s, c), assignment[s:s + c], cent, cbooks, block=block,
                by_residual=cfg.by_residual))
            if verbose:
                print(f"[build-dev] encoded {s + c}/{n}", flush=True)
        if tail:
            codes.append(_encode_assigned_chunk(
                draw(n_use, tail), assignment[n_use:], cent, cbooks,
                block=tail, by_residual=cfg.by_residual))
        codes = torch.cat(codes) if len(codes) > 1 else codes[0]
        stages.lap("encode")
        return cent, cbooks, opq_R, assignment, codes, {
            "stragglers": n_stragglers, "cap": cap_list}

    # streamed assign + encode; the non-block-aligned tail is one call
    assigns, codes = [], []
    spans = [(s, min(chunk, n_use - s)) for s in range(0, n_use, chunk)]
    if tail:
        spans.append((n_use, tail))
    for s, c in spans:
        a_c, code_c = _assign_encode_chunk(
            draw(s, c), cent, cbooks, block=min(block, c), cand=cand,
            by_residual=cfg.by_residual)
        assigns.append(a_c)
        codes.append(code_c)
        if verbose:
            print(f"[build-dev] encoded {s + c}/{n}", flush=True)
    assignment = torch.cat(assigns) if len(assigns) > 1 else assigns[0]
    codes = torch.cat(codes) if len(codes) > 1 else codes[0]
    stages.lap("encode")
    return cent, cbooks, opq_R, assignment, codes, {}


@fp32_matmul()
def build_ivfpq_device(
    draw: DrawFn,
    n: int,
    cfg: IndexConfig,
    xt,
    *,
    kmeans_iters: int = 10,
    pq_iters: int = 10,
    seed: int = 0,
    chunk: int = 1 << 22,
    block: int = 4096,
    cand: int = 8,
    tail_pad: Optional[int] = None,
    verbose: bool = False,
    quantizers=None,
    tile_seg: int = 0,
    tile_only: bool = False,
    device=None,
):
    """Train + populate an IVF-PQ index on ``device`` without ever holding
    the corpus whole.

    ``draw(start, count)`` returns corpus rows ``[start, start+count)``
    (a tensor or array, f32), deterministically; ``xt`` is the training
    sample (a tensor, an array, or a callable returning one, freed after
    training).  ``cfg.opq`` host-trains the rotation on ≤131k rows and
    folds it into ``draw``; ``cfg.balanced`` trains balanced Lloyd
    iterations and caps the lists by the two-pass eviction rounds.
    ``quantizers=(centroids, codebooks, opq_R)`` populates against preset
    quantizers.  ``tile_seg`` > 0 packs every list on ``tile_seg``
    boundaries (``list_pad`` becomes ``lcm(list_pad, tile_seg)``) and
    attaches the seg-tiled twin; ``tile_only`` packs straight into it and
    drops the flat one.

    Returns ``(DeviceIVF, info)``: ``info`` has host copies of the list
    tables, ``ntotal``, ``n_pad`` and, when balanced, ``stragglers`` and
    ``cap``; ``stage_s`` (seconds: train, candidates, rebalance, encode,
    pack) with ``CHAMJAX_BUILD_PROFILE=1``."""
    from chamjax_torch.ops.scan_seg import MAX_SEG
    from chamjax_torch.searcher import DeviceIVF

    dev = resolve_device(device)
    # resident-tier int32 id space: the padded capacity must fit
    if n + cfg.nlist * max(cfg.list_pad, tile_seg, 1) >= 2 ** 31:
        raise ValueError(
            f"{n} rows + worst-case pad overflow the int32 id space; shard "
            "the corpus or use the streamed tier")
    if tile_seg:
        cfg = dataclasses.replace(
            cfg, list_pad=math.lcm(max(cfg.list_pad, 1), tile_seg))
    if tail_pad is None:
        tail_pad = 8192
    stages = _Stages(dev)
    cent, cbooks, opq_R, assignment, codes, binfo = _train_encode_stream(
        draw, n, cfg, xt, kmeans_iters=kmeans_iters, pq_iters=pq_iters,
        seed=seed, chunk=chunk, block=block, cand=cand, verbose=verbose,
        dev=dev, stages=stages, quantizers=quantizers)

    # device pack into the searcher's CSR layout (+ the MAX_SEG overread
    # tail, written in place by padding the gather map first)
    cap = n + cfg.nlist * cfg.list_pad + tail_pad
    gather_ids, list_start, list_len = _pack_layout(
        assignment, nlist=cfg.nlist, list_pad=cfg.list_pad, cap=cap)
    del assignment
    ids = torch.cat([gather_ids, torch.full((MAX_SEG,), -1,
                                            dtype=torch.int32, device=dev)])
    del gather_ids
    codes_t = codes_tiled = None
    if tile_seg:
        cap_t = -(-cap // tile_seg) * tile_seg     # ≤ cap + MAX_SEG
    if tile_seg and tile_only:
        codes_tiled = _pack_codes_tiled(codes, ids[:cap_t], tile_seg)
    else:
        codes_t = _pack_codes_t(codes, ids)
        if tile_seg:
            codes_tiled = (codes_t[:, :cap_t]
                           .reshape(codes_t.shape[0], cap_t // tile_seg,
                                    tile_seg).permute(1, 0, 2).contiguous())
    del codes
    if verbose:
        print(f"[build-dev] packed cap={cap} ({cap / max(n, 1):.3f}x)"
              f"{' tiled only' if codes_t is None else ''}", flush=True)
    stages.lap("pack")
    index = DeviceIVF(centroids=cent, codebooks=cbooks, codes_t=codes_t,
                      ids=ids, list_start=list_start, list_len=list_len,
                      opq_R=opq_R, codes_tiled=codes_tiled)
    info = {
        "list_len": list_len.cpu().numpy(),
        "list_start": list_start.cpu().numpy(),
        "ntotal": n,
        "n_pad": cap,
        **binfo,
    }
    if stages.on:
        info["stage_s"] = dict(stages.s)
        if verbose:
            print(f"[build-dev] stage profile: {stages.s}", flush=True)
    return index, info


@fp32_matmul()
def build_ivfpq_device_sharded(
    draw: DrawFn,
    n: int,
    cfg: IndexConfig,
    xt,
    n_shards: int,
    *,
    kmeans_iters: int = 10,
    pq_iters: int = 10,
    seed: int = 0,
    chunk: int = 1 << 22,
    block: int = 4096,
    cand: int = 8,
    tail_pad: int = 8192,
    verbose: bool = False,
    tile_seg: int = 0,
    device=None,
):
    """The streamed build straight into the mesh-sharded layout: a
    :class:`~chamjax_torch.parallel.sharded_search.ShardedIVF` of
    ``n_shards`` row-balanced shards, ready for ``place_sharded``, without
    the corpus ever visiting the host.

    Lists go to shards by ``shard_index``'s longest-first greedy row
    balance, computed on the host from the ``(nlist,)`` length table (the
    build's one host round trip besides OPQ's sample), which also sizes the
    static shard capacity ``cap``.  Every shard is packed on ``device``, the
    build's device, so the peak holds every shard there at once, beside the
    corpus's codes; ``place_sharded`` then moves them.

    ``tile_seg`` > 0 packs every list on ``tile_seg`` boundaries
    (``list_pad`` becomes ``lcm(list_pad, tile_seg)``) and emits the
    seg-tiled layout only: one reshape of the flat pack's first ``cap``
    columns, so a shard's ``codes_tiled`` holds ``cap`` rows while its
    ``ids`` keep the ``MAX_SEG`` overread tail (``cap + MAX_SEG``).

    Returns ``(ShardedIVF, info)``: ``info`` has the host ``list_len``,
    ``owner`` (each list's shard), ``shard_rows`` (padded rows a shard),
    ``ntotal`` and ``n_pad`` (= ``cap``)."""
    from chamjax_torch.ops.scan_seg import MAX_SEG
    from chamjax_torch.parallel.sharded_search import ShardedIVF

    dev = resolve_device(device)
    if tile_seg:
        cfg = dataclasses.replace(
            cfg, list_pad=math.lcm(max(cfg.list_pad, 1), tile_seg))
    cent, cbooks, opq_R, assignment, codes, _binfo = _train_encode_stream(
        draw, n, cfg, xt, kmeans_iters=kmeans_iters, pq_iters=pq_iters,
        seed=seed, chunk=chunk, block=block, cand=cand, verbose=verbose,
        dev=dev, stages=_Stages(dev))

    nlist, pad = cfg.nlist, cfg.list_pad
    order = torch.argsort(assignment, stable=True).to(torch.int32)
    list_len = torch.bincount(assignment.long(), minlength=nlist).to(
        torch.int32)
    src_start = _exclusive_cumsum(list_len)
    del assignment

    # greedy longest-first row balance, on the host's (nlist,) table
    ll = list_len.cpu().numpy()
    padded = (np.maximum(-(-np.maximum(ll, 1) // pad), 1) * pad).astype(
        np.int64)
    owner = np.zeros(nlist, np.int32)
    loads = np.zeros(n_shards, np.int64)
    for l in np.argsort(-ll, kind="stable"):
        s = int(np.argmin(loads))
        owner[l] = s
        loads[s] += int(padded[l])
    cap = int(loads.max()) + tail_pad
    if tile_seg:
        cap = -(-cap // tile_seg) * tile_seg
    if cap + MAX_SEG >= 2 ** 31:
        raise ValueError(f"a shard of {cap} padded rows overflows the int32 "
                         "id space; raise n_shards")
    if verbose:
        print(f"[build-dev] shard loads rows={loads.tolist()} cap={cap}",
              flush=True)

    codes_s, ids_s, starts_s, lens_s = [], [], [], []
    owner_dev = torch.from_numpy(owner).to(dev)
    for s in range(n_shards):
        g_ids, st, ln = _pack_layout_core(order, list_len, src_start,
                                          owner_dev == s, list_pad=pad,
                                          cap=cap)
        # the MAX_SEG overread tail goes on the gather map before the pack
        # (a pack then concatenate would hold the shard twice at its peak)
        g_ids = torch.cat([g_ids, torch.full((MAX_SEG,), -1,
                                             dtype=torch.int32, device=dev)])
        packed_t = _pack_codes_t(codes, g_ids)
        if tile_seg:
            # list_pad is a tile_seg multiple and cap is tile-rounded: the
            # tiled layout is one reshape of the first cap columns
            m = packed_t.shape[0]
            packed_t = (packed_t[:, :cap]
                        .reshape(m, cap // tile_seg, tile_seg)
                        .permute(1, 0, 2).contiguous())
        codes_s.append(packed_t)
        ids_s.append(g_ids)
        starts_s.append(st)
        lens_s.append(ln)
    del codes, order

    sharded = ShardedIVF(
        centroids=cent, codebooks=cbooks,
        codes_t=None if tile_seg else tuple(codes_s), ids=tuple(ids_s),
        list_start=tuple(starts_s), list_len=tuple(lens_s),
        codes_tiled=tuple(codes_s) if tile_seg else None, opq_R=opq_R)
    info = {"list_len": ll, "owner": owner, "shard_rows": loads,
            "ntotal": n, "n_pad": cap}
    return sharded, info


# ---------------------------------------------------------------------------
# streamed exact ground truth (same draw stream as the build)
# ---------------------------------------------------------------------------

def _gt_chunk(xq: torch.Tensor, x: torch.Tensor, start: int,
              best_d: torch.Tensor, best_i: torch.Tensor, k: int,
              block: int):
    """Fold the rows of ``x`` (global offset ``start``) into the running
    top-k (``best_d`` partial distances ||x||² - 2 q·x, ``best_i``)."""
    for s, b in _blocks(x.shape[0], block):
        x_blk = x[s:s + b]
        d2 = (torch.sum(x_blk * x_blk, dim=1)[None, :]
              - 2.0 * torch.matmul(xq, x_blk.T))
        cd, ci = torch.topk(-d2, min(k, b), dim=1)
        dall = torch.cat([best_d, -cd], dim=1)
        iall = torch.cat([best_i, ci + (start + s)], dim=1)
        neg, pos = torch.topk(-dall, k, dim=1)
        best_d, best_i = -neg, iall.gather(1, pos)
    return best_d, best_i


@fp32_matmul()
def compute_ground_truth_streamed(
    draw: DrawFn, n: int, xq, k: int = 10,
    chunk: int = 1 << 22, block: int = 1 << 20, device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact squared-L2 top-k over a streamed corpus (fp32, TF32 off).

    Returns ``(ids (nq, k) int64, dists (nq, k) float32)`` with true squared
    distances; the draws are the JAX package's (block-aligned chunks, one
    tail)."""
    dev = resolve_device(device)
    xq = as_f32(xq, dev)
    nq = xq.shape[0]
    best_d = torch.full((nq, k), float("inf"), device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    n_use = (n // block) * block
    chunk = max((chunk // block) * block, block)
    for s in range(0, n_use, chunk):
        c = min(chunk, n_use - s)
        best_d, best_i = _gt_chunk(xq, as_f32(draw(s, c), dev), s, best_d,
                                   best_i, k=k, block=min(block, c))
    tail = n - n_use
    if tail:
        best_d, best_i = _gt_chunk(xq, as_f32(draw(n_use, tail), dev), n_use,
                                   best_d, best_i, k=k, block=tail)
    qn = torch.sum(xq * xq, dim=1, keepdim=True)
    return best_i.cpu().numpy().astype(np.int64), (best_d + qn).cpu().numpy()
