"""The plain reference of an IVF-PQ search with packed-bf16 ADC tables,
and the judgment of a search's answers against it.

The semantics, written from the configuration: a query probes the
``nprobe`` lists whose centroids lie nearest (squared L2); a row's
distance is the sum over sub-quantizers of ``bf16(|r_m - c_m|^2)``, where
``r`` is the query's residual to the row's list centroid and ``c_m`` the
row's codeword; the answer is the ``k`` rows of smallest distance, as
ids.  A query scans its probes' windows of ``seg`` rows in order of
probe rank up to its window budget (``window_budget``), so a query whose
probes hold more windows scans a prefix of them.

Distances are formed in float64 from the difference itself (no
expansion), each term rounded to float32 and then to bfloat16, and summed
in float64.  The index tables (centroids, codebooks, codes, ids, list
starts and lengths) are the program's build: the reference follows the
search from them, and ``encode_gap`` checks the build's encoding on
corpus rows by itself.  ``truth`` judges the answers against the exact
nearest neighbours in the corpus, which needs none of the program's
tables.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

MAX_SEG = 4096
WINDOW_FIXED_ROWS = 2048  # the searcher's cost model, frozen here


def auto_seg(list_len: np.ndarray) -> int:
    """The power-of-two window width the configuration's searcher takes:
    the least length-weighted ``ceil(len/seg)·(fixed + seg)``."""
    lens = np.asarray(list_len, np.float64)
    total = lens.sum()
    if total <= 0:
        return 256
    w = lens / total
    best, best_cost, seg = 256, np.inf, 256
    while seg <= MAX_SEG:
        cost = float((w * np.ceil(lens / seg)).sum()
                     * (WINDOW_FIXED_ROWS + seg))
        if cost < best_cost:
            best, best_cost = seg, cost
        seg *= 2
    return best


def window_budget(list_len: np.ndarray, seg: int, nprobe: int,
                  group: int) -> int:
    """Windows a query may scan: nprobe times the length-weighted mean
    windows a list, times 1.2, plus 4; at most the worst query's need and
    the index's windows; rounded up to ``group``."""
    lens = np.asarray(list_len, np.float64)
    segs = np.ceil(lens / seg)
    total = lens.sum()
    w_mean = float((lens * segs).sum() / total)
    w = int(np.ceil(nprobe * w_mean * 1.2)) + 4
    w = min(w, int(nprobe * segs.max()), int(segs.sum()))
    return -(-w // group) * group


@dataclass
class Index:
    """The program's index tables on a device, with the maps the
    reference needs: a row's list and an id's row."""

    centroids: torch.Tensor     # (nlist, d) f64
    codebooks: torch.Tensor     # (m, ksub, dsub) f64
    codes: torch.Tensor         # (n_pad, m) uint8
    ids: torch.Tensor           # (n_pad,) int64, -1 on padding
    list_start: torch.Tensor    # (nlist,) int64
    list_len: torch.Tensor      # (nlist,) int64
    row_list: torch.Tensor      # (n_pad,) int64
    row_of_id: torch.Tensor     # (ntotal,) int64
    seg: int
    budget: int
    nprobe: int
    k: int

    @staticmethod
    def from_tables(t: Dict[str, np.ndarray], nprobe: int, k: int,
                    group: int, device) -> "Index":
        ll = np.asarray(t["list_len"], np.int64)
        ls = np.asarray(t["list_start"], np.int64)
        n_pad = t["codes"].shape[0]
        row_list = np.full(n_pad, -1, np.int64)
        for li in np.nonzero(ll)[0]:
            row_list[ls[li]:ls[li] + ll[li]] = li
        ids = np.asarray(t["ids"], np.int64)
        valid = ids >= 0
        row_of_id = np.full(int(ids.max()) + 1, -1, np.int64)
        row_of_id[ids[valid]] = np.nonzero(valid)[0]
        seg = auto_seg(ll)

        def put(a, dt=None):
            return torch.as_tensor(np.ascontiguousarray(a), device=device,
                                   dtype=dt)

        return Index(
            centroids=put(t["centroids"], torch.float64),
            codebooks=put(t["codebooks"], torch.float64),
            codes=put(t["codes"]), ids=put(ids), list_start=put(ls),
            list_len=put(ll), row_list=put(row_list),
            row_of_id=put(row_of_id), seg=seg,
            budget=window_budget(ll, seg, nprobe, group),
            nprobe=nprobe, k=k)


def terms(ix: Index, q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Per sub-quantizer distances ``|r_m - c_m|^2`` in float64 of
    queries ``q`` (b, d) to ``rows`` (b, n) of the packed layout:
    (b, n, m)."""
    b, n = rows.shape
    m, _, dsub = ix.codebooks.shape
    lists = ix.row_list[rows]                                   # (b, n)
    r = q.double()[:, None, :] - ix.centroids[lists]            # (b, n, d)
    codes = ix.codes[rows].long()                               # (b, n, m)
    cw = ix.codebooks[torch.arange(m, device=q.device), codes]  # (b,n,m,ds)
    return ((r.reshape(b, n, m, dsub) - cw) ** 2).sum(-1)


def bf16_sum(t: torch.Tensor) -> torch.Tensor:
    """The configuration's distance from float64 terms: each rounded to
    float32 then bfloat16, summed in float64."""
    return t.float().bfloat16().double().sum(-1)


def fp8_sum(t: torch.Tensor) -> torch.Tensor:
    """The control's distance: each term in float8 e4m3 under one scale a
    query (its largest term to 448), summed in float64."""
    scale = 448.0 / t.flatten(1).amax(dim=1).clamp_min(1e-30)
    s = scale[:, None, None]
    return ((t * s).float().to(torch.float8_e4m3fn).double() / s).sum(-1)


def coarse(ix: Index, q: torch.Tensor) -> torch.Tensor:
    """Squared distances of float64 queries (b, d) to every centroid."""
    cn = (ix.centroids ** 2).sum(1)
    return (q * q).sum(1)[:, None] + cn[None] - 2.0 * q @ ix.centroids.T


def _candidates(ix: Index, q: torch.Tensor):
    """Each query's scanned rows under the reference's probe order and
    window budget, and which of them are certain: in a list scanned whole
    and nearer, by more than rounding, than the first list not scanned
    whole.  Returns (rows (b, n) int64 with -1 padding, certain (b, n))."""
    qd = q.double()
    dc = coarse(ix, qd)                                         # (b, nlist)
    order = torch.argsort(dc, dim=1)[:, :ix.nprobe + 1]
    dsort = torch.gather(dc, 1, order)
    lens = ix.list_len[order[:, :ix.nprobe]]
    segs = (lens + ix.seg - 1) // ix.seg
    cum = torch.cumsum(segs, dim=1)
    full = cum <= ix.budget                                     # (b, nprobe)
    n_full = full.sum(1)
    # the first list not scanned whole: the budget's straddler or rank nprobe
    boundary = torch.gather(dsort, 1, n_full[:, None])[:, 0]
    tol = 1e-5 * ((qd * qd).sum(1) + (ix.centroids ** 2).sum(1).max())
    width = int(ix.list_len.max())
    off = torch.arange(width, device=q.device)
    b = q.shape[0]
    rows, certain = [], []
    for p in range(ix.nprobe):
        li = order[:, p]
        ln = ix.list_len[li]
        seen = torch.clamp(ix.budget - (cum[:, p] - segs[:, p]), min=0)
        ln_scanned = torch.minimum(ln, seen * ix.seg)
        r = ix.list_start[li][:, None] + off[None]
        ok = off[None] < ln_scanned[:, None]
        rows.append(torch.where(ok, r, torch.full_like(r, -1)))
        sure = full[:, p] & (dsort[:, p] < boundary - tol)
        certain.append(ok & sure[:, None])
    return torch.cat(rows, 1), torch.cat(certain, 1)


def control_answers(ix: Index, q: torch.Tensor, chunk: int = 8):
    """The control's answers: the reference's own search of queries ``q``
    (b, d) with its ADC terms in float8 e4m3 (``fp8_sum``), as ids and
    distances (b, k)."""
    out_ids, out_d = [], []
    for s in range(0, q.shape[0], chunk):
        qc = q[s:s + chunk].to(ix.centroids.device)
        rows, _ = _candidates(ix, qc)
        safe = rows.clamp_min(0)
        got = fp8_sum(terms(ix, qc, safe)).masked_fill(rows < 0, math.inf)
        d, pos = torch.topk(got, ix.k, dim=1, largest=False)
        out_ids.append(torch.gather(ix.ids[safe], 1, pos))
        out_d.append(d)
    return torch.cat(out_ids), torch.cat(out_d)


def judge(ix: Index, q: torch.Tensor, ids: torch.Tensor,
          dists: torch.Tensor, chunk: int = 8) -> Dict[str, float]:
    """The numbers by which a search's answers ``ids``, ``dists`` (b, k)
    for queries ``q`` (b, d) are judged against the configuration's
    semantics over the program's tables:

    - ``dist_err``: the largest gap between an answer's distance and the
      true distance of its id, over the query's true k-th distance;
    - ``miss``: the largest amount by which an answer's true distance
      lies above the k-th true distance among the query's certain rows,
      over that distance.

    An id that is not in the index reads as an infinite gap.
    """
    worst = {"dist_err": 0.0, "miss": 0.0}
    for s in range(0, q.shape[0], chunk):
        qc = q[s:s + chunk].to(ix.centroids.device)
        rows, certain = _candidates(ix, qc)
        true = bf16_sum(terms(ix, qc, rows.clamp_min(0)))
        true = true.masked_fill(rows < 0, math.inf)
        k = ix.k
        kth = torch.topk(true, k, dim=1, largest=False).values[:, -1]
        kth_certain = torch.topk(true.masked_fill(~certain, math.inf), k,
                                 dim=1, largest=False).values[:, -1]
        a_ids = ids[s:s + chunk].to(qc.device).long()
        a_d = dists[s:s + chunk].to(qc.device).double()
        bad = (a_ids < 0) | (a_ids >= ix.row_of_id.shape[0])
        a_rows = ix.row_of_id[a_ids.clamp(0, ix.row_of_id.shape[0] - 1)]
        bad |= a_rows < 0
        a_true = bf16_sum(terms(ix, qc, a_rows.clamp_min(0)))
        a_true = a_true.masked_fill(bad, math.inf)
        scale = kth.clamp_min(1e-30)[:, None]
        err = ((a_d - a_true).abs() / scale).nan_to_num(math.inf)
        err = err.masked_fill(bad, math.inf)
        dup = (a_ids[:, :, None] == a_ids[:, None, :]).sum((1, 2)) > k
        err[dup] = math.inf
        worst["dist_err"] = max(worst["dist_err"], float(err.max()))
        has = torch.isfinite(kth_certain)
        if bool(has.any()):
            miss = ((a_true.max(1).values - kth_certain)
                    / kth_certain.clamp_min(1e-30))[has]
            worst["miss"] = max(worst["miss"],
                                float(miss.nan_to_num(math.inf).max()))
    return worst


def exact_knn(xb: torch.Tensor, q: torch.Tensor, k: int,
              chunk: int = 1 << 17, spare: int = 32):
    """The exact ``k`` nearest corpus rows of each query by squared L2,
    from the corpus alone: candidates by a float32 pass over ``xb`` in
    chunks (TF32 off), ranked again in float64 from the differences.
    Returns (rows (b, k) int64, squared distances (b, k) float64)."""
    from portbench.reference.model import no_tf32

    qf = q.to(xb.device).float()
    qn = (qf * qf).sum(1)
    best_d = best_i = None
    c = k + spare
    with no_tf32():
        for s in range(0, xb.shape[0], chunk):
            x = xb[s:s + chunk].float()
            d = qn[:, None] + (x * x).sum(1)[None] - 2.0 * qf @ x.T
            v, i = torch.topk(d, min(c, x.shape[0]), dim=1, largest=False)
            i = i + s
            if best_d is not None:
                v, i = torch.cat([best_d, v], 1), torch.cat([best_i, i], 1)
                v, pos = torch.topk(v, min(c, v.shape[1]), dim=1,
                                    largest=False)
                i = torch.gather(i, 1, pos)
            best_d, best_i = v, i
    d64 = sq_dist(xb, q, best_i)
    v, pos = torch.topk(d64, k, dim=1, largest=False)
    return torch.gather(best_i, 1, pos), v


def sq_dist(xb: torch.Tensor, q: torch.Tensor, rows: torch.Tensor
            ) -> torch.Tensor:
    """Squared L2 in float64 from the differences, of queries ``q``
    (b, d) to corpus rows ``rows`` (b, n): (b, n)."""
    x = xb[rows.to(xb.device)].double()
    return ((x - q.to(xb.device).double()[:, None]) ** 2).sum(-1)


def truth(xb: torch.Tensor, q: torch.Tensor, ids: torch.Tensor
          ) -> Dict[str, torch.Tensor]:
    """The answers ``ids`` (b, k) of queries ``q`` against the exact
    nearest neighbours in the corpus ``xb`` (whose row i has id i), per
    query: ``kth_excess``, how far the farthest answer's squared distance
    lies above the exact k-th's, over it (infinite for an id that is not
    a corpus row or is answered twice); ``recall``, the share of the
    exact k nearest among the answers."""
    k = ids.shape[1]
    want, want_d = exact_knn(xb, q, k)
    a = ids.to(xb.device).long()
    bad = (a < 0) | (a >= xb.shape[0])
    bad |= (a[:, :, None] == a[:, None, :]).sum(2) > 1
    got_d = sq_dist(xb, q, a.clamp(0, xb.shape[0] - 1))
    got_d = got_d.masked_fill(bad, math.inf)
    kth = want_d[:, -1].clamp_min(1e-30)
    excess = got_d.max(1).values / kth - 1.0
    hit = (a[:, :, None] == want[:, None, :]).any(2) & ~bad
    return {"kth_excess": excess, "recall": hit.double().mean(1)}


def probe_sets(ix: Index, q: torch.Tensor) -> torch.Tensor:
    """Each query's ``nprobe`` nearest lists, sorted by list number."""
    dc = coarse(ix, q.double())
    return torch.sort(torch.topk(dc, ix.nprobe, dim=1, largest=False)
                      .indices, dim=1).values


def probed_rows(ix: Index, lists: torch.Tensor) -> Dict[str, int]:
    """Rows a batch's probes hold (with repeats) and the rows of the
    union of the lists it probes."""
    return {"rows_probed": int(ix.list_len[lists].sum()),
            "union_rows": int(ix.list_len[torch.unique(lists)].sum())}


def encode_gap(ix: Index, x: torch.Tensor, ids: torch.Tensor,
               control: bool = False) -> float:
    """The build's encoding, checked on corpus rows ``x`` (n, d) with ids
    ``ids``: for each row and sub-quantizer, how far its stored codeword
    lies above the nearest one to its residual, over the row's whole
    residual norm.  With ``control``, the nearest codewords are found in
    bfloat16 and judged the same way."""
    rows = ix.row_of_id[ids.long()]
    if bool((rows < 0).any()):
        return math.inf
    m, ksub, dsub = ix.codebooks.shape
    r = x.double() - ix.centroids[ix.row_list[rows]]
    rs = r.reshape(-1, m, 1, dsub)
    dist = ((rs - ix.codebooks[None]) ** 2).sum(-1)             # (n, m, ksub)
    if control:
        lo = ((rs.bfloat16() - ix.codebooks[None].bfloat16()).float() ** 2
              ).sum(-1)
        code = lo.argmin(-1)
    else:
        code = ix.codes[rows].long()
    stored = torch.gather(dist, 2, code[..., None])[..., 0]
    gap = (stored - dist.min(-1).values).sum(-1) / (r * r).sum(-1)
    return float(gap.max())


def id_coverage(ix: Index, ntotal: int) -> int:
    """Ids missing from the index or held more than once (0 for a sound
    build)."""
    ids = ix.ids[ix.ids >= 0]
    counts = torch.bincount(ids, minlength=ntotal)
    return int((counts != 1).sum())
