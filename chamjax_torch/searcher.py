"""End-to-end IVF-PQ search (the port of ``chamjax/searcher.py``).

The query path — OPQ rotation → coarse scan → LUT construction → window
expansion → ADC scan → top-k → row→id map — runs on one device, with no
host round trip between the stages.  The scan routes: ``backend="seg"``
over the seg-tiled twin (``csrc/adc_scan_tiles.cu``) or, without one, over
the flat layout (``csrc/adc_scan_flat.cu``, ``group > 1`` multi-window,
``group == 1`` single-window); ``backend="pallas"``, the padded-window scan
(``adc_scan_flat.cu`` too); ``backend="xla"``, the plain torch oracle.

``ivfpq_search`` and ``ivfpq_search_preassigned`` are captured in a CUDA
graph on the card for every backend (``utils/graphs.py``, the counterpart
of the JAX package's ``jit``), one graph per query shape and static
arguments, owned by the ``DeviceIVF``.  As under ``jit``, their host logic
(the window default, the pallas → xla warning, the fp32-matmul switch) runs
when a graph is captured; the matmuls replay with TF32 off, as captured.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from chamjax_torch.config import SearchConfig
from chamjax_torch.index.ivf import PackedIVF
from chamjax_torch.ops.coarse import select_probes
from chamjax_torch.ops.lut import build_luts
from chamjax_torch.ops.scan_pallas import (GROUP, resolve_chunk,
                                           scan_lists_pallas)
from chamjax_torch.ops.scan_seg import (MAX_SEG, WINDOW_FIXED_ROWS,
                                        scan_lists_seg)
from chamjax_torch.ops.scan_seg_block import scan_lists_seg_block
from chamjax_torch.ops.scan_seg_multi import scan_lists_seg_multi
from chamjax_torch.ops.scan_xla import scan_lists_xla
from chamjax_torch.utils import graphs, tracing
from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul


@dataclasses.dataclass
class DeviceIVF:
    """Device-resident index tensors, all on one device.

    ``codes_t``/``ids`` carry ``MAX_SEG`` extra padding rows so a scan
    window may overread past the last list (masked by the window length).

    ``codes_tiled`` (``from_packed(tile_seg=...)``): the same codes
    seg-tiled as ``(n_tiles, m, seg)`` with every list starting on a tile
    boundary.  When present, ``ids``/``list_start`` are in the tile-aligned
    coordinate system, shared by the flat twin.

    ``graphs``: the captured searches over this index.
    """

    centroids: torch.Tensor     # (nlist, d) f32
    codebooks: torch.Tensor     # (m, ksub, dsub) f32
    codes_t: torch.Tensor       # (m, n_pad + MAX_SEG) uint8 — transposed
    ids: torch.Tensor           # (n_pad + MAX_SEG,) int32
    list_start: torch.Tensor    # (nlist,) int32
    list_len: torch.Tensor      # (nlist,) int32
    opq_R: Optional[torch.Tensor] = None        # (d, d) f32 or None
    codes_tiled: Optional[torch.Tensor] = None  # (n_tiles, m, seg) uint8
    graphs: graphs.Graphs = dataclasses.field(
        default_factory=graphs.Graphs, repr=False, compare=False)

    @staticmethod
    def from_packed(index: PackedIVF, device=None,
                    tile_seg: int = 0) -> "DeviceIVF":
        dev = resolve_device(device)
        # int32 row/id space: past ~2.1B padded rows it would wrap silently
        worst_pad = (int(index.list_len.shape[0]) * max(int(tile_seg), 1)
                     + MAX_SEG)
        if int(index.codes.shape[0]) + worst_pad >= 2 ** 31:
            raise ValueError(
                f"{index.codes.shape[0]} rows (+{worst_pad} padding) "
                "overflow the resident tier's int32 id space; shard the "
                "corpus (not yet ported)")
        codes_tiled = None
        if tile_seg:
            # Re-pack every list onto tile_seg boundaries (host-side, one
            # pass) so both layouts share one coordinate system.
            seg = int(tile_seg)
            lens = np.asarray(index.list_len, np.int64)
            tiles_per = np.maximum(1, -(-lens // seg))
            new_start = (np.concatenate(
                [[0], np.cumsum(tiles_per)[:-1]]) * seg).astype(np.int64)
            n = int(tiles_per.sum()) * seg
            m = index.codes.shape[1]
            codes_flat = np.zeros((n + MAX_SEG, m), np.uint8)
            ids = np.full(n + MAX_SEG, -1, np.int32)
            old_start = np.asarray(index.list_start, np.int64)
            for li in range(lens.shape[0]):
                ln = int(lens[li])
                if ln == 0:
                    continue
                so, sn = int(old_start[li]), int(new_start[li])
                codes_flat[sn:sn + ln] = index.codes[so:so + ln]
                ids[sn:sn + ln] = index.ids[so:so + ln]
            codes_t = np.ascontiguousarray(codes_flat.T)
            list_start = new_start.astype(np.int32)
            codes_tiled = np.ascontiguousarray(
                codes_flat[:n].reshape(-1, seg, m).transpose(0, 2, 1))
        else:
            codes_t = np.pad(np.ascontiguousarray(index.codes.T),
                             ((0, 0), (0, MAX_SEG)))
            ids = np.pad(index.ids, (0, MAX_SEG), constant_values=-1)
            list_start = index.list_start

        def put(a):     # a copy: the device index never aliases the host's
            return torch.tensor(np.ascontiguousarray(a), device=dev)

        return DeviceIVF(
            centroids=put(np.asarray(index.centroids, np.float32)),
            codebooks=put(np.asarray(index.codebooks, np.float32)),
            codes_t=put(codes_t),
            ids=put(np.asarray(ids, np.int32)),
            list_start=put(np.asarray(list_start, np.int32)),
            list_len=put(np.asarray(index.list_len, np.int32)),
            opq_R=(put(np.asarray(index.opq_R, np.float32))
                   if index.opq_R is not None else None),
            codes_tiled=(put(codes_tiled) if codes_tiled is not None
                         else None),
        )


def _retile_core(codes_t, ids, list_start, list_len, *, seg: int,
                 cap_new: int):
    """Device-side repack of a flat CSR layout onto ``seg`` boundaries.

    The boundary marks run at tile granularity (every new tile belongs to
    one list), so the tables are ``cap_new/seg`` long; the per-row work is
    two small-table gathers.  Padding rows get id -1; their codes are
    whatever the clipped gather reads (a scan masks them by length)."""
    dev = codes_t.device
    nlist = list_len.shape[0]
    eff = list_len.long()
    tiles_per = torch.clamp((eff + seg - 1) // seg, min=1)
    tile_start = torch.zeros_like(tiles_per)
    tile_start[1:] = torch.cumsum(tiles_per, 0)[:-1]
    new_start = tile_start * seg
    n_tiles = cap_new // seg
    mark = torch.zeros((n_tiles,), dtype=torch.int64, device=dev)
    mark.index_add_(0, tile_start, torch.ones_like(tile_start))
    list_of_tile = torch.clamp(torch.cumsum(mark, 0) - 1, max=nlist - 1)
    base = (torch.arange(n_tiles, device=dev) * seg
            - new_start[list_of_tile])
    off2d = base[:, None] + torch.arange(seg, device=dev)[None, :]
    valid2d = (off2d >= 0) & (off2d < eff[list_of_tile][:, None])
    src2d = torch.clamp(list_start.long()[list_of_tile][:, None] + off2d,
                        0, codes_t.shape[1] - 1).reshape(-1)
    ids_new = torch.where(valid2d.reshape(-1), ids[src2d], -1).to(
        torch.int32)
    m = codes_t.shape[0]
    codes_new = codes_t[:, src2d]
    codes_tiled = (codes_new.reshape(m, n_tiles, seg).permute(1, 0, 2)
                   .contiguous())
    return codes_new, ids_new, new_start.to(torch.int32), codes_tiled


def retile_device_ivf(dev: DeviceIVF, seg: int,
                      list_len_host: Optional[np.ndarray] = None
                      ) -> DeviceIVF:
    """Re-pack a device-resident index onto ``seg`` tile boundaries and
    attach the ``codes_tiled`` twin, on its device: the post-build path for
    ``build_ivfpq_device`` indexes whose ``seg`` is sized from the built
    list lengths.  Reads only the (nlist,) length table on the host.

    The result is a new ``DeviceIVF`` with a fresh ``graphs``: a search
    captured over the old layout replays against the old tensors and must
    not be reused for the new one."""
    ll = (dev.list_len.cpu().numpy() if list_len_host is None
          else np.asarray(list_len_host))
    padded = (np.maximum(np.ceil(ll / seg), 1) * seg).astype(np.int64)
    cap_new = int(padded.sum()) + max(MAX_SEG, seg)
    cap_new = -(-cap_new // seg) * seg
    codes_new, ids_new, new_start, codes_tiled = _retile_core(
        dev.codes_t, dev.ids, dev.list_start, dev.list_len, seg=seg,
        cap_new=cap_new)
    return dataclasses.replace(dev, codes_t=codes_new, ids=ids_new,
                               list_start=new_start, codes_tiled=codes_tiled,
                               graphs=graphs.Graphs())


def _dispatch_scan(index: DeviceIVF, luts, list_ids, *, k, scan_len,
                   windows, seg, group, probe_chunk, use_approx,
                   recall_target, backend, tile, lut_bf16=False, select_l1=0,
                   lane_l1=False, slot_major=True):
    sel = dict(k=k, use_approx=use_approx, recall_target=recall_target)
    flat = (index.codes_t, index.ids, index.list_start, index.list_len,
            luts, list_ids)
    if backend == "seg":
        if (index.codes_tiled is not None
                and index.codes_tiled.shape[2] == seg):
            return scan_lists_seg_block(
                index.codes_tiled, index.ids, index.list_start,
                index.list_len, luts, list_ids,
                windows=windows, seg=seg, group=max(group, 1),
                lut_bf16=lut_bf16, select_l1=select_l1, lane_l1=lane_l1,
                slot_major=slot_major, **sel)
        if group > 1:
            return scan_lists_seg_multi(
                *flat, windows=windows, seg=seg, group=group,
                lut_bf16=lut_bf16, select_l1=select_l1, lane_l1=lane_l1,
                **sel)
        return scan_lists_seg(*flat, windows=windows, seg=seg,
                              lut_bf16=lut_bf16, select_l1=select_l1, **sel)
    if backend == "pallas":
        return scan_lists_pallas(*flat, scan_len=scan_len, tile=tile, **sel)
    return scan_lists_xla(*flat, scan_len=scan_len, probe_chunk=probe_chunk,
                          **sel)


def _pallas_or_xla(backend: str, scan_len: int) -> str:
    """``backend``, or "xla" with a warning where the padded-window scan
    cannot take ``scan_len``."""
    if backend == "pallas" and scan_len % GROUP:
        warnings.warn(
            f"backend='pallas' needs scan_len % {GROUP} == 0 (the kernel's "
            f"window is a whole number of {GROUP}-row groups); got "
            f"scan_len={scan_len} — falling back to the xla scan",
            stacklevel=3)
        return "xla"
    return backend


@fp32_matmul()
def _rotate(index: DeviceIVF, q: torch.Tensor) -> torch.Tensor:
    return torch.matmul(q, index.opq_R) if index.opq_R is not None else q


@graphs.captured
@fp32_matmul()
def ivfpq_search(
    index: DeviceIVF,
    queries: torch.Tensor,      # (b, d) float32, on the index's device
    *,
    nprobe: int,
    k: int,
    scan_len: int = 0,
    windows: int = 0,
    seg: int = 1024,
    group: int = 1,
    probe_chunk: int = 8,
    by_residual: bool = True,
    use_approx: bool = True,
    recall_target: float = 0.99,
    backend: str = "seg",
    tile: int = 0,
    coarse_approx: bool = False,
    coarse_cand: int = 0,
    lut_bf16: bool = False,
    select_l1: int = 0,
    lane_l1: bool = False,
    slot_major: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full IVF-PQ search → ``(dists (b, k) f32, ids (b, k) int32)``.

    ``lut_bf16``: packed-bf16 ADC LUTs (seg backend).  ``lane_l1``:
    in-kernel per-(window, lane) min (seg backend, ``group > 1``).
    ``coarse_cand`` > 0 selects probes with the two-stage coarse scan.
    ``use_approx``/``recall_target``/``select_l1``/``coarse_approx`` keep
    the JAX package's contract; selection is exact.  ``tile`` is the
    "pallas" backend's chunk (accepted, not needed on the card).  With
    ``backend="pallas"`` and ``scan_len % 1024`` it warns and runs xla.
    """
    if backend == "seg" and windows <= 0:
        windows = 2 * nprobe       # conservative default; searcher sizes it
    backend = _pallas_or_xla(backend, scan_len)
    with tracing.annotate("search.coarse"):
        q = _rotate(index, queries)
        list_ids, _ = select_probes(q, index.centroids, nprobe,
                                    coarse_cand=coarse_cand,
                                    use_approx=coarse_approx)
    with tracing.annotate("search.lut"):
        luts = build_luts(q, index.centroids, index.codebooks, list_ids,
                          by_residual=by_residual)
    return _dispatch_scan(
        index, luts, list_ids, k=k, scan_len=scan_len, windows=windows,
        seg=seg, group=group, probe_chunk=probe_chunk, use_approx=use_approx,
        recall_target=recall_target, backend=backend, tile=tile,
        lut_bf16=lut_bf16 and backend == "seg", select_l1=select_l1,
        lane_l1=lane_l1 and group > 1, slot_major=slot_major)


@graphs.captured
@fp32_matmul()
def ivfpq_search_preassigned(
    index: DeviceIVF,
    queries: torch.Tensor,
    list_ids: torch.Tensor,     # (b, nprobe) int32 — external coarse scan
    *,
    k: int,
    nprobe: int,
    scan_len: int = 4096,
    windows: int = 0,
    seg: int = 1024,
    group: int = 1,
    by_residual: bool = True,
    use_approx: bool = True,
    recall_target: float = 0.99,
    backend: str = "seg",
    tile: int = 0,
    lut_bf16: bool = False,
    select_l1: int = 0,
    lane_l1: bool = False,
):
    """Search with externally supplied IVF cells (Faiss
    ``search_preassigned``)."""
    if backend == "seg" and windows <= 0:
        windows = 2 * nprobe
    backend = _pallas_or_xla(backend, scan_len)
    with tracing.annotate("search.coarse"):
        q = _rotate(index, queries)
    with tracing.annotate("search.lut"):
        luts = build_luts(q, index.centroids, index.codebooks, list_ids,
                          by_residual=by_residual)
    return _dispatch_scan(
        index, luts, list_ids, k=k, scan_len=scan_len, windows=windows,
        seg=seg, group=group, probe_chunk=min(8, nprobe),
        use_approx=use_approx, recall_target=recall_target, backend=backend,
        tile=tile, lut_bf16=lut_bf16 and backend == "seg",
        select_l1=select_l1, lane_l1=lane_l1 and group > 1)


def resolve_coarse_cand(cfg_cand: int, nlist: int, nprobe: int) -> int:
    """Resolve ``SearchConfig.coarse_cand`` to a concrete shortlist width:
    -1 (auto) enables the two-stage scan only at nlist ≥ 32768 and
    nprobe ≥ 8; an explicit width is floored at nprobe and capped at
    nlist."""
    if cfg_cand < 0:
        cfg_cand = (max(4 * nprobe, 64)
                    if nlist >= 32768 and nprobe >= 8 else 0)
    if cfg_cand <= 0:
        return 0
    return min(max(cfg_cand, nprobe), nlist)


def auto_seg(list_len: np.ndarray) -> int:
    """Power-of-two seg minimizing the length-weighted expected window cost
    ``Σ wᵢ·ceil(lenᵢ/seg)·(WINDOW_FIXED_ROWS + seg)`` (the JAX package's
    cost model, so both packages pick the same seg)."""
    lens = np.asarray(list_len, np.float64)
    total = lens.sum()
    if total <= 0:
        return 256
    w = lens / total
    best, best_cost = 256, np.inf
    seg = 256
    while seg <= MAX_SEG:
        cost = float((w * np.ceil(lens / seg)).sum()
                     * (WINDOW_FIXED_ROWS + seg))
        if cost < best_cost:
            best, best_cost = seg, cost
        seg *= 2
    return best


def auto_windows(list_len: np.ndarray, seg: int, nprobe: int,
                 headroom: float = 1.2, slack: int = 4,
                 z: float = 0.0) -> int:
    """Static per-query window budget for the segmented backend: the
    length-weighted mean of ceil(len/seg) per probe times nprobe, with
    ``headroom``/``slack`` (and an optional ``z``-sigma tail term), capped
    at the worst query's exact need ``nprobe·max(segs)`` and at the total
    window count."""
    lens = np.asarray(list_len, np.float64)
    segs = np.ceil(lens / seg)
    total = lens.sum()
    if not total:
        return slack
    w_mean = float((lens * segs).sum() / total)
    w_var = max(0.0, float((lens * segs * segs).sum() / total) - w_mean ** 2)
    w = int(np.ceil(max(
        nprobe * w_mean * headroom,
        nprobe * w_mean + z * np.sqrt(w_var * nprobe)))) + slack
    w_upper = int(nprobe * segs.max()) if segs.size else w
    return min(w, w_upper, int(segs.sum()))


class IVFSearcher:
    """Host-facing wrapper: holds the device index + static search config,
    exposes numpy-in/numpy-out ``search``.  ``device=None`` means the card;
    pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, index: PackedIVF, search_cfg: SearchConfig,
                 scan_quantile: float = 1.0, device=None):
        self.device = resolve_device(device)
        self.packed = index
        self.cfg = index.cfg
        self.scfg = search_cfg
        self.backend = search_cfg.backend
        self.tile = search_cfg.tile
        if self.backend in ("pallas", "seg") and index.cfg.nbits != 8:
            warnings.warn(
                f"backend='{self.backend}' kernels are specialized for 8-bit "
                f"PQ; index has nbits={index.cfg.nbits} — falling back to "
                "the xla scan", stacklevel=2)
            self.backend = "xla"
        self.seg = search_cfg.seg or auto_seg(index.list_len)
        self.dev = DeviceIVF.from_packed(
            index, device=self.device,
            tile_seg=(self.seg if search_cfg.tiled
                      and self.backend == "seg" else 0))
        self.group = search_cfg.seg_group
        self.windows = search_cfg.scan_windows or self._auto_windows(
            search_cfg.nprobe)
        self.scan_len = index.suggest_scan_len(search_cfg.nprobe,
                                               scan_quantile)
        # never let a window run past the packed array's tail padding
        max_scan = index.n_pad - int(index.list_start.max())
        self.scan_len = min(self.scan_len, max_scan)
        if self.backend == "pallas":
            # whole GROUP-row groups: round up if the tail padding allows,
            # else down (never below one group)
            up = -(-self.scan_len // GROUP) * GROUP
            self.scan_len = (up if up <= max_scan else
                             max(GROUP, self.scan_len - self.scan_len % GROUP))
            if self.tile == 0:
                self.tile = resolve_chunk(self.scan_len, 0)

    def _auto_windows(self, nprobe: int) -> int:
        return auto_windows(self.packed.list_len, self.seg, nprobe)

    def _windows(self, nprobe: int) -> int:
        return (self.windows if nprobe == self.scfg.nprobe
                else self._auto_windows(nprobe))

    def _queries(self, queries) -> torch.Tensor:
        return as_f32(queries, self.device)   # any strides, e.g. xq[::-1]

    def search(self, queries: np.ndarray,
               nprobe: Optional[int] = None,
               k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns ``(dists (b,k) f32, ids (b,k) int64)``."""
        np_ = nprobe or self.scfg.nprobe
        d, i = ivfpq_search(
            self.dev, self._queries(queries),
            nprobe=np_,
            k=k or self.scfg.k,
            scan_len=self.scan_len,
            windows=self._windows(np_),
            seg=self.seg, group=self.group,
            probe_chunk=self.scfg.probe_chunk,
            by_residual=self.cfg.by_residual,
            use_approx=self.scfg.use_approx_topk,
            recall_target=self.scfg.approx_recall_target,
            backend=self.backend, tile=self.tile,
            coarse_approx=self.scfg.coarse_approx,
            coarse_cand=resolve_coarse_cand(self.scfg.coarse_cand,
                                            self.cfg.nlist, np_),
            lut_bf16=self.scfg.lut_bf16,
            select_l1=self.scfg.select_l1,
            lane_l1=self.scfg.lane_l1,
        )
        return d.cpu().numpy(), i.cpu().numpy().astype(np.int64)

    def search_preassigned(self, queries: np.ndarray, list_ids: np.ndarray,
                           k: Optional[int] = None):
        li = torch.from_numpy(np.array(list_ids, np.int32)).to(self.device)
        np_ = li.shape[1]
        d, i = ivfpq_search_preassigned(
            self.dev, self._queries(queries), li,
            k=k or self.scfg.k, nprobe=np_,
            scan_len=self.scan_len,
            windows=self._windows(np_),
            seg=self.seg, group=self.group,
            by_residual=self.cfg.by_residual,
            use_approx=self.scfg.use_approx_topk,
            recall_target=self.scfg.approx_recall_target,
            backend=self.backend, tile=self.tile,
            lut_bf16=self.scfg.lut_bf16,
            select_l1=self.scfg.select_l1,
            lane_l1=self.scfg.lane_l1,
        )
        return d.cpu().numpy(), i.cpu().numpy().astype(np.int64)
