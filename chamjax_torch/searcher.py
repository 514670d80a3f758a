"""End-to-end IVF-PQ search (the port of ``chamjax/searcher.py``).

The query path — OPQ rotation → coarse scan → LUT construction → window
expansion → ADC scan over the seg-tiled codes (the CUDA kernel of
``csrc/adc_scan_tiles.cu``) → top-k → row→id map — runs on one device,
with no host round trip between the stages.
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
from chamjax_torch.ops.scan_seg import MAX_SEG, WINDOW_FIXED_ROWS
from chamjax_torch.ops.scan_seg_block import scan_lists_seg_block
from chamjax_torch.ops.scan_xla import scan_lists_xla
from chamjax_torch.utils.device import resolve_device
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
    """

    centroids: torch.Tensor     # (nlist, d) f32
    codebooks: torch.Tensor     # (m, ksub, dsub) f32
    codes_t: torch.Tensor       # (m, n_pad + MAX_SEG) uint8 — transposed
    ids: torch.Tensor           # (n_pad + MAX_SEG,) int32
    list_start: torch.Tensor    # (nlist,) int32
    list_len: torch.Tensor      # (nlist,) int32
    opq_R: Optional[torch.Tensor] = None        # (d, d) f32 or None
    codes_tiled: Optional[torch.Tensor] = None  # (n_tiles, m, seg) uint8

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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to chamjax_torch yet (ROADMAP.md, kernels "
        f"queue: {item})")


def _dispatch_scan(index: DeviceIVF, luts, list_ids, *, k, scan_len,
                   windows, seg, group, probe_chunk, use_approx,
                   recall_target, backend, lut_bf16=False, select_l1=0,
                   lane_l1=False, slot_major=True):
    if backend == "seg":
        if (index.codes_tiled is not None
                and index.codes_tiled.shape[2] == seg):
            return scan_lists_seg_block(
                index.codes_tiled, index.ids, index.list_start,
                index.list_len, luts, list_ids,
                windows=windows, seg=seg, group=max(group, 1), k=k,
                use_approx=use_approx, recall_target=recall_target,
                lut_bf16=lut_bf16, select_l1=select_l1, lane_l1=lane_l1,
                slot_major=slot_major)
        raise _not_ported(
            "the flat-layout seg scan (no tiled twin at this seg)",
            "adc_scan_segments_multi / adc_scan_segments")
    if backend == "pallas":
        raise _not_ported("backend='pallas'", "adc_scan_distances")
    return scan_lists_xla(
        index.codes_t, index.ids, index.list_start, index.list_len,
        luts, list_ids,
        scan_len=scan_len, probe_chunk=probe_chunk, k=k,
        use_approx=use_approx, recall_target=recall_target)


@fp32_matmul()
def _rotate(index: DeviceIVF, q: torch.Tensor) -> torch.Tensor:
    return torch.matmul(q, index.opq_R) if index.opq_R is not None else q


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
    the JAX package's contract; selection is exact.  ``tile`` belongs to
    the unported "pallas" backend.
    """
    if backend == "seg" and windows <= 0:
        windows = 2 * nprobe       # conservative default; searcher sizes it
    q = _rotate(index, queries)
    list_ids, _ = select_probes(q, index.centroids, nprobe,
                                coarse_cand=coarse_cand,
                                use_approx=coarse_approx)
    luts = build_luts(q, index.centroids, index.codebooks, list_ids,
                      by_residual=by_residual)
    return _dispatch_scan(
        index, luts, list_ids, k=k, scan_len=scan_len, windows=windows,
        seg=seg, group=group, probe_chunk=probe_chunk, use_approx=use_approx,
        recall_target=recall_target, backend=backend,
        lut_bf16=lut_bf16 and backend == "seg", select_l1=select_l1,
        lane_l1=lane_l1 and group > 1, slot_major=slot_major)


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
    q = _rotate(index, queries)
    luts = build_luts(q, index.centroids, index.codebooks, list_ids,
                      by_residual=by_residual)
    return _dispatch_scan(
        index, luts, list_ids, k=k, scan_len=scan_len, windows=windows,
        seg=seg, group=group, probe_chunk=min(8, nprobe),
        use_approx=use_approx, recall_target=recall_target, backend=backend,
        lut_bf16=lut_bf16 and backend == "seg", select_l1=select_l1,
        lane_l1=lane_l1 and group > 1)


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
        if self.backend == "pallas":
            raise _not_ported("backend='pallas'", "adc_scan_distances")
        if self.backend == "seg" and index.cfg.nbits != 8:
            warnings.warn(
                f"backend='seg' kernels are specialized for 8-bit PQ; index "
                f"has nbits={index.cfg.nbits} — using the xla scan",
                stacklevel=2)
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

    def _auto_windows(self, nprobe: int) -> int:
        return auto_windows(self.packed.list_len, self.seg, nprobe)

    def _windows(self, nprobe: int) -> int:
        return (self.windows if nprobe == self.scfg.nprobe
                else self._auto_windows(nprobe))

    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(np.asarray(queries, np.float32)).to(
            self.device)

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
        li = torch.as_tensor(np.asarray(list_ids, np.int32)).to(self.device)
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
