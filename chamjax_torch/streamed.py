"""Host-streamed IVF-PQ serving for corpora larger than device memory (the
port of ``chamjax/streamed.py``).

The packed code and id arrays stay in host RAM (or a read-only memmap);
the card holds only the small tables (centroids, codebooks, list tables)
plus each batch's staged window slab:

    coarse scan + window table (card) → pull (starts, lens)
    → host gathers the probed ``(bW, seg, m)`` code windows into a pinned
      buffer → asynchronous copy to the card
    → ADC scan over the staged slab → top-k positions (card)
    → host maps positions back to ids

Ids never cross to the card: the scan returns top-k *positions* in the
staged slab, and the host maps ``position → window → global row → id``
against its own id array, in its own dtype (int32 or int64), with no copy.

The host gather is ``chamjax_torch.native.gather_codes`` (one memcpy a
window, straight into the pinned staging buffer), as in the reference; where
the native library cannot build, a numpy gather takes its place, as the
reference falls back to its Python loop.  ``gather_path`` records which
one the searcher runs.

The staged scan runs ``adc_scan_tiles`` by default (``SearchConfig.tiled``:
each staged window is one ``(m, seg)`` tile, ``tile_idx = arange(bW)``),
or ``adc_scan_segments_multi`` over the slab viewed as a flat layout with
``tiled=False``.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from chamjax_torch import native
from chamjax_torch.config import SearchConfig
from chamjax_torch.index.ivf import PackedIVF
from chamjax_torch.ops.coarse import select_probes
from chamjax_torch.ops.lut import build_luts
from chamjax_torch.ops.scan_seg import MAX_SEG, expand_windows, prepare_luts
from chamjax_torch.ops.scan_seg_block import adc_scan_tiles
from chamjax_torch.ops.scan_seg_multi import adc_scan_segments_multi
from chamjax_torch.ops.topk import select_topk
from chamjax_torch.searcher import auto_seg, auto_windows, resolve_coarse_cand
from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul


@fp32_matmul()
def plan_windows(
    queries: torch.Tensor,      # (b, d) f32
    centroids: torch.Tensor,    # (nlist, d) f32
    list_start: torch.Tensor,   # (nlist,) i32
    list_len: torch.Tensor,     # (nlist,) i32
    opq_R: Optional[torch.Tensor],
    *,
    nprobe: int,
    windows: int,
    seg: int,
    coarse_cand: int = 0,
    use_approx: bool = False,
):
    """Device phase 1: coarse scan + window table.  Returns ``(starts,
    lens, probe, list_ids, q_rot)``; starts/lens are global row offsets
    into the host-resident packed arrays."""
    q = torch.matmul(queries, opq_R) if opq_R is not None else queries
    list_ids, _ = select_probes(q, centroids, nprobe,
                                coarse_cand=coarse_cand,
                                use_approx=use_approx)
    starts, lens, probe, _valid = expand_windows(
        list_ids, list_start, list_len, windows=windows, seg=seg)
    return starts, lens, probe, list_ids, q


def scan_staged(
    slab_codes: torch.Tensor,   # (bW, seg, m) uint8 — staged windows
    lens: torch.Tensor,         # (b, W) int32
    probe: torch.Tensor,        # (b, W) int32
    list_ids: torch.Tensor,     # (b, nprobe) int32
    q_rot: torch.Tensor,        # (b, d) f32, already OPQ-rotated
    centroids: torch.Tensor,
    codebooks: torch.Tensor,
    *,
    nprobe: int,
    k: int,
    seg: int,
    group: int,
    use_approx: bool = True,
    recall_target: float = 0.99,
    by_residual: bool = True,
    lut_bf16: bool = False,
    select_l1: int = 0,
    tiled: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device phase 2: ADC over the staged slab + selection.  Returns
    ``(best_d (b, k) f32, pos (b, k) int32)``; ``pos`` indexes each
    query's ``W·seg`` window-major candidate rows (padding slots are
    +inf; the host masks them to -1).  Rows of a window past its length
    may hold stale bytes of an earlier batch: nothing reads them."""
    b, windows = lens.shape
    bw = b * windows
    m = slab_codes.shape[-1]
    luts = build_luts(q_rot, centroids, codebooks, list_ids,
                      by_residual=by_residual)
    luts_k, lut_idx = prepare_luts(luts, probe, lut_bf16=lut_bf16)
    flat_lens = lens.reshape(-1).contiguous()
    if tiled:
        tiles = slab_codes.permute(0, 2, 1).contiguous()      # (bW, m, seg)
        dists = adc_scan_tiles(
            tiles, torch.arange(bw, dtype=torch.int32,
                                device=slab_codes.device),
            flat_lens, lut_idx, luts_k, seg=seg, group=group,
            lut_bf16=lut_bf16)
    else:
        codes_t = torch.nn.functional.pad(
            slab_codes.permute(2, 0, 1).reshape(m, bw * seg), (0, MAX_SEG))
        v_starts = torch.arange(bw, dtype=torch.int32,
                                device=slab_codes.device) * seg
        dists = adc_scan_segments_multi(
            codes_t, v_starts, flat_lens, lut_idx, luts_k, seg=seg,
            group=group, lut_bf16=lut_bf16)
    best_d, pos = select_topk(dists.reshape(b, windows * seg), k,
                              use_approx=use_approx,
                              recall_target=recall_target, l1=select_l1)
    return best_d, pos


class HostStreamedSearcher:
    """Numpy-in/numpy-out searcher over a host-resident packed index.

    ``packed.codes``/``packed.ids`` may be plain arrays or read-only
    memmaps: nothing corpus-sized is uploaded, only each batch's probed
    code windows.  ``packed.ids`` keeps its dtype and is never copied.
    ``device=None`` means the card; ``device="cpu"`` runs the same path on
    the CPU (the scans then run their plain versions).

    Staging uses two pinned host buffers in turn.  The copy of a buffer to
    the card is asynchronous, so before the host gathers into a buffer
    again it waits on the CUDA event recorded after the copy that last
    read it.

    ``gather``: ``"auto"`` takes the native gather where the library
    builds and the numpy gather where it does not; ``"native"`` raises
    ``NativeUnavailable`` instead of falling back; ``"numpy"`` always
    takes numpy.  ``gather_path`` says which one runs.  The two fill the
    rows past a window's length differently (zeros / the rows that follow
    it); nothing reads them, so the results are bit-equal."""

    def __init__(self, packed: PackedIVF, scfg: SearchConfig,
                 seg: int = 0, device=None, gather: str = "auto"):
        self.device = resolve_device(device)
        if gather not in ("auto", "native", "numpy"):
            raise ValueError(f"gather={gather!r}: auto, native or numpy")
        if gather == "native":
            native.load()
        self.gather_path = ("native" if gather == "native" or (
            gather == "auto" and native.available()) else "numpy")
        self.scfg = scfg
        self.cfg = packed.cfg
        if packed.cfg.nbits != 8:
            # the scan kernels take 8-bit codes and this tier has no xla
            # fallback
            raise ValueError(
                f"HostStreamedSearcher requires nbits=8 PQ codes (got "
                f"nbits={packed.cfg.nbits}); use IVFSearcher's xla "
                "backend for nbits != 8")
        if scfg.lane_l1:
            warnings.warn(
                "HostStreamedSearcher ignores SearchConfig.lane_l1 (not "
                "supported by the staged scan)", stacklevel=2)
        self.seg = seg or scfg.seg or auto_seg(packed.list_len)
        self.windows = scfg.scan_windows or auto_windows(
            packed.list_len, self.seg, scfg.nprobe)
        self.group = max(1, scfg.seg_group)   # 0/neg = no grouping
        self.windows += (-self.windows) % self.group
        self.tiled = bool(scfg.tiled)

        def put(a, dtype):
            return torch.tensor(np.asarray(a, dtype), device=self.device)

        self.centroids = put(packed.centroids, np.float32)
        self.codebooks = put(packed.codebooks, np.float32)
        self.list_start = put(packed.list_start, np.int32)
        self.list_len = put(packed.list_len, np.int32)
        self.opq_R = (put(packed.opq_R, np.float32)
                      if packed.opq_R is not None else None)
        # codes stay (n_pad, m) row-major: a window is a contiguous row range
        self.codes = packed.codes
        self.ids = packed.ids          # original dtype, never copied
        self.n_pad = packed.codes.shape[0]
        self._bufs: List[Optional[torch.Tensor]] = [None, None]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]

    def warm(self, chunk_rows: int = 1 << 20) -> None:
        """Touch the code/id arrays sequentially to populate the page cache
        (memmap) or fault in RAM, so the first searches do not pay for
        cold random window reads."""
        m = self.codes.shape[1]
        code_stride = max(1, 4096 // m)     # ≥1 touch per 4 KiB page
        acc = 0
        for s in range(0, self.n_pad, chunk_rows):
            e = min(s + chunk_rows, self.n_pad)
            acc += int(self.codes[s:e:code_stride, 0].sum())
            acc += int(self.ids[s:e:1024].sum())
        self._warmed = acc  # keep the reads from being skipped

    def _buffer(self, slot: int, shape) -> torch.Tensor:
        """Host staging buffer ``slot`` viewed as ``shape`` uint8 (pinned
        when the searcher runs on the card), grown as needed.  Waits until
        the last copy out of it has finished."""
        n = int(np.prod(shape))
        buf = self._bufs[slot]
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
            self._bufs[slot] = buf
        elif self._copied[slot] is not None:
            self._copied[slot].synchronize()
        return buf[:n].view(shape)

    def _gather(self, starts: np.ndarray, lens: np.ndarray,
                slot: int) -> torch.Tensor:
        """Host gather of the probed code windows into staging buffer
        ``slot``: ``(bW, seg, m)`` u8.  A window takes ``seg`` rows from
        its start (cut at the array's end); nothing reads the rows past its
        length.  The native gather zero-fills them and the windows of
        length 0; the numpy gather copies every window's ``seg`` rows, the
        last row repeated past the array's end."""
        host = self._buffer(slot, (starts.size, self.seg, self.cfg.m))
        if self.gather_path == "native":
            native.gather_codes(self.codes, starts, lens, self.seg,
                                out=host.numpy())
            return host
        rows = (starts.reshape(-1).astype(np.int64)[:, None]
                + np.arange(self.seg, dtype=np.int64))
        np.take(self.codes, rows, axis=0, out=host.numpy(), mode="clip")
        return host

    def _upload(self, host: torch.Tensor, slot: int) -> torch.Tensor:
        """Asynchronous copy of staging buffer ``slot`` to the device."""
        if self.device.type != "cuda":
            return host     # the scan runs before this buffer is reused
        slab = host.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._copied[slot] = ev
        return slab

    def _stage(self, starts: np.ndarray, lens: np.ndarray,
               slot: int = 0) -> torch.Tensor:
        """Gather a batch's windows on the host and start their copy:
        returns the device slab ``(bW, seg, m)`` u8."""
        return self._upload(self._gather(starts, lens, slot), slot)

    @staticmethod
    def _pull_windows(plan) -> Tuple[np.ndarray, np.ndarray]:
        """A plan's ``(starts, lens)`` on the host, in one copy."""
        both = torch.stack((plan[0], plan[1])).cpu().numpy()
        return both[0], both[1]

    def _plan(self, queries: np.ndarray):
        q = as_f32(queries, self.device)
        return plan_windows(
            q, self.centroids, self.list_start, self.list_len, self.opq_R,
            nprobe=self.scfg.nprobe, windows=self.windows, seg=self.seg,
            coarse_cand=resolve_coarse_cand(
                self.scfg.coarse_cand, self.centroids.shape[0],
                self.scfg.nprobe),
            use_approx=self.scfg.coarse_approx)

    def _scan(self, slab, lens, probe, list_ids, q_rot, k: int):
        return scan_staged(
            slab, lens, probe, list_ids, q_rot, self.centroids,
            self.codebooks, nprobe=self.scfg.nprobe, k=k, seg=self.seg,
            group=self.group, use_approx=self.scfg.use_approx_topk,
            recall_target=self.scfg.approx_recall_target,
            by_residual=self.cfg.by_residual, lut_bf16=self.scfg.lut_bf16,
            select_l1=self.scfg.select_l1, tiled=self.tiled)

    def _map_ids(self, d: np.ndarray, pos: np.ndarray,
                 starts: np.ndarray) -> np.ndarray:
        """Host side of the position protocol: ``pos`` (b, k) indexes the
        per-query window-major candidate rows; map through the window
        table to global rows and look ids up in their own dtype."""
        win = pos // self.seg
        off = pos % self.seg
        rows = np.take_along_axis(starts.astype(np.int64), win, axis=1) + off
        rows = np.clip(rows, 0, self.n_pad - 1)
        ids = np.asarray(self.ids[rows.reshape(-1)], np.int64)
        return np.where(np.isfinite(d), ids.reshape(pos.shape), -1)

    def search(self, queries: np.ndarray, k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns ``(dists (b, k) f32, ids (b, k) int64)``."""
        k = k or self.scfg.k
        plan = self._plan(queries)
        starts_h, lens_h = self._pull_windows(plan)
        slab = self._stage(starts_h, lens_h)
        _starts, lens, probe, list_ids, q_rot = plan
        d, pos = self._scan(slab, lens, probe, list_ids, q_rot, k)
        d = d.cpu().numpy()
        return d, self._map_ids(d, pos.cpu().numpy(), starts_h)

    def search_pipelined(self, batches, k: Optional[int] = None):
        """Double-buffered serving over a stream of query batches: batch
        i+1's host gather overlaps batch i's scan on the card.  Batch
        i+1's window table is planned and pulled before scan i is
        enqueued, so the pull never waits behind the scan; results are
        pulled once at the end.  Returns a list of ``(dists, ids)`` numpy
        pairs, equal to mapping :meth:`search` over ``batches``."""
        k = k or self.scfg.k
        batches = list(batches)
        if not batches:
            return []
        outs = []
        plan = self._plan(batches[0])
        starts_h, lens_h = self._pull_windows(plan)
        slab = self._stage(starts_h, lens_h, slot=0)
        for i in range(len(batches)):
            next_plan = next_windows = None
            if i + 1 < len(batches):
                next_plan = self._plan(batches[i + 1])
                next_windows = self._pull_windows(next_plan)
            _starts, lens, probe, list_ids, q_rot = plan
            outs.append((self._scan(slab, lens, probe, list_ids, q_rot, k),
                         starts_h))
            if next_plan is not None:
                # gathers into the other buffer while the card scans batch i
                slab = self._stage(*next_windows, slot=(i + 1) % 2)
                plan, starts_h = next_plan, next_windows[0]
        res = []
        for (d, pos), st_h in outs:
            d = d.cpu().numpy()
            res.append((d, self._map_ids(d, pos.cpu().numpy(), st_h)))
        return res
