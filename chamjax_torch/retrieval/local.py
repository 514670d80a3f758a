"""In-process retrievers over the port's IVF-PQ search (the port of
``chamjax/retrieval/local.py``: ``LocalRetriever``, ``DeviceRetriever``,
``MeshRetriever`` and ``NativeCPURetriever``).

``retrieve`` takes and returns numpy arrays; ``retrieve_device`` takes a
tensor on the index's device and returns tensors there, so the RALM loop
chains decode → search with no host transfer.  Both run on the card unless
the caller asks for the CPU (``device="cpu"``).  On the card each search
is a replay of ``ivfpq_search``'s captured graph (``utils/graphs.py``),
owned by the index; the results are fresh tensors.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np

from chamjax_torch import native
from chamjax_torch.config import SearchConfig
from chamjax_torch.index.ivf import PackedIVF
from chamjax_torch.retrieval.interface import BaseRetriever, RetrievalResult
from chamjax_torch.searcher import (IVFSearcher, auto_seg, auto_windows,
                                    ivfpq_search, resolve_coarse_cand)
from chamjax_torch.utils import tracing
from chamjax_torch.utils.device import as_f32, resolve_device


class LocalRetriever(BaseRetriever):
    """``IVFSearcher`` behind the retriever contract; ``searcher_kwargs``
    (``scan_quantile``, ``device``) go to the searcher."""

    def __init__(self, index: PackedIVF,
                 search_cfg: Optional[SearchConfig] = None,
                 **searcher_kwargs):
        self._searcher_kwargs = searcher_kwargs
        self.searcher = IVFSearcher(index, search_cfg or SearchConfig(),
                                    **searcher_kwargs)

    @staticmethod
    def from_file(path: str, search_cfg: Optional[SearchConfig] = None,
                  **searcher_kwargs) -> "LocalRetriever":
        return LocalRetriever(PackedIVF.load(path), search_cfg,
                              **searcher_kwargs)

    def set_nprobe(self, nprobe: int) -> None:
        """Rebuilds the searcher so window budgets resize with nprobe,
        keeping the constructor's searcher kwargs (dropping ``device``
        would move the index to the default device)."""
        self.searcher = IVFSearcher(
            self.searcher.packed,
            dataclasses.replace(self.searcher.scfg, nprobe=nprobe),
            **self._searcher_kwargs)

    def retrieve(self, queries: np.ndarray, nprobe: int, k: int
                 ) -> RetrievalResult:
        dists, ids = self.searcher.search(queries, nprobe=nprobe, k=k)
        return RetrievalResult(ids=ids, dists=dists)

    def retrieve_device(self, queries, nprobe: int, k: int
                        ) -> RetrievalResult:
        """Fused path: a (b, d) float32 tensor on the index's device in,
        ``(ids (b,k) int32, dists (b,k) f32)`` tensors there out."""
        s = self.searcher
        np_ = nprobe or s.scfg.nprobe
        # the window budget tracks an nprobe override (as search does): a
        # budget sized for scfg.nprobe would truncate the scan
        with tracing.annotate("retrieve"):
            d, i = ivfpq_search(
                s.dev, queries,
                nprobe=np_, k=k or s.scfg.k,
                scan_len=s.scan_len, windows=s._windows(np_), seg=s.seg,
                group=s.group, probe_chunk=s.scfg.probe_chunk,
                by_residual=s.cfg.by_residual,
                use_approx=s.scfg.use_approx_topk,
                recall_target=s.scfg.approx_recall_target,
                backend=s.backend, tile=s.tile,
                coarse_approx=s.scfg.coarse_approx,
                coarse_cand=resolve_coarse_cand(s.scfg.coarse_cand,
                                                s.cfg.nlist, np_),
                lut_bf16=s.scfg.lut_bf16, select_l1=s.scfg.select_l1,
                lane_l1=s.scfg.lane_l1,
            )
        return RetrievalResult(ids=i, dists=d)

    def retrieve_with_lists(self, queries: np.ndarray, list_ids: np.ndarray,
                            k: int) -> RetrievalResult:
        dists, ids = self.searcher.search_preassigned(queries, list_ids, k=k)
        return RetrievalResult(ids=ids, dists=dists)


class DeviceRetriever(BaseRetriever):
    """Retriever over an index already on the device (a ``DeviceIVF`` with
    no host ``PackedIVF`` behind it), plus the host list-length table the
    window budget is sized from.  The same contract as ``LocalRetriever``,
    the fused ``retrieve_device`` included.  ``device`` must be the
    index's (the card unless ``"cpu"``)."""

    def __init__(self, dev, list_len: np.ndarray,
                 search_cfg: Optional[SearchConfig] = None, device=None):
        self.device = resolve_device(device)
        if dev.centroids.device != self.device:
            raise ValueError(f"DeviceRetriever: index on "
                             f"{dev.centroids.device}, device={self.device}")
        self.dev = dev
        self.list_len = np.asarray(list_len)
        self.scfg = search_cfg or SearchConfig()
        if self.scfg.backend != "seg":
            # no PackedIVF behind this tier to size the other backends'
            # scan_len: say so instead of running another kernel silently
            warnings.warn(
                f"DeviceRetriever always uses backend='seg' (no host "
                f"PackedIVF to size scan_len for "
                f"backend={self.scfg.backend!r})", stacklevel=2)
        # a tiled index fixes seg at its tile width (another seg would scan
        # the flat layout instead); otherwise the config's, or auto-sized
        self.seg = (int(dev.codes_tiled.shape[2])
                    if dev.codes_tiled is not None
                    else self.scfg.seg or auto_seg(self.list_len))
        self.windows = auto_windows(self.list_len, self.seg, self.scfg.nprobe)

    def _search(self, q, nprobe, k):
        np_ = nprobe or self.scfg.nprobe
        W = (self.windows if np_ == self.scfg.nprobe
             else auto_windows(self.list_len, self.seg, np_))
        return ivfpq_search(
            self.dev, q, nprobe=np_, k=k or self.scfg.k,
            windows=W, seg=self.seg, group=self.scfg.seg_group,
            probe_chunk=self.scfg.probe_chunk,
            by_residual=True, use_approx=self.scfg.use_approx_topk,
            recall_target=self.scfg.approx_recall_target,
            backend="seg", coarse_approx=self.scfg.coarse_approx,
            coarse_cand=resolve_coarse_cand(
                self.scfg.coarse_cand, self.dev.centroids.shape[0], np_),
            lut_bf16=self.scfg.lut_bf16, select_l1=self.scfg.select_l1,
            lane_l1=self.scfg.lane_l1)

    def retrieve(self, queries: np.ndarray, nprobe: int, k: int
                 ) -> RetrievalResult:
        d, i = self._search(as_f32(queries, self.device), nprobe, k)
        return RetrievalResult(ids=i.cpu().numpy().astype(np.int64),
                               dists=d.cpu().numpy())

    def retrieve_device(self, queries, nprobe: int, k: int
                        ) -> RetrievalResult:
        with tracing.annotate("retrieve"):
            d, i = self._search(queries, nprobe, k)
        return RetrievalResult(ids=i, dists=d)


class MeshRetriever(BaseRetriever):
    """Retriever over a mesh-sharded index: a placed
    :class:`~chamjax_torch.parallel.sharded_search.ShardedIVF` (lists over
    ``axis``, and the batch over ``batch_axis`` when given: the 2-D
    layout) behind the same contract as ``LocalRetriever``, the fused
    ``retrieve_device`` included, so the RALM and tik-tok loops serve from
    the mesh unchanged.  ``list_len`` is the host (nlist,) length table the
    window budget is sized from.  Always ``backend="seg"``: the tiled scan
    on a tiled index, the flat multi-window scan otherwise."""

    def __init__(self, sh, mesh, list_len: np.ndarray,
                 search_cfg: Optional[SearchConfig] = None,
                 axis: str = "lists", batch_axis: Optional[str] = None):
        self.sh = sh
        self.mesh = mesh
        self.axis = axis
        self.batch_axis = batch_axis
        self.list_len = np.asarray(list_len)
        self.scfg = search_cfg or SearchConfig()
        self.seg = (self.scfg.seg
                    or (int(sh.codes_tiled[0].shape[-1])
                        if sh.codes_tiled is not None
                        else auto_seg(self.list_len)))
        self.group = max(1, self.scfg.seg_group)
        self.windows = self._rounded(self.scfg.scan_windows or auto_windows(
            self.list_len, self.seg, self.scfg.nprobe))

    def _rounded(self, w: int) -> int:
        return w + (-w) % self.group      # the group divides the budget

    def _search(self, q, nprobe, k):
        from chamjax_torch.parallel.sharded_search import (sharded_search,
                                                           sharded_search_2d)
        np_ = nprobe or self.scfg.nprobe
        kw = dict(mesh=self.mesh, axis=self.axis, nprobe=np_,
                  k=k or self.scfg.k,
                  windows=(self.windows if np_ == self.scfg.nprobe
                           else self._rounded(auto_windows(
                               self.list_len, self.seg, np_))),
                  seg=self.seg, group=self.group,
                  use_approx=self.scfg.use_approx_topk, backend="seg",
                  lut_bf16=self.scfg.lut_bf16,
                  select_l1=self.scfg.select_l1, lane_l1=self.scfg.lane_l1,
                  coarse_cand=resolve_coarse_cand(
                      self.scfg.coarse_cand, self.sh.centroids.shape[0],
                      np_))
        if self.batch_axis:
            return sharded_search_2d(self.sh, q, batch_axis=self.batch_axis,
                                     **kw)
        return sharded_search(self.sh, q, **kw)

    def retrieve(self, queries: np.ndarray, nprobe: int, k: int
                 ) -> RetrievalResult:
        d, i = self._search(as_f32(queries, self.mesh.device_at()), nprobe,
                            k)
        return RetrievalResult(ids=i.cpu().numpy().astype(np.int64),
                               dists=d.cpu().numpy())

    def retrieve_device(self, queries, nprobe: int, k: int
                        ) -> RetrievalResult:
        """A (b, d) float32 tensor in, ``(ids, dists)`` tensors out on its
        device."""
        d, i = self._search(queries, nprobe, k)
        return RetrievalResult(ids=i, dists=d)


class NativeCPURetriever(BaseRetriever):
    """The host (C++) engine behind the retriever contract: the reference's
    ``FaissServer`` CPU mode.  The same packed index as ``LocalRetriever``,
    with f32 LUTs: the same distances to float tolerance; no card
    needed."""

    def __init__(self, index: PackedIVF,
                 search_cfg: Optional[SearchConfig] = None):
        self.engine = native.NativeIVFPQ(index)
        self.scfg = search_cfg or SearchConfig()

    def set_nprobe(self, nprobe: int) -> None:
        self.scfg = dataclasses.replace(self.scfg, nprobe=nprobe)

    def retrieve(self, queries: np.ndarray, nprobe: int, k: int
                 ) -> RetrievalResult:
        dists, ids = self.engine.search(queries, nprobe or self.scfg.nprobe,
                                        k or self.scfg.k)
        return RetrievalResult(ids=ids, dists=dists)

    def retrieve_with_lists(self, queries: np.ndarray, list_ids: np.ndarray,
                            k: int) -> RetrievalResult:
        dists, ids = self.engine.search_preassigned(queries, list_ids,
                                                    k or self.scfg.k)
        return RetrievalResult(ids=ids, dists=dists)

    def close(self) -> None:
        self.engine.close()
