"""Mesh-sharded IVF-PQ search: a scan per list shard and an exact top-k
merge (the port of ``chamjax/parallel/sharded_search.py``).

Inverted lists go to shards by a greedy longest-first row balance; every
shard keeps a full ``(nlist,)`` start/len table in which foreign lists have
length 0, so window expansion gives them no windows.  The OPQ rotation, the
coarse scan and the LUTs run once (1-D layout) or once per ``data`` row on
that row's slice of the batch (2-D layout), on the row's first position;
then each shard scans its lists on its own position through the
single-device searcher's scan dispatch (``searcher._dispatch_scan``, one
call a shard, so the routes are chosen in one place), the ``S`` local ``(b, k)`` results are gathered
to the row's first position (``mesh.all_gather_to``) and an exact
``torch.topk`` over ``S·k`` candidates merges them, in the JAX package's
candidate order.

Positions on other mesh axes (a ``tp`` axis beside ``data`` and ``lists``)
hold replicas of a shard; the search runs each (row, shard) once, on the
position whose other coordinates are 0, where ``shard_map`` would run it on
every replica at once.

Where every position lies on one device the whole search (rotation, coarse,
LUTs, the S scans, the merge) is one CUDA graph, owned by the
``ShardedIVF`` and keyed as ``ivfpq_search``'s calls are.  Where positions
span cards it runs eagerly: one CUDA graph cannot span devices
(:func:`captures` says which).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from chamjax_torch.index.ivf import PackedIVF
from chamjax_torch.ops.coarse import select_probes
from chamjax_torch.ops.lut import build_luts
from chamjax_torch.ops.scan_seg import MAX_SEG
from chamjax_torch.parallel.mesh import Mesh, all_gather_to
from chamjax_torch.searcher import _dispatch_scan
from chamjax_torch.utils import graphs
from chamjax_torch.utils.precision import fp32_matmul

_SHARDED = ("codes_t", "ids", "list_start", "list_len", "codes_tiled")
_REPLICATED = ("centroids", "codebooks", "opq_R")


@dataclasses.dataclass(eq=False)
class ShardedIVF:
    """Per-shard index tensors: each sharded field is a sequence of ``S``
    tensors, one a shard.

    Exactly one of ``codes_t`` (flat CSR) and ``codes_tiled`` (seg-tiled)
    is set by the builders; tiled builds drop the flat twin.  ``list_start``
    is in the resident layout's coordinates (tile-aligned when tiled) and
    ``ids`` are the index's global ids, int32.

    ``place_sharded`` returns a placed copy: shard ``s`` on the positions
    whose ``axis`` coordinate is ``s`` (one copy a distinct device), the
    replicated tensors on every device of the mesh; the fields then hold
    the copies at the positions whose other coordinates are 0.  ``graphs``
    holds the captured searches over it.
    """

    centroids: torch.Tensor                         # (nlist, d)
    codebooks: torch.Tensor                         # (m, ksub, dsub)
    codes_t: Optional[Sequence[torch.Tensor]]       # S × (m, n_pad_sh) u8
    ids: Sequence[torch.Tensor]                     # S × (n_pad_sh,) int32
    list_start: Sequence[torch.Tensor]              # S × (nlist,) int32
    list_len: Sequence[torch.Tensor]                # S × (nlist,) int32
    codes_tiled: Optional[Sequence[torch.Tensor]] = None  # S × (T, m, seg)
    opq_R: Optional[torch.Tensor] = None            # (d, d)
    mesh: Optional[Mesh] = None
    axis: str = "lists"
    # (shard, device) → that shard's tensors there (a namespace with the
    # sharded fields, as ``_dispatch_scan`` reads them); device → replicated
    copies: Dict = dataclasses.field(default_factory=dict, repr=False)
    replicas: Dict = dataclasses.field(default_factory=dict, repr=False)
    graphs: graphs.Graphs = dataclasses.field(
        default_factory=graphs.Graphs, repr=False)

    @property
    def n_shards(self) -> int:
        return len(self.ids)

    def shard(self, s: int, device: torch.device) -> types.SimpleNamespace:
        """Shard ``s``'s tensors on ``device`` (a placed index)."""
        return self.copies[(s, device)]

    def replicated(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The centroids, codebooks and rotation on ``device``."""
        return self.replicas[device]


def _pad_unit_load(ln: int, pad_unit: int) -> int:
    # max(ln, 1): the pack loop advances one pad_unit slot even for an
    # empty list; counting it as 0 under-sizes the shard (an overrun when a
    # shard collects many empty lists) and piles every empty list on one
    # shard (argmin never moves on +0)
    return -(-max(ln, 1) // pad_unit) * pad_unit


def shard_index(index: PackedIVF, n_shards: int, tail_pad: int = 8192,
                tile_seg: int = 0) -> ShardedIVF:
    """Split a packed index into ``n_shards`` row-balanced shards, on the
    host (tensors on the CPU; ``place_sharded`` moves them).

    Lists go longest first to the lightest shard.  ``tile_seg`` > 0 packs
    every list on ``tile_seg`` boundaries and emits the seg-tiled
    ``codes_tiled`` layout, dropping the flat twin: the production mesh
    path.  The layouts are the JAX package's, bit for bit."""
    nlist = index.cfg.nlist
    pad_unit = tile_seg if tile_seg else index.cfg.list_pad
    tail = max(tail_pad, MAX_SEG)
    order = np.argsort(-index.list_len, kind="stable")
    loads = np.zeros(n_shards, np.int64)
    owner = np.zeros(nlist, np.int32)
    for l in order:
        s = int(np.argmin(loads))
        owner[l] = s
        loads[s] += _pad_unit_load(int(index.list_len[l]), pad_unit)
    n_pad_sh = int(loads.max()) + tail
    if tile_seg:
        n_pad_sh = -(-n_pad_sh // tile_seg) * tile_seg
    # the id space is int32: a shard past ~2.1B padded rows would wrap
    if n_pad_sh >= 2 ** 31:
        raise ValueError(
            f"a shard of {n_pad_sh} padded rows overflows the int32 id "
            "space; raise n_shards or use the streamed tier")

    m = index.codes.shape[1]
    codes_t = np.zeros((n_shards, m, n_pad_sh), np.uint8)
    ids = np.full((n_shards, n_pad_sh), -1, np.int32)
    list_start = np.zeros((n_shards, nlist), np.int32)
    list_len = np.zeros((n_shards, nlist), np.int32)
    cursor = np.zeros(n_shards, np.int64)
    for l in range(nlist):
        s = int(owner[l])
        src, ln = int(index.list_start[l]), int(index.list_len[l])
        dst = int(cursor[s])
        codes_t[s, :, dst:dst + ln] = index.codes[src:src + ln].T
        ids[s, dst:dst + ln] = index.ids[src:src + ln]
        list_start[s, l] = dst
        list_len[s, l] = ln
        cursor[s] += _pad_unit_load(ln, pad_unit)
    codes_tiled = None
    if tile_seg:
        codes_tiled = np.ascontiguousarray(
            codes_t.reshape(n_shards, m, n_pad_sh // tile_seg, tile_seg)
            .transpose(0, 2, 1, 3))
        codes_t = None

    def per_shard(a):
        return None if a is None else tuple(torch.from_numpy(a).unbind(0))

    return ShardedIVF(
        centroids=torch.from_numpy(np.array(index.centroids, np.float32)),
        codebooks=torch.from_numpy(np.array(index.codebooks, np.float32)),
        codes_t=per_shard(codes_t), ids=per_shard(ids),
        list_start=per_shard(list_start), list_len=per_shard(list_len),
        codes_tiled=per_shard(codes_tiled),
        opq_R=(torch.from_numpy(np.array(index.opq_R, np.float32))
               if index.opq_R is not None else None))


def place_sharded(sh: ShardedIVF, mesh: Mesh, axis: str = "lists"
                  ) -> ShardedIVF:
    """Put shard ``s`` on every device that holds a position whose ``axis``
    coordinate is ``s``, and the centroids, codebooks and rotation on every
    device of the mesh (copies; a shard already there is not copied)."""
    if mesh.shape.get(axis) != sh.n_shards:
        raise ValueError(f"{sh.n_shards} shards on a mesh whose {axis!r} "
                         f"axis has {mesh.shape.get(axis)} positions")
    ax = mesh.axis_names.index(axis)
    copies, replicas = {}, {}
    for pos in np.ndindex(*mesh.devices.shape):
        dev, s = mesh.devices[pos], pos[ax]
        if (s, dev) not in copies:
            copies[(s, dev)] = types.SimpleNamespace(**{
                f: (getattr(sh, f)[s].to(dev)
                    if getattr(sh, f) is not None else None)
                for f in _SHARDED})
        if dev not in replicas:
            replicas[dev] = {f: (getattr(sh, f).to(dev)
                                 if getattr(sh, f) is not None else None)
                             for f in _REPLICATED}
    first = [copies[(s, mesh.device_at(**{axis: s}))]
             for s in range(sh.n_shards)]
    home = replicas[mesh.device_at()]
    return ShardedIVF(
        **{f: (tuple(getattr(c, f) for c in first)
               if getattr(sh, f) is not None else None) for f in _SHARDED},
        **home, mesh=mesh, axis=axis, copies=copies, replicas=replicas)


def captures(mesh: Mesh) -> bool:
    """Whether a search over ``mesh`` runs as one captured CUDA graph: on a
    card, with every position on that card."""
    return mesh.one_device and mesh.device_at().type == "cuda"


def _shard_window_budget(windows: int, windows_shard: int, nprobe: int,
                         group: int) -> int:
    """A shard's window budget for the seg routes.

    By default (``windows_shard=0``) the full global budget: foreign lists
    have length 0 and so no windows, so a shard's demand for a query is a
    subset of the global demand and never truncates more than the global
    search would.  A smaller budget drops the last windows of queries whose
    probes fall on one shard (lists go to shards by size, not locality);
    ``windows_shard`` sets it, trading that risk for a smaller scan a shard
    where the build is balanced (every list one segment: demand ≤
    nprobe)."""
    if windows_shard:
        return max(group, windows_shard)
    return max(group, windows, nprobe)


@fp32_matmul()
def _search_impl(sh, queries, *, mesh, axis, batch_axis, nprobe, k,
                 scan_len, windows, windows_shard, seg, group, by_residual,
                 use_approx, backend, lut_bf16, select_l1, lane_l1,
                 coarse_cand):
    w_sh = _shard_window_budget(windows, windows_shard, nprobe, group)
    rows = mesh.shape[batch_axis] if batch_axis else 1
    S = mesh.shape[axis]
    bl = queries.shape[0] // rows
    out = []
    for r in range(rows):
        row = {batch_axis: r} if batch_axis else {}
        home = mesh.device_at(**row)
        rep = sh.replicated(home)
        q = queries[r * bl:(r + 1) * bl].to(home)
        if rep["opq_R"] is not None:
            # centroids and codebooks live in rotated space; the caller's
            # queries (and the ground truth) do not
            q = torch.matmul(q, rep["opq_R"])
        list_ids, _ = select_probes(q, rep["centroids"], nprobe,
                                    coarse_cand=coarse_cand)
        luts = build_luts(q, rep["centroids"], rep["codebooks"], list_ids,
                          by_residual=by_residual)
        local = []
        for s in range(S):
            dev = mesh.device_at(**row, **{axis: s})
            local.append(_dispatch_scan(
                sh.shard(s, dev), luts.to(dev), list_ids.to(dev), k=k,
                scan_len=scan_len, windows=w_sh, seg=seg, group=group,
                probe_chunk=8, use_approx=use_approx, recall_target=0.99,
                backend=backend, tile=2048, lut_bf16=lut_bf16,
                select_l1=select_l1, lane_l1=lane_l1))
        # the merge: shard-major candidates per query, as the JAX package's
        # all_gather + moveaxis, then an exact top-k (the L2 queue)
        flat_d = torch.cat(all_gather_to([d for d, _ in local], home), dim=1)
        flat_i = torch.cat(all_gather_to([i for _, i in local], home), dim=1)
        vals, pos = torch.topk(flat_d, k, dim=1, largest=False, sorted=True)
        out.append((vals, torch.gather(flat_i, 1, pos)))
    dev = queries.device
    return (torch.cat(all_gather_to([d for d, _ in out], dev)),
            torch.cat(all_gather_to([i for _, i in out], dev)))


def _search(sh: ShardedIVF, queries: torch.Tensor, *, mesh: Mesh,
            batch_axis: Optional[str], **kw) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    if sh.mesh is not mesh:
        raise ValueError("the ShardedIVF is not placed on this mesh; call "
                         "place_sharded(sh, mesh) first")
    if kw["backend"] != "seg" and sh.codes_t is None:
        raise ValueError(
            f"backend={kw['backend']!r} needs the flat codes_t layout, but "
            "this ShardedIVF is tiled-only (built with tile_seg>0)")
    if (sh.codes_tiled is not None and sh.codes_t is None
            and sh.codes_tiled[0].shape[2] != kw["seg"]):
        raise ValueError(
            f"seg={kw['seg']} on an index tiled at "
            f"{sh.codes_tiled[0].shape[2]}: the tiled scan reads windows of "
            "the tile width")
    if kw["axis"] != sh.axis:
        raise ValueError(f"the index is sharded over {sh.axis!r}, not "
                         f"{kw['axis']!r}")
    rows = mesh.shape[batch_axis] if batch_axis else 1
    if queries.shape[0] % rows:
        raise ValueError(f"a batch of {queries.shape[0]} does not split over "
                         f"{rows} {batch_axis!r} positions")
    if captures(mesh):
        return graphs.call(sh.graphs, _search_impl, sh, queries, mesh=mesh,
                           batch_axis=batch_axis, **kw)
    with graphs.disable_capture():
        return _search_impl(sh, queries, mesh=mesh, batch_axis=batch_axis,
                            **kw)


def sharded_search(
    sh: ShardedIVF,
    queries: torch.Tensor,        # (b, d) float32
    *,
    mesh: Mesh,
    axis: str = "lists",
    nprobe: int,
    k: int,
    scan_len: int = 0,
    windows: int = 0,
    windows_shard: int = 0,
    seg: int = 512,
    group: int = 8,
    by_residual: bool = True,
    use_approx: bool = True,
    backend: str = "pallas",
    lut_bf16: bool = False,
    select_l1: int = 0,
    lane_l1: bool = False,
    coarse_cand: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-D mesh search over a placed ``ShardedIVF`` → ``(dists (b, k) f32,
    ids (b, k) int32)`` on the queries' device.

    Rotation, coarse scan and LUTs run once; each shard scans its lists;
    the merge is an exact top-k over the gathered ``S·k`` candidates.  A
    tiled ``ShardedIVF`` runs ``backend="seg"`` on the tiled scan
    (``adc_scan_tiles``); ``"pallas"`` and ``"xla"`` need the flat layout
    and raise ``ValueError`` on a tiled-only index.  ``windows_shard``
    sets each shard's window budget on the seg routes (0: the full budget,
    :func:`_shard_window_budget`); ``"pallas"`` and ``"xla"`` ignore it.
    ``use_approx`` keeps the JAX package's contract; selection is exact."""
    return _search(sh, queries, mesh=mesh, batch_axis=None, axis=axis,
                   nprobe=nprobe, k=k, scan_len=scan_len, windows=windows,
                   windows_shard=windows_shard, seg=seg, group=group,
                   by_residual=by_residual, use_approx=use_approx,
                   backend=backend, lut_bf16=lut_bf16, select_l1=select_l1,
                   lane_l1=lane_l1, coarse_cand=coarse_cand)


def sharded_search_2d(
    sh: ShardedIVF,
    queries: torch.Tensor,        # (b, d) float32, b divisible by the data size
    *,
    mesh: Mesh,
    axis: str = "lists",
    batch_axis: str = "data",
    nprobe: int,
    k: int,
    scan_len: int = 0,
    windows: int = 0,
    windows_shard: int = 0,
    seg: int = 512,
    group: int = 8,
    by_residual: bool = True,
    use_approx: bool = True,
    backend: str = "seg",
    lut_bf16: bool = False,
    select_l1: int = 0,
    lane_l1: bool = False,
    coarse_cand: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D mesh search: the batch split over ``batch_axis`` (row ``r`` takes
    queries ``[r·b/D, (r+1)·b/D)``), the lists over ``axis``.  Each row runs
    the rotation, coarse scan and LUTs on its own queries only, its shards
    scan them, and the merge gathers along ``axis`` within the row.  Returns
    the rows in order, on the queries' device."""
    return _search(sh, queries, mesh=mesh, batch_axis=batch_axis, axis=axis,
                   nprobe=nprobe, k=k, scan_len=scan_len, windows=windows,
                   windows_shard=windows_shard, seg=seg, group=group,
                   by_residual=by_residual, use_approx=use_approx,
                   backend=backend, lut_bf16=lut_bf16, select_l1=select_l1,
                   lane_l1=lane_l1, coarse_cand=coarse_cand)
