"""Tensor- and data-parallel placement of the models (the port of
``chamjax/parallel/sharded_model.py``).

The JAX package places the stacked-layer parameters with ``NamedSharding``
and lets GSPMD insert the collectives.  Here the placement builds a
:class:`~chamjax_torch.models.transformer.TPParams`: the replicated
parameters on each dp row's first position and, on every (dp, tp)
position, that tp position's slices; the family's steps
(``decoder_step``, ``decoder_prefill``, ``encoder_forward``,
``build_cross_kv``, ``llama_step``, ``llama_prefill``) see the type and run
their tensor-parallel cores, so the serving loops call them unchanged.
The grid is the mesh's ``dp`` × ``tp`` positions at 0 on every other axis
(a ``lists`` axis beside them holds the index's shards).

Attention is split by heads, so the heads must divide the tp size; where a
GSPMD layout would cut a head or an FFN column block unevenly, the
placement raises instead.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from chamjax_torch.models.llama import LlamaParams
from chamjax_torch.models.kimi_linear import KimiLinearParams
from chamjax_torch.models.mla_moe import MlaMoeParams
from chamjax_torch.models.transformer import (KVCache, ShardedKVCache,
                                              TPParams, TransformerParams)
from chamjax_torch.parallel.mesh import Mesh
from chamjax_torch.utils import graphs


def _grid(mesh: Mesh, dp_axis: str, tp_axis: str
          ) -> List[List[torch.device]]:
    """Devices of the (dp, tp) positions, every other axis at 0."""
    shape = mesh.shape
    dp, tp = shape.get(dp_axis, 1), shape.get(tp_axis, 1)

    def at(i, j):
        c = {a: v for a, v in ((dp_axis, i), (tp_axis, j)) if a in shape}
        return mesh.device_at(**c)
    return [[at(i, j) for j in range(tp)] for i in range(dp)]


def _holder(tensors: Dict[str, torch.Tensor], device) -> nn.Module:
    """A module whose parameters are ``tensors`` on ``device`` (the same
    storage where they lie there already)."""
    m = nn.Module()
    for name, t in tensors.items():
        if isinstance(t, dict):
            setattr(m, name, nn.ParameterDict({
                k: nn.Parameter(v.to(device), requires_grad=False)
                for k, v in t.items()}))
        else:
            setattr(m, name, nn.Parameter(t.to(device), requires_grad=False))
    return m


def _place(grid, shared: Dict, rank_slices: List[Dict]) -> TPParams:
    """``TPParams`` with one module a distinct (kind, device): the
    replicated ``shared`` on each row's first position, rank ``j``'s
    ``rank_slices[j]`` on each (i, j)."""
    made: Dict[Tuple, nn.Module] = {}

    def once(key, tensors, device):
        if (key, device) not in made:
            made[(key, device)] = _holder(tensors, device)
        return made[(key, device)]
    shared_rows = [once("shared", shared, row[0]) for row in grid]
    rank_grid = [[once(j, rank_slices[j], dev) for j, dev in enumerate(row)]
                 for row in grid]
    return TPParams(shared_rows, rank_grid)


def _cols(w: torch.Tensor, j: int, n: int) -> torch.Tensor:
    """Column block ``j`` of ``n`` of a stacked (L, in, out) weight (or of
    a stacked (L, out) bias), contiguous."""
    size = w.shape[-1] // n
    return w[..., j * size:(j + 1) * size].contiguous()


def _rows(w: torch.Tensor, j: int, n: int) -> torch.Tensor:
    """Row block ``j`` of ``n`` of a stacked (L, in, out) weight."""
    size = w.shape[1] // n
    return w[:, j * size:(j + 1) * size].contiguous()


def _need_split(what: str, width: int, tp: int) -> None:
    if width % tp:
        raise ValueError(f"{what} of width {width} does not split over "
                         f"tp={tp}")


@torch.no_grad()
def shard_decoder_params(params: TransformerParams, mesh: Mesh,
                         tp_axis: str = "tp", dp_axis: str = "dp"
                         ) -> TPParams:
    """Place a decoder's (or an encoder's) parameters over ``mesh``: q, k
    and v split by heads over ``tp_axis`` (each its own third of the fused
    ``wqkv``: the fused matrix's contiguous column blocks would give
    position 0 all of q and part of k), ``wo`` and ``w2`` by rows, ``w1``
    and ``b1`` by columns, the cross-attention's ``wq`` and its ``wkv``
    (k, then v) by heads and its ``wo`` by rows; embeddings, norms, the
    output projection and ``b2`` replicated, one copy a dp row.  A step
    raises where the heads do not divide the tp size.  The ``deepseek_v3``
    and ``kimi_linear`` families (``MlaMoeParams``, ``KimiLinearParams``)
    have no such form and raise here."""
    if isinstance(params, (MlaMoeParams, KimiLinearParams)):
        raise NotImplementedError(
            f"shard_decoder_params: the {params.cfg.model_type} family "
            f"(latent attention, routed experts) runs on one device; it has "
            f"no tensor-parallel or mesh form")
    grid = _grid(mesh, dp_axis, tp_axis)
    tp = len(grid[0])
    L = params.layers
    d = L.wqkv.shape[1]
    _need_split("attention", d, tp)
    _need_split("the FFN", L.w1.shape[-1], tp)
    shared = dict(embed=params.embed, pos=params.pos,
                  ln_f=dict(params.ln_f.items()), out_proj=params.out_proj,
                  ln1_scale=L.ln1_scale, ln1_bias=L.ln1_bias,
                  ln2_scale=L.ln2_scale, ln2_bias=L.ln2_bias, b2=L.b2)
    q, k, v = torch.chunk(L.wqkv, 3, dim=-1)
    C = params.cross_layers
    if C is not None:
        shared.update(c_ln_scale=C.ln_scale, c_ln_bias=C.ln_bias)
        ck, cv = torch.chunk(C.wkv, 2, dim=-1)
    ranks = []
    for j in range(tp):
        r = dict(wq=_cols(q, j, tp), wk=_cols(k, j, tp), wv=_cols(v, j, tp),
                 wo=_rows(L.wo, j, tp), w1=_cols(L.w1, j, tp),
                 b1=_cols(L.b1, j, tp), w2=_rows(L.w2, j, tp))
        if C is not None:
            r.update(cwq=_cols(C.wq, j, tp), cwk=_cols(ck, j, tp),
                     cwv=_cols(cv, j, tp), cwo=_rows(C.wo, j, tp))
        ranks.append(r)
    return _place(grid, shared, ranks)


@torch.no_grad()
def shard_kv_cache(cache: KVCache, mesh: Mesh, dp_axis: str = "dp",
                   tp_axis: str = "tp") -> ShardedKVCache:
    """Split a cache over ``mesh``: the batch over ``dp_axis``, the heads
    over ``tp_axis``, or every head on each tp position where they do not
    split (GQA caches may carry fewer KV heads than tp).  Copies; the
    result owns fresh graphs and keeps ``host_idx``."""
    grid = _grid(mesh, dp_axis, tp_axis)
    dp, tp = len(grid), len(grid[0])
    b, heads = cache.k.shape[1], cache.k.shape[3]
    if b % dp:
        raise ValueError(f"a batch of {b} does not split over dp={dp}")
    bl = b // dp
    split = heads % tp == 0
    hr = heads // tp if split else heads

    def part(t, i, j):
        t = t[:, i * bl:(i + 1) * bl]
        if split:
            t = t[:, :, :, j * hr:(j + 1) * hr]
        return graphs.state(t.to(grid[i][j]).clone(
            memory_format=torch.contiguous_format))

    def grid_of(t):
        return tuple(tuple(part(t, i, j) for j in range(tp))
                     for i in range(dp))
    idx = tuple(tuple(graphs.state(cache.idx.to(grid[i][j]).clone())
                      for j in range(tp)) for i in range(dp))
    return ShardedKVCache(k=grid_of(cache.k), v=grid_of(cache.v), idx=idx,
                          host_idx=cache.host_idx, graphs=graphs.Graphs())


@torch.no_grad()
def shard_llama_params(params: LlamaParams, mesh: Mesh, tp_axis: str = "tp",
                       kv_heads: int = 0, head_dim: int = 0,
                       dp_axis: str = "dp") -> TPParams:
    """Megatron placement of the llama stack: q, k, v and the FFN's w1/w3
    by columns over ``tp_axis``, ``wo`` and ``w2`` by rows, norms and
    embeddings replicated.  K/V are split only when whole KV heads land on
    each position, a test on the head count (``kv_heads``; 0 infers it as
    the JAX package does: equal q and kv widths are multi-head attention,
    tested on ``q_out // head_dim`` where ``head_dim`` is given, else on
    the width; unequal widths with no count replicate), never on the
    flattened width alone where the count is known: one KV head split
    across positions would need the collectives the placement avoids."""
    grid = _grid(mesh, dp_axis, tp_axis)
    tp = len(grid[0])
    L = params.layers
    q_out, kv_out = L.wq.shape[-1], L.wk.shape[-1]
    _need_split("the query heads", q_out, tp)
    _need_split("the FFN", L.w1.shape[-1], tp)
    if kv_heads:
        kv_split = kv_heads % tp == 0
    elif kv_out == q_out:
        kv_split = ((q_out // head_dim) % tp == 0 if head_dim
                    else kv_out % tp == 0)
    else:
        kv_split = False
    shared = dict(embed=params.embed, ln_f=params.ln_f,
                  out_proj=params.out_proj, ln1=L.ln1, ln2=L.ln2)

    def kv(w, j):
        return _cols(w, j, tp) if kv_split else w
    ranks = [dict(wq=_cols(L.wq, j, tp), wk=kv(L.wk, j), wv=kv(L.wv, j),
                  wo=_rows(L.wo, j, tp), w1=_cols(L.w1, j, tp),
                  w3=_cols(L.w3, j, tp), w2=_rows(L.w2, j, tp))
             for j in range(tp)]
    return _place(grid, shared, ranks)
