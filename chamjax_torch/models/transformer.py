"""Transformer decoder / encoder-decoder with explicit KV caches (the port
of ``chamjax/models/transformer.py``).

Parameters are ``nn.Module`` containers whose parameter names are the JAX
package's (``wqkv``, ``ln1_scale``, ``wkv``, …), with every layer's weights
stacked along a leading ``(layers, ...)`` axis as there, so
``models/convert.py`` is a name map.  The forward passes are functions with
the JAX entry points and their return triple ``(logits, hidden, cache)``,
and follow the JAX arithmetic op for op: layernorm, softmax and attention
scores in f32, everything else in the parameters' dtype, the casts in the
same places.

The KV cache is written in place at ``idx`` (the port's form of the JAX
package's donated cache), and ``idx`` stays a 0-d int32 tensor on the
cache's device.  Each step and prefill is a host shell around a device core:
the shell checks the room left in the cache from the host-side count
``KVCache.host_idx`` and advances it; the core, which reads no device value
on the host, computes the step, writes the cache in place and is captured
in a CUDA graph on the card (``utils/graphs.py``, the counterpart of the
JAX package's ``jit``), owned by the cache.  ``encoder_forward`` and
``build_cross_kv`` are captured whole, owned by their parameters.  Past
``max_seq_len`` the JAX package clamps the position gather and the cache
write silently; here the step raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from chamjax_torch import random as jr
from chamjax_torch.config import ModelConfig
from chamjax_torch.utils import graphs
from chamjax_torch.utils.collectives import all_gather_to, all_reduce_sum
from chamjax_torch.utils.device import resolve_device

Key = jr.Key       # a seed, or two uint32 words (``chamjax_torch.random``)


class KVCache(NamedTuple):
    """Self-attention cache: one stacked buffer per stack of layers.  ``k``,
    ``v`` and ``idx`` are graph state (read and written in place); the
    cache owns the graphs of the steps run on it."""

    k: torch.Tensor       # (layers, b, max_len, heads, head_dim)
    v: torch.Tensor       # (layers, b, max_len, heads, head_dim)
    idx: torch.Tensor     # () int32 on the cache's device — cached positions
    host_idx: int = 0     # the same count, kept on the host
    graphs: Optional[graphs.Graphs] = None


class ShardedKVCache(NamedTuple):
    """A KV cache over a data × tensor-parallel grid
    (``parallel/sharded_model.py::shard_kv_cache``): ``k[i][j]``,
    ``v[i][j]`` and ``idx[i][j]`` lie on grid position (i, j)'s device and
    hold dp slice ``i`` of the batch and tp position ``j``'s heads (every
    head where they do not split over tp).  All are graph state; the cache
    owns the graphs of the tensor-parallel steps run on it."""

    k: tuple
    v: tuple
    idx: tuple
    host_idx: int = 0
    graphs: Optional[graphs.Graphs] = None


def leaves(x) -> list:
    """The tensors of a tensor or of nested tuples of them (a cache's
    fields, a tensor-parallel cross K/V)."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in leaves(y)]


def _max_len(cache) -> int:
    return leaves(cache.k)[0].shape[2]


# ---------------------------------------------------------------------------
# Parameter containers
# ---------------------------------------------------------------------------


def _param(shape, fill: float, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, device=device, dtype=dtype),
                        requires_grad=False)


class LayerStack(nn.Module):
    """Self-attention + FFN weights of ``n_layers`` layers, stacked."""

    def __init__(self, cfg: ModelConfig, n_layers: int, *, device, dtype):
        super().__init__()
        d, f, L = cfg.embed_dim, cfg.ffn_embed_dim, n_layers
        kw = dict(device=device, dtype=dtype)
        self.ln1_scale = _param((L, d), 1.0, **kw)
        self.ln1_bias = _param((L, d), 0.0, **kw)
        self.wqkv = _param((L, d, 3 * d), 0.0, **kw)
        self.wo = _param((L, d, d), 0.0, **kw)
        self.ln2_scale = _param((L, d), 1.0, **kw)
        self.ln2_bias = _param((L, d), 0.0, **kw)
        self.w1 = _param((L, d, f), 0.0, **kw)
        self.b1 = _param((L, f), 0.0, **kw)
        self.w2 = _param((L, f, d), 0.0, **kw)
        self.b2 = _param((L, d), 0.0, **kw)


class CrossStack(nn.Module):
    """Cross-attention weights of an encoder-decoder's decoder, stacked."""

    def __init__(self, cfg: ModelConfig, n_layers: int, *, device, dtype):
        super().__init__()
        d, L = cfg.embed_dim, n_layers
        kw = dict(device=device, dtype=dtype)
        self.ln_scale = _param((L, d), 1.0, **kw)
        self.ln_bias = _param((L, d), 0.0, **kw)
        self.wq = _param((L, d, d), 0.0, **kw)
        self.wkv = _param((L, d, 2 * d), 0.0, **kw)
        self.wo = _param((L, d, d), 0.0, **kw)


class TransformerParams(nn.Module):
    """Embeddings, the layer stack, the final layernorm and the output
    projection; ``cross_layers`` for an encoder-decoder's decoder, else
    None.  An encoder has ``n_out=1`` (it emits hidden states only)."""

    def __init__(self, cfg: ModelConfig, *, n_layers: int, n_out: int,
                 cross_attention: bool = False, device=None, dtype=None):
        super().__init__()
        d = cfg.embed_dim
        kw = dict(device=device, dtype=dtype)
        self.embed = _param((cfg.vocab_size, d), 0.0, **kw)
        self.pos = _param((cfg.max_seq_len, d), 0.0, **kw)
        self.layers = LayerStack(cfg, n_layers, **kw)
        self.ln_f = nn.ParameterDict({"scale": _param((d,), 1.0, **kw),
                                      "bias": _param((d,), 0.0, **kw)})
        self.out_proj = _param((d, n_out), 0.0, **kw)
        self.cross_layers = (CrossStack(cfg, n_layers, **kw)
                             if cross_attention else None)
        # the graphs of encoder_forward and build_cross_kv on these weights
        self.graphs = graphs.Graphs()


class TPParams(nn.Module):
    """A model's parameters over a data × tensor-parallel grid
    (``parallel/sharded_model.py`` builds it; the family's step functions
    choose their tensor-parallel core by this type).

    ``shared_rows[i]`` holds the replicated parameters (embeddings, norms,
    output projection, the row-parallel biases) on dp row ``i``'s first
    position; ``rank_grid[i][j]`` holds tp position ``j``'s slices on
    position (i, j).  A row's modules are one object where devices repeat,
    so a mesh on one device holds the weights once.  Row 0's modules are
    registered (``shared``, ``ranks``)."""

    def __init__(self, shared_rows, rank_grid):
        super().__init__()
        self.shared = shared_rows[0]
        self.ranks = nn.ModuleList(rank_grid[0])
        self.shared_rows = list(shared_rows)
        self.rank_grid = [list(r) for r in rank_grid]
        # the graphs of encoder_forward and build_cross_kv on these weights
        self.graphs = graphs.Graphs()

    @property
    def dp(self) -> int:
        return len(self.rank_grid)

    @property
    def tp(self) -> int:
        return len(self.rank_grid[0])

    @property
    def embed(self) -> torch.Tensor:
        return self.shared.embed

    def rank_device(self, i: int, j: int) -> torch.device:
        return next(self.rank_grid[i][j].parameters()).device

    @property
    def one_device(self) -> bool:
        """Whether every position lies on one device: only then is a step
        one CUDA graph."""
        return len({self.rank_device(i, j) for i in range(self.dp)
                    for j in range(self.tp)}
                   | {r.embed.device for r in self.shared_rows}) == 1


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@torch.no_grad()
def normal_(p: torch.Tensor, key: Key, scale: float) -> None:
    """Fill ``p`` with ``normal(key)·scale`` drawn in f32, then cast (the
    JAX package's init: the same draw from the same key)."""
    p.copy_(jr.normal(key, p.shape, scale=scale, device=p.device))


def _init_stack(stack: nn.Module, key: Key, cfg: ModelConfig,
                names: Tuple[str, ...]) -> None:
    """The stack's weights ``names`` from ``split(key, 6)`` (self-attention
    and FFN) or ``split(key, 4)`` (cross-attention), in the JAX package's
    order: ``w2`` at ``ffn_embed_dim ** -0.5``, the rest at ``embed_dim **
    -0.5``."""
    keys = jr.split(key, 6 if "w1" in names else 4)
    d, f = cfg.embed_dim, cfg.ffn_embed_dim
    for k, name in zip(keys, names):
        normal_(getattr(stack, name), k, f ** -0.5 if name == "w2"
                else d ** -0.5)


_SELF = ("wqkv", "wo", "w1", "w2")
_CROSS = ("wq", "wkv", "wo")


def init_decoder(key: Key, cfg: ModelConfig, cross_attention: bool = False,
                 device=None) -> TransformerParams:
    """Random decoder parameters from ``key`` (a seed or a key) on
    ``device`` (the card unless given ``"cpu"``): ``split(key, 5)`` gives
    the embeddings, positions, layers, output projection and cross
    layers, as in the JAX package, so a seed gives its parameters."""
    dev = resolve_device(device)
    params = TransformerParams(cfg, n_layers=cfg.layers,
                               n_out=cfg.vocab_size,
                               cross_attention=cross_attention, device=dev,
                               dtype=dtype_of(cfg))
    d = cfg.embed_dim
    k1, k2, k3, k4, k5 = jr.split(key, 5)
    normal_(params.embed, k1, d ** -0.5)
    normal_(params.pos, k2, 0.02)
    _init_stack(params.layers, k3, cfg, _SELF)
    normal_(params.out_proj, k4, d ** -0.5)
    if cross_attention:
        _init_stack(params.cross_layers, k5, cfg, _CROSS)
    return params


def init_encoder(key: Key, cfg: ModelConfig, device=None
                 ) -> TransformerParams:
    """Encoder parameters from ``split(key, 3)`` (embeddings, positions,
    layers); the output projection stays zero."""
    dev = resolve_device(device)
    params = TransformerParams(cfg, n_layers=cfg.encoder_layers, n_out=1,
                               device=dev, dtype=dtype_of(cfg))
    d = cfg.embed_dim
    k1, k2, k3 = jr.split(key, 3)
    normal_(params.embed, k1, d ** -0.5)
    normal_(params.pos, k2, 0.02)
    _init_stack(params.layers, k3, cfg, _SELF)
    return params


def init_encoder_decoder(key: Key, cfg: ModelConfig, device=None
                         ) -> Tuple[TransformerParams, TransformerParams]:
    dev = resolve_device(device)
    k1, k2 = jr.split(key)
    return (init_encoder(k1, cfg, device=dev),
            init_decoder(k2, cfg, cross_attention=True, device=dev))


def init_kv_cache(cfg: ModelConfig, batch: int,
                  max_len: Optional[int] = None, device=None) -> KVCache:
    h = cfg.attention_heads
    return _zero_cache(cfg, batch, max_len, h, cfg.embed_dim // h, device)


def _zero_cache(cfg: ModelConfig, batch: int, max_len: Optional[int],
                heads: int, hd: int, device) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.layers, batch, max_len or cfg.max_seq_len, heads, hd)
    kw = dict(device=dev, dtype=dtype_of(cfg))
    k, v, idx = graphs.state(
        torch.zeros(shape, **kw), torch.zeros(shape, **kw),
        torch.zeros((), dtype=torch.int32, device=dev))
    return KVCache(k=k, v=v, idx=idx, graphs=graphs.Graphs())


def reset_cache(cache: KVCache) -> KVCache:
    """Empty ``cache`` in place: zero K, V and ``idx`` on the device and the
    count on the host.  Its storage stays, so the graphs captured on it stay
    valid (the JAX package builds a fresh zero cache: the same values)."""
    for t in leaves((cache.k, cache.v, cache.idx)):
        t.zero_()
    return cache._replace(host_idx=0)


def state_of(cache: KVCache) -> Tuple[torch.Tensor, ...]:
    """The cache's device state, as a step's core takes it."""
    return cache.k, cache.v, cache.idx


def check_room(cache: KVCache) -> None:
    """Raise when the cache is full: the JAX package would clamp the write
    silently, a CUDA gather would assert on the device."""
    if cache.host_idx >= _max_len(cache):
        raise IndexError(f"KV cache full: {cache.host_idx} positions cached "
                         f"of max_len {_max_len(cache)}")


def write_column(kv, ks_new: torch.Tensor, vs_new: torch.Tensor) -> None:
    """Write the step's K/V columns ``(layers, b, 1, h, hd)`` at ``idx`` in
    place and advance ``idx`` on the device (``kv``: ``state_of(cache)``)."""
    k, v, idx = kv
    at = idx.long().reshape(1)
    k.index_copy_(2, at, ks_new)
    v.index_copy_(2, at, vs_new)
    idx.add_(1)


def check_prompt(cache: KVCache, t: int) -> None:
    if t > _max_len(cache):
        raise IndexError(f"prompt of {t} tokens past max_len "
                         f"{_max_len(cache)}")


def fill_prefix(kv, layer: int, kh: torch.Tensor, vh: torch.Tensor) -> None:
    """Prefill: write positions ``[0, t)`` of one layer in place."""
    t = kh.shape[1]
    kv[0][layer, :, :t] = kh
    kv[1][layer, :, :t] = vh


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def _ln(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)   # jnp.var: population
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def _gelu(x):
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def _split_heads(x, h):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h)


def _attn_full(q, k, v, causal: bool, valid_len=None):
    """q,k,v: (b, t, h, hd) → (b, t, h, hd); scores and softmax in f32."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    tq, tk = q.shape[1], k.shape[1]
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        scores = scores.masked_fill(~mask, float("-inf"))
    if valid_len is not None:   # per-batch key padding mask (b,)
        pos = torch.arange(tk, device=q.device)[None, None, None, :]
        scores = scores.masked_fill(pos >= valid_len[:, None, None, None],
                                    float("-inf"))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _ffn(x, L, i):
    y = _ln(x, L.ln2_scale[i], L.ln2_bias[i])
    return x + _gelu(y @ L.w1[i] + L.b1[i]) @ L.w2[i] + L.b2[i]


def _embed(params, tokens):
    return params.embed.index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, -1)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _decoder_prefill(params, tokens, kv, heads):
    """The device core of :func:`decoder_prefill`."""
    t = tokens.shape[1]
    h = heads
    x = _embed(params, tokens) + params.pos[:t][None]
    L = params.layers
    for i in range(L.wqkv.shape[0]):
        y = _ln(x, L.ln1_scale[i], L.ln1_bias[i])
        q, k, v = torch.chunk(y @ L.wqkv[i], 3, dim=-1)
        qh, kh, vh = (_split_heads(z, h) for z in (q, k, v))
        a = _attn_full(qh, kh, vh, causal=True)
        x = x + a.reshape(x.shape) @ L.wo[i]
        x = _ffn(x, L, i)
        fill_prefix(kv, i, kh, vh)
    kv[2].fill_(t)
    hidden = _ln(x, params.ln_f["scale"], params.ln_f["bias"])
    return hidden @ params.out_proj, hidden


@torch.no_grad()
def decoder_prefill(
    params: TransformerParams,
    tokens: torch.Tensor,         # (b, t) int
    cache: KVCache,
    heads: int,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Process a whole prompt; fill the cache in place. Returns
    ``(logits (b,t,V), hidden (b,t,d), cache)``."""
    t = tokens.shape[1]
    check_prompt(cache, t)
    if isinstance(params, TPParams):
        check_tp(params, cache, heads, tokens.shape[0])
        logits, hidden = tp_call(params, cache.graphs, _tp_decoder_prefill,
                                 params, tokens, state_of(cache), heads)
    else:
        logits, hidden = graphs.call(cache.graphs, _decoder_prefill, params,
                                     tokens, state_of(cache), heads)
    return logits, hidden, cache._replace(host_idx=t)


def _attend_step(qh, kh, vh, k_hist, v_hist, strict_mask):
    """One token's attention: ``qh``/``kh``/``vh`` (b, 1, h, hd) against the
    cached positions where ``strict_mask`` (T,) holds, and, in a separate
    term, against itself.  Returns (b, 1, h, hd) in the inputs' dtype."""
    T = k_hist.shape[1]
    hd = qh.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", qh.float(),
                          k_hist.float()) * hd ** -0.5
    scores = scores.masked_fill(~strict_mask.reshape(1, 1, 1, T),
                                float("-inf"))
    self_score = (qh * kh).float().sum(dim=-1) * hd ** -0.5  # (b, 1, h)
    self_score = self_score.transpose(1, 2)[:, :, :, None]   # (b,h,1,1)
    all_scores = torch.cat([scores, self_score], dim=-1)
    p = torch.softmax(all_scores, dim=-1).to(qh.dtype)
    return (torch.einsum("bhqk,bkhd->bqhd", p[..., :T], v_hist)
            + p[..., T:].transpose(1, 2) * vh)


def _decoder_step(params, tokens, kv, heads, cross_kv, cross_valid_len):
    """The device core of :func:`decoder_step`: reads no device value on
    the host, writes the cache in place and advances ``idx``."""
    k_cache, v_cache, idx = kv
    h = heads
    T = k_cache.shape[2]
    x = _embed(params, tokens) + params.pos.index_select(0, idx.reshape(1))
    x = x[:, None, :]                                       # (b, 1, d)
    strict_mask = torch.arange(T, device=x.device) < idx    # cached pos < idx
    L, C = params.layers, params.cross_layers
    ks_new, vs_new = [], []
    for i in range(L.wqkv.shape[0]):
        y = _ln(x, L.ln1_scale[i], L.ln1_bias[i])
        q, k, v = torch.chunk(y @ L.wqkv[i], 3, dim=-1)
        qh = _split_heads(q, h)                             # (b, 1, h, hd)
        kh = _split_heads(k, h)
        vh = _split_heads(v, h)
        a = _attend_step(qh, kh, vh, k_cache[i], v_cache[i], strict_mask)
        x = x + a.reshape(x.shape) @ L.wo[i]
        if cross_kv is not None:
            y = _ln(x, C.ln_scale[i], C.ln_bias[i])
            cq = _split_heads(y @ C.wq[i], h)
            ca = _attn_full(cq, cross_kv[0][i], cross_kv[1][i], causal=False,
                            valid_len=cross_valid_len)
            x = x + ca.reshape(x.shape) @ C.wo[i]
        x = _ffn(x, L, i)
        ks_new.append(kh)
        vs_new.append(vh)
    write_column(kv, torch.stack(ks_new), torch.stack(vs_new))
    hidden = _ln(x[:, 0, :], params.ln_f["scale"], params.ln_f["bias"])
    return hidden @ params.out_proj, hidden


@torch.no_grad()
def decoder_step(
    params: TransformerParams,
    tokens: torch.Tensor,         # (b,) int — one new token per sequence
    cache: KVCache,
    heads: int,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cross_valid_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """One incremental decode step. Returns ``(logits (b,V), hidden (b,d),
    cache)``; the cache is written in place and returned with ``idx``
    advanced.

    ``cross_kv``: stacked (layers, b, s, h, hd) K/V over retrieved-context
    encoder output — enc-dec mode only.

    As in the JAX package, the cache is only read inside the layer loop:
    each layer attends to the cached positions ``< idx`` and, in a separate
    term, to the current token; the new K/V columns are written after the
    loop.  The host checks the room left (a replay would not) and advances
    ``host_idx``; the rest is the captured core.
    """
    check_room(cache)
    if isinstance(params, TPParams):
        check_tp(params, cache, heads, tokens.shape[0])
        if cross_kv is not None and isinstance(cross_kv[0], torch.Tensor):
            raise ValueError("tensor-parallel parameters need the cross K/V "
                             "of their build_cross_kv")
        logits, hidden = tp_call(params, cache.graphs, _tp_decoder_step,
                                 params, tokens, state_of(cache), heads,
                                 cross_kv, cross_valid_len)
    else:
        logits, hidden = graphs.call(cache.graphs, _decoder_step, params,
                                     tokens, state_of(cache), heads,
                                     cross_kv, cross_valid_len)
    return logits, hidden, cache._replace(host_idx=cache.host_idx + 1)


# ---------------------------------------------------------------------------
# Encoder (enc-dec mode: encodes query tokens / retrieved tokens)
# ---------------------------------------------------------------------------


@torch.no_grad()
def encoder_forward(
    params: TransformerParams,
    tokens: torch.Tensor,         # (b, s) int
    heads: int,
    valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bidirectional encoder → hidden states (b, s, d); captured, owned by
    the parameters."""
    if isinstance(params, TPParams):
        return tp_call(params, params.graphs, _tp_encoder_forward, params,
                       tokens, heads, valid_len)
    return graphs.call(params.graphs, _encoder_forward, params, tokens,
                       heads, valid_len)


def _encoder_forward(params, tokens, heads, valid_len):
    s = tokens.shape[1]
    h = heads
    x = _embed(params, tokens) + params.pos[:s][None]
    L = params.layers
    for i in range(L.wqkv.shape[0]):
        y = _ln(x, L.ln1_scale[i], L.ln1_bias[i])
        q, k, v = torch.chunk(y @ L.wqkv[i], 3, dim=-1)
        a = _attn_full(_split_heads(q, h), _split_heads(k, h),
                       _split_heads(v, h), causal=False, valid_len=valid_len)
        x = x + a.reshape(x.shape) @ L.wo[i]
        x = _ffn(x, L, i)
    return _ln(x, params.ln_f["scale"], params.ln_f["bias"])


@torch.no_grad()
def build_cross_kv(
    dec_params: TransformerParams,
    enc_out: torch.Tensor,        # (b, s, d)
    heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-decoder-layer cross-attention K/V over the encoder output (done
    once per retrieval step, reused for ``retrieval_interval`` decode
    steps).  Returns ``(k, v)``, each (layers, b, s, h, hd); on
    ``TPParams``, each split over the grid (``_tp_build_cross_kv``).
    Captured, owned by the parameters."""
    if isinstance(dec_params, TPParams):
        return tp_call(dec_params, dec_params.graphs, _tp_build_cross_kv,
                       dec_params, enc_out, heads)
    return graphs.call(dec_params.graphs, _build_cross_kv, dec_params,
                       enc_out, heads)


def _build_cross_kv(dec_params, enc_out, heads):
    L, b, s = dec_params.cross_layers.wkv.shape[0], *enc_out.shape[:2]
    kv = enc_out[None] @ dec_params.cross_layers.wkv[:, None]  # (L,b,s,2d)
    k, v = torch.chunk(kv, 2, dim=-1)
    return (k.reshape(L, b, s, heads, -1), v.reshape(L, b, s, heads, -1))


# ---------------------------------------------------------------------------
# Tensor parallel: the cores the steps above run on ``TPParams``
# ---------------------------------------------------------------------------
#
# GSPMD inserts the JAX package's collectives; here they are explicit.
# Per dp row, on its first position: the norms, the residual stream and the
# row-parallel biases; per tp position: its heads of q, k and v (split by
# heads, never as contiguous columns of the fused wqkv, which would give
# rank 0 all of q and part of k), its rows of wo, its columns of w1 and b1,
# its rows of w2.  Each row-parallel product's partials come out in float32
# and are summed before one rounding (``tp_sum``): two all-reduces a layer,
# and one more after the cross-attention's wo.


def mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` accumulated in and returned as float32: a tp position's
    partial of a row-parallel product (bf16 operands on a card, float32 on
    the CPU, which has no bf16 product with a float32 result)."""
    if a.dtype == torch.float32:
        return a @ w
    if a.is_cuda:
        out = torch.mm(a.reshape(-1, a.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], w.shape[-1])
    return a.float() @ w.float()


def tp_sum(params: TPParams, i: int, y: torch.Tensor, partial
           ) -> torch.Tensor:
    """Dp row ``i``'s all-reduce of a row-parallel product: ``partial(j,
    rank, y_j)`` on each tp position ``j`` with ``y`` copied there, summed in
    float32 on ``y``'s device and rounded to ``y``'s dtype once."""
    parts = [partial(j, r, y.to(params.rank_device(i, j)))
             for j, r in enumerate(params.rank_grid[i])]
    return all_reduce_sum(parts, [y.device])[0].to(y.dtype)


def tp_call(params: TPParams, owner, fn, *args):
    """``graphs.call`` where every position lies on one device; eagerly
    otherwise, as one CUDA graph cannot span devices."""
    if params.one_device:
        return graphs.call(owner, fn, *args)
    with graphs.disable_capture():
        return fn(*args)


def tp_row(x: torch.Tensor, i: int, dp: int, device) -> torch.Tensor:
    """Dp row ``i``'s slice of the batch ``x``, on ``device``."""
    b = x.shape[0] // dp
    return x[i * b:(i + 1) * b].to(device)


def tp_gather(params: TPParams, rows) -> torch.Tensor:
    """The dp rows' outputs joined in order on the first position."""
    return torch.cat(all_gather_to(rows, params.embed.device))


def check_tp(params: TPParams, cache, heads: int, batch: int) -> None:
    """Raise unless ``cache`` is a ``ShardedKVCache`` over ``params``' grid
    and the batch and heads split over it."""
    if not isinstance(cache, ShardedKVCache):
        raise ValueError("tensor-parallel parameters need a ShardedKVCache "
                         "(parallel.shard_kv_cache)")
    if len(cache.k) != params.dp or len(cache.k[0]) != params.tp:
        raise ValueError(f"a {len(cache.k)}×{len(cache.k[0])} cache for a "
                         f"{params.dp}×{params.tp} grid")
    if heads % params.tp or batch % params.dp:
        raise ValueError(f"{heads} heads and a batch of {batch} do not "
                         f"split over tp={params.tp}, dp={params.dp}")


def _tp_block(params: TPParams, i: int, l: int, x, attn, cross=None):
    """Layer ``l`` of the decoder family on dp row ``i``: ``attn(j, rank,
    y)`` (and ``cross``) give a tp position's heads, (b, t, heads/tp·hd),
    which its rows of ``wo`` project to a partial."""
    S = params.shared_rows[i]
    y = _ln(x, S.ln1_scale[l], S.ln1_bias[l])
    x = x + tp_sum(params, i, y,
                   lambda j, r, yj: mm_f32(attn(j, r, yj), r.wo[l]))
    if cross is not None:
        y = _ln(x, S.c_ln_scale[l], S.c_ln_bias[l])
        x = x + tp_sum(params, i, y,
                       lambda j, r, yj: mm_f32(cross(j, r, yj), r.cwo[l]))
    y = _ln(x, S.ln2_scale[l], S.ln2_bias[l])
    return x + tp_sum(params, i, y, lambda j, r, yj: mm_f32(
        _gelu(yj @ r.w1[l] + r.b1[l]), r.w2[l])) + S.b2[l]


def _qkv(r, y, l, hr):
    return tuple(_split_heads(y @ w[l], hr) for w in (r.wq, r.wk, r.wv))


def _tp_decoder_prefill(params, tokens, kv, heads):
    """The tensor-parallel core of :func:`decoder_prefill`."""
    ks, vs, idxs = kv
    t, hr = tokens.shape[1], heads // params.tp
    logits, hidden = [], []
    for i in range(params.dp):
        S = params.shared_rows[i]
        x = (_embed(S, tp_row(tokens, i, params.dp, S.embed.device))
             + S.pos[:t][None])
        for l in range(S.ln1_scale.shape[0]):
            def attn(j, r, y):
                qh, kh, vh = _qkv(r, y, l, hr)
                fill_prefix((ks[i][j], vs[i][j]), l, kh, vh)
                return _attn_full(qh, kh, vh, causal=True).flatten(2)
            x = _tp_block(params, i, l, x, attn)
        for idx in idxs[i]:
            idx.fill_(t)
        h = _ln(x, S.ln_f["scale"], S.ln_f["bias"])
        logits.append(h @ S.out_proj)
        hidden.append(h)
    return tp_gather(params, logits), tp_gather(params, hidden)


def _tp_decoder_step(params, tokens, kv, heads, cross_kv, cross_valid_len):
    """The tensor-parallel core of :func:`decoder_step`: each tp position
    attends to its heads' slice of the cache and writes it in place."""
    ks, vs, idxs = kv
    hr = heads // params.tp
    logits, hidden = [], []
    for i in range(params.dp):
        S = params.shared_rows[i]
        home = S.embed.device
        idx = idxs[i][0].to(home)
        x = (_embed(S, tp_row(tokens, i, params.dp, home))
             + S.pos.index_select(0, idx.reshape(1)))[:, None, :]
        strict = [torch.arange(ks[i][j].shape[2], device=ks[i][j].device)
                  < idxs[i][j] for j in range(params.tp)]
        new = [([], []) for _ in range(params.tp)]
        for l in range(S.ln1_scale.shape[0]):
            def attn(j, r, y):
                qh, kh, vh = _qkv(r, y, l, hr)
                new[j][0].append(kh)
                new[j][1].append(vh)
                return _attend_step(qh, kh, vh, ks[i][j][l], vs[i][j][l],
                                    strict[j]).flatten(2)

            def cross(j, r, y):
                vl = (None if cross_valid_len is None else
                      tp_row(cross_valid_len, i, params.dp, y.device))
                return _attn_full(_split_heads(y @ r.cwq[l], hr),
                                  cross_kv[0][i][j][l], cross_kv[1][i][j][l],
                                  causal=False, valid_len=vl).flatten(2)
            x = _tp_block(params, i, l, x, attn,
                          cross if cross_kv is not None else None)
        for j in range(params.tp):
            write_column((ks[i][j], vs[i][j], idxs[i][j]),
                         torch.stack(new[j][0]), torch.stack(new[j][1]))
        h = _ln(x[:, 0, :], S.ln_f["scale"], S.ln_f["bias"])
        logits.append(h @ S.out_proj)
        hidden.append(h)
    return tp_gather(params, logits), tp_gather(params, hidden)


def _tp_encoder_forward(params, tokens, heads, valid_len):
    """The tensor-parallel core of :func:`encoder_forward`."""
    s, hr = tokens.shape[1], heads // params.tp
    out = []
    for i in range(params.dp):
        S = params.shared_rows[i]
        x = (_embed(S, tp_row(tokens, i, params.dp, S.embed.device))
             + S.pos[:s][None])
        for l in range(S.ln1_scale.shape[0]):
            def attn(j, r, y):
                vl = (None if valid_len is None else
                      tp_row(valid_len, i, params.dp, y.device))
                return _attn_full(*_qkv(r, y, l, hr), causal=False,
                                  valid_len=vl).flatten(2)
            x = _tp_block(params, i, l, x, attn)
        out.append(_ln(x, S.ln_f["scale"], S.ln_f["bias"]))
    return tp_gather(params, out)


def _tp_build_cross_kv(params, enc_out, heads):
    """The tensor-parallel core of :func:`build_cross_kv`: ``(k, v)``, each
    ``[i][j]`` (layers, b/dp, s, heads/tp, hd) on position (i, j)."""
    hr = heads // params.tp
    k, v = [], []
    for i in range(params.dp):
        kr, vr = [], []
        for j, r in enumerate(params.rank_grid[i]):
            e = tp_row(enc_out, i, params.dp, params.rank_device(i, j))
            shape = (r.cwk.shape[0], *e.shape[:2], hr, -1)
            kr.append((e[None] @ r.cwk[:, None]).reshape(shape))
            vr.append((e[None] @ r.cwv[:, None]).reshape(shape))
        k.append(tuple(kr))
        v.append(tuple(vr))
    return tuple(k), tuple(v)
