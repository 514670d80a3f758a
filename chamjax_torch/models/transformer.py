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

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from chamjax_torch.config import ModelConfig
from chamjax_torch.utils import graphs
from chamjax_torch.utils.device import resolve_device

Key = Union[int, torch.Generator]


class KVCache(NamedTuple):
    """Self-attention cache: one stacked buffer per stack of layers.  ``k``,
    ``v`` and ``idx`` are graph state (read and written in place); the
    cache owns the graphs of the steps run on it."""

    k: torch.Tensor       # (layers, b, max_len, heads, head_dim)
    v: torch.Tensor       # (layers, b, max_len, heads, head_dim)
    idx: torch.Tensor     # () int32 on the cache's device — cached positions
    host_idx: int = 0     # the same count, kept on the host
    graphs: Optional[graphs.Graphs] = None


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


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def generator(key: Key, device: torch.device) -> torch.Generator:
    """``key``: a seed, or a ``torch.Generator`` on ``device``."""
    if isinstance(key, torch.Generator):
        return key
    g = torch.Generator(device=device)
    g.manual_seed(int(key))
    return g


@torch.no_grad()
def normal_(p: torch.Tensor, g: torch.Generator, scale: float) -> None:
    """Fill ``p`` with N(0, 1)·scale drawn in f32, then cast (the JAX
    package's init)."""
    p.copy_(torch.randn(p.shape, generator=g, device=p.device,
                        dtype=torch.float32) * scale)


def _init_stack(stack: nn.Module, g: torch.Generator, cfg: ModelConfig
                ) -> None:
    d, f = cfg.embed_dim, cfg.ffn_embed_dim
    scales = {"wqkv": d ** -0.5, "wo": d ** -0.5, "w1": d ** -0.5,
              "w2": f ** -0.5, "wq": d ** -0.5, "wkv": d ** -0.5}
    for name, p in stack.named_parameters():
        if name in scales:
            normal_(p, g, scales[name])


def _init_params(params: TransformerParams, g: torch.Generator,
                 cfg: ModelConfig, out_proj: bool) -> TransformerParams:
    d = cfg.embed_dim
    normal_(params.embed, g, d ** -0.5)
    normal_(params.pos, g, 0.02)
    _init_stack(params.layers, g, cfg)
    if out_proj:
        normal_(params.out_proj, g, d ** -0.5)
    if params.cross_layers is not None:
        _init_stack(params.cross_layers, g, cfg)
    return params


def init_decoder(key: Key, cfg: ModelConfig, cross_attention: bool = False,
                 device=None) -> TransformerParams:
    """Random decoder parameters from ``key`` (a seed or a generator) on
    ``device`` (the card unless given ``"cpu"``)."""
    dev = resolve_device(device)
    params = TransformerParams(cfg, n_layers=cfg.layers,
                               n_out=cfg.vocab_size,
                               cross_attention=cross_attention, device=dev,
                               dtype=dtype_of(cfg))
    return _init_params(params, generator(key, dev), cfg, out_proj=True)


def init_encoder(key: Key, cfg: ModelConfig, device=None
                 ) -> TransformerParams:
    dev = resolve_device(device)
    params = TransformerParams(cfg, n_layers=cfg.encoder_layers, n_out=1,
                               device=dev, dtype=dtype_of(cfg))
    return _init_params(params, generator(key, dev), cfg, out_proj=False)


def init_encoder_decoder(key: Key, cfg: ModelConfig, device=None
                         ) -> Tuple[TransformerParams, TransformerParams]:
    dev = resolve_device(device)
    g = generator(key, dev)
    return (init_encoder(g, cfg, device=dev),
            init_decoder(g, cfg, cross_attention=True, device=dev))


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
    cache.k.zero_()
    cache.v.zero_()
    cache.idx.zero_()
    return cache._replace(host_idx=0)


def state_of(cache: KVCache) -> Tuple[torch.Tensor, ...]:
    """The cache's device state, as a step's core takes it."""
    return cache.k, cache.v, cache.idx


def check_room(cache: KVCache) -> None:
    """Raise when the cache is full: the JAX package would clamp the write
    silently, a CUDA gather would assert on the device."""
    if cache.host_idx >= cache.k.shape[2]:
        raise IndexError(f"KV cache full: {cache.host_idx} positions cached "
                         f"of max_len {cache.k.shape[2]}")


def write_column(kv, ks_new: torch.Tensor, vs_new: torch.Tensor) -> None:
    """Write the step's K/V columns ``(layers, b, 1, h, hd)`` at ``idx`` in
    place and advance ``idx`` on the device (``kv``: ``state_of(cache)``)."""
    k, v, idx = kv
    at = idx.long().reshape(1)
    k.index_copy_(2, at, ks_new)
    v.index_copy_(2, at, vs_new)
    idx.add_(1)


def check_prompt(cache: KVCache, t: int) -> None:
    if t > cache.k.shape[2]:
        raise IndexError(f"prompt of {t} tokens past max_len "
                         f"{cache.k.shape[2]}")


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
    logits, hidden = graphs.call(cache.graphs, _decoder_prefill, params,
                                 tokens, state_of(cache), heads)
    return logits, hidden, cache._replace(host_idx=t)


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
        hd = qh.shape[-1]
        scores = torch.einsum("bqhd,bkhd->bhqk", qh.float(),
                              k_cache[i].float()) * hd ** -0.5
        scores = scores.masked_fill(~strict_mask.reshape(1, 1, 1, T),
                                    float("-inf"))
        self_score = (qh * kh).float().sum(dim=-1) * hd ** -0.5  # (b, 1, h)
        self_score = self_score.transpose(1, 2)[:, :, :, None]   # (b,h,1,1)
        all_scores = torch.cat([scores, self_score], dim=-1)
        p = torch.softmax(all_scores, dim=-1).to(x.dtype)
        a = (torch.einsum("bhqk,bkhd->bqhd", p[..., :T], v_cache[i])
             + p[..., T:].transpose(1, 2) * vh)             # (b, 1, h, hd)
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
    logits, hidden = graphs.call(cache.graphs, _decoder_step, params, tokens,
                                 state_of(cache), heads, cross_kv,
                                 cross_valid_len)
    return logits, hidden, cache._replace(host_idx=cache.host_idx + 1)


# ---------------------------------------------------------------------------
# Encoder (enc-dec mode: encodes query tokens / retrieved tokens)
# ---------------------------------------------------------------------------


@torch.no_grad()
@graphs.captured
def encoder_forward(
    params: TransformerParams,
    tokens: torch.Tensor,         # (b, s) int
    heads: int,
    valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bidirectional encoder → hidden states (b, s, d)."""
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
@graphs.captured
def build_cross_kv(
    dec_params: TransformerParams,
    enc_out: torch.Tensor,        # (b, s, d)
    heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-decoder-layer cross-attention K/V over the encoder output (done
    once per retrieval step, reused for ``retrieval_interval`` decode
    steps).  Returns ``(k, v)``, each (layers, b, s, h, hd)."""
    L, b, s = dec_params.cross_layers.wkv.shape[0], *enc_out.shape[:2]
    kv = enc_out[None] @ dec_params.cross_layers.wkv[:, None]  # (L,b,s,2d)
    k, v = torch.chunk(kv, 2, dim=-1)
    return (k.reshape(L, b, s, heads, -1), v.reshape(L, b, s, heads, -1))
