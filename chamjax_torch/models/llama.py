"""Llama-family decoder: RMSNorm + rotate-half RoPE + SwiGLU + GQA (the
port of ``chamjax/models/llama.py``).

The same stacked-layer parameters and in-place KV cache as
``transformer.py``, with the llama blocks:

- RMSNorm (no mean subtraction, no bias), computed in f32;
- rotary position embeddings applied to q/k at attention time; cached K is
  stored pre-rotated so incremental steps never re-rotate history;
- SwiGLU FFN (``silu(x@w1) * (x@w3) @ w2``), no biases anywhere;
- grouped-query attention: ``kv_heads ≤ attention_heads`` K/V heads, each
  shared by ``attention_heads // kv_heads`` query heads.

``llama_prefill``/``llama_step`` are signature-compatible with
``decoder_prefill``/``decoder_step``, and like them a host shell around a
device core captured in a CUDA graph on the card, owned by the cache.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from chamjax_torch.config import ModelConfig
from chamjax_torch.models.transformer import (Key, KVCache, _embed, _param,
                                              _zero_cache, check_prompt,
                                              check_room, dtype_of,
                                              fill_prefix, generator,
                                              state_of, write_column)
from chamjax_torch.utils import graphs
from chamjax_torch.utils.device import resolve_device


def _kv_heads(cfg: ModelConfig) -> int:
    kv = cfg.kv_heads or cfg.attention_heads
    if cfg.attention_heads % kv:
        raise ValueError(f"attention_heads={cfg.attention_heads} is not a "
                         f"multiple of kv_heads={kv}")
    return kv


class LlamaLayerStack(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, f, h = cfg.embed_dim, cfg.ffn_embed_dim, cfg.attention_heads
        hd, kv, L = d // h, _kv_heads(cfg), cfg.layers
        kw = dict(device=device, dtype=dtype)
        self.ln1 = _param((L, d), 1.0, **kw)
        self.wq = _param((L, d, h * hd), 0.0, **kw)
        self.wk = _param((L, d, kv * hd), 0.0, **kw)
        self.wv = _param((L, d, kv * hd), 0.0, **kw)
        self.wo = _param((L, h * hd, d), 0.0, **kw)
        self.ln2 = _param((L, d), 1.0, **kw)
        self.w1 = _param((L, d, f), 0.0, **kw)
        self.w3 = _param((L, d, f), 0.0, **kw)
        self.w2 = _param((L, f, d), 0.0, **kw)


class LlamaParams(nn.Module):
    """The JAX package's llama dict (``embed``, ``layers``, ``ln_f``,
    ``out_proj``) as a module."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d = cfg.embed_dim
        kw = dict(device=device, dtype=dtype)
        self.embed = _param((cfg.vocab_size, d), 0.0, **kw)
        self.layers = LlamaLayerStack(cfg, **kw)
        self.ln_f = _param((d,), 1.0, **kw)
        self.out_proj = _param((d, cfg.vocab_size), 0.0, **kw)


@torch.no_grad()
def init_llama(key: Key, cfg: ModelConfig, device=None) -> LlamaParams:
    """Random parameters, drawn at the target dtype (a 7B stack's f32
    intermediates would double the init's transient memory)."""
    dev = resolve_device(device)
    p = LlamaParams(cfg, device=dev, dtype=dtype_of(cfg))
    g = generator(key, dev)
    d, f = cfg.embed_dim, cfg.ffn_embed_dim
    for name, t in (("embed", p.embed), *p.layers.named_parameters(),
                    ("out_proj", p.out_proj)):
        if name.startswith("ln"):
            continue
        scale = f ** -0.5 if name == "w2" else d ** -0.5
        t.copy_(torch.randn(t.shape, generator=g, device=dev,
                            dtype=t.dtype) * scale)
    return p


def init_llama_kv_cache(cfg: ModelConfig, batch: int,
                        max_len: Optional[int] = None,
                        device=None) -> KVCache:
    return _zero_cache(cfg, batch, max_len, _kv_heads(cfg),
                       cfg.embed_dim // cfg.attention_heads, device)


# ---------------------------------------------------------------------------
# rotary helpers
# ---------------------------------------------------------------------------


def _rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """cos/sin (…, hd/2) for the rotate-half convention, f32."""
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=positions.device) / hd)
    ang = positions.float()[..., None] * inv                  # (..., hd/2)
    return torch.cos(ang), torch.sin(ang)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """x: (b, t, h, hd); cos/sin broadcastable to (b, t, 1, hd/2)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _gqa_scores(qh, kh, groups: int):
    """qh (b,tq,h,hd) × kh (b,tk,kv,hd) → (b, h, tq, tk) f32."""
    b, tq, h, hd = qh.shape
    kvh = kh.shape[2]
    qg = qh.reshape(b, tq, kvh, groups, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kh.float())
    return s.reshape(b, h, tq, kh.shape[1]) * hd ** -0.5


def _gqa_mix(p, vh, groups: int):
    """p (b,h,tq,tk) × vh (b,tk,kv,hd) → (b, tq, h, hd)."""
    b, h, tq, tk = p.shape
    kvh = vh.shape[2]
    pg = p.reshape(b, kvh, groups, tq, tk)
    a = torch.einsum("bkgqs,bskd->bqkgd", pg, vh)
    return a.reshape(b, tq, h, a.shape[-1])


def _rms(x, scale, eps=1e-5):
    xf = x.float()
    nrm = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * nrm).to(x.dtype) * scale


def _swiglu(x, L, i):
    y = _rms(x, L.ln2[i])
    return x + (F.silu(y @ L.w1[i]) * (y @ L.w3[i])) @ L.w2[i]


# ---------------------------------------------------------------------------
# prefill / step
# ---------------------------------------------------------------------------


def _llama_prefill(params, tokens, kv, heads, kv_heads, theta):
    """The device core of :func:`llama_prefill`."""
    b, t = tokens.shape
    h = heads
    kv_h = kv_heads or heads
    groups = h // kv_h
    hd = params.embed.shape[1] // h
    x = _embed(params, tokens)
    cos, sin = _rope_tables(torch.arange(t, device=x.device), hd, theta)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    L = params.layers
    for i in range(L.wq.shape[0]):
        y = _rms(x, L.ln1[i])
        qh = _rope((y @ L.wq[i]).reshape(b, t, h, hd), cos, sin)
        kh = _rope((y @ L.wk[i]).reshape(b, t, kv_h, hd), cos, sin)
        vh = (y @ L.wv[i]).reshape(b, t, kv_h, hd)
        s = _gqa_scores(qh, kh, groups).masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1).to(x.dtype)
        a = _gqa_mix(p, vh, groups)
        x = x + a.reshape(b, t, h * hd) @ L.wo[i]
        x = _swiglu(x, L, i)
        fill_prefix(kv, i, kh, vh)
    kv[2].fill_(t)
    hidden = _rms(x, params.ln_f)
    return hidden @ params.out_proj, hidden


@torch.no_grad()
def llama_prefill(params: LlamaParams, tokens: torch.Tensor, cache: KVCache,
                  heads: int, kv_heads: int = 0, theta: float = 10000.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Whole-prompt pass; fills the cache in place with pre-rotated K.

    Returns ``(logits (b,t,V), hidden (b,t,d), cache)``."""
    t = tokens.shape[1]
    check_prompt(cache, t)
    logits, hidden = graphs.call(cache.graphs, _llama_prefill, params, tokens,
                                 state_of(cache), heads, kv_heads, theta)
    return logits, hidden, cache._replace(host_idx=t)


def _llama_step(params, tokens, kv, heads, kv_heads, theta):
    """The device core of :func:`llama_step`."""
    k_cache, v_cache, idx = kv
    b = tokens.shape[0]
    h = heads
    kv_h = kv_heads or heads
    groups = h // kv_h
    hd = params.embed.shape[1] // h
    T = k_cache.shape[2]
    x = _embed(params, tokens)[:, None, :]                    # (b, 1, d)
    cos, sin = _rope_tables(idx.reshape(1), hd, theta)        # (1, hd/2)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]   # (1,1,1,hd/2)
    strict = torch.arange(T, device=x.device) < idx           # (T,)
    L = params.layers
    ks_new, vs_new = [], []
    for i in range(L.wq.shape[0]):
        y = _rms(x, L.ln1[i])
        qh = _rope((y @ L.wq[i]).reshape(b, 1, h, hd), cos, sin)
        kh = _rope((y @ L.wk[i]).reshape(b, 1, kv_h, hd), cos, sin)
        vh = (y @ L.wv[i]).reshape(b, 1, kv_h, hd)
        s_hist = _gqa_scores(qh, k_cache[i], groups)          # (b,h,1,T)
        s_hist = s_hist.masked_fill(~strict, float("-inf"))
        s_self = ((qh.reshape(b, 1, kv_h, groups, hd) * kh[:, :, :, None, :])
                  .float().sum(dim=-1).reshape(b, 1, h) * hd ** -0.5)
        s_all = torch.cat([s_hist, s_self.transpose(1, 2)[:, :, :, None]],
                          dim=-1)
        p = torch.softmax(s_all, dim=-1).to(x.dtype)
        a = (_gqa_mix(p[..., :T], v_cache[i], groups)
             + (p[..., T:].transpose(1, 2).reshape(b, 1, kv_h, groups, 1)
                * vh[:, :, :, None, :]).reshape(b, 1, h, hd))
        x = x + a.reshape(b, 1, h * hd) @ L.wo[i]
        x = _swiglu(x, L, i)
        ks_new.append(kh)
        vs_new.append(vh)
    write_column(kv, torch.stack(ks_new), torch.stack(vs_new))
    hidden = _rms(x[:, 0, :], params.ln_f)
    return hidden @ params.out_proj, hidden


@torch.no_grad()
def llama_step(params: LlamaParams, tokens: torch.Tensor, cache: KVCache,
               heads: int, kv_heads: int = 0, theta: float = 10000.0
               ) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """One incremental decode step; the same cache discipline as
    ``decoder_step`` (the cache only read in the layer loop, history and
    self terms apart, one column written in place after it; the room left
    checked and ``host_idx`` advanced on the host).  Returns
    ``(logits (b,V), hidden (b,d), cache)``."""
    check_room(cache)
    logits, hidden = graphs.call(cache.graphs, _llama_step, params, tokens,
                                 state_of(cache), heads, kv_heads, theta)
    return logits, hidden, cache._replace(host_idx=cache.host_idx + 1)
