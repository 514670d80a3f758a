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
from chamjax_torch.models.transformer import (Key, KVCache, TPParams,
                                              _embed, _param, _zero_cache,
                                              check_prompt, check_room,
                                              check_tp, dtype_of,
                                              fill_prefix, generator, mm_f32,
                                              state_of, tp_call, tp_gather,
                                              tp_row, tp_sum, write_column)
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
    if isinstance(params, TPParams):
        check_tp(params, cache, heads, tokens.shape[0])
        logits, hidden = tp_call(params, cache.graphs, _tp_llama_prefill,
                                 params, tokens, state_of(cache), heads,
                                 kv_heads, theta)
    else:
        logits, hidden = graphs.call(cache.graphs, _llama_prefill, params,
                                     tokens, state_of(cache), heads,
                                     kv_heads, theta)
    return logits, hidden, cache._replace(host_idx=t)


def _gqa_attend_step(qh, kh, vh, k_hist, v_hist, strict, groups: int):
    """One token's grouped-query attention: ``qh`` (b, 1, h, hd) against
    the cached positions where ``strict`` (T,) holds and, apart, against
    its own ``kh``/``vh`` (b, 1, kv, hd).  Returns (b, 1, h, hd)."""
    b, _, h, hd = qh.shape
    kv_h = kh.shape[2]
    T = k_hist.shape[1]
    s_hist = _gqa_scores(qh, k_hist, groups)                  # (b,h,1,T)
    s_hist = s_hist.masked_fill(~strict, float("-inf"))
    s_self = ((qh.reshape(b, 1, kv_h, groups, hd) * kh[:, :, :, None, :])
              .float().sum(dim=-1).reshape(b, 1, h) * hd ** -0.5)
    s_all = torch.cat([s_hist, s_self.transpose(1, 2)[:, :, :, None]],
                      dim=-1)
    p = torch.softmax(s_all, dim=-1).to(qh.dtype)
    return (_gqa_mix(p[..., :T], v_hist, groups)
            + (p[..., T:].transpose(1, 2).reshape(b, 1, kv_h, groups, 1)
               * vh[:, :, :, None, :]).reshape(b, 1, h, hd))


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
        a = _gqa_attend_step(qh, kh, vh, k_cache[i], v_cache[i], strict,
                             groups)
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
    if isinstance(params, TPParams):
        check_tp(params, cache, heads, tokens.shape[0])
        logits, hidden = tp_call(params, cache.graphs, _tp_llama_step,
                                 params, tokens, state_of(cache), heads,
                                 kv_heads, theta)
    else:
        logits, hidden = graphs.call(cache.graphs, _llama_step, params,
                                     tokens, state_of(cache), heads,
                                     kv_heads, theta)
    return logits, hidden, cache._replace(host_idx=cache.host_idx + 1)


# ---------------------------------------------------------------------------
# Tensor parallel (``TPParams`` from ``parallel/sharded_model.py``)
# ---------------------------------------------------------------------------
#
# Megatron placement: q/k/v and w1/w3 by columns, wo and w2 by rows, two
# all-reduces a layer (``tp_sum``).  K/V are split only when whole KV heads
# land on each tp position; otherwise every position holds them whole and
# its query heads read KV head ``head // groups``.  RoPE is per head.


def _rank_kv(kh, vh, j: int, cache_heads: int):
    """The K/V heads tp position ``j`` caches: its slice where whole
    projections feed a split cache, else ``kh``/``vh`` as they are."""
    if kh.shape[2] > cache_heads:
        sl = slice(j * cache_heads, (j + 1) * cache_heads)
        return kh[:, :, sl], vh[:, :, sl]
    if kh.shape[2] < cache_heads:
        raise ValueError(f"split K/V projections ({kh.shape[2]} heads) "
                         f"with a replicated cache ({cache_heads})")
    return kh, vh


def _rank_groups(params, j: int, heads: int, kv_full: int, kv_here: int,
                 device):
    """``(groups, sel)`` for tp position ``j``'s attention: with whole K/V
    on every position (``kv_here == kv_full``, tp > 1), ``sel`` picks each
    of its query heads' KV head and the groups are 1; else ``sel`` is
    None."""
    hr, groups = heads // params.tp, heads // kv_full
    if params.tp > 1 and kv_here == kv_full:
        return 1, torch.div(torch.arange(j * hr, (j + 1) * hr, device=device),
                            groups, rounding_mode="floor")
    return groups, None


def _tp_llama_layer(params, i, l, x, attn):
    S = params.shared_rows[i]
    y = _rms(x, S.ln1[l])
    x = x + tp_sum(params, i, y,
                   lambda j, r, yj: mm_f32(attn(j, r, yj), r.wo[l]))
    y = _rms(x, S.ln2[l])
    return x + tp_sum(params, i, y, lambda j, r, yj: mm_f32(
        F.silu(yj @ r.w1[l]) * (yj @ r.w3[l]), r.w2[l]))


def _tp_llama_prefill(params, tokens, kv, heads, kv_heads, theta):
    """The tensor-parallel core of :func:`llama_prefill`."""
    ks, vs, idxs = kv
    bl, t = tokens.shape[0] // params.dp, tokens.shape[1]
    hr, kv_full = heads // params.tp, kv_heads or heads
    hd = params.embed.shape[1] // heads
    logits, hidden = [], []
    for i in range(params.dp):
        S = params.shared_rows[i]
        x = _embed(S, tp_row(tokens, i, params.dp, S.embed.device))
        rope = []
        for j in range(params.tp):
            dev = params.rank_device(i, j)
            cos, sin = _rope_tables(torch.arange(t, device=dev), hd, theta)
            rope.append((cos[None, :, None, :], sin[None, :, None, :]))
        for l in range(S.ln1.shape[0]):
            def attn(j, r, y):
                cos, sin = rope[j]
                qh = _rope((y @ r.wq[l]).reshape(bl, t, hr, hd), cos, sin)
                kh = _rope((y @ r.wk[l]).reshape(bl, t, -1, hd), cos, sin)
                vh = (y @ r.wv[l]).reshape(bl, t, -1, hd)
                kh, vh = _rank_kv(kh, vh, j, ks[i][j].shape[3])
                fill_prefix((ks[i][j], vs[i][j]), l, kh, vh)
                groups, sel = _rank_groups(params, j, heads, kv_full,
                                           kh.shape[2], y.device)
                if sel is not None:
                    kh, vh = kh.index_select(2, sel), vh.index_select(2, sel)
                mask = torch.ones((t, t), dtype=torch.bool,
                                  device=y.device).tril()
                sc = _gqa_scores(qh, kh, groups).masked_fill(~mask,
                                                             float("-inf"))
                p = torch.softmax(sc, dim=-1).to(y.dtype)
                return _gqa_mix(p, vh, groups).flatten(2)
            x = _tp_llama_layer(params, i, l, x, attn)
        for idx in idxs[i]:
            idx.fill_(t)
        h = _rms(x, S.ln_f)
        logits.append(h @ S.out_proj)
        hidden.append(h)
    return tp_gather(params, logits), tp_gather(params, hidden)


def _tp_llama_step(params, tokens, kv, heads, kv_heads, theta):
    """The tensor-parallel core of :func:`llama_step`: each tp position
    attends with its query heads and writes its share of the cache."""
    ks, vs, idxs = kv
    bl = tokens.shape[0] // params.dp
    hr, kv_full = heads // params.tp, kv_heads or heads
    hd = params.embed.shape[1] // heads
    logits, hidden = [], []
    for i in range(params.dp):
        S = params.shared_rows[i]
        x = _embed(S, tp_row(tokens, i, params.dp, S.embed.device))[:, None]
        rope, strict, rank = [], [], []
        for j in range(params.tp):
            k_c, idx = ks[i][j], idxs[i][j]
            cos, sin = _rope_tables(idx.reshape(1), hd, theta)
            rope.append((cos[None, :, None, :], sin[None, :, None, :]))
            strict.append(torch.arange(k_c.shape[2], device=k_c.device)
                          < idx)
            rank.append(_rank_groups(params, j, heads, kv_full,
                                     k_c.shape[3], k_c.device))
        new = [([], []) for _ in range(params.tp)]
        for l in range(S.ln1.shape[0]):
            def attn(j, r, y):
                cos, sin = rope[j]
                qh = _rope((y @ r.wq[l]).reshape(bl, 1, hr, hd), cos, sin)
                kh = _rope((y @ r.wk[l]).reshape(bl, 1, -1, hd), cos, sin)
                vh = (y @ r.wv[l]).reshape(bl, 1, -1, hd)
                kh, vh = _rank_kv(kh, vh, j, ks[i][j].shape[3])
                new[j][0].append(kh)
                new[j][1].append(vh)
                hist = (ks[i][j][l], vs[i][j][l])
                groups, sel = rank[j]
                if sel is not None:
                    kh, vh, *hist = (z.index_select(2, sel)
                                     for z in (kh, vh, *hist))
                return _gqa_attend_step(qh, kh, vh, *hist, strict[j],
                                        groups).flatten(2)
            x = _tp_llama_layer(params, i, l, x, attn)
        for j in range(params.tp):
            write_column((ks[i][j], vs[i][j], idxs[i][j]),
                         torch.stack(new[j][0]), torch.stack(new[j][1]))
        h = _rms(x[:, 0, :], S.ln_f)
        logits.append(h @ S.out_proj)
        hidden.append(h)
    return tp_gather(params, logits), tp_gather(params, hidden)
