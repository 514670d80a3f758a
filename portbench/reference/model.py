"""The plain reference of the Chameleon RALM transformers, in float32.

Written from the model's equations (pre-norm blocks: layernorm with the
population variance and eps 1e-5, multi-head attention with scores scaled
by head_dim^-0.5, a tanh-GELU FFN; learned positions; an encoder-decoder's
decoder adds cross-attention after self-attention), with plain torch
operations, no cache, no kernels of the program.  Matmuls run with TF32
off.  The weights are the benchmark's own (``inputs.make_weights``), as
float32 copies.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """Float32 matmuls in float32: TF32 off for the block, restored after."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def layernorm(x, scale, bias, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def attention(q, k, v, heads: int, causal_from: Optional[int] = None):
    """q (b, tq, d), k and v (b, tk, d) → (b, tq, d).  ``causal_from``:
    query i sits at key position ``causal_from + i`` and sees keys up to
    it; None: every key."""
    b, tq, d = q.shape
    tk = k.shape[1]
    hd = d // heads
    qh = q.reshape(b, tq, heads, hd).transpose(1, 2)
    kh = k.reshape(b, tk, heads, hd).transpose(1, 2)
    vh = v.reshape(b, tk, heads, hd).transpose(1, 2)
    s = qh @ kh.transpose(-1, -2) / math.sqrt(hd)
    if causal_from is not None:
        qpos = causal_from + torch.arange(tq, device=q.device)[:, None]
        kpos = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return (p @ vh).transpose(1, 2).reshape(b, tq, d)


def ffn(x, w, i):
    y = layernorm(x, w["ln2_scale"][i], w["ln2_bias"][i])
    h = F.gelu(y @ w["w1"][i] + w["b1"][i], approximate="tanh")
    return x + h @ w["w2"][i] + w["b2"][i]


def encode(w: Dict[str, torch.Tensor], tokens: torch.Tensor, heads: int
           ) -> torch.Tensor:
    """The encoder over ``tokens`` (b, s) → final-norm hidden (b, s, d)."""
    s = tokens.shape[1]
    x = w["embed"][tokens.long()] + w["pos"][:s][None]
    d = x.shape[-1]
    for i in range(w["wqkv"].shape[0]):
        y = layernorm(x, w["ln1_scale"][i], w["ln1_bias"][i])
        qkv = y @ w["wqkv"][i]
        x = x + attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                          heads) @ w["wo"][i]
        x = ffn(x, w, i)
    return layernorm(x, w["lnf_scale"], w["lnf_bias"])


def cross_kv(w: Dict[str, torch.Tensor], enc_out: torch.Tensor):
    """Every decoder layer's cross K and V over ``enc_out``: two
    (layers, b, s, d) tensors."""
    kv = torch.einsum("bsd,lde->lbse", enc_out, w["c_wkv"])
    d = enc_out.shape[-1]
    return kv[..., :d], kv[..., d:]


def decode(w: Dict[str, torch.Tensor], tokens: torch.Tensor, heads: int,
           cache=None, cross=None, start: int = 0):
    """Decoder positions ``start .. start + t`` for ``tokens`` (b, t),
    given ``cache``: a list a layer of the (K, V) (b, start, d) of the
    positions before, which is extended in place.  ``cross``: a layer's
    (K, V) over the retrieved context, or None.  Returns (logits (b, t,
    V), hidden (b, t, d))."""
    t = tokens.shape[1]
    x = w["embed"][tokens.long()] + w["pos"][start:start + t][None]
    d = x.shape[-1]
    for i in range(w["wqkv"].shape[0]):
        y = layernorm(x, w["ln1_scale"][i], w["ln1_bias"][i])
        qkv = y @ w["wqkv"][i]
        k, v = qkv[..., d:2 * d], qkv[..., 2 * d:]
        if cache is not None:
            if len(cache) <= i:
                cache.append((k, v))
            else:
                k = torch.cat([cache[i][0], k], dim=1)
                v = torch.cat([cache[i][1], v], dim=1)
                cache[i] = (k, v)
        x = x + attention(qkv[..., :d], k, v, heads,
                          causal_from=start) @ w["wo"][i]
        if cross is not None:
            y = layernorm(x, w["c_ln_scale"][i], w["c_ln_bias"][i])
            x = x + attention(y @ w["c_wq"][i], cross[0][i], cross[1][i],
                              heads) @ w["c_wo"][i]
        x = ffn(x, w, i)
    hidden = layernorm(x, w["lnf_scale"], w["lnf_bias"])
    return hidden @ w["out_proj"], hidden


def fp8_copy(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The control's weights: each tensor rounded to float8 e4m3 under one
    scale a tensor (its largest magnitude to 448), back in float32."""
    out = {}
    for name, t in w.items():
        amax = t.abs().max().clamp_min(1e-30)
        scale = 448.0 / amax
        out[name] = (t * scale).to(torch.float8_e4m3fn).float() / scale
    return out


def retrieved_tokens(ids: torch.Tensor, tokens_per_doc: int, vocab: int,
                     max_len: int, seed: int = 7) -> torch.Tensor:
    """The retrieved documents' tokens (b, min(k·tokens_per_doc, max_len))
    from neighbour ids (b, k): token t of the document with id x is
    ``((x·2654435761 + seed + t·40503) mod 2^32) mod (vocab - 2) + 1``,
    with x taken as an unsigned 32-bit number (an id of -1 as 2^32 - 1)."""
    mask = (1 << 32) - 1
    x = ids.cpu().numpy().astype(np.int64).astype(np.uint64) & np.uint64(mask)
    t = np.arange(tokens_per_doc, dtype=np.uint64)
    base = ((x * np.uint64(2654435761)) & np.uint64(mask))[:, :, None]
    base = (base + np.uint64(seed) + t[None, None, :] * np.uint64(40503)) \
        & np.uint64(mask)
    tok = (base % np.uint64(max(vocab - 2, 1))).astype(np.int64) + 1
    tok = tok.reshape(ids.shape[0], -1)[:, :max_len]
    return torch.from_numpy(tok).to(ids.device)
