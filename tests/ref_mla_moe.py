"""The plain reference of the DeepSeek-V3 block (latent attention, routed
and shared experts) that the tests hold ``chamjax_torch.models.mla_moe``
to: float32, TF32 off, plain torch operations, no cache, no kernel of the
port and no JAX.

Written from the Hugging Face ``deepseek_v3`` equations: RMSNorm (float32
statistics), queries of [nope | rope] a head, the key-value latent
compressed to ``kv_lora_rank`` and normed, decompressed to each head's
[k_nope | v] by W_kvb (no absorption), DeepSeek's interleaved RoPE on q_pe
and the shared k_pe, causal attention at scale (nope + rope)^-0.5; then a
SwiGLU in the dense layers, and in the others sigmoid scores, the top
``num_experts_per_tok`` of the scores plus the bias, weights normalised
over the chosen and scaled, each expert run over its rows in a loop, plus
the shared experts.  ``w`` holds the port's parameter names, stacked by
layer.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (..., t, [heads,] 2n) at positions ``pos`` (t,): pairs (2i, 2i+1)
    rotated by pos·θ^(-2i/2n), written to entries i and n + i."""
    n = x.shape[-1] // 2
    inv = theta ** (-torch.arange(n, dtype=torch.float64) * 2 / (2 * n))
    ang = pos.double()[:, None].cpu() * inv
    cos, sin = ang.cos().float().to(x.device), ang.sin().float().to(x.device)
    if x.dim() == 4:                         # (b, t, heads, 2n)
        cos, sin = cos[:, None], sin[:, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def swiglu(x, gate_up, down):
    f = gate_up.shape[-1] // 2
    return (F.silu(x @ gate_up[:, :f]) * (x @ gate_up[:, f:])) @ down


def route(cfg, h2, router, e_bias):
    """(chosen experts (n, k), their weights (n, k))."""
    s = torch.sigmoid(h2 @ router)
    top = torch.topk(s + e_bias, cfg.num_experts_per_tok, dim=-1).indices
    w = s.gather(1, top)
    if cfg.norm_topk_prob:
        w = w / w.sum(-1, keepdim=True)
    return top, w * cfg.routed_scaling_factor


def moe(cfg, h2, w, m):
    """The routed layer ``m`` over ``h2`` (n, d): a loop over the experts,
    each over the rows that chose it, plus the shared experts."""
    top, wt = route(cfg, h2, w["router"][m], w["e_bias"][m])
    out = swiglu(h2, w["shared_gate_up"][m], w["shared_down"][m])
    for e in range(cfg.n_routed_experts):
        rows, slot = (top == e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(h2[rows], w["expert_gate_up"][m][e],
                       w["expert_down"][m][e])
            out = out.index_add(0, rows, y * wt[rows, slot][:, None])
    return out


def attention(cfg, h, w, l, pos):
    """Decompressed MLA over all positions of ``h`` (b, t, d), causal."""
    b, t, _ = h.shape
    H, nope, rp, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                       cfg.qk_rope_head_dim, cfg.v_head_dim)
    r = cfg.kv_lora_rank
    q = (h @ w["wq"][l]).view(b, t, H, nope + rp)
    kv = h @ w["wkv_a"][l]
    c = rms_norm(kv[..., :r], w["kv_norm"][l], cfg.rms_norm_eps)
    k_pe = rope(kv[..., r:], pos, cfg.rope_theta)
    kvb = (c @ w["wkv_b"][l]).view(b, t, H, nope + dv)
    k = torch.cat([kvb[..., :nope], k_pe[:, :, None].expand(b, t, H, rp)],
                  dim=-1)
    qq = torch.cat([q[..., :nope], rope(q[..., nope:], pos, cfg.rope_theta)],
                   dim=-1)
    s = torch.einsum("bqhd,bkhd->bhqk", qq, k) * (nope + rp) ** -0.5
    mask = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), kvb[..., nope:])
    return o.reshape(b, t, H * dv) @ w["wo"][l]


def forward(cfg, w: Dict[str, torch.Tensor], tokens: torch.Tensor):
    """tokens (b, t) → (logits (b, t, V), final normed hidden (b, t, d))."""
    eps = cfg.rms_norm_eps
    t = tokens.shape[1]
    pos = torch.arange(t)
    x = w["embed"][tokens.long()]
    for l in range(cfg.num_hidden_layers):
        x = x + attention(cfg, rms_norm(x, w["attn_norm"][l], eps), w, l, pos)
        h2 = rms_norm(x, w["ffn_norm"][l], eps)
        if l < cfg.first_k_dense_replace:
            x = x + swiglu(h2, w["dense_gate_up"][l], w["dense_down"][l])
        else:
            m = l - cfg.first_k_dense_replace
            x = x + moe(cfg, h2.reshape(-1, h2.shape[-1]), w, m).view(x.shape)
    hidden = rms_norm(x, w["final_norm"], eps)
    return hidden @ w["head"], hidden
