"""The plain reference of the Kimi-Linear block (KDA and latent attention,
routed and shared experts) that the tests hold
``chamjax_torch.models.kimi_linear`` to: float32, TF32 off, plain torch
operations, no cache, no chunking, no absorption, no kernel of the port
and no JAX.

Written from the published Kimi-Linear equations: RMSNorm (float32
statistics); a KDA layer's q, k, v products, the causal depthwise
convolution of width W over positions and SiLU, q and k L2-normed (eps
1e-6 under the root) and q scaled by K^-0.5, the decay a = −exp(A_log)·
softplus(h·W_fa·W_fb + dt_bias), β = sigmoid(h·W_b), the recurrence run
position by position (S ← Diag(e^a)S; S ← S + βk(v − Sᵀk)ᵀ; o = Sᵀq), the
output normed per head and gated by sigmoid(h·W_ga·W_gb), then W_o; an MLA
layer decompressed by W_kvb with no rotary embedding, causal, at scale
(nope + rope)^-0.5; a SwiGLU in the dense layers, and in the others
sigmoid scores over every expert, the top ``num_experts_per_token`` of
the scores plus the bias, the chosen scores over their sum times the
scaling factor, each held expert run over its rows in a loop (an expert
not held adds nothing), plus the shared expert.  ``w`` holds the port's
parameter names, each kind's layers stacked; ``kda_in`` is split here
into its six products by the widths the config gives.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ref_mla_moe import no_tf32, rms_norm, swiglu  # noqa: F401


def l2_norm(x):
    return x / torch.sqrt(x.pow(2).sum(-1, keepdim=True) + 1e-6)


def split_in(cfg, proj):
    """[q | k | v | f_a | g_a | b] of a KDA layer's input product."""
    HK, K = cfg.kda_num_heads * cfg.kda_head_dim, cfg.kda_head_dim
    return proj.split([HK, HK, HK, K, K, cfg.kda_num_heads], dim=-1)


def kda(cfg, h, w, i, state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """KDA layer ``i`` over ``h`` (b, t, d) from ``state`` (b, H, K, V;
    zeros if None): (its output (b, t, d), the final state)."""
    b, t, _ = h.shape
    H, K = cfg.kda_num_heads, cfg.kda_head_dim
    W = cfg.short_conv_kernel_size
    q, k, v, fa, ga, bl = split_in(cfg, h @ w["kda_in"][i])
    x = torch.cat([q, k, v], -1)
    taps = w["kda_conv"][i]                             # (W, 3·H·K)
    xp = torch.cat([x.new_zeros(b, W - 1, x.shape[-1]), x], 1)
    conv = sum(xp[:, j:j + t] * taps[j] for j in range(W))
    q, k, v = F.silu(conv).view(b, t, 3, H, K).unbind(2)
    q = l2_norm(q) * K ** -0.5
    k = l2_norm(k)
    a = -torch.exp(w["kda_a_log"][i])[:, None] * F.softplus(
        (fa @ w["kda_fb"][i]).view(b, t, H, K)
        + w["kda_dt_bias"][i].view(H, K))
    beta = torch.sigmoid(bl)
    S = h.new_zeros(b, H, K, K) if state is None else state.clone()
    o = h.new_empty(b, t, H, K)
    for s in range(t):
        S = S * torch.exp(a[:, s])[..., None]
        u = beta[:, s, :, None] * (v[:, s] - torch.einsum("bhk,bhkv->bhv",
                                                          k[:, s], S))
        S = S + k[:, s, ..., None] * u[..., None, :]
        o[:, s] = torch.einsum("bhk,bhkv->bhv", q[:, s], S)
    gate = torch.sigmoid(ga @ w["kda_gb"][i]).view(b, t, H, K)
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps)
    o = o * w["kda_o_norm"][i] * gate
    return o.reshape(b, t, H * K) @ w["kda_wo"][i], S


def mla(cfg, h, w, i):
    """MLA layer ``i`` over all positions of ``h`` (b, t, d): decompressed,
    causal, no rotary embedding."""
    b, t, _ = h.shape
    H, nope, rp, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                       cfg.qk_rope_head_dim, cfg.v_head_dim)
    r = cfg.kv_lora_rank
    q = (h @ w["wq"][i]).view(b, t, H, nope + rp)
    kv = h @ w["wkv_a"][i]
    c = rms_norm(kv[..., :r], w["kv_norm"][i], cfg.rms_norm_eps)
    kvb = (c @ w["wkv_b"][i]).view(b, t, H, nope + dv)
    k = torch.cat([kvb[..., :nope],
                   kv[..., None, r:].expand(b, t, H, rp)], dim=-1)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (nope + rp) ** -0.5
    mask = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), kvb[..., nope:])
    return o.reshape(b, t, H * dv) @ w["wo"][i]


def route(cfg, h2, router, e_bias):
    """(chosen experts (n, k) of all num_experts, their weights (n, k))."""
    s = torch.sigmoid(h2 @ router)
    top = torch.topk(s + e_bias, cfg.num_experts_per_token, dim=-1).indices
    wt = s.gather(1, top)
    if cfg.moe_renormalize:
        wt = wt / wt.sum(-1, keepdim=True)
    return top, wt * cfg.routed_scaling_factor


def moe(cfg, h2, w, m, held=None, shared=True):
    """Routed layer ``m`` over ``h2`` (n, d): the held experts ``[lo, hi)``
    (default the config's) in a loop, each over the rows that chose it,
    ``w``'s experts numbered from lo; plus the shared expert."""
    lo, hi = held or cfg.held
    top, wt = route(cfg, h2, w["router"][m], w["e_bias"][m])
    out = (swiglu(h2, w["shared_gate_up"][m], w["shared_down"][m]) if shared
           else torch.zeros_like(h2))
    for e in range(lo, hi):
        rows, slot = (top == e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(h2[rows], w["expert_gate_up"][m][e - lo],
                       w["expert_down"][m][e - lo])
            out = out.index_add(0, rows, y * wt[rows, slot][:, None])
    return out


def forward(cfg, w: Dict[str, torch.Tensor], tokens: torch.Tensor):
    """tokens (b, t) → (logits (b, t, V), final normed hidden (b, t, d),
    each KDA layer's state after the last position)."""
    eps = cfg.rms_norm_eps
    x = w["embed"][tokens.long()]
    states = []
    for l, (kind, i) in enumerate(cfg.slots):
        h = rms_norm(x, w["attn_norm"][l], eps)
        if kind == "kda":
            o, S = kda(cfg, h, w, i)
            states.append(S)
        else:
            o = mla(cfg, h, w, i)
        x = x + o
        h2 = rms_norm(x, w["ffn_norm"][l], eps)
        if l < cfg.first_k_dense_replace:
            x = x + swiglu(h2, w["dense_gate_up"][l], w["dense_down"][l])
        else:
            m = l - cfg.first_k_dense_replace
            x = x + moe(cfg, h2.reshape(-1, h2.shape[-1]), w, m).view(x.shape)
    hidden = rms_norm(x, w["final_norm"], eps)
    return hidden @ w["head"], hidden, states
