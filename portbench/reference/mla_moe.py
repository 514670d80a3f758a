"""The plain reference of the DeepSeek-V3 block (``model_type``
``deepseek_v3``: Moonlight-16B-A3B), in float32.

Written from the model's equations, with plain torch operations, no cache,
no absorption and no kernel of the program: RMSNorm with its statistics
over the last axis and eps ``rms_norm_eps``; queries of [nope | rope] a
head; the key-value latent h·W_kva, its first ``kv_lora_rank`` entries
normed and decompressed by W_kvb into each head's [k_nope | v]; DeepSeek's
interleaved RoPE (entries 2i and 2i + 1 rotated by position ·
θ^(-2i/rope), written to i and rope/2 + i) on q_pe and on the k_pe all
heads share; causal attention at scale (nope + rope)^-0.5; then a SwiGLU
in the dense layers and, in the routed ones, sigmoid scores of h2·W_r, the
top ``num_experts_per_tok`` of the scores plus the bias, the chosen
scores over their sum times ``routed_scaling_factor``, each expert run
over the rows that chose it in a loop, plus the shared experts.  Matmuls
run with TF32 off (``model.no_tf32``).

It goes layer by layer: ``layer_w(l)`` returns layer l's weights (the
benchmark draws them again from the seed), so that the float32 model is
never held whole.  Attention runs a row and ``q_chunk`` queries at a time.

Routing near-ties.  Where the 6th and 7th biased scores lie closer than
the program's precision can tell apart, the program may take the other
expert, and what follows for that position is then another computation,
not an error.  With ``follow`` (the experts the program recorded at each
position and routed layer), the reference takes the program's choice
wherever it is a top set of the reference's own biased scores to within
``tau``: the least of the chosen lies at most ``tau`` below the most of
those left out.  Elsewhere it keeps its own choice, and the amount by
which the program's choice falls short (``route_gap``) is a number the
check compares.  ``near_ties`` counts the (position, layer) pairs where
the choice followed differs from the reference's own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

TAU = 0.04      # the bound on the program's biased-score error (PERF.md)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(t: int, rope: int, theta: float, device):
    """cos and sin (t, rope/2) of position · θ^(-2i/rope), in float64 then
    float32."""
    inv = theta ** (-torch.arange(rope // 2, dtype=torch.float64) * 2 / rope)
    ang = torch.arange(t, dtype=torch.float64)[:, None] * inv
    return ang.cos().float().to(device), ang.sin().float().to(device)


def rope(x, cos, sin):
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def swiglu(x, gate_up, down):
    f = gate_up.shape[-1] // 2
    return (F.silu(x @ gate_up[:, :f]) * (x @ gate_up[:, f:])) @ down


def attention(m: Dict, h, w, cos, sin, q_chunk: int):
    """Decompressed latent attention over ``h`` (r, t, d), causal, a row
    and ``q_chunk`` queries at a time → (r, t, d)."""
    r, t, _ = h.shape
    H, nope, rp, dv = (m["num_attention_heads"], m["qk_nope_head_dim"],
                       m["qk_rope_head_dim"], m["v_head_dim"])
    kr = m["kv_lora_rank"]
    scale = (nope + rp) ** -0.5
    out = torch.empty((r, t, H * dv), device=h.device)
    for i in range(r):
        q = (h[i] @ w["wq"]).view(t, H, nope + rp)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], cos[:, None],
                                           sin[:, None])], dim=-1)
        kv = h[i] @ w["wkv_a"]
        c = rms_norm(kv[:, :kr], w["kv_norm"], m["rms_norm_eps"])
        k_pe = rope(kv[:, kr:], cos, sin)
        kvb = (c @ w["wkv_b"]).view(t, H, nope + dv)
        k = torch.cat([kvb[..., :nope], k_pe[:, None].expand(t, H, rp)],
                      dim=-1).transpose(0, 1)                 # (H, t, dq)
        v = kvb[..., nope:].transpose(0, 1)                   # (H, t, dv)
        qh = q.transpose(0, 1)
        for s in range(0, t, q_chunk):
            e = min(s + q_chunk, t)
            sc = qh[:, s:e] @ k[:, :e].transpose(1, 2) * scale
            qpos = torch.arange(s, e, device=h.device)[:, None]
            kpos = torch.arange(e, device=h.device)[None, :]
            sc = sc.masked_fill(kpos > qpos, float("-inf"))
            o = torch.softmax(sc, dim=-1) @ v[:, :e]          # (H, cq, dv)
            out[i, s:e] = o.transpose(0, 1).reshape(e - s, H * dv)
        del q, kv, kvb, k, v, qh
    return out @ w["wo"]


@dataclass
class RouteStats:
    route_gap: float = 0.0
    near_ties: int = 0
    pairs: int = 0


def route(m: Dict, h2, w, follow: Optional[torch.Tensor], tau: float,
          stats: RouteStats):
    """The experts each row of ``h2`` (n, d) takes and their weights, both
    (n, topk): the reference's own top set, or the program's ``follow``
    (n, topk) where it is a top set to within ``tau``."""
    k = m["num_experts_per_tok"]
    s = torch.sigmoid(h2 @ w["router"])
    z = s + w["e_bias"]
    own = torch.topk(z, k, dim=-1).indices
    chosen = own
    if follow is not None:
        p = follow.long()
        inside = torch.zeros_like(z, dtype=torch.bool).scatter_(1, p, True)
        low = z.masked_fill(~inside, float("inf")).min(-1).values
        high = z.masked_fill(inside, float("-inf")).max(-1).values
        gap = (high - low).clamp_min(0.0)
        ok = gap <= tau
        chosen = torch.where(ok[:, None], p, own)
        differ = (p.sort(-1).values != own.sort(-1).values).any(-1)
        stats.near_ties += int((differ & ok).sum())
        stats.route_gap = max(stats.route_gap, float(gap.max()))
    stats.pairs += h2.shape[0]
    wt = s.gather(1, chosen)
    if m["norm_topk_prob"]:
        wt = wt / wt.sum(-1, keepdim=True)
    return chosen, wt * m["routed_scaling_factor"]


def moe(m: Dict, h2, w, chosen, wt):
    """The routed experts, each over the rows that chose it, plus the
    shared experts."""
    out = swiglu(h2, w["shared_gate_up"], w["shared_down"])
    for e in range(m["n_routed_experts"]):
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(h2[rows], w["expert_gate_up"][e], w["expert_down"][e])
            out.index_add_(0, rows, y * wt[rows, slot][:, None])
    return out


@dataclass
class Result:
    hidden: torch.Tensor         # (r, t - out_from, d): final normed hidden
    routes: torch.Tensor         # (routed layers, r, t, topk): taken
    stats: RouteStats


def forward(m: Dict, tokens: torch.Tensor,
            layer_w: Callable[[int], Dict[str, torch.Tensor]],
            outer: Dict[str, torch.Tensor], out_from: int,
            follow: Optional[torch.Tensor] = None, tau: float = TAU,
            q_chunk: int = 512) -> Result:
    """Every layer over ``tokens`` (r, t) from position 0; returns the
    final normed hidden state of positions ``out_from ..`` and the
    experts taken.  ``follow``: the program's routes (routed layers, r, t,
    topk), followed within ``tau`` (module docstring)."""
    r, t = tokens.shape
    eps = m["rms_norm_eps"]
    dense = m["first_k_dense_replace"]
    cos, sin = rope_tables(t, m["qk_rope_head_dim"], m["rope_theta"],
                           tokens.device)
    x = outer["embed"][tokens.long()]
    taken = []
    stats = RouteStats()
    for layer in range(m["num_hidden_layers"]):
        w = layer_w(layer)
        x = x + attention(m, rms_norm(x, w["attn_norm"], eps), w, cos, sin,
                          q_chunk)
        h2 = rms_norm(x, w["ffn_norm"], eps).view(r * t, -1)
        if layer < dense:
            y = swiglu(h2, w["dense_gate_up"], w["dense_down"])
        else:
            f = (follow[layer - dense].reshape(r * t, -1)
                 if follow is not None else None)
            chosen, wt = route(m, h2, w, f, tau, stats)
            y = moe(m, h2, w, chosen, wt)
            taken.append(chosen.view(r, t, -1))
        x = x + y.view(r, t, -1)
        del w, h2, y
    hidden = rms_norm(x[:, out_from:], outer["final_norm"], eps)
    return Result(hidden=hidden, routes=torch.stack(taken), stats=stats)
