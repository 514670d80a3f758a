"""The plain reference of the Kimi-Linear block (``model_type``
``kimi_linear``: Kimi-Linear-48B-A3B), in float32.

Written from the model's equations, with plain torch operations, no
cache, no chunking, no absorption and no kernel of the program.  A KDA
layer: h·W_q, h·W_k, h·W_v, the causal depthwise convolution of width
``short_conv_kernel_size`` over positions and SiLU, q and k L2-normed
(eps 1e-6 under the root) and q scaled by head_dim^-0.5; the decay a =
−exp(A_log)·softplus(h·W_fa·W_fb + dt_bias), β = sigmoid(h·W_b); the
recurrence run position by position from an empty state (S ← Diag(e^a)S;
S ← S + βk(v − Sᵀk)ᵀ; o = Sᵀq); o normed per head (eps ``rms_norm_eps``)
times its weight and sigmoid(h·W_ga·W_gb), then W_o.  An MLA layer: the
latent h·W_kva, its first ``kv_lora_rank`` entries normed and decompressed
by W_kvb into each head's [k_nope | v], the k_pe all heads share, no rotary
embedding (``mla_use_nope``), causal attention at scale (nope +
rope)^-0.5.  Then a SwiGLU in the dense layers and, in the routed ones,
sigmoid scores over all ``router_experts``, the top
``num_experts_per_token`` of the scores plus the bias, the chosen scores
over their sum times ``routed_scaling_factor``; each expert this chip
holds (the first ``num_experts``) run over the rows that chose it in a
loop, an expert not held adding nothing, plus the shared expert.  Matmuls
run with TF32 off (``model.no_tf32``).

It goes layer by layer (``layer_w(l)`` draws layer l's weights again from
the seed), so that the float32 model is never held whole; attention runs
a row and ``q_chunk`` queries at a time.  Routing near-ties are followed
as in ``mla_moe.py`` (its ``route``, over all ``router_experts`` choices,
held or not).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.mla_moe import TAU, RouteStats, rms_norm, route, swiglu


@dataclass
class Result:
    hidden: torch.Tensor         # (r, t - out_from, d): final normed hidden
    routes: torch.Tensor         # (routed layers, r, t, topk): taken
    states: torch.Tensor         # (KDA layers, r, H, K, K): after position t
    stats: RouteStats


def kinds(m: Dict):
    """Each layer's kind and index among its kind (the 1-based published
    ``full_attn_layers`` are the MLA layers)."""
    full = set(m["linear_attn_config"]["full_attn_layers"])
    count, out = {"kda": 0, "mla": 0}, []
    for l in range(1, m["num_hidden_layers"] + 1):
        kind = "mla" if l in full else "kda"
        out.append((kind, count[kind]))
        count[kind] += 1
    return out


def kda(m: Dict, h, w):
    """A KDA layer over ``h`` (r, t, d), from an empty state → (its output
    (r, t, d), the state after the last position (r, H, K, K))."""
    r, t, _ = h.shape
    lin = m["linear_attn_config"]
    H, K, W = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
    HK = H * K
    x, fa, ga, bl = (h @ w["kda_in"]).split([3 * HK, K, K, H], dim=-1)
    xp = F.pad(x, (0, 0, W - 1, 0))
    conv = sum(xp[:, j:j + t] * w["kda_conv"][j] for j in range(W))
    del x, xp
    q, k, v = F.silu(conv).view(r, t, 3, H, K).unbind(2)
    del conv
    q = q / torch.sqrt(q.pow(2).sum(-1, keepdim=True) + 1e-6) * K ** -0.5
    k = k / torch.sqrt(k.pow(2).sum(-1, keepdim=True) + 1e-6)
    a = -torch.exp(w["kda_a_log"])[:, None] * F.softplus(
        (fa @ w["kda_fb"]).view(r, t, H, K) + w["kda_dt_bias"].view(H, K))
    alpha = torch.exp(a)
    beta = torch.sigmoid(bl)
    S = h.new_zeros(r * H, K, K)
    o = h.new_empty(r, t, H, K)
    for s in range(t):
        S.mul_(alpha[:, s].reshape(r * H, K, 1))
        ks = k[:, s].reshape(r * H, 1, K)
        u = (v[:, s].reshape(r * H, 1, K) - torch.bmm(ks, S)) * beta[
            :, s].reshape(r * H, 1, 1)
        S.baddbmm_(ks.transpose(1, 2), u)
        o[:, s] = torch.bmm(q[:, s].reshape(r * H, 1, K), S).view(r, H, K)
    gate = torch.sigmoid(ga @ w["kda_gb"]).view(r, t, H, K)
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + m["rms_norm_eps"])
    o = o * w["kda_o_norm"] * gate
    return o.reshape(r, t, HK) @ w["kda_wo"], S.view(r, H, K, K)


def mla(m: Dict, h, w, q_chunk: int):
    """Decompressed latent attention over ``h`` (r, t, d), causal, no
    rotary embedding, a row and ``q_chunk`` queries at a time."""
    r, t, _ = h.shape
    H, nope, rp, dv = (m["num_attention_heads"], m["qk_nope_head_dim"],
                       m["qk_rope_head_dim"], m["v_head_dim"])
    kr = m["kv_lora_rank"]
    scale = (nope + rp) ** -0.5
    out = torch.empty((r, t, H * dv), device=h.device)
    for i in range(r):
        q = (h[i] @ w["wq"]).view(t, H, nope + rp).transpose(0, 1)
        kv = h[i] @ w["wkv_a"]
        c = rms_norm(kv[:, :kr], w["kv_norm"], m["rms_norm_eps"])
        kvb = (c @ w["wkv_b"]).view(t, H, nope + dv)
        k = torch.cat([kvb[..., :nope], kv[:, None, kr:].expand(t, H, rp)],
                      dim=-1).transpose(0, 1)                 # (H, t, dq)
        v = kvb[..., nope:].transpose(0, 1)                   # (H, t, dv)
        for s in range(0, t, q_chunk):
            e = min(s + q_chunk, t)
            sc = q[:, s:e] @ k[:, :e].transpose(1, 2) * scale
            qpos = torch.arange(s, e, device=h.device)[:, None]
            kpos = torch.arange(e, device=h.device)[None, :]
            sc = sc.masked_fill(kpos > qpos, float("-inf"))
            o = torch.softmax(sc, dim=-1) @ v[:, :e]          # (H, cq, dv)
            out[i, s:e] = o.transpose(0, 1).reshape(e - s, H * dv)
        del q, kv, kvb, k, v
    return out @ w["wo"]


def moe(m: Dict, h2, w, chosen, wt):
    """The held routed experts (ids 0 .. ``num_experts`` − 1), each over
    the rows that chose it, plus the shared expert; a route to an expert
    not held adds nothing."""
    out = swiglu(h2, w["shared_gate_up"], w["shared_down"])
    for e in range(m["num_experts"]):
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(h2[rows], w["expert_gate_up"][e], w["expert_down"][e])
            out.index_add_(0, rows, y * wt[rows, slot][:, None])
    return out


def _routing(m: Dict) -> Dict:
    """``m`` under the names ``mla_moe.route`` reads."""
    return {"num_experts_per_tok": m["num_experts_per_token"],
            "norm_topk_prob": m["moe_renormalize"],
            "routed_scaling_factor": m["routed_scaling_factor"]}


def forward(m: Dict, tokens: torch.Tensor,
            layer_w: Callable[[int], Dict[str, torch.Tensor]],
            outer: Dict[str, torch.Tensor], out_from: int,
            follow: Optional[torch.Tensor] = None, tau: float = TAU,
            q_chunk: int = 512) -> Result:
    """Every layer over ``tokens`` (r, t) from position 0; returns the
    final normed hidden state of positions ``out_from ..``, the experts
    taken and each KDA layer's state after the last position.
    ``follow``: the program's routes (routed layers, r, t, topk), followed
    within ``tau`` (``mla_moe.py``)."""
    r, t = tokens.shape
    eps = m["rms_norm_eps"]
    dense = m["first_k_dense_replace"]
    rm = _routing(m)
    x = outer["embed"][tokens.long()]
    taken, states = [], []
    stats = RouteStats()
    for layer, (kind, _) in enumerate(kinds(m)):
        w = layer_w(layer)
        h = rms_norm(x, w["attn_norm"], eps)
        if kind == "kda":
            o, S = kda(m, h, w)
            states.append(S)
        else:
            o = mla(m, h, w, q_chunk)
        x = x + o
        del h, o
        h2 = rms_norm(x, w["ffn_norm"], eps).view(r * t, -1)
        if layer < dense:
            y = swiglu(h2, w["dense_gate_up"], w["dense_down"])
        else:
            f = (follow[layer - dense].reshape(r * t, -1)
                 if follow is not None else None)
            chosen, wt = route(rm, h2, w, f, tau, stats)
            y = moe(m, h2, w, chosen, wt)
            taken.append(chosen.view(r, t, -1))
        x = x + y.view(r, t, -1)
        del w, h2, y
    hidden = rms_norm(x[:, out_from:], outer["final_norm"], eps)
    return Result(hidden=hidden, routes=torch.stack(taken),
                  states=torch.stack(states), stats=stats)
