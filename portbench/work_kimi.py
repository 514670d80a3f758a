"""The yardstick's arithmetic for a ``kimi_linear`` configuration (KDA
beside latent attention, a held share of routed experts): the operations
and bytes of a decode step, of one launch of the KDA decode kernel and of
one launch of the latent attention kernel, counted from the shapes, at the
peaks of ``work.py``.

Counts follow the workload: each weight read once a step; of the routed
experts only those held here (``num_experts`` of ``router_experts``) that
some row of the batch chose, the expected number under uniform routing,
n_held·(1 − (1 − k/E)^b) (55.7 of 64 at b = 64, k = 8, E = 256); each KDA
state (128 × 128 float32 a row and head) read and written once, with the
step's q, k, v, α and β read and o written; each convolution tail read and
written; each held latent read once a row and layer for all heads, each
new latent written once.  Operations are bfloat16 tensor-core products
(the projections, the absorbed up-projections, the held experts a row
routes to, the head, the latent attention's scores and p·V) and float32
for the router and the recurrence.  Nothing here imports torch.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

from portbench.work import BF16, F32, Work


def _lin(m: Dict):
    lin = m["linear_attn_config"]
    return (lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"],
            len(lin["kda_layers"]), len(lin["full_attn_layers"]))


def experts_touched(m: Dict, b: int) -> float:
    """Expected held experts a layer that ``b`` rows touch, each row
    choosing ``num_experts_per_token`` of ``router_experts`` at random."""
    E, k = m["router_experts"], m["num_experts_per_token"]
    return m["num_experts"] * (1.0 - (1.0 - k / E) ** b)


def kda_kernel(m: Dict, b: int) -> Work:
    """One launch of the KDA decode kernel: ``b`` rows of every head; each
    state read and written once, q, k, v, α and β read (float32), o
    written (bfloat16); the decay, Sᵀk, the rank-1 update and Sᵀq."""
    H, K, _, _, _ = _lin(m)
    bh = b * H
    ops = Counter({"f32": 7 * bh * K * K})
    nbytes = bh * (2 * K * K * F32 + 4 * K * F32 + F32 + K * BF16)
    return ops, nbytes


def latent_kernel(m: Dict, b: int, held: int) -> Work:
    """One launch of the latent attention kernel: ``b`` rows of every head
    against ``held`` cached latents and the current token's; the latents
    read once, q read, the output written."""
    H, D, V = (m["num_attention_heads"],
               m["kv_lora_rank"] + m["qk_rope_head_dim"], m["kv_lora_rank"])
    keys = held + 1
    ops = Counter({"bf16": 2 * b * H * keys * (D + V)})
    nbytes = b * keys * D * BF16 + b * H * (D + V) * BF16
    return ops, nbytes


def _kda_weights(m: Dict) -> int:
    """Elements of one KDA layer: the input product (q, k, v, f_a, g_a,
    b), the taps, W_fb, W_gb, A_log, dt_bias, the output norm, W_o and the
    two layer norms."""
    d = m["hidden_size"]
    H, K, W, _, _ = _lin(m)
    HK = H * K
    return (d * (3 * HK + 2 * K + H) + W * 3 * HK + 2 * K * HK + H + HK + K
            + HK * d + 2 * d)


def _mla_weights(m: Dict) -> int:
    """Elements of one MLA layer as a decode step reads them: W_q, W_kva,
    the absorbed W_UK and W_UV, W_o and the three norms."""
    d, H = m["hidden_size"], m["num_attention_heads"]
    r, nope, rp, dv = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                       m["qk_rope_head_dim"], m["v_head_dim"])
    return (d * H * (nope + rp) + d * (r + rp) + H * nope * r + H * r * dv
            + H * dv * d + 2 * d + r)


def decode_step(m: Dict, b: int, held: int) -> Work:
    """One decode step of ``b`` rows at ``held`` cached positions: every
    layer, the head; the KDA states and tails read and written, the
    latents held read once and the new ones written."""
    d, L, V = m["hidden_size"], m["num_hidden_layers"], m["vocab_size"]
    H, K, W, Lk, Lm = _lin(m)
    HK = H * K
    Hm = m["num_attention_heads"]
    r, nope, rp, dv = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                       m["qk_rope_head_dim"], m["v_head_dim"])
    Ld = m["first_k_dense_replace"]
    Lr = L - Ld
    E, k, fe = (m["router_experts"], m["num_experts_per_token"],
                m["moe_intermediate_size"])
    f, fs = m["intermediate_size"], m["num_shared_experts"] * fe
    share = m["num_experts"] / E          # the routes that land here
    ops = Counter()
    ops["bf16"] += 2 * b * Lk * (d * (3 * HK + 2 * K + H) + 2 * K * HK
                                 + HK * d)                 # KDA products
    k_ops, _ = kda_kernel(m, b)
    ops += Counter({p: n * Lk for p, n in k_ops.items()})
    ops["bf16"] += 2 * b * Lm * (d * Hm * (nope + rp) + d * (r + rp)
                                 + Hm * nope * r + Hm * r * dv + Hm * dv * d)
    a_ops, _ = latent_kernel(m, b, held)
    ops += Counter({p: n * Lm for p, n in a_ops.items()})
    ops["bf16"] += 2 * b * Ld * 3 * d * f                     # dense FFN
    ops["f32"] += 2 * b * Lr * d * E                          # router
    ops["bf16"] += 2 * b * Lr * (share * k * 3 * d * fe + 3 * d * fs)
    ops["bf16"] += 2 * b * d * V                              # head
    w = Lk * _kda_weights(m) + Lm * _mla_weights(m) + Ld * (3 * d * f + 2 * d)
    w += Lr * (d * E + 3 * d * fs + experts_touched(m, b) * 3 * d * fe
               + 2 * d)
    w += d * V + d                                            # head, norm
    nbytes = (w + b * d) * BF16 + Lr * E * F32                # + embedding
    nbytes += Lk * (H + HK) * (F32 - BF16)     # A_log, dt_bias in float32
    _, k_bytes = kda_kernel(m, b)
    nbytes += Lk * k_bytes                                    # KDA states
    nbytes += 2 * Lk * b * (W - 1) * 3 * HK * BF16            # tails
    nbytes += Lm * b * held * (r + rp) * BF16                 # latents read
    nbytes += Lm * b * (r + rp) * BF16                        # ... written
    nbytes += b * V * BF16                                    # logits
    return ops, nbytes
