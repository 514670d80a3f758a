"""The yardstick's arithmetic for a ``deepseek_v3`` configuration (latent
attention over a compressed cache, routed experts): the operations and
bytes of a decode step and of one launch of the latent attention kernel,
counted from the shapes, at the peaks of ``work.py``.

Counts follow the workload: each weight read once a step, the routed
experts only where some row of the batch chose them (the expected number
of experts touched under uniform routing, E·(1 − (1 − k/E)^b), 63.9 of 64
at b = 64), each held latent read once a row and layer for all heads, each
new latent written once.  Operations are bfloat16 tensor-core products
(the projections, the absorbed up-projections, the experts, the head, and
the attention's scores and p·V) and float32 for the router.  Nothing here
imports torch.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

from portbench.work import BF16, F32, Work


def experts_touched(m: Dict, b: int) -> float:
    """Expected routed experts a layer that ``b`` rows touch, each row
    choosing ``num_experts_per_tok`` of ``n_routed_experts`` at random."""
    E, k = m["n_routed_experts"], m["num_experts_per_tok"]
    return E * (1.0 - (1.0 - k / E) ** b)


def latent_kernel(m: Dict, b: int, held: int) -> Work:
    """One launch of the latent attention kernel: ``b`` rows of every head
    against ``held`` cached latents and the current token's; the latents
    read once, q read, the output written."""
    H, D, V = m["num_attention_heads"], _latent(m), m["kv_lora_rank"]
    keys = held + 1
    ops = Counter({"bf16": 2 * b * H * keys * (D + V)})
    nbytes = b * keys * D * BF16 + b * H * (D + V) * BF16
    return ops, nbytes


def _latent(m: Dict) -> int:
    return m["kv_lora_rank"] + m["qk_rope_head_dim"]


def _attn_weights(m: Dict) -> int:
    """Elements of one layer's attention as a decode step reads them: W_q,
    W_kva, the absorbed W_UK and W_UV, W_o and the three norms."""
    d, H = m["hidden_size"], m["num_attention_heads"]
    r, nope, rp, dv = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                       m["qk_rope_head_dim"], m["v_head_dim"])
    return (d * H * (nope + rp) + d * (r + rp) + H * nope * r + H * r * dv
            + H * dv * d + 2 * d + r)


def decode_step(m: Dict, b: int, held: int) -> Work:
    """One decode step of ``b`` rows at ``held`` cached positions: every
    layer, the head; the latents held read once and the new ones
    written."""
    d, L, V = m["hidden_size"], m["num_hidden_layers"], m["vocab_size"]
    H = m["num_attention_heads"]
    r, nope, rp, dv = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                       m["qk_rope_head_dim"], m["v_head_dim"])
    Ld = m["first_k_dense_replace"]
    Lm = L - Ld
    E, k, fe = (m["n_routed_experts"], m["num_experts_per_tok"],
                m["moe_intermediate_size"])
    f, fs = m["intermediate_size"], m["n_shared_experts"] * fe
    ops = Counter()
    # projections: q, kv_a, the absorbed up-projections, o
    ops["bf16"] += 2 * b * L * (d * H * (nope + rp) + d * (r + rp)
                                + H * nope * r + H * r * dv + H * dv * d)
    a_ops, _ = latent_kernel(m, b, held)
    ops += Counter({p: n * L for p, n in a_ops.items()})
    ops["bf16"] += 2 * b * Ld * 3 * d * f                     # dense FFN
    ops["f32"] += 2 * b * Lm * d * E                          # router
    ops["bf16"] += 2 * b * Lm * (k * 3 * d * fe + 3 * d * fs)  # experts
    ops["bf16"] += 2 * b * d * V                              # head
    w = L * _attn_weights(m) + Ld * 3 * d * f
    w += Lm * (d * E + 3 * d * fs + experts_touched(m, b) * 3 * d * fe)
    w += d * V + d                                            # head, norm
    nbytes = (w + b * d) * BF16 + Lm * E * F32                # + embedding
    nbytes += L * b * held * _latent(m) * BF16                # latents read
    nbytes += L * b * _latent(m) * BF16                       # ... written
    nbytes += b * V * BF16                                    # logits
    return ops, nbytes
