"""What the ``ralm_doc`` cells make from ``--seed`` for a ``deepseek_v3``
configuration: each layer's weights (drawn from a generator of its own, so
that the reference can draw one layer again without the rest), the
embedding, final norm and head, and the traffic's prompts and rows to
check.  Drawn on the device in the configuration's dtype, as
``inputs.py`` draws the GPT family's.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.inputs import generator

# the weights' scales (the configuration's "assumed" says why)
NEAR_ONE = 0.02           # norms: 1 + N(0, 0.02)
Q_GAIN = 3.0              # W_q: attention that picks out a few positions
E_BIAS = 1e-3             # the router's bias: every expert still chosen


def _out(m: Dict) -> float:
    """Projections back into the residual: over (2·layers)^0.5."""
    return (2 * m["num_hidden_layers"]) ** -0.5


def layer_weights(m: Dict, seed: int, layer: int, device, dtype
                  ) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s weights under the program's names (a layer's slice
    of ``MlaMoeParams``): its attention, then the dense FFN's or the
    router's, the bias's (float32), the routed and shared experts'."""
    g = generator(seed, f"mla.layer{layer}", device)
    d, H = m["hidden_size"], m["num_attention_heads"]
    r, nope, rope, dv = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                         m["qk_rope_head_dim"], m["v_head_dim"])
    out = _out(m)

    def normal(shape, scale, dt=dtype):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dt) * scale

    w = {"attn_norm": 1.0 + normal((d,), NEAR_ONE),
         "wq": normal((d, H * (nope + rope)), Q_GAIN * d ** -0.5),
         "wkv_a": normal((d, r + rope), d ** -0.5),
         "kv_norm": 1.0 + normal((r,), NEAR_ONE),
         "wkv_b": normal((r, H * (nope + dv)), r ** -0.5),
         "wo": normal((H * dv, d), out * (H * dv) ** -0.5),
         "ffn_norm": 1.0 + normal((d,), NEAR_ONE)}
    if layer < m["first_k_dense_replace"]:
        f = m["intermediate_size"]
        w["dense_gate_up"] = normal((d, 2 * f), d ** -0.5)
        w["dense_down"] = normal((f, d), out * f ** -0.5)
        return w
    E, fe = m["n_routed_experts"], m["moe_intermediate_size"]
    fs = m["n_shared_experts"] * fe
    w["router"] = normal((d, E), d ** -0.5)
    w["e_bias"] = normal((E,), E_BIAS, torch.float32)
    w["expert_gate_up"] = normal((E, d, 2 * fe), d ** -0.5)
    w["expert_down"] = normal((E, fe, d), out * fe ** -0.5)
    w["shared_gate_up"] = normal((d, 2 * fs), d ** -0.5)
    w["shared_down"] = normal((fs, d), out * fs ** -0.5)
    return w


def outer_weights(m: Dict, seed: int, device, dtype
                  ) -> Dict[str, torch.Tensor]:
    """The embedding (N(0, 1)), the final norm and the untied head."""
    g = generator(seed, "mla.outer", device)
    d, V = m["hidden_size"], m["vocab_size"]
    return {"embed": torch.randn((V, d), generator=g, device=device,
                                 dtype=dtype),
            "final_norm": 1.0 + torch.randn((d,), generator=g, device=device,
                                            dtype=dtype) * NEAR_ONE,
            "head": torch.randn((d, V), generator=g, device=device,
                                dtype=dtype) * d ** -0.5}


def prompts(seed: int, batch: int, length: int, vocab: int, device
            ) -> torch.Tensor:
    """Each row's document prompt, (batch, length) int32 in [1, vocab)."""
    g = generator(seed, "prompts", device)
    return torch.randint(1, vocab, (batch, length), generator=g,
                         device=device, dtype=torch.int32)
