"""What the ``ralm_doc_hybrid`` cells make from ``--seed`` for a
``kimi_linear`` configuration: each layer's weights (drawn from a
generator of its own, so that the reference can draw one layer again
without the rest), and the embedding, final norm and head.  Drawn on the
device in the configuration's dtype (the KDA decay parameters and the
router's bias in float32), as ``mla_inputs.py`` draws Moonlight's; the
prompts and rows to check are ``mla_inputs``'.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.inputs import generator
from portbench.mla_inputs import E_BIAS, NEAR_ONE, Q_GAIN
from portbench.reference.kimi_linear import kinds

FB_GAIN = 0.1             # W_fb: the decay set by dt_bias
A_RANGE = (1.0, 16.0)     # exp(A_log) uniform, a head
DT_RANGE = (1e-3, 1e-1)   # softplus(dt_bias) log-uniform, a channel


def layer_weights(m: Dict, seed: int, layer: int, device, dtype
                  ) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s weights under the program's names (a layer's slice
    of ``KimiLinearParams``): its norms, its KDA or MLA weights, then the
    dense FFN's or the router's (all ``router_experts``), the bias's, the
    held routed experts' (``num_experts`` of them) and the shared
    expert's."""
    g = generator(seed, f"kimi.layer{layer}", device)
    d = m["hidden_size"]
    out = (2 * m["num_hidden_layers"]) ** -0.5

    def normal(shape, scale, dt=dtype):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dt) * scale

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                           dtype=torch.float32)

    w = {"attn_norm": 1.0 + normal((d,), NEAR_ONE),
         "ffn_norm": 1.0 + normal((d,), NEAR_ONE)}
    if kinds(m)[layer][0] == "kda":
        lin = m["linear_attn_config"]
        H, K, W = lin["num_heads"], lin["head_dim"], lin[
            "short_conv_kernel_size"]
        HK = H * K
        dt = torch.exp(uniform((HK,), math.log(DT_RANGE[0]),
                               math.log(DT_RANGE[1])))
        w.update({
            "kda_in": normal((d, 3 * HK + 2 * K + H), d ** -0.5),
            "kda_conv": normal((W, 3 * HK), W ** -0.5),
            "kda_fb": normal((K, HK), FB_GAIN * K ** -0.5),
            "kda_gb": normal((K, HK), K ** -0.5),
            "kda_a_log": torch.log(uniform((H,), *A_RANGE)),
            "kda_dt_bias": torch.log(torch.expm1(dt)),
            "kda_o_norm": 1.0 + normal((K,), NEAR_ONE),
            "kda_wo": normal((HK, d), out * HK ** -0.5)})
    else:
        H = m["num_attention_heads"]
        r, nope, rope, dv = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                             m["qk_rope_head_dim"], m["v_head_dim"])
        w.update({
            "wq": normal((d, H * (nope + rope)), Q_GAIN * d ** -0.5),
            "wkv_a": normal((d, r + rope), d ** -0.5),
            "kv_norm": 1.0 + normal((r,), NEAR_ONE),
            "wkv_b": normal((r, H * (nope + dv)), r ** -0.5),
            "wo": normal((H * dv, d), out * (H * dv) ** -0.5)})
    if layer < m["first_k_dense_replace"]:
        f = m["intermediate_size"]
        w["dense_gate_up"] = normal((d, 2 * f), d ** -0.5)
        w["dense_down"] = normal((f, d), out * f ** -0.5)
        return w
    E, En, fe = (m["router_experts"], m["num_experts"],
                 m["moe_intermediate_size"])
    fs = m["num_shared_experts"] * fe
    w["router"] = normal((d, E), d ** -0.5)
    w["e_bias"] = normal((E,), E_BIAS, torch.float32)
    w["expert_gate_up"] = normal((En, d, 2 * fe), d ** -0.5)
    w["expert_down"] = normal((En, fe, d), out * fe ** -0.5)
    w["shared_gate_up"] = normal((d, 2 * fs), d ** -0.5)
    w["shared_down"] = normal((fs, d), out * fs ** -0.5)
    return w


def outer_weights(m: Dict, seed: int, device, dtype
                  ) -> Dict[str, torch.Tensor]:
    """The embedding (N(0, 1)), the final norm and the untied head."""
    g = generator(seed, "kimi.outer", device)
    d, V = m["hidden_size"], m["vocab_size"]
    return {"embed": torch.randn((V, d), generator=g, device=device,
                                 dtype=dtype),
            "final_norm": 1.0 + torch.randn((d,), generator=g, device=device,
                                            dtype=dtype) * NEAR_ONE,
            "head": torch.randn((d, V), generator=g, device=device,
                                dtype=dtype) * d ** -0.5}
