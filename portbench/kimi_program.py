"""The ``kimi_linear`` family of the system under test, reached through its
public entry points: its config (the chip's share of the routed experts
named), the parameter container the benchmark's weights are written into,
and the RALM loop on the family's own cache.
"""

from __future__ import annotations

from typing import Dict

import torch

from chamjax_torch.models.kimi_linear import (KimiLinearConfig,
                                              KimiLinearParams, dtype_of)
from chamjax_torch.serving.ralm import RalmDecoder

from portbench import kimi_inputs

# the weights stacked over the routed layers alone, and by layer kind
ROUTED = ("router", "e_bias", "expert_gate_up", "expert_down",
          "shared_gate_up", "shared_down")
BY_KIND = ("kda_in", "kda_conv", "kda_fb", "kda_gb", "kda_a_log",
           "kda_dt_bias", "kda_o_norm", "kda_wo", "wq", "wkv_a", "kv_norm",
           "wkv_b", "wo")


def model_config(cfg: Dict) -> KimiLinearConfig:
    """The program's config from the configuration file: the published
    keys at its top level, the router at its published width
    (``router_experts``) and the experts held here (the first
    ``num_experts``), the loop's keys beside them."""
    return KimiLinearConfig.from_dict(
        {**cfg, "num_experts": cfg["router_experts"],
         "experts_held": (0, cfg["num_experts"])})


def model_dtype(cfg: Dict) -> torch.dtype:
    return dtype_of(model_config(cfg))


@torch.no_grad()
def params(cfg: Dict, seed: int, device) -> KimiLinearParams:
    """The program's parameters, holding the benchmark's weights drawn
    from the seed layer by layer (``kimi_inputs``), the absorbed
    up-projections written from them."""
    mc = model_config(cfg)
    dtype = dtype_of(mc)
    p = KimiLinearParams(mc, device=device, dtype=dtype)
    for name, t in kimi_inputs.outer_weights(cfg, seed, device,
                                             dtype).items():
        getattr(p, name).copy_(t)
    for layer, (kind, i) in enumerate(mc.slots):
        for name, t in kimi_inputs.layer_weights(cfg, seed, layer, device,
                                                 dtype).items():
            at = (layer - mc.dense_layers if name in ROUTED
                  else i if name in BY_KIND else layer)
            getattr(p, name)[at].copy_(t)
    p.absorb()
    return p


def loop(cfg: Dict, p: KimiLinearParams, retriever, batch: int
         ) -> RalmDecoder:
    """The RALM loop over ``retriever``, on the family's own cache
    (``max_seq_len`` positions, the routes recorded, the prompt's
    snapshot)."""
    return RalmDecoder(p, model_config(cfg), retriever, batch,
                       nprobe=cfg["search"]["nprobe"], k=cfg["search"]["k"])
