"""The ``deepseek_v3`` family of the system under test, reached through its
public entry points: its config, the parameter container the benchmark's
weights are written into, the latent cache and the RALM loop.  With
``program.py`` the only modules of the harness that import the program.
"""

from __future__ import annotations

from typing import Dict

import torch

from chamjax_torch.models.mla_moe import (MlaMoeConfig, MlaMoeParams,
                                          dtype_of)
from chamjax_torch.serving.ralm import RalmDecoder

from portbench import mla_inputs

# the weights stacked over the routed layers alone
ROUTED = ("router", "e_bias", "expert_gate_up", "expert_down",
          "shared_gate_up", "shared_down")


def model_config(cfg: Dict) -> MlaMoeConfig:
    """The program's config from the configuration file: the published
    keys at its top level, the loop's beside them."""
    return MlaMoeConfig.from_dict(cfg)


def model_dtype(cfg: Dict) -> torch.dtype:
    return dtype_of(model_config(cfg))


@torch.no_grad()
def params(cfg: Dict, seed: int, device) -> MlaMoeParams:
    """The program's parameters, holding the benchmark's weights drawn
    from the seed layer by layer (``mla_inputs``), the absorbed
    up-projections written from them."""
    mc = model_config(cfg)
    dtype = dtype_of(mc)
    p = MlaMoeParams(mc, device=device, dtype=dtype)
    for name, t in mla_inputs.outer_weights(cfg, seed, device, dtype).items():
        getattr(p, name).copy_(t)
    for layer in range(mc.layers):
        for name, t in mla_inputs.layer_weights(cfg, seed, layer, device,
                                                dtype).items():
            i = layer - mc.dense_layers if name in ROUTED else layer
            getattr(p, name)[i].copy_(t)
    p.absorb()
    return p


def loop(cfg: Dict, p: MlaMoeParams, retriever, batch: int) -> RalmDecoder:
    """The RALM loop over ``retriever``, on the family's own latent cache
    (``max_seq_len`` positions, each position's routes recorded)."""
    return RalmDecoder(p, model_config(cfg), retriever, batch,
                       nprobe=cfg["search"]["nprobe"], k=cfg["search"]["k"])
