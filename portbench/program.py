"""The system under test, reached through its public entry points: the
corpus draw, the index build and the retriever, the parameter containers
that the benchmark's weights are written into, and the RALM loops.  The
only module of the harness that imports the program (``chamjax_torch``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from chamjax_torch.config import IndexConfig, ModelConfig, SearchConfig
from chamjax_torch.data import synthetic_dataset_device
from chamjax_torch.index import build_ivfpq
from chamjax_torch.models.transformer import TransformerParams, dtype_of
from chamjax_torch.retrieval.local import LocalRetriever
from chamjax_torch.serving.ralm import RalmDecoder, RalmEncoderDecoder

from portbench.inputs import sub_seed


def model_config(cfg: Dict) -> ModelConfig:
    return ModelConfig(**cfg["model"])


def model_dtype(cfg: Dict) -> torch.dtype:
    return dtype_of(model_config(cfg))


def _dataset(cfg: Dict, seed: int, device, parts, queries: int = 0):
    ix = cfg["index"]
    return synthetic_dataset_device(
        nb=ix["nb"], nq=max(queries, 1), nt=ix["nt"], d=ix["dim"],
        seed=sub_seed(seed, "corpus"), n_clusters=ix["n_clusters"],
        chunk=max(8192, (1 << 26) // ix["dim"]), parts=parts,
        to_host=False, device=device)


def corpus(cfg: Dict, seed: int, device) -> torch.Tensor:
    """The index's corpus ``xb`` drawn again from the seed on ``device``,
    as ``build`` drew it: what the check reads once the window has
    closed."""
    return _dataset(cfg, seed, device, ("xb",)).xb


def build(cfg: Dict, seed: int, device, queries: int = 0):
    """Draw the corpus (and ``queries`` queries off its distribution) on
    ``device`` from the seed, build the index there and put a retriever
    over it.  Returns ``(retriever, tables, xq)``: the index's tables as
    host arrays (what the search reference follows) and the queries, or
    ``None``."""
    ix, sc = cfg["index"], cfg["search"]
    d = ix["dim"]
    parts = ("xb", "xt", "xq") if queries else ("xb", "xt")
    ds = _dataset(cfg, seed, device, parts, queries)
    xq = ds.xq
    index = build_ivfpq(
        ds.xb, IndexConfig(dim=d, nlist=ix["nlist"], m=ix["m"],
                           nbits=ix["nbits"], opq=ix["opq"],
                           list_pad=ix["list_pad"],
                           balanced=ix["balanced"],
                           balance_factor=ix["balance_factor"]),
        xt=ds.xt, seed=sub_seed(seed, "index"),
        kmeans_iters=ix["kmeans_iters"], pq_iters=ix["pq_iters"],
        device=device)
    del ds
    retriever = LocalRetriever(
        index, SearchConfig(nprobe=sc["nprobe"], k=sc["k"],
                            lut_bf16=sc["lut_bf16"],
                            seg_group=sc["seg_group"]), device=device)
    tables = {name: np.asarray(getattr(index, name)) for name in
              ("centroids", "codebooks", "codes", "ids", "list_start",
               "list_len")}
    tables["ntotal"] = int(index.ntotal)
    return retriever, tables, xq


_STACK = ("ln1_scale", "ln1_bias", "wqkv", "wo", "ln2_scale", "ln2_bias",
          "w1", "b1", "w2", "b2")
_CROSS = {"c_ln_scale": "ln_scale", "c_ln_bias": "ln_bias", "c_wq": "wq",
          "c_wkv": "wkv", "c_wo": "wo"}


@torch.no_grad()
def params(cfg: Dict, w: Dict[str, torch.Tensor], encoder: bool, device
           ) -> TransformerParams:
    """The program's parameter container, holding a copy of the
    benchmark's weights ``w``."""
    mc = model_config(cfg)
    p = TransformerParams(
        mc, n_layers=mc.encoder_layers if encoder else mc.layers,
        n_out=1 if encoder else mc.vocab_size,
        cross_attention=not encoder and "c_wq" in w, device=device,
        dtype=dtype_of(mc))
    p.embed.copy_(w["embed"])
    p.pos.copy_(w["pos"])
    for name in _STACK:
        getattr(p.layers, name).copy_(w[name])
    p.ln_f["scale"].copy_(w["lnf_scale"])
    p.ln_f["bias"].copy_(w["lnf_bias"])
    if not encoder:
        p.out_proj.copy_(w["out_proj"])
    if p.cross_layers is not None:
        for src, dst in _CROSS.items():
            getattr(p.cross_layers, dst).copy_(w[src])
    return p


def loop(cfg: Dict, weights: Dict, retriever, batch: int, device):
    """The configuration's RALM loop over ``retriever``."""
    mc = model_config(cfg)
    sc = cfg["search"]
    dec = params(cfg, weights["decoder"], False, device)
    if mc.model_type == "encoder-decoder":
        enc = params(cfg, weights["encoder"], True, device)
        return RalmEncoderDecoder(enc, dec, mc, retriever, batch,
                                  retrieval_interval=mc.retrieval_interval,
                                  nprobe=sc["nprobe"], k=sc["k"])
    return RalmDecoder(dec, mc, retriever, batch,
                       retrieval_interval=mc.retrieval_interval,
                       nprobe=sc["nprobe"], k=sc["k"])
