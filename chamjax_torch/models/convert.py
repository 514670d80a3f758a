"""Carry the JAX package's model parameters into the port.

The input is the JAX parameter tree as numpy arrays: a ``TransformerParams``
after ``jax.tree.map(np.asarray, p)`` (read by attribute) or the llama dict
(read by key).  Parameter names are shared, so the conversion is a name
map: each port parameter ``a.b`` is read at ``tree.a["b"]``.  Arrays go
through float32 on the host (numpy's bfloat16 arrays, which JAX hands out
for bf16 parameters, are not accepted by ``torch.from_numpy``) and are cast
to the config's dtype on the device, which is exact for bf16 values.

The IR encoders' parameters are plain dicts of arrays
(``JaxDualEncoder.params``, ``JaxSparseEncoder.params``);
``dual_encoder_from_numpy`` and ``sparse_encoder_from_numpy`` build the
port's ``nn.Module`` from them, its sizes read from the arrays' shapes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from chamjax_torch.config import ModelConfig
from chamjax_torch.ir.models import DualEncoder, SparseEncoder
from chamjax_torch.models.llama import LlamaParams
from chamjax_torch.models.transformer import TransformerParams, dtype_of
from chamjax_torch.utils.device import resolve_device


def _lookup(tree, path: str):
    for part in path.split("."):
        tree = tree[part] if isinstance(tree, dict) else getattr(tree, part)
    return tree


@torch.no_grad()
def load_numpy_(module: nn.Module, tree) -> nn.Module:
    """Copy every parameter of ``module`` from the same name in ``tree``;
    raises on a missing name or a shape that differs."""
    for name, p in module.named_parameters():
        a = np.array(_lookup(tree, name), dtype=np.float32)   # a writable copy
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape}, the port's "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(a).to(p.device))
    return module


def decoder_from_numpy(tree, cfg: ModelConfig, device=None
                       ) -> TransformerParams:
    """``init_decoder``'s tree (with cross layers where it has them)."""
    dev = resolve_device(device)
    params = TransformerParams(
        cfg, n_layers=cfg.layers, n_out=cfg.vocab_size,
        cross_attention=_lookup(tree, "cross_layers") is not None,
        device=dev, dtype=dtype_of(cfg))
    return load_numpy_(params, tree)


def encoder_from_numpy(tree, cfg: ModelConfig, device=None
                       ) -> TransformerParams:
    params = TransformerParams(cfg, n_layers=cfg.encoder_layers, n_out=1,
                               device=resolve_device(device),
                               dtype=dtype_of(cfg))
    return load_numpy_(params, tree)


def llama_from_numpy(tree, cfg: ModelConfig, device=None) -> LlamaParams:
    params = LlamaParams(cfg, device=resolve_device(device),
                         dtype=dtype_of(cfg))
    return load_numpy_(params, tree)


def dual_encoder_from_numpy(tree, max_len: int = 32, device=None
                            ) -> DualEncoder:
    """``JaxDualEncoder.params``: ``embed`` (vocab, emb_dim) and the ``q``
    and ``d`` towers' ``w1 b1 w2 b2``."""
    vocab, emb_dim = np.shape(tree["embed"])
    enc = DualEncoder(vocab=vocab, dim=np.shape(tree["q"]["w2"])[1],
                      emb_dim=emb_dim, max_len=max_len, device=device)
    return load_numpy_(enc, tree)


def sparse_encoder_from_numpy(tree, max_len: int = 32,
                              max_expansion: int = 64, device=None
                              ) -> SparseEncoder:
    """``JaxSparseEncoder.params``: ``embed`` (vocab, latent) and ``head``
    (latent, n_buckets)."""
    vocab, latent = np.shape(tree["embed"])
    enc = SparseEncoder(vocab=vocab, n_buckets=np.shape(tree["head"])[1],
                        latent=latent, max_len=max_len,
                        max_expansion=max_expansion, device=device)
    return load_numpy_(enc, tree)
