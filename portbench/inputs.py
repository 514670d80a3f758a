"""What the benchmark makes from ``--seed``: the sub-seeds of each input,
the model weights, and the traffic's own draws (first tokens, query
order).  Everything is drawn on the device with a ``torch.Generator``
there, in a few large calls, in the dtype it is served in.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch


def sub_seed(seed: int, what: str) -> int:
    """A 31-bit seed for one input, from the run's seed and the input's
    name: any seed (also past 2^32) gives the same inputs every time."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def generator(seed: int, what: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, what))
    return g


def _stack_weights(m: Dict, n_layers: int, g, device, dtype,
                   cross: bool) -> Dict[str, torch.Tensor]:
    d, f = m["embed_dim"], m["ffn_embed_dim"]
    L = n_layers

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dtype) * scale

    def near_one(shape):
        return 1.0 + normal(shape, 0.02)

    w = {"embed": normal((m["vocab_size"], d), d ** -0.5),
         "pos": normal((m["max_seq_len"], d), 0.02),
         "ln1_scale": near_one((L, d)), "ln1_bias": normal((L, d), 0.02),
         "wqkv": normal((L, d, 3 * d), d ** -0.5),
         "wo": normal((L, d, d), d ** -0.5),
         "ln2_scale": near_one((L, d)), "ln2_bias": normal((L, d), 0.02),
         "w1": normal((L, d, f), d ** -0.5), "b1": normal((L, f), 0.02),
         "w2": normal((L, f, d), f ** -0.5), "b2": normal((L, d), 0.02),
         "lnf_scale": near_one((d,)), "lnf_bias": normal((d,), 0.02)}
    if cross:
        w.update({"c_ln_scale": near_one((L, d)),
                  "c_ln_bias": normal((L, d), 0.02),
                  "c_wq": normal((L, d, d), d ** -0.5),
                  "c_wkv": normal((L, d, 2 * d), d ** -0.5),
                  "c_wo": normal((L, d, d), d ** -0.5)})
    return w


def make_weights(m: Dict, seed: int, device, dtype
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The model's weights from the seed: ``{"decoder": ...}`` and, for an
    encoder-decoder, ``"encoder"``."""
    g = generator(seed, "weights", device)
    enc_dec = m["model_type"] == "encoder-decoder"
    out = {"decoder": _stack_weights(m, m["layers"], g, device, dtype,
                                     cross=enc_dec)}
    out["decoder"]["out_proj"] = torch.randn(
        (m["embed_dim"], m["vocab_size"]), generator=g, device=device,
        dtype=dtype) * m["embed_dim"] ** -0.5
    if enc_dec:
        out["encoder"] = _stack_weights(m, m["encoder_layers"], g, device,
                                        dtype, cross=False)
    return out


def first_tokens(seed: int, generations: int, batch: int, vocab: int,
                 device) -> torch.Tensor:
    """Each generation's first token a row, (generations, batch) int32 in
    [1, vocab)."""
    g = generator(seed, "first_tokens", device)
    return torch.randint(1, vocab, (generations, batch), generator=g,
                         device=device, dtype=torch.int32)


def sample(seed: int, what: str, n: int, k: int) -> list:
    """``k`` distinct numbers of ``range(n)`` drawn from the seed, sorted."""
    g = torch.Generator()
    g.manual_seed(sub_seed(seed, what))
    return sorted(torch.randperm(n, generator=g)[:k].tolist())
