"""Bidirectional multi-head attention over a key-padded context: the
attention of an encoder layer (``models/transformer.py::_attn_full`` with
``causal=False``, which ``_encoder_forward`` and its tensor-parallel core
call).

``attend`` launches the hand-written kernel
``chamjax_torch/csrc/encode_attend.cu`` on a CUDA tensor and runs the
plain version ``attend_reference`` on a CPU tensor.  The plain version is
``_attn_full``'s arithmetic without the causal mask, as the JAX package
writes it (scores and softmax in float32, the probabilities rounded to the
inputs' dtype before p·V); the kernel computes the same scores on the
tensor cores with float32 sums, keeps the softmax in float32 on chip,
rounds p to bfloat16 for p·V as the plain version does, sums p·V in
float32 and rounds the output once.  The JAX package has no kernel here:
XLA compiles the einsums.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from chamjax_torch.utils import cuda_lib

HEAD_DIMS = (64, 128)       # the kernel's instantiations
_LENGTH_DTYPES = {torch.int32: 0, torch.int64: 1}


def attend_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Plain version of :func:`attend`: ``_attn_full(causal=False)`` op for
    op — the scores in float32, keys at or past a row's ``valid_len`` set
    to -inf, a softmax, the probabilities rounded to ``q``'s dtype, p·V."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    tk = k.shape[1]
    if valid_len is not None:   # per-batch key padding mask (b,)
        pos = torch.arange(tk, device=q.device)[None, None, None, :]
        scores = scores.masked_fill(pos >= valid_len[:, None, None, None],
                                    float("-inf"))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _check(q, k, v, valid_len) -> None:
    for t in (q, k, v):
        if t.dim() != 4:
            raise ValueError(f"encode_attend: (b, s, h, hd) tensors, got "
                             f"{tuple(t.shape)}")
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError("encode_attend: q, k and v in bfloat16 on one "
                             "device")
    b, _, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"encode_attend: head_dim {hd} (one of "
                         f"{HEAD_DIMS})")
    if (k.shape != v.shape or (k.shape[0], *k.shape[2:]) != (b, h, hd)
            or k.shape[1] == 0):
        raise ValueError(f"encode_attend: K {tuple(k.shape)} and V "
                         f"{tuple(v.shape)} against q's {tuple(q.shape)}")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("encode_attend: each head's values must be "
                             "contiguous")
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                    for st in strides):
            raise ValueError("encode_attend: rows, positions and heads must "
                             "be 16-byte aligned")
    if valid_len is not None and (
            valid_len.device != q.device or valid_len.dim() != 1
            or valid_len.numel() not in (1, b)
            or valid_len.dtype not in _LENGTH_DTYPES):
        raise ValueError("encode_attend: valid_len is one int32 or int64 "
                         "count a row (or one for all), on q's device")
    if b > 65535 or h > 65535:
        raise ValueError(f"encode_attend: {b} rows of {h} heads (at most "
                         f"65535 each)")


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q`` (b, sq, h, hd) against the keys ``[0, valid_len)`` of ``k`` and
    ``v`` (b, sk, h, hd) → (b, sq, h, hd) in ``q``'s dtype, contiguous.

    ``valid_len``: one count a row (b,), or None (all sk keys); a row that
    holds no key is NaN, as the plain version's softmax over -inf.  On a
    CUDA tensor the kernel reads q, k and v in place (strided views of a
    fused QKV product: each head's values contiguous, 16-byte aligned),
    takes bfloat16 and head dims 64 and 128 and raises on anything else,
    and never reads a key at or past a row's count; each launch counts in
    ``cuda_lib.launch_counts["encode_attend"]``."""
    dev = q.device
    if dev.type == "cpu":
        return attend_reference(q, k, v, valid_len)
    if dev.type != "cuda":
        raise ValueError(f"encode_attend: unsupported device {dev}")
    _check(q, k, v, valid_len)
    b, sq, h, hd = q.shape
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev)
    if b == 0 or sq == 0:
        return out
    lens = (None, 0, 0)                 # no length: all sk keys
    if valid_len is not None:
        lens = (valid_len.data_ptr(),
                valid_len.stride(0) if valid_len.numel() > 1 else 0,
                _LENGTH_DTYPES[valid_len.dtype])
    lib = cuda_lib.load("encode_attend")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chamjax_encode_attend(
            q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], *lens, out.data_ptr(), b, sq,
            k.shape[1], h, hd, hd ** -0.5 * math.log2(math.e), stream)
    cuda_lib.check(lib, err, "encode_attend")
    cuda_lib.launch_counts["encode_attend"] += 1
    return out
