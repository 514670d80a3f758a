"""Single-query attention against a K/V history: the attention of a decode
step (``models/transformer.py::_decoder_step``, its self-attention over
the KV cache and its cross-attention over the retrieved context).

``attend`` launches the hand-written kernel
``chamjax_torch/csrc/decode_attend.cu`` on a CUDA tensor and runs the
plain version ``attend_reference`` on a CPU tensor.  The plain version is
the step's arithmetic as the JAX package writes it (scores and softmax in
float32, the probabilities rounded to the inputs' dtype before p·V); the
kernel keeps p·V in float32 too and rounds the output once.  The JAX
package has no kernel here: XLA compiles the einsums.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from chamjax_torch.utils import cuda_lib

# the kernel's layout (csrc/decode_attend.cu): a row's held positions split
# over a cluster of up to 8 CTAs of at most MAX_THREADS threads, each thread
# a 16-byte slice of a position's h·hd values
MAX_THREADS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attend_reference(q: torch.Tensor, k_hist: torch.Tensor,
                     v_hist: torch.Tensor,
                     length: Optional[torch.Tensor] = None,
                     self_kv: Optional[Tuple[torch.Tensor, torch.Tensor]]
                     = None) -> torch.Tensor:
    """Plain version of :func:`attend`: the scores of every position in
    float32, those at or past ``length`` set to -inf, a softmax, the
    probabilities rounded to ``q``'s dtype, p·V.  With ``self_kv`` the
    current token's score joins the softmax as one more key, and its value
    enters as a separate term."""
    T, hd = k_hist.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_hist.float()) * hd ** -0.5
    if length is not None:      # a 0-d length, or one a row
        past = torch.arange(T, device=q.device) >= length.reshape(-1, 1)
        scores = scores.masked_fill(past[:, None, None, :], float("-inf"))
    if self_kv is None:
        p = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, v_hist)
    kh, vh = self_kv
    self_score = (q * kh).float().sum(dim=-1) * hd ** -0.5    # (b, 1, h)
    self_score = self_score.transpose(1, 2)[:, :, :, None]     # (b, h, 1, 1)
    p = torch.softmax(torch.cat([scores, self_score], dim=-1),
                      dim=-1).to(q.dtype)
    return (torch.einsum("bhqk,bkhd->bqhd", p[..., :T], v_hist)
            + p[..., T:].transpose(1, 2) * vh)


def _threads(vecs: int) -> int:
    """A CTA's threads: whole passes of ``vecs`` slices, whole warps (0:
    no such count)."""
    passes = MAX_THREADS // vecs
    while passes and (passes * vecs) % 32:
        passes -= 1
    return passes * vecs


@functools.lru_cache(maxsize=None)
def cluster_size(b: int, heads: int, head_dim: int, dtype: torch.dtype,
                 device: int) -> int:
    """The CTAs a row on card ``device``: the most of 8, 4, 2, 1 at which
    the clusters of all ``b`` rows are resident at once (the card's
    occupancy calculator), asked once a shape."""
    lib = cuda_lib.load("decode_attend")
    chunks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.chamjax_decode_attend_chunks(b, heads, head_dim,
                                               _DTYPES[dtype],
                                               ctypes.byref(chunks))
    cuda_lib.check(lib, err, "decode_attend cluster size")
    return chunks.value


def _check(q, k_hist, v_hist, length, self_kv) -> None:
    b, one, h, hd = q.shape
    if one != 1:
        raise ValueError(f"decode_attend: one query a row, got {q.shape}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode_attend: dtype {q.dtype} (float32 or "
                         f"bfloat16)")
    hist = (k_hist, v_hist) + tuple(self_kv or ())
    for t in (q,) + hist:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("decode_attend: q, K, V (and self_kv) on one "
                             "device in one dtype")
        if (t.shape[0], *t.shape[2:]) != (b, h, hd):
            raise ValueError(f"decode_attend: {tuple(t.shape)} against q's "
                             f"{tuple(q.shape)}")
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError("decode_attend: each position's heads must be "
                             "contiguous")
        strides = t.stride()[:2] if t.shape[1] > 1 else t.stride()[:1]
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in strides):
            raise ValueError("decode_attend: rows and positions must be "
                             "16-byte aligned")
    if v_hist.shape[1] != k_hist.shape[1] or any(
            t.shape[1] != 1 for t in self_kv or ()):
        raise ValueError("decode_attend: K and V hold the same positions")
    lanes, rem = divmod(hd * q.element_size(), 16)    # slices a head
    if (rem or lanes > 32 or lanes & (lanes - 1) or h * lanes > MAX_THREADS
            or not _threads(h * lanes)):
        raise ValueError(f"decode_attend: heads {h} x head_dim {hd} in "
                         f"{q.dtype} is not a shape the kernel takes")
    if length is not None and (length.device != q.device
                               or length.numel() not in (1, b)):
        raise ValueError("decode_attend: length is one count, or one a "
                         "row, on q's device")
    if b > 65535:
        raise ValueError(f"decode_attend: {b} rows (at most 65535)")


def attend(q: torch.Tensor, k_hist: torch.Tensor, v_hist: torch.Tensor,
           length: Optional[torch.Tensor] = None,
           self_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
           ) -> torch.Tensor:
    """``q`` (b, 1, h, hd) against the positions ``[0, length)`` of
    ``k_hist``/``v_hist`` (b, T, h, hd) → (b, 1, h, hd) in ``q``'s dtype.

    ``length``: a 0-d device count (the cache's ``idx``, every row), one a
    row (``cross_valid_len``), or None (all T).  ``self_kv``: the current
    token's ``(kh, vh)``, each (b, 1, h, hd), as one more key.  On a CUDA
    tensor the kernel reads K and V in their dtype and never reads a
    position at or past ``length``; each launch counts in
    ``cuda_lib.launch_counts["decode_attend"]``."""
    dev = q.device
    if dev.type == "cpu":
        return attend_reference(q, k_hist, v_hist, length, self_kv)
    if dev.type != "cuda":
        raise ValueError(f"decode_attend: unsupported device {dev}")
    _check(q, k_hist, v_hist, length, self_kv)
    b, _, h, hd = q.shape
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=dev)
    if b == 0:
        return out
    own = (None, 0)                     # no current token: a null key
    kh, vh = (((t.data_ptr(), t.stride(0)) for t in self_kv) if self_kv
              else (own, own))
    lens = (None, 0)                    # no length: all T positions
    if length is not None:
        length = length.reshape(-1).to(torch.int32)
        lens = (length.data_ptr(), length.stride(0) if b > 1 and
                length.numel() == b else 0)
    lib = cuda_lib.load("decode_attend")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chamjax_decode_attend(
            q.data_ptr(), q.stride(0), k_hist.data_ptr(), k_hist.stride(0),
            k_hist.stride(1), v_hist.data_ptr(), v_hist.stride(0),
            v_hist.stride(1), *kh, *vh, *lens, out.data_ptr(), b,
            k_hist.shape[1], h, hd, _DTYPES[q.dtype],
            cluster_size(b, h, hd, q.dtype, dev.index),
            hd ** -0.5 * math.log2(math.e), stream)
    cuda_lib.check(lib, err, "decode_attend")
    cuda_lib.launch_counts["decode_attend"] += 1
    return out
