"""Single-query latent attention against a compressed cache: the attention
of a decode step of the DeepSeek-V3 block (``models/mla_moe.py``) and of
Kimi-Linear's latent-attention layers (``models/kimi_linear.py``), after
the key and value up-projections are absorbed into the query and the
output.

Every head reads the same latent a position, ``[c_kv | k_pe]``; the value
is its first ``v_dim`` entries.  ``attend`` launches the hand-written
kernel ``chamjax_torch/csrc/latent_attend.cu`` on a CUDA tensor (bfloat16,
576-wide latents, 512-wide values, up to 32 heads: one or two 16-row
tiles of the MMA) and runs the plain
version ``attend_reference`` on a CPU tensor.  The plain version keeps
scores, softmax and p·V in float32; the kernel rounds the probabilities to
bfloat16 for its tensor-core p·V and the output once.  The JAX package has
no such family.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from chamjax_torch.utils import cuda_lib

# the kernel's shape (csrc/latent_attend.cu)
LATENT = 576            # c_kv 512 + k_pe 64
V_DIM = 512
MAX_HEADS = 32          # two tiles of the MMA's M (16)


def attend_reference(q: torch.Tensor, lat: torch.Tensor,
                     length: Optional[torch.Tensor] = None,
                     self_lat: Optional[torch.Tensor] = None,
                     scale: float = 1.0, v_dim: int = V_DIM
                     ) -> torch.Tensor:
    """Plain version of :func:`attend`: the scores of every position in
    float32, those at or past ``length`` set to -inf, with ``self_lat`` one
    more position; a softmax; p times the first ``v_dim`` values of each
    latent, in float32, rounded to ``q``'s dtype."""
    T = lat.shape[1]
    qf = q.float()
    scores = torch.einsum("bhd,btd->bht", qf, lat.float()) * scale
    if length is not None:      # a 0-d length, or one a row
        past = torch.arange(T, device=q.device) >= length.reshape(-1, 1)
        scores = scores.masked_fill(past[:, None, :], float("-inf"))
    vals = lat[..., :v_dim].float()
    if self_lat is not None:
        own = (qf * self_lat.float()[:, None, :]).sum(-1) * scale
        scores = torch.cat([scores, own[..., None]], dim=-1)
        vals = torch.cat([vals, self_lat[:, None, :v_dim].float()], dim=1)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bht,btc->bhc", p, vals).to(q.dtype)


@functools.lru_cache(maxsize=None)
def cluster_size(b: int, device: int, heads: int = 16) -> int:
    """The CTAs a row on card ``device`` for ``heads`` heads (the kernel
    takes up to 16 in a CTA of 4 warps, up to 32 in one of 8): the most of
    8, 4, 2, 1 at which the clusters of all ``b`` rows are resident at
    once, asked once a batch."""
    lib = cuda_lib.load("latent_attend")
    chunks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.chamjax_latent_attend_chunks(b, heads,
                                               ctypes.byref(chunks))
    cuda_lib.check(lib, err, "latent_attend cluster size")
    return chunks.value


def _check(q, lat, length, self_lat) -> None:
    b, h, d = q.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"latent_attend: dtype {q.dtype} (the kernel takes "
                         f"bfloat16)")
    if d != LATENT or lat.shape[2] != LATENT or not 1 <= h <= MAX_HEADS:
        raise ValueError(f"latent_attend: q {tuple(q.shape)} against latents "
                         f"{tuple(lat.shape)} is not a shape the kernel takes "
                         f"(up to {MAX_HEADS} heads of {LATENT})")
    for t in (lat,) + ((self_lat,) if self_lat is not None else ()):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("latent_attend: q, the latents (and self_lat) "
                             "on one device in one dtype")
        if t.shape[0] != b or t.shape[-1] != LATENT or t.stride(-1) != 1:
            raise ValueError(f"latent_attend: {tuple(t.shape)} against q's "
                             f"{tuple(q.shape)}, each latent contiguous")
    if q.stride(2) != 1:
        raise ValueError("latent_attend: each head's query contiguous")
    for t in (q, lat) + ((self_lat,) if self_lat is not None else ()):
        strides = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
        if t.data_ptr() % 16 or any(s * 2 % 16 for s in strides):
            raise ValueError("latent_attend: rows, heads and positions must "
                             "be 16-byte aligned")
    if length is not None and (length.device != q.device
                               or length.numel() not in (1, b)):
        raise ValueError("latent_attend: length is one count, or one a "
                         "row, on q's device")
    if b > 65535:
        raise ValueError(f"latent_attend: {b} rows (at most 65535)")


def attend(q: torch.Tensor, lat: torch.Tensor,
           length: Optional[torch.Tensor] = None,
           self_lat: Optional[torch.Tensor] = None,
           scale: float = 1.0, v_dim: int = V_DIM) -> torch.Tensor:
    """``q`` (b, h, 576) against the positions ``[0, length)`` of the
    latents ``lat`` (b, T, 576) → (b, h, 512) in ``q``'s dtype; the values
    are a latent's first ``v_dim`` entries (512 on the card).

    ``length``: a 0-d device count (the cache's ``idx``, every row), one a
    row, or None (all T).  ``self_lat``: the current token's latent (b,
    576), as one more position.  ``scale`` multiplies the scores.  On a
    CUDA tensor the kernel reads each held latent once for all heads and
    never reads one at or past ``length``; each launch counts in
    ``cuda_lib.launch_counts["latent_attend"]``."""
    dev = q.device
    if dev.type == "cpu":
        return attend_reference(q, lat, length, self_lat, scale, v_dim)
    if dev.type != "cuda":
        raise ValueError(f"latent_attend: unsupported device {dev}")
    if v_dim != V_DIM:
        raise ValueError(f"latent_attend: values of {v_dim} (the kernel "
                         f"takes {V_DIM})")
    _check(q, lat, length, self_lat)
    b, h, _ = q.shape
    out = torch.empty((b, h, V_DIM), dtype=q.dtype, device=dev)
    if b == 0:
        return out
    own = ((self_lat.data_ptr(), self_lat.stride(0)) if self_lat is not None
           else (None, 0))
    lens = (None, 0)                    # no length: all T positions
    if length is not None:
        length = length.reshape(-1).to(torch.int32)
        lens = (length.data_ptr(), length.stride(0) if b > 1 and
                length.numel() == b else 0)
    lib = cuda_lib.load("latent_attend")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chamjax_latent_attend(
            q.data_ptr(), q.stride(0), q.stride(1), lat.data_ptr(),
            lat.stride(0), lat.stride(1), *own, *lens, out.data_ptr(), b,
            lat.shape[1], h, cluster_size(b, dev.index, h),
            scale * math.log2(math.e), stream)
    cuda_lib.check(lib, err, "latent_attend")
    cuda_lib.launch_counts["latent_attend"] += 1
    return out
