"""The decode step of Kimi Delta Attention (KDA), the gated delta-rule
linear attention of Kimi-Linear's KDA layers (``models/kimi_linear.py``).

Each (row, head) holds a state S (K × V, float32; K = V = 128 at the
published widths), rows indexed by the key channel.  A step, with the
token's q, k, v (q and k L2-normed), the per-channel decay α ∈ (0, 1)
and the gate β ∈ (0, 1):

    S ← Diag(α)·S;   S ← S + β·k·(v − Sᵀk)ᵀ;   o = Sᵀq.

``step`` launches the hand-written kernel ``csrc/kda_decode.cu`` on a CUDA
tensor (one launch a layer, each state read and written once, the output
in bfloat16) and runs the plain version ``step_reference`` on a CPU
tensor.  The JAX package has no such family.
"""

from __future__ import annotations

from typing import Optional

import torch

from chamjax_torch.utils import cuda_lib

HEAD_DIM = 128          # the kernel's K and V (csrc/kda_decode.cu)


def step_reference(state: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of :func:`step`: ``state`` (b, h, K, V) updated in
    place in float32, o (b, h, V) in ``out_dtype`` (default q's)."""
    s = state * alpha.float()[..., None]
    kf = k.float()
    u = beta.float()[..., None] * (v.float()
                                   - torch.einsum("bhk,bhkv->bhv", kf, s))
    s = s + kf[..., None] * u[..., None, :]
    state.copy_(s)
    o = torch.einsum("bhk,bhkv->bhv", q.float(), s)
    return o.to(out_dtype or q.dtype)


def _check(state, q, k, v, alpha, beta) -> None:
    b, h = q.shape[:2]
    if state.shape != (b, h, HEAD_DIM, HEAD_DIM):
        raise ValueError(f"kda_decode: state {tuple(state.shape)} against q "
                         f"{tuple(q.shape)} (the kernel takes heads of "
                         f"{HEAD_DIM} x {HEAD_DIM})")
    for name, t, shape in (("q", q, (b, h, HEAD_DIM)),
                           ("k", k, (b, h, HEAD_DIM)),
                           ("v", v, (b, h, HEAD_DIM)),
                           ("alpha", alpha, (b, h, HEAD_DIM)),
                           ("beta", beta, (b, h)), ("state", state, None)):
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"kda_decode: {name} {tuple(t.shape)}, not "
                             f"{shape}")
        if t.dtype != torch.float32 or t.device != state.device:
            raise ValueError(f"kda_decode: {name} must be float32 on the "
                             f"state's device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"kda_decode: {name} contiguous and 16-byte "
                             f"aligned")


def step(state: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
         v: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One KDA step of ``state`` (b, h, K, V) in place with ``q``, ``k``,
    ``v``, ``alpha`` (b, h, K) and ``beta`` (b, h), all float32; returns o
    (b, h, V) in ``out_dtype``.  On a CUDA tensor the kernel (bfloat16 out
    only) reads and writes each state once; each launch counts in
    ``cuda_lib.launch_counts["kda_decode"]``."""
    dev = state.device
    if dev.type == "cpu":
        return step_reference(state, q, k, v, alpha, beta, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"kda_decode: unsupported device {dev}")
    if out_dtype != torch.bfloat16:
        raise ValueError("kda_decode: the kernel writes bfloat16")
    _check(state, q, k, v, alpha, beta)
    b, h = q.shape[:2]
    out = torch.empty((b, h, HEAD_DIM), dtype=torch.bfloat16, device=dev)
    lib = cuda_lib.load("kda_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chamjax_kda_decode(
            state.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            alpha.data_ptr(), beta.data_ptr(), out.data_ptr(), b * h, stream)
    cuda_lib.check(lib, err, "kda_decode")
    cuda_lib.launch_counts["kda_decode"] += 1
    return out
