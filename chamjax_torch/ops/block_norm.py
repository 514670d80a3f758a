"""The elementwise junctions of a transformer block
(``models/transformer.py``): the residual add with the layernorm after it
(``add_ln``), and the FFN's bias with its GELU (``bias_gelu``).

``add_ln`` and ``bias_gelu`` launch the hand-written kernels of
``chamjax_torch/csrc/block_norm.cu`` on a CUDA tensor and run the plain
versions on a CPU tensor.  The plain versions are the block's arithmetic
as the JAX package writes it, op for op: ``x + a @ w + b`` rounds after
each add, the layernorm takes its statistics in float32 (the population
variance, as ``jnp.var``) and rounds the normalised row before its scale
and shift, and the GELU is the tanh form (``jax.nn.gelu``'s default).  The
kernels keep those roundings: only the order of the float32 sums differs.

``add_ln`` and ``bias_gelu`` are the one dispatcher: bfloat16 rows on the
card at a width the kernels have launch a kernel, whose guard raises on an
operand it does not take (another dtype, shape or device, a strided or
unaligned row); every other row (the CPU, float32, other widths) runs the
plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from chamjax_torch.utils import cuda_lib

WIDTH_STEP = 256        # a row is whole 16-byte vectors of each of 32 lanes
MAX_WIDTH = 4096        # the widest instantiation (csrc/block_norm.cu)


def add_ln_reference(x: torch.Tensor, delta: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], scale: torch.Tensor,
                     ln_bias: torch.Tensor, eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`add_ln`."""
    if delta is not None:
        x = x + delta
    if bias is not None:
        x = x + bias
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)   # jnp.var: population
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + ln_bias
    return x, y


def bias_gelu_reference(g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bias_gelu`."""
    return F.gelu(g + b, approximate="tanh")    # jax.nn.gelu's default


def _width(x: torch.Tensor) -> Optional[int]:
    """The width of ``x``'s rows where the kernels have it, else None."""
    width = x.shape[-1] if x.dim() else 0
    ok = 0 < width <= MAX_WIDTH and width % WIDTH_STEP == 0
    return width if ok else None


def _on_kernel(what: str, x: torch.Tensor) -> bool:
    """Whether the kernels take rows ``x``: on a card, bfloat16, a width
    they have.  False on the CPU, where the plain versions run; raises on
    any other device."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"{what}: unsupported device {x.device}")
        return False
    return x.dtype == torch.bfloat16 and _width(x) is not None


def _check(what: str, rows: dict, cols: dict) -> None:
    """Raise unless the kernel takes the row-wise operands ``rows`` (the
    first one's shape; None for one left out) and the per-column ones
    ``cols`` (its width), by name: bfloat16, on the first one's device,
    contiguous from a 16-byte boundary, rows of a width it has."""
    x = next(iter(rows.values()))
    width = _width(x)
    if width is None:
        raise ValueError(f"{what}: rows of {tuple(x.shape[-1:])} (a "
                         f"multiple of {WIDTH_STEP} up to {MAX_WIDTH})")
    named = [(n, t, x.shape) for n, t in rows.items() if t is not None]
    named += [(n, t, (width,)) for n, t in cols.items() if t is not None]
    for name, t, shape in named:
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise ValueError(f"{what}: {name} must be bfloat16 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} {tuple(t.shape)}, not "
                             f"{tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous rows from a "
                             f"16-byte boundary")


def add_ln(x: torch.Tensor, delta: Optional[torch.Tensor],
           bias: Optional[torch.Tensor], scale: torch.Tensor,
           ln_bias: torch.Tensor, eps: float = 1e-5
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual ``x_new = (x + delta) + bias`` (each add rounded to
    ``x``'s dtype; ``delta`` (x's shape) and ``bias`` (its width) may be
    None) and its layernorm ``y`` with ``scale`` and ``ln_bias`` →
    ``(x_new, y)``; ``x_new`` is ``x`` itself where nothing is added.

    On bfloat16 rows on a card at a width of a multiple of 256 up to 4096,
    one kernel launch reads each row once and writes ``x_new`` (where
    something is added) and ``y``, and raises on an operand it does not
    take; each launch counts in ``cuda_lib.launch_counts["add_ln"]``.
    Other rows run the plain version."""
    if not _on_kernel("add_ln", x):
        return add_ln_reference(x, delta, bias, scale, ln_bias, eps)
    return _add_ln_kernel(x, delta, bias, scale, ln_bias, eps)


def _add_ln_kernel(x, delta, bias, scale, ln_bias, eps):
    """:func:`add_ln`'s launch, after its guard."""
    _check("add_ln", dict(x=x, delta=delta),
           dict(bias=bias, scale=scale, ln_bias=ln_bias))
    x_new = x if delta is None and bias is None else torch.empty_like(x)
    y = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    if rows == 0:
        return x_new, y
    lib = cuda_lib.load("block_norm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.chamjax_add_ln(
            x.data_ptr(), None if delta is None else delta.data_ptr(),
            None if bias is None else bias.data_ptr(), scale.data_ptr(),
            ln_bias.data_ptr(), None if x_new is x else x_new.data_ptr(),
            y.data_ptr(), rows, x.shape[-1], eps, stream)
    cuda_lib.check(lib, err, "add_ln")
    cuda_lib.launch_counts["add_ln"] += 1
    return x_new, y


def bias_gelu(g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``gelu_tanh(g + b)``, the add rounded to ``g``'s dtype: ``g``
    (rows, f), ``b`` (f).  On rows :func:`add_ln`'s kernel would take, one
    kernel launch, bit-equal to the plain version, which raises on an
    operand it does not take; each launch counts in
    ``cuda_lib.launch_counts["bias_gelu"]``.  Other rows run the plain
    version."""
    if not _on_kernel("bias_gelu", g):
        return bias_gelu_reference(g, b)
    return _bias_gelu_kernel(g, b)


def _bias_gelu_kernel(g, b):
    """:func:`bias_gelu`'s launch, after its guard."""
    _check("bias_gelu", dict(g=g), dict(b=b))
    out = torch.empty_like(g)
    rows = g.numel() // g.shape[-1]
    if rows == 0:
        return out
    lib = cuda_lib.load("block_norm")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.chamjax_bias_gelu(g.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), rows, g.shape[-1],
                                    stream)
    cuda_lib.check(lib, err, "bias_gelu")
    cuda_lib.launch_counts["bias_gelu"] += 1
    return out
