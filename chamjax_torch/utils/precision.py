"""True-fp32 matmuls for everything that ranks by distance.

The JAX package runs every ranking matmul at ``Precision.HIGHEST``; the
port's counterpart is a float32 matmul with TF32 off.  ``fp32_matmul`` sets
that for the duration of one call and restores the caller's setting, so the
port neither relies on PyTorch's defaults nor changes a global setting at
import time.  Use it as a context manager or as a decorator.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_matmul():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")   # TF32 off (cuBLAS: ieee)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
