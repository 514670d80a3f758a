"""Device resolution shared by the entry points."""

from __future__ import annotations

import subprocess
from typing import Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises when the resolved device is a card
    and none is present: an entry point never carries on on the CPU unless
    the caller asked for it with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "chamjax_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU explicitly")
        if dev.index is None:      # pin "cuda" to the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """numpy array or tensor → contiguous float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    a = np.ascontiguousarray(x, np.float32)
    if not a.flags.writeable:      # torch wants writable host memory
        a = a.copy()
    return torch.from_numpy(a).to(device)


def seeded_generator(device, *words: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the non-negative
    integers ``words`` (numpy's ``SeedSequence`` mixes them), the port's
    counterpart of ``jax.random.fold_in`` chains.  Its stream is torch's
    (MT19937 on the CPU, Philox on a card): a CPU draw differs from a card
    draw and neither is JAX-PRNG."""
    seed = int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1, np.uint64)[0]) >> 1
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed)
    return g


def card_description() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``: every time on the card is kept
    beside it.  Raises ``OSError`` or ``subprocess.SubprocessError`` where
    ``nvidia-smi`` is missing or fails."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def card_power_limit() -> Tuple[str, float]:
    """``(name, watts)`` of the first card: :func:`card_description` split
    at its last comma, the power limit in watts.  Raises ``ValueError``
    where ``nvidia-smi`` prints no positive number for the limit
    (``[N/A]``)."""
    desc = card_description()
    name, _, limit = desc.rpartition(",")
    try:
        watts = float(limit.strip().split()[0])
    except (IndexError, ValueError):
        watts = 0.0
    if not watts > 0:
        raise ValueError(f"no power limit in nvidia-smi's {desc!r}")
    return name.strip(), watts
