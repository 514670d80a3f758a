"""The mesh's two collectives on lists of tensors, one a position: the
only copies between positions (``parallel.mesh`` re-exports them).  A leaf
module, so that the models' tensor-parallel cores and the mesh search share
them without one layer importing the other; a multi-process mesh would swap
NCCL in here without touching a caller."""

from __future__ import annotations

from typing import List, Sequence

import torch


def all_gather_to(tensors: Sequence[torch.Tensor], device: torch.device
                  ) -> List[torch.Tensor]:
    """Every tensor on ``device`` (a peer copy where it lies elsewhere; the
    same tensor where it is there already)."""
    return [t.to(device) for t in tensors]


def all_reduce_sum(partials: Sequence[torch.Tensor],
                   devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of ``partials`` in float32, formed on ``devices[0]``, and a
    copy of it on each of ``devices`` (the same tensor where a device
    repeats).  Callers round it to their dtype once."""
    total = None
    for p in all_gather_to(partials, devices[0]):
        p = p.float()
        total = p if total is None else total + p
    return [total.to(d) for d in devices]
