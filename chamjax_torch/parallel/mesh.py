"""A device mesh and its collectives (the port of ``chamjax/parallel/mesh.py``).

The JAX package's mesh is single-controller: one Python process owns every
device, and ``shard_map`` / GSPMD run each position's share.  The port keeps
that model.  A :class:`Mesh` is an n-d array of ``torch.device`` with axis
names; the code that runs on it loops over the positions and moves tensors
between them with the two collectives of ``utils/collectives.py``
(re-exported here), written once so that callers never copy between
positions themselves.  This is how Faiss shards
a GPU index over the cards of one process (``IndexShards``).

A position is a place, not a card: ``make_mesh(axes, devices=["cuda:0"] *
8)`` is a mesh of 8 positions on one card (the counterpart of the JAX
package's 8 virtual CPU devices), and ``["cpu"] * 8`` the same on the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from chamjax_torch.utils.collectives import (  # noqa: F401
    all_gather_to,
    all_reduce_sum,
)
from chamjax_torch.utils.device import resolve_device


class Mesh:
    """Positions (an n-d numpy array of ``torch.device``) and their axis
    names.  ``shape`` maps each axis to its size, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices, axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_at(self, **coords: int) -> torch.device:
        """The device of the position at ``coords`` (axis name → index);
        an axis not named is at 0."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no axes {sorted(unknown)} in {self.axis_names}")
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def distinct_devices(self) -> List[torch.device]:
        """The devices the positions lie on, each once, in position order."""
        return list(dict.fromkeys(self.devices.flat))

    @property
    def one_device(self) -> bool:
        """Whether every position lies on one device (one CUDA graph can
        hold the whole program only then)."""
        return len(self.distinct_devices()) == 1

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, {len(self.distinct_devices())} "
                f"distinct device(s))")


def make_mesh(axes: Optional[Sequence[Tuple[str, int]]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh from ``(axis, size)`` pairs; the sizes multiply to the
    number of positions, and one size of -1 takes what the others leave.
    ``devices=None`` means every visible card (``torch.cuda.device_count()``,
    as ``jax.devices()``), and raises where there is none; pass a list to
    place the positions yourself."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices "
                "explicitly (e.g. ['cpu'] * 8) to build a mesh elsewhere")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if axes is None:
        axes = (("lists", n),)
    names = [a for a, _ in axes]
    sizes = [int(s) for _, s in axes]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh sizes {sizes} do not multiply to the "
                         f"{n} devices given")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(sizes), tuple(names))
