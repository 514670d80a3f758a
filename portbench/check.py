"""Deciding ``correct``: the numbers compared and their limits.

Each cell's numbers are worked out by its runner from the reference
(``reference/``) and the program's outputs; each has a limit in
``limits/<workload>.json``, set from the program's readings over a dozen
seeds and the control's (``calibrate.py``).  A number passes when it is
finite and at most its limit.  The build's own check (``build_numbers``)
is shared by every cell over an index.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Tuple

import torch

from portbench.inputs import sub_seed
from portbench.reference import search as ref_search

KEPT_ROWS = 4096      # corpus rows the build's encoding is checked on


def kept_rows(seed: int, nb: int) -> torch.Tensor:
    """The corpus rows the build's check reads, drawn from the seed."""
    g = torch.Generator(device="cpu")
    g.manual_seed(sub_seed(seed, "kept_rows"))
    return torch.randperm(nb, generator=g)[:KEPT_ROWS]


def build_numbers(ix: "ref_search.Index", tables: Dict, xb: torch.Tensor,
                  seed: int, control: bool = False) -> Dict[str, float]:
    """The build's stage, which the search reference follows from the
    program's tables, checked by itself on the corpus ``xb``: the
    encoding of kept corpus rows (``encode_gap``) and that every id is
    held once (``id_coverage``)."""
    dev = ix.centroids.device
    rows = kept_rows(seed, xb.shape[0])
    return {
        "encode_gap": ref_search.encode_gap(
            ix, xb[rows.to(xb.device)].to(dev), rows.to(dev), control),
        "id_coverage": float(ref_search.id_coverage(ix, tables["ntotal"])),
    }


def compare(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``(correct, checks)``: each number beside its limit.  A limit with
    no number, or a number that is not finite, fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        if not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, checks


def print_checks(checks: Dict[str, Dict[str, float]]) -> None:
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)


def finite(x: float) -> float:
    """JSON has no infinity: a number that is not finite is written as a
    very large one."""
    return x if math.isfinite(x) else 1e300
