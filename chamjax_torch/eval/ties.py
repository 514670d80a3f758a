"""Compare two top-k results that may order distance ties differently.

Two scans of the same candidates agree on every distance within rounding,
but a top-k selection may break a tie between equal distances either way.
So ids are compared per row over *tie classes*: ranks whose distances lie
within the tolerance of a neighbour's (in either result), chained in
sorted order.  Within a class the ids may come in any order but must be the
same multiset; a rank alone in its class must carry the same id.  The class
that holds the row's largest distance may go on past the last rank, so
there an id the reference does not show is allowed, once, as long as the
reference shows it nowhere else in the row.
"""

from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np


def _close(a: float, b: float, rtol: float, atol: float) -> bool:
    if a == b:
        return True
    return bool(np.isfinite(a) and np.isfinite(b)
                and abs(a - b) <= atol + rtol * max(abs(a), abs(b)))


def tie_mismatches(d, i, d_ref, i_ref, *, rtol: float, atol: float,
                   limit: int = 5) -> List[str]:
    """Where ``(d, i)`` differs from ``(d_ref, i_ref)`` other than by the
    order of ties: an empty list when it does not.  ``d``/``i`` are
    ``(nq, k)``; at most ``limit`` faults are described."""
    d, i = np.asarray(d), np.asarray(i)
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    if d.shape != d_ref.shape or i.shape != i_ref.shape or d.shape != i.shape:
        return [f"shapes {d.shape} {i.shape} vs {d_ref.shape} {i_ref.shape}"]
    out: List[str] = []
    bad = np.argwhere(~np.isclose(d, d_ref, rtol=rtol, atol=atol))
    for r, c in bad[:limit]:
        out.append(f"row {r} rank {c}: dist {d[r, c]} vs {d_ref[r, c]}")
    if len(bad):
        return out
    for r in range(d.shape[0]):
        order = np.argsort(d_ref[r], kind="stable")
        classes, cur = [], [order[0]]
        for a, b in zip(order[:-1], order[1:]):
            if (_close(d_ref[r, a], d_ref[r, b], rtol, atol)
                    or _close(d[r, a], d[r, b], rtol, atol)):
                cur.append(b)
            else:
                classes.append(cur)
                cur = [b]
        classes.append(cur)
        for n, cls in enumerate(classes):
            want, got = Counter(i_ref[r, cls]), Counter(i[r, cls])
            if want == got:
                continue
            extra = got - want
            if (n == len(classes) - 1
                    and all(v == 1 for v in extra.values())
                    and not set(extra) & set(i_ref[r].tolist())):
                continue       # the boundary class goes on past rank k
            out.append(f"row {r} ranks {sorted(int(x) for x in cls)}: ids "
                       f"{i[r, cls].tolist()} vs {i_ref[r, cls].tolist()} "
                       f"at dists {d_ref[r, cls].tolist()}")
            if len(out) >= limit:
                return out
    return out
