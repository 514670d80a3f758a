"""The program's own spans in a traced stretch (``trace.Trace``).

The program opens two kinds (``chamjax_torch/utils/tracing.py``): host
spans at its layer boundaries, ``record_function`` ranges such as
``retrieve``, ``ralm.step`` and ``ralm.refill``; and, around each replay of
a captured CUDA graph, a range whose name carries the graph's stage map::

    chamjax.graph <fn>: <span> <n>, <span> <n>, ...

the replay's device nodes in capture order, as runs of the innermost span
open when each was captured.  A replay's device activities all carry the
correlation id of its ``cudaGraphLaunch``; one capture stream runs them in
capture order, so in start order they split into the map's runs.

Each replay is checked on its own.  The profiler loses device records now
and then (on the H100 of the benchmark, some of a replay's activities or
all of them in a few of 64 decode steps), so a replay whose activities do
not number its map's total exactly is not split, never guessed at: it is
left out.  A reader returns None where fewer than half the replays are
whole.

Nothing here imports the program.  In a trace of a program without these
spans every reader finds nothing and returns None.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import List, Optional, Tuple

GRAPH = "chamjax.graph "
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")

Runs = List[Tuple[str, List[Tuple[str, float, float]]]]


def parse_map(name: str) -> Optional[Tuple[str, List[Tuple[str, int]]]]:
    """``(fn, [(span, nodes), ...])`` of a replay range's name, else
    None."""
    if not name.startswith(GRAPH) or ": " not in name:
        return None
    fn, runs = name[len(GRAPH):].split(": ", 1)
    out = []
    for run in runs.split(", ") if runs else []:
        span, n = run.rsplit(" ", 1)
        out.append((span, int(n)))
    return fn, out


def split_replays(t, fn: str
                  ) -> List[Tuple[Tuple[float, float], Optional[Runs]]]:
    """Each replay of ``fn``'s graphs in the trace: its host range and its
    map's runs ``(span, [(name, start, dur), ...])`` of device activities
    in start order, or None where the range holds other than one graph
    launch or the launch's activities do not number the map's total."""
    launches = sorted((ts, corr) for name, ts, _, corr in t.runtime
                      if name in GRAPH_LAUNCHES)
    starts = [ts for ts, _ in launches]
    acts = defaultdict(list)
    for name, s, d, corr in t.device:
        acts[corr].append((s, d, name))
    out = []
    for name, ranges in t.ranges.items():
        parsed = parse_map(name)
        if parsed is None or parsed[0] != fn:
            continue
        runs = parsed[1]
        for s, d in ranges:
            lo = bisect.bisect_left(starts, s)
            hi = bisect.bisect_right(starts, s + d)
            mine = ([(n, s0, d0) for s0, d0, n in
                     sorted(acts.get(launches[lo][1], []))]
                    if hi - lo == 1 else None)
            if mine is None or len(mine) != sum(n for _, n in runs):
                out.append(((s, d), None))
                continue
            split, i = [], 0
            for span, n in runs:
                split.append((span, mine[i:i + n]))
                i += n
            out.append(((s, d), split))
    return sorted(out, key=lambda r: r[0])


def whole(t, fn: str) -> Optional[List[Runs]]:
    """The whole replays of ``fn`` (``split_replays``), or None where
    there is none or fewer than half the replays are whole."""
    reps = split_replays(t, fn)
    good = [runs for _, runs in reps if runs is not None]
    if not good or 2 * len(good) < len(reps):
        return None
    return good


def stage_ms(t, fn: str, spans) -> Optional[float]:
    """Mean device milliseconds a whole replay of ``fn`` spends in the
    runs of ``spans``."""
    if t is None or not t.device:
        return None
    reps = whole(t, fn)
    if reps is None:
        return None
    us = [sum(d for span, acts in runs if span in spans for _, _, d in acts)
          for runs in reps]
    return sum(us) / len(us) / 1e3


def idle_inside(t, span: str, fn: str) -> Optional[float]:
    """The median over the ranges named ``span`` that start in the
    stretch's window and hold a whole replay of ``fn`` of the microseconds
    in which the card ran nothing; None where there are none, or where
    fewer than half of those ranges hold one (a replay whose records the
    profiler lost would read as idle)."""
    if t is None or not t.device:
        return None
    lo, hi = t.window
    ranges = sorted((s, s + d) for s, d in t.ranges.get(span, [])
                    if lo <= s < hi)
    reps = split_replays(t, fn)
    good = sorted(r for r, runs in reps if runs is not None)
    starts = [s for s, _ in good]
    busy = t.busy_intervals()
    idle, held = [], 0
    for s, e in ranges:
        j = bisect.bisect_left(starts, s)
        if j == len(good) or good[j][0] + good[j][1] > e:
            continue
        held += 1
        covered = sum(max(0.0, min(e, be) - max(s, bs)) for bs, be in busy
                      if be > s and bs < e)
        idle.append((min(e, hi) - s) - covered)
    if not idle or 2 * held < len(ranges):
        return None
    return statistics.median(idle)
