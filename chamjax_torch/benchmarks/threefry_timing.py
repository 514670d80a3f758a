"""Time the threefry kernels (``chamjax_torch/csrc/threefry.cu``) beside
the same kernels built from an earlier source directory.

Rows, each at its bounds (``benchmarks/bounds.py``: ``threefry_bound``,
the integer pipe's 41 operations an output, and ``threefry_form_bound``,
the float-aware bound of the form):

- every form over 2^26 outputs whose counters start at 2^32 + 12345
  (``chip_smoke.py``'s phase 2), and the flagship's 1M x 128 noise
  (a float32 normal times 0.05);
- the Gumbel-max step of k-means++ at n = 100,000 (the flagship's
  seeding) and at 2^26: the fused kernel (``random.gumbel_argmax``, this
  tree only where the baseline lacks it) and the chain of torch ops it
  replaces (``gumbel_argmax_reference``: the bulk gumbel, clamp, log, add,
  argmax) on each build.

``--baseline-csrc DIR`` builds the kernels from ``DIR`` too (an earlier
``chamjax_torch/csrc`` with the same ``chamjax_threefry`` entry point;
library names hash the sources, so neither build overwrites the other).
The builds go in four rounds, the baseline first in the even ones and
this tree first in the odd ones.  Each build's first output of every row
is held against the plain version on the card (bit for bit; the fused
index equal to the chain's), each timing is ``kernel_variants.event_ms``
(device time), and each build's registers and spills (``ptxas -v``) and
SASS by pipe (``sass_report.pipe_counts``, and over the hashes the code
holds, ``per_hash``) lead the output.  The last line per row gives each
build's median.

    python -m chamjax_torch.benchmarks.threefry_timing [--baseline-csrc DIR]

Needs the card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from chamjax_torch import random as jr
from chamjax_torch.benchmarks import sass_report
from chamjax_torch.benchmarks.bounds import (threefry_bound,
                                             threefry_form_bound)
from chamjax_torch.benchmarks.kernel_variants import event_ms
from chamjax_torch.utils import cuda_lib
from chamjax_torch.utils.device import card_description, resolve_device

N = 1 << 26
START = (1 << 32) + 12345
NOISE = (1_000_000 * 128, 0.05)
ARGMAX_N = (100_000, 1 << 26)
REPS = 4
BASE_CSRC = cuda_lib.CSRC_DIR
UNIFORM_BOUNDS = (-3.0, 5.5)
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def use_sources(csrc: Path) -> str:
    """Build (where needed) and load threefry from ``csrc``; returns the
    compiler's output where it built."""
    cuda_lib.CSRC_DIR = csrc
    cuda_lib.load.cache_clear()
    return cuda_lib.build(("threefry",)).get("threefry", "")


def registers(log: str) -> Dict[str, Dict[str, int]]:
    """{mangled kernel: registers and spill bytes} from ``ptxas -v``."""
    out: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = out.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = _SPILL.search(line)
        if m:
            current.update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = _USED.search(line)
        if m:
            current["registers"] = int(m.group(1))
    return out


def sass_pipes() -> Dict[str, Dict]:
    """{demangled kernel: its SASS by pipe and by pipe over its hashes}
    of the library built from the current ``CSRC_DIR``."""
    cuobjdump = sass_report._tool("cuobjdump")
    if not cuobjdump:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    text = subprocess.run([cuobjdump, "-sass",
                           str(cuda_lib.library_path("threefry"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = sass_report.pipe_counts(text)
    mangled = sorted(counts)
    return {name: dict(static=dict(counts[raw]),
                       per_hash=sass_report.per_hash(counts[raw]))
            for raw, name in zip(mangled, sass_report._demangle(mangled))}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[t.element_size()])


def draw_rows(dev: torch.device) -> Dict[str, Tuple[Callable, Callable,
                                                    Dict]]:
    """row name → (call, plain call, bounds)."""
    key = jr.fold_in(jr.key(42), 7)
    rows = {}
    for form in jr.FORMS:
        kw = jr.draw_params(form, *(UNIFORM_BOUNDS
                                    if form.startswith("uniform")
                                    else (0.0, 1.0)))
        rows[form] = (N, form, kw, START)
    rows["noise"] = (NOISE[0], "normal_f32",
                     jr.draw_params("normal_f32", scale=NOISE[1]), 0)
    out = {}
    for name, (n, form, kw, start) in rows.items():
        nbytes = n * torch.empty((), dtype=jr._OUT_DTYPE[form]).element_size()
        out[name] = (
            lambda n=n, f=form, kw=kw, s=start: jr.threefry_draw(
                key, n, f, start=s, device=dev, **kw),
            lambda n=n, f=form, kw=kw, s=start: jr.threefry_draw_reference(
                key, n, f, start=s, device=dev, **kw),
            dict(n=n, form=form, int_bound=threefry_bound(n, nbytes),
                 form_bound=threefry_form_bound(n, nbytes, form)))
    return out


def argmax_inputs(dev: torch.device) -> Dict[int, torch.Tensor]:
    """D² of every row to the flagship-like first centre: a gamma-shaped
    positive vector of each length (drawn with torch on the card)."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return {n: torch.rand(n, generator=g, device=dev).pow_(3).mul_(400.0)
            for n in ARGMAX_N}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-csrc", type=Path, default=None,
                    help="also time the kernels built from this directory")
    return ap.parse_args(argv)


def study(args: argparse.Namespace, dev: torch.device, card: str):
    """Yield the builds' registers and SASS, one row per (rep, build,
    row), then one ``medians`` row per row."""
    draws = draw_rows(dev)
    dvec = argmax_inputs(dev)
    builds = [("this", BASE_CSRC)]
    if args.baseline_csrc is not None:
        builds.insert(0, ("baseline", args.baseline_csrc.resolve()))
    times: Dict[Tuple[str, str], List[float]] = {}
    checked = set()
    try:
        for build, csrc in builds:
            log = use_sources(csrc)
            yield dict(build=build, csrc=str(csrc), card=card,
                       ptxas=registers(log), sass=sass_pipes())
        for rep in range(REPS):
            for build, csrc in (builds if rep % 2 == 0 else builds[::-1]):
                use_sources(csrc)
                lib = cuda_lib.load("threefry")
                fused = hasattr(lib, "chamjax_threefry_gumbel_argmax")
                fns = {name: (fn, ref, info)
                       for name, (fn, ref, info) in draws.items()}
                for n, d in dvec.items():
                    scratch = jr.argmax_scratch(dev)
                    chain = (lambda d=d: jr.gumbel_argmax_reference(9, 5, d))
                    fns[f"argmax_chain_{n}"] = (chain, None, dict(n=n))
                    if fused:
                        fns[f"argmax_fused_{n}"] = (
                            lambda d=d, s=scratch: jr.gumbel_argmax(
                                9, 5, d, scratch=s), chain, dict(n=n))
                for name, (fn, ref, info) in fns.items():
                    row = dict(row=name, build=build, rep=rep, card=card,
                               **{k: v for k, v in info.items()})
                    if (name, build) not in checked and ref is not None:
                        got = fn()
                        torch.cuda.synchronize()
                        want = ref()
                        if name.startswith("argmax"):
                            same = int(got) == int(want)
                        else:
                            same = torch.equal(_bits(got), _bits(want))
                        if not same:
                            raise AssertionError(
                                f"threefry {name} ({build}) differs from "
                                f"its plain version")
                        row["equal_plain"] = True
                        checked.add((name, build))
                        del got, want
                    ms = event_ms(fn, launches=20, reps=9)
                    times.setdefault((name, build), []).append(ms)
                    yield dict(row, ms=ms)
    finally:
        use_sources(BASE_CSRC)
    for name in sorted({n for n, _ in times}):
        yield dict(medians=dict(
            row=name, card=card,
            ms={b: statistics.median(times[(name, b)])
                for b, _ in builds if (name, b) in times}))


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    dev = resolve_device(None)          # raises without a card
    card = card_description()
    for row in study(args, dev, card):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
