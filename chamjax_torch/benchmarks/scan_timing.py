"""Time the staged ADC scans (``chamjax_torch/csrc/adc_scan_tiles.cu`` and
``adc_scan_flat.cu``) at the 1M flagship's main-path shapes, beside the
same scans built from an earlier source directory.

The shapes: b=128 queries x 32 probes over 4096 lists of a hard-balanced
IVF4096 (lengths drawn around 1M/4096 = 244 rows, capped at 512), m=16,
seg 512 with the searcher's window budget (``auto_windows``):

- ``adc_scan_tiles``: packed-bf16 LUTs, f32 out, slot-major windows (the
  main path);
- ``adc_scan_segments_multi`` and ``adc_scan_segments``: f32 LUTs,
  probe-major windows over the flat layout (list_pad 128; the flat g8 and
  g1 routes);
- ``adc_scan_distances``: f32 LUTs, scan_len 1024 (the pallas route);

and two shapes with wide windows, where a window is several work items:
``adc_scan_tiles`` over the kernel study's windows (seg 2048, full,
random tiles of a 16M-row slab, packed LUTs; ``@seg2048``) and
``adc_scan_distances`` at ``configs/vector_search.yaml``'s scan_len 4096
over lists of ~1k rows (``@scan4096``).

``--baseline-csrc DIR`` builds the scans from ``DIR`` too (an earlier
version of ``chamjax_torch/csrc`` with the same C entry points; the
library names hash the sources, so neither build overwrites the other).
The builds go in four rounds, baseline first in the even ones and this
tree first in the odd ones.  Each row is one timing (``kernel_variants.event_ms``:
device time) with the sources it was built from and its bound
(``benchmarks/bounds.py``); each build's first output is held against the
plain version (rtol 1e-5), and its registers and spills (``ptxas -v``) go
to standard error.  The last line per kernel gives each build's median.

    python -m chamjax_torch.benchmarks.scan_timing [--baseline-csrc DIR]

Needs the card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from chamjax_torch.ops.scan_pallas import (adc_scan_distances,
                                           adc_scan_distances_reference)
from chamjax_torch.ops.scan_seg import (adc_scan_segments,
                                        adc_scan_segments_reference,
                                        expand_windows, prepare_luts)
from chamjax_torch.ops.scan_seg_block import (adc_scan_tiles,
                                              adc_scan_tiles_reference)
from chamjax_torch.ops.scan_seg_multi import (
    adc_scan_segments_multi, adc_scan_segments_multi_reference)
from chamjax_torch.searcher import auto_windows
from chamjax_torch.utils import cuda_lib
from chamjax_torch.utils.device import card_description, resolve_device

from chamjax_torch.benchmarks.bounds import flat_scan_bound, tile_scan_bound
from chamjax_torch.benchmarks.kernel_variants import event_ms

B, NPROBE, NLIST, M, SEG, GROUP, NB = 128, 32, 4096, 16, 512, 8, 1_000_000
LIST_PAD, SCAN_LEN = 128, 1024
REPS = 4                       # turns of each build
BASE_CSRC = cuda_lib.CSRC_DIR


def flagship_inputs(dev: torch.device) -> Dict:
    """The scans' arguments at the flagship's main-path shapes and at
    the two wide-window shapes."""
    rng = np.random.default_rng(0)
    list_len = np.clip(rng.normal(NB / NLIST, 60, NLIST), 1, SEG)
    list_len = list_len.astype(np.int64)
    windows = auto_windows(list_len, SEG, NPROBE)
    windows = -(-windows // GROUP) * GROUP
    list_ids = np.stack([rng.choice(NLIST, NPROBE, replace=False)
                         for _ in range(B)]).astype(np.int32)
    luts = torch.from_numpy(
        (rng.random((B, NPROBE, 256, M)) * 4.0).astype(np.float32)).to(dev)
    ll = torch.from_numpy(list_len.astype(np.int32)).to(dev)
    li = torch.from_numpy(list_ids).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    # tiled: one seg tile per list (every list <= seg rows)
    tile_start = torch.arange(NLIST, dtype=torch.int32, device=dev) * SEG
    codes_tiled = torch.randint(0, 256, (NLIST, M, SEG), generator=g,
                                device=dev, dtype=torch.uint8)
    starts, lens, probe, _ = expand_windows(li, tile_start, ll,
                                            windows=windows, seg=SEG)

    def slot_major(x):
        return (x.reshape(B, GROUP, windows // GROUP).transpose(1, 2)
                .reshape(B, windows))
    starts, lens, probe = slot_major(starts), slot_major(lens), \
        slot_major(probe)
    luts_p, lut_idx = prepare_luts(luts, probe, lut_bf16=True)
    tiles = (codes_tiled, (starts // SEG).reshape(-1).contiguous(),
             lens.reshape(-1).contiguous(), lut_idx, luts_p)

    # flat: lists padded to list_pad multiples, probe-major windows
    padded = np.maximum(-(-list_len // LIST_PAD) * LIST_PAD, LIST_PAD)
    list_start = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(padded)[:-1]]).astype(np.int32)).to(dev)
    n_cols = int(padded.sum()) + 4096
    codes_t = torch.randint(0, 256, (M, n_cols), generator=g, device=dev,
                            dtype=torch.uint8)
    f_starts, f_lens, f_probe, _ = expand_windows(li, list_start, ll,
                                                  windows=windows, seg=SEG)
    luts_f, f_lut_idx = prepare_luts(luts, f_probe, lut_bf16=False)
    flat = (codes_t, f_starts.reshape(-1).contiguous(),
            f_lens.reshape(-1).contiguous(), f_lut_idx, luts_f)

    # padded windows: one per (query, probe), lens cut at scan_len
    lid = li.long()
    dist = (codes_t, list_start[lid].reshape(-1).contiguous(),
            torch.clamp(ll[lid], max=SCAN_LEN).reshape(-1).contiguous(),
            luts.permute(0, 1, 3, 2).reshape(-1, M, 256).contiguous())
    # wide windows: the kernel study's seg 2048 tiles, and scan_len 4096
    # over IVF1024-sized lists (~1k rows, some longer than the window)
    n_tiles = 16_000_000 // 2048
    big = torch.randint(0, 256, (n_tiles, M, 2048), generator=g, device=dev,
                        dtype=torch.uint8)
    bw = B * NPROBE
    wide = (big, torch.randint(0, n_tiles, (bw,), generator=g, device=dev,
                               dtype=torch.int32),
            torch.full((bw,), 2048, dtype=torch.int32, device=dev),
            torch.randint(0, bw, (bw,), generator=g, device=dev,
                          dtype=torch.int32),
            luts_p)
    long_len = torch.from_numpy(rng.gamma(4.0, 1e6 / 1024 / 4.0, bw).astype(
        np.int32)).to(dev)
    long_start = torch.randint(0, n_cols - 8192, (bw,), generator=g,
                               device=dev, dtype=torch.int32)
    dist4096 = (codes_t, long_start, torch.clamp(long_len, max=4096),
                dist[3])
    return dict(windows=windows, tiles=tiles, flat=flat, dist=dist,
                wide=wide, dist4096=dist4096)


def calls(inp: Dict) -> Dict:
    """kernel name → (call, plain call, bound(out) → (ms, by))."""
    t, f, d = inp["tiles"], inp["flat"], inp["dist"]
    wt, d4 = inp["wide"], inp["dist4096"]

    def nbytes(o):
        return o.numel() * o.element_size()

    def dist_bound(a, width):
        rows = torch.arange(a[1].numel(), device=a[1].device)
        return lambda o: flat_scan_bound(*a[:3], rows, a[3], width=width,
                                         n_idx=2, out_bytes=nbytes(o))
    return {
        "adc_scan_tiles": (
            lambda: adc_scan_tiles(*t, seg=SEG, group=GROUP, lut_bf16=True),
            lambda: adc_scan_tiles_reference(*t, seg=SEG, lut_bf16=True),
            lambda o: tile_scan_bound(*t, nbytes(o))),
        "adc_scan_segments_multi": (
            lambda: adc_scan_segments_multi(*f, seg=SEG, group=GROUP),
            lambda: adc_scan_segments_multi_reference(*f, seg=SEG),
            lambda o: flat_scan_bound(*f, width=SEG, n_idx=3,
                                      out_bytes=nbytes(o))),
        "adc_scan_segments": (
            lambda: adc_scan_segments(*f, seg=SEG),
            lambda: adc_scan_segments_reference(*f, seg=SEG),
            lambda o: flat_scan_bound(*f, width=SEG, n_idx=3,
                                      out_bytes=nbytes(o))),
        "adc_scan_distances": (
            lambda: adc_scan_distances(*d, scan_len=SCAN_LEN),
            lambda: adc_scan_distances_reference(*d, scan_len=SCAN_LEN),
            dist_bound(d, SCAN_LEN)),
        "adc_scan_tiles@seg2048": (
            lambda: adc_scan_tiles(*wt, seg=2048, group=GROUP, lut_bf16=True),
            lambda: adc_scan_tiles_reference(*wt, seg=2048, lut_bf16=True),
            lambda o: tile_scan_bound(*wt, nbytes(o))),
        "adc_scan_distances@scan4096": (
            lambda: adc_scan_distances(*d4, scan_len=4096),
            lambda: adc_scan_distances_reference(*d4, scan_len=4096),
            dist_bound(d4, 4096)),
    }


def use_sources(csrc: Path) -> Dict[str, str]:
    """Build (where needed) and load the scans from ``csrc``; the library
    names hash the sources, so no build is overwritten.  Returns the
    compiler's output of each library it built."""
    cuda_lib.CSRC_DIR = csrc
    cuda_lib.load.cache_clear()
    return cuda_lib.build(("adc_scan_tiles", "adc_scan_flat"))


def check(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """+inf in the same places and the finite values within rtol 1e-5;
    returns the max abs error over the finite ones."""
    fin = torch.isfinite(want)
    if got.shape != want.shape or not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{name}: +inf pattern differs from the plain "
                             f"version's")
    g, w = got[fin], want[fin]
    if not torch.allclose(g, w, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{name} disagrees with its plain version")
    return float((g - w).abs().max()) if g.numel() else 0.0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-csrc", type=Path, default=None,
                    help="also time the scans built from this directory")
    return ap.parse_args(argv)


def study(args: argparse.Namespace, dev: torch.device, card: str):
    """Yield one row per (rep, build, kernel), then one ``medians`` row per
    kernel."""
    inp = flagship_inputs(dev)
    fns = calls(inp)
    builds = [("this", BASE_CSRC)]
    if args.baseline_csrc is not None:
        builds.insert(0, ("baseline", args.baseline_csrc.resolve()))
    times: Dict[Tuple[str, str], List[float]] = {}
    checked = set()
    try:
        for rep in range(REPS):
            for build, csrc in (builds if rep % 2 == 0 else builds[::-1]):
                for lib, text in use_sources(csrc).items():
                    for line in text.splitlines():
                        if "registers" in line or "spill" in line:
                            print(f"{build} {lib}: {line.strip()}",
                                  file=sys.stderr, flush=True)
                for name, (fn, ref, bound) in fns.items():
                    row = dict(kernel=name, build=build, csrc=str(csrc),
                               rep=rep)
                    if (name, build) not in checked:
                        got = fn()
                        row["max_abs_err"] = check(f"{name} {build}", got,
                                                   ref())
                        row["bound_ms"], row["bound_by"] = bound(got)
                        checked.add((name, build))
                    ms = event_ms(fn, launches=20, reps=9)
                    times.setdefault((name, build), []).append(ms)
                    yield dict(row, ms=ms, windows=inp["windows"], card=card)
    finally:
        use_sources(BASE_CSRC)
    for name in fns:
        yield dict(medians=dict(
            kernel=name, card=card,
            ms={b: statistics.median(times[(name, b)]) for b, _ in builds}))


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    dev = resolve_device(None)          # raises without a card
    card = card_description()
    for row in study(args, dev, card):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
