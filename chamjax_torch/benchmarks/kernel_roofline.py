"""ADC scan roofline study: rows/s and code bandwidth of the scan kernels
against the card's HBM rate (the port of ``benchmarks/kernel_roofline.py``).

Synthetic work, no index: an (m, n) uint8 code slab, random 128-aligned
window starts, full lens, random LUT rows.  ``seg_*`` variants run
``adc_scan_segments_multi`` over the flat slab; ``block_*`` variants run
``adc_scan_tiles`` over its seg-tiled twin (random tiles over the whole
slab), ``block_*bf16d`` with bf16 distances, ``block_*copy`` and
``block_*nogather`` with the ``debug_ablate`` measurement bodies, which
read the same bytes but gather nothing.  ``_bf16`` in a name means packed
LUTs.  Times are CUDA events around back-to-back launches.

    python -m chamjax_torch.benchmarks.kernel_roofline            # default
    python -m chamjax_torch.benchmarks.kernel_roofline --variants seg_f32 \\
        seg_bf16 block_bf16 block_bf16copy --runlen 0 8

Every row carries ``pct_hbm``, the code bandwidth as a share of
``perf_model.H100.hbm_gbps``, ``bound_ms`` (``bounds.ablate_bound`` for the
measurement bodies, which read no LUT), ``max_abs_err`` (the first output
of each configuration against its plain version, which it must match:
bit-equal for ``copy``/``nogather``, one bf16 ulp for ``bf16d``, else rtol
1e-5) and the card's name and power limit.  It needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterator, List, Optional

import torch

from chamjax_torch.benchmarks.bounds import (ablate_bound, flat_scan_bound,
                                             tile_scan_bound)
from chamjax_torch.benchmarks.kernel_variants import event_ms, hold
from chamjax_torch.ops.scan_seg import pack_luts_bf16
from chamjax_torch.ops.scan_seg_block import (adc_scan_tiles,
                                              adc_scan_tiles_reference)
from chamjax_torch.ops.scan_seg_multi import (
    adc_scan_segments_multi, adc_scan_segments_multi_reference)
from chamjax_torch.perf_model import H100
from chamjax_torch.utils.device import card_description, resolve_device

DEFAULT_VARIANTS = ["seg_f32", "seg_bf16", "block_f32", "block_bf16"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16_000_000,
                    help="code rows in the slab (16M x m16 = 256 MB)")
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--bw", type=int, default=4096,
                    help="windows per call (b*W)")
    ap.add_argument("--n_lut", type=int, default=4096)
    ap.add_argument("--segs", type=int, nargs="+", default=[1024, 2048])
    ap.add_argument("--groups", type=int, nargs="+", default=[8])
    ap.add_argument("--variants", nargs="+", default=DEFAULT_VARIANTS,
                    help="seg_* = flat multi-window scan; block_* = the "
                         "tiled scan (the production one)")
    ap.add_argument("--reps", type=int, default=1,
                    help="interleaved repetitions of the whole matrix; the "
                         "per-config minimum is reported")
    ap.add_argument("--runlen", type=int, nargs="+", default=[0],
                    help="> 0: block_* windows arrive in runs of L "
                         "consecutive tiles sharing one LUT row, slot-major "
                         "(the production order after the slot-major "
                         "window permutation); 0 = fully random")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run_streams(bw: int, group: int, runlen: int, n_tiles: int, n_lut: int,
                g: torch.Generator, dev) -> tuple:
    """Slot-major run layout: slot j (flat windows i*G + j) walks runs of
    ``runlen`` consecutive tiles sharing one LUT row back to back.
    Returns (tile_idx, lut_idx), (bW,) int32 each."""
    steps = bw // group
    n_runs = -(-steps // runlen)
    rt = torch.randint(0, max(n_tiles - runlen, 1), (group, n_runs),
                       generator=g, device=dev, dtype=torch.int32)
    rl = torch.randint(0, n_lut, (group, n_runs), generator=g, device=dev,
                       dtype=torch.int32)
    i = torch.arange(steps, device=dev)
    st = rt[:, i // runlen] + (i % runlen).to(torch.int32)[None, :]
    sl = rl[:, i // runlen]
    return st.T.reshape(-1).contiguous(), sl.T.reshape(-1).contiguous()


def _rates(ms: float, bw: int, seg: int, m: int) -> Dict:
    grows = bw * seg / ms / 1e6
    gbs = grows * m
    return dict(grows=grows, code_gbs=gbs, pct_hbm=100 * gbs / H100.hbm_gbps)


def study(args: argparse.Namespace, dev: torch.device,
          card: str) -> Iterator[Dict]:
    """Yield one row per (rep, seg, group, runlen, variant), then, with
    ``--reps`` > 1, one ``best_ms`` row per configuration, then the
    ``best`` row (the highest rows/s)."""
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    m, n, bw = args.m, args.n, args.bw
    codes_t = torch.randint(0, 256, (m, n), generator=g, device=dev,
                            dtype=torch.uint8)
    luts = torch.rand((args.n_lut, m, 256), generator=g, device=dev)
    luts_p = pack_luts_bf16(luts)
    lut_idx = torch.randint(0, args.n_lut, (bw,), generator=g, device=dev,
                            dtype=torch.int32)
    best_ms: Dict = {}
    for rep in range(args.reps):
        for seg in args.segs:
            starts = torch.randint(0, (n - seg) // 128, (bw,), generator=g,
                                   device=dev, dtype=torch.int32) * 128
            lens = torch.full((bw,), seg, dtype=torch.int32, device=dev)
            n_tiles = n // seg
            codes_tiled = None
            if any(v.startswith("block") for v in args.variants):
                codes_tiled = (codes_t[:, :n_tiles * seg]
                               .reshape(m, n_tiles, seg).transpose(0, 1)
                               .contiguous())
            tile_idx = torch.randint(0, n_tiles, (bw,), generator=g,
                                     device=dev, dtype=torch.int32)
            for group in args.groups:
                for runlen in args.runlen:
                    ti, li = ((tile_idx, lut_idx) if runlen <= 1 else
                              run_streams(bw, group, runlen, n_tiles,
                                          args.n_lut, g, dev))
                    for variant in args.variants:
                        lut_bf16 = "bf16" in variant
                        lt = luts_p if lut_bf16 else luts
                        ablate = ""
                        if variant.startswith("block"):
                            ablate = ("copy" if variant.endswith("copy") else
                                      "nogather"
                                      if variant.endswith("nogather") else "")
                            kw = dict(seg=seg, lut_bf16=lut_bf16,
                                      dist_bf16=variant.endswith("bf16d"),
                                      debug_ablate=ablate)
                            args_ = (codes_tiled, ti, lens, li, lt)
                            fn, ref = adc_scan_tiles, adc_scan_tiles_reference
                        else:
                            # the flat scan takes no runs (as in the JAX
                            # harness): random starts and LUT rows
                            kw = dict(seg=seg, lut_bf16=lut_bf16)
                            args_ = (codes_t, starts, lens, lut_idx, lt)
                            fn = adc_scan_segments_multi
                            ref = adc_scan_segments_multi_reference
                        def call():
                            return fn(*args_, group=group, **kw)
                        out = call()
                        err = hold(f"{variant} seg {seg} runlen {runlen}",
                                   out, ref(*args_, **kw), exact=bool(ablate),
                                   bf16=kw.get("dist_bf16", False))
                        ms = event_ms(call)
                        ob = out.numel() * out.element_size()
                        if ablate:
                            # the measurement bodies read no LUT and copy
                            # reads one code row of each tile
                            bound_ms, bound_by = ablate_bound(
                                ablate, codes_tiled, ti, ob)
                        elif variant.startswith("block"):
                            bound_ms, bound_by = tile_scan_bound(
                                codes_tiled, ti, lens, li, lt, ob)
                        else:
                            bound_ms, bound_by = flat_scan_bound(
                                codes_t, starts, lens, lut_idx, lt,
                                width=seg, n_idx=3, out_bytes=ob)
                        key = (variant, seg, group, runlen)
                        best_ms[key] = min(best_ms.get(key, ms), ms)
                        yield dict(variant=variant, seg=seg, group=group,
                                   runlen=runlen, rep=rep, ms=ms,
                                   **_rates(ms, bw, seg, m),
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   max_abs_err=err, card=card)
            del codes_tiled
    if args.reps > 1:
        for (variant, seg, group, runlen), ms in sorted(best_ms.items()):
            yield dict(variant=variant, seg=seg, group=group, runlen=runlen,
                       best_ms=ms, **_rates(ms, bw, seg, m), card=card)
    (bv, bs, bg, brl), bms = max(best_ms.items(),
                                 key=lambda kv: kv[0][1] / kv[1])
    yield dict(best=dict(variant=bv, seg=bs, group=bg, runlen=brl,
                         best_ms=bms, **_rates(bms, bw, bs, m), card=card))


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    dev = resolve_device(None)          # raises without a card
    card = card_description()
    for row in study(args, dev, card):
        if "best" in row:
            print("BEST:", json.dumps(row["best"]), flush=True)
        else:
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
