#!/usr/bin/env python3
"""Smoke test of chamjax_torch on one NVIDIA card: builds the CUDA kernels
from ``chamjax_torch/csrc``, holds each against its plain PyTorch version,
then drives every scan route of the IVF-PQ query path at the 1M flagship
size.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. Build the kernels (one ``nvcc`` per source, started together); print the
   card's name and power limit.
2. Kernels vs plain versions, each timed on the device (``device_ms``:
   CUDA events around back-to-back calls queued behind a spin kernel)
   beside its plain version and its bound:
   - ``adc_scan_tiles`` at the flagship shape (m=16, seg=512, bW=4096
     windows over 4096 random tiles, some windows empty, some partial) for
     five option sets: f32 LUT, packed-bf16 LUT, bf16 distance output, the
     in-kernel lane-L1 reduction, and packed LUTs shared by runs of 8
     windows; and its ``debug_ablate`` measurement bodies ``copy`` and
     ``nogather`` with f32 and packed LUTs (exact);
   - ``adc_scan_segments_multi`` (f32, packed, lane_l1) and
     ``adc_scan_segments`` (f32, packed) over a flat layout the size of the
     flagship's (16 x ~1.05M u8), bW=4096 windows of seg 512 whose starts
     are multiples of 64, some empty, some partial; and again with the
     starts at every residue mod 16 over a layout whose n_cols is 7 mod 16;
   - ``adc_scan_distances`` at the shape of ``configs/vector_search.yaml``
     (IVF1024 over 1M: lists of ~1k rows with a tail), bp=4096, scan_len
     4096, list lengths from 0 to above scan_len;
   - the measurement kernels of ``chamjax_torch/benchmarks/
     kernel_variants.py``: ``run_variant`` for each of its 17 variants and
     ``run_block_variant``, at m=16 over a 16 x 2^20 u8 slab, bW=4096,
     seg 512 and 2048 (exact where the output is a code, an integer sum or
     one LUT entry; else rtol 1e-5).
3. The main path: ``synthetic_dataset`` (1M x 128, 4096 clusters, seed 42)
   → ``build_ivfpq`` (OPQ16 + IVF4096 + PQ16, hard-balanced) →
   ``compute_ground_truth`` (256 queries) → ``IVFSearcher.search``
   (seg=512, group=8, nprobe=32, k=100, packed-bf16 LUTs).  Recall is
   checked against the same index searched by the plain ``xla`` backend;
   the kernel's launch count must rise during the search.  Times a
   b=128 and a b=1 search and the stages of a b=128 search, and traces
   10 back-to-back b=128 searches (``chamjax_torch.utils.tracing``): the
   card's busy share (CUDA kernel time over the profiled window, and its
   kernel time a search over the unprofiled b=128 batch time) and the
   kernels that took the most device time.
4. The other routes on the same index, each run over the 256 recall
   queries with the launch counts set to 0 just before and read just
   after (its kernel must have launched): the flat layout (``tiled=False``)
   at group 8 and group 1 and ``backend="pallas"`` with f32 LUTs, each
   within 0.002 R@10 of the xla oracle and equal to the tiled f32 route
   except in the order of distance ties (``tie_mismatches``); flat group 8
   with packed-bf16 LUTs within 0.01 of the oracle; ``HostStreamedSearcher``
   with ``tiled`` True and False, each equal to the resident search up to
   the order of ties, at the same R@10.  Each route's kernel is held
   against its plain version on one real batch; b=128 and b=1 searches are timed on
   the flat and pallas routes; ``search_pipelined`` over the 65 remaining
   b=128 batches and one batch's host gather, copy and device scan on the
   streamed tier.
5. The kernel-study path at full width (the JAX harness's defaults: a
   16M x m16 slab, bW=4096, n_lut=4096), counts set to 0 just before and
   read just after: ``kernel_variants.study`` over every variant at seg
   2048, again with ``--same-lut``, and ``kernel_roofline.study`` over
   ``seg_f32 seg_bf16 block_f32 block_bf16 block_bf16copy
   block_bf16nogather`` at seg 1024 and 2048, runlen 0 and 8; each
   configuration's first output is held against its plain version at
   that shape before it is timed.
6. Print the kernels line, the main-path line, the routes line, the
   kernel-study line, and the result line.

Needs the card, the CUDA toolkit (``nvcc``) and the rest of this repository
beside the script.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time

FLAGSHIP = dict(nb=1_000_000, nq=128 * 65 + 256, nt=100_000, d=128, seed=42,
                n_clusters=4096)
BATCH, NPROBE, K, SEG, GROUP = 128, 32, 100, 512, 8
N_GT = 256
MIN_R10 = 0.85
# configs/vector_search.yaml: IVF1024 over 1M, backend pallas
PALLAS_NLIST, PALLAS_SCAN_LEN = 1024, 4096


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> int:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn`` as the
    host enqueues it: the host's time where it is the longer (the search
    stages)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, plain: bool = False) -> float:
    """Device time of one call of a kernel's wrapper (or, ``plain``, of its
    plain version): ``kernel_variants.event_ms``, which holds the card
    while the host enqueues the calls, so the wrapper's host time is not
    counted.  ``time_ms`` above times a call as it is enqueued: for a short
    kernel that is the host's time."""
    from chamjax_torch.benchmarks.kernel_variants import event_ms
    if plain:
        return event_ms(fn, launches=3, reps=5, warmup=1)
    return event_ms(fn, launches=20, reps=9)


def hold(name, fn, ref, args, kw, ref_kw, bound):
    """Launch ``fn``, synchronise, compare with the plain version ``ref`` on
    the same inputs (``check_scan``), and time both (``device_ms``).
    ``bound(out)`` gives (ms, by).  Returns the measurement, or raises."""
    import torch
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    want = ref(*args, **ref_kw)
    full = (ref(*args, **dict(ref_kw, lane_l1=False))
            if ref_kw.get("lane_l1") else None)
    ok, err = check_scan(got, want, dist_bf16=False, full=full)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"(max abs err {err})")
    ms = device_ms(lambda: fn(*args, **kw))
    plain_ms = device_ms(lambda: ref(*args, **ref_kw), plain=True)
    bound_ms, bound_by = bound(got)
    log(f"{name}: ok, max_abs_err={err:.3g} kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def bf16_ulp_ok(got, want) -> bool:
    """|got - want| within one bf16 ulp of the larger magnitude."""
    import torch
    g, w = got.float(), want.float()
    fin = torch.isfinite(w)
    if not torch.equal(fin, torch.isfinite(g)):
        return False
    mag = torch.maximum(g[fin].abs(), w[fin].abs())
    return bool(((g[fin] - w[fin]).abs() <= mag * 2.0 ** -7).all())


def check_scan(got, want, *, dist_bf16: bool, full=None):
    """Compare one kernel output with the plain version's; returns
    (ok, max_abs_err over finite entries).  ``full`` (bW, seg) is given for
    a lane_l1 output: the unreduced distances, to find unique minima."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    if full is not None:
        gd, wd = got[:, 0], want[:, 0]
    else:
        gd, wd = got.float(), want.float()
    fin = torch.isfinite(wd)
    if not torch.equal(fin, torch.isfinite(gd)):
        return False, float("inf")
    err = float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0
    if dist_bf16:
        return bf16_ulp_ok(got, want), err
    ok = bool(torch.allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-5))
    if full is not None and ok:
        # the winning group must agree wherever the minimum is unique
        groups = full.reshape(full.shape[0], -1, got.shape[2])
        srt = torch.sort(groups, dim=1).values
        unique = torch.isfinite(srt[:, 0])
        if groups.shape[1] > 1:
            gap = srt[:, 1] - srt[:, 0]
            unique &= ~(gap <= 1e-4 * srt[:, 0].abs() + 1e-4)
        gt_, wt = got[:, 1].view(torch.int32), want[:, 1].view(torch.int32)
        ok = bool((gt_[unique] == wt[unique]).all())
    return ok, err


def kernel_phase(dev):
    """Phase 2: adc_scan_tiles vs adc_scan_tiles_reference at the flagship
    shape.  Returns the kernels-line entry, or raises."""
    import torch
    from chamjax_torch.benchmarks.bounds import ablate_bound, tile_scan_bound
    from chamjax_torch.ops.scan_seg import pack_luts_bf16
    from chamjax_torch.ops.scan_seg_block import (adc_scan_tiles,
                                                  adc_scan_tiles_reference)
    m, seg, bw, n_tiles, n_lut = 16, SEG, BATCH * NPROBE, 4096, BATCH * NPROBE
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    codes = torch.randint(0, 256, (n_tiles, m, seg), generator=g, device=dev,
                          dtype=torch.uint8)
    tile_idx = torch.randint(0, n_tiles, (bw,), generator=g, device=dev,
                             dtype=torch.int32)
    lut_idx = torch.randint(0, n_lut, (bw,), generator=g, device=dev,
                            dtype=torch.int32)
    lens = torch.randint(1, seg + 1, (bw,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[::2] = seg                    # half full, a quarter-ish partial,
    lens[1::8] = 0                     # one in eight empty
    luts_f32 = torch.rand((n_lut, m, 256), generator=g, device=dev) * 4.0
    luts_bf = pack_luts_bf16(luts_f32)
    # runs of 8 windows that share a LUT row (the staged row is kept)
    lut_runs = torch.randint(0, n_lut, (bw // 8,), generator=g, device=dev,
                             dtype=torch.int32).repeat_interleave(8)
    sets = [("f32_lut", dict(lut_bf16=False)),
            ("bf16_lut", dict(lut_bf16=True)),
            ("bf16_lut_dist_bf16", dict(lut_bf16=True, dist_bf16=True)),
            ("bf16_lut_lane_l1", dict(lut_bf16=True, lane_l1=True)),
            ("bf16_lut_runs8", dict(lut_bf16=True))]
    # the debug_ablate measurement bodies (exact: a code, or a sum of codes)
    sets += [(f"{lut}_lut_{body}", dict(lut_bf16=lut == "bf16",
                                        debug_ablate=body))
             for body in ("copy", "nogather") for lut in ("f32", "bf16")]
    results = []
    for name, opt in sets:
        luts = luts_bf if opt["lut_bf16"] else luts_f32
        args = (codes, tile_idx, lens,
                lut_runs if name.endswith("runs8") else lut_idx, luts)
        got = adc_scan_tiles(*args, seg=seg, group=GROUP, **opt)
        torch.cuda.synchronize()
        want = adc_scan_tiles_reference(*args, seg=seg, **opt)
        full = (adc_scan_tiles_reference(*args, seg=seg,
                                         lut_bf16=opt["lut_bf16"])
                if opt.get("lane_l1") else None)
        ok, err = check_scan(got, want, dist_bf16=bool(opt.get("dist_bf16")),
                             full=full)
        if opt.get("debug_ablate"):
            ok = ok and torch.equal(got, want)
        if not ok:
            raise AssertionError(f"adc_scan_tiles[{name}] disagrees with its "
                                 f"plain version (max abs err {err})")
        ms = device_ms(lambda: adc_scan_tiles(*args, seg=seg, group=GROUP,
                                              **opt))
        plain_ms = device_ms(lambda: adc_scan_tiles_reference(
            *args, seg=seg, **opt), plain=True)
        out_bytes = got.numel() * got.element_size()
        bound_ms, bound_by = (
            ablate_bound(opt["debug_ablate"], codes, tile_idx, out_bytes)
            if opt.get("debug_ablate") else tile_scan_bound(*args, out_bytes))
        results.append(dict(options=name, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by))
        log(f"adc_scan_tiles[{name}]: ok, max_abs_err={err:.3g} "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    return results


def flat_kernel_phase(dev):
    """Phase 2, flat layout: adc_scan_segments_multi, adc_scan_segments and
    adc_scan_distances vs their plain versions.  Returns {kernel: [entry
    per option set]}, or raises."""
    import numpy as np
    import torch
    from chamjax_torch.benchmarks.bounds import flat_scan_bound as flat_bound
    from chamjax_torch.ops.scan_pallas import (adc_scan_distances,
                                               adc_scan_distances_reference)
    from chamjax_torch.ops.scan_seg import (MAX_SEG, adc_scan_segments,
                                            adc_scan_segments_reference,
                                            pack_luts_bf16)
    from chamjax_torch.ops.scan_seg_multi import (
        adc_scan_segments_multi, adc_scan_segments_multi_reference)
    m, seg, bw = 16, SEG, BATCH * NPROBE
    rng = np.random.default_rng(1)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    # the flagship's flat layout: ~1.05M padded rows + MAX_SEG tail padding
    n_cols = (1 << 20) + MAX_SEG
    codes_t = torch.randint(0, 256, (m, n_cols), generator=g, device=dev,
                            dtype=torch.uint8)
    starts = rng.integers(0, (n_cols - MAX_SEG) // 64, bw) * 64
    lens = rng.integers(1, seg + 1, bw)
    lens[::2] = seg                    # half full, a quarter-ish partial,
    lens[1::8] = 0                     # one in eight empty (start 0)
    starts[1::8] = 0
    lut_idx = rng.integers(0, bw, bw)
    # the same windows at every start residue mod 16 over a layout whose
    # n_cols is 7 mod 16, so each code row has its own misalignment
    n_cols_u = n_cols + 7
    codes_u = torch.randint(0, 256, (m, n_cols_u), generator=g, device=dev,
                            dtype=torch.uint8)
    starts_u = starts + np.arange(bw) % 16
    starts_u[1::8] = 0
    starts, starts_u, lens, lut_idx = (
        torch.from_numpy(a.astype(np.int32)).to(dev)
        for a in (starts, starts_u, lens, lut_idx))
    luts_f32 = torch.rand((bw, m, 256), generator=g, device=dev) * 4.0
    luts_bf = pack_luts_bf16(luts_f32)
    layouts = (("", codes_t, starts), ("unaligned_", codes_u, starts_u))
    out = {}
    for name, fn, ref, sets in (
            ("adc_scan_segments_multi", adc_scan_segments_multi,
             adc_scan_segments_multi_reference,
             [("f32_lut", dict(lut_bf16=False)),
              ("bf16_lut", dict(lut_bf16=True)),
              ("bf16_lut_lane_l1", dict(lut_bf16=True, lane_l1=True))]),
            ("adc_scan_segments", adc_scan_segments,
             adc_scan_segments_reference,
             [("f32_lut", dict(lut_bf16=False)),
              ("bf16_lut", dict(lut_bf16=True))])):
        out[name] = []
        for (prefix, codes, sts), (opt_name, opt) in itertools.product(
                layouts, sets):
            luts = luts_bf if opt["lut_bf16"] else luts_f32
            args = (codes, sts, lens, lut_idx, luts)
            kw = dict(seg=seg, **opt)
            if fn is adc_scan_segments_multi:
                kw["group"] = GROUP
            ref_kw = dict(seg=seg, **opt)
            r = hold(f"{name}[{prefix}{opt_name}]", fn, ref, args, kw, ref_kw,
                     lambda o, a=args: flat_bound(
                         *a, width=seg, n_idx=3,
                         out_bytes=o.numel() * o.element_size()))
            out[name].append(dict(options=prefix + opt_name, **r))

    # adc_scan_distances: IVF1024 over 1M rows, lists of ~1k rows with a
    # tail (gamma-distributed, some empty, a few longer than scan_len),
    # list_pad 128; bp (query, probe) pairs over random lists
    nb, nlist, scan_len = FLAGSHIP["nb"], PALLAS_NLIST, PALLAS_SCAN_LEN
    list_len = rng.gamma(4.0, nb / nlist / 4.0, nlist).astype(np.int64)
    list_len[:8] = 0
    list_len[8:12] = rng.integers(scan_len + 1, scan_len + 2000, 4)
    padded = np.maximum(-(-list_len // 128) * 128, 128)
    list_start = np.concatenate([[0], np.cumsum(padded)[:-1]])
    n_cols_p = int(padded.sum()) + 8192 + MAX_SEG
    codes_p = torch.randint(0, 256, (m, n_cols_p), generator=g, device=dev,
                            dtype=torch.uint8)
    lids = rng.integers(0, nlist, bw)
    lids[:16] = np.arange(16)          # empty lists and the long tail
    p_starts, p_lens = (torch.from_numpy(a[lids].astype(np.int32)).to(dev)
                        for a in (list_start, list_len))
    p_luts = torch.rand((bw, m, 256), generator=g, device=dev) * 4.0
    args = (codes_p, p_starts, p_lens, p_luts)
    rows = torch.arange(bw, dtype=torch.int32, device=dev)
    r = hold("adc_scan_distances[f32_lut]", adc_scan_distances,
             adc_scan_distances_reference, args,
             dict(scan_len=scan_len), dict(scan_len=scan_len),
             lambda o: flat_bound(codes_p, p_starts, p_lens, rows, p_luts,
                                  width=scan_len, n_idx=2,
                                  out_bytes=o.numel() * 4))
    out["adc_scan_distances"] = [dict(
        options=f"f32_lut nlist={nlist} scan_len={scan_len} "
                f"mean_list={float(list_len.mean()):.1f} "
                f"max_list={int(list_len.max())}", **r)]
    return out


def time_search(dev_index, kw, xq_dev):
    """Device time of 65 back-to-back b=128 searches and of 200 b=1
    searches (CUDA events), beside the host time to enqueue them."""
    import torch
    from chamjax_torch.searcher import ivfpq_search
    n_b = xq_dev.shape[0] // BATCH
    batches = [xq_dev[i * BATCH:(i + 1) * BATCH] for i in range(n_b)]
    singles = [xq_dev[i:i + 1] for i in range(200)]
    res = {}
    for name, qs, warm in (("b128", batches, 3), ("b1", singles, 5)):
        for q in qs[:warm]:
            ivfpq_search(dev_index, q, **kw)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for q in qs:
            ivfpq_search(dev_index, q, **kw)
        res[f"host_{name}"] = (time.perf_counter() - t0) * 1e3 / len(qs)
        b.record()
        b.synchronize()
        res[f"ms_{name}"] = a.elapsed_time(b) / len(qs)
    return res


def main_path(dev):
    """Phase 3: the port's IVF-PQ query path at the 1M flagship."""
    import numpy as np
    import torch
    from chamjax_torch.benchmarks.bounds import tile_scan_bound as scan_bound
    from chamjax_torch.config import IndexConfig, SearchConfig
    from chamjax_torch.data import compute_ground_truth, synthetic_dataset
    from chamjax_torch.eval import recall_at_k
    from chamjax_torch.index import build_ivfpq
    from chamjax_torch.ops.coarse import select_probes
    from chamjax_torch.ops.lut import build_luts
    from chamjax_torch.ops.scan_seg import expand_windows, prepare_luts
    from chamjax_torch.ops.scan_seg_block import (adc_scan_tiles,
                                                  adc_scan_tiles_reference)
    from chamjax_torch.ops.topk import select_topk
    from chamjax_torch.searcher import IVFSearcher, _rotate
    from chamjax_torch.utils import cuda_lib
    from chamjax_torch.utils.precision import fp32_matmul

    t0 = time.perf_counter()
    ds = synthetic_dataset(**FLAGSHIP)
    t_data = time.perf_counter() - t0
    nb, d, nlist, m = FLAGSHIP["nb"], FLAGSHIP["d"], 4096, 16
    cfg = IndexConfig(dim=d, nlist=nlist, m=m, list_pad=128, opq=True,
                      balanced=True, balance_hard=True,
                      balance_factor=512 * nlist / nb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = build_ivfpq(ds.xb, cfg, xt=ds.xt, kmeans_iters=10, pq_iters=10,
                      device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"dataset {t_data:.1f} s, build {t_build:.1f} s, max list "
        f"{int(idx.list_len.max())}, cap "
        f"{int(np.ceil(nb / cfg.nlist * cfg.balance_factor))}")
    if int(idx.list_len.sum()) != nb:
        raise AssertionError("index lost rows")
    t0 = time.perf_counter()
    gt, _ = compute_ground_truth(ds.xb, ds.xq[:N_GT], k=K, device=dev)
    t_gt = time.perf_counter() - t0

    scfg = SearchConfig(nprobe=NPROBE, k=K, seg=SEG, seg_group=GROUP,
                        lut_bf16=True, approx_recall_target=0.9,
                        coarse_approx=True)
    s = IVFSearcher(idx, scfg, device=dev)
    xq = ds.xq[:N_GT]
    cuda_lib.launch_counts.clear()
    outs = [s.search(xq[i:i + BATCH]) for i in range(0, N_GT, BATCH)]
    launches = dict(cuda_lib.launch_counts)
    d_s = np.concatenate([o[0] for o in outs])
    i_s = np.concatenate([o[1] for o in outs])
    if launches.get("adc_scan_tiles", 0) < 1:
        raise AssertionError(f"main path did not launch adc_scan_tiles: "
                             f"{launches}")
    if d_s.shape != (N_GT, K) or i_s.shape != (N_GT, K):
        raise AssertionError(f"bad result shapes {d_s.shape} {i_s.shape}")
    fin = np.isfinite(d_s)
    if not fin[:, :10].all() or (np.diff(d_s, axis=1) < 0).any():
        raise AssertionError("distances not finite/sorted")
    if ((i_s[fin] < 0) | (i_s[fin] >= nb)).any() or (i_s[~fin] != -1).any():
        raise AssertionError("ids out of range")
    rec = {f"recall_at_{r}": recall_at_k(i_s, gt, r) for r in (1, 10, 100)}
    # oracles on the same index: the plain xla backend (f32 LUTs) and the
    # kernel path with f32 LUTs, which must agree with it; the packed-bf16
    # main path rounds LUT entries, so it is held to a looser bar
    s_x = IVFSearcher(idx, SearchConfig(nprobe=NPROBE, k=K, backend="xla"),
                      device=dev)
    r10_xla = recall_at_k(s_x.search(xq)[1], gt, 10)
    s_f = IVFSearcher(idx, dataclasses.replace(scfg, lut_bf16=False),
                      device=dev)
    res_f = s_f.search(xq)
    r10_f32 = recall_at_k(res_f[1], gt, 10)
    log(f"recall {rec}, f32-LUT kernel path R@10 {r10_f32:.4f}, xla oracle "
        f"R@10 {r10_xla:.4f}, launches {launches}")
    if abs(r10_f32 - r10_xla) > 0.002:
        raise AssertionError(f"f32-LUT seg R@10 {r10_f32} vs xla oracle "
                             f"{r10_xla}")
    if abs(rec["recall_at_10"] - r10_xla) > 0.01:
        raise AssertionError(f"seg R@10 {rec['recall_at_10']} vs xla oracle "
                             f"{r10_xla}")
    if rec["recall_at_10"] < MIN_R10:
        raise AssertionError(f"R@10 {rec['recall_at_10']} < {MIN_R10}")

    # kernel vs plain on one real main-path batch (not counted above)
    q = torch.as_tensor(xq[:BATCH]).to(dev)
    dv = s.dev
    with fp32_matmul():
        qr = q @ dv.opq_R
    list_ids, _ = select_probes(qr, dv.centroids, NPROBE)
    luts = build_luts(qr, dv.centroids, dv.codebooks, list_ids)
    starts, lens, probe, _ = expand_windows(list_ids, dv.list_start,
                                            dv.list_len, windows=s.windows,
                                            seg=SEG)
    luts_k, lut_idx = prepare_luts(luts, probe, lut_bf16=True)
    args = (dv.codes_tiled, (starts // SEG).reshape(-1).contiguous(),
            lens.reshape(-1).contiguous(), lut_idx, luts_k)
    got = adc_scan_tiles(*args, seg=SEG, group=GROUP, lut_bf16=True)
    want = adc_scan_tiles_reference(*args, seg=SEG, lut_bf16=True)
    ok, err = check_scan(got, want, dist_bf16=False)
    if not ok:
        raise AssertionError(f"kernel vs plain on main-path inputs: {err}")
    k_ms = device_ms(lambda: adc_scan_tiles(*args, seg=SEG, group=GROUP,
                                            lut_bf16=True))
    p_ms = device_ms(lambda: adc_scan_tiles_reference(*args, seg=SEG,
                                                      lut_bf16=True),
                     plain=True)
    b_ms, b_by = scan_bound(*args, got.numel() * 4)
    main_kernel = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                       bound_ms=b_ms, bound_by=b_by,
                       windows=int(args[1].numel()))

    # stage times of one b=128 search (CUDA events, median of 30)
    flat = got.reshape(BATCH, -1)
    stages = {
        "rotate": time_ms(lambda: _rotate(dv, q)),
        "coarse": time_ms(lambda: select_probes(qr, dv.centroids, NPROBE)),
        "luts": time_ms(lambda: build_luts(qr, dv.centroids, dv.codebooks,
                                           list_ids)),
        "windows": time_ms(lambda: prepare_luts(luts, expand_windows(
            list_ids, dv.list_start, dv.list_len, windows=s.windows,
            seg=SEG)[2], lut_bf16=True)),
        "scan": time_ms(lambda: adc_scan_tiles(*args, seg=SEG, group=GROUP,
                                               lut_bf16=True)),
        "topk": time_ms(lambda: select_topk(flat, K)),
    }

    kw = dict(nprobe=NPROBE, k=K, windows=s.windows, seg=SEG, group=GROUP,
              lut_bf16=True, backend="seg")
    xq_dev = torch.as_tensor(ds.xq[N_GT:]).to(dev)
    ts = time_search(s.dev, kw, xq_dev)
    ms_b128, ms_b1 = ts["ms_b128"], ts["ms_b1"]
    host_b128, host_b1 = ts["host_b128"], ts["host_b1"]
    ctx = dict(idx=idx, ds=ds, gt=gt, scfg=scfg, r10_xla=r10_xla,
               tiled_bf16=(d_s, i_s), tiled_f32=res_f, xq_dev=xq_dev,
               main_search=(s.dev, kw))
    return dict(
        launches=launches, main_kernel=main_kernel, ctx=ctx,
        line=dict(
            main_path="ivfpq_search 1M flagship (OPQ16,IVF4096,PQ16 hard-"
                      "balanced; seg=512 group=8 nprobe=32 k=100 lut_bf16)",
            nb=nb, nq_recall=N_GT, windows=s.windows, **rec,
            recall_at_10_xla_oracle=r10_xla,
            recall_at_10_f32_lut=r10_f32,
            qps_b128=BATCH * 1e3 / ms_b128, ms_per_batch_b128=ms_b128,
            ms_per_query_b1=ms_b1, stage_ms_b128=stages,
            # host time to enqueue one search; near the device time above
            # means the card waits on the host
            host_enqueue_ms_b128=host_b128, host_enqueue_ms_b1=host_b1,
            dataset_s=t_data, build_s=t_build, ground_truth_s=t_gt,
            max_list_len=int(idx.list_len.max())))


def check_same_up_to_ties(name, d, i, d_ref, i_ref, rtol: float) -> None:
    """Distances allclose(rtol) rank by rank, and ids equal except in the
    order of distance ties (``chamjax_torch.eval.tie_mismatches``)."""
    from chamjax_torch.eval import tie_mismatches
    bad = tie_mismatches(d, i, d_ref, i_ref, rtol=rtol, atol=rtol)
    if bad:
        raise AssertionError(f"{name}: {bad}")


def run_path(name, kernel, search, xq):
    """Drive one path over the recall queries in b=128 batches with every
    launch count set to 0 just before; its kernel must have launched.
    Returns (dists, ids, launches)."""
    import numpy as np
    from chamjax_torch.utils import cuda_lib
    cuda_lib.launch_counts.clear()
    outs = [search(xq[i:i + BATCH]) for i in range(0, len(xq), BATCH)]
    launches = dict(cuda_lib.launch_counts)
    if launches.get(kernel, 0) < 1:
        raise AssertionError(f"{name} did not launch {kernel}: {launches}")
    return (np.concatenate([o[0] for o in outs]),
            np.concatenate([o[1] for o in outs]), launches)


def routes_phase(dev, ctx):
    """Phase 4a: the flat-layout and padded-window routes of the resident
    searcher on the flagship index."""
    import dataclasses as dc
    import torch
    from chamjax_torch.benchmarks.bounds import flat_scan_bound as flat_bound
    from chamjax_torch.eval import recall_at_k
    from chamjax_torch.ops.coarse import select_probes
    from chamjax_torch.ops.lut import build_luts
    from chamjax_torch.ops.scan_pallas import (adc_scan_distances,
                                               adc_scan_distances_reference)
    from chamjax_torch.ops.scan_seg import (adc_scan_segments,
                                            adc_scan_segments_reference,
                                            expand_windows, prepare_luts)
    from chamjax_torch.ops.scan_seg_multi import (
        adc_scan_segments_multi, adc_scan_segments_multi_reference)
    from chamjax_torch.searcher import IVFSearcher, _rotate
    idx, gt, scfg = ctx["idx"], ctx["gt"], ctx["scfg"]
    xq = ctx["ds"].xq[:N_GT]
    r10_xla = ctx["r10_xla"]
    routes = (
        # name, options, kernel, R@10 bar vs the oracle, equal to
        ("flat_g8_f32", dict(tiled=False, seg_group=8, lut_bf16=False),
         "adc_scan_segments_multi", 0.002, "tiled_f32"),
        ("flat_g1_f32", dict(tiled=False, seg_group=1, lut_bf16=False),
         "adc_scan_segments", 0.002, "tiled_f32"),
        ("pallas", dict(backend="pallas", lut_bf16=False),
         "adc_scan_distances", 0.002, "tiled_f32"),
        ("flat_g8_bf16", dict(tiled=False, seg_group=8, lut_bf16=True),
         "adc_scan_segments_multi", 0.01, "tiled_bf16"),
    )
    line, kernels, results = {}, {}, {}
    q = ctx["xq_dev"][:BATCH]
    for name, opt, kernel, bar, ref in routes:
        sr = IVFSearcher(idx, dc.replace(scfg, **opt), device=dev)
        if sr.dev.codes_tiled is not None:
            raise AssertionError(f"{name}: a tiled twin was built")
        d, i, launches = run_path(name, kernel, sr.search, xq)
        results[name] = (d, i)
        r10 = recall_at_k(i, gt, 10)
        if abs(r10 - r10_xla) > bar:
            raise AssertionError(f"{name} R@10 {r10} vs xla oracle "
                                 f"{r10_xla} (bar {bar})")
        check_same_up_to_ties(f"{name} vs the {ref} route", d, i, *ctx[ref],
                              rtol=1e-5)
        entry = dict(recall_at_10=r10, launches=launches,
                     scan_len=sr.scan_len, windows=sr.windows)
        kw = dict(nprobe=NPROBE, k=K, windows=sr.windows, seg=SEG,
                  group=sr.group, lut_bf16=sr.scfg.lut_bf16,
                  backend=sr.backend, scan_len=sr.scan_len, tile=sr.tile)
        if name != "flat_g1_f32":
            entry.update(time_search(sr.dev, kw, ctx["xq_dev"]))
            entry["qps_b128"] = BATCH * 1e3 / entry["ms_b128"]
        line[name] = entry
        log(f"route {name}: {entry}")
        if kernel in kernels:
            continue
        # the route's kernel vs its plain version on one real batch (these
        # launches are not counted above)
        dv = sr.dev
        qr = _rotate(dv, q)
        list_ids, _ = select_probes(qr, dv.centroids, NPROBE)
        luts = build_luts(qr, dv.centroids, dv.codebooks, list_ids)
        if kernel == "adc_scan_distances":
            lid = list_ids.long()
            p_starts = dv.list_start[lid].reshape(-1).contiguous()
            p_lens = torch.clamp(dv.list_len[lid], max=sr.scan_len).reshape(
                -1).contiguous()
            luts_k = luts.permute(0, 1, 3, 2).reshape(
                -1, luts.shape[3], luts.shape[2]).contiguous()
            args = (dv.codes_t, p_starts, p_lens, luts_k)
            rows = torch.arange(p_starts.numel(), dtype=torch.int32,
                                device=dev)
            meas = hold(f"{kernel}[main path]", adc_scan_distances,
                     adc_scan_distances_reference, args,
                     dict(scan_len=sr.scan_len), dict(scan_len=sr.scan_len),
                     lambda o: flat_bound(
                         dv.codes_t, p_starts, p_lens, rows, luts_k,
                         width=sr.scan_len, n_idx=2,
                         out_bytes=o.numel() * 4))
        else:
            windows = -(-sr.windows // sr.group) * sr.group
            starts, lens, probe, _ = expand_windows(
                list_ids, dv.list_start, dv.list_len, windows=windows,
                seg=SEG)
            luts_k, lut_idx = prepare_luts(luts, probe, lut_bf16=False)
            args = (dv.codes_t, starts.reshape(-1).contiguous(),
                    lens.reshape(-1).contiguous(), lut_idx, luts_k)
            fn, ref = ((adc_scan_segments_multi,
                        adc_scan_segments_multi_reference)
                       if kernel == "adc_scan_segments_multi" else
                       (adc_scan_segments, adc_scan_segments_reference))
            kw_k = dict(seg=SEG, lut_bf16=False)
            if fn is adc_scan_segments_multi:
                kw_k["group"] = sr.group
            meas = hold(f"{kernel}[main path]", fn, ref, args, kw_k,
                     dict(seg=SEG, lut_bf16=False),
                     lambda o, a=args: flat_bound(
                         *a, width=SEG, n_idx=3, out_bytes=o.numel() * 4))
        kernels[kernel] = dict(meas, path=name,
                               launches=launches.get(kernel, 0),
                               windows=int(args[1].numel()))
    # the main path timed again after the routes, so that the order of the
    # timings does not decide the comparison between layouts
    line["tiled_bf16_repeat"] = time_search(*ctx["main_search"],
                                            ctx["xq_dev"])
    return dict(line=line, kernels=kernels, results=results)


def streamed_phase(dev, ctx, flat_bf16):
    """Phase 4b: HostStreamedSearcher, tiled and flat, against the resident
    search; search_pipelined over the 65 remaining b=128 batches; one
    batch's host gather, copy and device scan."""
    import dataclasses as dc
    import numpy as np
    import torch
    from chamjax_torch.eval import recall_at_k
    from chamjax_torch.streamed import HostStreamedSearcher
    idx, scfg, gt = ctx["idx"], ctx["scfg"], ctx["gt"]
    xq = ctx["ds"].xq
    batches = [xq[N_GT + i * BATCH:N_GT + (i + 1) * BATCH]
               for i in range((len(xq) - N_GT) // BATCH)]
    line, launches_by_kernel = {}, {}
    for tiled, kernel, resident in (
            (True, "adc_scan_tiles", ctx["tiled_bf16"]),
            (False, "adc_scan_segments_multi", flat_bf16)):
        name = f"streamed_{'tiled' if tiled else 'flat'}"
        st = HostStreamedSearcher(idx, dc.replace(scfg, tiled=tiled),
                                  device=dev)
        d, i, launches = run_path(name, kernel, st.search, xq[:N_GT])
        launches_by_kernel[kernel] = launches.get(kernel, 0)
        check_same_up_to_ties(f"{name} vs the resident search", d, i,
                              *resident, rtol=1e-4)
        r10 = recall_at_k(i, gt, 10)
        r10_res = recall_at_k(resident[1], gt, 10)
        if r10 != r10_res:
            raise AssertionError(f"{name} R@10 {r10} vs resident {r10_res}")
        # the pipelined stream equals the sequential search
        st.search_pipelined(batches[:2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        piped = st.search_pipelined(batches)
        t_pipe = time.perf_counter() - t0
        for j in (0, len(batches) - 1):
            d_s, i_s = st.search(batches[j])
            if not (np.array_equal(piped[j][0], d_s)
                    and np.array_equal(piped[j][1], i_s)):
                raise AssertionError(f"{name}: search_pipelined batch {j} "
                                     "differs from search")
        t_seq0 = time.perf_counter()
        for b_ in batches[:16]:
            st.search(b_)
        t_seq = (time.perf_counter() - t_seq0) / 16
        # one batch, part by part
        plan_ms, gather_ms = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = st._plan(batches[0])
            starts_h = plan[0].cpu().numpy()
            t1 = time.perf_counter()
            host = st._gather(starts_h, 0)
            t2 = time.perf_counter()
            plan_ms.append((t1 - t0) * 1e3)
            gather_ms.append((t2 - t1) * 1e3)
        slab = st._upload(host, 0)
        _s, lens, probe, list_ids, q_rot = plan
        h2d = time_ms(lambda: st._upload(host, 0), reps=10)
        scan = time_ms(lambda: st._scan(slab, lens, probe, list_ids, q_rot,
                                        K), reps=10)
        d_b, pos_b = st._scan(slab, lens, probe, list_ids, q_rot, K)
        d_h = d_b.cpu().numpy()
        t0 = time.perf_counter()
        st._map_ids(d_h, pos_b.cpu().numpy(), starts_h)
        map_ms = (time.perf_counter() - t0) * 1e3
        entry = dict(
            recall_at_10=r10, launches=launches, windows=st.windows,
            slab_mb=host.numel() / 2 ** 20,
            pipelined_qps_b128=len(batches) * BATCH / t_pipe,
            pipelined_ms_per_batch=t_pipe * 1e3 / len(batches),
            sequential_ms_per_batch=t_seq * 1e3,
            batch_ms=dict(plan_and_pull=float(np.median(plan_ms)),
                          host_gather=float(np.median(gather_ms)),
                          h2d_copy=h2d, device_scan=scan,
                          map_ids=map_ms))
        line[name] = entry
        log(f"{name}: {entry}")
    return dict(line=line, launches=launches_by_kernel)


ROOFLINE_VARIANTS = ("seg_f32", "seg_bf16", "block_f32", "block_bf16",
                     "block_bf16copy", "block_bf16nogather")
N_TRACED = 10


def variants_phase(dev):
    """Phase 2: every run_variant variant and run_block_variant against
    their plain versions at m=16, n=2^20, bW=4096, seg 512 and 2048, each
    timed beside its plain version and its bound.  Returns {kernel: [entry
    per (variant, seg)]}, or raises."""
    import torch
    from chamjax_torch.benchmarks import kernel_variants as kv
    from chamjax_torch.benchmarks.bounds import variant_bound
    args = kv.parse_args(["--n", str(1 << 20), "--seed", "3"])
    data = kv.make_data(args, dev)
    out = {"run_variant": [], "run_block_variant": []}
    for seg in (512, 2048):
        starts = torch.randint(0, (args.n - seg) // 512, (args.bw,),
                               generator=data["gen"], device=dev,
                               dtype=torch.int32) * 512
        lens = torch.full((args.bw,), seg, dtype=torch.int32, device=dev)
        for variant in (*kv.VARIANTS, kv.BLOCK_VARIANT):
            cd, st = kv.inputs_for(data, variant, seg, starts)
            lt = data["luts_p"] if kv.packed(variant) else data["luts"]
            call = (cd, st, lens, data["lut_idx"], lt)
            if variant == kv.BLOCK_VARIANT:
                name = "run_block_variant"
                got = kv.run_block_variant(*call, seg=seg, group=GROUP)
                ref = lambda c=call, s_=seg: kv.run_block_variant_reference(
                    *c, seg=s_, group=GROUP)
            else:
                name = "run_variant"
                got = kv.run_variant(*call, seg=seg, group=GROUP,
                                     variant=variant)
                ref = lambda c=call, s_=seg, v=variant: \
                    kv.run_variant_reference(*c, seg=s_, group=GROUP,
                                             variant=v)
            torch.cuda.synchronize()
            err = kv.hold(f"{name}[{variant}] seg {seg}", got, ref(),
                          exact=variant in kv.EXACT_VARIANTS)
            ms = kv.event_ms(lambda c=call, s_=seg, v=variant: kv.launch(
                v, c[0], c[1], c[3], c[4], seg=s_))
            plain_ms = kv.event_ms(ref, launches=3, reps=3, warmup=1)
            bound_ms, bound_by = variant_bound(variant, cd, st,
                                               data["lut_idx"], lt, seg=seg,
                                               out_bytes=got.numel() * 4)
            out[name].append(dict(variant=variant, seg=seg, max_abs_err=err,
                                  ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by))
            log(f"{name}[{variant}] seg {seg}: ok, max_abs_err={err:.3g} "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})")
    return out


def trace_phase(dev, ctx):
    """Phase 3: the card's busy share over ``N_TRACED`` back-to-back b=128
    main-path searches: CUDA kernel time in a ``tracing.trace`` window over
    the window's host time (synchronised at both ends, profiler on), and
    the kernels that took the most device time."""
    import os
    import torch
    from chamjax_torch.searcher import ivfpq_search
    from chamjax_torch.utils import tracing
    dv, kw = ctx["main_search"]
    xq = ctx["xq_dev"]
    qs = [xq[i * BATCH:(i + 1) * BATCH] for i in range(N_TRACED)]
    for q in qs[:3]:
        ivfpq_search(dv, q, **kw)
    torch.cuda.synchronize()
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chamjax_torch", "build", "traces")
    annotation = f"{N_TRACED}_searches_b{BATCH}"
    with tracing.trace(log_dir) as prof:
        t0 = time.perf_counter()
        with tracing.annotate(annotation):
            for q in qs:
                ivfpq_search(dv, q, **kw)
            torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # device events, less the annotation's own device-side range
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and e.name != annotation]
    kernels = [e for e in dev_events
               if not e.name.startswith(("Memcpy", "Memset"))]
    res = dict(window_ms=window_ms, searches=N_TRACED,
               trace_files=sorted(os.listdir(log_dir))[-1:])
    if not kernels:
        res.update(busy_share=None, reason=(
            "torch.profiler recorded no CUDA activity on this machine "
            f"({len(dev_events)} device events)"))
        return res

    def busy_us(events):
        """Length of the union of the events' device intervals."""
        total, end = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in events):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    kernel_ms = busy_us(kernels) / 1e3
    res.update(busy_share=kernel_ms / window_ms, kernel_ms=kernel_ms,
               copy_ms=busy_us([e for e in dev_events
                                if e.name.startswith(("Memcpy", "Memset"))]
                               ) / 1e3,
               kernel_launches=len(kernels),
               top_kernels=[dict(name=n[:160], ms=v[0], launches=v[1])
                            for n, v in top])
    return res


def study_phase(dev, card):
    """Phase 5: the kernel-study path at its full width (the JAX harness's
    defaults: a 16M x m16 slab, bW=4096, n_lut=4096): every measurement
    variant at seg 2048, again with --same-lut, then the roofline matrix
    at seg 1024 and 2048 with runlen 0 and 8.  Both harnesses hold each
    configuration's first output against its plain version before timing
    it (a disagreement fails the phase).  Counts are set to 0 just before
    and read just after; every kernel of the path must launch."""
    from chamjax_torch.benchmarks import kernel_roofline as kr
    from chamjax_torch.benchmarks import kernel_variants as kv
    from chamjax_torch.utils import cuda_lib
    every = [*kv.VARIANTS, kv.BLOCK_VARIANT]
    t0 = time.perf_counter()
    cuda_lib.launch_counts.clear()
    rows = list(kv.study(kv.parse_args(["--variants", *every]), dev, card))
    rows += list(kv.study(kv.parse_args(["--variants", *every, "--same-lut"]),
                          dev, card))
    roof = list(kr.study(kr.parse_args(["--variants", *ROOFLINE_VARIANTS,
                                        "--runlen", "0", "8"]), dev, card))
    launches = dict(cuda_lib.launch_counts)
    bad = [r for r in rows if "error" in r]
    if bad:
        raise AssertionError(f"kernel study: {bad}")
    for name in ("run_variant", "run_block_variant", "adc_scan_tiles",
                 "adc_scan_segments_multi"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel study did not launch {name}: "
                                 f"{launches}")
    timed = rows + [r for r in roof if "ms" in r]
    if not all(0 < r["ms"] < float("inf") for r in timed):
        raise AssertionError("kernel study: a time is not finite and > 0")
    for r in rows:
        log(f"study {r['variant']}{' same_lut' if r['same_lut'] else ''}: "
            f"{r['ms']:.4f} ms, {r['code_gbs']:.0f} code GB/s, bound "
            f"{r['bound_ms']:.4f} ms, max_abs_err {r['max_abs_err']:.3g}")
    for r in roof:
        log(f"roofline {r}")
    return dict(variants=[r for r in rows if not r["same_lut"]],
                variants_same_lut=[r for r in rows if r["same_lut"]],
                roofline=[r for r in roof if "best" not in r],
                best=roof[-1]["best"], launches=launches,
                seconds=time.perf_counter() - t0)


def main() -> int:
    try:
        import torch
    except ImportError as e:
        return fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    try:
        from chamjax_torch.utils import cuda_lib
    except ImportError as e:
        return fail(f"chamjax_torch is not importable beside this script: "
                    f"{e}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    build_logs = cuda_lib.build()
    t_nvcc = time.perf_counter() - t0
    for name, text in build_logs.items():
        for line in text.strip().splitlines():
            log(f"nvcc {name}: {line}")
    log(f"kernels built in {t_nvcc:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode:
        return fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    try:
        options = kernel_phase(dev)
        flat_options = flat_kernel_phase(dev)
        variant_options = variants_phase(dev)
        main = main_path(dev)
        traced = trace_phase(dev, main["ctx"])
        routes = routes_phase(dev, main["ctx"])
        streamed = streamed_phase(dev, main["ctx"],
                                  routes["results"]["flat_g8_bf16"])
        study = study_phase(dev, card)
    except AssertionError as e:
        return fail(str(e))
    log(f"trace: {traced}")
    mk = main["main_kernel"]
    kernels = [dict(
        name="adc_scan_tiles", route="cuda",
        source="chamjax_torch/csrc/adc_scan_tiles.cu",
        replaces="chamjax/ops/scan_seg_block.py:122",
        launches=main["launches"].get("adc_scan_tiles", 0),
        max_abs_err=mk["max_abs_err"], ms=mk["ms"], plain_ms=mk["plain_ms"],
        bound_ms=mk["bound_ms"], bound_by=mk["bound_by"], library_ms=None,
        main_path_windows=mk["windows"], options=options,
        launches_streamed_tiled=streamed["launches"]["adc_scan_tiles"],
        launches_kernel_study=study["launches"]["adc_scan_tiles"])]
    for name, replaces in (
            ("adc_scan_segments_multi", "chamjax/ops/scan_seg_multi.py:134"),
            ("adc_scan_segments", "chamjax/ops/scan_seg.py:162"),
            ("adc_scan_distances", "chamjax/ops/scan_pallas.py:118")):
        rk = routes["kernels"][name]
        kernels.append(dict(
            name=name, route="cuda",
            source="chamjax_torch/csrc/adc_scan_flat.cu", replaces=replaces,
            launches=rk["launches"], max_abs_err=rk["max_abs_err"],
            ms=rk["ms"], plain_ms=rk["plain_ms"], bound_ms=rk["bound_ms"],
            bound_by=rk["bound_by"], library_ms=None, path=rk["path"],
            main_path_windows=rk["windows"], options=flat_options[name]))
    kernels[1]["launches_streamed_flat"] = (
        streamed["launches"]["adc_scan_segments_multi"])
    kernels[1]["launches_kernel_study"] = (
        study["launches"]["adc_scan_segments_multi"])
    # the measurement kernels: the row's times are the baseline body's
    # (f32; block_bf16t) at seg 2048 against its plain version; options
    # hold every variant at seg 512 and 2048
    for name, head, replaces in (
            ("run_variant", "f32", "benchmarks/kernel_variants.py:322"),
            ("run_block_variant", "block_bf16t",
             "benchmarks/kernel_variants.py:280")):
        rows = variant_options[name]
        h = next(r for r in rows if r["variant"] == head and r["seg"] == 2048)
        kernels.append(dict(
            name=name, route="cuda",
            source="chamjax_torch/csrc/adc_scan_variants.cu",
            replaces=replaces, launches=study["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=h["ms"],
            plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=None, path="kernel study",
            options=rows))
    print(json.dumps({"kernels": kernels}), flush=True)
    # busy_share divides by the profiled window, which the profiler
    # stretches; busy_share_unprofiled divides the same kernel time a
    # search by this run's unprofiled b=128 batch time
    unprofiled = (traced["kernel_ms"] / traced["searches"]
                  / main["line"]["ms_per_batch_b128"]
                  if traced["busy_share"] is not None else None)
    print(json.dumps(dict(main["line"], busy_share=traced["busy_share"],
                          busy_share_unprofiled=unprofiled,
                          trace=traced, card=card, nvcc_s=t_nvcc)),
          flush=True)
    print(json.dumps(dict(routes=routes["line"], **streamed["line"],
                          card=card)), flush=True)
    print(json.dumps(dict(kernel_study=study, card=card)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
