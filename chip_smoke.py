#!/usr/bin/env python3
"""Smoke test of chamjax_torch on one NVIDIA card: builds the CUDA kernels
from ``chamjax_torch/csrc``, holds each against its plain PyTorch version,
then drives the IVF-PQ query path at the 1M flagship size.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. Build the kernels (one ``nvcc`` per source, started together); print the
   card's name and power limit.
2. Kernel vs plain version at the flagship shape (m=16, seg=512,
   bW=4096 windows over 4096 random tiles, some windows empty, some
   partial) for four option sets: f32 LUT, packed-bf16 LUT, bf16 distance
   output, and the in-kernel lane-L1 reduction.  Each is timed with CUDA
   events (median of 30) beside its plain version and its bound.
3. The main path: ``synthetic_dataset`` (1M x 128, 4096 clusters, seed 42)
   → ``build_ivfpq`` (OPQ16 + IVF4096 + PQ16, hard-balanced) →
   ``compute_ground_truth`` (256 queries) → ``IVFSearcher.search``
   (seg=512, group=8, nprobe=32, k=100, packed-bf16 LUTs).  Recall is
   checked against the same index searched by the plain ``xla`` backend;
   the kernel's launch count must rise during the search.  Times a
   b=128 and a b=1 search and the stages of a b=128 search.
4. Print the kernels line, the main-path line, and the result line.

Needs the card, the CUDA toolkit (``nvcc``) and the rest of this repository
beside the script.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

H100_HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12        # non-tensor fp32
FLAGSHIP = dict(nb=1_000_000, nq=128 * 65 + 256, nt=100_000, d=128, seed=42,
                n_clusters=4096)
BATCH, NPROBE, K, SEG, GROUP = 128, 32, 100, 512, 8
N_GT = 256
MIN_R10 = 0.85


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> int:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn``."""
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


def scan_bound(codes_tiled, tile_idx, lens, lut_idx, luts, out_bytes: int):
    """Least time for the scan on an H100: each needed input byte read once
    and each output byte written once, over the HBM rate; the adds this
    data needs over the fp32 rate.  Returns (ms, "bytes" | "operations")."""
    import torch
    m, seg = codes_tiled.shape[1], codes_tiled.shape[2]
    active = lens > 0
    # codes: per referenced tile, the rows the longest window over it needs
    rows = torch.zeros(codes_tiled.shape[0], dtype=torch.int64,
                       device=lens.device)
    rows.scatter_reduce_(0, tile_idx[active].long(), lens[active].long(),
                         reduce="amax")
    code_bytes = int(rows.sum()) * m
    lut_rows = int(torch.unique(lut_idx[active]).numel())
    lut_bytes = lut_rows * luts.shape[1] * luts.shape[2] * 4
    idx_bytes = 3 * 4 * tile_idx.numel()
    nbytes = code_bytes + lut_bytes + idx_bytes + out_bytes
    adds = int(lens.long().sum()) * m
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = adds / H100_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    sets = [("f32_lut", dict(lut_bf16=False)),
            ("bf16_lut", dict(lut_bf16=True)),
            ("bf16_lut_dist_bf16", dict(lut_bf16=True, dist_bf16=True)),
            ("bf16_lut_lane_l1", dict(lut_bf16=True, lane_l1=True))]
    results = []
    for name, opt in sets:
        luts = luts_bf if opt["lut_bf16"] else luts_f32
        args = (codes, tile_idx, lens, lut_idx, luts)
        got = adc_scan_tiles(*args, seg=seg, group=GROUP, **opt)
        torch.cuda.synchronize()
        want = adc_scan_tiles_reference(*args, seg=seg, **opt)
        full = (adc_scan_tiles_reference(*args, seg=seg,
                                         lut_bf16=opt["lut_bf16"])
                if opt.get("lane_l1") else None)
        ok, err = check_scan(got, want, dist_bf16=bool(opt.get("dist_bf16")),
                             full=full)
        if not ok:
            raise AssertionError(f"adc_scan_tiles[{name}] disagrees with its "
                                 f"plain version (max abs err {err})")
        ms = time_ms(lambda: adc_scan_tiles(*args, seg=seg, group=GROUP,
                                            **opt))
        plain_ms = time_ms(lambda: adc_scan_tiles_reference(*args, seg=seg,
                                                            **opt))
        out_bytes = got.numel() * got.element_size()
        bound_ms, bound_by = scan_bound(*args, out_bytes)
        results.append(dict(options=name, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by))
        log(f"adc_scan_tiles[{name}]: ok, max_abs_err={err:.3g} "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    return results


def main_path(dev):
    """Phase 3: the port's IVF-PQ query path at the 1M flagship."""
    import numpy as np
    import torch
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
    from chamjax_torch.searcher import IVFSearcher, _rotate, ivfpq_search
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
    r10_f32 = recall_at_k(s_f.search(xq)[1], gt, 10)
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
    k_ms = time_ms(lambda: adc_scan_tiles(*args, seg=SEG, group=GROUP,
                                          lut_bf16=True))
    p_ms = time_ms(lambda: adc_scan_tiles_reference(*args, seg=SEG,
                                                    lut_bf16=True))
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
        "scan": k_ms,
        "topk": time_ms(lambda: select_topk(flat, K)),
    }

    kw = dict(nprobe=NPROBE, k=K, windows=s.windows, seg=SEG, group=GROUP,
              lut_bf16=True, backend="seg")
    xq_dev = torch.as_tensor(ds.xq[N_GT:]).to(dev)
    n_b = xq_dev.shape[0] // BATCH
    batches = [xq_dev[i * BATCH:(i + 1) * BATCH] for i in range(n_b)]
    for b_ in batches[:3]:
        ivfpq_search(s.dev, b_, **kw)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for b_ in batches:
        ivfpq_search(s.dev, b_, **kw)
    host_b128 = (time.perf_counter() - t0) * 1e3 / n_b  # enqueue only
    b.record()
    b.synchronize()
    ms_b128 = a.elapsed_time(b) / n_b
    singles = [xq_dev[i:i + 1] for i in range(200)]
    for q1 in singles[:5]:
        ivfpq_search(s.dev, q1, **kw)
    torch.cuda.synchronize()
    a.record()
    t0 = time.perf_counter()
    for q1 in singles:
        ivfpq_search(s.dev, q1, **kw)
    host_b1 = (time.perf_counter() - t0) * 1e3 / len(singles)
    b.record()
    b.synchronize()
    ms_b1 = a.elapsed_time(b) / len(singles)
    return dict(
        launches=launches, main_kernel=main_kernel,
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
        main = main_path(dev)
    except AssertionError as e:
        return fail(str(e))
    mk = main["main_kernel"]
    kernels = [dict(
        name="adc_scan_tiles", route="cuda",
        source="chamjax_torch/csrc/adc_scan_tiles.cu",
        replaces="chamjax/ops/scan_seg_block.py:122",
        launches=main["launches"].get("adc_scan_tiles", 0),
        max_abs_err=mk["max_abs_err"], ms=mk["ms"], plain_ms=mk["plain_ms"],
        bound_ms=mk["bound_ms"], bound_by=mk["bound_by"], library_ms=None,
        main_path_windows=mk["windows"], options=options)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps(dict(main["line"], card=card, nvcc_s=t_nvcc)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
