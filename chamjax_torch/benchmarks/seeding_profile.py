"""Where the k-means++ seeding's time goes at the 1M flagship, on the card.

The flagship build (``chip_smoke.py``'s main path: ``build_ivfpq`` over
``synthetic_dataset_device(nb=1M, nt=100k, d=128, seed=42)``, IVF4096)
seeds its k-means with ``index/kmeans.py::_kmeanspp_init`` on all of
``xt`` (100,000 x 128, k = 4096): 4095 steps, each one Gumbel-max draw
over the 100,000 rows and a distance update.  This script reports:

- ``seeding``: the seeding's wall time on the flagship's ``xt`` (host
  clock between two device syncs, twice), the launches it made by kernel
  name (``cuda_lib.launch_counts``) and a digest of the centroids (the
  same digest from two trees means the same seeds);
- ``sync``: the host syncs of 64 steps run under
  ``torch.cuda.set_sync_debug_mode("warn")`` (each warning one sync);
- ``trace``: one seeding under ``torch.profiler``: the window's wall
  time, the device time by kernel name, the busy union and the idle share
  (1 - busy / window), kernels a step, the host's launching calls;
- ``build``: one flagship ``build_ivfpq`` (OPQ16 + IVF4096 + PQ16,
  hard-balanced, 10 k-means and 10 PQ iterations, as the smoke runs it),
  its wall time and the seeding's wall time inside it (the seeding
  wrapped between two device syncs), and the share.

``--tree DIR`` imports ``chamjax_torch`` from ``DIR`` (an unpacked
earlier commit) instead of this checkout, so two trees run the same
measurement in turns.  Run it by path, not with ``-m``:

    python chamjax_torch/benchmarks/seeding_profile.py [--tree DIR]
        [--no-build]

Prints one JSON line per part, each with the card's name and power limit.
Needs the card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import sys
import time
import warnings
from pathlib import Path

FLAGSHIP = dict(nb=1_000_000, nq=256, nt=100_000, d=128, seed=42,
                n_clusters=4096)
NLIST = 4096
SYNC_STEPS = 64


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="import chamjax_torch from this directory")
    ap.add_argument("--no-build", action="store_true",
                    help="skip the flagship build")
    return ap.parse_args(argv)


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def seeding(init, xt, key, cuda_lib, torch) -> dict:
    walls = []
    for _ in range(2):
        cuda_lib.launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cents = init(xt, NLIST, key)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return dict(wall_s=walls, launches=dict(cuda_lib.launch_counts),
                centroids_digest=digest(cents), steps=NLIST - 1)


def syncs(init, xt, key, torch) -> dict:
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            init(xt, SYNC_STEPS + 1, key)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    msgs = [str(w.message) for w in caught
            if "synchroniz" in str(w.message).lower()]
    return dict(steps=SYNC_STEPS, syncs=len(msgs),
                syncs_per_step=len(msgs) / SYNC_STEPS,
                first=msgs[0][:200] if msgs else None)


def busy_us(events) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace(init, xt, key, torch) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        init(xt, NLIST, key)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        return dict(window_ms=window_ms, busy_share=None,
                    reason="torch.profiler recorded no CUDA activity")
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = busy_us(events) / 1e3
    calls = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
             "cudaStreamSynchronize", "cudaDeviceSynchronize")
    return dict(
        window_ms=window_ms, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / window_ms,
        device_events=len(events), events_per_step=len(events) / (NLIST - 1),
        by_kernel=[dict(name=n[:120], ms=v[0], launches=v[1])
                   for n, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][0])],
        host_calls={e.key: e.count for e in prof.key_averages()
                    if e.key in calls})


def build(ds, kmeans_mod, torch, dev) -> dict:
    from chamjax_torch.config import IndexConfig
    from chamjax_torch.index import build_ivfpq
    nb, d = FLAGSHIP["nb"], FLAGSHIP["d"]
    cfg = IndexConfig(dim=d, nlist=NLIST, m=16, list_pad=128, opq=True,
                      balanced=True, balance_hard=True,
                      balance_factor=512 * NLIST / nb)
    inner = kmeans_mod._kmeanspp_init
    spans = []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return out

    kmeans_mod._kmeanspp_init = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            idx = build_ivfpq(ds.xb, cfg, xt=ds.xt, kmeans_iters=10,
                              pq_iters=10, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        kmeans_mod._kmeanspp_init = inner
    return dict(build_s=wall, seeding_s=spans,
                seeding_share=sum(spans) / wall,
                rows=int(idx.list_len.sum()))


def main(argv=None) -> int:
    args = parse_args(argv)
    root = (args.tree or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import torch
    from chamjax_torch import random as jr
    from chamjax_torch.data import Dataset, synthetic_dataset_device
    from chamjax_torch.utils import cuda_lib
    from chamjax_torch.utils.device import card_description, resolve_device

    # the module (the package's ``kmeans`` is the function)
    kmeans_mod = importlib.import_module("chamjax_torch.index.kmeans")
    dev = resolve_device(None)          # raises without a card
    card = card_description()
    tree = str(args.tree) if args.tree else "this"
    cuda_lib.build()
    drawn = synthetic_dataset_device(**FLAGSHIP, to_host=False, device=dev)
    xt = drawn.xt.contiguous()
    key = jr.key(0)                     # build_ivfpq's seed 0
    init = kmeans_mod._kmeanspp_init
    init(xt, 9, key)                    # warm: kernels loaded, allocator
    torch.cuda.synchronize()
    for name, fn in (("seeding", lambda: seeding(init, xt, key, cuda_lib,
                                                 torch)),
                     ("sync", lambda: syncs(init, xt, key, torch)),
                     ("trace", lambda: trace(init, xt, key, torch))):
        print(json.dumps({name: fn(), "tree": tree, "card": card}),
              flush=True)
    if not args.no_build:
        ds = Dataset(name="SYN", **{p: getattr(drawn, p).cpu().numpy()
                                    for p in ("xb", "xq", "xt")})
        del drawn, xt
        torch.cuda.empty_cache()
        print(json.dumps({"build": build(ds, kmeans_mod, torch, dev),
                          "tree": tree, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
