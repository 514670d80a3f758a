#!/usr/bin/env python3
"""Smoke test of chamjax_torch on one NVIDIA card: builds the CUDA kernels
from ``chamjax_torch/csrc`` and the host library from
``chamjax_torch/native/src``, holds each kernel against its plain PyTorch
version, then drives every scan route of the IVF-PQ query path at the 1M
flagship size, the kernel study, the RALM serving path (decode fused with
the on-card retrieval) at the full width of the Dec-S, Llama-S and EncDec-S
presets, disaggregated serving (engine processes behind an index server
and behind the coordinators), the streamed index build on the card, and
the mesh tier (list-sharded search, the sharded build, tensor-parallel
decode, the multi-chip RAG step) on positions of this card, and the
retrieval-quality path (the IR matrix with a dual encoder trained and mined
on the card, and the advanced-RAG pipeline); on the flagship also the stage
profile, the recall-loss diagnosis, the card's efficiency and the host's
ADC rate.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. Build the kernels (one ``nvcc`` per source, started together),
   ``libchamnet`` and ``adc_bench`` (``g++``, in a thread meanwhile); print
   the card's name and power limit.
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
   kernels that took the most device time.  ``recall_diagnosis`` splits
   the R@10 loss of the packed-bf16 search and of the f32-LUT search
   (their top 10) into found / probe / window / quant / select: the five
   sum to 1 within 1e-9 and ``found`` is the search's intersection R@10
   exactly.  ``card_efficiency`` gives QPS/W and mJ/query at the b=128
   QPS (duty 1.0, the card's power limit), and ``RaplMeter`` the host's
   power over 20 passes of the b=128 loop (null without RAPL counters).
   Each scan kernel's library column: ``embedding_bag`` over the flat
   LUT indices of the valid rows at that kernel's main-path inputs, held
   against the kernel's output (rtol 1e-5) and timed beside it.
   The stage profile (``benchmarks/profiling_stages.py``) over the
   flagship's ``DeviceIVF`` at b=128 and b=1 with every option (packed
   LUTs, the two-stage coarse scan, lane L1, select L1), counts set to 0
   just before and read just after: every time finite and > 0, the timed
   scans' outputs equal the plain version's (f32 rtol 1e-5, packed one
   bf16 ulp), the five stages' sum beside ``full_ms``.
4. The other routes on the same index, each run over the 256 recall
   queries with the launch counts set to 0 just before and read just
   after (its kernel must have launched): the flat layout (``tiled=False``)
   at group 8 and group 1 and ``backend="pallas"`` with f32 LUTs, each
   within 0.002 R@10 of the xla oracle and equal to the tiled f32 route
   except in the order of distance ties (``tie_mismatches``); flat group 8
   with packed-bf16 LUTs within 0.01 of the oracle; ``HostStreamedSearcher``
   with ``tiled`` True and False, each equal to the resident search up to
   the order of ties, at the same R@10, gathering with the native gather
   (``gather_path`` must be "native") and again with the numpy gather
   (bit-equal results).  Each route's kernel is held
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
6. The RALM serving path (``chamjax_torch.benchmarks.ralm_device_bench``,
   its non-streamed leg): ``synthetic_dataset`` (1M x 512, 4096 clusters,
   seed 11) → ``build_ivfpq`` (IVF4096 + PQ16, balanced 1.3, 8 k-means and
   8 PQ iterations) behind one ``LocalRetriever`` (nprobe 32, k 10: the
   tiled kernel); Dec-S and Llama-S at retrieval interval 1 and EncDec-S at
   its preset interval 8, full width in bf16 (random weights, seed 0),
   batch 64, 8 warmup and 128 timed steps.  The timed steps run under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync) with the
   launch counts set to 0 just before and read just after
   (``adc_scan_tiles`` must have launched).  Then, per preset: 8 more steps
   traced (kernel launches and device time a step, busy share); the last
   step's hidden states searched again by ``retrieve_device`` and by
   ``IVFSearcher.search``, both equal to the fused result up to ties; the
   tiled kernel held against its plain version on that step's windows and
   timed beside its bound.  Last, the first 4 decode steps of Dec-S and
   Llama-S at batch 4, bf16 on the card against the same parameters in
   f32 on the CPU (logits within 0.03 of the f32 logits' largest
   magnitude).  Per preset also: the eager leg (8 warmup, 32 timed steps
   under the sync check, 8 traced) on the same loop; the first 16 steps
   from one reset both ways (tokens and fused retrievals equal); and a
   copy of the preset with a 4-position cache, whose fifth step must raise
   both ways.
7. Tik-tok (``chamjax_torch.serving.tiktok``) on the fused path:
   ``TikTokDecoder`` on Dec-S at interval 1 and ``TikTokEncoderDecoder`` on
   EncDec-S at interval 8, batch 64 a state, the two states seeded with
   different first tokens; each state's tokens and last retrieval equal to
   a ``RalmDecoder`` / ``RalmEncoderDecoder`` run from the same tokens; tok/s
   of both.  Then its host path: a ``RetrievalServer`` serving the RALM
   index's ``LocalRetriever`` from a thread (its own CUDA stream) on
   loopback, ``ExternalRetriever`` connected to it, Dec-S at batch 64 and
   interval 8 through ``TikTokDecoder`` and through ``RalmDecoder``: tok/s
   and the requests in flight (2 and 1), the last answer equal to the same
   search in process.
8. Disaggregated serving (``disagg_phase``): both indexes saved to npz
   files in a temporary directory and four engine processes started at
   once (spawn; each loads its index and captures its graphs before it
   listens).  The flagship as a vector-search service: an
   ``IndexScanner`` on the card here feeding an ``IndexServer`` whose PQ
   scans run in an engine process — the card engine (the flagship's
   search config) and the native CPU engine (f32 LUTs) — in latency and
   tik-tok mode at b=128 (65 batches) and b=1 (200); every answer held
   to the in-process ``IVFSearcher.search`` (card: rtol 1e-5, R@10 equal;
   CPU: the f32-LUT searcher at rtol 1e-4, R@10 within 0.005).  The RALM
   topology: two Dec-S workers (threads, each on its own CUDA stream),
   batch 64, interval 1, behind ``NativeCoordinator`` and then
   ``RetrieveCoordinator`` in front of two engine processes on the card;
   ``RalmDecoder`` and ``TikTokDecoder``, 32 timed steps each; tok/s, the
   requests in flight (1 and 2), every engine serving under each
   coordinator, each worker's last answer equal to the search in process
   up to ties.  Last, the relay's cost a round trip of a RALM frame,
   direct and through each coordinator.  Then ``native.run_adc_bench`` (4M rows,
   m 16, one core: scalar, unrolled and soa Mrows/s; ``g++`` failing
   fails the phase) beside the CPU engine's rate: the rows its b=128
   batches' probed lists hold over its p50 a batch.
9. The index build on the card (``build_phase``): ``benchmarks/
   bench_large.py``'s configuration with ``--hard --n-clusters 262144
   --opq --balance 1.30 --balance-deadband 1.25 --balance-iters 12``, cut
   in depth to 16·2^20 rows: the hard-mode corpus (d 128, seed 42) drawn
   on the card → ``build_ivfpq_device`` (OPQ16, IVF65536, PQ16, 2M
   training rows, 8 k-means and 10 PQ iterations, 12 balanced ones, chunks
   of 4·2^20, blocks of 4096; tiled at the seg ``auto_seg`` picks for the
   expected lengths, both twins; stage seconds, peak memory, stragglers;
   every list within the cap or counted as stragglers) →
   ``compute_ground_truth_streamed`` (256 independent queries, k 100) →
   the captured ``ivfpq_search`` at nprobe 1/16/32/64 with every window of
   the probed lists and f32 LUTs, the launch counts set to 0 just before
   and read just after: equal to the ``backend="xla"`` oracle up to ties
   and within 0.002 R@10, R@10 not falling with nprobe and rising by more
   than 0.1 from nprobe 1 to 16; at ``auto_windows``' budget, R@10, b=128
   QPS and b=1 ms with f32 and packed-bf16 LUTs; ``adc_scan_tiles`` held
   against its plain version at the build's tile width; the flat twin
   retiled to the other tile width (answers equal up to ties, a fresh
   ``graphs``); the quantizers exported as ``TrainedQuantizers``,
   ``populate_on_disk_device`` over 4·2^20 rows → ``load_ondisk`` →
   ``HostStreamedSearcher``, against ``build_ivfpq_device(quantizers=)``
   over the same rows (list lengths and ids per list equal, a b=128 batch
   equal up to ties); ``ralm_device_bench.run --streamed --hard --balance
   1.3`` (Dec-S over 2^20 rows, IVF4096) with the fused retrievals equal
   to an eager ``DeviceRetriever`` search up to ties.
10. The mesh tier (``mesh_phase``), every position on this card (an
   explicit virtual mesh: its times are the mesh program's cost over the
   single-device search, not scaling; the line says
   ``mesh_distinct_cards``): the flagship index sharded by ``shard_index``
   (tiled over lists 2 and 4 and data 2 × lists 2; flat over lists 4 for
   ``backend="seg"`` and ``"pallas"``), the 256 recall queries through each
   with f32 and packed-bf16 LUTs, equal to ``IVFSearcher.search`` up to ties
   at the same R@10, the route's kernel launching, b=128 and b=1 times
   captured and eager beside the single-device search's;
   ``build_ivfpq_device_sharded`` at the flagship's configuration over its
   1M rows (4 shards, tiled), every id and list once, searched equal to the
   xla oracle over the same lists up to ties; tensor-parallel decode of
   Dec-S, EncDec-S and Llama-S at dp 2 × tp 2 (f32 against the unsharded
   step, bf16 against the unsharded bf16 step within ``BF16_REL``, ms a
   step, launches and busy share beside the unsharded step's); the
   multi-chip RAG step: ``RalmDecoder`` and ``TikTokDecoder`` on Dec-S with
   tensor-parallel parameters over a ``MeshRetriever`` (dp × tp × lists, 8
   positions), the last fused retrieval equal to ``IVFSearcher.search``,
   tok/s beside the unsharded loops'; ``entry.dryrun_multichip(8)``.
11. The retrieval-quality path (``ir_phase``, ``rag_phase``):
   ``benchmarks/ir_quality.py``'s matrix at its defaults, its corpus
   (``write_beir_dataset``: 100k docs, 300 test and 1500 train queries,
   seed 0) written by a child process started with the smoke, read back
   through ``GenericDataLoader``; with the launch counts set to 0 just
   before and read just after: bm25, dense_hash (``HashingEncoder(256)``
   exact on the card), the ``DualEncoder`` (vocab 32768, dim 256, emb
   192, max_len 48) trained 4000 steps at batch 128 and lr 3e-3 then 2
   rounds of mining on the card (the IVF-PQ branch: IVF1024, PQ16, the
   tiled kernel) and 2500 hard-negative steps at lr 1.5e-3 (pairs capped
   at 200k), dense_trained, ivfpq_trained (IVF1562, PQ16, nprobe 32),
   sparse, MaxSim rerank of dense_trained over the trained token table:
   NDCG@10, MAP@100, R@100 and seconds each.  Held: the first 20 fit steps
   on the card against the CPU's from the same parameters (1e-3
   relative); dense_trained on the card against the CPU (ties, rtol
   1e-5); ivfpq_trained's index with f32 LUTs against the xla oracle up
   to ties, its packed-bf16 R@10 within 0.01 of the oracle's; the tiled
   kernel against its plain version at the IR index's shape.  The RAG
   leg: the corpus split (512-char chunks) into an IVF-PQ ``VectorStore``
   (the ``HashingEncoder``), ``AdvancedRAG`` (30 retrieved, MaxSim rerank
   to 5, a Dec-S ``DecoderReader`` at full width, random weights, 32 new
   tokens) answering 32 test queries, counts set to 0 just before and
   read just after; the store held to the xla oracle as above, the
   reader's captured tokens to eager ones for 4 prompts (equal), and a
   ``Seq2SeqReranker`` over ivfpq_trained's top 100 for 32 queries, the
   card's scores within 1e-4 of the CPU's from the same weights.
12. Print the kernels line, the main-path line, the stages line, the
   routes line, the kernel-study line, the ralm line, the tiktok line,
   the disagg line, the adc_bench line, the build line, the mesh line,
   the ir line, the rag line and the result line.

Every search and every model step runs as a replay of a captured CUDA graph
(``chamjax_torch/utils/graphs.py``), the default; each is also run eagerly
under ``graphs.disable_capture()``, and the two are held equal: search
results bit-equal (or, where the card gives otherwise, reported and held to
rtol 1e-5 and ties), RALM tokens and fused retrievals equal over the first
16 steps from one reset, and the cache-full check raising at the same step.
The existing keys of each line are the captured run's; ``_eager`` keys are
the eager run's (the RALM eager leg times 32 steps).  A capture in a timed
RALM step fails its sync check (a capture synchronises the card).

Needs the card, the CUDA toolkit (``nvcc``) and the rest of this repository
beside the script.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import socket
import subprocess
import sys
import threading
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


def eager_unless(captured: bool):
    """A context: captured graphs (the default), or eager under
    ``graphs.disable_capture()``."""
    from chamjax_torch.utils import graphs
    return contextlib.nullcontext() if captured else graphs.disable_capture()


def suffixed(d: dict, suffix: str) -> dict:
    return {f"{k}{suffix}": v for k, v in d.items()}


def captured_vs_eager(name, got, want) -> bool:
    """Search results ``(dists, ids)`` captured against eager: bit-equal,
    or else (reported) within rtol 1e-5 with ids equal up to ties.
    Returns whether they were bit-equal."""
    import numpy as np
    bit = all(np.array_equal(a, b) for a, b in zip(got, want))
    if not bit:
        log(f"{name}: captured and eager results are not bit-equal")
        check_same_up_to_ties(f"{name}: captured vs eager", *got, *want,
                              rtol=1e-5)
    return bit


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


def hold(name, fn, ref, args, kw, ref_kw, bound, library=None):
    """Launch ``fn``, synchronise, compare with the plain version ``ref`` on
    the same inputs (``check_scan``), and time both (``device_ms``).
    ``bound(out)`` gives (ms, by); ``library(out)``, where given, the
    library call's ms (``library_scan``).  Returns the measurement, or
    raises."""
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
    library_ms = library(got) if library is not None else None
    log(f"{name}: ok, max_abs_err={err:.3g} kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), library "
        f"{library_ms} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def scan_rows(lens, width):
    """(window, column) of every valid row of a scan output: columns below
    the window's length."""
    import torch
    valid = (torch.arange(width, device=lens.device)[None, :]
             < lens.long()[:, None])
    return valid.nonzero(as_tuple=True)


def library_scan(name, got, w, c, codes, lut_row, luts, lut_bf16):
    """The one PyTorch call nearest to an ADC scan, timed on the scan's
    valid rows: ``embedding_bag(idx, lut.view(-1, 1), mode="sum")`` over
    the flat indices ``(lut_row·m + j)·256 + code`` of each row's ``m``
    codes (``codes`` (n, m) u8, ``lut_row`` (n,)), a bag a row; packed LUTs
    are decoded to f32 first.  The indices and the table are built outside
    the timed call (in the library's favour).  Its sums are held against
    the kernel's output at those rows (rtol 1e-5).  Returns its ms."""
    import torch
    import torch.nn.functional as F
    m = codes.shape[1]
    table = luts.contiguous().view(torch.bfloat16).float() if lut_bf16 \
        else luts
    weight = table.reshape(-1, 1)
    idx = ((lut_row.long()[:, None] * m
            + torch.arange(m, device=codes.device)[None, :]) * 256
           + codes.long())

    def call():
        return F.embedding_bag(idx, weight, mode="sum")

    out = call()[:, 0]
    if not torch.allclose(out, got[w, c], rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{name}: embedding_bag disagrees with the "
                             f"kernel")
    return device_ms(call)


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
    from chamjax_torch.searcher import ivfpq_search
    return time_batches(lambda q: ivfpq_search(dev_index, q, **kw), xq_dev)


def time_batches(search, xq_dev, small: int = 1):
    """``time_search`` for any ``search(q)``: 65 b=128 batches and 200
    batches of ``small`` queries."""
    import torch
    n_b = xq_dev.shape[0] // BATCH
    batches = [xq_dev[i * BATCH:(i + 1) * BATCH] for i in range(n_b)]
    singles = [xq_dev[i * small:(i + 1) * small] for i in range(200)]
    res = {}
    for name, qs, warm in (("b128", batches, 3), (f"b{small}", singles, 5)):
        for q in qs[:warm]:
            search(q)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for q in qs:
            search(q)
        res[f"host_{name}"] = (time.perf_counter() - t0) * 1e3 / len(qs)
        b.record()
        b.synchronize()
        res[f"ms_{name}"] = a.elapsed_time(b) / len(qs)
    return res


def tiles_on_queries(name, s, q, nprobe, library: bool = False):
    """``adc_scan_tiles`` on the windows that one search of the queries
    ``q`` by the tiled ``IVFSearcher`` ``s`` scans (its seg, window budget
    and LUT type; windows in probe order), held against its plain version
    and timed beside it (``hold``), with its bound.  Returns the
    measurement and the stage inputs (``qr``, ``list_ids``, ``luts``, the
    kernel's ``args`` and ``kw``)."""
    from chamjax_torch.benchmarks.bounds import tile_scan_bound
    from chamjax_torch.ops.coarse import select_probes
    from chamjax_torch.ops.lut import build_luts
    from chamjax_torch.ops.scan_seg import expand_windows, prepare_luts
    from chamjax_torch.ops.scan_seg_block import (adc_scan_tiles,
                                                  adc_scan_tiles_reference)
    from chamjax_torch.searcher import _rotate
    dv, seg, lut_bf16 = s.dev, s.seg, s.scfg.lut_bf16
    qr = _rotate(dv, q)
    list_ids, _ = select_probes(qr, dv.centroids, nprobe)
    luts = build_luts(qr, dv.centroids, dv.codebooks, list_ids)
    starts, lens, probe, _ = expand_windows(list_ids, dv.list_start,
                                            dv.list_len, windows=s.windows,
                                            seg=seg)
    luts_k, lut_idx = prepare_luts(luts, probe, lut_bf16=lut_bf16)
    args = (dv.codes_tiled, (starts // seg).reshape(-1).contiguous(),
            lens.reshape(-1).contiguous(), lut_idx, luts_k)
    kw = dict(seg=seg, group=GROUP, lut_bf16=lut_bf16)

    def lib(out):
        w, c = scan_rows(args[2], seg)
        return library_scan(name, out, w, c,
                            dv.codes_tiled[args[1].long()[w], :, c],
                            args[3][w], args[4], lut_bf16)

    measured = hold(name, adc_scan_tiles, adc_scan_tiles_reference, args, kw,
                    dict(seg=seg, lut_bf16=lut_bf16),
                    lambda o: tile_scan_bound(*args, o.numel() * 4),
                    library=lib if library else None)
    measured["windows"] = int(args[1].numel())
    return dict(measured=measured, qr=qr, list_ids=list_ids, luts=luts,
                args=args, kw=kw)


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
    from chamjax_torch.ops.scan_seg_block import adc_scan_tiles
    from chamjax_torch.ops.topk import select_topk
    from chamjax_torch.searcher import IVFSearcher, _rotate
    from chamjax_torch.utils import cuda_lib, graphs

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
    runs = []
    for captured in (True, False):
        with eager_unless(captured):
            cuda_lib.launch_counts.clear()
            outs = [s.search(xq[i:i + BATCH]) for i in range(0, N_GT, BATCH)]
            launches = dict(cuda_lib.launch_counts)
            singles = [s.search(xq[i:i + 1]) for i in range(8)]
        runs.append((tuple(np.concatenate([o[j] for o in outs])
                           for j in (0, 1)),
                     tuple(np.concatenate([o[j] for o in singles])
                           for j in (0, 1)), launches))
    (d_s, i_s), b1, launches = runs[0]
    launches_eager = runs[1][2]
    equal = dict(b128=captured_vs_eager("main path b=128", runs[0][0],
                                        runs[1][0]),
                 b1=captured_vs_eager("main path b=1", b1, runs[1][1]))
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
    scan = tiles_on_queries("adc_scan_tiles[main path]", s, q, NPROBE,
                            library=True)
    qr, list_ids, luts = scan["qr"], scan["list_ids"], scan["luts"]
    args, kw_k = scan["args"], scan["kw"]
    main_kernel = scan["measured"]

    # stage times of one b=128 search (CUDA events, median of 30)
    flat = adc_scan_tiles(*args, **kw_k).reshape(BATCH, -1)
    stages = {
        "rotate": time_ms(lambda: _rotate(dv, q)),
        "coarse": time_ms(lambda: select_probes(qr, dv.centroids, NPROBE)),
        "luts": time_ms(lambda: build_luts(qr, dv.centroids, dv.codebooks,
                                           list_ids)),
        "windows": time_ms(lambda: prepare_luts(luts, expand_windows(
            list_ids, dv.list_start, dv.list_len, windows=s.windows,
            seg=SEG)[2], lut_bf16=True)),
        "scan": time_ms(lambda: adc_scan_tiles(*args, **kw_k)),
        "topk": time_ms(lambda: select_topk(flat, K)),
    }

    kw = dict(nprobe=NPROBE, k=K, windows=s.windows, seg=SEG, group=GROUP,
              lut_bf16=True, backend="seg")
    xq_dev = torch.as_tensor(ds.xq[N_GT:]).to(dev)
    ts = time_search(s.dev, kw, xq_dev)
    ms_b128, ms_b1 = ts["ms_b128"], ts["ms_b1"]
    host_b128, host_b1 = ts["host_b128"], ts["host_b1"]
    with graphs.disable_capture():
        te = time_search(s.dev, kw, xq_dev)
    t0 = time.perf_counter()
    efficiency = efficiency_block(s.dev, kw, xq_dev, BATCH * 1e3 / ms_b128)
    diagnosis = {
        name: diagnose(f"main path {name}", searcher, xq, gt, res)
        for name, searcher, res in (("bf16", s, (d_s, i_s)),
                                    ("f32", s_f, res_f))}
    t_extra = time.perf_counter() - t0
    ctx = dict(idx=idx, ds=ds, gt=gt, cfg=cfg, scfg=scfg, r10_xla=r10_xla,
               tiled_bf16=(d_s, i_s), tiled_f32=res_f, xq_dev=xq_dev,
               main_search=(s.dev, kw), searcher=s, searcher_f32=s_f)
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
            diagnosis_bf16=diagnosis["bf16"], diagnosis_f32=diagnosis["f32"],
            efficiency_and_diagnosis_s=t_extra,
            **efficiency,
            # host time to enqueue one search; near the device time above
            # means the card waits on the host
            host_enqueue_ms_b128=host_b128, host_enqueue_ms_b1=host_b1,
            qps_b128_eager=BATCH * 1e3 / te["ms_b128"],
            ms_per_batch_b128_eager=te["ms_b128"],
            ms_per_query_b1_eager=te["ms_b1"],
            host_enqueue_ms_b128_eager=te["host_b128"],
            host_enqueue_ms_b1_eager=te["host_b1"],
            launches=launches, launches_eager=launches_eager,
            captured_bit_equal_eager=equal, graphs=len(s.dev.graphs),
            dataset_s=t_data, build_s=t_build, ground_truth_s=t_gt,
            max_list_len=int(idx.list_len.max())))


def diagnose(name, s, xq, gt, res):
    """``recall_diagnosis`` of one search of the recall queries by the
    ``IVFSearcher`` ``s`` (its window budget, seg, group and coarse
    shortlist), over its top 10: the five fractions, held to sum to 1
    within 1e-9 and ``found`` to equal the search's intersection R@10
    exactly, and that R@10 beside them."""
    from chamjax_torch.eval import recall_at_k, recall_diagnosis
    from chamjax_torch.searcher import resolve_coarse_cand
    d, i = res
    diag = recall_diagnosis(
        s.dev, xq, gt, i[:, :10], d[:, :10], nprobe=s.scfg.nprobe,
        windows=s.windows, seg=s.seg, group=s.group, at=10,
        coarse_approx=s.scfg.coarse_approx,
        coarse_cand=resolve_coarse_cand(s.scfg.coarse_cand, s.cfg.nlist,
                                        s.scfg.nprobe))
    r10 = recall_at_k(i, gt, 10, mode="intersection")
    if abs(sum(diag.values()) - 1.0) > 1e-9:
        raise AssertionError(f"{name}: diagnosis does not sum to 1: {diag}")
    if diag["found"] != r10:
        raise AssertionError(f"{name}: found {diag['found']} is not the "
                             f"intersection R@10 {r10}")
    log(f"{name} diagnosis: {diag}")
    return dict(diag, recall_at_10_intersection=r10)


def efficiency_block(dev_index, kw, xq_dev, qps):
    """``card_efficiency`` at the b=128 QPS with duty 1.0 (``bench.py``'s
    accounting), at the card's power limit from ``nvidia-smi``; and the
    host's RAPL power over 20 passes of the b=128 loop (``None`` where the
    host exposes no RAPL counters)."""
    import torch
    from chamjax_torch.searcher import ivfpq_search
    from chamjax_torch.utils.energy import RaplMeter, card_efficiency
    eff = card_efficiency(qps, duty=1.0)
    batches = [xq_dev[i * BATCH:(i + 1) * BATCH]
               for i in range(xq_dev.shape[0] // BATCH)]
    torch.cuda.synchronize()
    with RaplMeter() as rapl:
        for _ in range(20):
            for q in batches:
                ivfpq_search(dev_index, q, **kw)
        torch.cuda.synchronize()
    out = dict(qps_per_watt=eff["qps_per_watt"],
               mj_per_query=eff["mj_per_query"],
               assumed_watts=eff["assumed_watts"], duty=1.0,
               host_watts=rapl.watts, host_rapl_s=rapl.seconds,
               host_rapl_domains=len(rapl.domains))
    log(f"efficiency: {out}")
    return out


STAGE_BATCHES = (BATCH, 1)
STAGE_OPTIONS = dict(lut_bf16=True, coarse_cand=4 * NPROBE, lane_l1=True,
                     select_l1=4 * K)


def stages_phase(dev, ctx):
    """The stage profile (``benchmarks/profiling_stages.profile_stages``)
    over the flagship's ``DeviceIVF`` at b=128 and b=1, every option on
    (packed LUTs, the two-stage coarse scan at 4·nprobe, lane L1, select
    L1 4·k), with the launch counts set to 0 just before and read just
    after.  Holds every time finite and > 0, and the timed scans' outputs
    against the plain version (f32 LUTs rtol 1e-5, packed LUTs one bf16
    ulp).  Returns the stages line's entries and the launches."""
    import math
    from chamjax_torch.benchmarks.profiling_stages import (
        implied_efficiencies, profile_stages)
    from chamjax_torch.ops.scan_seg import pack_luts_bf16
    from chamjax_torch.ops.scan_seg_multi import (
        adc_scan_segments_multi_reference as plain)
    from chamjax_torch.utils import cuda_lib
    dv, xq = ctx["searcher"].dev, ctx["ds"].xq[N_GT:]
    out = {}
    t0 = time.perf_counter()
    cuda_lib.launch_counts.clear()
    runs = {b: profile_stages(dv, xq, batch=b, nprobe=NPROBE, k=K, seg=SEG,
                              group=GROUP, **STAGE_OPTIONS)
            for b in STAGE_BATCHES}
    launches = dict(cuda_lib.launch_counts)
    if launches.get("adc_scan_segments_multi", 0) < 1:
        raise AssertionError(f"the stage profile did not launch "
                             f"adc_scan_segments_multi: {launches}")
    for b, (times, t) in runs.items():
        bad = {k: v for k, v in times.items()
               if not (math.isfinite(v) and v > 0)}
        if bad:
            raise AssertionError(f"stages b={b}: {bad}")
        args = (dv.codes_t, t["starts"], t["lens"], t["lut_idx"])
        for key, got, luts, bf16 in (
                ("dists", t["dists"], t["luts_k"], False),
                ("dists_bf16", t["dists_bf16"], pack_luts_bf16(t["luts_k"]),
                 True)):
            want = plain(*args, luts, seg=SEG, lut_bf16=bf16).reshape(b, -1)
            ok, err = check_scan(got, want, dist_bf16=bf16)
            if not ok:
                raise AssertionError(f"stages b={b}: the {key} scan "
                                     f"disagrees with its plain version "
                                     f"(max abs err {err})")
        coarse = times["coarse2_ms" if STAGE_OPTIONS["coarse_cand"]
                       else "coarse_ms"]
        scan = times["scan_bf16_ms" if STAGE_OPTIONS["lut_bf16"]
                     else "scan_ms"]
        total = (coarse + times["lut_ms"] + times["expand_ms"] + scan
                 + times["topk_ms"])
        nlist, d = dv.centroids.shape
        out[f"b{b}"] = dict(
            times, windows=t["W"], sum_of_stages_ms=total,
            sum_over_full=total / times["full_ms"],
            implied_efficiencies=implied_efficiencies(
                times, batch=b, nlist=nlist, d=d, windows=t["W"], seg=SEG))
        log(f"stages b={b}: {out[f'b{b}']}")
    return dict(line=dict(out, options=STAGE_OPTIONS,
                          phase_s=time.perf_counter() - t0),
                launches=launches)


ADC_BENCH_ROWS, ADC_BENCH_M = 1 << 22, 16


def adc_bench_phase(ctx, disagg):
    """The host's ADC scan rate (``native.run_adc_bench``, one core) beside
    the CPU engine's rate in the disagg phase: the rows that the probed
    lists of its b=128 batches hold over its p50 a batch."""
    import os
    from chamjax_torch import native
    t0 = time.perf_counter()
    rates = native.run_adc_bench(ADC_BENCH_ROWS, ADC_BENCH_M)
    row = disagg["service"]["native"]["b128"]
    n = row["batches"] * BATCH
    rows = probed_rows(ctx["searcher"].dev, ctx["ds"].xq[:n], NPROBE, 0)
    per_batch = float(rows.sum()) / row["batches"]
    line = dict(n_rows=ADC_BENCH_ROWS, m=ADC_BENCH_M,
                mrows_per_s=rates, cpu_count=os.cpu_count(),
                cpu_engine_b128_p50_ms=row["p50_ms"],
                cpu_engine_rows_per_batch=per_batch,
                cpu_engine_mrows_per_s=per_batch / row["p50_ms"] / 1e3,
                phase_s=time.perf_counter() - t0)
    log(f"adc_bench: {line}")
    return line


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
    from chamjax_torch.utils import graphs
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
        with graphs.disable_capture():
            d_e, i_e, launches_e = run_path(name, kernel, sr.search, xq)
        bit_equal = captured_vs_eager(f"route {name}", (d, i), (d_e, i_e))
        results[name] = (d, i)
        r10 = recall_at_k(i, gt, 10)
        if abs(r10 - r10_xla) > bar:
            raise AssertionError(f"{name} R@10 {r10} vs xla oracle "
                                 f"{r10_xla} (bar {bar})")
        check_same_up_to_ties(f"{name} vs the {ref} route", d, i, *ctx[ref],
                              rtol=1e-5)
        entry = dict(recall_at_10=r10, launches=launches,
                     launches_eager=launches_e,
                     captured_bit_equal_eager=bit_equal,
                     scan_len=sr.scan_len, windows=sr.windows)
        kw = dict(nprobe=NPROBE, k=K, windows=sr.windows, seg=SEG,
                  group=sr.group, lut_bf16=sr.scfg.lut_bf16,
                  backend=sr.backend, scan_len=sr.scan_len, tile=sr.tile)
        if name != "flat_g1_f32":
            entry.update(time_search(sr.dev, kw, ctx["xq_dev"]))
            with graphs.disable_capture():
                entry.update(suffixed(time_search(sr.dev, kw, ctx["xq_dev"]),
                                      "_eager"))
            entry["qps_b128"] = BATCH * 1e3 / entry["ms_b128"]
            entry["qps_b128_eager"] = BATCH * 1e3 / entry["ms_b128_eager"]
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

            def lib(out, a=args, width=sr.scan_len):
                w, c = scan_rows(a[2], width)
                return library_scan(f"{kernel}[main path]", out, w, c,
                                    a[0][:, a[1].long()[w] + c].T, w, a[3],
                                    False)

            meas = hold(f"{kernel}[main path]", adc_scan_distances,
                     adc_scan_distances_reference, args,
                     dict(scan_len=sr.scan_len), dict(scan_len=sr.scan_len),
                     lambda o: flat_bound(
                         dv.codes_t, p_starts, p_lens, rows, luts_k,
                         width=sr.scan_len, n_idx=2,
                         out_bytes=o.numel() * 4), library=lib)
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
            def lib(out, a=args):
                w, c = scan_rows(a[2], SEG)
                return library_scan(f"{kernel}[main path]", out, w, c,
                                    a[0][:, a[1].long()[w] + c].T, a[3][w],
                                    a[4], False)

            meas = hold(f"{kernel}[main path]", fn, ref, args, kw_k,
                     dict(seg=SEG, lut_bf16=False),
                     lambda o, a=args: flat_bound(
                         *a, width=SEG, n_idx=3, out_bytes=o.numel() * 4),
                     library=lib)
        kernels[kernel] = dict(meas, path=name,
                               launches=launches.get(kernel, 0),
                               windows=int(args[1].numel()))
    # the main path timed again after the routes, so that the order of the
    # timings does not decide the comparison between layouts
    line["tiled_bf16_repeat"] = time_search(*ctx["main_search"],
                                            ctx["xq_dev"])
    with graphs.disable_capture():
        line["tiled_bf16_repeat"].update(suffixed(
            time_search(*ctx["main_search"], ctx["xq_dev"]), "_eager"))
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
                                  device=dev, gather="native")
        if st.gather_path != "native":
            raise AssertionError(f"{name}: gather {st.gather_path}")
        d, i, launches = run_path(name, kernel, st.search, xq[:N_GT])
        launches_by_kernel[kernel] = launches.get(kernel, 0)
        # the numpy gather (the fallback where the library cannot build):
        # the same results, bit for bit
        st_np = HostStreamedSearcher(idx, dc.replace(scfg, tiled=tiled),
                                     device=dev, gather="numpy")
        d_np, i_np, _ = run_path(f"{name} (numpy gather)", kernel,
                                 st_np.search, xq[:N_GT])
        if not (np.array_equal(d, d_np) and np.array_equal(i, i_np)):
            raise AssertionError(f"{name}: the native and numpy gathers "
                                 "give different results")
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
        plan_ms, gather_ms, gather_np_ms = [], [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = st._plan(batches[0])
            starts_h, lens_h = st._pull_windows(plan)
            t1 = time.perf_counter()
            host = st._gather(starts_h, lens_h, 0)
            t2 = time.perf_counter()
            st_np._gather(starts_h, lens_h, 0)
            t3 = time.perf_counter()
            plan_ms.append((t1 - t0) * 1e3)
            gather_ms.append((t2 - t1) * 1e3)
            gather_np_ms.append((t3 - t2) * 1e3)
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
            gather_path=st.gather_path,
            gather_ms=dict(native=float(np.median(gather_ms)),
                           numpy=float(np.median(gather_np_ms))),
            numpy_gather_bit_equal=True,
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
    return dict(line=line, launches=launches_by_kernel,
                gather_path={n: e["gather_path"] for n, e in line.items()})


ROOFLINE_VARIANTS = ("seg_f32", "seg_bf16", "block_f32", "block_bf16",
                     "block_bf16copy", "block_bf16nogather")
N_TRACED = 10


def variants_phase(dev):
    """Phase 2: every run_variant variant and run_block_variant against
    their plain versions at m=16, n=2^20, bW=4096, seg 512, 1024 and 2048,
    each timed beside its plain version and its bound.  Returns {kernel:
    [entry per (variant, seg)]}, or raises."""
    import torch
    from chamjax_torch.benchmarks import kernel_variants as kv
    from chamjax_torch.benchmarks.bounds import variant_bound
    args = kv.parse_args(["--n", str(1 << 20), "--seed", "3"])
    data = kv.make_data(args, dev)
    out = {"run_variant": [], "run_block_variant": []}
    for seg in (512, 1024, 2048):
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


def device_events(prof, annotation: str):
    """The CUDA events of a ``tracing.trace`` window, less the
    annotation's own device-side range: ``(kernels, copies)``, copies being
    the Memcpy and Memset events."""
    import torch
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name != annotation]
    copy = ("Memcpy", "Memset")
    return ([e for e in events if not e.name.startswith(copy)],
            [e for e in events if e.name.startswith(copy)])


def busy_us(events) -> float:
    """Length of the union of the events' device intervals, in µs."""
    total, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


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
    kernels, copies = device_events(prof, annotation)
    res = dict(window_ms=window_ms, searches=N_TRACED,
               trace_files=sorted(os.listdir(log_dir))[-1:])
    if not kernels:
        res.update(busy_share=None, reason=(
            "torch.profiler recorded no CUDA activity on this machine "
            f"({len(copies)} copies)"))
        return res
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    kernel_ms = busy_us(kernels) / 1e3
    res.update(busy_share=kernel_ms / window_ms, kernel_ms=kernel_ms,
               copy_ms=busy_us(copies) / 1e3,
               kernel_launches=len(kernels),
               host_launch_calls=host_launch_calls(prof),
               top_kernels=[dict(name=n[:160], ms=v[0], launches=v[1])
                            for n, v in top])
    return res


# the runtime calls by which the host launches work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def host_launch_calls(prof) -> dict:
    """How often the host called each launching runtime function in a
    traced window (a graph replay is one ``cudaGraphLaunch``)."""
    return {e.key: e.count for e in prof.key_averages()
            if e.key in LAUNCH_CALLS}


def study_phase(dev, card):
    """Phase 5: the kernel-study path at its full width (the JAX harness's
    defaults: a 16M x m16 slab, bW=4096, n_lut=4096): every measurement
    variant at seg 2048, each beside its production counterpart over the
    same windows, again with --same-lut, then the roofline matrix at seg
    1024 and 2048 with runlen 0 and 8.  Both harnesses hold each
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
            f"{r['ms']:.4f} ms, {r['code_gbs']:.0f} code GB/s; "
            f"{r['counterpart']} {r['counterpart_ms']:.4f} ms, variant - "
            f"counterpart {r['minus_counterpart_ms']:+.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_share']:.1%} of it); "
            f"max_abs_err {r['max_abs_err']:.3g}")
    for r in roof:
        log(f"roofline {r}")
    return dict(variants=[r for r in rows if not r["same_lut"]],
                variants_same_lut=[r for r in rows if r["same_lut"]],
                roofline=[r for r in roof if "best" not in r],
                best=roof[-1]["best"], launches=launches,
                seconds=time.perf_counter() - t0)


# The RALM serving path, through ralm_device_bench (its non-streamed leg):
# one 1M x 512 IVF4096,PQ16 balanced index shared by the presets, Dec-S and
# Llama-S at interval 1 and EncDec-S at its preset interval 8, batch 64, 8
# warmup and 128 timed steps (max_seq_len clamped to 144, as the bench does)
RALM_ARGV = ["--nb", "1000000", "--nlist", "4096", "--m", "16", "--nprobe",
             "32", "--k", "10", "--batch", "64", "--warmup", "8", "--steps",
             "128"]
RALM_RUNS = (("Dec-S,Llama-S", 1), ("EncDec-S", 8))
RALM_TRACED = 8          # steps traced after the timed ones (8 cache slots)
# bf16 on the card vs f32 on the CPU, same params and tokens: the first
# steps of the decoder families at batch 4, logits within BF16_REL of the
# f32 logits' largest magnitude (0.013-0.018 measured at these widths on
# the CPU, bf16 against f32)
PRECISION_PRESETS, PRECISION_BATCH, PRECISION_STEPS = ("Dec-S", "Llama-S"), 4, 4
BF16_REL = 0.03
RALM_EAGER_STEPS = 32    # the eager leg's timed steps (each ~40 ms)
RALM_SAME_STEPS = 16     # steps from one reset held equal both ways
CACHE_FULL_LEN = 4       # the cache-full check's cache


class QueryRecorder:
    """The retriever of the RALM loop, unchanged (``retrieve_device`` is
    passed through), keeping the last queries it was handed and what it
    answered, so a step's hidden states can be searched again."""

    def __init__(self, inner):
        self.inner = inner
        self.queries = None
        self.result = None

    def retrieve_device(self, queries, nprobe, k):
        self.queries = queries
        self.result = self.inner.retrieve_device(queries, nprobe, k)
        return self.result


def trace_steps(loop, annotation: str, ms_per_step: float) -> dict:
    """Trace ``RALM_TRACED`` more steps of ``loop``: kernel launches and
    device time a step, the busy share against ``ms_per_step``, the
    copies, the host's launching calls and its top ops a step."""
    import os
    import torch
    from chamjax_torch.utils import tracing
    torch.cuda.synchronize()
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chamjax_torch", "build", "traces")
    with tracing.trace(log_dir) as prof:
        with tracing.annotate(annotation):
            loop.multi_steps(RALM_TRACED)
            torch.cuda.synchronize()
    kernels, copies = device_events(prof, annotation)
    kernel_ms = busy_us(kernels) / 1e3 / RALM_TRACED
    host_ops = sorted((e for e in prof.key_averages()
                       if e.self_cpu_time_total > 0),
                      key=lambda e: -e.self_cpu_time_total)[:8]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / RALM_TRACED
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(
        traced_steps=RALM_TRACED,
        launches_per_step=len(kernels) / RALM_TRACED,
        top_kernels_per_step=[dict(name=n[:120], ms=v[0],
                                   launches=v[1] / RALM_TRACED)
                              for n, v in top],
        copies_per_step={n: c / RALM_TRACED for n, c in
                         collections.Counter(e.name for e in copies).items()},
        kernel_ms_per_step=kernel_ms,
        busy_share=kernel_ms / ms_per_step if kernels else None,
        host_launch_calls_per_step={
            n: c / RALM_TRACED for n, c in host_launch_calls(prof).items()},
        # host time under the profiler, which adds its own per op
        top_host_ops=[dict(name=e.key, calls_per_step=e.count / RALM_TRACED,
                           self_cpu_ms_per_step=e.self_cpu_time_total / 1e3
                           / RALM_TRACED) for e in host_ops])


def ralm_eager(loop, args, preset: str) -> dict:
    """The eager leg on the same loop, under ``disable_capture()``: warmup,
    ``RALM_EAGER_STEPS`` timed steps under the sync check, then
    ``RALM_TRACED`` traced ones.  Its keys end in ``_eager``."""
    import torch
    from chamjax_torch.benchmarks.ralm_device_bench import no_host_sync
    from chamjax_torch.utils import graphs
    with graphs.disable_capture():
        loop.reset_inference_state()
        loop.batch_inference(args.warmup)
        loop.reset_inference_state()
        with no_host_sync(torch.device("cuda", torch.cuda.current_device())):
            loop.batch_inference(RALM_EAGER_STEPS)
        ms = loop.total_wall_s / RALM_EAGER_STEPS * 1e3
        stats = loop.prof.stats(args.batch)
        traced = trace_steps(loop, f"ralm_{preset}_eager", ms)
    traced.pop("top_host_ops")
    traced.pop("top_kernels_per_step")
    return suffixed(dict(
        traced, steps=RALM_EAGER_STEPS, ms_per_step=ms,
        tok_per_s=loop.throughput_tokens_per_sec(RALM_EAGER_STEPS),
        p50_step_ms=stats["p50_step_ms"], p50_model_ms=stats["p50_model_ms"],
        p50_retriever_ms=stats["p50_retriever_ms"]), "_eager")


def ralm_same_steps(loop, preset: str) -> dict:
    """The first ``RALM_SAME_STEPS`` steps from one reset, captured and
    eager: the tokens of every step and every fused retrieval equal."""
    import torch
    runs = []
    for captured in (True, False):
        loop.reset_inference_state()
        toks, rets = [], []
        with eager_unless(captured):
            for i in range(RALM_SAME_STEPS):
                loop.single_step()
                toks.append(loop.tokens.clone())
                if i % loop.interval == 0:
                    rets.append((loop.last_result.ids.clone(),
                                 loop.last_result.dists.clone()))
        runs.append((toks, rets))
    (tc, rc), (te, re_) = runs
    tokens_equal = all(torch.equal(a, b) for a, b in zip(tc, te))
    retrievals_equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                           for a, b in zip(rc, re_))
    if not (tokens_equal and retrievals_equal):
        raise AssertionError(
            f"ralm {preset}: captured and eager steps differ from one reset "
            f"(tokens equal {tokens_equal}, retrievals equal "
            f"{retrievals_equal})")
    return dict(same_steps=RALM_SAME_STEPS, retrievals_compared=len(rc),
                captured_tokens_equal_eager=True,
                captured_retrievals_equal_eager=True)


def ralm_inspect(rec, args, preset, interval, loop):
    """After a preset's timed steps: trace ``RALM_TRACED`` more steps
    (``trace_steps``), search the last step's hidden states again with
    ``retrieve_device`` and ``IVFSearcher.search`` (both equal to the fused
    result up to ties), hold ``adc_scan_tiles`` on that step's windows
    against its plain version, then the eager leg (``ralm_eager``) and the
    first steps both ways (``ralm_same_steps``)."""
    import numpy as np
    ms_per_step = loop.total_wall_s / args.steps * 1e3
    traced = trace_steps(loop, f"ralm_{preset}_{RALM_TRACED}_steps",
                         ms_per_step)
    q, fused = rec.queries, rec.result
    s = rec.inner.searcher
    again = rec.inner.retrieve_device(q, args.nprobe, args.k)
    d_s, i_s = s.search(q.cpu().numpy(), nprobe=args.nprobe, k=args.k)
    for name, res in (("fused retrieval", fused),
                      ("retrieve_device", again)):
        check_same_up_to_ties(
            f"{preset}: {name} vs IVFSearcher.search",
            res.dists.cpu().numpy(), res.ids.cpu().numpy().astype(np.int64),
            d_s, i_s, rtol=1e-5)
    scan = tiles_on_queries(f"adc_scan_tiles[ralm {preset}]", s, q,
                            args.nprobe)
    eager = ralm_eager(loop, args, preset)
    same = ralm_same_steps(loop, preset)
    # a CUDA graph's kernels, as the profiler sees a replay, against the
    # same step's kernels run eagerly
    traced["profiler_sees_graph_kernels"] = (
        traced["launches_per_step"]
        >= 0.5 * eager["launches_per_step_eager"])
    log(f"ralm {preset} interval {interval}: {traced}; {eager}; {same}; "
        f"fused retrieval equals IVFSearcher.search up to ties")
    return dict(traced, **eager, **same, fused_equals_searcher=True,
                queries=list(q.shape), scan=scan["measured"],
                graphs=len(loop.cache.graphs))


def ralm_cache_full(dev, rec, argv) -> dict:
    """Each preset with a ``CACHE_FULL_LEN``-position cache (batch 64, full
    width): the step after the cache is full raises ``IndexError``, at the
    same step captured and eager."""
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    out = {}
    for presets, interval in RALM_RUNS:
        args = bench.parse_args(argv + ["--presets", presets, "--interval",
                                        str(interval)])
        for name, cfg in bench.model_configs(args).items():
            cfg = dataclasses.replace(cfg, max_seq_len=CACHE_FULL_LEN)
            params = bench.init_params(cfg, 0, dev)
            raised_at = {}
            for captured in (True, False):
                loop = bench.make_loop(cfg, params, rec, args, interval)
                with eager_unless(captured):
                    for step in range(CACHE_FULL_LEN + 1):
                        try:
                            loop.single_step()
                        except IndexError:
                            raised_at[captured] = step
                            break
            if raised_at != {True: CACHE_FULL_LEN, False: CACHE_FULL_LEN}:
                raise AssertionError(f"{name}: a {CACHE_FULL_LEN}-position "
                                     f"cache raised at steps {raised_at}")
            out[name] = dict(max_seq_len=CACHE_FULL_LEN,
                             raised_at_captured=raised_at[True],
                             raised_at_eager=raised_at[False])
            log(f"ralm {name}: the cache-full check raised at step "
                f"{CACHE_FULL_LEN} captured and eager")
            del params
    return out


def ralm_precision(dev, argv):
    """The first ``PRECISION_STEPS`` decode steps of each
    ``PRECISION_PRESETS`` model at batch ``PRECISION_BATCH``: bf16 on the
    card against the same parameters in f32 on the CPU, on the same seeded
    tokens.  Returns the largest logit gap a step over the f32 logits'
    largest magnitude, or raises past ``BF16_REL``."""
    import numpy as np
    import torch
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    from chamjax_torch.serving.ralm import step_fns
    cfgs = bench.model_configs(bench.parse_args(
        argv + ["--presets", ",".join(PRECISION_PRESETS)]))
    out = {}
    for name, cfg in cfgs.items():
        f32 = dataclasses.replace(cfg, dtype="float32")
        card = bench.init_params(cfg, 0, dev)
        ref = bench.init_params(f32, 0, "cpu")
        ref.load_state_dict(card.state_dict())      # bf16 → f32: exact
        step, new_cache = step_fns(cfg)
        toks = np.random.default_rng(5).integers(
            0, cfg.vocab_size, (PRECISION_STEPS, PRECISION_BATCH)).astype(
                np.int32)
        c_card = new_cache(cfg, PRECISION_BATCH, device=dev)
        c_ref = new_cache(f32, PRECISION_BATCH, device="cpu")
        errs = []
        for t in toks:
            lg, _, c_card = step(card, torch.from_numpy(t).to(dev), c_card)
            lr, _, c_ref = step(ref, torch.from_numpy(t), c_ref)
            lg = lg.float().cpu()
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"{name}: non-finite bf16 logits")
            errs.append(float((lg - lr).abs().max() / lr.abs().max()))
        log(f"ralm precision {name}: bf16 card vs f32 CPU, rel err a step "
            f"{errs} (bar {BF16_REL})")
        if max(errs) > BF16_REL:
            raise AssertionError(f"{name}: bf16 on the card vs f32 on the "
                                 f"CPU {max(errs)} > {BF16_REL}")
        out[name] = dict(rel_err=errs, bar=BF16_REL, batch=PRECISION_BATCH)
        del card, ref
    return out


def ralm_phase(dev, argv=RALM_ARGV, runs=RALM_RUNS):
    """Phase 6: the RALM serving path.  One index for every preset, then
    ``ralm_device_bench.run`` per (presets, interval): its timed steps run
    under ``set_sync_debug_mode("error")`` with the launch counts set to 0
    just before and read just after (``adc_scan_tiles`` must have
    launched), then ``ralm_inspect``; last ``ralm_precision``."""
    import functools
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    first = bench.parse_args(argv + ["--presets", runs[0][0]])
    d = next(iter(bench.model_configs(first).values())).embed_dim
    t0 = time.perf_counter()
    rec = QueryRecorder(bench.build_retriever(first, d, dev))
    build_s = time.perf_counter() - t0
    s = rec.inner.searcher
    log(f"ralm index built in {build_s:.1f} s: seg {s.seg}, windows "
        f"{s.windows}, max list {int(s.packed.list_len.max())}")
    rows = []
    for presets, interval in runs:
        args = bench.parse_args(argv + ["--presets", presets, "--interval",
                                        str(interval)])
        for row in bench.run(args, dev, retriever=rec,
                             inspect=functools.partial(ralm_inspect, rec,
                                                       args)):
            if row["launches_adc_scan_tiles"] < 1:
                raise AssertionError(f"ralm {row['preset']}: the timed steps "
                                     f"did not launch adc_scan_tiles")
            if not row["no_host_sync_checked"]:
                raise AssertionError("ralm: the timed steps ran unchecked "
                                     "for host syncs")
            log(f"ralm row: {row}")
            rows.append(row)
    return dict(rows=rows, precision=ralm_precision(dev, argv),
                cache_full=ralm_cache_full(dev, rec, argv), rec=rec,
                index=dict(build_s=build_s, seg=s.seg, windows=s.windows,
                           nlist=s.cfg.nlist, m=s.cfg.m, dim=s.cfg.dim))


# Tik-tok: Dec-S at interval 1 and EncDec-S at 8 on the fused path, Dec-S at
# interval 8 on the host path, batch 64 a state, over the RALM index
TIKTOK_FUSED = (("Dec-S", 1), ("EncDec-S", 8))
TIKTOK_HOST = ("Dec-S", 8)
TIKTOK_STEPS = 32
HOST = "127.0.0.1"


def tiktok_loops(preset, interval, argv, dev):
    """The preset's config (the RALM phase's clamp), its random weights
    (seed 0) and the (tik-tok, sequential) loop classes of its family."""
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    from chamjax_torch.serving import (RalmDecoder, RalmEncoderDecoder,
                                       TikTokDecoder, TikTokEncoderDecoder)
    args = bench.parse_args(argv + ["--presets", preset, "--interval",
                                    str(interval)])
    cfg = bench.model_configs(args)[preset]
    params = bench.init_params(cfg, 0, dev)
    if cfg.model_type == "encoder-decoder":
        return args, cfg, params, TikTokEncoderDecoder, RalmEncoderDecoder
    return args, cfg, (params,), TikTokDecoder, RalmDecoder


def tiktok_fused(dev, retriever, argv=RALM_ARGV) -> dict:
    """Tik-tok on the fused path, captured: warmup, reset, the two states
    seeded with different first tokens, ``TIKTOK_STEPS`` timed steps; then
    a sequential loop from each state's tokens (warmup, reset, the same
    timed steps), whose tokens and last retrieval must equal the state's."""
    import numpy as np
    import torch
    from chamjax_torch.utils import cuda_lib
    out = {}
    for preset, interval in TIKTOK_FUSED:
        args, cfg, ps, tiktok, sequential = tiktok_loops(preset, interval,
                                                         argv, dev)
        kw = dict(retrieval_interval=interval, nprobe=args.nprobe, k=args.k)
        rng = np.random.default_rng(interval)
        seeds = {name: torch.from_numpy(rng.integers(
            1, cfg.vocab_size, args.batch).astype(np.int32)).to(dev)
            for name in ("tik", "tok")}
        tt = tiktok(*ps, cfg, retriever, args.batch, **kw)
        tt.batch_inference(args.warmup)
        tt.reset_inference_state()
        for name, seed in seeds.items():
            tt.states[name].tokens.copy_(seed)
        cuda_lib.launch_counts.clear()
        tt.batch_inference(TIKTOK_STEPS)
        launches = cuda_lib.launch_counts["adc_scan_tiles"]
        row = dict(interval=interval, batch_per_state=args.batch,
                   steps=TIKTOK_STEPS, launches_adc_scan_tiles=launches,
                   tok_per_s=tt.throughput_tokens_per_sec(TIKTOK_STEPS),
                   wall_s=tt.prof.time_step[-1])
        if launches < 1:
            raise AssertionError(f"tik-tok {preset} did not launch "
                                 "adc_scan_tiles")
        for name, seed in seeds.items():
            seq = sequential(*ps, cfg, retriever, args.batch, **kw)
            seq.batch_inference(args.warmup)
            seq.reset_inference_state()
            seq.tokens.copy_(seed)
            seq.batch_inference(TIKTOK_STEPS)
            st = tt.states[name]
            same = (torch.equal(st.tokens, seq.tokens)
                    and torch.equal(st.last_result.ids, seq.last_result.ids)
                    and torch.equal(st.last_result.dists,
                                    seq.last_result.dists))
            if not same:
                raise AssertionError(f"tik-tok {preset}: state {name} "
                                     "differs from its sequential twin")
            row[f"tok_per_s_sequential_{name}"] = \
                seq.throughput_tokens_per_sec(TIKTOK_STEPS)
        row["states_equal_sequential"] = True
        log(f"tiktok fused {preset}: {row}")
        out[preset] = row
        del tt, seq, ps
    return out


class FlightRecorder:
    """A host retriever passed through, counting the requests in flight
    (the deepest count kept) and keeping the last query and its answer."""

    def __init__(self, inner):
        self.inner = inner
        self.sent = collections.deque()
        self.depth = self.max_depth = 0
        self.last = None

    def retrieve(self, queries, nprobe, k):
        self.retrieve_send(queries, nprobe, k)
        return self.retrieve_recv(len(queries), k)

    def retrieve_send(self, queries, nprobe, k):
        self.inner.retrieve_send(queries, nprobe, k)
        self.sent.append(queries)
        self.depth += 1
        self.max_depth = max(self.max_depth, self.depth)

    def poll(self):
        return self.inner.poll()

    def retrieve_recv(self, batch, k):
        res = self.inner.retrieve_recv(batch, k)
        self.depth -= 1
        self.last = (self.sent.popleft(), res)
        return res


def free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def tiktok_host(dev, retriever, argv=RALM_ARGV) -> dict:
    """Tik-tok's host path against a real engine: a ``RetrievalServer``
    hosting ``retriever`` from a thread (on its own CUDA stream) on
    loopback, an ``ExternalRetriever`` connected to it; Dec-S through
    ``TikTokDecoder`` and through ``RalmDecoder`` (warmup, reset,
    ``TIKTOK_STEPS`` timed steps): tok/s, the requests in flight, and the
    last answer against the same search in process."""
    import torch
    from chamjax_torch.retrieval.external import ExternalRetriever
    from chamjax_torch.retrieval.server import RetrievalServer
    from chamjax_torch.utils import cuda_lib
    preset, interval = TIKTOK_HOST
    args, cfg, ps, tiktok, sequential = tiktok_loops(preset, interval, argv,
                                                     dev)
    port = free_port()
    server = RetrievalServer(retriever, HOST, port, batch_size=args.batch,
                             dim=cfg.embed_dim, nprobe=args.nprobe)
    stream = torch.cuda.Stream(dev)
    failures = []

    def serve():
        try:
            with torch.cuda.stream(stream):
                server.start()
        except Exception as e:      # reported by the main thread
            failures.append(e)

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    client = None
    for _ in range(200):
        try:
            client = ExternalRetriever(HOST, port, args.batch, cfg.embed_dim,
                                       k=args.k, nprobe=args.nprobe)
            break
        except OSError:
            time.sleep(0.05)
    if client is None:
        raise AssertionError("the retrieval server never came up")
    out = dict(preset=preset, interval=interval, batch=args.batch,
               steps=TIKTOK_STEPS, engine="RetrievalServer on loopback, "
               "one thread, its own CUDA stream")
    try:
        for name, cls in (("tiktok", tiktok), ("sequential", sequential)):
            rec = FlightRecorder(client)
            loop = cls(*ps, cfg, rec, args.batch,
                       retrieval_interval=interval, nprobe=args.nprobe,
                       k=args.k)
            loop.batch_inference(args.warmup)
            loop.reset_inference_state()
            rec.max_depth = 0
            cuda_lib.launch_counts.clear()
            loop.batch_inference(TIKTOK_STEPS)
            launches = cuda_lib.launch_counts["adc_scan_tiles"]
            q, res = rec.last
            want = retriever.retrieve(q, args.nprobe, args.k)
            check_same_up_to_ties(f"tik-tok host path ({name}): the last "
                                  "answer vs the search in process",
                                  res.dists, res.ids, want.dists, want.ids,
                                  rtol=1e-5)
            out[name] = dict(
                tok_per_s=loop.throughput_tokens_per_sec(TIKTOK_STEPS),
                max_in_flight=rec.max_depth,
                launches_adc_scan_tiles=launches)
    finally:
        client.close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("the retrieval server's thread did not stop")
    if failures:
        raise AssertionError(f"the retrieval server failed: {failures[0]!r}")
    if (out["tiktok"]["max_in_flight"], out["sequential"]["max_in_flight"]) \
            != (2, 1):
        raise AssertionError(f"tik-tok host path: requests in flight {out}")
    log(f"tiktok host path: {out}")
    return out


# Disaggregated serving: the flagship's PQ scans in a spawned engine process
# fed by an IndexScanner here (the reference's vector-search service mode;
# the card engine and the native CPU engine), then the RALM topology (two
# engine processes on the card behind a coordinator, two Dec-S workers on
# threads of this process, each on its own CUDA stream)
SERVICE_RUNS = (("b128", BATCH, 65), ("b1", 1, 200))
DISAGG_PRESET = "Dec-S"
DISAGG_WORKERS = 2
DISAGG_ENGINES = 2
DISAGG_STEPS = 32
RELAY_FRAME = dict(batch=64, dim=512, k=10)     # a RALM request
RELAY_TRIPS = 200
WAIT_S = 300     # any socket wait or join: a hang fails the smoke


@dataclasses.dataclass
class Engine:
    name: str
    proc: object
    report: object
    port: int


def spawn_engine(name: str, path: str, **kw) -> Engine:
    """``run_engine`` on ``path`` in a process of its own (spawn: this
    process has touched the card), on a free port."""
    import multiprocessing
    from chamjax_torch.retrieval.engine import run_engine
    ctx = multiprocessing.get_context("spawn")
    report = ctx.Queue()
    port = free_port()
    proc = ctx.Process(target=run_engine, args=(path, port),
                       kwargs=dict(kw, host=HOST, report=report), name=name,
                       daemon=True)
    proc.start()
    return Engine(name, proc, report, port)


def engine_failure(e: Engine) -> str:
    import queue
    try:
        kind, out = e.report.get(timeout=5)
    except queue.Empty:
        return f"exit code {e.proc.exitcode}, no report"
    return f"{kind}: {out}"


def connect(make, engines, what: str):
    """``make()`` retried until ``what`` listens; fails at once when an
    engine process has died, else after ``WAIT_S``."""
    t0 = time.perf_counter()
    while True:
        try:
            return make()
        except OSError:
            for e in engines:
                if not e.proc.is_alive():
                    raise AssertionError(f"engine {e.name} died: "
                                         f"{engine_failure(e)}") from None
            if time.perf_counter() - t0 > WAIT_S:
                raise AssertionError(f"{what} never listened") from None
            time.sleep(0.1)


def finish_engine(e: Engine) -> dict:
    """The engine's report once it has served its connections."""
    import queue
    try:
        kind, out = e.report.get(timeout=WAIT_S)
    except queue.Empty:
        raise AssertionError(f"engine {e.name} reported nothing") from None
    e.proc.join(timeout=WAIT_S)
    if kind != "done" or e.proc.exitcode != 0:
        raise AssertionError(f"engine {e.name} failed (exit code "
                             f"{e.proc.exitcode}): {out}")
    return out


def joined(threads, what: str) -> None:
    for t in threads:
        t.join(timeout=WAIT_S)
        if t.is_alive():
            raise AssertionError(f"{what}: a thread did not stop")


def hold_answers(name, got, want, rtol: float) -> int:
    """Every answer against its reference, both lists of ``(dists, ids)``
    batches: distances close rank by rank (rtol = atol), ids equal except
    in the order of ties (a row of equal ids needs no tie check).  Returns
    the rows that are bit-equal."""
    import numpy as np
    d, i = (np.concatenate([g[j] for g in got]) for j in (0, 1))
    d_r, i_r = (np.concatenate([w[j] for w in want]) for j in (0, 1))
    if d.shape != d_r.shape or i.shape != i_r.shape:
        raise AssertionError(f"{name}: shapes {d.shape} vs {d_r.shape}")
    far = np.argwhere(~np.isclose(d, d_r, rtol=rtol, atol=rtol))
    if len(far):
        r, c = far[0]
        raise AssertionError(f"{name}: {len(far)} distances apart, first "
                             f"row {r} rank {c}: {d[r, c]} vs {d_r[r, c]}")
    rows = np.flatnonzero((i != i_r).any(axis=1))
    check_same_up_to_ties(name, d[rows], i[rows], d_r[rows], i_r[rows],
                          rtol=rtol)
    return int(((d == d_r) & (i == i_r)).all(axis=1).sum())


def service_phase(dev, ctx, engines) -> dict:
    """The vector-search service mode at the flagship: an ``IndexScanner``
    on the card here (the index's OPQ rotation, then the coarse scan)
    feeds an ``IndexServer`` whose PQ scans run in an engine process, over
    one ``ExternalRetriever`` connection each: the card engine
    (``LocalRetriever``, the flagship's search config, the tiled kernel)
    and the native CPU engine (f32 LUTs).  Latency and tik-tok mode at
    b=128 (65 batches) and b=1 (200): QPS, p50 and p95; the two modes'
    answers bit-equal; every answer held against the in-process
    ``IVFSearcher.search`` of the same queries (the card engine: the
    flagship searcher at rtol 1e-5 and R@10 equal; the CPU engine: the
    searcher with f32 LUTs at rtol 1e-4 and R@10 within 0.005)."""
    import numpy as np
    from chamjax_torch.eval import recall_at_k
    from chamjax_torch.retrieval import (ExternalRetriever, IndexScanner,
                                         IndexServer)
    idx, gt, xq = ctx["idx"], ctx["gt"], ctx["ds"].xq
    runs = {name: [xq[j * b:(j + 1) * b] for j in range(n)]
            for name, b, n in SERVICE_RUNS}
    refs = {engine: {name: [s.search(q) for q in batches]
                     for name, batches in runs.items()}
            for engine, s in (("card", ctx["searcher"]),
                              ("native", ctx["searcher_f32"]))}
    n_gt = N_GT // BATCH       # the b=128 batches with ground truth

    def r10(batches):
        return recall_at_k(np.concatenate([b[1] for b in batches[:n_gt]]),
                           gt, 10)

    scanner = IndexScanner(idx.centroids, nprobe=NPROBE,
                           coarse_cand=ctx["scfg"].coarse_cand,
                           opq_R=idx.opq_R, device=dev)
    out = {}
    for name, rtol, r10_bar in (("card", 1e-5, 0.0), ("native", 1e-4,
                                                      0.005)):
        engine = engines[name]
        client = connect(lambda: ExternalRetriever(
            HOST, engine.port, BATCH, idx.cfg.dim, K, nprobe=NPROBE,
            timeout=WAIT_S), [engine], f"the {name} engine")
        server = IndexServer(scanner, client, k=K)
        row = dict(engine=engine.name)
        try:
            for q in (runs["b128"][0], runs["b1"][0]):
                server.search(q)     # the scanner's graphs, the connection
            for run, b, n in SERVICE_RUNS:
                batches = runs[run]
                t0 = time.perf_counter()
                lat = server.search_multi_batch(batches)
                wall = time.perf_counter() - t0
                stats = server.latency_stats_ms()
                tik = server.search_multi_batch_tiktok(batches)
                qps_tik = server.throughput_qps(batches)
                lat = [(r.dists, r.ids) for r in lat]
                tik = [(r.dists, r.ids) for r in tik]
                if not all(np.array_equal(a[0], c[0])
                           and np.array_equal(a[1], c[1])
                           for a, c in zip(lat, tik)):
                    raise AssertionError(f"service {name} {run}: tik-tok "
                                         "answers differ from latency mode")
                bit_equal = hold_answers(
                    f"service {name} {run} vs the search in process", lat,
                    refs[name][run], rtol)
                row[run] = dict(batch=b, batches=n,
                                qps_latency=n * b / wall,
                                p50_ms=stats["p50"], p95_ms=stats["p95"],
                                qps_tiktok=qps_tik,
                                rows_bit_equal_in_process=bit_equal,
                                rows=n * b)
                if run == "b128":
                    row["recall_at_10"] = r10(lat)
                    row["recall_at_10_in_process"] = r10(refs[name][run])
        finally:
            client.close()
        if abs(row["recall_at_10"] - row["recall_at_10_in_process"]) \
                > r10_bar:
            raise AssertionError(f"service {name}: R@10 {row}")
        report = finish_engine(engine)
        row.update(served=report["served"], launches=report["launches"])
        if name == "card" and dev.type == "cuda" and report[
                "launches"].get("adc_scan_tiles", 0) < 1:
            raise AssertionError(f"the card engine did not launch "
                                 f"adc_scan_tiles: {report}")
        log(f"service {name}: {row}")
        out[name] = row
    out["native"]["recall_at_10_minus_card"] = (
        out["native"]["recall_at_10"] - out["card"]["recall_at_10"])
    return out


def ralm_disagg_phase(dev, retriever, engines) -> dict:
    """``benchmarks/launch_ralm.py``'s topology on one card: two Dec-S
    workers (full width, batch 64, interval 1), each a thread of this
    process on its own CUDA stream with its own ``ExternalRetriever``,
    behind a coordinator (``NativeCoordinator``, then
    ``RetrieveCoordinator``, each in a thread) in front of two engine
    processes on the card serving the RALM index.  Per coordinator and per
    worker: ``RalmDecoder``, then ``TikTokDecoder``, each ``DISAGG_STEPS``
    timed steps after the warm-up (the workers' captures one at a time,
    their timed steps together); tok/s, the requests in flight, and the
    last answer against the same search in process (``retriever``).  The
    loops are built once and keep their graphs across coordinators.  The
    coordinators stop when the workers disconnect."""
    import torch
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    from chamjax_torch.retrieval import (ExternalRetriever, NativeCoordinator,
                                         RetrieveCoordinator)
    args, cfg, ps, tiktok, sequential = tiktok_loops(DISAGG_PRESET, 1,
                                                     RALM_ARGV, dev)
    params = [ps[0]] + [bench.init_params(cfg, w, dev)
                        for w in range(1, DISAGG_WORKERS)]
    streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None
               for _ in range(DISAGG_WORKERS)]
    loops = [dict() for _ in range(DISAGG_WORKERS)]
    addrs = [(HOST, e.port) for e in engines]
    out = {}
    for coord_name, cls in (("native", NativeCoordinator),
                            ("python", RetrieveCoordinator)):
        port = free_port()
        coord = cls(HOST, port, DISAGG_WORKERS, args.batch, cfg.embed_dim,
                    args.k, engine_addrs=addrs, queries_per_client=None)
        failures = []
        capture = threading.Lock()
        together = threading.Barrier(DISAGG_WORKERS, timeout=WAIT_S)
        rows = [dict() for _ in range(DISAGG_WORKERS)]

        def run_coordinator():
            try:
                coord.start()
            except Exception as e:      # reported by the main thread
                failures.append(("the coordinator", e))

        def run_worker(w, client):
            for name, loop_cls in (("sequential", sequential),
                                   ("tiktok", tiktok)):
                rec = FlightRecorder(client)
                with capture:           # one capture at a time
                    loop = loops[w].get(name)
                    if loop is None:
                        loop = loops[w][name] = loop_cls(
                            params[w], cfg, rec, args.batch,
                            retrieval_interval=1, nprobe=args.nprobe,
                            k=args.k)
                    loop.retriever = rec
                    loop.reset_inference_state()
                    loop.batch_inference(args.warmup)
                    loop.reset_inference_state()
                rec.max_depth = 0
                together.wait()
                loop.batch_inference(DISAGG_STEPS)
                together.wait()
                rows[w][name] = dict(
                    tok_per_s=loop.throughput_tokens_per_sec(DISAGG_STEPS),
                    max_in_flight=rec.max_depth, last=rec.last)

        def worker(w):
            try:
                with torch.cuda.stream(streams[w]):
                    client = connect(lambda: ExternalRetriever(
                        HOST, port, args.batch, cfg.embed_dim, k=args.k,
                        nprobe=args.nprobe, timeout=WAIT_S), engines,
                        f"the {coord_name} coordinator")
                    try:
                        client.sync_with_coordinator()
                        run_worker(w, client)
                    finally:
                        client.close()
            except Exception as e:      # reported by the main thread
                failures.append((f"worker {w}", e))
                together.abort()

        ct = threading.Thread(target=run_coordinator, daemon=True)
        ct.start()
        workers = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(DISAGG_WORKERS)]
        for t in workers:
            t.start()
        joined(workers, f"ralm {coord_name} coordinator: the workers")
        if not failures:        # a worker that failed leaves it waiting
            joined([ct], f"ralm {coord_name} coordinator")
        if failures:
            who, e = failures[0]
            raise AssertionError(f"ralm {coord_name} coordinator: {who} "
                                 f"failed: {e!r}")
        entry = dict(answered=coord.answered_query_cnt)
        for name in ("sequential", "tiktok"):
            per = []
            for w in range(DISAGG_WORKERS):
                r = rows[w][name]
                q, res = r.pop("last")
                want = retriever.retrieve(q, args.nprobe, args.k)
                check_same_up_to_ties(
                    f"ralm {coord_name} {name} worker {w}: the last answer "
                    "vs the search in process", res.dists, res.ids,
                    want.dists, want.ids, rtol=1e-5)
                per.append(r)
            depth = {r["max_in_flight"] for r in per}
            if depth != {2 if name == "tiktok" else 1}:
                raise AssertionError(f"ralm {coord_name} {name}: requests "
                                     f"in flight {per}")
            entry[name] = dict(
                tok_per_s_total=sum(r["tok_per_s"] for r in per),
                workers=per)
        log(f"ralm disagg {coord_name}: {entry}")
        out[coord_name] = entry
    reports = [finish_engine(e) for e in engines]
    for e, rep in zip(engines, reports):
        if len(rep["served"]) != 2 or min(rep["served"]) < 1:
            raise AssertionError(f"engine {e.name} served {rep['served']} "
                                 "batches a coordinator: round robin failed")
        if dev.type == "cuda" and rep["launches"].get("adc_scan_tiles",
                                                      0) < 1:
            raise AssertionError(f"engine {e.name} did not launch "
                                 f"adc_scan_tiles: {rep}")
    out["engines"] = [dict(name=e.name, served=dict(zip(
        ("native_coordinator", "python_coordinator"), r["served"])),
        launches=r["launches"]) for e, r in zip(engines, reports)]
    out.update(preset=DISAGG_PRESET, batch=args.batch, interval=1,
               workers=DISAGG_WORKERS, steps=DISAGG_STEPS,
               warmup=args.warmup)
    return out


def relay_phase() -> dict:
    """The relay's cost a batch: ``RELAY_TRIPS`` sequential round trips of a
    RALM frame from one client to a ``RandomAnswerServer`` (a thread of
    this process), directly and through each coordinator in front of two
    of them."""
    import numpy as np
    from chamjax_torch.retrieval import (ExternalRetriever, NativeCoordinator,
                                         RandomAnswerServer,
                                         RetrieveCoordinator)
    b, d, k = RELAY_FRAME["batch"], RELAY_FRAME["dim"], RELAY_FRAME["k"]
    q = np.random.default_rng(0).standard_normal((b, d)).astype(np.float32)

    def servers(n):
        srv = [RandomAnswerServer(HOST, free_port(), batch_size=b, dim=d,
                                  seed=i) for i in range(n)]
        threads = [threading.Thread(target=s.start, daemon=True)
                   for s in srv]
        for t in threads:
            t.start()
        return srv, threads

    def trips(port, barrier: bool) -> float:
        c = connect(lambda: ExternalRetriever(HOST, port, b, d, k,
                                              timeout=WAIT_S), [],
                    "the relay")
        try:
            if barrier:
                c.sync_with_coordinator()
            for _ in range(10):
                c.retrieve(q, 32, k)
            t0 = time.perf_counter()
            for _ in range(RELAY_TRIPS):
                c.retrieve(q, 32, k)
            return (time.perf_counter() - t0) * 1e3 / RELAY_TRIPS
        finally:
            c.close()

    ms = {}
    srv, threads = servers(1)
    ms["direct"] = trips(srv[0].port, False)
    joined(threads, "relay: the engine")
    for name, cls in (("native", NativeCoordinator),
                      ("python", RetrieveCoordinator)):
        srv, threads = servers(2)
        port = free_port()
        coord = cls(HOST, port, 1, b, d, k,
                    engine_addrs=[(HOST, s.port) for s in srv],
                    queries_per_client=None)
        ct = threading.Thread(target=coord.start, daemon=True)
        ct.start()
        ms[name] = trips(port, True)
        joined([ct] + threads, f"relay: the {name} coordinator")
    return dict(frame=RELAY_FRAME, trips=RELAY_TRIPS, ms_per_batch=ms,
                relay_overhead_ms={n: ms[n] - ms["direct"]
                                   for n in ("native", "python")})


def disagg_phase(dev, ctx, retriever, gather_path) -> dict:
    """Phase 9: save both indexes to npz files in a temporary directory,
    start every engine process at once (each loads its index and captures
    its graphs before it listens), then the service mode, the RALM
    topology and the relay's cost.  Engines and files are cleaned up
    whatever happens."""
    import shutil
    import tempfile
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    ralm_batch = bench.parse_args(RALM_ARGV).batch
    tmp = tempfile.mkdtemp(prefix="chamjax_disagg_")
    engines = []
    try:
        flagship = f"{tmp}/flagship.npz"
        ctx["idx"].save(flagship)
        ralm_index = f"{tmp}/ralm.npz"
        retriever.searcher.packed.save(ralm_index)
        service = dict(
            card=spawn_engine("service card", flagship, backend="local",
                              device=str(dev), search_cfg=ctx["scfg"],
                              batch=BATCH, with_lists=True,
                              warm=(BATCH, 1)),
            native=spawn_engine(
                "service native", flagship, backend="native",
                search_cfg=dataclasses.replace(ctx["scfg"], lut_bf16=False),
                batch=BATCH, with_lists=True))
        ralm_engines = [spawn_engine(
            f"ralm {j}", ralm_index, backend="local", device=str(dev),
            search_cfg=retriever.searcher.scfg, batch=ralm_batch,
            connections=2, warm=(ralm_batch,))
            for j in range(DISAGG_ENGINES)]
        engines = [*service.values(), *ralm_engines]
        t0 = time.perf_counter()
        out = dict(service=service_phase(dev, ctx, service))
        t1 = time.perf_counter()
        out["ralm"] = ralm_disagg_phase(dev, retriever, ralm_engines)
        t2 = time.perf_counter()
        out["relay"] = relay_phase()
        out.update(streamed_gather_path=gather_path,
                   wall_s=dict(service=t1 - t0, ralm=t2 - t1,
                               relay=time.perf_counter() - t2))
        return out
    finally:
        for e in engines:
            if e.proc.is_alive():
                e.proc.kill()
            e.proc.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


# The build phase: benchmarks/bench_large.py's configuration (:54-83,
# :102-112) with --hard --n-clusters 262144 --opq --balance 1.30
# --balance-deadband 1.25 --balance-iters 12; only the depth is cut, from
# 96·2^20 to 16·2^20 rows
BUILD_CORPUS = dict(d=128, n_clusters=262_144, seed=42, zipf_a=1.05,
                    center_scale=1.25)
BUILD_NB = 16 << 20
BUILD_CFG = dict(nlist=65536, m=16, list_pad=128, opq=True, balanced=True,
                 balance_hard=True, balance_factor=1.30,
                 balance_train_iters=12, balance_deadband=1.25)
BUILD_KW = dict(kmeans_iters=8, pq_iters=10, seed=42, chunk=4 << 20,
                block=4096)
BUILD_NT = 2_000_000
BUILD_NPROBES = (1, 16, 32, 64)   # bench_large's --nprobes, plus 1
BUILD_BATCHES = 40                # b=128 query batches timed
ORACLE_R10 = 0.002                # f32-LUT kernel vs the xla oracle
MIN_R10_GAIN = 0.1                # R@10(16) - R@10(1): not saturated
ONDISK_NB = 4 << 20               # rows of the on-disk / preset leg
# the RALM streamed leg: the bench's defaults (Dec-S, IVF4096, PQ16,
# nprobe 32, batch 64, 128 timed steps) over 2^20 hard-mode rows
BUILD_RALM_ARGV = ["--streamed", "--hard", "--balance", "1.3", "--nb",
                   str(1 << 20)]
# context only (never gated): the Faiss SIFT100M IVF4096,PQ16 R@10 points
# that chamjax/data/hard.py cites
FAISS_SIFT100M_R10 = {"1": 0.41, "4": 0.66, "16": 0.79, "32": 0.80}


def synchronize(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def probed_rows(index, xq, nprobe, coarse_cand):
    """Rows in the lists ``ivfpq_search`` probes for each query of ``xq``
    (its rotation and coarse scan, in ``search_all``'s batches of
    ``BATCH``: a query's rotation may differ in its last bits between batch
    sizes), as int64 numpy."""
    import numpy as np
    import torch
    from chamjax_torch.ops.coarse import select_probes
    from chamjax_torch.searcher import _rotate
    from chamjax_torch.utils.precision import fp32_matmul
    out = []
    with fp32_matmul():
        for i in range(0, xq.shape[0], BATCH):
            q = _rotate(index, torch.as_tensor(xq[i:i + BATCH]).to(
                index.centroids.device))
            list_ids, _ = select_probes(q, index.centroids, nprobe,
                                        coarse_cand=coarse_cand,
                                        use_approx=coarse_cand == 0)
            out.append(index.list_len[list_ids.long()].sum(1).cpu().numpy())
    return np.concatenate(out).astype(np.int64)


def search_all(index, xq, kw):
    """``ivfpq_search`` over ``xq`` in b=128 batches → (dists, ids) numpy,
    ids int64."""
    import numpy as np
    from chamjax_torch.searcher import ivfpq_search
    outs = [ivfpq_search(index, xq[i:i + BATCH], **kw)
            for i in range(0, xq.shape[0], BATCH)]
    return (np.concatenate([o[0].cpu().numpy() for o in outs]),
            np.concatenate([o[1].cpu().numpy() for o in outs]).astype(
                np.int64))


def build_index(dev, hc):
    """Step 1: train and build on the card from the hard stream, both
    twins at the tile width ``auto_seg`` picks for evenly filled lists,
    with the stage profile on.  Returns (index, info, record)."""
    import os
    import numpy as np
    import torch
    from chamjax_torch.config import IndexConfig
    from chamjax_torch.data.hard import GEN
    from chamjax_torch.index import build_ivfpq_device
    from chamjax_torch.searcher import auto_seg
    nlist = BUILD_CFG["nlist"]
    nt = (BUILD_NT // BUILD_KW["block"]) * BUILD_KW["block"]

    def xt():         # the training sample, freed after training
        return hc.draw_train(0, -(-nt // GEN) * GEN)[:nt]

    seg = auto_seg(np.full(nlist, max(BUILD_NB // nlist, 1)))
    cfg = IndexConfig(dim=BUILD_CORPUS["d"], **BUILD_CFG)
    prev = os.environ.get("CHAMJAX_BUILD_PROFILE")
    os.environ["CHAMJAX_BUILD_PROFILE"] = "1"
    synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    t0 = time.perf_counter()
    try:
        index, info = build_ivfpq_device(hc.draw_base, BUILD_NB, cfg, xt,
                                         tile_seg=seg, device=dev,
                                         **BUILD_KW)
    finally:
        if prev is None:
            del os.environ["CHAMJAX_BUILD_PROFILE"]
        else:
            os.environ["CHAMJAX_BUILD_PROFILE"] = prev
    synchronize(dev)
    build_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - mem0
            if dev.type == "cuda" else None)
    lens = info["list_len"]
    if int(lens.sum()) != BUILD_NB:
        raise AssertionError(f"device build lost rows: {int(lens.sum())}")
    if index.codes_tiled is None or index.codes_tiled.shape[2] != seg:
        raise AssertionError("device build did not attach the tiled twin")
    cap, strag = info["cap"], info["stragglers"]
    over = np.maximum(lens.astype(np.int64) - cap, 0)
    if int(over.sum()) > strag:
        raise AssertionError(f"{int(over.sum())} rows past the cap {cap} "
                             f"but {strag} stragglers")
    rec = dict(build_s=build_s, stage_s=info["stage_s"],
               peak_mem_gib=None if peak is None else peak / 2 ** 30,
               stragglers=strag, cap=cap, max_list=int(lens.max()),
               lists_over_cap=int((over > 0).sum()),
               rows_over_cap=int(over.sum()),
               list_len_p50_p90_p99=np.percentile(
                   lens, [50, 90, 99]).tolist(),
               seg=seg, list_pad=build_config(seg).list_pad,
               n_pad=info["n_pad"])
    log(f"device build {build_s:.1f} s: {rec}")
    return index, info, rec


def build_search(dev, index, info, xq, gt):
    """Step 3: the captured ``ivfpq_search`` on the tiled layout at each
    nprobe, launch counts set to 0 just before and read just after.  With
    f32 LUTs and every window of the probed lists it is held to the
    ``backend="xla"`` oracle on the same DeviceIVF (the kernel alone
    differs); at ``auto_windows``' budget (bench_large's operating point)
    its recall and times are recorded, with f32 and packed-bf16 LUTs."""
    import numpy as np
    from chamjax_torch.eval import recall_at_k
    from chamjax_torch.searcher import auto_windows, resolve_coarse_cand
    from chamjax_torch.utils import cuda_lib
    lens, seg = info["list_len"], int(index.codes_tiled.shape[2])
    nlist = BUILD_CFG["nlist"]
    pad = build_config(seg).list_pad
    scan_len = -(-int(lens.max()) // pad) * pad
    q_gt, q_time = xq[:N_GT], xq[N_GT:]
    out, launches = {}, 0
    for nprobe in BUILD_NPROBES:
        ccand = resolve_coarse_cand(-1, nlist, nprobe)
        kw = dict(nprobe=nprobe, k=K, seg=seg, group=GROUP,
                  recall_target=0.9, backend="seg", coarse_approx=ccand == 0,
                  coarse_cand=ccand, lut_bf16=False,
                  windows=int(nprobe * np.ceil(lens.max() / seg)))
        cuda_lib.launch_counts.clear()
        d_s, i_s = search_all(index, q_gt, kw)
        n_l = cuda_lib.launch_counts["adc_scan_tiles"]
        if n_l < 1:
            raise AssertionError(f"build search nprobe {nprobe} did not "
                                 f"launch adc_scan_tiles")
        launches += n_l
        fin = np.isfinite(d_s)
        # every row of the probed lists is scanned here, so a row holds
        # exactly min(K, rows in its probed lists) finite distances, first
        # and sorted; at nprobe 1 a short list gives fewer than 10
        held = probed_rows(index, q_gt, nprobe, ccand)
        want = np.minimum(K, held)
        prefix = np.arange(K)[None, :] < want[:, None]
        if (not np.array_equal(fin, prefix)
                or (np.diff(d_s, axis=1) < 0).any()):
            bad = np.flatnonzero((fin != prefix).any(axis=1))[:5]
            raise AssertionError(
                f"build search nprobe {nprobe}: distances not finite/sorted "
                f"(rows {bad.tolist()}: finite {fin[bad].sum(1).tolist()}, "
                f"rows in their probed lists {held[bad].tolist()})")
        if ((i_s[fin] < 0) | (i_s[fin] >= BUILD_NB)).any():
            raise AssertionError("build search: ids out of range")
        rec = {f"recall_at_{r}": recall_at_k(i_s, gt, r)
               for r in (1, 10, 100)}
        d_x, i_x = search_all(index, q_gt, dict(kw, backend="xla",
                                                scan_len=scan_len))
        check_same_up_to_ties(f"build nprobe {nprobe}: tiled vs xla",
                              d_s, i_s, d_x, i_x, rtol=1e-5)
        r10_x = recall_at_k(i_x, gt, 10)
        if abs(rec["recall_at_10"] - r10_x) > ORACLE_R10:
            raise AssertionError(f"build nprobe {nprobe}: R@10 "
                                 f"{rec['recall_at_10']} vs xla oracle "
                                 f"{r10_x}")
        kw_a = dict(kw, windows=auto_windows(lens, seg, nprobe))
        kw_bf = dict(kw_a, lut_bf16=True)
        r10_a = recall_at_k(search_all(index, q_gt, kw_a)[1], gt, 10)
        r10_bf = recall_at_k(search_all(index, q_gt, kw_bf)[1], gt, 10)
        t32, tbf = time_search(index, kw_a, q_time), time_search(index, kw_bf,
                                                                 q_time)
        out[str(nprobe)] = dict(
            rec, recall_at_10_xla_oracle=r10_x, windows_all=kw["windows"],
            queries_under_10_rows=int((held < 10).sum()),
            launches=n_l, coarse_cand=ccand, windows=kw_a["windows"],
            recall_at_10_auto_windows=r10_a,
            recall_at_10_auto_windows_lut_bf16=r10_bf,
            qps_b128=BATCH * 1e3 / t32["ms_b128"],
            ms_per_batch_b128=t32["ms_b128"], ms_per_query_b1=t32["ms_b1"],
            qps_b128_lut_bf16=BATCH * 1e3 / tbf["ms_b128"],
            ms_per_query_b1_lut_bf16=tbf["ms_b1"])
        log(f"build search nprobe {nprobe}: {out[str(nprobe)]}")
    r10 = [out[str(p)]["recall_at_10"] for p in BUILD_NPROBES]
    if any(b < a for a, b in zip(r10, r10[1:])):
        raise AssertionError(f"build R@10 falls with nprobe: {r10}")
    gain = out["16"]["recall_at_10"] - out["1"]["recall_at_10"]
    if gain <= MIN_R10_GAIN:
        raise AssertionError(f"build R@10 saturates: nprobe 16 - nprobe 1 "
                             f"= {gain}")
    return out, launches


def build_breakdown(dev, hc, index, built):
    """Where the build's time goes: the device time (``device_ms``) of each
    primitive of one 4096-row block at the build's shapes (the bf16
    stage-1 GEMM, the fp32 epilogue, top-k over the (4096, 65536) scores,
    the exact re-rank; a whole k-means, balanced-training and candidates
    block), the host's time to enqueue a candidates block, and one stable
    sort of 16·2^20 keys (two a rebalance round), beside the stage
    seconds they imply (blocks × ms)."""
    import torch
    from chamjax_torch.data.hard import GEN
    from chamjax_torch.index import device_build as db
    from chamjax_torch.utils.precision import fp32_matmul
    blk, cent = BUILD_KW["block"], index.centroids
    with fp32_matmul():
        x = (hc.draw_base(0, GEN)[:blk] @ index.opq_R).contiguous()
    x16, c16 = x.to(torch.bfloat16), cent.to(torch.bfloat16)
    scores = db._stage1_scores(x, cent)
    top16 = torch.topk(scores, 16, dim=1).indices
    keys = torch.rand(BUILD_NB, device=dev)
    with fp32_matmul():
        ms = dict(
            gemm_bf16=device_ms(lambda: torch.mm(x16, c16.T,
                                                 out_dtype=torch.float32)),
            stage1_scores=device_ms(lambda: db._stage1_scores(x, cent)),
            topk_16=device_ms(lambda: torch.topk(scores, 16, dim=1)),
            topk_32=device_ms(lambda: torch.topk(scores, 32, dim=1)),
            rerank_16=device_ms(lambda: db._exact_partial(x, cent, top16)),
            block_assign_cand8=device_ms(
                lambda: db._assign_exact_2stage(x, cent, 8)),
            block_topc_c8=device_ms(
                lambda: db._topc_exact_2stage(x, cent, 8)),
            block_topc_c16=device_ms(
                lambda: db._topc_exact_2stage(x, cent, 16)),
            stable_sort_16m=device_ms(
                lambda: torch.argsort(keys, stable=True)))
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(20):
            db._topc_exact_2stage(x, cent, 8)
        ms["host_enqueue_block_topc_c8"] = (time.perf_counter() - t0) * 50
        synchronize(dev)
    nt_blocks = -(-BUILD_NT // blk)
    implied = dict(
        kmeans_s=BUILD_KW["kmeans_iters"] * nt_blocks
        * ms["block_assign_cand8"] / 1e3,
        balanced_training_s=BUILD_CFG["balance_train_iters"] * nt_blocks
        * ms["block_topc_c16"] / 1e3,
        candidates_s=BUILD_NB // blk * ms["block_topc_c8"] / 1e3)
    out = dict(block_ms=ms, implied=implied, stage_s=built["stage_s"])
    log(f"build breakdown: {out}")
    del keys, scores
    return out


def build_retile(dev, index, info, xq):
    """Step 5: ``retile_device_ivf`` of the flat twin to the other
    power-of-two tile width: the searches (f32 LUTs, every window of the
    probed lists) equal up to ties, and the retiled index owns a fresh
    ``graphs`` (a search captured on the old layout is never replayed on
    it)."""
    import numpy as np
    from chamjax_torch.ops.scan_seg import MAX_SEG
    from chamjax_torch.searcher import retile_device_ivf
    lens, seg = info["list_len"], int(index.codes_tiled.shape[2])
    other = seg * 2 if seg * 2 <= MAX_SEG else seg // 2
    q = xq[:N_GT]

    def kw(s):
        return dict(nprobe=NPROBE, k=K, seg=s, group=GROUP, backend="seg",
                    lut_bf16=False,
                    windows=int(NPROBE * np.ceil(lens.max() / s)))
    d_a, i_a = search_all(index, q, kw(seg))
    old_graphs = len(index.graphs)
    t0 = time.perf_counter()
    r = retile_device_ivf(index, other, lens)
    synchronize(dev)
    retile_s = time.perf_counter() - t0
    if r.graphs is index.graphs or len(r.graphs):
        raise AssertionError("the retiled index kept the old graphs")
    d_b, i_b = search_all(r, q, kw(other))
    if len(index.graphs) != old_graphs or (dev.type == "cuda"
                                           and not len(r.graphs)):
        raise AssertionError("a search of the retiled index went to the "
                             "old index's graphs")
    check_same_up_to_ties(f"retile {seg} -> {other}", d_b, i_b, d_a, i_a,
                          rtol=1e-5)
    out = dict(seg=seg, other=other, retile_s=retile_s,
               graphs_old=old_graphs, graphs_new=len(r.graphs))
    del r
    log(f"retile: {out}; answers equal up to ties")
    return out


def build_ondisk(dev, hc, index, info):
    """Step 6: the trained quantizers exported as ``TrainedQuantizers``;
    ``populate_on_disk_device`` over the first ``ONDISK_NB`` rows into a
    temporary directory, ``load_ondisk``, ``HostStreamedSearcher``; and
    ``build_ivfpq_device(quantizers=..., balanced=False)`` over the same
    rows: equal list lengths, ids equal per list, b=128 answers equal up
    to ties."""
    import tempfile
    import numpy as np
    import torch
    from chamjax_torch.config import SearchConfig
    from chamjax_torch.index import build_ivfpq_device
    from chamjax_torch.index.factory import TrainedQuantizers
    from chamjax_torch.index.ondisk import load_ondisk, populate_on_disk_device
    from chamjax_torch.searcher import auto_seg, auto_windows, ivfpq_search
    from chamjax_torch.streamed import HostStreamedSearcher
    cfg = dataclasses.replace(build_config(int(index.codes_tiled.shape[2])),
                              balanced=False)
    tq = TrainedQuantizers(
        cfg=cfg, centroids=index.centroids.cpu().numpy(),
        codebooks=index.codebooks.cpu().numpy(),
        opq_R=index.opq_R.cpu().numpy())
    q = torch.as_tensor(hc.queries(BATCH, salt=4)).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        populate_on_disk_device(hc.draw_base, ONDISK_NB, tq, tmp,
                                chunk=1 << 20, device=dev)
        ondisk_s = time.perf_counter() - t0
        disk = load_ondisk(tmp)
        t0 = time.perf_counter()
        sub, sub_info = build_ivfpq_device(
            hc.draw_base, ONDISK_NB, cfg, None, device=dev,
            quantizers=(tq.centroids, tq.codebooks, tq.opq_R),
            chunk=BUILD_KW["chunk"], block=BUILD_KW["block"])
        synchronize(dev)
        preset_s = time.perf_counter() - t0
        if not np.array_equal(disk.list_len, sub_info["list_len"]):
            raise AssertionError("on-disk and resident list lengths differ")
        ids_d = np.asarray(disk.ids)
        ids_r = sub.ids.cpu().numpy()[:ids_d.shape[0]]
        if not np.array_equal(ids_d, ids_r):
            raise AssertionError("on-disk and resident ids differ per list")
        seg = auto_seg(disk.list_len)
        W = auto_windows(disk.list_len, seg, NPROBE)
        scfg = SearchConfig(nprobe=NPROBE, k=K, seg=seg, seg_group=GROUP,
                            lut_bf16=False, scan_windows=W, coarse_cand=0)
        hs = HostStreamedSearcher(disk, scfg, device=dev)
        t0 = time.perf_counter()
        d_h, i_h = hs.search(q.cpu().numpy())
        host_ms = (time.perf_counter() - t0) * 1e3
        d_r, i_r = ivfpq_search(sub, q, nprobe=NPROBE, k=K, windows=W,
                                seg=seg, group=GROUP, lut_bf16=False,
                                backend="seg")
        check_same_up_to_ties("on-disk vs resident b=128", d_h, i_h,
                              d_r.cpu().numpy(),
                              i_r.cpu().numpy().astype(np.int64), rtol=1e-5)
        out = dict(rows=ONDISK_NB, populate_on_disk_device_s=ondisk_s,
                   preset_build_s=preset_s, seg=seg, windows=W,
                   streamed_search_ms_b128=host_ms,
                   gather_path=hs.gather_path,
                   codes_mib=disk.codes.nbytes / 2 ** 20)
        del disk, hs, sub
    log(f"on-disk leg: {out}; layouts and answers equal")
    return out


def build_config(seg: int):
    """The build's IndexConfig, with the list padding its tile width gives
    it (``lcm(list_pad, seg)``, as ``build_ivfpq_device`` pads)."""
    import math
    from chamjax_torch.config import IndexConfig
    return IndexConfig(dim=BUILD_CORPUS["d"], **dict(
        BUILD_CFG, list_pad=math.lcm(BUILD_CFG["list_pad"], seg)))


def build_ralm(dev):
    """Step 7: ``ralm_device_bench.run`` on its streamed leg (``--streamed
    --hard --balance 1.3``) at the bench's defaults: the timed steps under
    the sync check with the launch counts set to 0 just before and read
    just after; the fused retrievals of the last step equal an eager
    ``DeviceRetriever`` search of the same hidden states up to ties."""
    import numpy as np
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    from chamjax_torch.utils import graphs
    args = bench.parse_args(BUILD_RALM_ARGV)
    d = next(iter(bench.model_configs(args).values())).embed_dim
    t0 = time.perf_counter()
    rec = QueryRecorder(bench.build_streamed_retriever(args, d, dev))
    build_s = time.perf_counter() - t0

    def inspect(preset, interval, loop):
        with graphs.disable_capture():
            again = rec.inner.retrieve_device(rec.queries, args.nprobe,
                                              args.k)
        check_same_up_to_ties(
            f"streamed ralm {preset}: fused vs DeviceRetriever",
            rec.result.dists.cpu().numpy(),
            rec.result.ids.cpu().numpy().astype(np.int64),
            again.dists.cpu().numpy(),
            again.ids.cpu().numpy().astype(np.int64), rtol=1e-5)
        return dict(fused_equals_device_retriever=True)

    rows = list(bench.run(args, dev, retriever=rec, inspect=inspect))
    row = rows[0]
    if row["launches_adc_scan_tiles"] < 1 or not row["no_host_sync_checked"]:
        raise AssertionError(f"streamed ralm: {row}")
    r = rec.inner
    out = dict(row, build_s=build_s, seg=r.seg, windows=r.windows,
               nb=args.nb, max_list=int(r.list_len.max()),
               cap=int(np.ceil(args.nb / args.nlist * args.balance)))
    log(f"streamed ralm: {out}")
    return out


def build_phase(dev):
    """Phase 9: the index build on the card (``BUILD_*``): build, streamed
    ground truth, the search curve against the xla oracle, the tiled
    kernel at the build's tile width, retile, the on-disk leg, the RALM
    streamed leg.  Returns the build line and the kernel measurement."""
    import torch
    from chamjax_torch.data.hard import GEN, make_hard_corpus
    from chamjax_torch.index import compute_ground_truth_streamed
    from chamjax_torch.searcher import auto_windows
    t_phase = time.perf_counter()
    hc = make_hard_corpus(device=dev, **BUILD_CORPUS)
    xq = hc.queries(BATCH * BUILD_BATCHES + N_GT)    # independent draws
    index, info, built = build_index(dev, hc)
    t0 = time.perf_counter()
    gt, _ = compute_ground_truth_streamed(hc.draw_base, BUILD_NB, xq[:N_GT],
                                          k=K, chunk=BUILD_KW["chunk"],
                                          block=GEN, device=dev)
    synchronize(dev)
    gt_s = time.perf_counter() - t0
    search, launches = build_search(dev, index, info, xq, gt)
    seg = int(index.codes_tiled.shape[2])
    s = dataclasses.make_dataclass("S", ["dev", "seg", "scfg", "windows"])(
        index, seg, dataclasses.make_dataclass("C", ["lut_bf16"])(False),
        auto_windows(info["list_len"], seg, NPROBE))
    scan = tiles_on_queries(f"adc_scan_tiles[device build seg {seg}]", s,
                            torch.as_tensor(xq[:BATCH]).to(dev), NPROBE)
    breakdown = build_breakdown(dev, hc, index, built)
    retile = build_retile(dev, index, info, xq)
    ondisk = build_ondisk(dev, hc, index, info)
    del index
    ralm = build_ralm(dev)
    line = dict(
        config="bench_large.py --hard --n-clusters 262144 --opq --balance "
               "1.30 --balance-deadband 1.25 --balance-iters 12, nb cut to "
               "16*2^20",
        nb=BUILD_NB, nlist=BUILD_CFG["nlist"], m=BUILD_CFG["m"],
        **built, ground_truth_s=gt_s, nq_recall=N_GT, k=K,
        search=search, faiss_sift100m_r10_context=FAISS_SIFT100M_R10,
        kernel=scan["measured"], breakdown=breakdown, retile=retile,
        ondisk=ondisk,
        ralm_streamed=ralm, phase_s=time.perf_counter() - t_phase)
    return dict(line=line, launches=launches, kernel=scan["measured"],
                seg=seg)


# The mesh phase: every position on the one card (an explicit virtual mesh,
# ``make_mesh(axes, devices=[card] * n)``), so its times are the mesh
# program's cost over the single-device search, not scaling
MESH_LAYOUTS = (    # name, axes, tiled, backend, kernel
    ("tiled_lists2", (("lists", 2),), True, "seg", "adc_scan_tiles"),
    ("tiled_lists4", (("lists", 4),), True, "seg", "adc_scan_tiles"),
    ("tiled_data2_lists2", (("data", 2), ("lists", 2)), True, "seg",
     "adc_scan_tiles"),
    ("flat_seg_lists4", (("lists", 4),), False, "seg",
     "adc_scan_segments_multi"),
    ("flat_pallas_lists4", (("lists", 4),), False, "pallas",
     "adc_scan_distances"),
)
MESH_BUILD_SHARDS = 4
MESH_BUILD_GAP = 0.02          # sharded against host build R@10: a finding
MESH_TP_PRESETS = ("Dec-S", "EncDec-S", "Llama-S")
MESH_TP_AXES = (("dp", 2), ("tp", 2))
MESH_TP_F32 = dict(batch=4, steps=4, rtol=1e-4)
MESH_TP_BF16_STEPS = 16        # bf16 TP against bf16 unsharded, BF16_REL
MESH_TP_WARM, MESH_TP_TIMED = 8, 32
MESH_RAG_AXES = (("dp", 2), ("tp", 2), ("lists", 2))
MESH_RAG_PRESET, MESH_RAG_STEPS = "Dec-S", 32


def on_card_mesh(axes, dev):
    import math
    from chamjax_torch.parallel import make_mesh
    return make_mesh(axes, devices=[dev] * math.prod(s for _, s in axes))


def rows_off(d, i, d_ref, i_ref, rtol):
    """The rows of ``(d, i)`` that differ from the reference's other than
    by the order of ties."""
    from chamjax_torch.eval import tie_mismatches
    return [r for r in range(d.shape[0])
            if tie_mismatches(d[r:r + 1], i[r:r + 1], d_ref[r:r + 1],
                              i_ref[r:r + 1], rtol=rtol, atol=rtol)]


def lut_batch_witness(s, xq):
    """Why the 2-D rows are held to row-sized searches: the rotation,
    probes and LUTs of the same b=128 batches built whole and as the two
    data rows' halves, compared bit for bit (the LUTs in f32 and at their
    packed-bf16 rounding, over the rows whose probes agree)."""
    import numpy as np
    import torch
    from chamjax_torch.ops.coarse import select_probes
    from chamjax_torch.ops.lut import build_luts
    from chamjax_torch.searcher import _rotate
    from chamjax_torch.utils.precision import fp32_matmul
    idx, half = s.dev, BATCH // 2

    @fp32_matmul()        # as ivfpq_search runs them
    def pieces(q):
        rot = _rotate(idx, q)
        list_ids, _ = select_probes(rot, idx.centroids, NPROBE)
        return rot, list_ids, build_luts(rot, idx.centroids, idx.codebooks,
                                         list_ids)
    n = dict(rot=0, probe_rows=0, lut_f32=0, lut_bf16=0, lut_entries=0)
    for b0 in range(0, N_GT, BATCH):
        q = torch.as_tensor(xq[b0:b0 + BATCH]).to(idx.centroids.device)
        whole = pieces(q)
        rot, ids, luts = (torch.cat(x) for x in zip(
            pieces(q[:half]), pieces(q[half:])))
        n["rot"] += int((rot != whole[0]).sum())
        same = (ids == whole[1]).all(1)
        n["probe_rows"] += int((~same).sum())
        a, b = luts[same], whole[2][same]
        n["lut_f32"] += int((a != b).sum())
        n["lut_bf16"] += int((a.to(torch.bfloat16)
                              != b.to(torch.bfloat16)).sum())
        n["lut_entries"] += a.numel()
    return n


def mesh_search(dev, ctx):
    """Step 1: the flagship index sharded by ``shard_index`` in each
    ``MESH_LAYOUTS`` layout; the 256 recall queries through it with f32 and
    packed-bf16 LUTs (f32 only on the padded-window route), the launch
    counts set to 0 just before and read just after, each equal to the
    single-device ``IVFSearcher.search`` with the same LUTs up to ties at
    the same R@10; b=128 and b=1 (2-D: b=2) times, captured and eager,
    beside the single-device search's in this run."""
    import numpy as np
    import torch
    from chamjax_torch.eval import recall_at_k
    from chamjax_torch.ops.scan_pallas import GROUP as PALLAS_GROUP
    from chamjax_torch.parallel import (place_sharded, shard_index,
                                        sharded_search, sharded_search_2d)
    from chamjax_torch.parallel.sharded_search import captures
    from chamjax_torch.utils import cuda_lib, graphs
    idx, gt, xq = ctx["idx"], ctx["gt"], ctx["ds"].xq[:N_GT]
    s = ctx["searcher"]
    want = {True: ctx["tiled_bf16"], False: ctx["tiled_f32"]}
    # the 2-D layout builds each data row's LUTs on its half of the batch,
    # and the LUTs of a query differ in their last bits between a batch of
    # 128 and one of 64 (``lut_batch_witness``); one bit can move a
    # packed-bf16 entry a whole bf16 step, so the 2-D rows are held to the
    # single-device search over row-sized batches, and the rows where that
    # search itself differs between the two sizes are recorded
    want_rows = {bf: tuple(np.concatenate(part) for part in zip(*(
        searcher.search(xq[i:i + BATCH // 2])
        for i in range(0, N_GT, BATCH // 2))))
        for bf, searcher in ((True, s), (False, ctx["searcher_f32"]))}
    witness = dict(bits_differ=lut_batch_witness(s, xq))
    for bf, tag in ((True, "bf16"), (False, "f32")):
        (d64, i64), (d128, i128) = want_rows[bf], want[bf]
        witness[f"search_{tag}"] = dict(
            rows_dists_not_bit_equal=int(np.any(d64 != d128, axis=1).sum()),
            rows_off_up_to_ties=rows_off(d64, i64, d128, i128, 1e-5))
    log(f"mesh lut batch witness: {witness}")
    scan_len = -(-idx.suggest_scan_len(NPROBE) // PALLAS_GROUP) * PALLAS_GROUP
    if scan_len < int(idx.list_len.max()):
        raise AssertionError("the padded-window route would cut lists")
    single = dict(time_search(*ctx["main_search"], ctx["xq_dev"]))
    with graphs.disable_capture():
        single.update(suffixed(time_search(*ctx["main_search"],
                                           ctx["xq_dev"]), "_eager"))
    out = dict(single=single, lut_batch_witness=witness)
    launches = collections.Counter()
    for name, axes, tiled, backend, kernel in MESH_LAYOUTS:
        mesh = on_card_mesh(axes, dev)
        sh = place_sharded(shard_index(idx, mesh.shape["lists"],
                                       tile_seg=SEG if tiled else 0), mesh)
        two_d = "data" in mesh.shape
        search = sharded_search_2d if two_d else sharded_search
        rec = dict(mesh=mesh.shape, backend=backend, tiled=tiled,
                   captured=captures(mesh))
        for lut_bf16 in ((False, True) if backend == "seg" else (False,)):
            kw = dict(nprobe=NPROBE, k=K, windows=s.windows, seg=SEG,
                      group=GROUP, backend=backend, lut_bf16=lut_bf16,
                      scan_len=scan_len)
            tag = "bf16" if lut_bf16 else "f32"
            cuda_lib.launch_counts.clear()
            res = [search(sh, torch.as_tensor(xq[i:i + BATCH]).to(dev),
                          mesh=mesh, **kw) for i in range(0, N_GT, BATCH)]
            got = dict(cuda_lib.launch_counts)
            if got.get(kernel, 0) < 1:
                raise AssertionError(f"mesh {name}: {kernel} did not "
                                     f"launch: {got}")
            launches[kernel] += got[kernel]
            d = np.concatenate([r[0].cpu().numpy() for r in res])
            i = np.concatenate([r[1].cpu().numpy() for r in res]).astype(
                np.int64)
            ref = (want_rows if two_d else want)[lut_bf16]
            check_same_up_to_ties(f"mesh {name} {tag} vs IVFSearcher.search",
                                  d, i, *ref, rtol=1e-5)
            if two_d:
                # where the 2-D rows leave the full-batch search, the
                # single-device search leaves it too at row-sized batches
                off = rows_off(d, i, *want[lut_bf16], 1e-5)
                if set(off) - set(witness[f"search_{tag}"][
                        "rows_off_up_to_ties"]):
                    raise AssertionError(
                        f"mesh {name} {tag}: rows {off} off the full-batch "
                        f"search, not all explained by the batch size: "
                        f"{witness}")
                rec[f"rows_off_full_batch_{tag}"] = off
            r10, r10_single = recall_at_k(i, gt, 10), recall_at_k(ref[1], gt,
                                                                 10)
            if abs(r10 - r10_single) > 1 / (10 * N_GT) or r10 < MIN_R10:
                raise AssertionError(f"mesh {name} {tag}: R@10 {r10}, the "
                                     f"single-device search's {r10_single}")
            rec[f"recall_at_10_{tag}"] = r10
            rec[f"launches_{tag}"] = got
        # times at the route's production LUTs
        kw["lut_bf16"] = backend == "seg"
        small = 2 if two_d else 1

        def run(q):
            return search(sh, q, mesh=mesh, **kw)
        rec.update(time_batches(run, ctx["xq_dev"], small))
        with graphs.disable_capture():
            rec.update(suffixed(time_batches(run, ctx["xq_dev"], small),
                                "_eager"))
        rec["graphs"] = len(sh.graphs)
        log(f"mesh search {name}: {rec}")
        out[name] = rec
    return out, dict(launches)


def reassembled(sh, info, cfg):
    """The sharded build's lists as one ``PackedIVF``: each list's rows as
    its owner shard holds them (tiled codes read back row-major)."""
    import math
    import numpy as np
    from chamjax_torch.index.ivf import PackedIVF
    from chamjax_torch.ops.scan_seg import MAX_SEG
    pad = math.lcm(cfg.list_pad, SEG)
    ll, owner = info["list_len"].astype(np.int64), info["owner"]
    m = sh.codes_tiled[0].shape[1]
    codes_sh = [t.permute(0, 2, 1).reshape(-1, m).cpu().numpy()
                for t in sh.codes_tiled]
    ids_sh = [t.cpu().numpy() for t in sh.ids]
    starts_sh = [t.cpu().numpy() for t in sh.list_start]
    padded = np.maximum(-(-np.maximum(ll, 1) // pad), 1) * pad
    start = np.concatenate([[0], np.cumsum(padded)[:-1]])
    n_pad = int(padded.sum()) + MAX_SEG
    codes = np.zeros((n_pad, m), np.uint8)
    ids = np.full(n_pad, -1, np.int32)
    for li in range(ll.shape[0]):
        s, n = int(owner[li]), int(ll[li])
        a, b = int(starts_sh[s][li]), int(start[li])
        codes[b:b + n] = codes_sh[s][a:a + n]
        ids[b:b + n] = ids_sh[s][a:a + n]
    return PackedIVF.from_arrays(
        dict(dataclasses.asdict(cfg), list_pad=pad),
        centroids=sh.centroids.cpu().numpy(),
        codebooks=sh.codebooks.cpu().numpy(), codes=codes, ids=ids,
        list_start=start, list_len=ll, ntotal=info["ntotal"],
        opq_R=None if sh.opq_R is None else sh.opq_R.cpu().numpy())


def mesh_build(dev, ctx, host_line):
    """Step 2: ``build_ivfpq_device_sharded`` at the flagship's
    configuration over its 1M rows (the numpy corpus in memory),
    ``MESH_BUILD_SHARDS`` shards, tiled at seg 512: every id once, every
    list owned once with ``info["list_len"]``; searched through
    ``sharded_search`` (f32 LUTs, every window of the probed lists) equal
    to the ``backend="xla"`` oracle over the same lists as one
    ``PackedIVF`` up to ties and within ``ORACLE_R10``; build s, peak GiB
    and R@10 beside the host build's."""
    import numpy as np
    import torch
    from chamjax_torch.config import SearchConfig
    from chamjax_torch.eval import recall_at_k
    from chamjax_torch.index import build_ivfpq_device_sharded
    from chamjax_torch.parallel import place_sharded, sharded_search
    from chamjax_torch.searcher import IVFSearcher
    from chamjax_torch.utils import cuda_lib
    ds, cfg, gt = ctx["ds"], ctx["cfg"], ctx["gt"]
    nb = ds.xb.shape[0]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    sh, info = build_ivfpq_device_sharded(
        lambda s, c: ds.xb[s:s + c], nb, cfg, ds.xt, MESH_BUILD_SHARDS,
        kmeans_iters=10, pq_iters=10, tile_seg=SEG, device=dev)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - mem0) / 2 ** 30
    lens = np.stack([t.cpu().numpy() for t in sh.list_len])
    ids = np.concatenate([t.cpu().numpy() for t in sh.ids])
    if not (np.array_equal(np.sort(ids[ids >= 0]), np.arange(nb))
            and ((lens > 0).sum(0) <= 1).all()
            and np.array_equal(lens.sum(0), info["list_len"])):
        raise AssertionError("sharded build: ids or lists not partitioned")
    mesh = on_card_mesh((("lists", MESH_BUILD_SHARDS),), dev)
    placed = place_sharded(sh, mesh)
    xq = ds.xq[:N_GT]
    windows = NPROBE * int(np.ceil(info["list_len"].max() / SEG))
    kw = dict(nprobe=NPROBE, k=K, windows=windows, seg=SEG, group=GROUP,
              backend="seg", lut_bf16=False)
    cuda_lib.launch_counts.clear()
    res = [sharded_search(placed, torch.as_tensor(xq[i:i + BATCH]).to(dev),
                          mesh=mesh, **kw) for i in range(0, N_GT, BATCH)]
    launches = dict(cuda_lib.launch_counts)
    if launches.get("adc_scan_tiles", 0) < 1:
        raise AssertionError(f"sharded build search: {launches}")
    d = np.concatenate([r[0].cpu().numpy() for r in res])
    i = np.concatenate([r[1].cpu().numpy() for r in res]).astype(np.int64)
    oracle = IVFSearcher(reassembled(sh, info, cfg),
                         SearchConfig(nprobe=NPROBE, k=K, backend="xla"),
                         device=dev).search(xq)
    check_same_up_to_ties("sharded build vs the xla oracle", d, i, *oracle,
                          rtol=1e-5)
    r10, r10_oracle = recall_at_k(i, gt, 10), recall_at_k(oracle[1], gt, 10)
    if abs(r10 - r10_oracle) > ORACLE_R10:
        raise AssertionError(f"sharded build R@10 {r10}, oracle "
                             f"{r10_oracle}")
    host = host_line["recall_at_10_f32_lut"]
    rec = dict(shards=MESH_BUILD_SHARDS, build_s=build_s,
               peak_mem_gib=peak, shard_rows=info["shard_rows"].tolist(),
               n_pad=info["n_pad"], max_list=int(info["list_len"].max()),
               windows=windows, recall_at_10_f32=r10,
               recall_at_10_xla_oracle=r10_oracle,
               host_build_s=host_line["build_s"],
               host_recall_at_10_f32=host,
               recall_gap_over_bar=host - r10 > MESH_BUILD_GAP,
               launches=launches)
    log(f"mesh build: {rec}")
    return rec


class DecodeSteps:
    """Decode steps alone, no retrieval, on fixed buffers (a token buffer
    the argmax is written back to; the encoder-decoder's cross K/V made
    once from an encoded context): what a tensor-parallel step costs.
    ``mesh`` None runs the unsharded step."""

    def __init__(self, cfg, params, batch, dev, mesh=None):
        import numpy as np
        import torch
        from chamjax_torch.models import encoder_forward
        from chamjax_torch.models.transformer import build_cross_kv, leaves
        from chamjax_torch.parallel import (shard_decoder_params,
                                            shard_kv_cache,
                                            shard_llama_params)
        from chamjax_torch.serving.ralm import first_tokens, step_fns
        from chamjax_torch.utils import graphs
        self._step, new_cache = step_fns(cfg)
        *enc, dec = params if cfg.model_type == "encoder-decoder" else (
            params,)
        self.cache = new_cache(cfg, batch, device=dev)
        if mesh is not None:
            dec = (shard_llama_params(dec, mesh, kv_heads=cfg.kv_heads)
                   if cfg.model_type == "llama"
                   else shard_decoder_params(dec, mesh))
            enc = [shard_decoder_params(e, mesh) for e in enc]
            self.cache = shard_kv_cache(self.cache, mesh)
        self.dec = dec
        self.tokens = first_tokens(batch, dev)
        self.cross = {}
        if enc:
            src = torch.from_numpy(np.random.default_rng(3).integers(
                1, cfg.vocab_size, (batch, 16)).astype(np.int32)).to(dev)
            kv = build_cross_kv(dec, encoder_forward(
                enc[0], src, cfg.attention_heads), cfg.attention_heads)
            graphs.state(*leaves(kv))
            self.cross = dict(cross_kv=kv)

    def step(self, tokens=None):
        import torch
        if tokens is not None:
            self.tokens.copy_(tokens)
        logits, _, self.cache = self._step(self.dec, self.tokens, self.cache,
                                           **self.cross)
        self.tokens.copy_(torch.argmax(logits, dim=-1))
        return logits

    def multi_steps(self, n):
        for _ in range(n):
            self.step()


def mesh_tp(dev):
    """Step 3: tensor-parallel decode at full width, dp 2 × tp 2 on the
    card: per preset, ``MESH_TP_F32`` steps in f32 against the unsharded
    f32 step (logits within rtol of the largest, tokens equal), then
    ``MESH_TP_BF16_STEPS`` bf16 steps at batch 64 on the same seeded tokens
    against the unsharded bf16 step (``BF16_REL`` of the f32 logits'
    largest magnitude), then captured ms a step, launches a step and busy
    share (``trace_steps``) of both."""
    import numpy as np
    import torch
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    from chamjax_torch.benchmarks.ralm_device_bench import no_host_sync
    from chamjax_torch.models.transformer import reset_cache
    args = bench.parse_args(RALM_ARGV + ["--presets",
                                         ",".join(MESH_TP_PRESETS)])
    mesh = on_card_mesh(MESH_TP_AXES, dev)
    out = {}
    for name, cfg in bench.model_configs(args).items():
        rec = dict(mesh=mesh.shape)
        f32 = dataclasses.replace(cfg, dtype="float32")
        p32 = bench.init_params(f32, 0, dev)
        b = MESH_TP_F32["batch"]
        ref, tp = DecodeSteps(f32, p32, b, dev), DecodeSteps(f32, p32, b,
                                                             dev, mesh)
        errs = []
        for _ in range(MESH_TP_F32["steps"]):
            lr, lt = ref.step(), tp.step()
            errs.append(float((lt - lr).abs().max() / lr.abs().max()))
            if not torch.equal(ref.tokens, tp.tokens):
                raise AssertionError(f"tp {name} f32: tokens differ")
        if max(errs) > MESH_TP_F32["rtol"]:
            raise AssertionError(f"tp {name} f32: rel err {errs}")
        rec["f32_rel_err"] = errs
        del ref, tp, p32
        p16 = bench.init_params(cfg, 0, dev)
        p32 = bench.init_params(f32, 0, dev)
        for a, c in zip(p32 if isinstance(p32, tuple) else (p32,),
                        p16 if isinstance(p16, tuple) else (p16,)):
            a.load_state_dict(c.state_dict())       # bf16 → f32: exact
        loops = {"unsharded": DecodeSteps(cfg, p16, args.batch, dev),
                 "tp": DecodeSteps(cfg, p16, args.batch, dev, mesh),
                 "f32": DecodeSteps(f32, p32, args.batch, dev)}
        toks = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (MESH_TP_BF16_STEPS, args.batch))
        errs = []
        for t in toks:
            t = torch.from_numpy(t.astype(np.int32)).to(dev)
            lg = {k: v.step(t).float() for k, v in loops.items()}
            errs.append(float((lg["tp"] - lg["unsharded"]).abs().max()
                              / lg["f32"].abs().max()))
        if max(errs) > BF16_REL:
            raise AssertionError(f"tp {name} bf16: rel err {errs}")
        rec["bf16_rel_err"] = errs
        del loops["f32"], p32
        for kind, loop in loops.items():
            loop.cache = reset_cache(loop.cache)
            loop.tokens.fill_(1)
            loop.multi_steps(MESH_TP_WARM)
            loop.cache = reset_cache(loop.cache)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with no_host_sync(dev):
                loop.multi_steps(MESH_TP_TIMED)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) / MESH_TP_TIMED * 1e3
            traced = trace_steps(loop, f"tp_{name}_{kind}", ms)
            rec[kind] = dict(ms_per_step=ms,
                             tok_per_s=args.batch * 1e3 / ms,
                             launches_per_step=traced["launches_per_step"],
                             kernel_ms_per_step=traced["kernel_ms_per_step"],
                             busy_share=traced["busy_share"],
                             graphs=len(loop.cache.graphs))
        log(f"mesh tp {name}: {rec}")
        out[name] = rec
        del loops, p16
    return out


def mesh_rag(dev, retriever):
    """Step 4: ``RalmDecoder`` and ``TikTokDecoder`` on Dec-S at interval 1,
    batch 64: tensor-parallel parameters over a ``MeshRetriever`` on the
    RALM index sharded over ``lists``, ``batch_axis="dp"`` (dp × tp × lists,
    8 positions), beside the unsharded loop over the ``LocalRetriever``:
    tok/s, ``adc_scan_tiles`` launches (counts set to 0 just before the
    timed steps), the last fused retrieval equal to ``IVFSearcher.search``
    on the same hidden states up to ties.  Then ``dryrun_multichip(8)`` on
    8 positions of the card."""
    import torch
    from chamjax_torch import entry
    from chamjax_torch.benchmarks import ralm_device_bench as bench
    from chamjax_torch.parallel import (place_sharded, shard_decoder_params,
                                        shard_index, shard_kv_cache)
    from chamjax_torch.retrieval import MeshRetriever
    from chamjax_torch.serving import RalmDecoder, TikTokDecoder
    from chamjax_torch.utils import cuda_lib
    s = retriever.searcher
    args = bench.parse_args(RALM_ARGV + ["--presets", MESH_RAG_PRESET])
    cfg = bench.model_configs(args)[MESH_RAG_PRESET]
    params = bench.init_params(cfg, 0, dev)
    mesh = on_card_mesh(MESH_RAG_AXES, dev)
    sh = place_sharded(shard_index(s.packed, mesh.shape["lists"],
                                   tile_seg=s.seg), mesh)
    mesh_r = QueryRecorder(MeshRetriever(
        sh, mesh, s.packed.list_len, dataclasses.replace(s.scfg, seg=s.seg),
        batch_axis="dp"))
    tp_params = shard_decoder_params(params, mesh)
    out = dict(mesh=mesh.shape, steps=MESH_RAG_STEPS, batch=args.batch)
    for kind, cls in (("ralm", RalmDecoder), ("tiktok", TikTokDecoder)):
        for sharded in (False, True):
            loop = cls(tp_params if sharded else params, cfg,
                       mesh_r if sharded else retriever, args.batch,
                       retrieval_interval=1, nprobe=args.nprobe, k=args.k)
            if sharded:
                states = (loop.states.values() if kind == "tiktok"
                          else (loop,))
                for st in states:
                    st.cache = shard_kv_cache(st.cache, mesh)
            loop.batch_inference(args.warmup)
            loop.reset_inference_state()
            cuda_lib.launch_counts.clear()
            loop.batch_inference(MESH_RAG_STEPS)
            launches = cuda_lib.launch_counts["adc_scan_tiles"]
            if launches < 1:
                raise AssertionError(f"mesh {kind}: adc_scan_tiles did not "
                                     "launch")
            key = f"{kind}{'_tp_mesh' if sharded else '_unsharded'}"
            out[key] = dict(tok_per_s=loop.throughput_tokens_per_sec(
                MESH_RAG_STEPS), launches_adc_scan_tiles=launches)
            if sharded:
                q, res = mesh_r.queries, mesh_r.result
                d_s, i_s = s.search(q.cpu().numpy(), nprobe=args.nprobe,
                                    k=args.k)
                check_same_up_to_ties(
                    f"mesh {kind}: fused retrieval vs IVFSearcher.search",
                    res.dists.cpu().numpy(),
                    res.ids.cpu().numpy().astype("int64"), d_s, i_s,
                    rtol=1e-5)
                out[key]["fused_equals_searcher"] = True
            del loop
            torch.cuda.synchronize(dev)
    out["graphs"] = len(sh.graphs)
    out["dryrun_multichip"] = entry.dryrun_multichip(8, devices=[dev] * 8)
    log(f"mesh rag: {out}")
    return out


def mesh_phase(dev, ctx, main_line, retriever):
    """Phase 10: the mesh tier on the card (``mesh_search``,
    ``mesh_build``, ``mesh_tp``, ``mesh_rag``).  Returns the mesh line and
    the launches of each scan kernel in its searches."""
    t0 = time.perf_counter()
    search, launches = mesh_search(dev, ctx)
    build = mesh_build(dev, ctx, main_line)
    tp = mesh_tp(dev)
    rag = mesh_rag(dev, retriever)
    launches["adc_scan_tiles"] += (
        build["launches"]["adc_scan_tiles"]
        + sum(v["launches_adc_scan_tiles"] for k, v in rag.items()
              if k.endswith("_tp_mesh")))
    cards = len(on_card_mesh(MESH_RAG_AXES, dev).distinct_devices())
    return dict(mesh_distinct_cards=cards, search=search, build=build,
                tp=tp, rag=rag, phase_s=time.perf_counter() - t0), launches


# The IR phase: benchmarks/ir_quality.py's matrix at its defaults
# (:47-74): 100,000 docs, 300 test and 1,500 train queries, seed 0; the
# dual encoder at vocab 32768, dim 256, emb 192, max_len 48; 4,000 warmup
# steps at batch 128 and lr 3e-3, then 2 mining rounds of 4 negatives at
# depth 32, each followed by 2,500 steps at lr 1.5e-3; nprobe 32; k 10 and
# 100.  One cut, in depth: the training pairs are capped at 200,000 (the
# script caps them at 800,000; tokenizing a pair is host Python).  The
# corpus is generated by a child process started with the smoke, so the
# host writes it while the card runs the earlier phases.
IR_DATA = dict(n_docs=100_000, seed=0, n_queries=300, n_train_queries=1500)
IR_MODEL = dict(vocab=32768, dim=256, emb_dim=192, max_len=48)
IR_WARMUP = dict(steps=4000, batch=128, lr=3e-3)
IR_HARD = dict(steps=2500, batch=128, lr=1.5e-3)
IR_ROUNDS, IR_NEGS, IR_NPROBE = 2, 4, 32
IR_PAIR_CAP = 200_000
IR_K = (10, 100)
IR_CHECK = dict(steps=20, batch=128, lr=3e-3)   # card vs CPU, first steps
IR_CHECK_PAIRS = 4096
IR_CORPUS_WAIT_S = 900
# RESULTS.md's 100k table (the JAX package's record), NDCG@10
IR_RESULTS_100K = dict(bm25=0.521, sparse=0.372, dense_hash=0.128)
# The RAG leg: advanced_rag.py's pipeline over the same corpus, answering the
# first 32 test queries with a Dec-S reader (full width, random weights).
RAG_QUERIES, RAG_NEW_TOKENS, RAG_SAME_PROMPTS = 32, 32, 4
RAG_READER = "Dec-S"
SEQ2SEQ_QUERIES, SEQ2SEQ_DEPTH = 32, 100


class CorpusJob:
    """``write_beir_dataset`` at ``IR_DATA`` in a child process, started
    early: the generator is pure Python on one host core for minutes, and
    the card runs the earlier phases meanwhile.  ``wait`` returns the
    dataset's directory, the generator's own seconds and the seconds
    waited; ``stop`` ends the child and removes the directory."""

    def __init__(self):
        import os
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="chamjax_ir_")
        self.path = os.path.join(self.dir, "beir")
        code = ("import json, time\n"
                "from chamjax_torch.ir.synth import write_beir_dataset\n"
                "t = time.perf_counter()\n"
                f"write_beir_dataset({self.path!r}, **{IR_DATA!r})\n"
                "print(json.dumps(dict(s=time.perf_counter() - t)))\n")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait(self):
        t0 = time.perf_counter()
        out, err = self.proc.communicate(timeout=IR_CORPUS_WAIT_S)
        if self.proc.returncode:
            raise AssertionError(f"corpus generation failed: {err[-2000:]}")
        gen_s = json.loads(out.strip().splitlines()[-1])["s"]
        return self.path, gen_s, time.perf_counter() - t0

    def stop(self):
        import shutil
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()
        shutil.rmtree(self.dir, ignore_errors=True)


def result_arrays(results, qids, k):
    """BEIR result dicts → (negated scores, doc-number) arrays, best first,
    short rows padded: ascending distances, as ``tie_mismatches`` reads."""
    import numpy as np
    d = np.full((len(qids), k), np.inf, np.float64)
    i = np.full((len(qids), k), -1, np.int64)
    for r, q in enumerate(qids):
        items = sorted(results[q].items(), key=lambda kv: -kv[1])[:k]
        for c, (did, s) in enumerate(items):
            d[r, c], i[r, c] = -s, int(did.lstrip("d"))
    return d, i


def ir_oracle(name, dev, index, scfg, q, gt, got):
    """The path's IVF-PQ answers ``got`` (its packed-bf16 LUTs) against the
    ``backend="xla"`` oracle on the same index: the same index searched
    with f32 LUTs equal to the oracle up to ties (rtol 1e-5); the path's
    R@10 within 0.01 of the oracle's.  Returns the recalls."""
    import dataclasses as dc
    from chamjax_torch.config import SearchConfig
    from chamjax_torch.eval import recall_at_k
    from chamjax_torch.searcher import IVFSearcher
    k = scfg.k
    xla = IVFSearcher(index, SearchConfig(nprobe=scfg.nprobe, k=k,
                                          backend="xla"),
                      device=dev).search(q)
    f32 = IVFSearcher(index, dc.replace(scfg, lut_bf16=False),
                      device=dev).search(q)
    check_same_up_to_ties(f"{name} f32 LUTs vs xla", *f32, *xla, rtol=1e-5)
    r = dict(recall_at_10=recall_at_k(got[1], gt, 10),
             recall_at_10_f32=recall_at_k(f32[1], gt, 10),
             recall_at_10_xla=recall_at_k(xla[1], gt, 10))
    if abs(r["recall_at_10"] - r["recall_at_10_xla"]) > 0.01:
        raise AssertionError(f"{name}: R@10 {r} off the xla oracle")
    return r


def ir_pairs(corpus, tq, tqr):
    """ir_quality.py's training pairs: the top grade twice and every
    judged doc once, shuffled and capped at ``IR_PAIR_CAP``; each pair keeps
    its query id."""
    import random

    def with_qid(min_score):
        return [(qid, did) for qid, rel in tqr.items() if qid in tq
                for did, score in rel.items()
                if (score > 0 if min_score <= 0 else score >= min_score)
                and did in corpus]
    id_pairs = with_qid(2) * 2 + with_qid(0)
    n_all = len(id_pairs)
    if n_all > IR_PAIR_CAP:
        random.Random(0).shuffle(id_pairs)
        id_pairs = id_pairs[:IR_PAIR_CAP]
    return id_pairs, n_all


def ir_train(dev, corpus, tq, tqr):
    """The dual encoder as ir_quality.py trains it: warmup, then mining
    rounds on the card (the IVF-PQ branch) each followed by hard-negative
    steps.  First, the card's first ``IR_CHECK`` steps held against the
    CPU's from the same parameters."""
    import numpy as np
    from chamjax_torch.ir import DualEncoder
    from chamjax_torch.ir.models import _batch_ids, _doc_text
    id_pairs, n_all = ir_pairs(corpus, tq, tqr)
    pairs = [(tq[q], _doc_text(corpus[d])) for q, d in id_pairs]

    sub = pairs[:IR_CHECK_PAIRS]
    cpu = DualEncoder(**IR_MODEL, device="cpu")
    card = DualEncoder(**IR_MODEL, device=dev)
    card.load_state_dict(cpu.state_dict())
    want = np.asarray(cpu.fit(sub, **IR_CHECK))
    got = np.asarray(card.fit(sub, **IR_CHECK))
    fit_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if not fit_rel <= 1e-3:
        raise AssertionError(f"ir fit: card losses {got[:5]} vs CPU "
                             f"{want[:5]} (max rel {fit_rel})")
    del cpu, card

    enc = DualEncoder(**IR_MODEL, device=dev)
    t0 = time.perf_counter()
    enc._pair_tokens(pairs)
    tokenize_s = time.perf_counter() - t0

    def fit(**kw):
        t0 = time.perf_counter()
        curve = enc.fit(pairs, **kw)            # ends in a host read
        return curve, time.perf_counter() - t0

    curve, warm_s = fit(**IR_WARMUP)
    doc_ids = list(corpus.keys())
    did2idx = {d: i for i, d in enumerate(doc_ids)}
    qid_list = sorted({q for q, _ in id_pairs})
    q_of = {q: i for i, q in enumerate(qid_list)}
    positives = [set() for _ in qid_list]
    for q, rel in tqr.items():
        if q in q_of:
            for did, sc in rel.items():
                if sc > 0 and did in did2idx:
                    positives[q_of[q]].add(did2idx[did])
    t0 = time.perf_counter()
    doc_tokens = _batch_ids([_doc_text(corpus[d]) for d in doc_ids],
                            enc.vocab, enc.max_len)
    doc_tokenize_s = time.perf_counter() - t0
    pair_q = np.asarray([q_of[q] for q, _ in id_pairs])
    rounds = []
    for r in range(IR_ROUNDS):
        t0 = time.perf_counter()
        neg = enc.mine_hard_negatives(
            [tq[q] for q in qid_list], doc_tokens, positives=positives,
            n_neg=IR_NEGS, depth=8 * IR_NEGS, seed=r)
        mine_s = time.perf_counter() - t0
        info = enc.mining[-1]
        if info["branch"] != "ivfpq":
            raise AssertionError(f"ir mining round {r} took {info}")
        hard, hard_s = fit(**IR_HARD, neg_tokens=doc_tokens,
                           neg_idx=neg[pair_q])
        rounds.append(dict(mine_s=mine_s, mining=info, fit_s=hard_s,
                           loss_first=hard[0], loss_last=hard[-1]))
    steps = IR_WARMUP["steps"] + IR_ROUNDS * IR_HARD["steps"]
    fit_s = warm_s + sum(r["fit_s"] for r in rounds)
    stats = dict(pairs=len(pairs), pairs_before_cap=n_all,
                 pair_tokenize_s=tokenize_s, doc_tokenize_s=doc_tokenize_s,
                 warmup_s=warm_s, warmup_loss_first=curve[0],
                 warmup_loss_last=curve[-1], rounds=rounds, steps=steps,
                 steps_per_s=steps / fit_s, fit_check_max_rel=fit_rel,
                 fit_check_steps=IR_CHECK["steps"])
    return enc, doc_tokens, stats


def ir_phase(dev, job):
    """Phase 11a: the IR matrix (``run`` a method: its results, NDCG@10,
    MAP@100, R@100 and seconds), the launch counts set to 0 just before
    and read just after; then the checks.  Returns the ir line, the
    launches, the kernel held at the IR index's shape and what the RAG leg
    reuses."""
    import numpy as np
    import torch
    from chamjax_torch.data import compute_ground_truth
    from chamjax_torch.ir import (BM25Search, DenseRetrievalExactSearch,
                                  DenseRetrievalIVFPQSearch, DualEncoder,
                                  EvaluateRetrieval, GenericDataLoader,
                                  MaxSimReranker, SparseSearch)
    from chamjax_torch.ir.ann import _normalize
    from chamjax_torch.ir.dense import HashingEncoder
    from chamjax_torch.ir.models import DualEncoderTokenAdapter
    from chamjax_torch.utils import cuda_lib
    t_phase = time.perf_counter()
    path, gen_s, wait_s = job.wait()
    t0 = time.perf_counter()
    corpus, queries, qrels = GenericDataLoader(path).load("test")
    _c, tq, tqr = GenericDataLoader(path).load("train")
    load_s = time.perf_counter() - t0
    log(f"ir corpus {len(corpus)} docs (generated in {gen_s:.1f} s, waited "
        f"{wait_s:.1f} s), {len(queries)} queries, {len(tq)} train")
    top = max(IR_K)
    rows, results = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        res = fn()
        s = time.perf_counter() - t0
        ndcg, _map, recall, _p = EvaluateRetrieval.evaluate(qrels, res,
                                                            list(IR_K))
        rows[name] = {"NDCG@10": ndcg["NDCG@10"], "MAP@100": _map["MAP@100"],
                      "Recall@100": recall["Recall@100"], "seconds": s}
        results[name] = res
        log(f"ir {name}: {rows[name]}")

    cuda_lib.launch_counts.clear()
    run("bm25", lambda: BM25Search().search(corpus, queries, top))
    hasher = HashingEncoder(dim=256)
    run("dense_hash", lambda: DenseRetrievalExactSearch(
        hasher, device=dev).search(corpus, queries, top))
    t0 = time.perf_counter()
    enc, doc_tokens, train = ir_train(dev, corpus, tq, tqr)
    train["seconds"] = time.perf_counter() - t0
    log(f"ir training: {train}")
    run("dense_trained", lambda: DenseRetrievalExactSearch(
        enc, device=dev).search(corpus, queries, top))
    ivf = DenseRetrievalIVFPQSearch(enc, nprobe=IR_NPROBE, device=dev)
    run("ivfpq_trained", lambda: ivf.search(corpus, queries, top))
    run("sparse", lambda: SparseSearch().search(corpus, queries, top))
    run("rerank(dense_trained)", lambda: MaxSimReranker(
        token_encoder=DualEncoderTokenAdapter(enc), device=dev).rerank(
        corpus, queries, results["dense_trained"], top_k=top))
    launches = dict(cuda_lib.launch_counts)
    if launches.get("adc_scan_tiles", 0) < 1 + IR_ROUNDS:
        raise AssertionError(f"ir did not launch adc_scan_tiles (mining and "
                             f"ivfpq_trained): {launches}")

    # dense_trained: the card against the CPU, the same weights
    cpu = DualEncoder(**IR_MODEL, device="cpu")
    cpu.load_state_dict(enc.state_dict())
    qids = list(queries)
    want = DenseRetrievalExactSearch(cpu, device="cpu").search(
        corpus, queries, top)
    check_same_up_to_ties("ir dense_trained card vs CPU",
                          *result_arrays(results["dense_trained"], qids, top),
                          *result_arrays(want, qids, top), rtol=1e-5)
    del cpu
    # ivfpq_trained: its raw answers against the xla oracle
    q = ivf.query_matrix(queries)
    got = ivf.searcher.search(q)
    emb = _normalize(enc._embed_tokens("d", *doc_tokens).cpu().numpy())
    gt, _ = compute_ground_truth(emb, q, k=10, device=dev)
    oracle = ir_oracle("ir ivfpq_trained", dev, ivf.index, ivf.searcher.scfg,
                       q, gt, got)
    kernel = tiles_on_queries("adc_scan_tiles[ir]", ivf.searcher,
                              torch.as_tensor(q[:BATCH]).to(dev), IR_NPROBE)
    kernel["measured"]["seg"] = ivf.searcher.seg
    reference = {m: dict(results_md=v, port=rows[m]["NDCG@10"],
                         diff=rows[m]["NDCG@10"] - v)
                 for m, v in IR_RESULTS_100K.items()}
    line = dict(
        corpus=dict(docs=len(corpus), queries=len(queries),
                    train_queries=len(tq), generate_s=gen_s, waited_s=wait_s,
                    load_s=load_s),
        methods=rows, training=train, launches_adc_scan_tiles=launches.get(
            "adc_scan_tiles", 0), launches=launches,
        ivfpq=dict(index=ivf.index.cfg.key, seg=ivf.searcher.seg,
                   windows=ivf.searcher.windows, **oracle),
        dense_trained_card_vs_cpu="equal up to ties (rtol 1e-5)",
        results_md_100k_ndcg10=reference,
        phase_s=time.perf_counter() - t_phase)
    return dict(line=line, launches=launches, kernel=kernel["measured"],
                corpus=corpus, queries=queries, hasher=hasher,
                ivfpq=results["ivfpq_trained"])


def rag_phase(dev, ir):
    """Phase 11b: the RAG leg on the IR corpus (split → an ivfpq
    ``VectorStore`` → ``AdvancedRAG`` with MaxSim rerank and a Dec-S
    ``DecoderReader``), the launch counts set to 0 just before the answers
    and read just after; the store held to the xla oracle, the reader's
    captured tokens to eager ones; then ``Seq2SeqReranker`` over
    ivfpq_trained's top 100, the card against the CPU."""
    import numpy as np
    from chamjax_torch.config import MODEL_PRESETS
    from chamjax_torch.data import compute_ground_truth
    from chamjax_torch.ir import MaxSimReranker, Rerank, Seq2SeqReranker
    from chamjax_torch.rag import (AdvancedRAG, DecoderReader,
                                   RecursiveTextSplitter, StageTimer,
                                   VectorStore)
    from chamjax_torch.utils import cuda_lib, graphs
    t_phase = time.perf_counter()
    corpus, queries = ir["corpus"], ir["queries"]
    t0 = time.perf_counter()
    chunks = RecursiveTextSplitter(chunk_size=512).split_documents(
        list(corpus.values()))
    split_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = VectorStore(ir["hasher"], backend="ivfpq", device=dev)
    store.add_documents(chunks)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store.searcher                              # builds the index
    build_s = time.perf_counter() - t0
    reader = DecoderReader(cfg=MODEL_PRESETS[RAG_READER],
                           max_new_tokens=RAG_NEW_TOKENS, seed=0, device=dev)
    rag = AdvancedRAG(store, reader, reranker=MaxSimReranker(
        dim=128, max_tokens=32, device=dev), n_retrieved=30, n_final=5)
    qs = list(queries.values())
    rag.answer(qs[RAG_QUERIES])                 # captures: not timed
    rag.timer = StageTimer()
    cuda_lib.launch_counts.clear()
    answers = [rag.answer(q) for q in qs[:RAG_QUERIES]]
    launches = dict(cuda_lib.launch_counts)
    if launches.get("adc_scan_tiles", 0) < RAG_QUERIES:
        raise AssertionError(f"rag did not launch adc_scan_tiles a "
                             f"query: {launches}")
    for text, ctx in answers:
        if len(text.split()) != RAG_NEW_TOKENS or len(ctx) != 5:
            raise AssertionError(f"rag answer {text!r} over {len(ctx)} docs")
    stages = rag.timer.stats_ms()

    q = np.asarray(store.encoder.encode_queries(qs[:RAG_QUERIES]),
                   np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True) + 1e-9
    got = store.searcher.search(q, k=rag.n_retrieved)
    gt, _ = compute_ground_truth(store.emb, q, k=10, device=dev)
    oracle = ir_oracle("rag store", dev, store.index, dataclasses.replace(
        store.searcher.scfg, k=rag.n_retrieved), q, gt, got)
    prompts = [f"question: {x}" for x in qs[:RAG_SAME_PROMPTS]]
    captured = [reader.generate_ids(p) for p in prompts]
    with graphs.disable_capture():
        eager = [reader.generate_ids(p) for p in prompts]
    if captured != eager:
        raise AssertionError(f"rag reader captured {captured} vs eager "
                             f"{eager}")

    s2s = Seq2SeqReranker(device=dev)
    s2s_cpu = Seq2SeqReranker(device="cpu")
    s2s_cpu.enc_params.load_state_dict(s2s.enc_params.state_dict())
    s2s_cpu.dec_params.load_state_dict(s2s.dec_params.state_dict())
    sub = {qid: queries[qid] for qid in list(queries)[:SEQ2SEQ_QUERIES]}
    first = {qid: ir["ivfpq"][qid] for qid in sub}
    t0 = time.perf_counter()
    reranked = Rerank(s2s).rerank(corpus, sub, first, top_k=SEQ2SEQ_DEPTH)
    s2s_s = time.perf_counter() - t0
    pairs = [(sub[qid], (corpus[d].get("title", "") + " "
                         + corpus[d].get("text", "")).strip())
             for qid in sub for d in first[qid]]
    s_card = np.asarray(s2s.predict(pairs))
    s_cpu = np.asarray(s2s_cpu.predict(pairs))
    s2s_err = float(np.abs(s_card - s_cpu).max())
    if not s2s_err <= 1e-4 or len(reranked) != len(sub):
        raise AssertionError(f"seq2seq card vs CPU max abs diff {s2s_err}")
    line = dict(
        chunks=len(chunks), split_s=split_s, encode_s=encode_s,
        index=store.index.cfg.key, build_s=build_s, reader=RAG_READER,
        new_tokens=RAG_NEW_TOKENS, queries=RAG_QUERIES,
        stage_ms={k: dict(p50=v["p50"], mean=v["mean"])
                  for k, v in stages.items()},
        launches_adc_scan_tiles=launches.get("adc_scan_tiles", 0),
        launches=launches, store=oracle,
        reader_captured_equal_eager=True, reader_graphs=len(
            reader.cache.graphs),
        seq2seq=dict(pairs=len(pairs), rerank_s=s2s_s,
                     max_abs_diff_cpu=s2s_err),
        phase_s=time.perf_counter() - t_phase)
    log(f"rag: {line}")
    return dict(line=line, launches=launches)


def main() -> int:
    t_smoke = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        return fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    try:
        import chamjax_torch.utils.cuda_lib  # noqa: F401
    except ImportError as e:
        return fail(f"chamjax_torch is not importable beside this script: "
                    f"{e}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    corpus_job = CorpusJob()          # the IR phase's corpus, on the host
    try:
        return run_smoke(t_smoke, dev, corpus_job)
    finally:
        corpus_job.stop()


def run_smoke(t_smoke, dev, corpus_job) -> int:
    import torch
    from chamjax_torch import native
    from chamjax_torch.utils import cuda_lib, graphs
    from chamjax_torch.utils.device import card_description

    # libchamnet and adc_bench (g++) build beside the CUDA libraries (nvcc)
    t0 = time.perf_counter()
    gxx = {}
    gxx_thread = threading.Thread(target=lambda: gxx.update(
        path=native.build(), bench=native.build_adc_bench(),
        s=time.perf_counter() - t0), daemon=True)
    gxx_thread.start()
    build_logs = cuda_lib.build()
    t_nvcc = time.perf_counter() - t0
    gxx_thread.join()
    if "bench" not in gxx:
        native.build()          # raises with the compiler's output
        native.build_adc_bench()
    log(f"libchamnet built in {gxx['s']:.1f} s: {gxx['path'].name}")
    for name, text in build_logs.items():
        for line in text.strip().splitlines():
            log(f"nvcc {name}: {line}")
    log(f"kernels built in {t_nvcc:.1f} s")
    try:
        card = card_description()
    except (OSError, subprocess.SubprocessError) as e:
        return fail(f"nvidia-smi failed: {e}")
    print(card, flush=True)

    try:
        options = kernel_phase(dev)
        flat_options = flat_kernel_phase(dev)
        variant_options = variants_phase(dev)
        main = main_path(dev)
        stages = stages_phase(dev, main["ctx"])
        traced = trace_phase(dev, main["ctx"])
        with graphs.disable_capture():
            traced_eager = trace_phase(dev, main["ctx"])
        routes = routes_phase(dev, main["ctx"])
        streamed = streamed_phase(dev, main["ctx"],
                                  routes["results"]["flat_g8_bf16"])
        study = study_phase(dev, card)
        ralm = ralm_phase(dev)
        tiktok = dict(fused=tiktok_fused(dev, ralm["rec"].inner),
                      host=tiktok_host(dev, ralm["rec"].inner))
        disagg = disagg_phase(dev, main["ctx"], ralm["rec"].inner,
                              streamed["gather_path"])
        adc_bench = adc_bench_phase(main["ctx"], disagg)
        build = build_phase(dev)
        mesh, mesh_launches = mesh_phase(dev, main["ctx"], main["line"],
                                         ralm["rec"].inner)
        ir = ir_phase(dev, corpus_job)
        rag = rag_phase(dev, ir)
    except AssertionError as e:
        return fail(str(e))
    log(f"trace: {traced}")
    log(f"trace, eager: {traced_eager}")
    mk = main["main_kernel"]
    kernels = [dict(
        name="adc_scan_tiles", route="cuda",
        source="chamjax_torch/csrc/adc_scan_tiles.cu",
        replaces="chamjax/ops/scan_seg_block.py:122",
        launches=main["launches"].get("adc_scan_tiles", 0),
        max_abs_err=mk["max_abs_err"], ms=mk["ms"], plain_ms=mk["plain_ms"],
        bound_ms=mk["bound_ms"], bound_by=mk["bound_by"],
        library_ms=mk["library_ms"], library="embedding_bag",
        main_path_windows=mk["windows"], options=options,
        launches_streamed_tiled=streamed["launches"]["adc_scan_tiles"],
        launches_kernel_study=study["launches"]["adc_scan_tiles"],
        launches_ralm={r["preset"]: r["launches_adc_scan_tiles"]
                       for r in ralm["rows"]},
        launches_tiktok=dict(
            {f"fused {p}": r["launches_adc_scan_tiles"]
             for p, r in tiktok["fused"].items()},
            **{f"host {tiktok['host']['preset']} {n}":
               tiktok["host"][n]["launches_adc_scan_tiles"]
               for n in ("tiktok", "sequential")}),
        # counted by the engine processes over everything they served
        # the device-built index's searches (every nprobe) and the kernel
        # held at that index's tile width and windows
        launches_device_build=build["launches"],
        launches_mesh=mesh_launches["adc_scan_tiles"],
        # the IR matrix (mining and ivfpq_trained) and the RAG leg's answers
        launches_ir=ir["launches"].get("adc_scan_tiles", 0),
        launches_rag=rag["launches"].get("adc_scan_tiles", 0),
        ir_kernel=ir["kernel"],
        seg_device_build=build["seg"], device_build=build["kernel"],
        launches_disagg=dict(
            {"service card engine": disagg["service"]["card"]["launches"].get(
                "adc_scan_tiles", 0)},
            **{f"{e['name']} engine": e["launches"].get("adc_scan_tiles", 0)
               for e in disagg["ralm"]["engines"]}))]
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
            bound_by=rk["bound_by"], library_ms=rk["library_ms"],
            library="embedding_bag", path=rk["path"],
            main_path_windows=rk["windows"], options=flat_options[name]))
    kernels[1]["launches_mesh"] = mesh_launches["adc_scan_segments_multi"]
    kernels[3]["launches_mesh"] = mesh_launches["adc_scan_distances"]
    kernels[1]["launches_streamed_flat"] = (
        streamed["launches"]["adc_scan_segments_multi"])
    kernels[1]["launches_kernel_study"] = (
        study["launches"]["adc_scan_segments_multi"])
    # the stage profile's scans and full paths (b=128 and b=1)
    kernels[1]["launches_stages"] = (
        stages["launches"]["adc_scan_segments_multi"])
    # the measurement kernels: the row's times are the baseline body's
    # (f32; block_bf16t) at seg 2048 against its plain version; options
    # hold every variant at seg 512, 1024 and 2048; full_width_* is the
    # kernel study's (a 16M-column slab), beside its production counterpart
    for name, head, replaces in (
            ("run_variant", "f32", "benchmarks/kernel_variants.py:322"),
            ("run_block_variant", "block_bf16t",
             "benchmarks/kernel_variants.py:280")):
        rows = variant_options[name]
        h = next(r for r in rows if r["variant"] == head and r["seg"] == 2048)
        fw = next(r for r in study["variants"] if r["variant"] == head)
        kernels.append(dict(
            name=name, route="cuda",
            source="chamjax_torch/csrc/adc_scan_variants.cu",
            replaces=replaces, launches=study["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=h["ms"],
            plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=None, path="kernel study",
            full_width_ms=fw["ms"], full_width_bound_ms=fw["bound_ms"],
            full_width_counterpart=fw["counterpart"],
            full_width_counterpart_ms=fw["counterpart_ms"], options=rows))
    print(json.dumps({"kernels": kernels}), flush=True)
    # busy_share divides by the profiled window, which the profiler
    # stretches; busy_share_unprofiled divides the same kernel time a
    # search by this run's unprofiled b=128 batch time
    unprofiled = {
        suffix: (t["kernel_ms"] / t["searches"]
                 / main["line"][f"ms_per_batch_b128{suffix}"]
                 if t["busy_share"] is not None else None)
        for suffix, t in (("", traced), ("_eager", traced_eager))}
    print(json.dumps(dict(main["line"], busy_share=traced["busy_share"],
                          busy_share_unprofiled=unprofiled[""],
                          busy_share_eager=traced_eager["busy_share"],
                          busy_share_unprofiled_eager=unprofiled["_eager"],
                          trace=traced, trace_eager=traced_eager, card=card,
                          nvcc_s=t_nvcc)),
          flush=True)
    print(json.dumps(dict(stages=stages["line"], card=card)), flush=True)
    print(json.dumps(dict(routes=routes["line"], **streamed["line"],
                          card=card)), flush=True)
    print(json.dumps(dict(kernel_study=study, card=card)), flush=True)
    print(json.dumps(dict(ralm={r["preset"]: r for r in ralm["rows"]},
                          precision=ralm["precision"],
                          cache_full=ralm["cache_full"], index=ralm["index"],
                          card=card)), flush=True)
    print(json.dumps(dict(tiktok=tiktok, card=card)), flush=True)
    print(json.dumps(dict(disagg=disagg, card=card,
                          gxx_s=gxx["s"])), flush=True)
    print(json.dumps(dict(adc_bench=adc_bench, card=card)), flush=True)
    print(json.dumps(dict(build=build["line"], card=card)), flush=True)
    print(json.dumps(dict(mesh=mesh, card=card)), flush=True)
    print(json.dumps(dict(ir=ir["line"], card=card)), flush=True)
    print(json.dumps(dict(rag=rag["line"], card=card,
                          smoke_s=time.perf_counter() - t_smoke)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
