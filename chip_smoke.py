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
     one LUT entry; else rtol 1e-5);
   - ``threefry`` (``csrc/threefry.cu``, the JAX PRNG): every form (raw
     bits at 32/16/8, float32 and bfloat16 uniforms and normals, the
     gumbel) over 2^26 outputs whose counters start above 2^32, bit for
     bit against its plain version (the ulp bar of the float32 normal and
     gumbel is 0), its bound from the integer operations the hash needs
     (the compiler's SASS counts beside it), beside ``torch.randint`` /
     ``rand`` / ``randn`` of the same shape; ``randint``, ``permutation`` (two and three sort rounds) and
     ``choice`` on the card equal to the CPU's plain draws; each launch of
     the flagship's xb draw at its shape.
3. The main path: ``synthetic_dataset_device`` (1M x 128, 4096 clusters,
   seed 42) drawn on the card by the threefry kernel and held to
   ``FLAGSHIP_FINGERPRINT`` (the JAX package's own draw of it: shapes,
   float64 sums within 1e-6 of the sum of |x|, the first and last 4 rows
   within 1e-4), then pulled to the host; the counts set to 0 just before
   the draw and read after the build (``threefry`` must launch)
   → ``build_ivfpq`` (OPQ16 + IVF4096 + PQ16, hard-balanced) →
   ``compute_ground_truth`` (256 queries) → ``IVFSearcher.search``
   (seg=512, group=8, nprobe=32, k=100, packed-bf16 LUTs).  R@1/10/100,
   the points that overflowed every candidate cell and ``n_pad`` are
   printed beside ``BENCH_r05.json``'s record of the reference on the
   same corpus (a TPU run; not gated on).  Recall is
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
   that shape before it is timed.  Then the library column of the two
   measurement kernels at that width: ``embedding_bag`` over every window
   row of ``f32`` and ``block_bf16t`` at seg 2048, held to the kernel.
6. The RALM serving path (``chamjax_torch.benchmarks.ralm_device_bench``,
   its non-streamed leg): ``synthetic_dataset_device`` (1M x 512, 4096
   clusters, seed 11, drawn on the card) → ``build_ivfpq`` (IVF4096 +
   PQ16, balanced 1.3, 8 k-means and 8 PQ iterations) behind one
   ``LocalRetriever`` (nprobe 32, k 10: the
   tiled kernel); Dec-S and Llama-S at retrieval interval 1 and EncDec-S at
   its preset interval 8, full width in bf16 (random weights from key 0,
   the reference bench's),
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
   on the card (the JAX package's threefry streams, so its rows are the
   reference's) → ``build_ivfpq_device`` (OPQ16, IVF65536, PQ16, 2M
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
import math
import re
import socket
import subprocess
import sys
import threading
import time
import warnings

FLAGSHIP = dict(nb=1_000_000, nq=128 * 65 + 256, nt=100_000, d=128, seed=42,
                n_clusters=4096)
# bench.py's own record of the reference on this corpus (BENCH_r05.json, a
# TPU run): printed beside the card's, not gated on
BENCH_R05 = dict(recall_at_1=0.6641, recall_at_10=0.9062,
                 recall_at_100=0.9883, overflowed=15909, n_pad=1189504)
# chamjax's own synthetic_dataset_device(**FLAGSHIP) on the CPU (the test
# tests/test_torch_random.py::test_flagship_fingerprint_is_chamjax_draw
# draws it and holds it to these): each split's shape, float64 sum, sum of
# |x| and sum of squares, and its first and last 4 rows (5 decimals)
FLAGSHIP_FINGERPRINT = {
    "xb": dict(
        shape=[1000000, 128], sum=-589205.6272651453,
        sum_abs=420953302.4020745, sumsq=2174383614.8237095,
        head=[
            [
                2.45712, 5.15015, -3.31232, -0.24747, -2.80815, 8.08659,
                -5.26067, -6.94478, -2.13996, 2.92802, 4.70171, 2.91769,
                -1.37007, 6.81709, -2.86057, -3.03606, 4.61981, -1.20028,
                5.42448, 2.06706, 6.52969, 1.60749, 1.86378, 4.51189,
                0.57019, -2.79006, -5.43758, -1.65486, -0.03629, -3.29140,
                0.23896, 3.64360, 2.69769, -0.87753, 5.61982, -4.70812,
                -4.25216, 4.37925, -1.72800, 1.06109, -3.58999, -4.63215,
                -0.22927, 1.18989, 0.91684, -7.13925, 3.19695, 2.84024,
                1.94021, -4.69416, 1.26199, 1.85066, 1.11964, -2.67071,
                1.29368, -1.61309, 8.29106, -2.29342, 4.93089, -4.05627,
                4.38826, 1.75802, 3.06171, 2.07564, -1.73147, -2.46938,
                3.50556, -0.85393, 1.39979, 4.54129, 2.82271, -1.64041,
                -1.06760, -1.12067, -5.18273, 1.80549, -6.32981, -1.05634,
                -2.29504, 8.97687, -3.79412, -4.03485, 3.88320, -5.33942,
                -9.30791, 5.44165, -3.50006, 6.86428, -1.87222, -2.05490,
                2.03240, -1.21704, 2.59658, -2.54211, -1.71969, -4.36199,
                -1.12821, 6.16665, -1.79645, -1.88028, 0.93415, -0.70802,
                7.22502, 3.07517, -4.79200, -2.77786, -8.18687, -2.94246,
                4.63742, -0.99806, -3.05060, 2.01909, 1.07956, -0.13507,
                3.77076, -2.57735, 5.42920, 2.83595, 3.23737, -1.09667,
                -8.60215, -1.74928, 5.66729, 6.75181, -3.16256, 5.48012,
                -7.48036, -2.01262,
            ],
            [
                -3.20402, -0.50895, -3.00792, 2.77650, 2.56619, 5.10953,
                -4.05769, -4.72374, 1.03793, -2.86939, 11.85895, -3.26071,
                -1.18804, -3.59954, -3.95229, -0.62453, 2.16165, 1.32092,
                -1.71883, 2.02087, -1.28539, 4.14975, -1.12528, 0.05165,
                -0.23685, -1.58155, 6.98676, 8.66616, 2.63964, 3.78398,
                1.56140, -0.27272, -4.56382, 2.84032, 2.19492, 2.00554,
                -3.98981, 4.38184, 4.09473, -8.39445, 3.75402, -1.74541,
                0.45436, -0.34226, -5.47712, 4.00947, -2.29470, -3.91412,
                4.73167, 4.19937, -0.53296, -2.90858, -9.53812, 5.40536,
                -3.76497, -4.50664, 0.21026, 1.47693, 3.26076, -3.34434,
                -7.27024, 0.82894, 6.11885, -1.01520, -4.15321, -2.12425,
                -0.87648, -8.03921, -1.58652, -4.28773, 0.24921, 9.54709,
                6.40464, -0.16670, 0.84650, 5.14704, -5.93021, 4.91648,
                -2.12142, 1.55097, 6.53597, 3.80108, 1.60512, -3.06416,
                3.57909, 4.70052, 6.21786, -8.25849, 6.09056, 1.70253,
                5.59373, 6.46985, -3.04237, 2.97635, 0.44158, -7.01264,
                -4.44825, -1.78513, -1.61926, 4.09832, 3.70080, -2.94022,
                -2.41347, -0.42535, 1.28016, 0.71091, -2.88508, 4.91942,
                -0.05221, 6.46845, 0.89534, 2.72944, 5.23063, 2.21100,
                -1.59328, -0.32387, 6.32672, -2.31489, 3.22842, 3.01760,
                -0.45754, 2.92868, 4.06844, -4.03005, -1.09064, 4.69176,
                -0.29020, -5.39557,
            ],
            [
                -0.45882, -5.48490, -0.45505, -7.22118, 10.03035, 7.32970,
                1.46883, -1.74118, -1.95024, 3.35666, -1.69893, 6.42960,
                -2.26935, 2.43016, 1.17237, 5.16494, -4.63020, 2.35507,
                -7.03557, -2.60831, -2.78061, 1.33080, -2.02676, 1.86416,
                -7.53709, 3.23788, -2.75872, 3.11154, -2.46271, -4.53498,
                12.17389, -0.92780, 4.65920, -2.57946, 3.72127, 2.68105,
                4.05282, -4.02574, -1.88597, -1.05941, -0.54848, 4.48759,
                -6.59332, -1.23714, 0.32543, 2.90837, 6.71894, -1.41446,
                2.12239, -5.90007, 3.79280, -4.27514, -4.63382, -3.07622,
                -1.44940, -3.73751, -2.17684, -0.98914, -9.92172, 0.24377,
                2.62162, 1.25503, 4.45956, -4.30876, -0.71674, -0.79321,
                -2.34146, -2.58446, 0.85292, -2.02685, 4.46844, 3.81893,
                -5.50949, -2.86238, -4.81320, -0.86972, 11.95164, -1.59972,
                -1.65636, -6.88665, 1.02311, 2.69150, -2.43401, -0.75721,
                -4.90841, -1.91412, -6.10450, -3.35769, 3.76129, 7.87694,
                2.24140, 3.23206, -6.35418, 1.14293, 2.53857, 2.92706,
                1.91550, 1.12027, -3.00968, -3.73919, -7.91285, 3.98409,
                -2.74039, -5.25675, 4.67710, 1.57773, 4.34586, -3.30286,
                2.95068, -0.72720, 6.37833, -2.68368, -4.68297, 1.29119,
                2.10185, 0.01217, 2.51501, -4.61296, -0.66246, 2.85594,
                -6.97832, 3.99622, -0.97046, 3.94896, 7.87406, -3.92193,
                3.01196, -8.60384,
            ],
            [
                0.08977, -2.43856, 1.59703, -0.86737, 10.98572, 3.99782,
                -6.03248, 2.98850, 0.39892, 6.58113, -3.25563, 2.84568,
                0.18857, -4.16416, 2.13796, 5.05669, 1.04595, 10.86169,
                -0.30791, 2.49783, -0.14160, -0.57988, 1.15386, 0.00133,
                1.05816, -2.32862, -6.69478, 1.59493, -6.40206, 0.29290,
                -1.69122, -5.69587, 2.06638, 4.26044, -4.04603, 1.93853,
                -3.27637, 3.33858, -1.21073, -5.45788, -0.07203, -2.30680,
                -2.23398, 1.52290, -6.73345, -3.98903, 3.69037, -5.85327,
                0.31222, 2.30937, 0.52607, 1.42029, -1.55954, 1.22494,
                -0.81174, -3.65145, 3.22353, 6.53773, 4.61760, -0.44003,
                -1.63867, -2.68925, 1.85422, -5.74422, -3.48727, -2.00456,
                5.05208, 9.55158, 9.85866, 1.37893, 4.11702, -0.13011,
                -7.17510, -5.57574, -2.87538, -2.47643, -5.95342, -2.24474,
                0.57933, -7.67006, 0.92018, -4.96328, -4.00299, 7.65540,
                -0.00264, 8.78866, 2.20407, -6.64767, -2.86347, -0.80056,
                -0.83093, -4.21345, 0.23588, 5.85696, 2.63838, -10.21548,
                -2.63331, 0.10786, -5.68327, -6.38370, 4.07871, -2.15277,
                -0.54501, 3.76802, 1.66371, 7.88536, -4.59828, -6.44515,
                2.12957, 3.25072, 0.86413, 0.93387, 0.47722, -5.90345,
                -1.32717, -1.21000, -4.57896, 2.23088, 3.46094, 8.52486,
                4.87954, -4.78008, 1.88178, -4.98628, 3.94223, -2.79083,
                -0.99953, -4.66678,
            ],
        ],
        tail=[
            [
                -4.19765, -6.12573, -3.57760, -0.24939, 3.42200, -9.40129,
                2.09704, 2.84108, 4.24552, -0.43816, 0.83394, -4.76315,
                -5.91684, 5.02961, -1.82687, 1.75260, 1.36458, 10.06196,
                -7.20498, 7.02993, 2.14345, 2.15710, 5.27955, -3.75344,
                4.15767, 1.37595, -0.54720, -1.61506, -2.73519, 5.42962,
                3.14673, 4.82285, 6.66301, 5.66109, -0.67365, -0.53498,
                4.50201, -3.24092, -4.26144, 6.55017, -4.81397, 1.97280,
                -0.42715, -0.64541, -3.80318, -3.33441, -3.42264, 6.08789,
                -2.27389, 0.39450, 2.03282, 0.82072, 3.27336, -1.11605,
                3.43127, -6.90209, -1.70653, -0.67749, 1.93814, -2.75936,
                -1.41556, 0.20392, -2.17412, 0.00490, 0.97505, -2.52611,
                3.80011, -5.22077, 7.83747, -2.35055, 0.97262, -2.29513,
                -8.72740, 0.64430, -4.54060, -0.55369, 3.05032, -4.78991,
                9.20391, 3.88699, -1.53038, 1.74090, 1.06178, 7.85145,
                0.25931, -7.63999, -1.43121, -2.96410, -7.16287, -4.18307,
                -1.66029, -0.01182, -0.84731, -8.79111, -1.49606, 0.50645,
                0.82873, -4.74258, -2.88907, 2.07248, 4.57047, -0.43185,
                -0.16821, 8.50714, -1.71626, 3.53867, 3.07865, 1.54296,
                -3.78773, -4.30690, 3.97915, -3.97935, 1.07282, 1.76907,
                5.01424, -5.81299, -1.08557, -0.50174, 1.36655, -7.96569,
                -4.79120, 1.22208, -3.56925, -4.51273, -0.60736, 1.06331,
                -1.57068, -8.70591,
            ],
            [
                0.32400, 4.07366, 3.47131, 1.83984, 2.75456, -1.93388,
                -2.01970, 6.30374, -2.49503, -2.14954, 1.04739, 4.25234,
                4.50394, -9.79631, -4.38075, 3.70569, 1.43023, 0.13219,
                -1.51393, -1.62082, -5.57252, -0.66653, 1.62662, 2.93246,
                -3.17666, 7.18597, -5.81153, 3.06582, -2.15500, 3.75098,
                3.92689, 0.25358, 0.16532, -5.25478, -0.10532, -3.03801,
                -5.57054, -1.86306, -4.69696, 6.02448, 8.85535, 4.00177,
                5.79675, -3.05721, 5.78756, 3.02128, 6.99782, 4.51725,
                0.99837, 1.11166, 1.58633, 2.02634, 3.45390, 0.88695,
                1.07194, -1.62385, 4.03081, 3.24077, 2.49595, -2.39092,
                -0.37132, 7.40071, -4.45550, -4.61509, 2.55628, -3.39512,
                5.21897, -2.63956, 2.31313, 1.73774, 0.01657, -6.75046,
                2.54429, -3.42352, 3.52416, 3.07598, 0.97995, -0.18493,
                2.28314, -1.43000, -3.46262, -2.53680, 8.08228, -4.30154,
                -2.98158, 3.22389, 0.20673, -0.12038, -0.03635, 2.96665,
                -6.67114, -2.09802, 1.40653, -5.80629, -0.18981, -1.85699,
                -1.94007, 4.69234, 1.48501, -0.97499, -4.75564, 2.70813,
                -0.61245, -2.82794, -0.76078, -0.13411, 1.37315, -4.72363,
                1.78797, 6.32119, -1.52307, 5.70079, -8.38544, -5.93261,
                0.40252, -1.41822, -0.66388, -3.34261, 1.27526, 1.15384,
                -9.88391, -1.43092, -0.02608, -9.62245, -5.64576, 3.69982,
                -0.76512, 7.08666,
            ],
            [
                -2.09563, -2.66428, 6.07287, -3.71045, 3.57646, 3.84134,
                6.03577, -1.68691, 4.98838, 5.06335, 1.01990, -4.94259,
                5.60274, 3.21286, 0.67376, 0.38332, 0.31577, 6.87441,
                -3.28146, 2.92802, -2.38431, 7.04087, -5.20994, 0.21787,
                -2.64896, -2.09200, 6.28677, 2.33384, -7.85401, 1.69741,
                7.43379, 4.32719, 1.69973, 1.18238, -5.38704, -0.14037,
                -7.15464, -5.13700, 4.49171, -1.87172, 4.82790, -3.30148,
                -0.50730, 1.87840, 5.91509, -2.68392, -4.14090, 1.34733,
                2.18036, -0.22585, 1.07768, 3.83371, -0.09096, -2.24250,
                8.39877, -4.34938, -1.84821, 7.46322, 3.81772, -0.76979,
                4.73794, 7.73463, -0.88324, 4.47712, -4.84608, 6.70804,
                4.84599, -5.85199, 0.93915, 0.47270, -8.37246, 0.14008,
                -3.26089, -3.57223, 3.86361, -1.21259, 4.95038, 4.78036,
                1.53617, -6.82678, 4.19781, -4.42622, -10.16458, -1.69725,
                7.96498, 5.66124, 3.98340, -2.37068, 2.79085, -0.97709,
                7.12502, -3.56075, -2.82834, -1.14364, 5.68002, 5.48511,
                -1.07328, 3.77235, 3.64670, -0.30871, 8.28022, 2.87424,
                -4.46180, -0.78069, -0.63364, 0.96589, 1.36168, -3.71217,
                3.58657, -2.54172, 4.80093, 4.33144, -2.08767, 1.23852,
                2.21754, -2.40170, 0.88132, -7.94267, -2.16057, 6.46625,
                -0.55476, 5.84401, -2.89806, 0.87274, 4.48336, 10.59086,
                -3.33778, 0.36467,
            ],
            [
                1.42134, -4.72355, -3.05888, 7.06536, -2.23759, -1.98103,
                4.54155, -2.09119, 1.85399, -0.87134, -1.47119, 1.92638,
                5.91470, -1.63586, 3.40363, -4.18316, -2.58308, -2.22585,
                1.21098, 2.60403, -6.88856, -10.95021, 2.52675, -3.82045,
                0.60172, 4.62359, -4.49592, 5.63032, -4.63907, 3.88157,
                -2.92896, -2.55125, -1.91852, -4.40501, -0.71749, 0.17682,
                -3.54900, -0.25547, 8.45155, -1.97741, 3.62211, 0.30723,
                0.44358, 4.74755, -1.61503, 10.05920, -2.17278, -6.13817,
                0.67431, -1.16403, 0.92249, -4.79440, 2.24960, 8.22114,
                3.62035, -8.72775, -4.14878, 0.45688, -0.50664, 2.08044,
                -1.94473, 0.73393, -2.24202, 3.15512, -5.75507, -3.30839,
                -1.02362, 6.91707, 8.32956, 6.98165, -6.89663, 1.40320,
                -2.83359, -4.05591, 8.83636, 3.85518, -2.40909, -1.35442,
                2.74536, 6.29103, -2.23944, -2.61150, -1.67884, 5.62333,
                3.14720, 0.04231, 1.76854, 7.84371, 2.57906, 2.68488,
                -3.59141, 3.33718, -3.15534, 0.55238, 0.18588, 8.40726,
                0.85119, -6.20273, -4.70902, 5.10523, 0.72761, 1.28669,
                -6.22489, -2.76628, -4.73653, -2.19996, -1.50066, -1.51401,
                -10.64505, 0.23532, -1.75596, 0.74127, 0.98573, -4.91151,
                -1.57843, 0.05048, -3.72705, -1.84452, -2.88237, 5.17708,
                -4.58439, -5.74107, -6.46531, -1.07882, 3.45099, 6.66593,
                4.47339, -1.06602,
            ],
        ],
    ),
    "xt": dict(
        shape=[100000, 128], sum=-38643.15148999033,
        sum_abs=42111894.91771828, sumsq=217600532.6150698,
        head=[
            [
                2.92068, -4.79266, -0.64829, -3.10888, -11.10872, -4.67017,
                7.06577, 6.99343, 0.79462, 1.80626, 7.06418, 3.19859,
                1.26311, -1.12575, 1.53729, -1.80709, 1.05155, -1.53869,
                -4.14464, 8.17653, 0.50247, 1.92236, 6.47918, 7.30815,
                5.58735, -9.05602, -7.19230, 3.24918, 4.61595, 4.44321,
                -6.37121, -2.12061, -2.42878, 5.09106, 6.44320, 2.68156,
                4.02383, 0.15521, 1.77613, 2.22915, -0.73753, -6.84621,
                -2.75154, 4.94368, 4.70622, 2.97187, -6.17419, -5.90767,
                -1.93201, -2.30228, -1.50496, 0.99062, -4.14216, 0.31657,
                -5.20328, 2.44680, 2.93165, -1.70870, 14.86884, -1.37999,
                0.68732, -2.86286, -7.56828, 2.59557, 0.59777, -9.75571,
                -3.86176, -5.16946, 1.16029, 8.84461, -3.67690, 0.12430,
                3.95503, -0.61769, -4.03781, -1.81574, -8.53043, 4.28563,
                4.25910, 2.16698, 0.76994, 6.19233, -5.10946, -4.24114,
                8.95612, 0.72055, -6.59536, 2.53913, 2.63029, -1.80207,
                -5.66450, -10.00470, 0.02671, -4.76844, 4.21210, -4.92487,
                3.56548, 5.12940, -6.37124, -6.68878, 0.58184, 3.43010,
                2.67675, -0.36909, -2.25868, -3.33615, -1.50422, -1.34344,
                5.97306, 2.80083, 0.72046, -3.97493, -1.51946, -0.54147,
                -0.10838, 5.90970, 2.27309, 8.65839, 3.41238, 3.89037,
                -7.69888, 6.03291, 0.98757, 3.66117, -4.77369, 4.94757,
                -1.66620, 3.45160,
            ],
            [
                1.64814, -1.13295, -1.94094, 3.70365, 9.62263, -0.59051,
                -1.90851, 1.89050, -0.55908, 1.97307, 5.18123, 3.33726,
                -0.48495, 0.64026, 0.56865, -4.13684, -2.10036, -1.66164,
                -2.95644, -0.61155, -6.47298, 6.58621, 7.63058, 8.76960,
                -3.31808, 0.26521, 4.40128, -1.49127, -2.71995, -3.61056,
                4.83730, 2.88786, -3.71925, 1.52418, 2.01513, -5.15742,
                0.77716, 5.67644, -0.29902, -1.12476, 0.52695, -1.99087,
                -4.60689, -8.70669, 0.12150, 1.24596, -3.15557, 2.64404,
                -6.54951, 7.55474, -5.07653, -0.52674, 5.63924, 4.76796,
                0.47554, 5.58261, 2.59094, 0.15158, -5.25037, 1.06403,
                -1.15063, -4.01366, -1.54394, 3.03141, 3.06442, 0.47256,
                5.08750, 6.49696, -9.16100, 0.44964, -2.84326, -2.84098,
                4.45376, 2.92801, 1.06393, -1.10581, 7.48860, 3.87366,
                2.10481, 12.01983, 3.48031, 1.30360, -0.00331, 4.50503,
                0.85491, -2.71862, -10.51751, -1.09855, -4.34475, 1.18043,
                -4.90557, -5.89177, -5.33237, 1.55171, 3.83501, 1.55346,
                -1.57732, -4.41937, 5.32880, 3.81902, 1.61351, -4.95760,
                -2.01349, -7.99692, -3.56418, -6.65480, 2.42036, -4.87944,
                -6.61396, 0.47662, 2.67444, 4.04379, -3.53541, 0.61157,
                -1.24611, 4.64520, 1.39293, -1.87821, 0.71323, 1.41606,
                6.02713, -0.12770, -2.46458, 4.84617, 4.11286, 3.89156,
                0.04667, 2.66323,
            ],
            [
                0.75641, 0.59240, 4.13492, -2.36713, 3.38544, -1.88950,
                3.82429, 4.86366, 4.82874, -2.01045, 2.15002, 7.30365,
                -1.99476, -5.15274, 0.71140, -2.57975, 4.55807, 4.14100,
                7.77020, -2.41118, 0.95469, -4.43468, -3.61196, -4.59238,
                0.04643, -3.80808, -0.67651, -1.17484, 2.52752, 0.01429,
                -1.13909, 6.26512, -3.75298, 4.16706, -6.49547, -2.78027,
                2.33628, -2.77167, -7.06306, -0.03896, 4.21544, -0.79168,
                -0.34809, 1.61084, 3.97522, 4.00806, -0.95662, 4.13419,
                -3.27370, 3.15269, -2.48762, 0.29335, 5.38371, -0.42830,
                -8.11411, 2.50268, 4.26490, -2.76140, -5.04449, 0.27526,
                -3.74623, -4.31841, -3.23815, -1.15818, -7.73920, 0.14370,
                -0.95275, 0.50830, -1.23645, -0.69038, -7.12283, -1.38176,
                -2.85383, -0.53552, -1.28918, -1.65989, -0.81377, -1.90708,
                3.42174, -8.54505, -4.87953, 1.14709, -3.89841, 3.05216,
                2.15716, 0.35109, -1.03437, 5.66737, 2.93827, 2.30795,
                1.19961, 6.36878, -3.58482, -2.32933, -0.42633, -2.13604,
                -1.78236, -0.31003, 0.89696, -8.03278, -3.45113, 0.92049,
                -0.12408, 1.71865, 5.03726, -6.59281, 6.17557, -4.20047,
                2.14662, -0.79130, 6.38111, -9.63486, 1.38133, -0.82660,
                -6.98543, 5.76694, 2.81390, 4.56290, 6.06408, 1.72423,
                4.58192, 5.75869, -2.47228, -2.15426, -0.91748, 8.70867,
                2.02116, -4.15837,
            ],
            [
                0.95305, -6.30713, -8.90977, -0.97633, -4.22919, -4.59470,
                -8.04655, -1.14779, -1.95886, -5.49575, 8.00103, 4.76246,
                -4.36383, 4.91433, -12.09068, 6.15271, -2.28768, 4.60342,
                2.81180, 2.93244, -7.62239, 7.04022, 0.48360, -3.43225,
                0.34035, 3.72361, -4.99390, -3.02200, 1.69063, 0.51378,
                3.76087, -0.12661, 0.49687, 7.67103, 3.32930, -4.76694,
                -2.79140, 1.22159, 0.40675, 2.13742, -7.85973, 4.11351,
                1.00980, 1.06723, 3.16563, 0.57315, -7.89633, -1.52209,
                1.34385, 3.60104, 0.45197, 0.03802, 0.70927, -0.48106,
                3.21542, -1.36695, 4.65352, 4.72665, 1.69040, 8.32201,
                5.46383, 2.21915, -1.87830, 2.62321, 3.12244, 3.64692,
                -1.51911, 1.77343, -10.22558, -1.81010, 9.70737, -7.01653,
                0.40163, -5.20955, 3.19084, -5.20124, -5.17890, 6.98246,
                -0.01121, 4.82191, -10.52272, -5.30634, -1.09896, -0.76968,
                3.70651, 7.13866, 0.21519, -3.06835, 7.67431, -3.43847,
                1.12282, 2.65526, 0.09902, 4.49698, 0.15383, -0.41467,
                -6.67368, -3.45124, -2.52142, 2.91380, -3.40124, -1.95790,
                -0.97554, 9.87787, -4.72749, -10.18646, -5.00790, 4.53923,
                -4.77372, 4.86669, -1.52546, -4.39554, 4.79899, -0.57784,
                4.02485, -6.92554, 5.77135, 1.85214, 2.92294, 1.63864,
                -5.86662, 7.49443, 5.51219, -6.78293, -4.48101, -1.88655,
                -2.68488, -1.75226,
            ],
        ],
        tail=[
            [
                -0.43440, 0.75755, 1.73570, -7.02285, 1.63666, 1.43273,
                -0.25944, 0.17643, -3.22096, -3.19568, 4.45265, 5.68963,
                3.57776, -2.46749, -4.21884, -2.49262, -1.65632, 5.11770,
                -8.10390, 1.12351, 2.93438, 1.83668, 3.94407, 3.04505,
                5.30664, 0.95193, -3.06930, 1.03800, 4.55550, -4.07207,
                7.56587, -1.47642, -4.66332, -0.75681, 1.12079, 3.99091,
                -0.17692, -8.39338, 0.84224, 3.10719, 4.36171, 4.04278,
                -4.31372, -3.49921, -0.46974, -1.27056, 4.29519, -5.18832,
                -6.54446, 1.72739, 7.68323, 4.09832, -0.29516, -4.81485,
                -0.87028, 3.96066, -1.53193, -0.24439, -3.38073, 1.20121,
                7.59296, -7.12763, -3.68671, 0.77818, 7.28062, 3.31296,
                -2.93601, -2.29990, 7.55216, -1.76328, -3.48500, 3.15611,
                1.96447, 2.00768, -5.48815, 0.00533, 4.96069, -4.44583,
                -2.30077, 0.82521, -4.55888, 0.75960, -10.47626, -6.62687,
                -1.71022, 2.43897, -2.54734, 3.38743, 0.00252, -5.25756,
                4.32300, 4.42980, -0.27996, 1.76103, -2.52227, 0.30498,
                2.78974, 3.18856, 0.83503, -5.53770, -10.58333, -3.14941,
                1.77438, -4.17452, 6.85935, 5.17493, -2.00925, 0.84011,
                0.51692, 3.38504, 7.57434, 3.59933, 4.46071, -3.17861,
                -3.32786, -1.73468, 2.51957, -5.73758, -8.33220, 3.18986,
                -0.35221, 10.84847, 1.89346, -2.27260, -0.68982, -4.83233,
                -6.06696, -2.94834,
            ],
            [
                6.11730, -1.97082, -6.96261, 5.48206, -2.38507, 5.72659,
                -2.34222, -3.83269, 1.66067, -0.59976, 7.12463, -0.95353,
                -0.66235, 0.80232, -4.93725, -2.37266, 4.44538, 1.62894,
                -6.81728, 7.19326, -4.43392, -1.92279, 7.01106, 1.73890,
                -0.13904, 6.94719, -6.62508, 1.62975, 1.37276, 6.19461,
                -6.92997, -2.24870, 3.49900, -4.09742, -0.49381, 2.91085,
                -5.52858, -0.61169, -0.74566, 1.64292, 0.19700, -0.63805,
                -1.03168, -2.06470, 0.04446, 1.27741, 1.89821, 1.25442,
                -8.65307, -3.94525, 0.80269, 11.20170, -2.52781, -0.47963,
                -4.62106, 9.14794, -9.58775, 7.25355, -6.25904, -0.87763,
                1.23793, -2.64485, 0.91796, 1.88245, -5.21893, 6.80463,
                3.09704, 3.33942, 2.52648, 1.45606, 0.18727, -0.54128,
                -2.59670, -5.14540, 1.79578, -2.05660, -0.52451, 0.28709,
                -3.19507, -4.08217, 1.53524, 0.53818, -0.57438, -1.63295,
                2.17750, 2.53594, -3.88977, 2.48479, 0.29838, 0.66314,
                0.47659, 4.17417, 2.55872, 3.40958, 6.64100, 9.08680,
                0.89311, -0.50398, 2.95028, -3.65826, -3.20600, 4.59152,
                1.99670, -1.87247, -9.29223, -2.08794, -0.95181, 0.50958,
                -0.17131, -3.15450, -7.99460, -1.17511, 5.58462, 1.62125,
                -3.86729, -3.55032, -3.71734, -7.05400, -6.99732, -0.05558,
                0.17329, 0.68367, 5.15594, -7.46782, -4.26216, 8.84677,
                -4.40555, -1.69932,
            ],
            [
                -5.68269, -8.01463, 2.17985, -2.73457, 2.85857, -5.33418,
                8.47903, -4.52902, 0.89347, -3.07563, 4.84707, 3.16158,
                -2.59928, 3.46679, -2.59024, 7.06601, 8.98652, -2.12199,
                -9.65839, -1.00979, 6.24338, 3.48451, 1.65740, -3.27106,
                -1.23011, -2.05799, -1.06484, 3.72581, 6.97142, 4.99375,
                -1.96243, 1.87250, 1.65005, 1.89178, -4.02609, -7.97683,
                6.57376, -5.12983, 3.46176, -4.09978, 7.05244, -0.55590,
                -2.61351, -0.00809, -3.21089, 0.21589, -0.73385, 2.96354,
                -3.40834, 8.06926, -1.77176, -3.80353, -0.14574, 1.89999,
                -7.18162, 2.28177, 5.93749, 2.79596, 5.35958, -4.38856,
                0.55747, 3.16618, -6.58455, 1.87099, -2.88019, 3.63424,
                -6.41920, 1.08887, 0.13136, -2.75807, -1.67786, 0.53235,
                -4.70947, 5.43349, 6.35148, -3.84404, -2.00680, -3.78433,
                3.84297, 4.17811, 5.59824, 2.23156, 2.44335, 3.70908,
                -2.04002, -0.09814, 0.36158, -1.82560, 0.58832, 2.21631,
                2.90009, 2.88703, -0.30014, 1.77044, 3.53763, -2.63020,
                -0.30861, 4.12608, -1.82425, 2.79148, -1.21450, -3.45956,
                -4.49770, 4.41390, 4.75777, -4.53148, -5.56246, -0.21692,
                -0.97081, -0.22420, 7.49932, -0.44383, -2.49149, -0.87750,
                7.27808, 1.78609, -2.63042, 3.07882, 1.27541, 4.70924,
                -0.82810, -8.18773, -6.55746, 6.20812, -0.93933, -2.14318,
                -6.31380, -5.78516,
            ],
            [
                0.33516, 6.28994, 3.52717, 8.67678, -0.02472, -5.01770,
                1.87225, -4.42136, 2.39733, 1.92795, 0.28908, 7.29936,
                -0.48307, -2.79713, -4.37933, -7.83633, -2.09945, -1.89561,
                2.78475, 3.27640, 2.04481, 1.23893, -4.59277, -4.28135,
                2.86607, -4.62303, 1.17632, 3.45476, -4.19231, 2.29992,
                2.95348, 5.98421, -2.90366, 5.39933, 1.36512, 3.70425,
                3.57208, -2.32082, 4.37084, 4.40787, -2.76940, -4.58602,
                1.86191, -4.87968, 3.61099, -1.17013, 0.69731, -3.05187,
                -1.90346, 10.14301, -1.66992, 2.33648, -3.87933, -2.54261,
                -5.85535, 4.85927, -6.51123, -7.54879, 2.65171, 0.69196,
                0.34558, -0.80249, 2.90214, 1.47577, 1.60829, -7.55328,
                1.97406, -4.45855, 1.81934, -0.69624, -3.27010, -6.44973,
                -1.30982, -5.09556, 0.76515, -0.17042, 6.41357, 1.96254,
                -4.94103, -1.73128, -2.23553, -4.40466, -3.24327, -0.82346,
                -3.11756, -8.10209, -3.94877, 6.45936, 0.92117, 3.13517,
                -3.09010, 5.61813, 8.39154, 5.77726, 0.41591, -6.93171,
                2.98411, 7.95162, -3.61709, -3.71511, -6.86413, -2.64417,
                2.57247, -0.50485, -0.94479, 8.08266, 3.29894, 3.48842,
                2.97118, -1.02224, -5.60984, 6.55740, -0.54865, 0.98654,
                -1.36668, -5.98129, 5.74406, -0.20264, -1.80481, 4.93846,
                9.06250, -3.83450, 1.45008, -2.99552, 2.75094, -2.92664,
                -3.25523, -2.81362,
            ],
        ],
    ),
    "xq": dict(
        shape=[8576, 128], sum=56.46475185451618,
        sum_abs=3609160.0236733123, sumsq=18634827.550208203,
        head=[
            [
                -0.49783, -1.05164, 6.26439, -2.51540, -5.83040, 2.09139,
                -1.30716, -2.08654, -1.96885, -4.48038, 3.40530, -3.81621,
                7.72671, -2.46237, 3.81387, 2.08688, 0.21948, 4.71396,
                4.82486, -3.12624, 1.29354, 7.44130, 1.43363, 3.00839,
                -2.70803, -0.93442, 0.44227, 2.73689, 3.08257, -3.59283,
                0.17944, -1.15261, -0.58858, -5.04213, 8.51987, 0.80652,
                5.42850, -4.41111, -5.33933, -1.07352, 0.34198, -2.95446,
                7.00230, 9.00396, 0.33954, -5.17892, -0.11478, -0.69996,
                2.50814, 0.66501, -5.99858, -3.61316, -3.46789, 4.66791,
                -0.56215, 2.30240, -0.74370, 0.86841, 2.97246, 1.35952,
                6.61554, -4.42928, -1.47428, -5.14168, -6.03273, 0.00913,
                -5.25292, -3.52781, 2.06372, 3.05761, -3.76724, 3.42295,
                -7.89362, -3.59593, 7.58065, 7.28055, 8.91826, -0.44631,
                1.14827, -6.39590, 8.64526, -0.62243, -1.15859, -3.24769,
                4.28225, 2.43324, 1.59089, 0.96795, -1.43335, -5.73666,
                -1.12677, -6.49420, -3.02220, -1.34765, -2.23284, 2.40393,
                -5.89709, -4.71437, 1.44717, 4.24161, 2.32232, -0.98350,
                6.23197, 0.24079, -1.00805, -1.12012, -0.25509, -1.82938,
                -5.01702, -0.97700, -0.72417, 0.16293, 2.79298, 3.47704,
                -5.25746, 2.29403, 5.07793, 2.04419, 0.91760, 4.29429,
                -2.60634, 0.88230, 6.54730, -10.69581, -4.72879, 3.07528,
                -4.59915, -1.09737,
            ],
            [
                -2.57967, 0.84259, 6.11202, 6.18268, -9.15894, 2.50258,
                -6.32209, 2.30625, -1.95046, -3.76312, 8.29914, 1.91447,
                -1.35063, -1.37039, -8.57120, 9.12282, -4.13262, -3.47349,
                7.25076, 2.99906, -1.31996, 2.30888, 0.12601, -1.14630,
                -6.57642, 4.19920, -0.00289, -1.97204, 2.25091, -4.58920,
                -0.29489, -3.99178, -6.16859, 3.72308, 5.16295, 0.39083,
                3.60727, -2.93289, 1.90471, 5.06510, -5.48860, -3.36635,
                -7.61737, 2.36050, 0.16481, -4.01025, -1.99329, 1.21916,
                -0.89672, 1.27437, -5.22713, -2.71088, -10.01216, 7.96832,
                -8.72752, 8.39518, -1.66093, -1.82287, 4.39612, 1.28703,
                -0.03564, -4.00099, -0.75928, -3.71502, 3.94656, 2.79973,
                -1.16927, 4.27237, -3.98746, 2.37180, 2.92346, -2.09361,
                -4.78804, -2.15839, 1.96338, -1.75078, -2.42062, -4.62587,
                -0.54881, 4.17422, -4.15993, 6.10369, -1.13482, 3.08127,
                -0.07624, 6.46919, -5.94758, -1.77359, 8.76504, -6.06442,
                5.11401, -2.04117, -2.01544, -1.92407, -7.58750, 2.14617,
                1.37438, 0.08623, -0.28306, -0.54295, -1.89471, -7.95206,
                -2.25725, 2.98535, 1.03170, 5.57784, 6.75122, 1.13109,
                6.53487, 4.12844, 1.90256, 1.41771, -8.63673, -0.68738,
                0.31507, -3.56481, 7.74226, -4.35803, 4.54143, 5.53367,
                3.18297, 1.30582, 2.46536, 1.54184, -1.92306, -4.49913,
                -2.58254, 3.88008,
            ],
            [
                -2.99537, 1.90059, 13.59341, 1.06253, 7.99903, -4.15886,
                3.04514, 6.47319, -3.81703, 3.73424, 10.72563, -10.05940,
                0.13221, 11.71317, -1.40585, 1.91403, -3.27501, -2.07247,
                0.28481, -1.25954, 5.76679, 3.05262, -2.18505, 9.26355,
                -3.68381, -0.21277, -6.40792, -9.67086, -3.11241, 1.69911,
                -3.24645, -7.73350, -5.86535, -0.53091, 1.27792, -0.83913,
                1.98170, 4.61367, -0.84039, -2.92347, -7.82657, 7.33609,
                -3.81544, 1.95170, -2.79820, -1.14169, 8.55773, 9.46148,
                5.34739, 1.10101, -2.83775, 1.45617, 2.43461, 6.07581,
                0.06454, -1.24392, -0.16973, 0.17520, -10.81436, 3.67551,
                4.32795, -3.87799, -5.45622, 7.69495, -4.55601, -4.76970,
                -2.87974, 1.00981, 0.70002, 0.96376, -1.87008, 1.12308,
                2.38769, -2.32376, 5.28305, 1.16700, -8.33043, -4.92044,
                3.72026, 3.30448, -5.54394, 3.31437, -9.98170, -7.13867,
                -1.16661, -0.43822, -5.93501, 2.26674, -2.37699, 1.92555,
                -7.39020, 5.57729, 1.41337, 2.42220, 3.67730, -0.08598,
                8.93445, 3.93330, 5.48787, -1.89818, -8.05818, 1.62473,
                1.09715, -1.14127, 11.94235, -0.66360, -11.75284, -3.42587,
                -4.84558, 3.88868, -3.83090, -5.91550, -4.19914, 1.77657,
                0.75867, 0.13521, -5.39319, -4.56186, 0.25102, -5.33617,
                -5.08295, -1.69339, 1.70309, 1.92627, 0.49223, 4.20735,
                -1.46147, 4.89673,
            ],
            [
                -1.89344, 3.45304, 2.75346, -2.22677, -2.99487, 0.29776,
                7.37579, 0.61013, 1.46373, 0.65318, -3.79718, -2.61425,
                3.74238, -4.89546, -0.24755, -2.21281, 3.70264, -2.30288,
                6.59947, 6.50483, 1.49312, -2.09225, 0.37282, -4.80245,
                -5.05312, 2.51136, -2.03167, -1.36066, 2.82453, -1.16564,
                5.66798, -0.23880, -0.13873, 2.98663, -6.97885, -11.03052,
                -0.25253, -2.88226, -5.97336, -8.30753, -0.16843, -5.58388,
                5.79521, 12.38239, 0.55730, -1.15866, -0.29054, 3.36090,
                4.19281, -4.42756, 1.21762, -4.77961, 2.82535, -0.31764,
                -1.76205, 2.35314, 0.88507, 3.25411, -2.52036, 2.17020,
                -2.11168, -6.55799, -4.02898, -7.83710, 0.00637, -3.99956,
                -6.22236, 3.84769, -9.67524, 3.87508, -4.50036, -2.73089,
                3.14046, 0.88625, 7.85202, 4.32255, -0.89172, -5.80658,
                0.41991, -3.37311, 5.43119, -2.58013, -0.98754, 1.38361,
                0.11367, -0.12220, 1.33130, 2.77494, 1.66162, 2.09414,
                0.20673, -0.78004, -3.71640, 2.12092, -2.66593, 5.90443,
                4.48687, 1.84523, -2.67967, -0.58248, 7.94696, -3.50345,
                4.80488, -0.69508, 3.83276, -1.07694, -6.76066, 1.74989,
                5.06920, 7.43240, -1.62910, -2.34651, 2.74127, -6.24549,
                4.55440, -9.94600, 4.72531, 0.13771, -0.84306, -6.77497,
                5.40737, 2.42554, 2.37754, -5.02293, 1.78892, -0.87926,
                1.34108, 5.51531,
            ],
        ],
        tail=[
            [
                -1.87631, -4.47014, 5.06295, 2.89384, -0.36314, -3.35141,
                -2.97510, -0.09868, 6.80072, -2.00177, 3.92863, -1.21575,
                -1.56653, -2.22269, 0.96850, -1.81930, 2.12758, -4.32498,
                11.18684, -4.99407, 3.27568, -4.23906, -3.27693, -1.60842,
                -0.98304, -1.71683, 1.92802, 4.89299, -5.88883, -2.57348,
                -2.62848, 3.39223, -0.84995, 5.36506, 4.41922, -3.17844,
                0.99603, -1.04326, 0.49687, -4.71706, -6.74928, 0.42717,
                -1.09548, -0.93530, -2.76054, 0.97809, -1.44688, -4.32945,
                0.95907, -3.56778, -3.44573, -6.40937, -2.33758, 1.78706,
                -0.09749, 5.88114, -4.30961, 3.67602, -4.17095, -1.82421,
                -3.34996, 1.91443, -4.20904, 0.87358, 0.88967, -1.11396,
                -4.26223, 2.27115, -4.74973, 1.56066, -5.70538, 1.66608,
                0.25437, -5.81409, -8.94244, 2.07237, -1.59200, 6.29075,
                -3.26586, 3.55434, -4.20377, -4.56864, -5.70865, -4.79778,
                -3.83716, -2.79490, 9.22850, -2.83161, -2.85772, 0.87355,
                2.62654, -0.04674, 4.99991, -6.76652, -0.94042, -1.77297,
                0.83920, 2.71330, -4.21748, -7.31544, 0.80206, 0.62400,
                -2.22703, -5.38385, 2.67618, 1.32421, -4.01928, 4.95723,
                4.74351, 3.00946, -1.85879, -6.70116, -1.32770, 2.70699,
                -2.79394, 9.63445, 10.76931, -2.42949, 2.12880, -1.40057,
                6.87937, 9.77968, 3.91445, 1.48118, 0.69164, 7.10052,
                -1.00057, -0.74908,
            ],
            [
                -2.54183, 1.79569, -3.44795, 6.06005, 0.36233, 1.07852,
                -7.39569, -2.27971, -1.47700, 1.88050, 1.21740, -2.30372,
                -2.02400, -0.53254, -5.21972, -0.77418, 3.68415, 5.15074,
                0.91631, 5.06443, -5.56288, 0.82159, 0.48449, -3.26668,
                6.04223, -1.01724, -4.12941, -3.41010, 1.94295, 2.73836,
                -5.52750, 3.67279, -2.51559, -5.21846, -0.81605, 6.20549,
                -3.31648, -2.35058, -0.28592, -5.24105, -0.68526, -8.50239,
                0.79910, 0.11534, 3.45289, 2.02770, 8.10406, 1.70593,
                -0.71584, -0.58945, -3.29211, 0.96522, -1.24112, -2.16744,
                3.07404, -4.37435, 7.96217, -3.08551, -1.03982, 2.99457,
                -5.40299, 0.67023, -3.58139, -3.06866, -4.11264, -7.65289,
                -0.29635, 3.96973, 7.31653, -0.37429, -2.63932, -0.86886,
                8.60386, 0.18724, 3.87248, 1.12918, -6.49777, 2.93497,
                -3.30872, 6.12980, -1.03386, 1.40843, 2.31040, -0.54379,
                1.19601, 4.73422, 3.22862, -12.31886, 9.09907, 1.95349,
                10.43696, -2.88687, 0.61442, 1.87511, 0.90299, 3.13513,
                3.87854, -4.72222, -3.74534, 3.98091, 4.59177, 3.54865,
                0.94375, -6.26996, -1.81213, -2.63368, -2.94237, -0.77603,
                2.02619, 1.70235, 3.67129, 5.22713, -0.50588, 1.28218,
                12.19958, -3.03963, -0.05860, -2.57525, 1.58560, 2.66529,
                0.95263, 4.95914, 0.97644, 0.16608, 3.63754, -8.26850,
                -4.36746, -3.50297,
            ],
            [
                -3.21635, 3.45301, -0.43711, -0.20147, -6.42914, -2.93305,
                -1.22352, -5.85516, 2.53803, 2.78162, -1.47525, -4.18037,
                1.55635, 5.85264, -3.16058, -6.85771, -4.87915, 4.13455,
                1.27593, 0.50637, 1.70697, 3.31555, -3.09402, -0.57399,
                7.74527, -5.17076, 4.32810, -6.51695, -3.73296, 7.58617,
                5.31585, -2.08934, 1.94307, -3.91156, 1.12764, 8.76962,
                2.96349, 3.81951, -4.79649, -9.18254, 0.39608, -3.71315,
                8.37894, -1.13509, 2.93571, -5.34443, 0.60862, -1.34485,
                -3.81399, -0.43915, 7.31947, -4.26052, -1.31039, -1.33386,
                1.82462, -2.42797, 7.53844, -0.93572, -9.69295, 9.59598,
                5.11192, -6.37377, -5.25325, -9.76741, -3.06880, 0.27957,
                8.90297, 0.29151, -2.14295, -1.91957, 3.88029, -4.43254,
                -5.67276, 8.36146, -1.47492, -4.34414, 0.50491, 2.32768,
                -5.61821, 7.25002, -0.34039, 4.86299, -6.46899, -7.68636,
                -0.45662, -1.30292, 3.30546, 0.72795, 5.00926, -0.47108,
                -1.14655, -0.55059, -7.11489, -4.82176, 2.79655, 2.44743,
                -1.80272, -6.53754, 2.53964, -0.24594, -3.81138, -1.22292,
                1.22179, 3.35829, -4.22561, -2.17933, -4.64766, 0.20643,
                -4.68608, 0.19728, 4.14211, 1.79688, -1.57142, 4.52311,
                -1.00624, 0.32100, 6.11555, -0.03182, 1.77753, -2.50193,
                -4.81230, -1.07248, 5.35403, 2.42179, -2.72183, -4.83091,
                1.41978, 1.07020,
            ],
            [
                2.10414, -6.23672, 1.74616, -6.23763, 0.24795, 7.54640,
                6.24453, 1.40754, -4.46349, -4.19749, -2.58480, -3.52942,
                -4.43590, 1.31031, -5.93268, 3.16341, -3.05267, 0.91742,
                -0.80818, 3.67740, 8.72464, 2.65196, 1.01626, -3.22393,
                -7.41276, -2.49220, 1.17784, -4.83780, -4.14938, -2.56619,
                0.84066, -1.11390, -2.75394, 3.41204, 2.73415, 5.57554,
                -7.99287, 2.99498, -3.45072, -0.97185, -1.67715, -8.37605,
                -0.35641, -7.02183, 6.63321, -0.17192, -0.45894, -5.80690,
                -1.85657, -4.13159, -3.05356, 7.70546, 6.01778, -0.99839,
                -5.51617, -1.02342, -6.65758, 5.29493, 0.95266, 0.11295,
                -1.89542, 1.05319, -2.04327, 4.04314, -2.22553, -7.26684,
                -2.63477, -10.84939, 5.92059, -1.73592, 4.17431, -1.53985,
                -4.04438, 6.98800, -1.91954, -3.01422, 0.68428, 0.85963,
                6.93635, -1.60746, -0.87890, 5.60002, 2.46519, 0.64446,
                -1.41887, -4.38130, 2.03570, -4.54941, 3.90171, -2.85537,
                3.14443, 5.09492, -0.05067, -1.44795, 0.49267, 4.29004,
                1.69615, -0.71327, -7.70586, -5.68206, -10.97542, -10.25308,
                2.95203, 0.90795, 8.11172, 4.15300, -3.70066, 0.20325,
                -0.24549, -2.50372, -1.55105, -0.54181, -5.16238, 3.26594,
                2.06897, 1.29054, -4.05536, -2.00342, -2.17887, 3.20382,
                -4.57048, 0.38883, 2.71587, -1.68872, -0.28824, 0.73088,
                -1.16223, 4.46821,
            ],
        ],
    ),
}


def fingerprint_errors(fp: dict) -> list:
    """What in ``fp`` (a split's ``shape``, ``sum``, ``sum_abs``,
    ``sumsq``, ``head`` and ``tail`` rows) differs from
    ``FLAGSHIP_FINGERPRINT``: the sums by more than 1e-6 of the sum of |x|
    (the sum of squares of itself), a row entry by more than 1e-4."""
    errors = []
    for part, want in FLAGSHIP_FINGERPRINT.items():
        got = fp[part]
        if list(got["shape"]) != want["shape"]:
            errors.append(f"{part} shape {got['shape']}")
            continue
        for name, scale in (("sum", want["sum_abs"]),
                            ("sum_abs", want["sum_abs"]),
                            ("sumsq", want["sumsq"])):
            if not abs(float(got[name]) - want[name]) <= 1e-6 * scale:
                errors.append(f"{part} {name} {got[name]} vs {want[name]}")
        for name in ("head", "tail"):
            err = max(abs(float(g) - w)
                      for grow, wrow in zip(got[name], want[name])
                      for g, w in zip(grow, wrow))
            if not err <= 1e-4:
                errors.append(f"{part} {name} rows off by {err}")
    return errors

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


def device_fingerprint(ds) -> dict:
    """``fingerprint_errors``' view of a draw whose splits are tensors:
    the sums in float64 on their device, the first and last 4 rows."""
    out = {}
    for part in ("xb", "xt", "xq"):
        x = getattr(ds, part).double()
        out[part] = dict(shape=list(x.shape), sum=float(x.sum()),
                         sum_abs=float(x.abs().sum()),
                         sumsq=float((x * x).sum()),
                         head=x[:4].cpu().tolist(),
                         tail=x[-4:].cpu().tolist())
        del x
    return out


def overflowed(caught) -> int:
    """The points ``assign_balanced(hard=True)`` reports as having
    overflowed every candidate cell (its warning), 0 without one (it warns
    above n/200)."""
    for w in caught:
        m = re.search(r"(\d+)/\d+ points .*overflowed", str(w.message))
        if m:
            return int(m.group(1))
    return 0


def main_path(dev):
    """Phase 3: the port's IVF-PQ query path at the 1M flagship, its corpus
    drawn on the card by ``synthetic_dataset_device`` (the threefry
    kernel) and held to ``FLAGSHIP_FINGERPRINT``."""
    import numpy as np
    import torch
    from chamjax_torch.config import IndexConfig, SearchConfig
    from chamjax_torch.data import (Dataset, compute_ground_truth,
                                    synthetic_dataset_device)
    from chamjax_torch.eval import recall_at_k
    from chamjax_torch.index import build_ivfpq
    from chamjax_torch.ops.coarse import select_probes
    from chamjax_torch.ops.lut import build_luts
    from chamjax_torch.ops.scan_seg import expand_windows, prepare_luts
    from chamjax_torch.ops.scan_seg_block import adc_scan_tiles
    from chamjax_torch.ops.topk import select_topk
    from chamjax_torch.searcher import IVFSearcher, _rotate
    from chamjax_torch.utils import cuda_lib, graphs

    # counts from 0: the draw and the build launch the threefry kernel
    cuda_lib.launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drawn = synthetic_dataset_device(**FLAGSHIP, to_host=False, device=dev)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    fp_errors = fingerprint_errors(device_fingerprint(drawn))
    if fp_errors:
        raise AssertionError(f"the card's flagship draw is not chamjax's: "
                             f"{fp_errors}")
    t0 = time.perf_counter()
    ds = Dataset(name="SYN", **{p: getattr(drawn, p).cpu().numpy()
                                for p in ("xb", "xq", "xt")})
    t_pull = time.perf_counter() - t0
    del drawn
    nb, d, nlist, m = FLAGSHIP["nb"], FLAGSHIP["d"], 4096, 16
    cfg = IndexConfig(dim=d, nlist=nlist, m=m, list_pad=128, opq=True,
                      balanced=True, balance_hard=True,
                      balance_factor=512 * nlist / nb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        idx = build_ivfpq(ds.xb, cfg, xt=ds.xt, kmeans_iters=10,
                          pq_iters=10, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    draw_launches = dict(cuda_lib.launch_counts)
    n_over = overflowed(caught)
    log(f"dataset drawn on the card in {t_data:.2f} s (= chamjax's draw: "
        f"FLAGSHIP_FINGERPRINT held), pulled to the host in {t_pull:.2f} s; "
        f"build {t_build:.1f} s, max list {int(idx.list_len.max())}, cap "
        f"{int(np.ceil(nb / cfg.nlist * cfg.balance_factor))}, overflowed "
        f"{n_over}, n_pad {idx.n_pad}; threefry launches "
        f"{draw_launches.get('threefry', 0)}")
    if draw_launches.get("threefry", 0) < 1:
        raise AssertionError(f"the flagship draw did not launch threefry: "
                             f"{draw_launches}")
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
    log(f"flagship on bench.py's corpus: R@1/10/100 "
        f"{rec['recall_at_1']:.4f} / {rec['recall_at_10']:.4f} / "
        f"{rec['recall_at_100']:.4f}, overflowed {n_over}, n_pad "
        f"{idx.n_pad}; the reference's record (BENCH_r05.json, TPU, "
        f"approximate top-k): {BENCH_R05}")
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
        draw_launches=draw_launches,
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
            dataset_s=t_data, dataset_pull_s=t_pull, build_s=t_build,
            ground_truth_s=t_gt, max_list_len=int(idx.list_len.max()),
            overflowed=n_over, n_pad=idx.n_pad,
            corpus="synthetic_dataset_device(**FLAGSHIP) on the card = "
                   "chamjax's (FLAGSHIP_FINGERPRINT)",
            reference_record_bench_r05=BENCH_R05,
            launches_draw_and_build=draw_launches))


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


THREEFRY_N = 1 << 26                 # phase 2's draws
THREEFRY_START = (1 << 32) + 12345   # their counters: the hi word set
# the samplers' sizes: the flagship's randint chunk, the hard corpus's
# choice over 2^20 rows (two sort rounds), a permutation of three rounds
THREEFRY_SAMPLER_N = (1_000_000, 1 << 20, 2_700_000)
# the flagship's draw (synthetic_dataset_device(**FLAGSHIP)): an xb chunk
# is two 32-bit draws (randint), the latent normal and the scaled noise
FLAGSHIP_DRAWS = (("u32", (1_000_000,), 1.0),
                  ("u32", (1_000_000,), 1.0),
                  ("normal_f32", (1_000_000, 32), 1.0),
                  ("normal_f32", (1_000_000, 128), 0.05))


def threefry_library(form: str, shape, dev):
    """The one PyTorch call that draws the same shape and type (another
    stream, the same work): ``torch.randint``, ``rand`` or ``randn``; a
    gumbel has none."""
    import torch
    calls = {
        "u32": lambda: torch.randint(-2 ** 31, 2 ** 31, shape,
                                     dtype=torch.int32, device=dev),
        "u16": lambda: torch.randint(-2 ** 15, 2 ** 15, shape,
                                     dtype=torch.int16, device=dev),
        "u8": lambda: torch.randint(0, 256, shape, dtype=torch.uint8,
                                    device=dev),
        "uniform_f32": lambda: torch.rand(shape, device=dev),
        "uniform_bf16": lambda: torch.rand(shape, dtype=torch.bfloat16,
                                           device=dev),
        "normal_f32": lambda: torch.randn(shape, device=dev),
        "normal_bf16": lambda: torch.randn(shape, dtype=torch.bfloat16,
                                           device=dev)}
    return calls.get(form)


def bit_view(t):
    """A tensor's bits as integers of its width."""
    import torch
    return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[t.element_size()])


def threefry_row(dev, form, n, *, start=0, scale=1.0, bounds=(0.0, 1.0)):
    """One draw of ``n`` outputs in ``form``: the kernel held bit for bit
    against its plain version on the card, both timed (``device_ms``; the
    plain version, hundreds of launches, by ``time_ms``), beside the bound
    and the library call of the same shape."""
    import torch
    from chamjax_torch import random as jr
    from chamjax_torch.benchmarks.bounds import threefry_bound
    key = jr.fold_in(jr.key(42), 7)
    kw = jr.draw_params(form, *bounds, scale=scale)

    def call():
        return jr.threefry_draw(key, n, form, start=start, device=dev, **kw)

    def plain():
        return jr.threefry_draw_reference(key, n, form, start=start,
                                          device=dev, **kw)
    got = call()
    torch.cuda.synchronize()
    want = plain()
    differ = int((bit_view(got) != bit_view(want)).sum())
    err = float((got.double() - want.double()).abs().max()) if n else 0.0
    if differ:
        raise AssertionError(f"threefry {form}: {differ} of {n} outputs "
                             f"differ from the plain version (max abs err "
                             f"{err})")
    out_bytes = got.numel() * got.element_size()
    del got, want
    ms = device_ms(call)
    plain_ms = time_ms(plain, reps=5, warmup=1)
    bound_ms, bound_by = threefry_bound(n, out_bytes)
    lib = threefry_library(form, (n,), dev)
    library_ms = device_ms(lib) if lib is not None else None
    row = dict(form=form, n=n, start=start, scale=scale, differing=differ,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms)
    log(f"threefry {form} n={n} start={start}: bit-equal to the plain "
        f"version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), library {library_ms} ms")
    return row


def threefry_phase(dev):
    """Phase 2, the threefry kernel: every form over 2^26 outputs whose
    counters start above 2^32, bit for bit against its plain version on
    the card (float32 normal and gumbel too: the ulp bar is 0), timed
    beside its bound (the integer operations the hash needs at the card's
    integer rate, against the bytes written; the raw-bits kernel's SASS
    counts by pipe beside it, as what the compiler emitted) and beside the
    ``torch.randint`` / ``rand`` / ``randn`` call of the same shape; then
    the samplers built on its bits (``randint`` at the flagship's chunk,
    ``permutation`` in two and three rounds, ``choice``) on the card
    against the plain versions on the CPU; then each launch of the
    flagship's xb draw at its shape.  Returns the rows, or raises."""
    import torch
    from chamjax_torch import random as jr
    from chamjax_torch.benchmarks.bounds import (THREEFRY_ADDS,
                                                 THREEFRY_INT_ONLY)
    from chamjax_torch.benchmarks.sass_report import library_pipe_counts
    kernels = library_pipe_counts("threefry")
    log(f"threefry SASS by pipe: {kernels}")
    # the raw 32-bit form (kBits32 = 0): the hash and the store alone,
    # its integer instructions an output against the bound's
    bits32 = re.compile(r"threefry_kernel(?:ILi0E|<(?:\(int\))?0>)")
    pipes = next(v for k, v in kernels.items() if bits32.search(k))
    per_output = max(THREEFRY_INT_ONLY,
                     (THREEFRY_INT_ONLY + THREEFRY_ADDS) / 2)
    log(f"threefry raw bits: {pipes} instructions an output emitted, "
        f"{per_output} on the busier pipe in the bound")
    forms = [threefry_row(dev, form, THREEFRY_N, start=THREEFRY_START,
                          bounds=(-3.0, 5.5) if form.startswith("uniform")
                          else (0.0, 1.0))
             for form in jr.FORMS]
    samplers = {}
    n1, n2, n3 = THREEFRY_SAMPLER_N
    for name, draw in (
            ("randint", lambda d: jr.randint(11, (n1,), 0, 4096, device=d)),
            ("randint_u8", lambda d: jr.randint(11, (16, n2), 0, 256,
                                                torch.uint8, device=d)),
            ("permutation_2_rounds", lambda d: jr.permutation(11, n2,
                                                              device=d)),
            ("permutation_3_rounds", lambda d: jr.permutation(11, n3,
                                                              device=d)),
            ("choice", lambda d: jr.choice(11, n2, 8192, device=d))):
        got = draw(dev)
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), draw("cpu")):
            raise AssertionError(f"threefry sampler {name}: the card's draw "
                                 f"differs from the CPU's")
        samplers[name] = dict(n=got.numel(), equal_cpu=True,
                              ms=time_ms(lambda: draw(dev), reps=5))
        log(f"threefry sampler {name}: card = CPU, {samplers[name]['ms']:.3f}"
            f" ms (host clock around the call)")
    flagship = [threefry_row(dev, form, math.prod(shape), scale=scale)
                for form, shape, scale in FLAGSHIP_DRAWS]
    return dict(forms=forms, samplers=samplers, flagship=flagship,
                sass_per_output=pipes, bound_ops_per_output=per_output)


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


def variant_library(dev):
    """The library column of the measurement kernels (rows 5 and 6 of the
    kernels line) at the kernel study's full width (a 16M x m16 slab,
    bW=4096, n_lut=4096, seg 2048, the windows ``kv.study`` draws): one
    ``embedding_bag`` over the flat LUT indices of every window row
    (``library_scan``), held against the kernel's output (rtol 1e-5) and
    timed beside it, for each row's baseline body (``f32`` and
    ``block_bf16t``).  The launches here compare; the study counted
    before.  Returns {kernel: dict(ms=, library_ms=)}."""
    import torch
    from chamjax_torch.benchmarks import kernel_variants as kv
    args = kv.parse_args(["--variants", "f32", kv.BLOCK_VARIANT])
    data = kv.make_data(args, dev)
    seg = args.segs[0]
    starts = torch.randint(0, (args.n - seg) // 512, (args.bw,),
                           generator=data["gen"], device=dev,
                           dtype=torch.int32) * 512
    lens = torch.full((args.bw,), seg, dtype=torch.int32, device=dev)
    out = {}
    for name, variant in (("run_variant", "f32"),
                          ("run_block_variant", kv.BLOCK_VARIANT)):
        cd, st = kv.inputs_for(data, variant, seg, starts)
        packed = kv.packed(variant)
        lt = data["luts_p"] if packed else data["luts"]
        call = (cd, st, lens, data["lut_idx"], lt)
        if variant == kv.BLOCK_VARIANT:
            got = kv.run_block_variant(*call, seg=seg, group=GROUP)
        else:
            got = kv.run_variant(*call, seg=seg, group=GROUP,
                                 variant=variant)
        torch.cuda.synchronize()
        codes = kv._window_codes(cd, st.long(), seg, variant)  # (bW, m, seg)
        rows = codes.permute(0, 2, 1).reshape(-1, codes.shape[1])
        del codes
        w, c = scan_rows(lens, seg)
        lut_row = data["lut_idx"].long()[w]
        ms = device_ms(lambda: kv.launch(variant, cd, st, data["lut_idx"], lt,
                                         seg=seg))
        library_ms = library_scan(f"{name}[{variant}] full width", got, w, c,
                                  rows, lut_row, lt, packed)
        out[name] = dict(variant=variant, seg=seg, ms=ms,
                         library_ms=library_ms)
        log(f"{name}[{variant}] full width seg {seg}: kernel {ms:.4f} ms, "
            f"embedding_bag {library_ms:.4f} ms")
        del rows, w, c, lut_row, got
    return out


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
    configuration over its 1M rows (the flagship corpus in host memory),
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
        threefry = threefry_phase(dev)
        main = main_path(dev)
        stages = stages_phase(dev, main["ctx"])
        traced = trace_phase(dev, main["ctx"])
        with graphs.disable_capture():
            traced_eager = trace_phase(dev, main["ctx"])
        routes = routes_phase(dev, main["ctx"])
        streamed = streamed_phase(dev, main["ctx"],
                                  routes["results"]["flat_g8_bf16"])
        study = study_phase(dev, card)
        study_library = variant_library(dev)
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
            bound_by=h["bound_by"],
            library_ms=study_library[name]["library_ms"],
            library="embedding_bag at full width (16M slab, seg 2048)",
            library_kernel_ms=study_library[name]["ms"], path="kernel study",
            full_width_ms=fw["ms"], full_width_bound_ms=fw["bound_ms"],
            full_width_counterpart=fw["counterpart"],
            full_width_counterpart_ms=fw["counterpart_ms"], options=rows))
    # the draws: no Pallas kernel on the TPU (XLA generates threefry2x32);
    # the row's times are the flagship's largest draw (its 1M x 128 noise)
    noise = threefry["flagship"][-1]
    kernels.append(dict(
        name="threefry", route="cuda",
        source="chamjax_torch/csrc/threefry.cu",
        replaces="jax/_src/prng.py:1184",
        replaces_note="XLA's threefry2x32 and jax/_src/random.py's "
                      "samplers; no pallas_call on the TPU",
        launches=main["draw_launches"].get("threefry", 0),
        max_abs_err=max(r["max_abs_err"]
                        for r in threefry["forms"] + threefry["flagship"]),
        ms=noise["ms"], plain_ms=noise["plain_ms"],
        bound_ms=noise["bound_ms"], bound_by=noise["bound_by"],
        library_ms=noise["library_ms"], library="torch.randn",
        path="main path: the flagship draw and the build's k-means++",
        flagship_xb_chunk_ms=sum(r["ms"] for r in threefry["flagship"]),
        flagship_draws=threefry["flagship"], options=threefry["forms"],
        samplers=threefry["samplers"],
        sass_per_output=threefry["sass_per_output"],
        bound_ops_per_output=threefry["bound_ops_per_output"]))
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
