"""Fused RALM benchmark on one card: decode and IVF-PQ retrieval with no
host transfer between them (the port of ``benchmarks/ralm_device_bench.py``).

Builds a synthetic corpus and an IVF-PQ index at the model's hidden width
on the card, wires a retriever whose ``retrieve_device`` keeps queries and
results on the card, and times ``batch_inference`` over the whole fused
chain: one JSON line per (preset, interval).  By default the corpus is
``synthetic_dataset_device`` (seed 11) drawn on the card and built by
``build_ivfpq`` behind a ``LocalRetriever``; ``--streamed`` draws it in
chunks (a clustered stream, or the hard-mode corpus with ``--hard``)
through the streamed device builder (``--balance`` caps its lists) into a
tile-only index behind a ``DeviceRetriever``.  Every corpus and the model
(seed 0) draw the reference bench's threefry streams.

    python -m chamjax_torch.benchmarks.ralm_device_bench \\
        --presets Dec-S,Llama-S,EncDec-S --batch 64
    python -m chamjax_torch.benchmarks.ralm_device_bench --streamed \\
        --hard --balance 1.3

``run`` does the work and is what ``chip_smoke.py`` calls.  On the card
every stage of a step is a replay of a captured CUDA graph
(``utils/graphs.py``); the warm-up steps reach every graph key (the first
step retrieves, and a plain step replays the same decode graph as a
retrieval step) and the reset between them and the timed steps keeps the
graphs.  The timed steps run under
``torch.cuda.set_sync_debug_mode("error")``, so a stage that reads a device
value on the host fails the run, and so does a graph captured late (a
capture synchronises the card).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from chamjax_torch.config import (MODEL_PRESETS, IndexConfig, ModelConfig,
                                  SearchConfig)
from chamjax_torch import random as jr
from chamjax_torch.data import synthetic_dataset_device
from chamjax_torch.data.datasets import clustered_rows
from chamjax_torch.data.hard import GEN as HARD_GEN
from chamjax_torch.data.hard import make_hard_corpus
from chamjax_torch.index import build_ivfpq, build_ivfpq_device
from chamjax_torch.retrieval.interface import BaseRetriever
from chamjax_torch.retrieval.local import DeviceRetriever, LocalRetriever
from chamjax_torch.searcher import auto_seg
from chamjax_torch.serving.ralm import (RalmDecoder, RalmEncoderDecoder,
                                        family)
from chamjax_torch.utils import cuda_lib
from chamjax_torch.utils.device import card_description, resolve_device

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="Dec-S")
    ap.add_argument("--presets", type=str, default="",
                    help="comma list of presets sharing ONE index build "
                         "(all of one embed_dim); overrides --preset")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--interval", type=int, default=1)
    ap.add_argument("--intervals", type=str, default="",
                    help="comma list of retrieval intervals swept in one "
                         "process; overrides --interval")
    ap.add_argument("--nb", type=int, default=1_000_000)
    ap.add_argument("--nlist", type=int, default=4096)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--nprobe", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--streamed", action="store_true",
                    help="build the corpus via the streamed device builder "
                         "(100M-scale; never materializes the corpus)")
    ap.add_argument("--hard", action="store_true",
                    help="streamed: hard-mode corpus family "
                         "(chamjax_torch/data/hard.py) at the model's "
                         "hidden dim — the retrieval leg does real work "
                         "instead of saturating on an easy clustered draw")
    ap.add_argument("--n-clusters", type=int, default=0,
                    help="corpus cluster count (0: nlist for the easy "
                         "draw, 4*nlist for --hard)")
    ap.add_argument("--balance", type=float, default=0.0,
                    help="> 0: hard-capped balanced assignment at cap = "
                         "ceil(nb/nlist * BALANCE) in the streamed builder "
                         "(collapses auto_windows to ~nprobe)")
    return ap.parse_args(argv)


def model_configs(args) -> Dict[str, ModelConfig]:
    """The presets, each with ``max_seq_len`` clamped to the measured steps
    (the KV cache is allocated at max_seq_len)."""
    names = ([p for p in args.presets.split(",") if p] if args.presets
             else [args.preset])
    cfgs = {}
    for name in names:
        m = MODEL_PRESETS[name]
        cfgs[name] = dataclasses.replace(
            m, max_seq_len=min(m.max_seq_len, args.steps + args.warmup + 8))
    dims = {m.embed_dim for m in cfgs.values()}
    if len(dims) != 1:
        raise ValueError(f"--presets must share embed_dim, got {dims}")
    return cfgs


def build_retriever(args, d: int, device) -> LocalRetriever:
    """The corpus (``synthetic_dataset_device``, seed 11, clustered, drawn
    on ``device`` in ~256 MB chunks) and a balanced IVF-PQ index built on
    ``device``, behind a LocalRetriever there."""
    ds = synthetic_dataset_device(nb=args.nb, nq=8, nt=min(100_000, args.nb),
                                  d=d, seed=11, n_clusters=args.nlist,
                                  chunk=max(8192, (1 << 26) // d),
                                  parts=("xb", "xt"), to_host=False,
                                  device=device)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=d, nlist=args.nlist, m=args.m,
                                         list_pad=128, balanced=True,
                                         balance_factor=1.3),
                      xt=ds.xt, kmeans_iters=8, pq_iters=8, device=device)
    del ds                  # drop the corpus before the parameters allocate
    return LocalRetriever(idx, SearchConfig(nprobe=args.nprobe, k=args.k),
                          device=device)


def clustered_stream(d: int, n_clusters: int, seed: int, device):
    """The easy streamed corpus (the family of ``clustered_rows``) in
    ``gen``-row chunks (~256 MB): base chunk ``s`` from ``fold_in(key,
    1_000_000 + s)``, training chunk ``s`` from ``fold_in(key, 2_000_000 +
    s)``, so a draw does not depend on the caller's chunking.  Returns
    ``(draw_base, draw_train, gen)``."""
    gen = max(8192, (1 << 26) // d)
    key, rows = clustered_rows(d, n_clusters, seed, device=device)

    def stream(offset: int):
        def draw(s: int, c: int) -> torch.Tensor:
            if s % gen or c % gen or c <= 0:
                raise ValueError(f"draws align to {gen} rows; got ({s}, {c})")
            parts = [rows(jr.fold_in(key, offset + s + i), gen)
                     for i in range(0, c, gen)]
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        return draw

    return stream(1_000_000), stream(2_000_000), gen


def build_streamed_retriever(args, d: int, device) -> DeviceRetriever:
    """``--streamed``: the corpus drawn on the card (seed 11), built by
    ``build_ivfpq_device`` straight into the tiled layout at the seg that
    ``auto_seg`` picks for evenly filled lists, behind a
    ``DeviceRetriever``.  ``args.nb`` rounds down to whole draw chunks."""
    if args.hard:
        hc = make_hard_corpus(d=d, n_clusters=args.n_clusters
                              or 4 * args.nlist, seed=11, device=device)
        draw, draw_train, gen = hc.draw_base, hc.draw_train, HARD_GEN
        chunk = gen                 # at d=512 one chunk is already 2 GB
    else:
        draw, draw_train, gen = clustered_stream(
            d, args.n_clusters or args.nlist, 11, device)
        chunk = 8 * gen
    nb = args.nb = (args.nb // gen) * gen
    if nb == 0:
        raise ValueError(f"--streamed needs --nb of at least one draw "
                         f"chunk ({gen} rows at d={d})")
    nt = min(2_000_000, nb)

    def draw_xt():   # lazy: freed inside the builder after training
        return draw_train(0, -(-nt // gen) * gen)[:nt]

    seg = auto_seg(np.full(args.nlist, max(nb // args.nlist, 1)))
    index, info = build_ivfpq_device(
        draw, nb, IndexConfig(dim=d, nlist=args.nlist, m=args.m,
                              list_pad=128, balanced=args.balance > 0,
                              balance_hard=True,
                              balance_factor=args.balance or 1.3),
        draw_xt, kmeans_iters=8, pq_iters=8, chunk=chunk, verbose=True,
        tile_seg=seg, tile_only=True, device=device)
    return DeviceRetriever(index, info["list_len"],
                           SearchConfig(nprobe=args.nprobe, k=args.k,
                                        seg=seg, approx_recall_target=0.99),
                           device=device)


def make_loop(mcfg: ModelConfig, params, retriever, args, interval: int):
    if mcfg.model_type == "encoder-decoder":
        return RalmEncoderDecoder(*params, mcfg, retriever, args.batch,
                                  retrieval_interval=interval,
                                  nprobe=args.nprobe, k=args.k)
    return RalmDecoder(params, mcfg, retriever, args.batch,
                       retrieval_interval=interval, nprobe=args.nprobe,
                       k=args.k)


def init_params(mcfg: ModelConfig, seed: int, device):
    return family(mcfg).init(seed, mcfg, device=device)


@contextlib.contextmanager
def no_host_sync(device: torch.device):
    """On a card, make any host sync an error; on the CPU, nothing."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def run(args, device=None, *, inspect: Optional[Callable] = None,
        retriever: Optional[BaseRetriever] = None) -> Iterator[dict]:
    """Yields one row per (preset, interval): the reference's keys
    (``tok_per_s``, ``ms_per_step`` over the timed steps, final device sync
    included), the p50 host spans of a timed step (``p50_step_ms`` is the
    host's enqueue time of a step on the fused path,
    ``p50_warmup_step_ms`` the same over the warmup steps, which run
    without the sync check, and ``p50_retrieval_ms`` the retriever span of
    the steps that retrieve),
    the tiled scan's launches in the timed steps, and the card's name and
    power limit.  ``inspect(preset, interval, loop)``, if given, runs after
    the timed steps and its dict joins the row.  ``retriever`` reuses an
    index built before."""
    dev = resolve_device(device)
    card = card_description() if dev.type == "cuda" else "cpu"
    cfgs = model_configs(args)
    d = next(iter(cfgs.values())).embed_dim
    t0 = time.perf_counter()
    if retriever is None:
        retriever = (build_streamed_retriever(args, d, dev) if args.streamed
                     else build_retriever(args, d, dev))
    print(f"index ready in {time.perf_counter() - t0:.1f}s", file=sys.stderr,
          flush=True)
    intervals = ([int(s) for s in args.intervals.split(",") if s]
                 if args.intervals else [args.interval])
    for preset, mcfg in cfgs.items():
        params = init_params(mcfg, 0, dev)
        for interval in intervals:
            loop = make_loop(mcfg, params, retriever, args, interval)
            loop.batch_inference(args.warmup)
            warm = loop.prof.stats(args.batch)
            loop.reset_inference_state()
            cuda_lib.launch_counts.clear()
            with no_host_sync(dev):
                loop.batch_inference(args.steps)
            launches = cuda_lib.launch_counts["adc_scan_tiles"]
            stats = loop.prof.stats(args.batch)
            row = dict(
                preset=preset, batch=args.batch, interval=interval,
                nprobe=args.nprobe, k=args.k, steps=args.steps,
                tok_per_s=loop.throughput_tokens_per_sec(args.steps),
                ms_per_step=loop.total_wall_s / args.steps * 1e3,
                nb=args.nb, m=args.m,
                p50_step_ms=stats["p50_step_ms"],
                p50_warmup_step_ms=warm["p50_step_ms"],
                p50_model_ms=stats["p50_model_ms"],
                p50_retriever_ms=stats["p50_retriever_ms"],
                p50_retrieval_ms=float(np.median(
                    loop.prof.time_retriever[::interval]) * 1e3),
                launches_adc_scan_tiles=launches,
                launches_decode_attend=cuda_lib.launch_counts[
                    "decode_attend"],
                launches_encode_attend=cuda_lib.launch_counts[
                    "encode_attend"],
                no_host_sync_checked=dev.type == "cuda", card=card)
            if inspect is not None:
                row.update(inspect(preset, interval, loop))
            yield row
            del loop
        del params


def main(argv=None) -> None:
    for row in run(parse_args(argv)):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
