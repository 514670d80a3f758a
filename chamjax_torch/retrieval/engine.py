"""A retrieval engine as a process of its own: a ``RetrievalServer`` over a
saved index, the engine node of the disaggregated topologies (the
reference's ``FaissServer`` / ChamVS node behind a coordinator or an index
server).

    python -m chamjax_torch.retrieval.engine --index IDX.npz --port 7001 \\
        [--backend local|native] [--device cuda|cpu] [--with-lists] \\
        [--connections N] [--batch 64] [--warm 64,1] \\
        [--search-cfg '{"nprobe": 32, "k": 10}']

``backend="local"`` serves ``LocalRetriever`` (the IVF-PQ search on
``device``, the card unless ``"cpu"``; with lists,
``ivfpq_search_preassigned``); ``"native"`` serves ``NativeCPURetriever``
(the host C++ engine, f32 LUTs: the reference's ``--backend cpu``).  The
engine searches once at every batch size in ``warm`` before it listens, so
its graphs are captured before the first request; clients and
coordinators retry their connects until it listens.  It serves
``connections`` connections one after another, then exits.

Started from Python with ``multiprocessing``'s spawn context (a process
that has touched the card must not fork), ``run_engine`` puts one message
on ``report`` as it ends: ``("done", {"served", "launches"})`` with the
batches it answered on each connection and the kernel launches of serving
(``cuda_lib.launch_counts`` after the warm-up), or ``("failed",
traceback)``.
"""

from __future__ import annotations

import argparse
import json
import traceback
from typing import Optional, Sequence

import numpy as np

from chamjax_torch.config import SearchConfig
from chamjax_torch.index.ivf import PackedIVF
from chamjax_torch.utils.device import resolve_device


def _warm(retriever, dim: int, nlist: int, scfg: SearchConfig,
          batches: Sequence[int], with_lists: bool) -> None:
    for b in batches:
        q = np.zeros((b, dim), np.float32)
        if with_lists:
            lids = np.arange(b * scfg.nprobe).reshape(b, scfg.nprobe) % nlist
            retriever.retrieve_with_lists(q, lids, scfg.k)
        else:
            retriever.retrieve(q, scfg.nprobe, scfg.k)


def run_engine(index_path: str, port: int, *, host: str = "127.0.0.1",
               backend: str = "local", device=None,
               search_cfg: Optional[SearchConfig] = None, batch: int = 64,
               with_lists: bool = False, connections: int = 1,
               warm: Sequence[int] = (), report=None) -> dict:
    """Serve ``index_path`` on ``host:port`` (see the module's text).
    Returns ``{"served", "launches"}``."""
    try:
        import torch

        from chamjax_torch.retrieval.local import (LocalRetriever,
                                                   NativeCPURetriever)
        from chamjax_torch.retrieval.server import RetrievalServer
        from chamjax_torch.utils import cuda_lib

        scfg = search_cfg or SearchConfig()
        packed = PackedIVF.load(index_path)
        if backend == "local":
            device = resolve_device(device)
            if device.type == "cuda":
                torch.cuda.set_device(device)
            retriever = LocalRetriever(packed, scfg, device=device)
        elif backend == "native":
            retriever = NativeCPURetriever(packed, scfg)
        else:
            raise ValueError(f"backend={backend!r}: local or native")
        _warm(retriever, packed.cfg.dim, packed.cfg.nlist, scfg, warm,
              with_lists)
        if backend == "local" and device.type == "cuda":
            torch.cuda.synchronize(device)
        cuda_lib.launch_counts.clear()
        server = RetrievalServer(retriever, host, port, batch_size=batch,
                                 dim=packed.cfg.dim, nprobe=scfg.nprobe)
        server.start(n_connections=connections, with_lists=with_lists)
        out = dict(served=server.served,
                   launches=dict(cuda_lib.launch_counts))
    except Exception:
        if report is not None:
            report.put(("failed", traceback.format_exc()))
        raise
    if report is not None:
        report.put(("done", out))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--index", required=True, help="a PackedIVF .npz")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--backend", choices=("local", "native"),
                    default="local")
    ap.add_argument("--device", default=None,
                    help="local backend: cuda (the default) or cpu")
    ap.add_argument("--batch", type=int, default=64,
                    help="rows of a plain request (with lists: any)")
    ap.add_argument("--with-lists", action="store_true",
                    help="serve preassigned requests (an index server's)")
    ap.add_argument("--connections", type=int, default=1)
    ap.add_argument("--warm", default="",
                    help="comma list of batch sizes captured before "
                         "listening")
    ap.add_argument("--search-cfg", default="{}",
                    help="SearchConfig fields as a JSON object")
    args = ap.parse_args(argv)
    out = run_engine(
        args.index, args.port, host=args.host, backend=args.backend,
        device=args.device,
        search_cfg=SearchConfig(**json.loads(args.search_cfg)),
        batch=args.batch, with_lists=args.with_lists,
        connections=args.connections,
        warm=[int(b) for b in args.warm.split(",") if b])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
