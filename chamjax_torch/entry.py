"""Entry points: the single-device search step and the multi-device RAG step
(the port of ``__graft_entry__.py``).

``entry()``              → ``(fn, args)``: the flagship-shaped IVF-PQ
                           search step over a small device-resident index;
                           on a card each call replays a captured graph.
``dryrun_multichip(n)``  → build an n-position mesh (dp × tp × lists),
                           shard the decoder (TP + DP) and the inverted
                           lists (the streamed builder, tiled), run ONE RAG
                           serving step (decode, then the 2-D mesh search
                           with the hidden state as the query) and hold its
                           outputs.

Where the JAX package finds fewer devices than asked it switches to a
virtual CPU mesh on its own; here the caller places the positions
(``devices=["cuda:0"] * 8`` is 8 positions on one card), and without them
the call raises unless that many cards are present.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from chamjax_torch.utils.device import resolve_device


def entry(device=None):
    """Returns ``(fn, args)``: ``fn(*args)`` is one search of 8 queries
    (nprobe 8, k 10, the segmented flat scan with 4 windows a step and
    packed-bf16 LUTs) over a 20k-row index built on ``device`` (the card
    unless ``"cpu"``)."""
    from chamjax_torch.config import IndexConfig
    from chamjax_torch.data import synthetic_dataset
    from chamjax_torch.index import build_ivfpq
    from chamjax_torch.searcher import (DeviceIVF, auto_seg, auto_windows,
                                        ivfpq_search)

    dev = resolve_device(device)
    ds = synthetic_dataset(nb=20_000, nq=8, nt=4000, d=64, seed=0,
                           n_clusters=64)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=64, nlist=64, m=8, list_pad=128),
                      xt=ds.xt, kmeans_iters=4, pq_iters=4, device=dev)
    index = DeviceIVF.from_packed(idx, device=dev)
    seg = auto_seg(idx.list_len)
    windows = auto_windows(idx.list_len, seg, 8)
    windows += (-windows) % 4          # the group divides the window count

    def fn(index, queries):
        return ivfpq_search(index, queries, nprobe=8, k=10, windows=windows,
                            seg=seg, group=4, backend="seg", lut_bf16=True)

    return fn, (index, torch.from_numpy(ds.xq).to(dev))


def mesh_axes(n_devices: int):
    """``dryrun_multichip``'s layout: dp 2 × tp 2 × lists n/4 where 4
    divides n, else tp 2 × lists n/2 where 2 does, else lists n."""
    if n_devices % 4 == 0:
        return (("dp", 2), ("tp", 2), ("lists", n_devices // 4))
    if n_devices % 2 == 0:
        return (("dp", 1), ("tp", 2), ("lists", n_devices // 2))
    return (("dp", 1), ("tp", 1), ("lists", n_devices))


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     device=None) -> dict:
    """Run one full RAG serving step over an ``n_devices``-position mesh and
    hold its outputs; returns a summary.

    ``devices`` places the positions (e.g. ``["cuda:0"] * 8``); ``None``
    takes the first ``n_devices`` cards and raises if there are fewer.
    ``device`` is where the model is made and the index built before they
    are placed (default: the mesh's first position)."""
    from chamjax_torch.config import IndexConfig, ModelConfig
    from chamjax_torch.data import synthetic_dataset
    from chamjax_torch.index import build_ivfpq_device_sharded
    from chamjax_torch.models import decoder_step, init_decoder, init_kv_cache
    from chamjax_torch.parallel import (make_mesh, place_sharded,
                                        shard_decoder_params, shard_kv_cache,
                                        sharded_search_2d)
    from chamjax_torch.parallel.sharded_search import captures

    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip: {n_devices} cards asked, {have} present; "
                "pass devices explicitly (e.g. ['cuda:0'] * n) for a mesh "
                "of positions on fewer cards")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for {n_devices} positions")
    axes = mesh_axes(n_devices)
    mesh = make_mesh(axes, devices=devices)
    build_dev = resolve_device(device) if device is not None else \
        mesh.device_at()

    # tiny model, tensor-parallel (the heads divide tp)
    cfg = ModelConfig(model_type="decoder", embed_dim=64, ffn_embed_dim=128,
                      layers=2, attention_heads=4, vocab_size=128,
                      max_seq_len=16, dtype="float32")
    params = shard_decoder_params(init_decoder(0, cfg, device=build_dev),
                                  mesh)
    batch = 4
    cache = shard_kv_cache(init_kv_cache(cfg, batch, device=build_dev), mesh)

    # tiny index over `lists`, built by the streamed builder straight into
    # the tile-aligned shard layout: the tiled scan runs on every shard
    ds = synthetic_dataset(nb=4000, nq=batch, nt=2000, d=cfg.embed_dim,
                           seed=0, n_clusters=16)
    xb = torch.from_numpy(ds.xb).to(build_dev)
    sh, _info = build_ivfpq_device_sharded(
        lambda s, c: xb[s:s + c], ds.nb,
        IndexConfig(dim=cfg.embed_dim, nlist=16, m=8, list_pad=128),
        torch.from_numpy(ds.xt).to(build_dev), mesh.shape["lists"],
        kmeans_iters=2, pq_iters=2, chunk=2048, block=256, tile_seg=256,
        device=build_dev)
    if sh.codes_tiled is None:
        raise AssertionError("the dryrun must run the tiled scan")
    sh = place_sharded(sh, mesh)
    tokens = torch.ones((batch,), dtype=torch.int32,
                        device=params.embed.device)

    # 1. decode one token (dp batch, tp heads); 2. the 2-D mesh search with
    # the hidden state as the query: queries over dp, lists over `lists`,
    # packed-bf16 LUTs, the two-stage coarse scan
    logits, hidden, cache = decoder_step(params, tokens, cache,
                                         cfg.attention_heads)
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    dists, ids = sharded_search_2d(
        sh, hidden.float(), mesh=mesh, batch_axis="dp", nprobe=4, k=5,
        windows=16, seg=256, group=2, use_approx=True, backend="seg",
        lut_bf16=True, select_l1=16, coarse_cand=8)
    if next_tokens.shape != (batch,):
        raise AssertionError(f"tokens {tuple(next_tokens.shape)}")
    if dists.shape != (batch, 5) or ids.shape != (batch, 5):
        raise AssertionError(f"top-k {tuple(dists.shape)} {tuple(ids.shape)}")
    if not bool(torch.isfinite(dists).all()):
        raise AssertionError("non-finite retrieval distances")
    out = dict(n_devices=n_devices, mesh=dict(axes),
               distinct_devices=len(mesh.distinct_devices()),
               captured=captures(mesh), tokens=list(next_tokens.shape),
               topk=list(ids.shape))
    print(f"dryrun_multichip OK on {n_devices} positions: {out}", flush=True)
    return out
