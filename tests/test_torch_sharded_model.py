"""Tensor- and data-parallel decode (``chamjax_torch/parallel/
sharded_model.py`` and the tensor-parallel cores of ``models/
transformer.py`` and ``models/llama.py``) against the unsharded port step
and the JAX package's GSPMD step, on the CPU.

Counterparts of ``tests/test_sharded_model.py`` (one a test, in its order),
then the cases a hand-written placement can get wrong: the fused ``wqkv``
split by heads (a contiguous split fails), the encoder-decoder's cross
attention, K/V replicated over tp for GQA, prefill, bf16.  Both packages
take the same parameters (the JAX package's, carried over with
``models/convert.py``); the JAX package runs its 4 virtual CPU devices,
the port a mesh of CPU positions, both dp 2 × tp 2.  Tolerance in f32:
atol 1e-5 (summation order only); bf16: 0.03 of the f32 logits' largest
magnitude, the RALM path's bar.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chamjax.config import ModelConfig
from chamjax.models import init_decoder, init_kv_cache
from chamjax.models.llama import init_llama, init_llama_kv_cache, llama_step
from chamjax.models.transformer import decoder_prefill, decoder_step
from chamjax.parallel import make_mesh as j_make_mesh
from chamjax.parallel.sharded_model import (
    shard_decoder_params as j_shard_decoder,
    shard_kv_cache as j_shard_cache,
    shard_llama_params as j_shard_llama,
)

from chamjax_torch import config as tconfig
from chamjax_torch import models as tm
from chamjax_torch.models import llama as tl
from chamjax_torch.models import transformer as tt
from chamjax_torch.models.convert import (decoder_from_numpy,
                                          encoder_from_numpy,
                                          llama_from_numpy)
from chamjax_torch.parallel import (make_mesh, shard_decoder_params,
                                    shard_kv_cache, shard_llama_params)

ATOL = 1e-5


def j_mesh():
    return j_make_mesh((("dp", 2), ("tp", 2)), devices=jax.devices()[:4])


def t_mesh():
    return make_mesh((("dp", 2), ("tp", 2)), devices=["cpu"] * 4)


def _dec_cfg(**over):
    kw = dict(model_type="decoder", embed_dim=64, ffn_embed_dim=128,
              layers=2, attention_heads=4, vocab_size=128, max_seq_len=16,
              dtype="float32")
    kw.update(over)
    return ModelConfig(**kw)


def tcfg(cfg):
    return tconfig.ModelConfig(**dataclasses.asdict(cfg))


def f32_tree(p):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def n(x):
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(n(got), n(want), atol=atol, rtol=0)


def join_grid(parts):
    """A ``[i][j]`` grid of head-split tensors (a ``ShardedKVCache``'s K or
    V, a tensor-parallel cross K or V) put back together: rows over dp,
    heads over tp."""
    return torch.cat([torch.cat(r, dim=3) for r in parts], dim=1)


def full_cache(sc):
    return join_grid(sc.k), join_grid(sc.v)


def test_tp_decoder_step_matches_unsharded():
    cfg = _dec_cfg()
    jp = init_decoder(jax.random.PRNGKey(0), cfg)
    params = decoder_from_numpy(f32_tree(jp), tcfg(cfg), device="cpu")
    b = 4
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(1), (b, 6), 0,
                                           cfg.vocab_size, jnp.int32))
    # the JAX package on its mesh (GSPMD)
    jm = j_mesh()
    jsp = j_shard_decoder(jp, jm)
    _, _, jc = decoder_prefill(jsp, jnp.asarray(prompt),
                               j_shard_cache(init_kv_cache(cfg, b), jm),
                               cfg.attention_heads)
    tok = jnp.full((b,), 3, jnp.int32)
    jax_out = []
    for _ in range(2):
        lg, hd, jc = decoder_step(jsp, tok, jc, cfg.attention_heads)
        jax_out.append((np.asarray(lg), np.asarray(hd)))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    # the port, unsharded and over the mesh
    tp_ = shard_decoder_params(params, t_mesh())
    caches = {}
    for name, p, cache in (
            ("ref", params, tm.init_kv_cache(tcfg(cfg), b, device="cpu")),
            ("tp", tp_, shard_kv_cache(tm.init_kv_cache(
                tcfg(cfg), b, device="cpu"), t_mesh()))):
        _, _, cache = tm.decoder_prefill(p, torch.from_numpy(prompt), cache,
                                         cfg.attention_heads)
        tok = torch.full((b,), 3, dtype=torch.int32)
        outs = []
        for _ in range(2):
            lg, hd, cache = tm.decoder_step(p, tok, cache,
                                            cfg.attention_heads)
            outs.append((lg, hd))
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
        caches[name] = (cache, outs)
    (ref_cache, ref), (tp_cache, got) = caches["ref"], caches["tp"]
    for (lg, hd), (lr, hr), (lj, hj) in zip(got, ref, jax_out):
        close(lg, lr)
        close(hd, hr)
        close(lg, lj)
        close(hd, hj)
    assert tp_cache.host_idx == ref_cache.host_idx == 8
    k, v = full_cache(tp_cache)
    close(k, ref_cache.k)
    close(v, ref_cache.v)
    close(k, np.asarray(jc.k))


def test_tp_llama_step_matches_unsharded():
    cfg = _dec_cfg(model_type="llama", kv_heads=2)
    jp = init_llama(jax.random.PRNGKey(0), cfg)
    params = llama_from_numpy(f32_tree(jp), tcfg(cfg), device="cpu")
    b = 4
    jm = j_mesh()
    jsp = j_shard_llama(jp, jm, kv_heads=cfg.kv_heads)
    jc = j_shard_cache(init_llama_kv_cache(cfg, b), jm)
    tok = jnp.full((b,), 5, jnp.int32)
    jax_out = []
    for _ in range(3):
        lg, hd, jc = llama_step(jsp, tok, jc, heads=cfg.attention_heads,
                                kv_heads=cfg.kv_heads, theta=cfg.rope_theta)
        jax_out.append((np.asarray(lg), np.asarray(hd)))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    tsp = shard_llama_params(params, t_mesh(), kv_heads=cfg.kv_heads)
    assert tsp.ranks[0].wk.shape[-1] == params.layers.wk.shape[-1] // 2
    runs = []
    for p, cache in ((params, tl.init_llama_kv_cache(tcfg(cfg), b,
                                                     device="cpu")),
                     (tsp, shard_kv_cache(tl.init_llama_kv_cache(
                         tcfg(cfg), b, device="cpu"), t_mesh()))):
        tok = torch.full((b,), 5, dtype=torch.int32)
        outs = []
        for _ in range(3):
            lg, hd, cache = tl.llama_step(p, tok, cache, cfg.attention_heads,
                                          cfg.kv_heads, cfg.rope_theta)
            outs.append((lg, hd))
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
        runs.append(outs)
    for (lg, hd), (lr, hr), (lj, hj) in zip(runs[1], runs[0], jax_out):
        close(lg, lr)
        close(hd, hr)
        close(lg, lj)
        close(hd, hj)


def test_tp_gqa_kv_cache_replicates_odd_heads():
    # kv_heads=1 does not divide tp=2: every tp position holds the head
    cfg = _dec_cfg(model_type="llama", kv_heads=1)
    sc = shard_kv_cache(tl.init_llama_kv_cache(tcfg(cfg), 4, device="cpu"),
                        t_mesh())
    for row in sc.k:
        for part in row:
            assert tuple(part.shape) == (2, 2, 16, 1, 16)
    jc = j_shard_cache(init_llama_kv_cache(cfg, 4), j_mesh())
    assert jc.k.sharding.spec[3] is None


def test_tp_gqa_kv_proj_replicates_odd_heads():
    # kv_heads=1 with a tp-divisible head_dim: splitting the flattened
    # width would cut the one KV head; the placement replicates it
    cfg = _dec_cfg(model_type="llama", kv_heads=1)
    jp = init_llama(jax.random.PRNGKey(0), cfg)
    params = llama_from_numpy(f32_tree(jp), tcfg(cfg), device="cpu")
    for kv_heads in (cfg.kv_heads, 0):     # known, or inferred from widths
        sp = shard_llama_params(params, t_mesh(), kv_heads=kv_heads)
        for r in sp.ranks:
            assert r.wk.shape == params.layers.wk.shape
            assert r.wv.shape == params.layers.wv.shape
            assert r.wq.shape[-1] == params.layers.wq.shape[-1] // 2
        jsp = j_shard_llama(jp, j_mesh(), kv_heads=kv_heads)
        assert jsp["layers"]["wk"].sharding.spec[-1] is None
        assert jsp["layers"]["wq"].sharding.spec[-1] == "tp"


def test_tp_ralm_decoder_multistep_on_mesh():
    from chamjax.retrieval.interface import DummyRetriever
    from chamjax.serving.ralm import RalmDecoder
    from chamjax_torch.retrieval import DummyRetriever as TDummy
    from chamjax_torch.serving.ralm import RalmDecoder as TRalmDecoder

    cfg = _dec_cfg(retrieval_interval=2, k=4)
    jp = init_decoder(jax.random.PRNGKey(0), cfg)
    jdec = RalmDecoder(j_shard_decoder(jp, j_mesh()), cfg, DummyRetriever(),
                       batch_size=4, retrieval_interval=2, k=4)
    jdec.cache = j_shard_cache(jdec.cache, j_mesh())
    jdec.batch_inference(num_step=6)

    params = decoder_from_numpy(f32_tree(jp), tcfg(cfg), device="cpu")
    toks = []
    for p in (params, shard_decoder_params(params, t_mesh())):
        dec = TRalmDecoder(p, tcfg(cfg), TDummy(), batch_size=4,
                           retrieval_interval=2, k=4)
        if p is not params:
            dec.cache = shard_kv_cache(dec.cache, t_mesh())
        dec.batch_inference(num_step=6)
        toks.append(dec.tokens.numpy().copy())
        dec.reset_inference_state()        # a sharded cache empties too
        assert all(not t.any() for t in tt.leaves(dec.cache.k))
    np.testing.assert_array_equal(toks[1], toks[0])
    np.testing.assert_array_equal(toks[1], np.asarray(jdec.tokens))


# ---------------------------------------------------------------------------
# beyond the reference tests
# ---------------------------------------------------------------------------


def test_wqkv_splits_by_heads_not_by_columns():
    """At tp=2 the fused (L, d, 3d) ``wqkv``'s contiguous column halves
    give position 0 all of q and half of k.  The placement takes each of
    q, k and v apart by heads; the contiguous split, run through the same
    tensor-parallel step, misses the unsharded logits."""
    cfg = _dec_cfg()
    params = decoder_from_numpy(
        f32_tree(init_decoder(jax.random.PRNGKey(3), cfg)), tcfg(cfg),
        device="cpu")
    mesh = make_mesh((("tp", 2),), devices=["cpu"] * 2)
    d = cfg.embed_dim
    good = shard_decoder_params(params, mesh)
    wqkv = params.layers.wqkv.detach()
    np.testing.assert_array_equal(n(good.ranks[0].wq), n(wqkv[..., :d // 2]))
    np.testing.assert_array_equal(n(good.ranks[1].wk),
                                  n(wqkv[..., d + d // 2:2 * d]))
    bad = shard_decoder_params(params, mesh)
    for j, r in enumerate(bad.ranks):
        block = wqkv[..., j * 3 * d // 2:(j + 1) * 3 * d // 2]
        for name, w in zip(("wq", "wk", "wv"), torch.chunk(block, 3, -1)):
            getattr(r, name).data = w.contiguous()
    b = 2
    tok = torch.tensor([3, 7], dtype=torch.int32)
    outs = {}
    for name, p, cache in (
            ("ref", params, tm.init_kv_cache(tcfg(cfg), b, device="cpu")),
            ("good", good, shard_kv_cache(tm.init_kv_cache(
                tcfg(cfg), b, device="cpu"), mesh)),
            ("contiguous", bad, shard_kv_cache(tm.init_kv_cache(
                tcfg(cfg), b, device="cpu"), mesh))):
        for _ in range(3):
            lg, _, cache = tm.decoder_step(p, tok, cache, cfg.attention_heads)
        outs[name] = lg
    close(outs["good"], outs["ref"])
    assert float((outs["contiguous"] - outs["ref"]).abs().max()) > 1e-2


def test_tp_encoder_decoder_matches_unsharded():
    """The encoder, the cross K/V and the decoder step with cross
    attention (a third all-reduce a layer) against the unsharded port and
    the JAX package's GSPMD run."""
    from chamjax.models import encoder_forward, init_encoder_decoder
    from chamjax.models.transformer import build_cross_kv
    cfg = _dec_cfg(model_type="encoder-decoder", encoder_layers=2)
    jenc, jdec = init_encoder_decoder(jax.random.PRNGKey(0), cfg)
    enc = encoder_from_numpy(f32_tree(jenc), tcfg(cfg), device="cpu")
    dec = decoder_from_numpy(f32_tree(jdec), tcfg(cfg), device="cpu")
    b, h = 4, cfg.attention_heads
    ret = np.random.default_rng(4).integers(1, cfg.vocab_size,
                                            (b, 8)).astype(np.int32)
    valid = np.array([8, 5, 8, 3], np.int32)
    jm = j_mesh()
    jse, jsd = j_shard_decoder(jenc, jm), j_shard_decoder(jdec, jm)
    je = encoder_forward(jse, jnp.asarray(ret), h, jnp.asarray(valid))
    jkv = build_cross_kv(jsd, je, h)
    jc = j_shard_cache(init_kv_cache(cfg, b), jm)
    tok = jnp.full((b,), 3, jnp.int32)
    jax_out = []
    for _ in range(3):
        lg, _, jc = decoder_step(jsd, tok, jc, h, cross_kv=jkv,
                                 cross_valid_len=jnp.asarray(valid))
        jax_out.append(np.asarray(lg))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    mesh = t_mesh()
    runs = []
    for e, d_, cache in (
            (enc, dec, tm.init_kv_cache(tcfg(cfg), b, device="cpu")),
            (shard_decoder_params(enc, mesh), shard_decoder_params(dec, mesh),
             shard_kv_cache(tm.init_kv_cache(tcfg(cfg), b, device="cpu"),
                            mesh))):
        out = tm.encoder_forward(e, torch.from_numpy(ret), h,
                                 torch.from_numpy(valid))
        kv = tt.build_cross_kv(d_, out, h)
        tok = torch.full((b,), 3, dtype=torch.int32)
        lgs = []
        for _ in range(3):
            lg, _, cache = tm.decoder_step(d_, tok, cache, h, cross_kv=kv,
                                           cross_valid_len=torch.from_numpy(
                                               valid))
            lgs.append(lg)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
        runs.append((out, lgs))
    (out_r, ref), (out_t, got) = runs
    close(out_t, out_r)
    close(out_t, np.asarray(je))
    for a, r, j in zip(got, ref, jax_out):
        close(a, r)
        close(a, j)


@pytest.mark.parametrize("kv_heads,named", [(1, True), (2, True), (4, True),
                                            (2, False)])
def test_tp_llama_prefill_and_steps_match_unsharded(kv_heads, named):
    """GQA with K/V replicated over tp (kv_heads=1: every position reads
    KV head ``head // groups`` from the whole K/V), split (2), multi-head
    (4), and GQA placed without its head count (2, unnamed: whole K/V
    projections feeding a split cache, each position caching its heads):
    prefill, then steps, against the unsharded port and the JAX package's
    GSPMD step."""
    from chamjax.models.llama import llama_prefill
    cfg = _dec_cfg(model_type="llama", kv_heads=kv_heads)
    jp = init_llama(jax.random.PRNGKey(1), cfg)
    params = llama_from_numpy(f32_tree(jp), tcfg(cfg), device="cpu")
    b, h = 4, cfg.attention_heads
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                               (b, 5)).astype(np.int32)
    jm = j_mesh()
    jsp = j_shard_llama(jp, jm, kv_heads=kv_heads if named else 0)
    jl0, _, jc = llama_prefill(jsp, jnp.asarray(prompt),
                               j_shard_cache(init_llama_kv_cache(cfg, b), jm),
                               heads=h, kv_heads=kv_heads,
                               theta=cfg.rope_theta)
    jax_out = [np.asarray(jl0)]
    tok = jnp.argmax(jl0[:, -1], axis=-1).astype(jnp.int32)
    for _ in range(3):
        lg, _, jc = llama_step(jsp, tok, jc, heads=h, kv_heads=kv_heads,
                               theta=cfg.rope_theta)
        jax_out.append(np.asarray(lg))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    tsp = shard_llama_params(params, t_mesh(),
                             kv_heads=kv_heads if named else 0)
    split = tsp.ranks[0].wk.shape[-1] < params.layers.wk.shape[-1]
    assert split == (kv_heads % 2 == 0 and (named or kv_heads == 4))
    runs = []
    for p, cache in ((params, tl.init_llama_kv_cache(tcfg(cfg), b,
                                                     device="cpu")),
                     (tsp, shard_kv_cache(tl.init_llama_kv_cache(
                         tcfg(cfg), b, device="cpu"), t_mesh()))):
        l0, _, cache = tl.llama_prefill(p, torch.from_numpy(prompt), cache,
                                        h, kv_heads, cfg.rope_theta)
        outs = [l0]
        tok = torch.argmax(l0[:, -1], dim=-1).to(torch.int32)
        for _ in range(3):
            lg, _, cache = tl.llama_step(p, tok, cache, h, kv_heads,
                                         cfg.rope_theta)
            outs.append(lg)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
        runs.append(outs)
    for a, r, j in zip(runs[1], runs[0], jax_out):
        close(a, r)
        close(a, j)


@pytest.mark.parametrize("family", ["decoder", "llama"])
def test_tp_bf16_steps_within_the_bf16_bar(family):
    """bf16 tensor-parallel steps (float32 partials summed, then rounded
    once) against the unsharded bf16 step: logits within 0.03 of the f32
    logits' largest magnitude."""
    cfg = _dec_cfg(model_type=family, dtype="bfloat16",
                   **({"kv_heads": 2} if family == "llama" else {}))
    f32 = dataclasses.replace(tcfg(cfg), dtype="float32")
    init, step, new_cache = (
        (tl.init_llama, tl.llama_step, tl.init_llama_kv_cache)
        if family == "llama" else
        (tm.init_decoder, tm.decoder_step, tm.init_kv_cache))
    kw = ({"kv_heads": 2, "theta": cfg.rope_theta} if family == "llama"
          else {})
    p16 = init(0, tcfg(cfg), device="cpu")
    p32 = init(0, f32, device="cpu")
    p32.load_state_dict(p16.state_dict())
    sp = (shard_llama_params(p16, t_mesh(), kv_heads=2) if family == "llama"
          else shard_decoder_params(p16, t_mesh()))
    b = 4
    caches = [new_cache(tcfg(cfg), b, device="cpu"),
              shard_kv_cache(new_cache(tcfg(cfg), b, device="cpu"), t_mesh()),
              new_cache(f32, b, device="cpu")]
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (6, b))
    for t in toks:
        t = torch.from_numpy(t.astype(np.int32))
        outs = []
        for i, p in enumerate((p16, sp, p32)):
            lg, _, caches[i] = step(p, t, caches[i], cfg.attention_heads,
                                    **kw)
            outs.append(lg.float())
        bar = 0.03 * float(outs[2].abs().max())
        assert float((outs[1] - outs[0]).abs().max()) <= bar
        assert float((outs[1] - outs[2]).abs().max()) <= bar


def test_tp_refuses_what_it_cannot_split():
    cfg = _dec_cfg()
    params = tm.init_decoder(0, tcfg(cfg), device="cpu")
    sp = shard_decoder_params(params, t_mesh())
    tok = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="ShardedKVCache"):
        tm.decoder_step(sp, tok, tm.init_kv_cache(tcfg(cfg), 4, device="cpu"),
                        cfg.attention_heads)
    sc = shard_kv_cache(tm.init_kv_cache(tcfg(cfg), 4, device="cpu"),
                        t_mesh())
    with pytest.raises(ValueError, match="do not split"):
        tm.decoder_step(sp, tok[:3], sc, cfg.attention_heads)
    with pytest.raises(ValueError, match="does not split"):
        shard_kv_cache(tm.init_kv_cache(tcfg(cfg), 3, device="cpu"), t_mesh())
    odd = tm.init_decoder(0, tcfg(_dec_cfg(ffn_embed_dim=129)), device="cpu")
    with pytest.raises(ValueError, match="FFN"):
        shard_decoder_params(odd, t_mesh())


# ---------------------------------------------------------------------------
# the encoder-decoder loops over tensor-parallel parameters
# ---------------------------------------------------------------------------


class RowIds:
    """A retriever with ``retrieve_device`` (the fused path) in both
    packages: row r retrieves ids ``3·j + 11·r``, so the rows' retrieved
    tokens differ; it keeps the last queries it was handed."""

    def __init__(self, to_ids):
        self.to_ids, self.queries = to_ids, None

    def retrieve_device(self, queries, nprobe, k):
        b = queries.shape[0]
        self.queries = queries
        ids = self.to_ids((np.arange(k)[None] * 3
                           + 11 * np.arange(b)[:, None]).astype(np.int32),
                          queries)
        return types.SimpleNamespace(ids=ids, dists=ids)


def _encdec_loops(kind, jdummy, tdummy, jse, jsd, tse, tsd, cfg, steps,
                  monkeypatch):
    """Runs the JAX package's and the port's ``kind`` loop ("ralm" or
    "tiktok") over sharded parameters for ``steps`` steps; returns each
    loop and the logits of every decode step, in order."""
    import chamjax.serving.ralm as jralm
    import chamjax.serving.tiktok as jtiktok
    import chamjax_torch.serving.ralm as tralm
    import chamjax_torch.serving.tiktok as ttiktok
    logits = {"jax": [], "port": []}
    for side, mods in (("jax", (jralm, jtiktok)), ("port", (tralm,
                                                            ttiktok))):
        for mod in mods:
            def spy(*a, _real=mod.decoder_step, _out=logits[side], **k):
                lg, hid, cache = _real(*a, **k)
                _out.append(lg)
                return lg, hid, cache
            monkeypatch.setattr(mod, "decoder_step", spy)
    kw = dict(retrieval_interval=2, k=4)
    jm_, tm_ = j_mesh(), t_mesh()
    if kind == "ralm":
        jloop = jralm.RalmEncoderDecoder(jse, jsd, cfg, jdummy, 4, **kw)
        tloop = tralm.RalmEncoderDecoder(tse, tsd, tcfg(cfg), tdummy, 4,
                                         **kw)
        jstates, tstates = (jloop,), (tloop,)
    else:
        jloop = jtiktok.TikTokEncoderDecoder(jse, jsd, cfg, jdummy, 4, **kw)
        tloop = ttiktok.TikTokEncoderDecoder(tse, tsd, tcfg(cfg), tdummy, 4,
                                             **kw)
        jstates = tuple(jloop.states.values())
        tstates = tuple(tloop.states.values())
    for st in jstates:
        st.cache = j_shard_cache(st.cache, jm_)
    for st in tstates:
        st.cache = shard_kv_cache(st.cache, tm_)
    if kind == "ralm":
        jloop.multi_steps(steps)
        tloop.multi_steps(steps)
    else:
        jloop.batch_inference(steps)
        tloop.batch_inference(steps)
    return jloop, tloop, jstates, tstates, logits


@pytest.mark.parametrize("path", ["host", "device"])
@pytest.mark.parametrize("kind", ["ralm", "tiktok"])
def test_tp_encoder_decoder_loops_match_jax(kind, path, monkeypatch):
    """``RalmEncoderDecoder`` and ``TikTokEncoderDecoder`` over
    ``shard_decoder_params`` of both models and a ``shard_kv_cache`` cache
    (dp 2 × tp 2), on the host path (``DummyRetriever``) and the fused
    path, against the JAX package's loops over its GSPMD placement: tokens
    equal, and every step's logits and the cross K/V joined back over the
    grid within atol 1e-5.  Under this random init every token is the same
    in both packages, so the logits and the K/V carry the comparison.
    Then a reset empties the sharded cache in place and the run repeats
    on the same cross K/V buffers."""
    from chamjax.models import init_encoder_decoder
    from chamjax.retrieval.interface import DummyRetriever
    from chamjax_torch.retrieval import DummyRetriever as TDummy
    cfg = _dec_cfg(model_type="encoder-decoder", encoder_layers=2,
                   retrieval_token_len=4)
    jenc, jdec = init_encoder_decoder(jax.random.PRNGKey(0), cfg)
    enc = encoder_from_numpy(f32_tree(jenc), tcfg(cfg), device="cpu")
    dec = decoder_from_numpy(f32_tree(jdec), tcfg(cfg), device="cpu")
    if path == "host":
        jr, tr = DummyRetriever(), TDummy()
    else:
        jr = RowIds(lambda ids, q: jnp.asarray(ids))
        tr = RowIds(lambda ids, q: torch.from_numpy(ids).to(q.device))
    jm_, tm_ = j_mesh(), t_mesh()
    tse, tsd = shard_decoder_params(enc, tm_), shard_decoder_params(dec, tm_)
    jloop, tloop, jstates, tstates, logits = _encdec_loops(
        kind, jr, tr, j_shard_decoder(jenc, jm_), j_shard_decoder(jdec, jm_),
        tse, tsd, cfg, 6, monkeypatch)
    assert len(logits["port"]) == len(logits["jax"]) > 0
    for got, want in zip(logits["port"], logits["jax"]):
        close(got, want)
    if path == "device":
        close(tr.queries, jr.queries)
    buffers = []
    for jst, tst in zip(jstates, tstates):
        np.testing.assert_array_equal(tst.tokens.numpy(),
                                      np.asarray(jst.tokens))
        assert isinstance(tst.cross_kv[0], tuple)       # the grid layout
        for got, want in zip(tst.cross_kv, jst.cross_kv):
            close(join_grid(got), want)
        buffers.append([t.data_ptr() for t in tt.leaves(tst.cross_kv)])
    # the reset: the sharded cache empties in place, the cross K/V is
    # forgotten, and the next run refills the same buffers
    first = list(logits["port"])
    tloop.reset_inference_state()
    for tst in tstates:
        assert all(not t.any() for t in tt.leaves(tst.cache.k))
        assert tst.cross_kv is None
    logits["port"].clear()
    if kind == "ralm":
        tloop.multi_steps(6)
    else:
        tloop.batch_inference(6)
    assert len(logits["port"]) == len(first)
    for a, b in zip(logits["port"], first):
        assert torch.equal(a, b)
    assert [[t.data_ptr() for t in tt.leaves(tst.cross_kv)]
            for tst in tstates] == buffers


@pytest.mark.parametrize("what", ["batch", "heads"])
def test_cross_kv_refuses_what_it_cannot_split(what):
    """``CrossKV`` on tensor-parallel parameters refuses a batch that does
    not split over dp and heads that do not split over tp, with
    ``check_tp``'s message, before it encodes anything."""
    from chamjax_torch.serving.ralm import CrossKV
    cfg = tcfg(_dec_cfg(model_type="encoder-decoder", encoder_layers=1,
                        **({"embed_dim": 48, "attention_heads": 3}
                           if what == "heads" else {})))
    enc, dec = tm.init_encoder_decoder(0, cfg, device="cpu")
    mesh = t_mesh()
    cross = CrossKV(shard_decoder_params(enc, mesh),
                    shard_decoder_params(dec, mesh), cfg, 4)
    b = 3 if what == "batch" else 4
    with pytest.raises(ValueError, match="do not split over tp=2, dp=2"):
        cross.from_tokens(torch.ones((b, 8), dtype=torch.int32))
    assert cross.kv is None
