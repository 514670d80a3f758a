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


def full_cache(sc):
    """A head-split ``ShardedKVCache``'s K and V put back together: rows
    over dp, heads over tp."""
    def join(parts):
        return torch.cat([torch.cat(r, dim=3) for r in parts], dim=1)
    return join(sc.k), join(sc.v)


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
