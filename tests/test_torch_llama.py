"""chamjax_torch.models.llama against chamjax.models.llama on the CPU:
converted JAX parameters, prefill and 8 decode steps (cache and ``idx``
included) with grouped-query (``kv_heads < heads``) and plain multi-head
attention, and the rotary, RMSNorm and GQA helpers.

Tolerances as in ``test_torch_models.py``: f32 ``rtol = atol = 2e-4``;
bf16 ``0.03 · max|ref|`` (the largest measured here is 0.021, from
rounding the frameworks do at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chamjax import config as jconfig
from chamjax import models as jm
from chamjax.models import llama as jl

from chamjax_torch import config as tconfig
from chamjax_torch import models as tm
from chamjax_torch.models import llama as tl
from chamjax_torch.models.convert import llama_from_numpy

SHAPE = dict(model_type="llama", embed_dim=64, ffn_embed_dim=160, layers=3,
             attention_heads=4, kv_heads=2, vocab_size=97, max_seq_len=16)
H = SHAPE["attention_heads"]
F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_REL = 0.03
CASES = {"gqa_f32": dict(dtype="float32"),
         "mha_f32": dict(dtype="float32", kv_heads=0),
         "gqa_bf16": dict(dtype="bfloat16")}


def close(got, want, dtype):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, w, **F32_TOL)
    else:
        assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()


@pytest.fixture(scope="module", params=sorted(CASES))
def llama(request):
    shape = dict(SHAPE, **CASES[request.param])
    jcfg, tcfg = jconfig.ModelConfig(**shape), tconfig.ModelConfig(**shape)
    p = jm.init_llama(jax.random.PRNGKey(0), jcfg)
    tp = llama_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       p), tcfg, device="cpu")
    return shape["dtype"], jcfg, tcfg, p, tp


def tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, SHAPE["vocab_size"], shape).astype(np.int32)


def test_llama_prefill_matches_chamjax(llama):
    dtype, jcfg, tcfg, p, tp = llama
    toks = tokens((2, 8))
    lg, hid, cache = jm.llama_prefill(p, jnp.asarray(toks),
                                      jm.init_llama_kv_cache(jcfg, 2), H,
                                      jcfg.kv_heads)
    tlg, thid, tcache = tm.llama_prefill(
        tp, torch.from_numpy(toks),
        tm.init_llama_kv_cache(tcfg, 2, device="cpu"), H, tcfg.kv_heads)
    close(tlg, lg, dtype)
    close(thid, hid, dtype)
    close(tcache.k, cache.k, dtype)
    close(tcache.v, cache.v, dtype)
    assert int(tcache.idx) == 8


def test_llama_steps_match_chamjax(llama):
    dtype, jcfg, tcfg, p, tp = llama
    toks = tokens((3, 8), seed=2)
    cache = jm.init_llama_kv_cache(jcfg, 3)
    tcache = tm.init_llama_kv_cache(tcfg, 3, device="cpu")
    assert tuple(tcache.k.shape) == cache.k.shape
    for i in range(8):
        lg, hid, cache = jm.llama_step(p, jnp.asarray(toks[:, i]), cache, H,
                                       jcfg.kv_heads)
        tlg, thid, tcache = tm.llama_step(tp, torch.from_numpy(toks[:, i]),
                                          tcache, H, tcfg.kv_heads)
        close(tlg, lg, dtype)
        close(thid, hid, dtype)
        assert int(tcache.idx) == int(cache.idx) == i + 1
    close(tcache.k, cache.k, dtype)
    close(tcache.v, cache.v, dtype)


def test_llama_prefill_step_consistency():
    """Incremental decode (pre-rotated cached K, GQA) reproduces the full
    causal forward (mirrors tests/test_llama.py)."""
    cfg = tconfig.ModelConfig(**dict(SHAPE, dtype="float32"))
    tp = tl.init_llama(0, cfg, device="cpu")
    toks = torch.from_numpy(tokens((2, 8), seed=3))
    full, _, _ = tm.llama_prefill(
        tp, toks, tm.init_llama_kv_cache(cfg, 2, device="cpu"), H,
        cfg.kv_heads)
    cache = tm.init_llama_kv_cache(cfg, 2, device="cpu")
    outs = []
    for i in range(8):
        lg, _, cache = tm.llama_step(tp, toks[:, i], cache, H, cfg.kv_heads)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               **F32_TOL)


def test_gqa_cache_is_kv_heads_sized():
    cfg = tconfig.ModelConfig(**SHAPE)
    cache = tm.init_llama_kv_cache(cfg, 3, device="cpu")
    assert cache.k.shape == (cfg.layers, 3, cfg.max_seq_len, cfg.kv_heads,
                             cfg.embed_dim // cfg.attention_heads)
    with pytest.raises(ValueError, match="kv_heads"):
        tm.init_llama_kv_cache(tconfig.ModelConfig(**dict(SHAPE,
                                                          kv_heads=3)),
                               1, device="cpu")


def test_rope_matches_chamjax_and_is_a_rotation():
    """The port's rotary tables and rotation equal chamjax's; identity at
    position 0, norm-preserving, and q·k depends only on the offset
    (mirrors tests/test_llama.py)."""
    hd = 8
    x = np.random.default_rng(4).standard_normal((1, 5, 2, hd)).astype(
        np.float32)
    pos = np.arange(5)
    jc, js = jl._rope_tables(jnp.asarray(pos), hd, 10000.0)
    tc, ts = tl._rope_tables(torch.from_numpy(pos), hd, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    y = tl._rope(torch.from_numpy(x), tc[None, :, None, :],
                 ts[None, :, None, :]).numpy()
    want = np.asarray(jl._rope(jnp.asarray(x), jc[None, :, None, :],
                               js[None, :, None, :]))
    np.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y[:, 0], x[:, 0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(y, axis=-1),
                               np.linalg.norm(x, axis=-1), rtol=1e-5,
                               atol=1e-5)
    q = torch.from_numpy(np.random.default_rng(5).standard_normal(hd)
                         .astype(np.float32))
    k = torch.from_numpy(np.random.default_rng(6).standard_normal(hd)
                         .astype(np.float32))

    def rot(v, p):
        c, s = tl._rope_tables(torch.tensor([p]), hd, 10000.0)
        return tl._rope(v[None, None, None, :], c[None, :, None, :],
                        s[None, :, None, :])[0, 0, 0]
    np.testing.assert_allclose(float(rot(q, 3) @ rot(k, 1)),
                               float(rot(q, 9) @ rot(k, 7)), rtol=1e-5,
                               atol=1e-5)


def test_rms_matches_chamjax_in_bf16():
    """RMSNorm in f32, cast, then scaled — the same order of casts."""
    x = np.random.default_rng(7).standard_normal((4, 64)).astype(np.float32)
    s = np.random.default_rng(8).standard_normal(64).astype(np.float32)
    want = np.asarray(jl._rms(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(s, jnp.bfloat16)), np.float32)
    got = tl._rms(torch.from_numpy(x).bfloat16(),
                  torch.from_numpy(s).bfloat16()).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_llama_init_shapes():
    cfg = tconfig.MODEL_PRESETS["Llama-S"]
    small = tconfig.ModelConfig(**dict(SHAPE, dtype="bfloat16"))
    p = tl.init_llama(1, small, device="cpu")
    assert p.layers.wk.shape == (small.layers, 64, 2 * 16)
    assert p.embed.dtype == torch.bfloat16
    assert float(p.layers.ln1.float().min()) == 1.0
    assert cfg.attention_heads % cfg.kv_heads == 0
