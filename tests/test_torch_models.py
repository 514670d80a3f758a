"""chamjax_torch.models.transformer against chamjax.models.transformer on
the CPU: the same JAX-initialised parameters carried across
(``models/convert.py``), the same tokens, and prefill, 8 decode steps (the
cache and ``idx`` included), the encoder with and without ``valid_len``,
the cross K/V and a cross-attention step.

Tolerances: f32 configs ``rtol = atol = 2e-4`` (the JAX package's own bar,
``tests/test_models.py``); bf16 configs ``0.03 · max|ref|``.  The bf16 bar
is what the two frameworks' rounding leaves: XLA fuses elementwise chains
and keeps them in f32 (and rounds GELU's constants to bf16), torch rounds
after each op, so the two bf16 runs differ by a few bf16 ulps a layer; at
these sizes the largest difference measured is 0.010–0.021 · max|ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chamjax import config as jconfig
from chamjax import models as jm
from chamjax.models import transformer as jt

from chamjax_torch import config as tconfig
from chamjax_torch import random as jr
from chamjax_torch import models as tm
from chamjax_torch.models import transformer as tt
from chamjax_torch.models.convert import (decoder_from_numpy,
                                          encoder_from_numpy)

SHAPE = dict(model_type="decoder", embed_dim=64, ffn_embed_dim=128, layers=3,
             attention_heads=4, vocab_size=97, max_seq_len=16)
H = SHAPE["attention_heads"]
F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_REL = 0.03


def f32_tree(p):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def cfgs(dtype, **kw):
    shape = dict(SHAPE, dtype=dtype, **kw)
    return jconfig.ModelConfig(**shape), tconfig.ModelConfig(**shape)


def close(got, want, dtype):
    """The port's ``got`` (a tensor) against chamjax's ``want`` at the
    dtype's stated tolerance."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, w, **F32_TOL)
    else:
        assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def decoder(request):
    jcfg, tcfg = cfgs(request.param)
    p = jm.init_decoder(jax.random.PRNGKey(0), jcfg)
    return request.param, jcfg, tcfg, p, decoder_from_numpy(
        f32_tree(p), tcfg, device="cpu")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def enc_dec(request):
    jcfg, tcfg = cfgs(request.param, model_type="encoder-decoder",
                      encoder_layers=2)
    enc, dec = jm.init_encoder_decoder(jax.random.PRNGKey(2), jcfg)
    return (request.param, jcfg, tcfg, enc, dec,
            encoder_from_numpy(f32_tree(enc), tcfg, device="cpu"),
            decoder_from_numpy(f32_tree(dec), tcfg, device="cpu"))


def tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, SHAPE["vocab_size"], shape).astype(np.int32)


def test_model_presets_match_chamjax():
    assert set(tconfig.MODEL_PRESETS) == set(jconfig.MODEL_PRESETS)
    for name, cfg in jconfig.MODEL_PRESETS.items():
        assert dataclasses.asdict(tconfig.MODEL_PRESETS[name]) == \
            dataclasses.asdict(cfg)
    assert (dataclasses.asdict(tconfig.ModelConfig())
            == dataclasses.asdict(jconfig.ModelConfig()))


def test_decoder_prefill_matches_chamjax(decoder):
    dtype, jcfg, tcfg, p, tp = decoder
    toks = tokens((2, 8))
    lg, hid, cache = jm.decoder_prefill(p, jnp.asarray(toks),
                                        jm.init_kv_cache(jcfg, 2), H)
    tlg, thid, tcache = tm.decoder_prefill(
        tp, torch.from_numpy(toks), tm.init_kv_cache(tcfg, 2, device="cpu"),
        H)
    close(tlg, lg, dtype)
    close(thid, hid, dtype)
    close(tcache.k, cache.k, dtype)
    close(tcache.v, cache.v, dtype)
    assert int(tcache.idx) == int(cache.idx) == 8 and tcache.host_idx == 8


def test_decoder_steps_match_chamjax(decoder):
    """8 successive steps: logits, hidden, the whole cache and idx."""
    dtype, jcfg, tcfg, p, tp = decoder
    toks = tokens((3, 8), seed=2)
    cache = jm.init_kv_cache(jcfg, 3)
    tcache = tm.init_kv_cache(tcfg, 3, device="cpu")
    for i in range(8):
        lg, hid, cache = jm.decoder_step(p, jnp.asarray(toks[:, i]), cache, H)
        tlg, thid, tcache = tm.decoder_step(tp, torch.from_numpy(toks[:, i]),
                                            tcache, H)
        close(tlg, lg, dtype)
        close(thid, hid, dtype)
        assert int(tcache.idx) == int(cache.idx) == i + 1
        assert tcache.host_idx == i + 1
        assert tcache.idx.dtype == torch.int32 and tcache.idx.dim() == 0
    close(tcache.k, cache.k, dtype)
    close(tcache.v, cache.v, dtype)


def test_prefill_step_consistency():
    """The port's own invariant (mirrors tests/test_models.py): incremental
    decoding reproduces the full causal forward."""
    jcfg, tcfg = cfgs("float32")
    tp = tt.init_decoder(0, tcfg, device="cpu")
    toks = torch.from_numpy(tokens((2, 8), seed=3))
    logits_full, _, _ = tm.decoder_prefill(
        tp, toks, tm.init_kv_cache(tcfg, 2, device="cpu"), H)
    cache = tm.init_kv_cache(tcfg, 2, device="cpu")
    steps = []
    for i in range(8):
        lg, _, cache = tm.decoder_step(tp, toks[:, i], cache, H)
        steps.append(lg)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               logits_full.numpy(), **F32_TOL)
    assert int(cache.idx) == 8


def test_step_shapes_and_cache_growth():
    _, tcfg = cfgs("float32")
    tp = tt.init_decoder(jr.fold_in(4, 1), tcfg, device="cpu")
    cache = tm.init_kv_cache(tcfg, 4, device="cpu")
    lg, hid, cache = tm.decoder_step(tp, torch.zeros(4, dtype=torch.int32),
                                     cache, H)
    assert lg.shape == (4, tcfg.vocab_size)
    assert hid.shape == (4, tcfg.embed_dim)
    assert int(cache.idx) == 1
    assert float(cache.k[:, :, 0].abs().sum()) > 0
    assert float(cache.k[:, :, 1].abs().sum()) == 0


def test_step_ignores_cache_beyond_idx():
    """The step attends to cached positions < idx plus a separate self
    term, and writes its column after the layer loop.  A step must not see
    what the cache holds at positions >= idx: a port that attends over
    ``<= idx`` before writing its column reads a stale column, and one
    that drops the mask reads the garbage."""
    _, tcfg = cfgs("float32")
    tp = tt.init_decoder(5, tcfg, device="cpu")
    toks = torch.from_numpy(tokens((2, 4), seed=5))
    clean = tm.init_kv_cache(tcfg, 2, device="cpu")
    dirty = tm.init_kv_cache(tcfg, 2, device="cpu")
    for i in range(3):
        _, _, clean = tm.decoder_step(tp, toks[:, i], clean, H)
        _, _, dirty = tm.decoder_step(tp, toks[:, i], dirty, H)
        dirty.k[:, :, i + 1:] = 1e3     # finite garbage: p = 0 must hide it
        dirty.v[:, :, i + 1:] = -1e3
    lg_c, hid_c, clean = tm.decoder_step(tp, toks[:, 3], clean, H)
    lg_d, hid_d, dirty = tm.decoder_step(tp, toks[:, 3], dirty, H)
    assert torch.equal(lg_c, lg_d) and torch.equal(hid_c, hid_d)
    # the step wrote column 3 and nothing else
    assert torch.equal(clean.k[:, :, :4], dirty.k[:, :, :4])
    assert bool((dirty.k[:, :, 4:] == 1e3).all())


def test_step_past_max_seq_len_raises():
    """The JAX package clamps the position gather and the cache write past
    max_seq_len (silently); on a card that index would be a device-side
    assert, so the port raises on the host, from the host-side count."""
    jcfg, tcfg = cfgs("float32", max_seq_len=4)
    p = jm.init_decoder(jax.random.PRNGKey(6), jcfg)
    tp = decoder_from_numpy(f32_tree(p), tcfg, device="cpu")
    cache = jm.init_kv_cache(jcfg, 2)
    tcache = tm.init_kv_cache(tcfg, 2, device="cpu")
    tok = np.zeros(2, np.int32)
    for _ in range(4):
        _, _, cache = jm.decoder_step(p, jnp.asarray(tok), cache, H)
        _, _, tcache = tm.decoder_step(tp, torch.from_numpy(tok), tcache, H)
    lg, _, cache = jm.decoder_step(p, jnp.asarray(tok), cache, H)
    assert np.isfinite(np.asarray(lg)).all() and int(cache.idx) == 5
    with pytest.raises(IndexError, match="KV cache full"):
        tm.decoder_step(tp, torch.from_numpy(tok), tcache, H)
    with pytest.raises(IndexError):
        tm.decoder_prefill(tp, torch.zeros((2, 5), dtype=torch.int32),
                           tm.init_kv_cache(tcfg, 2, max_len=4,
                                            device="cpu"), H)


@pytest.mark.parametrize("with_valid_len", [False, True])
def test_encoder_forward_matches_chamjax(enc_dec, with_valid_len):
    dtype, jcfg, tcfg, enc, _dec, tenc, _tdec = enc_dec
    src = tokens((2, 8), seed=7)
    vl = np.array([5, 8], np.int32)
    kw = dict(valid_len=jnp.asarray(vl)) if with_valid_len else {}
    tkw = dict(valid_len=torch.from_numpy(vl)) if with_valid_len else {}
    out = jm.encoder_forward(enc, jnp.asarray(src), H, **kw)
    tout = tm.encoder_forward(tenc, torch.from_numpy(src), H, **tkw)
    close(tout, out, dtype)
    if with_valid_len:
        # tokens past valid_len must not reach the valid positions
        src2 = src.copy()
        src2[0, 6] = (src2[0, 6] + 3) % tcfg.vocab_size
        tout2 = tm.encoder_forward(tenc, torch.from_numpy(src2), H, **tkw)
        assert torch.equal(tout2[0, :5], tout[0, :5])


def test_cross_kv_and_cross_step_match_chamjax(enc_dec):
    dtype, jcfg, tcfg, enc, dec, tenc, tdec = enc_dec
    src = tokens((2, 6), seed=8)
    vl = np.array([4, 6], np.int32)
    enc_out = jm.encoder_forward(enc, jnp.asarray(src), H)
    tenc_out = tm.encoder_forward(tenc, torch.from_numpy(src), H)
    ckv = jt.build_cross_kv(dec, enc_out, H)
    # each package's own encoder output, and chamjax's carried over, so the
    # cross K/V is checked apart from the encoder
    tckv = tt.build_cross_kv(tdec, tenc_out, H)
    tckv_same = tt.build_cross_kv(
        tdec, torch.from_numpy(np.array(enc_out, np.float32)).to(
            tenc_out.dtype), H)
    for got in (tckv, tckv_same):
        assert got[0].shape == (tcfg.layers, 2, 6, H, 16)
        close(got[0], ckv[0], dtype)
        close(got[1], ckv[1], dtype)
    toks = tokens((2, 3), seed=9)
    cache = jm.init_kv_cache(jcfg, 2)
    tcache = tm.init_kv_cache(tcfg, 2, device="cpu")
    for i in range(3):
        lg, hid, cache = jm.decoder_step(dec, jnp.asarray(toks[:, i]), cache,
                                         H, cross_kv=ckv,
                                         cross_valid_len=jnp.asarray(vl))
        tlg, thid, tcache = tm.decoder_step(
            tdec, torch.from_numpy(toks[:, i]), tcache, H, cross_kv=tckv,
            cross_valid_len=torch.from_numpy(vl))
        close(tlg, lg, dtype)
        close(thid, hid, dtype)


CROSS_SHAPES = [(3, 2, 6, 64, 4), (2, 1, 5, 32, 2), (4, 3, 1, 48, 3),
                (1, 1, 1, 16, 1), (2, 4, 7, 96, 8)]      # (L, b, s, d, h)


def cross_case(L, b, s, d, h, dtype=torch.float32):
    """A decoder with cross-attention whose ``wkv`` is drawn from a seed,
    and an encoder output drawn from it too."""
    cfg = tconfig.ModelConfig(model_type="encoder-decoder", embed_dim=d,
                              ffn_embed_dim=2 * d, layers=L,
                              attention_heads=h, vocab_size=11,
                              max_seq_len=8)
    dec = tt.TransformerParams(cfg, n_layers=L, n_out=11,
                               cross_attention=True, device="cpu",
                               dtype=dtype)
    g = torch.Generator().manual_seed(L * 1000 + b * 100 + s * 10 + h)
    dec.cross_layers.wkv.copy_(torch.randn(L, d, 2 * d, generator=g))
    return dec, torch.randn(b, s, d, generator=g).to(dtype)


def cross_buffers(L, b, s, d, h, dtype=torch.float32):
    return tuple(torch.full((L, b, s, h, d // h), float("nan"), dtype=dtype)
                 for _ in range(2))


@pytest.mark.parametrize("L,b,s,d,h", CROSS_SHAPES)
def test_write_cross_kv_is_the_broadcast_product(L, b, s, d, h):
    """The writer's buffers equal the broadcast product over every layer,
    chunked into K and V and split into heads, bit for bit in f32.  At
    s = 1 the broadcast is vector-matrix products, which the CPU's BLAS
    sums in another order than the writer's GEMMs over b rows (or its own
    vector path at b = 1): there both must lie within f32's bound for a
    d-term dot product (d · eps · |e|·|w|) of the float64 product."""
    dec, enc_out = cross_case(L, b, s, d, h)
    wkv = dec.cross_layers.wkv
    kv = enc_out[None] @ wkv[:, None]
    want = [x.reshape(L, b, s, h, -1) for x in torch.chunk(kv, 2, dim=-1)]
    out = cross_buffers(L, b, s, d, h)
    tt.write_cross_kv(dec, enc_out, h, out)
    if s > 1:
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
        return
    exact = enc_out.double()[None] @ wkv.double()[:, None]
    bound = d * torch.finfo(torch.float32).eps * (
        enc_out.double().abs()[None] @ wkv.double().abs()[:, None])
    got = torch.cat([x.reshape(L, b, s, d) for x in out], dim=-1)
    assert ((got.double() - exact).abs() <= bound).all()
    assert ((kv.double() - exact).abs() <= bound).all()


@pytest.mark.parametrize("L,b,s,d,h", CROSS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_cross_kv_is_the_writer(L, b, s, d, h, dtype):
    """``build_cross_kv`` returns what the writer writes, bit for bit, as
    contiguous (L, b, s, h, hd) tensors in the weights' dtype."""
    dec, enc_out = cross_case(L, b, s, d, h, dtype)
    got = tt.build_cross_kv(dec, enc_out, h)
    out = cross_buffers(L, b, s, d, h, dtype)
    tt.write_cross_kv(dec, enc_out, h, out)
    for g, o in zip(got, out):
        assert g.dtype == dtype and g.is_contiguous()
        assert torch.equal(g, o)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("fault", ["shape", "heads", "dtype", "strided"])
def test_write_cross_kv_refuses_a_wrong_buffer(fault, which):
    """A K (0) or V (1) buffer of another shape (or head split), another
    dtype, or one that is not contiguous is refused before anything is
    written."""
    L, b, s, d, h = CROSS_SHAPES[0]
    dec, enc_out = cross_case(L, b, s, d, h)
    out = [torch.zeros(L, b, s, h, d // h) for _ in range(2)]
    out[which] = {
        "shape": lambda: torch.zeros(L, b, s + 1, h, d // h),
        "heads": lambda: torch.zeros(L, b, s, 2 * h, d // (2 * h)),
        "dtype": lambda: torch.zeros(L, b, s, h, d // h,
                                     dtype=torch.bfloat16),
        "strided": lambda: torch.zeros(L, b, s, h, 2 * d // h)[..., ::2],
    }[fault]()
    with pytest.raises(ValueError, match="write_cross_kv"):
        tt.write_cross_kv(dec, enc_out, h, tuple(out))
    assert not any(t.any() for t in out)


def test_gelu_is_jax_default_tanh():
    """jax.nn.gelu defaults to the tanh approximation; torch's to erf,
    which differs by up to ~5e-4 here."""
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tt._bias_gelu(torch.from_numpy(x), torch.zeros(1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_layernorm_is_population_variance():
    """jnp.var is the population variance (torch.var's default is the
    sample one: a d/(d-1) difference, 14% at d=8)."""
    x = np.random.default_rng(10).standard_normal((5, 8)).astype(np.float32)
    s = np.random.default_rng(11).standard_normal(8).astype(np.float32)
    b = np.random.default_rng(12).standard_normal(8).astype(np.float32)
    want = np.asarray(jt._ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = tt._ln(torch.from_numpy(x), torch.from_numpy(s),
                 torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_converter_takes_bf16_numpy():
    """JAX hands out bf16 parameters as numpy bfloat16 arrays, which
    ``torch.from_numpy`` refuses; the converter carries them through f32,
    bit for bit."""
    jcfg, tcfg = cfgs("bfloat16")
    p = jm.init_decoder(jax.random.PRNGKey(13), jcfg)
    raw = jax.tree.map(np.asarray, p)
    assert raw.embed.dtype.name == "bfloat16"
    with pytest.raises(TypeError):
        torch.from_numpy(np.array(raw.embed))
    tp = decoder_from_numpy(raw, tcfg, device="cpu")
    assert tp.embed.dtype == torch.bfloat16
    assert np.array_equal(tp.embed.float().numpy(),
                          np.asarray(raw.embed, np.float32))
    assert np.array_equal(tp.layers.wqkv.float().numpy(),
                          np.asarray(raw.layers["wqkv"], np.float32))


def test_converter_rejects_a_shape_mismatch():
    jcfg, tcfg = cfgs("float32")
    p = f32_tree(jm.init_decoder(jax.random.PRNGKey(14), jcfg))
    other = dataclasses.replace(tcfg, ffn_embed_dim=64)
    with pytest.raises(ValueError, match="w1"):
        decoder_from_numpy(p, other, device="cpu")


def test_init_shapes_and_dtypes():
    _, tcfg = cfgs("bfloat16", model_type="encoder-decoder")
    enc, dec = tt.init_encoder_decoder(0, tcfg, device="cpu")
    assert enc.layers.wqkv.shape == (tcfg.encoder_layers, 64, 192)
    assert enc.out_proj.shape == (64, 1) and enc.cross_layers is None
    assert dec.cross_layers.wkv.shape == (tcfg.layers, 64, 128)
    assert dec.embed.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in dec.parameters())
    # a seed is reproducible
    again = tt.init_decoder(7, tcfg, device="cpu")
    assert torch.equal(again.layers.w1, tt.init_decoder(7, tcfg,
                                                        device="cpu").layers.w1)


def tree_pairs(jp, tp, prefix=""):
    """(name, chamjax array, port tensor) for every parameter of a
    ``TransformerParams``."""
    out = [(prefix + n, getattr(jp, n), getattr(tp, n))
           for n in ("embed", "pos", "out_proj")]
    out += [(prefix + "ln_f." + k, jp.ln_f[k], tp.ln_f[k])
            for k in ("scale", "bias")]
    for stack in ("layers", "cross_layers"):
        j_stack = getattr(jp, stack)
        if j_stack is None:
            assert getattr(tp, stack) is None
            continue
        out += [(f"{prefix}{stack}.{k}", v, getattr(getattr(tp, stack), k))
                for k, v in j_stack.items()]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["decoder", "encoder-decoder"])
def test_init_from_a_seed_equals_chamjax(kind, dtype):
    """A seed gives the JAX package's initial parameters, every one bit for
    bit (f32 draws cast to the config's dtype), with no conversion: both
    draw ``split(key, 5)`` (decoder) or ``split(key)`` then ``split(k, 3)``
    and ``split(k, 5)`` (encoder-decoder) from threefry."""
    jcfg, tcfg = cfgs(dtype, model_type=kind, encoder_layers=2)
    if kind == "decoder":
        pairs = tree_pairs(jm.init_decoder(jax.random.PRNGKey(11), jcfg),
                           tt.init_decoder(11, tcfg, device="cpu"))
    else:
        (je, jd), (te, td) = (
            jm.init_encoder_decoder(jax.random.PRNGKey(11), jcfg),
            tt.init_encoder_decoder(11, tcfg, device="cpu"))
        pairs = tree_pairs(je, te, "enc.") + tree_pairs(jd, td, "dec.")
    for name, want, got in pairs:
        assert got.dtype == tt.dtype_of(tcfg), name
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32),
                                      err_msg=name)
