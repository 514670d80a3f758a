"""The elementwise junctions of a transformer block
(``chamjax_torch/ops/block_norm.py``) on the CPU: the plain versions are
the block's arithmetic before the kernels, bit for bit (the layernorm
chain ``_ln`` was, and ``_ffn``'s ``x + gelu(y @ w1 + b1) @ w2 + b2``), so
the CPU parity tests against chamjax see no change; ``add_ln`` and
``bias_gelu``, which ``_ln``, ``_add_ln``, ``_bias_gelu`` and ``_ffn``
call, send only bf16 rows on the card at a width the kernels take to the
kernels; the model's cores (plain and tensor-parallel)
open one ``block.norm`` span a junction and one ``block.act`` span a FFN;
the wrappers' guards refuse what the kernels do not take.  The kernels
themselves are held against the plain versions on the card
(``tests/test_torch_gpu.py``)."""

import collections
import contextlib
import types

import pytest
import torch
import torch.nn.functional as F

from chamjax_torch import config as tconfig
from chamjax_torch import models as tm
from chamjax_torch.models import transformer as tt
from chamjax_torch.ops import block_norm as bn
from chamjax_torch.parallel import (make_mesh, shard_decoder_params,
                                    shard_kv_cache)
from chamjax_torch.utils import cuda_lib, tracing


def ln_before(x, scale, bias, eps=1e-5):
    """``models/transformer.py::_ln`` as it was before the kernels, kept
    here as the bar."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def randn(*shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * 2 + 0.5).to(dtype)


def same(got, want):
    return got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", ["norm", "delta", "delta+bias", "ffn"])
@pytest.mark.parametrize("width", [256, 512, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_versions_equal_the_block_before(dtype, width, case):
    """``add_ln_reference`` is the residual adds and the layernorm chain
    before the kernels, and ``_ffn`` (through ``bias_gelu_reference``) the
    FFN's ``x + gelu(y @ w1 + b1) @ w2 + b2`` followed by the next
    layernorm, bit for bit."""
    x, delta = (randn(3, 5, width, dtype=dtype, seed=s) for s in (0, 1))
    bias, scale, shift = (randn(width, dtype=dtype, seed=s) for s in (2, 3, 4))
    if case == "ffn":
        f = 2 * width
        L = types.SimpleNamespace(
            w1=randn(1, width, f, dtype=dtype, seed=5) / width ** 0.5,
            b1=randn(1, f, dtype=dtype, seed=6),
            w2=randn(1, f, width, dtype=dtype, seed=7) / f ** 0.5,
            b2=bias[None], ln1_scale=scale[None], ln1_bias=shift[None])
        ln_f = dict(scale=shift, bias=scale)
        y = ln_before(x, scale, shift)
        want_x = x + F.gelu(y @ L.w1[0] + L.b1[0],
                            approximate="tanh") @ L.w2[0] + L.b2[0]
        got_x, got_y = tt._ffn(x, y, L, 0, ln_f)
        assert same(got_x, want_x)
        assert same(got_y, ln_before(want_x, shift, scale))
        return
    d = delta if case != "norm" else None
    b = bias if case == "delta+bias" else None
    want_x = x + delta + bias if b is not None else (
        x + delta if d is not None else x)
    got_x, got_y = bn.add_ln_reference(x, d, b, scale, shift)
    assert same(got_x, want_x)
    assert same(got_y, ln_before(want_x, scale, shift))
    assert same(tt._ln(x, scale, shift), ln_before(x, scale, shift))


def test_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors ``add_ln`` and ``bias_gelu`` launch nothing and are
    the plain versions; ``x_new`` is ``x`` itself where nothing is
    added."""
    x, delta = (randn(4, 512, dtype=torch.bfloat16, seed=s) for s in (0, 1))
    v = [randn(512, dtype=torch.bfloat16, seed=s) for s in (2, 3, 4)]
    before = dict(cuda_lib.launch_counts)
    for d, b in ((None, None), (delta, None), (delta, v[0])):
        got = bn.add_ln(x, d, b, v[1], v[2])
        want = bn.add_ln_reference(x, d, b, v[1], v[2])
        assert all(same(g, w) for g, w in zip(got, want))
    assert bn.add_ln(x, None, None, v[1], v[2])[0] is x
    assert same(bn.bias_gelu(x, v[0]), bn.bias_gelu_reference(x, v[0]))
    assert dict(cuda_lib.launch_counts) == before


def bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def ln_args(**kw):
    """``add_ln``'s inputs at a width the kernel takes, with ``kw`` in place
    of one (checked where the kernel would launch: ``_check``)."""
    args = dict(x=bf16(4, 3, 512), delta=bf16(4, 3, 512), bias=bf16(512),
                scale=bf16(512), ln_bias=bf16(512))
    args.update(kw)
    return ("add_ln", dict(x=args["x"], delta=args["delta"]),
            dict(bias=args["bias"], scale=args["scale"],
                 ln_bias=args["ln_bias"]))


def gelu_args(**kw):
    args = dict(g=bf16(4, 2048), b=bf16(2048))
    args.update(kw)
    return "bias_gelu", dict(g=args["g"]), dict(b=args["b"])


@pytest.mark.parametrize("case,args,match", [
    ("float32 x", ln_args(x=torch.zeros(4, 3, 512)), "x must be bfloat16"),
    ("float16 scale", ln_args(scale=torch.zeros(512, dtype=torch.float16)),
     "scale must be bfloat16"),
    ("scale on another device", ln_args(scale=bf16(512).to("meta")),
     "scale must be bfloat16 on cpu"),
    ("delta of another shape", ln_args(delta=bf16(4, 1, 512)), "delta"),
    ("bias of another width", ln_args(bias=bf16(256)), "bias"),
    ("ln_bias of rows", ln_args(ln_bias=bf16(4, 512)), "ln_bias"),
    ("width 320", ln_args(x=bf16(4, 3, 320)), r"rows of \(320,\)"),
    ("width 4352", ln_args(x=bf16(2, 4352)), r"rows of \(4352,\)"),
    ("width 128", ln_args(x=bf16(2, 128)), r"rows of \(128,\)"),
    ("every other column", ln_args(x=bf16(4, 3, 1024)[..., ::2]),
     "x must be contiguous"),
    ("delta transposed", ln_args(delta=bf16(3, 4, 512).transpose(0, 1)),
     "delta must be contiguous"),
    ("rows unaligned", ln_args(x=bf16(12 * 512 + 1)[1:].reshape(4, 3, 512)),
     "16-byte"),
    ("float32 g", gelu_args(g=torch.zeros(4, 2048)), "g must be bfloat16"),
    ("b of another width", gelu_args(b=bf16(512)), "b "),
    ("g every other row", gelu_args(g=bf16(8, 2048)[::2]),
     "g must be contiguous"),
    ("g width 200", gelu_args(g=bf16(4, 200), b=bf16(200)),
     r"rows of \(200,\)"),
])
def test_kernel_guards_refuse_what_they_do_not_take(case, args, match):
    what, rows, cols = args
    with pytest.raises(ValueError, match=what):
        bn._check(what, rows, cols)
    with pytest.raises(ValueError, match=match):
        bn._check(what, rows, cols)


@pytest.mark.parametrize("shape", [(64, 1, 512), (64, 512, 512), (7, 256),
                                   (2, 4096), (64, 1, 2048)])
def test_kernel_guards_take_the_block_shapes(shape):
    """The decode step's, the encoder's and a FFN's rows pass, with and
    without ``delta`` and ``bias``."""
    w = shape[-1]
    for d, b in ((None, None), (bf16(*shape), None), (bf16(*shape), bf16(w))):
        bn._check("add_ln", dict(x=bf16(*shape), delta=d),
                  dict(bias=b, scale=bf16(w), ln_bias=bf16(w)))
    bn._check("bias_gelu", dict(g=bf16(*shape)), dict(b=bf16(w)))


def test_wrappers_refuse_a_device_that_is_not_a_card():
    x = bf16(2, 512).to("meta")
    with pytest.raises(ValueError, match="add_ln: unsupported device meta"):
        bn.add_ln(x, None, None, x[0], x[0])
    with pytest.raises(ValueError, match="bias_gelu: unsupported device"):
        bn.bias_gelu(x, x[0])


class OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: what the dispatch decides
    on, without one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype,card,width,norm,act", [
    (torch.bfloat16, True, 512, True, True),    # Dec-S: FFN 2048
    (torch.bfloat16, True, 1024, True, True),   # FFN 4096
    (torch.bfloat16, True, 64, False, True),    # rows the norm lacks
    (torch.bfloat16, True, 96, False, False),   # FFN 384
    (torch.bfloat16, True, 1280, True, False),  # FFN 5120, past 4096
    (torch.float32, True, 512, False, False),
    (torch.bfloat16, False, 512, False, False),     # the CPU
    (torch.float32, False, 64, False, False),
])
def test_ln_and_ffn_send_only_bf16_card_rows_to_the_kernels(
        monkeypatch, dtype, card, width, norm, act):
    """``_ln`` and ``_ffn`` reach the kernels' launches through
    ``block_norm.add_ln`` (``_ln`` with no ``delta`` or ``bias``, ``_ffn``
    after w2 with both) and ``bias_gelu`` on bf16 rows on the card at a
    width the kernel takes, each deciding on its own rows' width, past the
    kernels' guards; CPU and float32 rows and other widths keep the plain
    chain (the same values)."""
    calls = []

    def spy(name, real):
        def call(*a):
            calls.append((name, *(t is not None for t in a[1:3])))
            return real(*a)
        return call

    monkeypatch.setattr(bn, "_add_ln_kernel",
                        spy("add_ln", bn.add_ln_reference))
    monkeypatch.setattr(bn, "_bias_gelu_kernel",
                        spy("bias_gelu", bn.bias_gelu_reference))
    f = 4 * width
    ts = dict(x=randn(2, 1, width, dtype=dtype, seed=0),
              w1=randn(1, width, f, dtype=dtype, seed=1) / width ** 0.5,
              b1=randn(1, f, dtype=dtype, seed=2),
              w2=randn(1, f, width, dtype=dtype, seed=3) / f ** 0.5,
              b2=randn(1, width, dtype=dtype, seed=4),
              ln1_scale=randn(1, width, dtype=dtype, seed=5),
              ln1_bias=randn(1, width, dtype=dtype, seed=6))

    def block(t):
        L = types.SimpleNamespace(**t)
        ln = (L.ln1_scale[0], L.ln1_bias[0])
        y = tt._ln(L.x, *ln)
        return (y, *tt._ffn(L.x, y, L, 0, dict(zip(("scale", "bias"), ln))))

    want = block(ts)
    assert not calls
    if card:
        ts = {k: v.as_subclass(OnCard) for k, v in ts.items()}
    got = block(ts)
    assert calls == ([("add_ln", False, False)] if norm else []) + (
        [("bias_gelu", True)] if act else []) + (
        [("add_ln", True, True)] if norm else [])
    for g, w in zip(got, want):
        assert same(g.as_subclass(torch.Tensor), w)


def on_card(t):
    return t.as_subclass(OnCard)


@pytest.mark.parametrize("case,match", [
    ("strided delta", "add_ln: delta must be contiguous"),
    ("float32 scale", "add_ln: scale must be bfloat16"),
    ("unaligned bias", "add_ln: bias must be contiguous rows from a 16-byte"),
    ("delta of another shape", r"add_ln: delta \(4, 1, 512\)"),
    ("strided g", "bias_gelu: g must be contiguous"),
    ("b of another width", r"bias_gelu: b \(256,\)"),
])
def test_card_rows_raise_on_an_operand_the_kernel_lacks(case, match):
    """bf16 rows on the card at a width the kernels have never fall back to
    the plain chain at the model's junctions (``_add_ln``, ``_bias_gelu``):
    an operand the kernel does not take raises before any launch."""
    x, v = on_card(bf16(4, 3, 512)), on_card(bf16(512))
    args = dict(delta=on_card(bf16(4, 3, 512)), bias=v, scale=v, ln_bias=v)
    if case == "strided delta":
        args["delta"] = on_card(bf16(4, 6, 512)[:, ::2])
    elif case == "float32 scale":
        args["scale"] = on_card(torch.zeros(512))
    elif case == "unaligned bias":
        args["bias"] = on_card(bf16(513)[1:])
    elif case == "delta of another shape":
        args["delta"] = on_card(bf16(4, 1, 512))
    before = dict(cuda_lib.launch_counts)
    with pytest.raises(ValueError, match=match):
        if case == "strided g":
            tt._bias_gelu(on_card(bf16(8, 2048)[::2]), on_card(bf16(2048)))
        elif case == "b of another width":
            tt._bias_gelu(on_card(bf16(4, 512)), on_card(bf16(256)))
        else:
            tt._add_ln(x, *args.values())
    assert dict(cuda_lib.launch_counts) == before


SHAPE = dict(embed_dim=64, ffn_embed_dim=128, layers=3, attention_heads=4,
             vocab_size=97, max_seq_len=16, dtype="float32",
             encoder_layers=2)


@pytest.mark.parametrize("tp", [False, True])
@pytest.mark.parametrize("kind", ["decoder", "encoder-decoder"])
def test_cores_open_a_span_at_each_junction(kind, tp, monkeypatch):
    """A decode step opens a ``block.norm`` span at each of its 2L + 1
    junctions (3L + 1 with cross-attention: layer 0's ``ln1``, then after
    each attention and each FFN) and a ``block.act`` span a layer; the
    encoder 2 · layers + 1 and one a layer; the prefill as the step
    without cross-attention.  Nothing else opens inside them.  The
    tensor-parallel core (a 2 × 2 grid of CPU positions) opens the norms
    once a dp row and the GELU on every position."""
    cfg = tconfig.ModelConfig(model_type=kind, **SHAPE)
    spans = collections.Counter()
    open_spans = []

    @contextlib.contextmanager
    def annotate(name):
        if name.startswith("block."):
            assert not any(s.startswith("block.") for s in open_spans)
        open_spans.append(name)
        try:
            yield
        finally:
            open_spans.pop()
        spans[name] += 1

    mesh = make_mesh((("dp", 2), ("tp", 2)), devices=["cpu"] * 4)
    place = ((lambda p: shard_decoder_params(p, mesh)) if tp
             else (lambda p: p))
    monkeypatch.setattr(tracing, "annotate", annotate)
    Ld, Le = cfg.layers, cfg.encoder_layers
    rows, cols = (2, 4) if tp else (1, 1)
    cross = {}
    if kind == "encoder-decoder":
        enc, dec = map(place, tt.init_encoder_decoder(0, cfg, device="cpu"))
        src = torch.randint(1, 97, (2, 5), dtype=torch.int32)
        vl = torch.tensor([3, 5], dtype=torch.int32)
        out = tm.encoder_forward(enc, src, 4, valid_len=vl)
        assert spans["block.norm"] == rows * (2 * Le + 1)
        assert spans["block.act"] == cols * Le
        cross = dict(cross_kv=tt.build_cross_kv(dec, out, 4),
                     cross_valid_len=vl)
    else:
        dec = place(tt.init_decoder(0, cfg, device="cpu"))
    cache = tt.init_kv_cache(cfg, 2, device="cpu")
    if tp:
        cache = shard_kv_cache(cache, mesh)
    spans.clear()
    _, _, cache = tt.decoder_prefill(dec, torch.ones((2, 3),
                                                     dtype=torch.int32),
                                     cache, 4)
    assert spans["block.norm"] == rows * (2 * Ld + 1)
    assert spans["block.act"] == cols * Ld
    spans.clear()
    _, _, cache = tt.decoder_step(dec, torch.ones(2, dtype=torch.int32),
                                  cache, 4, **cross)
    per = 3 if cross else 2
    assert spans["block.norm"] == rows * (per * Ld + 1)
    assert spans["block.act"] == cols * Ld
