"""The encoder's attention (``chamjax_torch/ops/encode_attend.py``).

On the CPU: the plain version is ``_attn_full(causal=False)``, bit for
bit, with and without a per-row ``valid_len`` (a row of length 0
included); the wrapper takes it on a CPU tensor; its guards refuse what the
kernel does not take; ``_attn_full`` sends only bidirectional bf16 calls on
the card to the kernel and keeps its own arithmetic for CPU, float32 and
causal calls; the encoder opens an ``encode.attend`` span around each
layer's attention.

On the card (marked ``gpu``, skipped where there is none; this file
imports neither jax nor chamjax, so it runs with ``--noconftest``): the
kernel on the strided views of a fused QKV product is no farther from the
float64 attention than twice the plain version's distance plus one bf16
ulp, at EncDec-S's shape and at ragged lengths; it reads no key at or past
a row's length; replays of a captured launch equal an eager one bit for
bit; a refill replay launches it once an encoder layer.

    python -m pytest --noconftest -m gpu tests/test_torch_encode_attend.py -q
"""

import collections
import contextlib

import pytest
import torch

from chamjax_torch import config as tconfig
from chamjax_torch.models import transformer as tt
from chamjax_torch.ops import encode_attend as ea
from chamjax_torch.utils import cuda_lib, tracing


def fused_qkv(b, s, h, hd, dtype=torch.bfloat16, device="cpu", seed=0):
    """q, k, v as the encoder makes them: the (b, s, h, hd) views of the
    three chunks of one (b, s, 3·h·hd) product (row stride 3·h·hd), q
    scaled so that the softmax is far from flat."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, 3 * h * hd, generator=g)
    x[..., :h * hd] *= 2.0
    x = x.to(device, dtype)
    return tuple(t.reshape(b, s, h, hd) for t in x.chunk(3, dim=-1))


def lengths(b, s, device="cpu"):
    """One count a row from 0 to s, in no order."""
    n = torch.arange(b) * s // max(b - 1, 1)
    return n[torch.randperm(b, generator=torch.Generator().manual_seed(
        b + s))].to(device, torch.int32)


def same(got, want):
    return (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(), want.nan_to_num()))


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hd", [(3, 1, 2, 16), (4, 7, 4, 16),
                                      (2, 33, 8, 64), (5, 20, 2, 128)])
def test_plain_version_equals_attn_full(b, s, h, hd, dtype, ragged):
    """``attend_reference`` is ``_attn_full(causal=False)`` op for op: equal
    bit for bit, NaN where a row holds no key (``ragged`` has one)."""
    q, k, v = fused_qkv(b, s, h, hd, dtype)
    vl = lengths(b, s) if ragged else None
    want = tt._attn_full(q, k, v, causal=False, valid_len=vl)
    got = ea.attend_reference(q, k, v, vl)
    assert got.dtype == dtype and got.shape == (b, s, h, hd)
    assert same(got, want)
    if ragged:
        assert got[vl == 0].isnan().all() and not got[vl > 0].isnan().any()


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors ``attend`` launches nothing and is
    ``attend_reference``; the strided views give the result of their
    contiguous copies."""
    q, k, v = fused_qkv(3, 9, 4, 16)
    assert not q.is_contiguous()
    vl = torch.tensor([9, 0, 4], dtype=torch.int64)
    before = cuda_lib.launch_counts["encode_attend"]
    got = ea.attend(q, k, v, vl)
    assert same(got, ea.attend_reference(q.contiguous(), k.contiguous(),
                                         v.contiguous(), vl))
    assert cuda_lib.launch_counts["encode_attend"] == before


def bad(**kw):
    """Inputs that break one of the kernel's terms (checked where the
    kernel would launch: ``_check``)."""
    q, k, v = fused_qkv(2, 8, 4, 64)
    args = dict(q=q, k=k, v=v, valid_len=None)
    args.update(kw)
    return args


def bf16_zeros(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,args", [
    ("rank 3", bad(q=bf16_zeros(2, 8, 256))),
    ("float32", bad(q=torch.zeros(2, 8, 4, 64))),
    ("float16", bad(k=torch.zeros(2, 8, 4, 64, dtype=torch.float16))),
    ("head_dim 48", bad(**dict(zip("qkv", fused_qkv(2, 8, 4, 48))))),
    ("head_dim 32", bad(**dict(zip("qkv", fused_qkv(2, 8, 4, 32))))),
    ("head_dim 16", bad(**dict(zip("qkv", fused_qkv(2, 8, 4, 16))))),
    ("every other value", bad(q=bf16_zeros(2, 8, 4, 128)[..., ::2])),
    ("values apart", bad(v=bf16_zeros(2, 8, 64, 4).transpose(2, 3))),
    ("positions unaligned", bad(k=bf16_zeros(2 * 8 * 260).as_strided(
        (2, 8, 4, 64), (8 * 260, 260, 64, 1)))),
    ("rows unaligned", bad(k=bf16_zeros(2 * 8 * 256 + 1)[1:].reshape(
        2, 8, 4, 64))),
    ("V of another length", bad(v=bf16_zeros(2, 7, 4, 64))),
    ("no keys", bad(k=bf16_zeros(2, 0, 4, 64), v=bf16_zeros(2, 0, 4, 64))),
    ("lengths of another batch", bad(valid_len=torch.zeros(
        3, dtype=torch.int32))),
    ("float lengths", bad(valid_len=torch.zeros(2))),
    ("lengths 2-d", bad(valid_len=torch.zeros(2, 1, dtype=torch.int32))),
])
def test_kernel_guards_refuse_what_it_does_not_take(case, args):
    with pytest.raises(ValueError, match="encode_attend"):
        ea._check(**args)


@pytest.mark.parametrize("b,s,h,hd", [(64, 512, 8, 64), (64, 1, 8, 64),
                                      (3, 7, 1, 64), (2, 100, 4, 128)])
def test_kernel_guards_take_the_encoder_shapes(b, s, h, hd):
    """The fused QKV product's views (EncDec-S's refill and query encoder,
    a tensor-parallel position's one head, a head of 128) pass, with int32
    and int64 lengths; so do contiguous (b, s, h, hd) tensors and heads
    before positions."""
    q, k, v = fused_qkv(b, s, h, hd)
    for vl in (None, lengths(b, s), lengths(b, s).long()):
        ea._check(q, k, v, vl)
    ea._check(q.contiguous(), k.contiguous(), v.contiguous(), None)
    ea._check(*(t.transpose(1, 2).contiguous().transpose(1, 2)
                for t in (q, k, v)), None)


class OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: what ``_attn_full``
    decides on, without one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype,causal,card,hd,kernel", [
    (torch.bfloat16, False, True, 64, True),
    (torch.bfloat16, False, True, 128, True),
    (torch.bfloat16, True, True, 64, False),
    (torch.float32, False, True, 64, False),
    (torch.bfloat16, False, True, 16, False),
    (torch.bfloat16, False, False, 64, False),
    (torch.float32, True, False, 64, False),
])
def test_attn_full_sends_only_bidirectional_bf16_card_calls(
        monkeypatch, dtype, causal, card, hd, kernel):
    """``_attn_full`` calls ``encode_attend.attend`` for a bidirectional
    call on bf16 tensors on the card at a head dim the kernel takes, and
    keeps its own arithmetic (equal to the call on plain CPU tensors) for
    CPU, float32 and causal calls and other head dims."""
    calls = []
    monkeypatch.setattr(ea, "attend", lambda *a: calls.append(a) or "kernel")
    q, k, v = fused_qkv(2, 6, 2, hd, dtype)
    vl = None if causal else torch.tensor([6, 3], dtype=torch.int32)
    want = tt._attn_full(q, k, v, causal, vl)
    assert not calls
    args = [t.as_subclass(OnCard) if card else t for t in (q, k, v)]
    got = tt._attn_full(*args, causal, vl)
    assert len(calls) == int(kernel)
    if kernel:
        assert got == "kernel" and calls[0][3] is vl
    else:
        assert same(got.as_subclass(torch.Tensor), want)


SHAPE = dict(embed_dim=64, ffn_embed_dim=128, layers=2, attention_heads=4,
             vocab_size=97, max_seq_len=16, dtype="float32",
             encoder_layers=3)


def test_encoder_opens_a_span_around_each_attention(monkeypatch):
    """``_encoder_forward`` calls ``_attn_full`` (bidirectional, with the
    call's ``valid_len``) once a layer, each inside an ``encode.attend``
    span, and nothing else there."""
    cfg = tconfig.ModelConfig(model_type="encoder-decoder", **SHAPE)
    enc, _ = tt.init_encoder_decoder(0, cfg, device="cpu")
    open_spans, seen = [], collections.Counter()
    real_attn = tt._attn_full

    @contextlib.contextmanager
    def annotate(name):
        open_spans.append(name)
        try:
            yield
        finally:
            open_spans.pop()

    def attn(q, k, v, causal, valid_len=None):
        seen[(tuple(open_spans), causal, valid_len is vl)] += 1
        return real_attn(q, k, v, causal, valid_len)

    vl = torch.tensor([5, 2], dtype=torch.int32)
    src = torch.randint(1, 97, (2, 5), dtype=torch.int32)
    want = tt.encoder_forward(enc, src, 4, valid_len=vl)
    monkeypatch.setattr(tracing, "annotate", annotate)
    monkeypatch.setattr(tt, "_attn_full", attn)
    got = tt.encoder_forward(enc, src, 4, valid_len=vl)
    assert seen == {(("encode.attend",), False, True): 3}
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda", 0)


def attend_f64(q, k, v, valid_len):
    """The same attention in float64 from the same stored values."""
    hd, tk = q.shape[-1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * hd ** -0.5
    if valid_len is not None:
        past = torch.arange(tk, device=q.device) >= valid_len.reshape(-1, 1)
        s = s.masked_fill(past[:, None, None, :], float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                        v.double())


def max_ulps(x, truth):
    """The largest |x - truth| in bfloat16 ulps at |truth| (below 2^-6, at
    2^-6), over the values that are not NaN."""
    held = ~truth.isnan()
    ulp = torch.exp2(torch.floor(torch.log2(
        truth[held].abs().clamp_min(2.0 ** -6))) - 7)
    return float(((x[held].double() - truth[held]).abs() / ulp).max())


CARD_SHAPES = [
    (64, 512, 8, 64, False),        # EncDec-S's refill: no valid_len
    (64, 512, 8, 64, True),
    (64, 1, 8, 64, False),          # the query encoder
    (16, 1, 8, 64, True),
    (16, 7, 8, 64, True),
    (16, 100, 8, 64, True),
    (16, 511, 8, 64, True),
    (4, 700, 2, 64, True),
    (8, 300, 4, 128, True),
    (8, 65, 4, 128, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,hd,ragged", CARD_SHAPES)
def test_encode_attend_within_bar_of_float64_on_card(cuda_device, b, s, h,
                                                     hd, ragged):
    """The kernel on the strided views of a fused QKV product, one launch,
    a contiguous bf16 output; NaN exactly where a row holds no key, as the
    plain version; elsewhere no farther from the float64 attention of the
    same values than twice the plain version's largest distance plus one
    bf16 ulp."""
    q, k, v = fused_qkv(b, s, h, hd, device=cuda_device, seed=s + hd)
    vl = lengths(b, s, cuda_device) if ragged else None
    before = cuda_lib.launch_counts["encode_attend"]
    got = ea.attend(q, k, v, vl)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["encode_attend"] == before + 1
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == (b, s, h, hd)
    want = ea.attend_reference(q, k, v, vl)
    truth = attend_f64(q, k, v, vl)
    assert torch.equal(got.isnan(), truth.isnan())
    assert torch.equal(want.isnan(), truth.isnan())
    assert max_ulps(got, truth) <= 2 * max_ulps(want, truth) + 1


@pytest.mark.gpu
@pytest.mark.parametrize("s", [7, 100, 512])
def test_encode_attend_never_reads_past_valid_len_on_card(cuda_device, s):
    """Every K and V position at or past a row's length set to NaN: the
    output does not change, bit for bit.  Had the kernel read one, its row
    would be NaN."""
    q, k, v = fused_qkv(16, s, 8, 64, device=cuda_device, seed=1)
    vl = lengths(16, s, cuda_device)
    clean = ea.attend(q, k, v, vl)
    past = (torch.arange(s, device=cuda_device)
            >= vl.reshape(-1, 1))[:, :, None, None].expand_as(k)
    poisoned = ea.attend(q, k.masked_fill(past, float("nan")),
                         v.masked_fill(past, float("nan")), vl)
    torch.cuda.synchronize()
    assert same(clean, poisoned)
    assert torch.equal(clean.isnan().reshape(16, -1).any(1), vl == 0)


@pytest.mark.gpu
def test_encode_attend_captured_equals_eager_on_card(cuda_device):
    """A launch captured in a CUDA graph: each replay equals an eager
    launch on the same inputs bit for bit, and the capture allocates only
    the output."""
    q, k, v = fused_qkv(64, 512, 8, 64, device=cuda_device, seed=3)
    vl = lengths(64, 512, cuda_device)
    eager = ea.attend(q, k, v, vl)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ea.attend(q, k, v, vl)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert same(out, eager)


@pytest.mark.gpu
def test_refill_replay_launches_encode_attend_per_layer_on_card(
        cuda_device):
    """At EncDec-S's widths (bf16, 2 encoder layers, 8 heads of 64, 512
    retrieved tokens a row), each replay of the captured refill adds two
    ``encode_attend`` launches; the query encoder's (s = 1) captured call
    adds two more."""
    import dataclasses
    from chamjax_torch.benchmarks.ralm_device_bench import init_params
    from chamjax_torch.config import MODEL_PRESETS
    from chamjax_torch.models import encoder_forward
    from chamjax_torch.serving.ralm import CrossKV
    cfg = dataclasses.replace(MODEL_PRESETS["EncDec-S"], dtype="bfloat16",
                              layers=2)
    enc, dec = init_params(cfg, 0, cuda_device)
    cross = CrossKV(enc, dec, cfg, tokens_per_doc=64)
    ids = torch.randint(0, 10 ** 6, (4, cfg.k), device=cuda_device)
    cross.from_ids(ids)                                 # the capture
    q_tokens = torch.ones((4, 1), dtype=torch.int32, device=cuda_device)
    encoder_forward(enc, q_tokens, cfg.attention_heads)
    torch.cuda.synchronize()
    before = cuda_lib.launch_counts["encode_attend"]
    for _ in range(3):
        cross.from_ids(ids)
    torch.cuda.synchronize()
    assert len(cross.graphs) == 1
    assert cuda_lib.launch_counts["encode_attend"] == before + 3 * 2
    encoder_forward(enc, q_tokens, cfg.attention_heads)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["encode_attend"] == before + 4 * 2
