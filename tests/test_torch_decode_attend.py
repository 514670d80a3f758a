"""The decode step's attention (``chamjax_torch/ops/decode_attend.py``) on
the CPU: the wrapper's plain route is the step's arithmetic before the
kernel, bit for bit — ``_attn_full`` at one query with and without
``valid_len``, and the self-attention step with the current token as a
separate term — so the CPU parity tests against chamjax see no change;
the model's cores (plain and tensor-parallel) reach it once a layer for
the self-attention and once more for the cross-attention; the wrapper's
guards refuse what the kernel does not take.  The kernel itself is held
against the plain version on the card (``tests/test_torch_gpu.py``)."""

import collections

import pytest
import torch

from chamjax_torch import config as tconfig
from chamjax_torch import models as tm
from chamjax_torch.models import transformer as tt
from chamjax_torch.ops import decode_attend as da
from chamjax_torch.parallel import (make_mesh, shard_decoder_params,
                                    shard_kv_cache)
from chamjax_torch.utils import cuda_lib

DTYPES = [torch.float32, torch.bfloat16]


def history(b, T, h, hd, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, kh, vh = (torch.randn(b, 1, h, hd, generator=g).to(dtype)
                 for _ in range(3))
    k, v = (torch.randn(b, T, h, hd, generator=g).to(dtype)
            for _ in range(2))
    return q, k, v, kh, vh


def attend_step_before(qh, kh, vh, k_hist, v_hist, strict_mask):
    """The self-attention step as ``models/transformer.py`` computed it
    before the wrapper (its ``_attend_step``), kept here as the bar."""
    T = k_hist.shape[1]
    hd = qh.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", qh.float(),
                          k_hist.float()) * hd ** -0.5
    scores = scores.masked_fill(~strict_mask.reshape(1, 1, 1, T),
                                float("-inf"))
    self_score = (qh * kh).float().sum(dim=-1) * hd ** -0.5
    self_score = self_score.transpose(1, 2)[:, :, :, None]
    all_scores = torch.cat([scores, self_score], dim=-1)
    p = torch.softmax(all_scores, dim=-1).to(qh.dtype)
    return (torch.einsum("bhqk,bkhd->bqhd", p[..., :T], v_hist)
            + p[..., T:].transpose(1, 2) * vh)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_route_equals_attn_full_at_one_query(dtype, ragged):
    """The cross-attention call: ``attend`` on the CPU equals
    ``_attn_full(causal=False)`` bit for bit, with a per-row valid length
    (0, 1, part and all of T) and without one."""
    q, k, v, _, _ = history(4, 12, 4, 16, dtype)
    vl = torch.tensor([0, 1, 7, 12], dtype=torch.int32) if ragged else None
    want = tt._attn_full(q, k, v, causal=False, valid_len=vl)
    got = da.attend(q, k, v, vl)
    assert got.dtype == dtype and torch.equal(got.nan_to_num(),
                                              want.nan_to_num())
    assert torch.equal(got.isnan(), want.isnan())   # row 0 holds nothing


@pytest.mark.parametrize("idx", [0, 1, 5, 11, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_route_equals_the_step_before(dtype, idx):
    """The self-attention call: ``attend`` with ``self_kv`` and a 0-d
    ``idx`` equals the step's own arithmetic before the wrapper, bit for
    bit, from an empty history to a full one."""
    q, k, v, kh, vh = history(3, 12, 4, 16, dtype, seed=idx)
    idx_t = torch.tensor(idx, dtype=torch.int32)
    want = attend_step_before(q, kh, vh, k, v, torch.arange(12) < idx_t)
    got = da.attend(q, k, v, idx_t, self_kv=(kh, vh))
    assert got.dtype == dtype and torch.equal(got, want)


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors ``attend`` launches nothing and is
    ``attend_reference``; strided views (the step's q, k, v are chunks of
    one projection) give the result of their contiguous copies."""
    q, k, v, kh, vh = history(2, 9, 4, 8, torch.float32)
    before = cuda_lib.launch_counts["decode_attend"]
    n = torch.tensor(6, dtype=torch.int32)
    qkv = torch.cat([t.reshape(2, 1, 32) for t in (q, kh, vh)], dim=-1)
    qs, ks, vs = (t.reshape(2, 1, 4, 8) for t in qkv.chunk(3, dim=-1))
    assert not qs.is_contiguous()
    got = da.attend(qs, k, v, n, self_kv=(ks, vs))
    assert torch.equal(got, da.attend_reference(q, k, v, n, (kh, vh)))
    assert cuda_lib.launch_counts["decode_attend"] == before


@pytest.mark.parametrize("vecs,threads", [
    (64, 256),      # Dec-S in bf16: 64 slices a position, 4 positions a pass
    (128, 256),     # Dec-S in f32: 2 a pass
    (16, 256),      # 8 heads of 16 in bf16: 16 a pass
    (24, 192),      # 3 heads of 64 in bf16: 8 a pass, whole warps
    (96, 192),      # 12 heads of 64 in bf16: 2 a pass
    (200, 0),       # no whole number of warps in 256 threads
])
def test_block_size_follows_the_kernel_layout(vecs, threads):
    """A CTA's threads (the kernel's ``threads_for``): whole passes of a
    position's 16-byte slices, whole warps, at most 256; 0 refuses."""
    assert da._threads(vecs) == threads


def bad(**kw):
    """Inputs that break one of the kernel's terms (checked where the
    kernel would launch: ``_check``)."""
    q, k, v, kh, vh = history(2, 8, 4, 16, torch.float32)
    args = dict(q=q, k_hist=k, v_hist=v, length=None, self_kv=(kh, vh))
    args.update(kw)
    return args


@pytest.mark.parametrize("case,args", [
    ("two queries", bad(q=torch.zeros(2, 2, 4, 16))),
    ("float16", bad(q=torch.zeros(2, 1, 4, 16, dtype=torch.float16))),
    ("mixed dtypes", bad(k_hist=torch.zeros(2, 8, 4, 16,
                                            dtype=torch.bfloat16))),
    ("heads apart", bad(k_hist=torch.zeros(2, 4, 8, 16).transpose(1, 2))),
    ("head_dim 12", bad(q=torch.zeros(2, 1, 4, 12),
                        k_hist=torch.zeros(2, 8, 4, 12),
                        v_hist=torch.zeros(2, 8, 4, 12), self_kv=None)),
    ("rows unaligned", bad(k_hist=torch.zeros(2 * 8 * 64 + 1)[1:].reshape(
        2, 8, 4, 16))),
    ("V of another length", bad(v_hist=torch.zeros(2, 7, 4, 16))),
    ("lengths of another batch", bad(length=torch.zeros(3,
                                                        dtype=torch.int32))),
])
def test_kernel_guards_refuse_what_it_does_not_take(case, args):
    with pytest.raises(ValueError, match="decode_attend"):
        da._check(**args)


def test_kernel_guards_take_the_step_shapes():
    """The shapes the cells and the card tests run pass the guards."""
    for b, T, h, hd, dtype in [(64, 512, 8, 64, torch.bfloat16),
                               (2, 16, 4, 16, torch.float32),
                               (64, 512, 16, 64, torch.bfloat16),
                               (8, 32, 4, 32, torch.float32)]:
        q, k, v, kh, vh = history(b, T, h, hd, dtype)
        da._check(q, k, v, torch.tensor(3), (kh, vh))
        da._check(q, k, v, torch.full((b,), 3), None)


SHAPE = dict(embed_dim=64, ffn_embed_dim=128, layers=3, attention_heads=4,
             vocab_size=97, max_seq_len=16, dtype="float32")


@pytest.mark.parametrize("tp", [False, True])
@pytest.mark.parametrize("kind", ["decoder", "encoder-decoder"])
def test_decode_step_attends_through_the_wrapper(kind, tp, monkeypatch):
    """A decode step calls ``attend`` once a layer with the current token
    as ``self_kv`` and the cache's ``idx`` as its length, and an
    encoder-decoder's once more a layer over the cross K/V with
    ``cross_valid_len``; prefill and the encoder keep ``_attn_full``.  The
    tensor-parallel core (a 2 x 2 grid of CPU positions) calls it once a
    layer on each position."""
    cfg = tconfig.ModelConfig(model_type=kind, **SHAPE)
    calls = collections.Counter()
    real = da.attend

    def counting(q, k_hist, v_hist, length=None, self_kv=None):
        calls["self" if self_kv is not None else "cross"] += 1
        calls["length_is_idx"] += length is not None and length.dim() == 0
        return real(q, k_hist, v_hist, length, self_kv)

    monkeypatch.setattr(da, "attend", counting)
    mesh = make_mesh((("dp", 2), ("tp", 2)), devices=["cpu"] * 4)
    place = ((lambda p: shard_decoder_params(p, mesh)) if tp
             else (lambda p: p))
    cross = {}
    if kind == "encoder-decoder":
        enc, dec = map(place, tt.init_encoder_decoder(0, cfg, device="cpu"))
        src = torch.randint(1, 97, (2, 5), dtype=torch.int32)
        vl = torch.tensor([3, 5], dtype=torch.int32)
        out = tm.encoder_forward(enc, src, 4, valid_len=vl)
        cross = dict(cross_kv=tt.build_cross_kv(dec, out, 4),
                     cross_valid_len=vl)
    else:
        dec = place(tt.init_decoder(0, cfg, device="cpu"))
    cache = tt.init_kv_cache(cfg, 2, device="cpu")
    if tp:
        cache = shard_kv_cache(cache, mesh)
    _, _, cache = tt.decoder_prefill(dec, torch.ones((2, 3),
                                                     dtype=torch.int32),
                                     cache, 4)
    assert not calls
    for _ in range(2):
        _, _, cache = tt.decoder_step(dec, torch.ones(2, dtype=torch.int32),
                                      cache, 4, **cross)
    n = 2 * cfg.layers * (4 if tp else 1)
    assert calls["self"] == n and calls["length_is_idx"] == n
    assert calls["cross"] == (n if kind == "encoder-decoder" else 0)
