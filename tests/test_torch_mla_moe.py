"""The ``deepseek_v3`` family (``chamjax_torch/models/mla_moe.py``):
latent attention over a compressed cache and routed experts, held to the
plain float32 reference ``ref_mla_moe.py`` (no cache, no absorption, an
expert loop) on the CPU at a tiny size, and on the card (tests marked
``gpu``, which skip where there is none) the latent kernel against its
plain version at Moonlight-16B-A3B's shapes and a step at the published
widths against the reference.  Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_mla_moe.py -q
"""

import types

import numpy as np
import pytest
import torch

import ref_mla_moe as ref
from chamjax_torch.models import mla_moe as mm
from chamjax_torch.ops import latent_attend
from chamjax_torch.utils import cuda_lib

CPU = torch.device("cpu")
TINY = mm.MlaMoeConfig(
    vocab_size=101, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=2, num_attention_heads=4,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=2,
    max_position_embeddings=32, max_seq_len=32, dtype="float32")
NAMES = ("embed", "attn_norm", "wq", "wkv_a", "kv_norm", "wkv_b", "wo",
         "ffn_norm", "dense_gate_up", "dense_down", "router", "e_bias",
         "expert_gate_up", "expert_down", "shared_gate_up", "shared_down",
         "final_norm", "head")


@pytest.fixture(scope="module")
def tiny():
    """The tiny model's parameters (seeded), their float32 copies for the
    reference, and a prompt with its continuation."""
    p = mm.init_mla_moe(11, TINY, device=CPU)
    w = {n: getattr(p, n).detach().float() for n in NAMES}
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, TINY.vocab_size, (3, 12), generator=g,
                           dtype=torch.int32)
    with torch.no_grad():
        want, hidden = ref.forward(TINY, w, tokens)
    return types.SimpleNamespace(p=p, w=w, tokens=tokens, want=want,
                                 hidden=hidden)


def _decode(p, tokens, prompt: int):
    """Prefill ``prompt`` tokens, then decode the rest one at a time:
    (the prefill's last logits and each step's logits (b, t - prompt, V),
    the steps' hidden states, the cache)."""
    b, t = tokens.shape
    cache = mm.init_latent_cache(TINY, b, device=CPU)
    first, _, cache = mm.mla_moe_prefill(p, tokens[:, :prompt], cache,
                                         rows=2)
    logits, hidden = [], []
    for i in range(prompt, t):
        lg, h, cache = mm.mla_moe_step(p, tokens[:, i], cache)
        logits.append(lg)
        hidden.append(h)
    return first, torch.stack(logits, 1), torch.stack(hidden, 1), cache


@pytest.mark.parametrize("prompt", [1, 5])
def test_prefill_then_absorbed_steps_match_full_forward(tiny, prompt):
    """Prefill (decompressed, in row chunks) then decode through the
    latent cache (absorbed) gives the reference's full forward: the
    prefill's last logits and every step's logits and hidden state."""
    first, logits, hidden, cache = _decode(tiny.p, tiny.tokens, prompt)
    np.testing.assert_allclose(first.numpy(),
                               tiny.want[:, prompt - 1].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(),
                               tiny.want[:, prompt:].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hidden.numpy(),
                               tiny.hidden[:, prompt:].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert cache.host_idx == int(cache.idx) == tiny.tokens.shape[1]


def test_moe_layer_matches_expert_loop(tiny):
    """The routed layer (device routing, sort by expert, offsets, grouped
    products, weighted sum) against the reference's loop over experts."""
    g = torch.Generator().manual_seed(5)
    h2 = torch.randn(37, TINY.hidden_size, generator=g)
    got, top = mm.moe(TINY, tiny.p, 0, h2)
    want = ref.moe(TINY, h2, tiny.w, 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    ref_top, _ = ref.route(TINY, h2, tiny.w["router"][0], tiny.w["e_bias"][0])
    assert torch.equal(top.sort(-1).values, ref_top.sort(-1).values)


BIASED = 2, 5       # experts given e_bias +1 and -1


@pytest.fixture(scope="module")
def biased():
    """The tiny model with a router bias that decides the choice: +1 on
    one expert, -1 on another; its float32 copies and rows to route."""
    p = mm.init_mla_moe(11, TINY, device=CPU)
    with torch.no_grad():
        p.e_bias[0].zero_()
        p.e_bias[0, BIASED[0]] = 1.0
        p.e_bias[0, BIASED[1]] = -1.0
    w = {n: getattr(p, n).detach().float() for n in NAMES}
    g = torch.Generator().manual_seed(6)
    h2 = torch.randn(37, TINY.hidden_size, generator=g)
    return types.SimpleNamespace(p=p, w=w, h2=h2, want=ref.moe(TINY, h2, w,
                                                               0))


def test_router_bias_decides_the_choice(biased):
    """With a bias of +1 on one expert and -1 on another, every row takes
    the first and none the second, and the routed layer equals the
    reference's expert loop, its own routing (no route followed)."""
    got, top = mm.moe(TINY, biased.p, 0, biased.h2)
    assert (top == BIASED[0]).any(-1).all()
    assert not (top == BIASED[1]).any()
    ref_top, _ = ref.route(TINY, biased.h2, biased.w["router"][0],
                           biased.w["e_bias"][0])
    assert torch.equal(top.sort(-1).values, ref_top.sort(-1).values)
    np.testing.assert_allclose(got.numpy(), biased.want.numpy(), rtol=1e-4,
                               atol=1e-5)


def _route_ignoring_bias(cfg, h2, router, e_bias, route=mm.route):
    return route(cfg, h2, router, torch.zeros_like(e_bias))


def _route_weighing_bias(cfg, h2, router, e_bias, route=mm.route):
    top, _ = route(cfg, h2, router, e_bias)
    w = (torch.sigmoid(h2.float() @ router.float()) + e_bias).gather(1, top)
    return top, w / w.sum(-1, keepdim=True) * cfg.routed_scaling_factor


@pytest.mark.parametrize("fault", [_route_ignoring_bias,
                                   _route_weighing_bias])
def test_router_bias_faults_fail_the_comparison(biased, monkeypatch, fault):
    """A routed layer that drops the bias, or weighs the chosen experts by
    score plus bias, is far outside the comparison above."""
    monkeypatch.setattr(mm, "route", fault)
    got, _ = mm.moe(TINY, biased.p, 0, biased.h2)
    assert float((got - biased.want).abs().max()) > 1e-2


def test_routes_recorded_in_the_cache(tiny):
    """The cache holds each position's chosen experts, from the prefill
    and from every step, equal to the reference's choice."""
    _, _, _, cache = _decode(tiny.p, tiny.tokens, 4)
    eps = TINY.rms_norm_eps
    x = tiny.w["embed"][tiny.tokens.long()]
    pos = torch.arange(tiny.tokens.shape[1])
    x = x + ref.attention(TINY, ref.rms_norm(x, tiny.w["attn_norm"][0], eps),
                          tiny.w, 0, pos)
    x = x + ref.swiglu(ref.rms_norm(x, tiny.w["ffn_norm"][0], eps),
                       tiny.w["dense_gate_up"][0], tiny.w["dense_down"][0])
    x = x + ref.attention(TINY, ref.rms_norm(x, tiny.w["attn_norm"][1], eps),
                          tiny.w, 1, pos)
    h2 = ref.rms_norm(x, tiny.w["ffn_norm"][1], eps)
    want, _ = ref.route(TINY, h2.reshape(-1, TINY.hidden_size),
                        tiny.w["router"][0], tiny.w["e_bias"][0])
    t = tiny.tokens.shape[1]
    got = cache.routes[0, :, :t].long().reshape(-1, TINY.num_experts_per_tok)
    assert torch.equal(got.sort(-1).values, want.sort(-1).values)


def test_latent_attend_plain_path_is_absorbed_attention():
    """The kernel's plain version, fed the absorbed query, is multi-head
    attention over the decompressed keys and values: held positions
    ``< length`` (one a row), the current token as one more."""
    g = torch.Generator().manual_seed(7)
    b, T, H, r, rp, nope, dv = 3, 9, 4, 16, 8, 12, 10
    lat = torch.randn(b, T, r + rp, generator=g)
    own = torch.randn(b, r + rp, generator=g)
    q_nope = torch.randn(b, H, nope, generator=g)
    q_pe = torch.randn(b, H, rp, generator=g)
    w_uk = torch.randn(H, r, nope, generator=g)
    w_uv = torch.randn(H, r, dv, generator=g)
    length = torch.tensor([0, 4, 9])
    scale = 0.3
    q = torch.cat([torch.einsum("bhn,hrn->bhr", q_nope, w_uk), q_pe], -1)
    o_lat = latent_attend.attend(q, lat, length, self_lat=own, scale=scale,
                                 v_dim=r)
    got = torch.einsum("bhr,hrv->bhv", o_lat, w_uv)
    full = torch.cat([lat, own[:, None]], 1)
    k = torch.cat([torch.einsum("btr,hrn->bthn", full[..., :r], w_uk),
                   full[:, :, None, r:].expand(b, T + 1, H, rp)], -1)
    v = torch.einsum("btr,hrv->bthv", full[..., :r], w_uv)
    s = torch.einsum("bhd,bthd->bht", torch.cat([q_nope, q_pe], -1),
                     k) * scale
    held = torch.arange(T + 1)[None] < length[:, None]
    held[:, T] = True
    s = s.masked_fill(~held[:, None], float("-inf"))
    want = torch.einsum("bht,bthv->bhv", torch.softmax(s, -1), v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_latent_attend_refuses_shapes_the_kernel_does_not_take():
    q = torch.zeros(2, 16, 576, dtype=torch.bfloat16)
    lat = torch.zeros(2, 8, 576, dtype=torch.bfloat16)
    latent_attend._check(q, lat, None, None)
    with pytest.raises(ValueError, match="shape"):
        latent_attend._check(torch.zeros(2, 33, 576, dtype=torch.bfloat16),
                             lat, None, None)
    with pytest.raises(ValueError, match="dtype"):
        latent_attend._check(q.float(), lat.float(), None, None)


class _Retriever:
    """A device retriever that keeps its queries."""

    def __init__(self):
        self.queries = []

    def retrieve_device(self, q, nprobe, k):
        self.queries.append(q.clone())
        ids = torch.zeros((q.shape[0], k), dtype=torch.int64)
        return types.SimpleNamespace(ids=ids, dists=ids.float())


def test_ralm_loop_prefills_and_rewinds_to_the_prompt(tiny):
    """``RalmDecoder`` over the family: a prompt prefilled once, each
    generation rewound to its end; the retrieval query is the final normed
    hidden state, and two generations from one first token agree."""
    from chamjax_torch.serving.ralm import RalmDecoder
    prompt = tiny.tokens[:, :6]
    rec = _Retriever()
    loop = RalmDecoder(tiny.p, TINY, rec, 3, nprobe=2, k=2)
    loop.prefill(prompt)
    assert loop.cache.host_idx == int(loop.cache.idx) == 6
    ptr = loop.cache.lat.data_ptr()
    runs = []
    for _ in range(2):
        loop.reset_inference_state()
        assert loop.cache.lat.data_ptr() == ptr
        loop.tokens.copy_(tiny.tokens[:, 6])
        served = []
        for _ in range(3):
            loop.single_step()
            served.append(loop.tokens.clone())
        runs.append(torch.stack(served, 1))
        assert loop.cache.host_idx == int(loop.cache.idx) == 9
    assert torch.equal(runs[0], runs[1])
    # the first step's query: the reference's hidden state at position 6
    np.testing.assert_allclose(rec.queries[0].numpy(),
                               tiny.hidden[:, 6].numpy(), rtol=1e-4,
                               atol=1e-5)


def test_dec_loop_unchanged_at_prompt_length_zero():
    """With no prompt the reset empties the cache as before: a decoder
    loop's steps after a reset equal a fresh loop's, cache and count."""
    from chamjax_torch.config import ModelConfig
    from chamjax_torch.models import init_decoder
    from chamjax_torch.serving.ralm import RalmDecoder
    cfg = ModelConfig(model_type="decoder", embed_dim=32, ffn_embed_dim=64,
                      layers=2, attention_heads=4, vocab_size=97,
                      max_seq_len=8, dtype="float32", retrieval_interval=2)
    p = init_decoder(4, cfg, device=CPU)
    first = torch.tensor([5, 9], dtype=torch.int32)

    def run(loop):
        loop.tokens.copy_(first)
        for _ in range(4):
            loop.single_step()
        return loop.tokens.clone(), loop.cache.k.clone()

    fresh = RalmDecoder(p, cfg, _Retriever(), 2)
    want = run(fresh)
    loop = RalmDecoder(p, cfg, _Retriever(), 2)
    run(loop)
    loop.reset_inference_state()
    assert loop.prompt_len == 0 and loop.cache.host_idx == 0
    assert int(loop.cache.idx) == 0 and not loop.cache.k.any()
    got = run(loop)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_dec_loop_prefills_a_prompt_and_rewinds_to_it():
    """The decoder family through the same prompt path: after
    ``prefill`` each reset rewinds to the prompt's end, and a generation
    from one first token equals the steps of ``decoder_prefill`` and
    ``decoder_step`` run by hand."""
    from chamjax_torch.config import ModelConfig
    from chamjax_torch.models import (decoder_prefill, decoder_step,
                                      init_decoder, init_kv_cache)
    from chamjax_torch.serving.ralm import RalmDecoder
    cfg = ModelConfig(model_type="decoder", embed_dim=32, ffn_embed_dim=64,
                      layers=2, attention_heads=4, vocab_size=97,
                      max_seq_len=12, dtype="float32")
    p = init_decoder(6, cfg, device=CPU)
    prompt = torch.tensor([[3, 8, 1, 4], [7, 7, 2, 9]], dtype=torch.int32)
    first = torch.tensor([5, 11], dtype=torch.int32)
    cache = init_kv_cache(cfg, 2, device=CPU)
    _, _, cache = decoder_prefill(p, prompt, cache, cfg.attention_heads)
    tok, want = first, []
    for _ in range(3):
        logits, _, cache = decoder_step(p, tok, cache, cfg.attention_heads)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        want.append(tok)
    loop = RalmDecoder(p, cfg, _Retriever(), 2)
    loop.prefill(prompt)
    ptr = loop.cache.k.data_ptr()
    for _ in range(2):
        loop.reset_inference_state()
        assert loop.cache.host_idx == int(loop.cache.idx) == 4
        assert loop.cache.k.data_ptr() == ptr
        loop.tokens.copy_(first)
        got = []
        for _ in range(3):
            loop.single_step()
            got.append(loop.tokens.clone())
        assert torch.equal(torch.stack(got), torch.stack(want))


def test_family_has_no_mesh_form(tiny):
    from chamjax_torch.parallel.sharded_model import shard_decoder_params
    with pytest.raises(NotImplementedError, match="deepseek_v3"):
        shard_decoder_params(tiny.p, None)
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        mm.MlaMoeConfig(q_lora_rank=1536)


def test_published_config_and_size():
    """The defaults are Moonlight-16B-A3B's: 15.96B parameters (the
    absorbed copies, buffers, left out)."""
    cfg = mm.MlaMoeConfig()
    assert (cfg.latent_dim, cfg.qk_head_dim, cfg.moe_layers) == (576, 192, 26)
    p = mm.MlaMoeParams(cfg, device="meta", dtype=torch.bfloat16)
    assert sum(t.numel() for t in p.parameters()) == 15_960_110_208


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("held", [0, 128, 7168, 7680])
def test_latent_kernel_matches_plain_on_card(cuda_device, held):
    """The kernel against its plain version at Moonlight-16B-A3B's shapes
    (b 64, 16 heads, 576-wide latents in a 7680-position cache, bf16):
    held positions from the cache's count, the current token, per-row
    counts and no current token; captured in a graph, it counts its
    launches.  The kernel rounds p to bf16 for P.V: 2^-8 of a value."""
    g = torch.Generator(device=cuda_device).manual_seed(held + 1)
    b, T, H = 64, 7680, 16
    lat = torch.randn(b, T, 576, generator=g, device=cuda_device,
                      dtype=torch.bfloat16)
    own = torch.randn(b, 576, generator=g, device=cuda_device,
                      dtype=torch.bfloat16)
    q = torch.randn(b, H, 576, generator=g, device=cuda_device,
                    dtype=torch.bfloat16) * 3
    scale = 192 ** -0.5
    idx = torch.tensor(held, dtype=torch.int32, device=cuda_device)
    got = latent_attend.attend(q, lat, idx, self_lat=own, scale=scale)
    want = latent_attend.attend_reference(q, lat, idx, own, scale)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    rows = torch.randint(0, held + 1, (b,), generator=g, device=cuda_device,
                         dtype=torch.int32)
    if held:
        got = latent_attend.attend(q, lat, rows, scale=scale)
        want = latent_attend.attend_reference(q, lat, rows, None, scale)
        ok = rows > 0                       # no position: 0/0
        torch.testing.assert_close(got[ok].float(), want[ok].float(),
                                   atol=2e-2, rtol=2e-2)
    graph = torch.cuda.CUDAGraph()
    out = torch.empty_like(got)
    before = cuda_lib.launch_counts["latent_attend"]
    with torch.cuda.graph(graph):
        out.copy_(latent_attend.attend(q, lat, idx, self_lat=own,
                                       scale=scale))
    graph.replay()
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["latent_attend"] == before + 1
    torch.testing.assert_close(out.float(),
                               latent_attend.attend_reference(
                                   q, lat, idx, own, scale).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_step_at_published_widths_matches_reference_on_card(cuda_device):
    """Two layers (the dense one and a routed one) at Moonlight-16B-A3B's
    published widths and vocabulary, bf16, on the card: prefill then
    steps (one CUDA graph each) against the float32 reference over the
    same weights.  A decoded position whose routing has a near tie (the
    6th and 7th biased scores within 0.005, five times the router's error
    through two bf16 layers) in the reference may route otherwise and is
    left out; the rest agree to bf16's rounding through two layers."""
    cfg = mm.MlaMoeConfig(num_hidden_layers=2, max_seq_len=160)
    p = mm.init_mla_moe(5, cfg, device=cuda_device)
    w = {n: getattr(p, n).detach().float() for n in NAMES}
    g = torch.Generator(device=cuda_device).manual_seed(9)
    b, prompt, t = 8, 140, 144
    tokens = torch.randint(1, cfg.vocab_size, (b, t), generator=g,
                           device=cuda_device, dtype=torch.int32)
    cache = mm.init_latent_cache(cfg, b, device=cuda_device)
    _, _, cache = mm.mla_moe_prefill(p, tokens[:, :prompt], cache)
    logits = []
    for i in range(prompt, t):
        lg, _, cache = mm.mla_moe_step(p, tokens[:, i], cache)
        logits.append(lg.float())
    got = torch.stack(logits, 1)
    assert len(cache.graphs) == 1
    with ref.no_tf32(), torch.no_grad():
        want, _ = ref.forward(cfg, w, tokens)
        x = w["embed"][tokens.long()]
        eps = cfg.rms_norm_eps
        pos = torch.arange(t)
        x = x + ref.attention(cfg, ref.rms_norm(x, w["attn_norm"][0], eps),
                              w, 0, pos)
        x = x + ref.swiglu(ref.rms_norm(x, w["ffn_norm"][0], eps),
                           w["dense_gate_up"][0], w["dense_down"][0])
        x = x + ref.attention(cfg, ref.rms_norm(x, w["attn_norm"][1], eps),
                              w, 1, pos)
        h2 = ref.rms_norm(x, w["ffn_norm"][1], eps)
        z = torch.sigmoid(h2 @ w["router"][0]) + w["e_bias"][0]
        top = z[:, prompt:].topk(7, dim=-1).values
        keep = (top[..., 5] - top[..., 6]) >= 0.005           # (b, t - prompt)
    assert keep.sum() >= keep.numel() // 4
    err = (got - want[:, prompt:]).abs().amax(-1)[keep].max()
    assert float(err) < 0.1, float(err)
