"""The ``kimi_linear`` family (``chamjax_torch/models/kimi_linear.py``):
KDA beside latent attention, routed experts held in shares, a hybrid cache
rewound by restoring a snapshot; held to the plain float32 reference
``ref_kimi_linear.py`` (no cache, no chunking, no absorption, the
recurrence position by position, an expert loop) on the CPU at a tiny
size, and on the card (tests marked ``gpu``, which skip where there is
none) the KDA kernel and ``latent_attend`` at 32 heads against float64,
and a full-depth step at the published widths against the reference.
Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kimi_linear.py -q
"""

import types

import numpy as np
import pytest
import torch

import ref_kimi_linear as ref
from chamjax_torch.models import kimi_linear as kl
from chamjax_torch.models import mla_moe as mm
from chamjax_torch.ops import kda_decode, latent_attend
from chamjax_torch.utils import cuda_lib

CPU = torch.device("cpu")
TINY = kl.KimiLinearConfig(
    vocab_size=101, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=4, first_k_dense_replace=1,
    num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    full_attn_layers=(2,), kda_layers=(1, 3, 4), kda_num_heads=4,
    kda_head_dim=16, num_experts=8, num_experts_per_token=2,
    max_seq_len=40, dtype="float32")
NAMES = ("embed", "attn_norm", "ffn_norm", "kda_in", "kda_conv", "kda_fb",
         "kda_gb", "kda_a_log", "kda_dt_bias", "kda_o_norm", "kda_wo", "wq",
         "wkv_a", "kv_norm", "wkv_b", "wo", "dense_gate_up", "dense_down",
         "router", "e_bias", "expert_gate_up", "expert_down",
         "shared_gate_up", "shared_down", "final_norm", "head")
TOL = dict(rtol=1e-4, atol=1e-5)       # float32 in another order


def weights(p):
    return {n: getattr(p, n).detach().float() for n in NAMES}


@pytest.fixture(scope="module")
def tiny():
    """The tiny model (seeded), its float32 copies for the reference, and
    a prompt with two continuations, each through the reference."""
    p = kl.init_kimi_linear(11, TINY, device=CPU)
    w = weights(p)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, TINY.vocab_size, (3, 14), generator=g,
                           dtype=torch.int32)
    other = tokens.clone()
    other[:, 6:] = torch.randint(1, TINY.vocab_size, (3, 8), generator=g,
                                 dtype=torch.int32)
    with torch.no_grad():
        want = ref.forward(TINY, w, tokens)
        want_other = ref.forward(TINY, w, other)
    return types.SimpleNamespace(p=p, w=w, tokens=tokens, other=other,
                                 want=want, want_other=want_other)


def _steps(p, tokens, cache):
    logits, hidden = [], []
    for i in range(tokens.shape[1]):
        lg, h, cache = kl.kimi_step(p, tokens[:, i], cache)
        logits.append(lg)
        hidden.append(h)
    return torch.stack(logits, 1), torch.stack(hidden, 1), cache


# ---------------------------------------------------------------------------
# The recurrence
# ---------------------------------------------------------------------------


def _recurrence_inputs(g, b, t, H, K, V, strong=False):
    q = torch.nn.functional.normalize(torch.randn(b, t, H, K, generator=g),
                                      dim=-1) * K ** -0.5
    k = torch.nn.functional.normalize(torch.randn(b, t, H, K, generator=g),
                                      dim=-1)
    v = torch.randn(b, t, H, V, generator=g)
    lo = -20.0 if strong else -1.0
    a = torch.rand(b, t, H, K, generator=g) * lo      # log-decay in (lo, 0]
    beta = torch.rand(b, t, H, generator=g)
    return q, k, v, a, beta


def _token_by_token(q, k, v, a, beta, S):
    """The recurrence as written: S ← Diag(α)S, S ← S + βk(v − Sᵀk)ᵀ, o =
    Sᵀq, one position at a time, in float64."""
    q, k, v, a, beta, S = (x.double() for x in (q, k, v, a, beta, S))
    o = []
    for s in range(q.shape[1]):
        S = torch.exp(a[:, s])[..., None] * S
        kk = k[:, s]
        u = beta[:, s, :, None] * (v[:, s] - (S * kk[..., None]).sum(-2))
        S = S + kk[..., None] * u[..., None, :]
        o.append((S * q[:, s, ..., None]).sum(-2))
    return torch.stack(o, 1), S


def test_kda_step_plain_path_is_the_recurrence():
    """The kernel's plain version, a step at a time on a state it updates
    in place, is the recurrence (float64 beside it)."""
    g = torch.Generator().manual_seed(1)
    b, H, K = 3, 2, 8
    q, k, v, a, beta = _recurrence_inputs(g, b, 5, H, K, K)
    S0 = torch.randn(b, H, K, K, generator=g)
    state = S0.clone()
    got = torch.stack([kda_decode.step(state, q[:, s], k[:, s], v[:, s],
                                       a[:, s].exp(), beta[:, s],
                                       out_dtype=torch.float32)
                       for s in range(5)], 1)
    want, S = _token_by_token(q, k, v, a, beta, S0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(state.numpy(), S.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("t,chunk,sub,group,strong", [
    (1, 8, 4, 16, False), (37, 8, 4, 16, False), (64, 16, 4, 32, False),
    (50, 8, 2, 64, True), (23, 64, 16, 2048, False)])
def test_chunked_recurrence_is_token_by_token(t, chunk, sub, group, strong):
    """The prefill's chunked form (several chunks a group and several
    groups, a length that is no multiple of the chunk, a state to start
    from) gives the outputs and final state of the recurrence run
    position by position; with decays down to e^-20 a position it forms
    nothing past 1 (no exp(−G)) and stays finite."""
    g = torch.Generator().manual_seed(t)
    b, H, K, V = 2, 3, 8, 6
    q, k, v, a, beta = _recurrence_inputs(g, b, t, H, K, V, strong)
    S0 = torch.randn(b, H, K, V, generator=g)
    got, S = kl.kda_chunked(q, k, v, a, beta, state=S0, chunk=chunk,
                            sub=sub, group=group)
    want, S_want = _token_by_token(q, k, v, a, beta, S0)
    assert torch.isfinite(got).all() and torch.isfinite(S).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(S.numpy(), S_want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_kda_kernel_guards_refuse_what_it_does_not_take():
    z = torch.zeros(2, 3, 128)
    state = torch.zeros(2, 3, 128, 128)
    kda_decode._check(state, z, z, z, z, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="state"):
        kda_decode._check(torch.zeros(2, 3, 64, 64), z[..., :64], z[..., :64],
                          z[..., :64], z[..., :64], torch.zeros(2, 3))
    with pytest.raises(ValueError, match="float32"):
        kda_decode._check(state, z.bfloat16(), z, z, z, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        kda_decode._check(state, torch.zeros(2, 128, 3).transpose(1, 2), z,
                          z, z, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="beta"):
        kda_decode._check(state, z, z, z, z, torch.zeros(2, 4))


# ---------------------------------------------------------------------------
# The model through its cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prompt,small_chunks", [(1, False), (6, False),
                                                 (9, True)])
def test_prefill_then_steps_match_full_forward(tiny, monkeypatch, prompt,
                                               small_chunks):
    """Prefill (chunked recurrence, decompressed attention, row chunks)
    then decode through the cache (the step's recurrence, absorbed
    attention) gives the reference's full forward: the prefill's last
    logits, every step's logits and hidden state, the KDA states."""
    if small_chunks:
        monkeypatch.setattr(kl, "CHUNK", 4)
        monkeypatch.setattr(kl, "SUB", 2)
        monkeypatch.setattr(kl, "GROUP", 8)
    monkeypatch.setattr(kl, "FFN_CHUNK", 5)
    b, t = tiny.tokens.shape
    cache = kl.init_kimi_cache(TINY, b, device=CPU)
    first, _, cache = kl.kimi_prefill(tiny.p, tiny.tokens[:, :prompt], cache,
                                      rows=2)
    logits, hidden, cache = _steps(tiny.p, tiny.tokens[:, prompt:], cache)
    want, want_hidden, states = tiny.want
    np.testing.assert_allclose(first.numpy(), want[:, prompt - 1].numpy(),
                               **TOL)
    np.testing.assert_allclose(logits.numpy(), want[:, prompt:].numpy(),
                               **TOL)
    np.testing.assert_allclose(hidden.numpy(),
                               want_hidden[:, prompt:].numpy(), **TOL)
    for got, S in zip(cache.kda, states):
        np.testing.assert_allclose(got.numpy(), S.numpy(), **TOL)
    assert cache.host_idx == int(cache.idx) == t


def test_a_second_answer_after_a_rewind_is_a_fresh_prefills(tiny):
    """Prefill a prompt, answer, rewind to the prompt, answer again with
    other tokens: the second answer's logits are those of a fresh prefill
    followed by it, and the reference's over prompt and second answer;
    the storage stays."""
    b = tiny.tokens.shape[0]
    prompt = tiny.tokens[:, :6]
    cache = kl.init_kimi_cache(TINY, b, device=CPU)
    _, _, cache = kl.kimi_prefill(tiny.p, prompt, cache)
    _, _, cache = _steps(tiny.p, tiny.tokens[:, 6:], cache)
    ptrs = [t.data_ptr() for t in kl._state(cache)]
    cache = kl.reset_kimi_cache(cache, 6)
    assert cache.host_idx == int(cache.idx) == 6
    got, _, cache = _steps(tiny.p, tiny.other[:, 6:], cache)
    assert [t.data_ptr() for t in kl._state(cache)] == ptrs
    fresh = kl.init_kimi_cache(TINY, b, device=CPU)
    _, _, fresh = kl.kimi_prefill(tiny.p, prompt, fresh)
    again, _, _ = _steps(tiny.p, tiny.other[:, 6:], fresh)
    torch.testing.assert_close(got, again, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(),
                               tiny.want_other[0][:, 6:].numpy(), **TOL)


def test_a_rewind_that_skips_the_restore_is_caught(tiny):
    """The fault the snapshot guards against: a rewind that sets the count
    but keeps the KDA states and tails of the answer before gives logits
    far from the reference's (the latents alone are right)."""
    b = tiny.tokens.shape[0]
    cache = kl.init_kimi_cache(TINY, b, device=CPU)
    _, _, cache = kl.kimi_prefill(tiny.p, tiny.tokens[:, :6], cache)
    _, _, cache = _steps(tiny.p, tiny.tokens[:, 6:], cache)
    cache.idx.fill_(6)
    got, _, _ = _steps(tiny.p, tiny.other[:, 6:], cache._replace(host_idx=6))
    gap = (got - tiny.want_other[0][:, 6:]).abs().max()
    assert float(gap) > 1e-2


def test_rewind_takes_only_the_snapshots_length_and_zero_empties(tiny):
    cache = kl.init_kimi_cache(TINY, 3, device=CPU)
    _, _, cache = kl.kimi_prefill(tiny.p, tiny.tokens[:, :6], cache)
    assert cache.snap_len == 6 and cache.snap_kda.any()
    with pytest.raises(ValueError, match="snapshot holds 6"):
        kl.reset_kimi_cache(cache, 5)
    cache = kl.reset_kimi_cache(cache)
    assert cache.host_idx == int(cache.idx) == 0 and cache.snap_len == 0
    for t in (cache.lat, cache.kda, cache.conv, cache.routes,
              cache.snap_kda, cache.snap_conv):
        assert not t.any()


def test_routes_recorded_in_the_cache(tiny, monkeypatch):
    """The cache holds each position's chosen experts (of all of them),
    from the prefill (routed a few positions at a time) and from every
    step, equal to the reference's."""
    monkeypatch.setattr(kl, "FFN_CHUNK", 4)
    b, t = tiny.tokens.shape
    cache = kl.init_kimi_cache(TINY, b, device=CPU)
    _, _, cache = kl.kimi_prefill(tiny.p, tiny.tokens[:, :5], cache)
    _, _, cache = _steps(tiny.p, tiny.tokens[:, 5:], cache)
    w, eps = tiny.w, TINY.rms_norm_eps
    x = w["embed"][tiny.tokens.long()]
    for l, (kind, i) in enumerate(TINY.slots):
        h = ref.rms_norm(x, w["attn_norm"][l], eps)
        x = x + (ref.kda(TINY, h, w, i)[0] if kind == "kda"
                 else ref.mla(TINY, h, w, i))
        h2 = ref.rms_norm(x, w["ffn_norm"][l], eps)
        if l < TINY.first_k_dense_replace:
            x = x + ref.swiglu(h2, w["dense_gate_up"][l], w["dense_down"][l])
            continue
        m = l - TINY.first_k_dense_replace
        top, _ = ref.route(TINY, h2.reshape(-1, TINY.hidden_size),
                           w["router"][m], w["e_bias"][m])
        got = cache.routes[m, :, :t].long().reshape(top.shape)
        assert torch.equal(got.sort(-1).values, top.sort(-1).values)
        x = x + ref.moe(TINY, h2.reshape(-1, TINY.hidden_size), w,
                        m).view(x.shape)


# ---------------------------------------------------------------------------
# The held share of the routed experts
# ---------------------------------------------------------------------------


def test_four_held_shares_sum_to_the_uncut_layer(tiny):
    """Expert parallelism over 4 chips: each share's layer (``mm.moe``
    given the experts it holds, their weights alone) routes over all 8,
    adds its own experts' part and the shared expert; the four outputs,
    the shared expert counted once, sum to the uncut reference layer, and
    each share equals the reference's loop over its experts."""
    g = torch.Generator().manual_seed(5)
    h2 = torch.randn(41, TINY.hidden_size, generator=g)
    w, p = tiny.w, tiny.p
    E = TINY.num_experts
    shared = ref.swiglu(h2, w["shared_gate_up"][0], w["shared_down"][0])
    total = -3 * shared
    for lo in range(0, E, E // 4):
        hi = lo + E // 4
        cfg = kl.KimiLinearConfig(**{**TINY.__dict__,
                                     "experts_held": (lo, hi)})
        part = types.SimpleNamespace(
            router=p.router, e_bias=p.e_bias, shared_gate_up=p.shared_gate_up,
            shared_down=p.shared_down,
            expert_gate_up=p.expert_gate_up[:, lo:hi],
            expert_down=p.expert_down[:, lo:hi])
        got, top = mm.moe(cfg, part, 0, h2, held=cfg.experts_held)
        sliced = {**w, "expert_gate_up": w["expert_gate_up"][:, lo:hi],
                  "expert_down": w["expert_down"][:, lo:hi]}
        np.testing.assert_allclose(
            got.numpy(), ref.moe(cfg, h2, sliced, 0).numpy(), **TOL)
        total = total + got
    np.testing.assert_allclose(total.numpy(),
                               ref.moe(TINY, h2, w, 0).numpy(), **TOL)
    full, _ = mm.moe(TINY, p, 0, h2)
    np.testing.assert_allclose(full.numpy(), ref.moe(TINY, h2, w, 0).numpy(),
                               **TOL)


def test_a_share_holding_nothing_chosen_adds_only_the_shared_expert(tiny):
    """Rows whose every choice lies outside the share get the shared
    expert alone: no route to an expert not held is computed."""
    g = torch.Generator().manual_seed(6)
    h2 = torch.randn(17, TINY.hidden_size, generator=g)
    p = tiny.p
    with torch.no_grad():
        bias = p.e_bias.clone()
        p.e_bias[0].copy_(torch.tensor([5., 5., 0, 0, 0, 0, 0, 0]))
        try:
            cfg = kl.KimiLinearConfig(**{**TINY.__dict__,
                                         "experts_held": (4, 8)})
            part = types.SimpleNamespace(
                router=p.router, e_bias=p.e_bias,
                shared_gate_up=p.shared_gate_up, shared_down=p.shared_down,
                expert_gate_up=p.expert_gate_up[:, 4:],
                expert_down=p.expert_down[:, 4:])
            got, top = mm.moe(cfg, part, 0, h2, held=(4, 8))
        finally:
            p.e_bias.copy_(bias)
    assert (top < 2).all()
    want = mm.swiglu(h2, p.shared_gate_up[0], p.shared_down[0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ---------------------------------------------------------------------------
# The config, the loop and the other families
# ---------------------------------------------------------------------------

PUBLISHED = {
    "model_type": "kimi_linear", "vocab_size": 163840, "hidden_size": 2304,
    "intermediate_size": 9216, "moe_intermediate_size": 1024,
    "num_hidden_layers": 27, "first_k_dense_replace": 1,
    "moe_layer_freq": 1, "hidden_act": "silu", "head_dim": 72,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "q_lora_rank": None, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "mla_use_nope": True,
    "linear_attn_config": {
        "full_attn_layers": [4, 8, 12, 16, 20, 24, 27],
        "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19,
                       21, 22, 23, 25, 26],
        "num_heads": 32, "head_dim": 128, "short_conv_kernel_size": 4},
    "num_experts": 256, "num_experts_per_token": 8, "num_shared_experts": 1,
    "moe_router_activation_func": "sigmoid", "moe_renormalize": True,
    "routed_scaling_factor": 2.446, "num_expert_group": 1, "topk_group": 1,
    "use_grouped_topk": True, "rms_norm_eps": 1e-5, "rope_theta": 10000,
    "rope_scaling": None, "tie_word_embeddings": False}


def test_published_config_is_parsed_from_one_based_lists():
    """The published ``config.json``: the layer lists counted from 1 become
    MLA at layers 3, 7, ..., 23 and 26 from 0, KDA elsewhere; 49.1B
    parameters at 256 experts, 13.8B with a quarter of them held (the
    absorbed copies, buffers, left out)."""
    cfg = kl.KimiLinearConfig.from_dict(PUBLISHED)
    assert cfg == kl.KimiLinearConfig()
    mla = [l for l, (kind, _) in enumerate(cfg.slots) if kind == "mla"]
    assert mla == [3, 7, 11, 15, 19, 23, 26]
    assert [i for kind, i in cfg.slots if kind == "kda"] == list(range(20))
    assert (cfg.kda_dim, cfg.kda_in_width, cfg.latent_dim) == (4096, 12576,
                                                               576)
    p = kl.KimiLinearParams(cfg, device="meta", dtype=torch.bfloat16)
    assert sum(t.numel() for t in p.parameters()) == 49_122_681_728
    held = kl.KimiLinearConfig.from_dict({**PUBLISHED,
                                          "experts_held": [0, 64]})
    assert held.held == (0, 64) and held.n_routed_experts == 256
    p = kl.KimiLinearParams(held, device="meta", dtype=torch.bfloat16)
    assert sum(t.numel() for t in p.parameters()) == 13_789_864_832


@pytest.mark.parametrize("change,error", [
    ({"q_lora_rank": 1536}, "q_lora_rank"),
    ({"mla_use_nope": False}, "mla_use_nope"),
    ({"num_expert_group": 8}, "num_expert_group"),
    ({"moe_router_activation_func": "softmax"}, "moe_router_activation"),
    ({"linear_attn_config": {**PUBLISHED["linear_attn_config"],
                             "kda_layers": [1, 2, 3, 4]}}, "split layers"),
    ({"linear_attn_config": {**PUBLISHED["linear_attn_config"],
                             "chunk": 64}}, "chunk"),
    ({"experts_held": [0, 300]}, "experts_held"),
    ({"model_type": "deepseek_v3"}, "model_type")])
def test_config_raises_on_what_it_does_not_implement(change, error):
    with pytest.raises((ValueError, NotImplementedError), match=error):
        kl.KimiLinearConfig.from_dict({**PUBLISHED, **change})


class _Retriever:
    """A device retriever that keeps its queries."""

    def __init__(self):
        self.queries = []

    def retrieve_device(self, q, nprobe, k):
        self.queries.append(q.clone())
        ids = torch.zeros((q.shape[0], k), dtype=torch.int64)
        return types.SimpleNamespace(ids=ids, dists=ids.float())


def test_ralm_loop_prefills_and_rewinds_to_the_prompt(tiny):
    """``RalmDecoder`` through ``family(cfg)``: the prompt prefilled once,
    each generation rewound to it (the snapshot restored); two
    generations from one first token agree, and the retrieval query is
    the reference's final normed hidden state."""
    from chamjax_torch.serving.ralm import RalmDecoder, family
    assert family(TINY).step is kl.kimi_step
    rec = _Retriever()
    loop = RalmDecoder(tiny.p, TINY, rec, 3, nprobe=2, k=2)
    loop.prefill(tiny.tokens[:, :6])
    runs = []
    for _ in range(2):
        loop.reset_inference_state()
        assert loop.cache.host_idx == int(loop.cache.idx) == 6
        loop.tokens.copy_(tiny.tokens[:, 6])
        served = []
        for _ in range(4):
            loop.single_step()
            served.append(loop.tokens.clone())
        runs.append(torch.stack(served, 1))
    assert torch.equal(runs[0], runs[1])
    np.testing.assert_allclose(rec.queries[0].numpy(),
                               tiny.want[1][:, 6].numpy(), **TOL)


def test_family_has_no_mesh_form(tiny):
    from chamjax_torch.parallel.sharded_model import shard_decoder_params
    from chamjax_torch.serving.ralm import RalmDecoder
    with pytest.raises(NotImplementedError, match="kimi_linear"):
        shard_decoder_params(tiny.p, None)
    with pytest.raises(NotImplementedError, match="kimi_linear"):
        RalmDecoder(object.__new__(mm.MlaMoeParams), TINY, _Retriever(), 3)


def test_other_families_rewind_as_before():
    """The ``deepseek_v3`` and ``decoder`` rewinds still set the count and
    keep every stored position (no snapshot), and 0 empties."""
    from chamjax_torch.config import ModelConfig
    from chamjax_torch.models.transformer import (init_kv_cache,
                                                  reset_cache)
    lat = mm.init_latent_cache(mm.MlaMoeConfig(
        vocab_size=11, hidden_size=8, num_hidden_layers=2, max_seq_len=8,
        max_position_embeddings=8, dtype="float32"), 2, device=CPU)
    dec = init_kv_cache(ModelConfig(model_type="decoder", embed_dim=8,
                                    layers=1, attention_heads=2,
                                    max_seq_len=8, dtype="float32"), 2,
                        device=CPU)
    for cache, reset, store in ((lat, mm.reset_latent_cache, "lat"),
                                (dec, reset_cache, "k")):
        getattr(cache, store).fill_(1.0)
        cache.idx.fill_(7)
        cache = reset(cache, 3)
        assert cache.host_idx == int(cache.idx) == 3
        assert bool((getattr(cache, store) == 1.0).all())
        cache = reset(cache)
        assert cache.host_idx == int(cache.idx) == 0
        assert not getattr(cache, store).any()


def test_latent_attend_takes_up_to_32_heads():
    lat = torch.zeros(2, 8, 576, dtype=torch.bfloat16)
    for h in (16, 17, 32):
        latent_attend._check(torch.zeros(2, h, 576, dtype=torch.bfloat16),
                             lat, None, None)
    with pytest.raises(ValueError, match="up to 32 heads"):
        latent_attend._check(torch.zeros(2, 33, 576, dtype=torch.bfloat16),
                             lat, None, None)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_kda_kernel_matches_float64_on_card(cuda_device):
    """The kernel at the published widths (b 64, 32 heads of 128 x 128)
    over 16 steps against the recurrence in float64, on the state (float32:
    1e-5 of its largest entry) and on o (bfloat16: 2^-8 of its largest);
    captured in a graph it counts one launch a call."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    b, H, K, t = 64, 32, 128, 16
    q, k, v, a, beta = (x.to(cuda_device) for x in _recurrence_inputs(
        torch.Generator().manual_seed(2), b, t, H, K, K))
    a = a * 0.05                       # long memory: α ≥ 0.95
    S0 = torch.randn(b, H, K, K, generator=g, device=cuda_device)
    state = S0.clone()
    outs = [kda_decode.step(state, q[:, s].contiguous(),
                            k[:, s].contiguous(), v[:, s].contiguous(),
                            a[:, s].exp().contiguous(),
                            beta[:, s].contiguous()) for s in range(t)]
    want, S = _token_by_token(q, k, v, a, beta, S0)
    got = torch.stack(outs, 1).double()
    assert float((state.double() - S).abs().max()) <= 1e-5 * float(
        S.abs().max())
    assert float((got - want).abs().max()) <= 2 ** -8 * float(
        want.abs().max())
    graph = torch.cuda.CUDAGraph()
    before = cuda_lib.launch_counts["kda_decode"]
    args = [x[:, 0].contiguous() for x in (q, k, v)] + [
        a[:, 0].exp().contiguous(), beta[:, 0].contiguous()]
    with torch.cuda.graph(graph):
        kda_decode.step(state, *args)
    graph.replay()
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["kda_decode"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("held", [0, 128, 16896])
def test_latent_kernel_at_32_heads_matches_float64_on_card(cuda_device,
                                                           held):
    """``latent_attend`` at Kimi-Linear's 32 heads (b 64, a 16,896-position
    cache, bf16): against float64 attention over the held positions and
    the current token, off by at most 2^-7 of the largest value (p rounded
    to bf16 for P.V)."""
    g = torch.Generator(device=cuda_device).manual_seed(held + 3)
    b, T, H = 64, 16896, 32
    lat = torch.randn(b, T, 576, generator=g, device=cuda_device,
                      dtype=torch.bfloat16)
    own = torch.randn(b, 576, generator=g, device=cuda_device,
                      dtype=torch.bfloat16)
    q = torch.randn(b, H, 576, generator=g, device=cuda_device,
                    dtype=torch.bfloat16) * 3
    scale = 192 ** -0.5
    idx = torch.tensor(held, dtype=torch.int32, device=cuda_device)
    got = latent_attend.attend(q, lat, idx, self_lat=own, scale=scale)
    kk = torch.cat([lat[:, :held], own[:, None]], 1).double()
    p = torch.softmax(torch.einsum("bhd,btd->bht", q.double(), kk) * scale,
                      -1)
    want = torch.einsum("bht,btc->bhc", p, kk[..., :512])
    err = float((got.double() - want).abs().max() / kk[..., :512].abs().max())
    assert err <= 2 ** -7, err


@pytest.mark.gpu
def test_full_depth_step_at_published_widths_matches_reference_on_card(
        cuda_device):
    """All 27 layers at the published widths and vocabulary, bf16, a held
    share of 16 of the 256 experts: prefill then steps (one CUDA graph)
    against the float32 reference over the same weights.  The router is
    made decisive (a bias of 1 on eight experts, half held, half not; the
    scores still weigh them), so that no routing near-tie can turn a
    position; the rest agrees to bf16's rounding through 27 layers."""
    cfg = kl.KimiLinearConfig(experts_held=(0, 16), max_seq_len=80)
    p = kl.init_kimi_linear(5, cfg, device=cuda_device)
    with torch.no_grad():
        p.e_bias.zero_()
        p.e_bias[:, [0, 3, 7, 12, 40, 90, 150, 255]] = 1.0
    w = weights(p)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    b, prompt, t = 4, 70, 76
    tokens = torch.randint(1, cfg.vocab_size, (b, t), generator=g,
                           device=cuda_device, dtype=torch.int32)
    cache = kl.init_kimi_cache(cfg, b, device=cuda_device)
    first, _, cache = kl.kimi_prefill(p, tokens[:, :prompt], cache)
    before = cuda_lib.launch_counts["kda_decode"]
    logits, _, cache = _steps(p, tokens[:, prompt:], cache)
    assert len(cache.graphs) == 1
    assert cuda_lib.launch_counts["kda_decode"] - before == 20 * (t - prompt)
    with ref.no_tf32(), torch.no_grad():
        want, _, _ = ref.forward(cfg, w, tokens)
    err = (logits.float() - want[:, prompt:]).abs().max()
    err_first = (first.float() - want[:, prompt - 1]).abs().max()
    scale = float(want.abs().max())
    assert float(err) < 0.05 * scale, (float(err), scale)
    assert float(err_first) < 0.05 * scale, (float(err_first), scale)
