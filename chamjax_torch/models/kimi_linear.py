"""Kimi Delta Attention beside latent attention, with routed experts: the
Kimi-Linear block (``model_type`` ``kimi_linear``) as
Kimi-Linear-48B-A3B publishes it.  The JAX package has no such family.

The layers are of two kinds, as ``linear_attn_config`` lists them (counted
from 1; here from 0): KDA layers (a gated delta-rule linear attention with
a recurrent state) and MLA layers (the latent attention of the DeepSeek-V3
block, ``mla_moe.py``).  Per layer, on x (b, d), with RMSNorm's statistics
in float32 and h = RMSNorm(x):

- KDA (H heads of K = V = ``head_dim``): q̃, k̃, ṽ = h·W_q, h·W_k, h·W_v;
  q, k, v = SiLU of a causal depthwise convolution of width
  ``short_conv_kernel_size`` over positions (a decode step keeps each
  channel's last W − 1 inputs); per head q ← q/‖q‖₂·K^-0.5, k ← k/‖k‖₂;
  the per-channel log-decay a = −exp(A_log_h)·softplus(h·W_fa·W_fb +
  dt_bias) (d → K → H·K), α = exp(a); β_h = sigmoid(h·W_b) (d → H); then,
  with S_h (K × V) in float32,

      S_h ← Diag(α_h)·S_h;  S_h ← S_h + β_h·k_h·(v_h − S_hᵀk_h)ᵀ;
      o_h = S_hᵀq_h

  (``ops/kda_decode.py``: one kernel launch a layer in a decode step; the
  prefill runs the same recurrence chunked, :func:`kda_chunked`); o_h ←
  RMSNorm_K(o_h)·w ⊙ sigmoid(h·W_ga·W_gb)_h; x += concat(o)·W_o.
- MLA: the DeepSeek-V3 step with ``mla_use_nope``: no rotation of q_pe or
  k_pe; [c | k_pe] = h·W_kva, c = RMSNorm(c); scores at scale (nope +
  rope)^-0.5; the prefill decompresses W_kvb, a decode step absorbs it
  (``ops/latent_attend.py``); x += o·W_o.
- FFN on h2 = RMSNorm(x): the first ``first_k_dense_replace`` layers a
  SwiGLU of width ``intermediate_size``; the others route (``mla_moe.moe``):
  sigmoid scores over all ``num_experts`` in float32, the top
  ``num_experts_per_token`` of scores plus the bias, the chosen scores
  over their sum times ``routed_scaling_factor``, x += Σ_{chosen ∩ held}
  w_i·E_i(h2) + S(h2), with S the shared experts as one SwiGLU.  Under
  expert parallelism a chip holds the experts ``experts_held`` and adds
  their part; the router keeps its published width.

The logits are the final RMSNorm's output times the untied head; the
retrieval query is that normed hidden state.  Weights, activations, the
latents and the convolutions' tails are in the parameters' dtype (bfloat16
as served); the KDA state and its recurrence, the norms, the gates, the
router and the softmax in float32; products with float32 accumulation.

The cache (:class:`KimiCache`) holds the MLA layers' latents, the KDA
layers' states and convolution tails, and, taken by the prefill, a
snapshot of the states and tails at the prompt's end: a recurrence cannot
be cut back to a shorter prefix, so :func:`reset_kimi_cache` rewinds to
the prompt by restoring the snapshot (a copy between answers, outside the
step's graph, under the span ``cache.restore``).  A decode step is one
CUDA graph on the card; the prefill runs eagerly, in row chunks.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from chamjax_torch import random as jr
from chamjax_torch.models import mla_moe
from chamjax_torch.models.mla_moe import rms_norm, swiglu
from chamjax_torch.ops import kda_decode
from chamjax_torch.utils import graphs, tracing
from chamjax_torch.utils.device import resolve_device

MODEL_TYPE = "kimi_linear"
L2_EPS = 1e-6           # q and k over sqrt(Σx² + eps), as the KDA layer
# the prefill's chunked recurrence (kda_chunked): positions a chunk, rows a
# diagonal block, positions worked out together
CHUNK, SUB, GROUP = 64, 8, 4096
FFN_CHUNK = 16384       # positions the prefill routes at once
# the layers by kind, counted from 1 as the published linear_attn_config
FULL_ATTN = (4, 8, 12, 16, 20, 24, 27)
KDA = tuple(sorted(set(range(1, 28)) - set(FULL_ATTN)))


@dataclass(frozen=True)
class KimiLinearConfig:
    """The block's settings under the Hugging Face ``config.json`` names
    (``linear_attn_config``'s keys flattened: ``full_attn_layers`` and
    ``kda_layers`` counted from 1 as published, ``kda_num_heads``,
    ``kda_head_dim``, ``short_conv_kernel_size``), the chip's share of the
    routed experts (``experts_held``, [lo, hi); None: all), and the RALM
    loop's settings; the defaults are Kimi-Linear-48B-A3B's."""

    model_type: str = MODEL_TYPE
    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    hidden_act: str = "silu"
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    mla_use_nope: bool = True
    full_attn_layers: Tuple[int, ...] = FULL_ATTN
    kda_layers: Tuple[int, ...] = KDA
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    short_conv_kernel_size: int = 4
    num_experts: int = 256
    num_experts_per_token: int = 8
    num_shared_experts: int = 1
    moe_router_activation_func: str = "sigmoid"
    moe_renormalize: bool = True
    routed_scaling_factor: float = 2.446
    num_expert_group: int = 1
    topk_group: int = 1
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    experts_held: Optional[Tuple[int, int]] = None
    max_seq_len: int = 16896
    retrieval_interval: int = 1
    k: int = 10
    dtype: str = "bfloat16"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KimiLinearConfig":
        """The config from a dict (a ``config.json``): its
        ``linear_attn_config`` read into the flat fields, lists made
        tuples, other keys left out."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        lin = d.get("linear_attn_config")
        if lin is not None:
            known = {"full_attn_layers", "kda_layers", "num_heads",
                     "head_dim", "short_conv_kernel_size"}
            if set(lin) - known:
                raise NotImplementedError(
                    f"KimiLinearConfig: linear_attn_config keys "
                    f"{sorted(set(lin) - known)} not supported")
            kw.update(full_attn_layers=lin["full_attn_layers"],
                      kda_layers=lin["kda_layers"],
                      kda_num_heads=lin["num_heads"],
                      kda_head_dim=lin["head_dim"],
                      short_conv_kernel_size=lin["short_conv_kernel_size"])
        for key in ("full_attn_layers", "kda_layers", "experts_held"):
            if kw.get(key) is not None:
                kw[key] = tuple(kw[key])
        return cls(**kw)

    def __post_init__(self):
        if self.model_type != MODEL_TYPE:
            raise ValueError(f"KimiLinearConfig: model_type "
                             f"{self.model_type!r}")
        L = self.num_hidden_layers
        full, kda = set(self.full_attn_layers), set(self.kda_layers)
        if (full & kda or full | kda != set(range(1, L + 1))
                or len(full) + len(kda) != len(self.full_attn_layers)
                + len(self.kda_layers)):
            raise ValueError("KimiLinearConfig: full_attn_layers and "
                             "kda_layers must split layers 1 .. "
                             f"{L} between them")
        lo, hi = self.experts_held or (0, self.num_experts)
        unsupported = {
            "q_lora_rank": self.q_lora_rank is not None,
            "mla_use_nope": not self.mla_use_nope,
            "moe_router_activation_func":
                self.moe_router_activation_func != "sigmoid",
            "num_expert_group": self.num_expert_group != 1,
            "topk_group": self.topk_group != 1,
            "moe_layer_freq": self.moe_layer_freq != 1,
            "hidden_act": self.hidden_act != "silu",
            "tie_word_embeddings": self.tie_word_embeddings,
            "num_key_value_heads":
                self.num_key_value_heads != self.num_attention_heads}
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                f"KimiLinearConfig: {', '.join(bad)} not supported (no query "
                f"compression, no rotary embedding, sigmoid scores in one "
                f"expert group, every layer past the dense ones routed, "
                f"SiLU, an untied head)")
        if not 0 <= lo < hi <= self.num_experts:
            raise ValueError(f"KimiLinearConfig: experts_held {(lo, hi)} "
                             f"outside the {self.num_experts} experts")
        if self.short_conv_kernel_size < 1 or self.max_seq_len < 1:
            raise ValueError("KimiLinearConfig: short_conv_kernel_size and "
                             "max_seq_len must be positive")

    # -- layers ---------------------------------------------------------
    @property
    def layers(self) -> int:
        return self.num_hidden_layers

    @property
    def slots(self) -> Tuple[Tuple[str, int], ...]:
        """Each layer's kind ("kda" or "mla") and its index among the
        layers of that kind, from layer 0."""
        kinds, count = [], {"kda": 0, "mla": 0}
        for l in range(1, self.num_hidden_layers + 1):
            kind = "mla" if l in self.full_attn_layers else "kda"
            kinds.append((kind, count[kind]))
            count[kind] += 1
        return tuple(kinds)

    @property
    def mla_layers(self) -> int:
        return len(self.full_attn_layers)

    @property
    def kda_layer_count(self) -> int:
        return len(self.kda_layers)

    @property
    def dense_layers(self) -> int:
        return self.first_k_dense_replace

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    # -- KDA widths -----------------------------------------------------
    @property
    def kda_dim(self) -> int:
        return self.kda_num_heads * self.kda_head_dim

    @property
    def conv_channels(self) -> int:
        """q, k and v side by side: the channels convolved."""
        return 3 * self.kda_dim

    @property
    def kda_in_width(self) -> int:
        """h's one product in a KDA layer: [q | k | v | f_a | g_a | b]; the
        gates' low-rank widths are the head dim."""
        return self.conv_channels + 2 * self.kda_head_dim + self.kda_num_heads

    # -- MLA and the experts, under the names mla_moe reads ---------------
    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def scale(self) -> float:
        return self.qk_head_dim ** -0.5

    @property
    def n_routed_experts(self) -> int:
        return self.num_experts

    @property
    def num_experts_per_tok(self) -> int:
        return self.num_experts_per_token

    @property
    def norm_topk_prob(self) -> bool:
        return self.moe_renormalize

    @property
    def held(self) -> Tuple[int, int]:
        return self.experts_held or (0, self.num_experts)

    @property
    def n_held(self) -> int:
        lo, hi = self.held
        return hi - lo

    @property
    def shared_width(self) -> int:
        return self.num_shared_experts * self.moe_intermediate_size


def dtype_of(cfg: KimiLinearConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _param(shape, fill: float, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, device=device, dtype=dtype),
                        requires_grad=False)


class KimiLinearParams(nn.Module):
    """The model's weights, each kind's layers stacked along a leading
    axis: the norms of every layer; the KDA layers' one input product
    ``kda_in`` ([W_q | W_k | W_v | W_fa | W_ga | W_b]), convolution taps
    ``kda_conv`` (W, 3·H·K), ``kda_fb``, ``kda_gb``, ``kda_a_log`` and
    ``kda_dt_bias`` (float32), ``kda_o_norm`` and ``kda_wo``; the MLA
    layers' weights under ``mla_moe``'s names; the dense FFN of the first
    ``first_k_dense_replace`` layers; the router (all ``num_experts``), its
    bias, the held routed experts and the shared experts of the rest.
    ``uk_t`` and ``uv`` are W_kvb's halves as a decode step absorbs them;
    :meth:`absorb` writes them."""

    def __init__(self, cfg: KimiLinearConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        L, d, H = cfg.layers, cfg.hidden_size, cfg.num_attention_heads
        Lk, Lm = cfg.kda_layer_count, cfg.mla_layers
        Hk, K, HK = cfg.kda_num_heads, cfg.kda_head_dim, cfg.kda_dim
        r, nope, rope, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                             cfg.qk_rope_head_dim, cfg.v_head_dim)
        Ld, Lr, E, En = (cfg.dense_layers, cfg.moe_layers, cfg.num_experts,
                         cfg.n_held)
        f, fe, fs = (cfg.intermediate_size, cfg.moe_intermediate_size,
                     cfg.shared_width)
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.embed = _param((cfg.vocab_size, d), 0.0, **kw)
        self.attn_norm = _param((L, d), 1.0, **kw)
        self.ffn_norm = _param((L, d), 1.0, **kw)
        self.kda_in = _param((Lk, d, cfg.kda_in_width), 0.0, **kw)
        self.kda_conv = _param((Lk, cfg.short_conv_kernel_size,
                                cfg.conv_channels), 0.0, **kw)
        self.kda_fb = _param((Lk, K, HK), 0.0, **kw)
        self.kda_gb = _param((Lk, K, HK), 0.0, **kw)
        self.kda_a_log = _param((Lk, Hk), 0.0, **f32)
        self.kda_dt_bias = _param((Lk, HK), 0.0, **f32)
        self.kda_o_norm = _param((Lk, K), 1.0, **kw)
        self.kda_wo = _param((Lk, HK, d), 0.0, **kw)
        self.wq = _param((Lm, d, H * (nope + rope)), 0.0, **kw)
        self.wkv_a = _param((Lm, d, r + rope), 0.0, **kw)
        self.kv_norm = _param((Lm, r), 1.0, **kw)
        self.wkv_b = _param((Lm, r, H * (nope + dv)), 0.0, **kw)
        self.wo = _param((Lm, H * dv, d), 0.0, **kw)
        self.dense_gate_up = _param((Ld, d, 2 * f), 0.0, **kw)
        self.dense_down = _param((Ld, f, d), 0.0, **kw)
        self.router = _param((Lr, d, E), 0.0, **kw)
        self.e_bias = _param((Lr, E), 0.0, **f32)
        self.expert_gate_up = _param((Lr, En, d, 2 * fe), 0.0, **kw)
        self.expert_down = _param((Lr, En, fe, d), 0.0, **kw)
        self.shared_gate_up = _param((Lr, d, 2 * fs), 0.0, **kw)
        self.shared_down = _param((Lr, fs, d), 0.0, **kw)
        self.final_norm = _param((d,), 1.0, **kw)
        self.head = _param((d, cfg.vocab_size), 0.0, **kw)
        self.register_buffer("uk_t", torch.zeros((Lm, H, nope, r), **kw))
        self.register_buffer("uv", torch.zeros((Lm, H, r, dv), **kw))

    @torch.no_grad()
    def absorb(self) -> None:
        """Write the decode step's absorbed up-projections from ``wkv_b``:
        ``uk_t[i, h]`` = W_UK,h transposed (nope × r), ``uv[i, h]`` = W_UV,h
        (r × v)."""
        cfg = self.cfg
        H, nope = cfg.num_attention_heads, cfg.qk_nope_head_dim
        w = self.wkv_b.view(cfg.mla_layers, cfg.kv_lora_rank, H, -1)
        self.uk_t.copy_(w[..., :nope].permute(0, 2, 3, 1))
        self.uv.copy_(w[..., nope:].permute(0, 2, 1, 3))


def init_kimi_linear(key: jr.Key, cfg: KimiLinearConfig, device=None
                     ) -> KimiLinearParams:
    """Seeded weights (``chamjax_torch.random``), at the scales of
    ``init_mla_moe`` for what the two blocks share; the KDA layers'
    projections at ``fan_in^-0.5``, W_fb at a tenth of that (the decay is
    set by dt_bias), the taps at W^-0.5, A_log = log U(1, 16) and dt_bias
    with softplus(dt_bias) log-uniform in [1e-3, 1e-1].  Then the absorbed
    up-projections."""
    dev = resolve_device(device)
    p = KimiLinearParams(cfg, device=dev, dtype=dtype_of(cfg))
    d, L, K = cfg.hidden_size, cfg.layers, cfg.kda_head_dim
    out = (2 * L) ** -0.5
    scales = {"embed": 1.0, "kda_in": d ** -0.5,
              "kda_conv": cfg.short_conv_kernel_size ** -0.5,
              "kda_fb": 0.1 * K ** -0.5, "kda_gb": K ** -0.5,
              "kda_wo": out * cfg.kda_dim ** -0.5,
              "wq": 3 * d ** -0.5, "wkv_a": d ** -0.5,
              "wkv_b": cfg.kv_lora_rank ** -0.5,
              "wo": out * (cfg.num_attention_heads * cfg.v_head_dim) ** -0.5,
              "dense_gate_up": d ** -0.5,
              "dense_down": out * cfg.intermediate_size ** -0.5,
              "router": d ** -0.5, "e_bias": 1e-3,
              "expert_gate_up": d ** -0.5,
              "expert_down": out * cfg.moe_intermediate_size ** -0.5,
              "shared_gate_up": d ** -0.5,
              "shared_down": out * cfg.shared_width ** -0.5,
              "head": d ** -0.5}
    keys = jr.split(key, len(scales) + 2)
    with torch.no_grad():
        for k, (name, scale) in zip(keys, scales.items()):
            t = getattr(p, name)
            t.copy_(jr.normal(k, t.shape, scale=scale, device=dev))
        a = jr.uniform(keys[-2], p.kda_a_log.shape, lo=1.0, hi=16.0,
                       device=dev)
        p.kda_a_log.copy_(a.log())
        u = jr.uniform(keys[-1], p.kda_dt_bias.shape, lo=math.log(1e-3),
                       hi=math.log(1e-1), device=dev)
        p.kda_dt_bias.copy_(softplus_inverse(u.exp()))
    p.absorb()
    return p


def softplus_inverse(y: torch.Tensor) -> torch.Tensor:
    """x with softplus(x) = y > 0: log(expm1(y)), in float32."""
    return torch.log(torch.expm1(y.float()))


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------


class KimiCache(NamedTuple):
    """The MLA layers' latents [c | k_pe], the KDA layers' states and
    convolution tails (graph state, read and written in place), the count
    held and the routes chosen (as ``mla_moe.LatentCache``); and the states
    and tails at the prompt's end, ``snap_len`` positions, that a rewind
    restores.  The cache owns the graphs of the steps run on it."""

    lat: torch.Tensor        # (mla layers, b, max_len, kv_lora_rank + rope)
    kda: torch.Tensor        # (kda layers, b, heads, K, V) float32
    conv: torch.Tensor       # (kda layers, b, W - 1, 3·heads·K)
    idx: torch.Tensor        # () int32 on the cache's device
    routes: torch.Tensor     # (routed layers, b, max_len, topk) uint8
    snap_kda: torch.Tensor   # kda and conv at snap_len positions
    snap_conv: torch.Tensor
    snap_len: int = 0
    host_idx: int = 0
    graphs: Optional[graphs.Graphs] = None


def init_kimi_cache(cfg: KimiLinearConfig, batch: int, device=None
                    ) -> KimiCache:
    dev = resolve_device(device)
    if cfg.num_experts > 256:
        raise ValueError("KimiCache: routes are kept as uint8 (at most 256 "
                         "experts)")
    T, dt = cfg.max_seq_len, dtype_of(cfg)
    K = cfg.kda_head_dim
    state_shape = (cfg.kda_layer_count, batch, cfg.kda_num_heads, K, K)
    tail_shape = (cfg.kda_layer_count, batch, cfg.short_conv_kernel_size - 1,
                  cfg.conv_channels)
    lat, kda, conv, idx, routes = graphs.state(
        torch.zeros((cfg.mla_layers, batch, T, cfg.latent_dim), dtype=dt,
                    device=dev),
        torch.zeros(state_shape, dtype=torch.float32, device=dev),
        torch.zeros(tail_shape, dtype=dt, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((cfg.moe_layers, batch, T, cfg.num_experts_per_token),
                    dtype=torch.uint8, device=dev))
    return KimiCache(lat=lat, kda=kda, conv=conv, idx=idx, routes=routes,
                     snap_kda=torch.zeros_like(kda),
                     snap_conv=torch.zeros_like(conv), graphs=graphs.Graphs())


def reset_kimi_cache(cache: KimiCache, prompt_len: int = 0) -> KimiCache:
    """Empty ``cache`` in place (the snapshot too); its storage and graphs
    stay.  Above 0, rewind it to the prompt its prefill took: restore the
    states and tails of the snapshot and set the count (span
    ``cache.restore``).  Raises unless ``prompt_len`` is the snapshot's."""
    if prompt_len:
        if prompt_len != cache.snap_len:
            raise ValueError(f"reset_kimi_cache: a rewind to {prompt_len} "
                             f"positions, but the snapshot holds "
                             f"{cache.snap_len}")
        with tracing.annotate("cache.restore"):
            cache.kda.copy_(cache.snap_kda)
            cache.conv.copy_(cache.snap_conv)
            cache.idx.fill_(prompt_len)
        return cache._replace(host_idx=prompt_len)
    for t in (cache.lat, cache.kda, cache.conv, cache.idx, cache.routes,
              cache.snap_kda, cache.snap_conv):
        t.zero_()
    return cache._replace(host_idx=0, snap_len=0)


def _state(cache: KimiCache):
    return cache.lat, cache.kda, cache.conv, cache.idx, cache.routes


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """x over sqrt(Σx² + 1e-6) along the last axis, in float32."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def gated_norm(o: torch.Tensor, w: torch.Tensor, gate: torch.Tensor,
               eps: float) -> torch.Tensor:
    """RMSNorm of ``o`` over its last axis times ``w`` and ``gate`` (the
    sigmoid already taken), in float32, rounded once to ``o``'s dtype."""
    of = o.float()
    y = of * torch.rsqrt(of.pow(2).mean(-1, keepdim=True) + eps)
    return (y * w.float() * gate).to(o.dtype)


def _pairwise(q: torch.Tensor, k: torch.Tensor, G: torch.Tensor, sub: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within each chunk of ``q``, ``k`` (n, C, K) with the cumulative
    log-decay ``G`` (n, C, K): Σ_c x_i[c]·k_j[c]·exp(G_i[c] − G_j[c]) for
    every j ≤ i, x = q (``mq``) and, for j < i, x = k (``mk``), (n, C, C)
    each, 0 elsewhere.  The decay of a pair is exp(G_i − G_j) ≤ 1: in
    blocks of ``sub`` rows, each pair of the diagonal block formed alone
    (the exponent clamped at 0 above the diagonal, whose sums are then
    dropped), and against the earlier columns through the block's first
    position m, exp(G_i − G_m)·exp(G_m − G_j), both ≤ 1; exp(−G) is never
    formed."""
    n, C, _ = k.shape
    mq = q.new_zeros((n, C, C))
    mk = q.new_zeros((n, C, C))
    for i0 in range(0, C, sub):
        i1 = min(i0 + sub, C)
        gi = G[:, i0:i1]
        if i0:
            ref = G[:, i0:i0 + 1]
            left = torch.exp(gi - ref)
            right = (k[:, :i0] * torch.exp(ref - G[:, :i0])).transpose(1, 2)
            mq[:, i0:i1, :i0] = (q[:, i0:i1] * left) @ right
            mk[:, i0:i1, :i0] = (k[:, i0:i1] * left) @ right
        kd = (gi[:, :, None] - gi[:, None, :]).clamp_max_(0.0).exp_()
        kd.mul_(k[:, None, i0:i1])                        # (n, s, s, K)
        both = torch.matmul(kd, torch.stack([q[:, i0:i1], k[:, i0:i1]], -1))
        mq[:, i0:i1, i0:i1] = both[..., 0]
        mk[:, i0:i1, i0:i1] = both[..., 1]
        del kd, both
    return mq.tril_(), mk.tril_(-1)


def kda_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                a: torch.Tensor, beta: torch.Tensor,
                state: Optional[torch.Tensor] = None, chunk: int = 64,
                sub: int = 16, group: int = 2048
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KDA recurrence over every position of ``q``, ``k`` (r, t, H,
    K), ``v`` (r, t, H, V), log-decay ``a`` (r, t, H, K) and ``beta`` (r,
    t, H), all float32, from ``state`` (r, H, K, V; zeros if None): the
    outputs o (r, t, H, V) and the final state, as the step's recurrence
    gives them position by position.

    In chunks of ``chunk`` positions with G the log-decay summed within the
    chunk and S₀ the state at its start, the recurrence's new values u_i =
    v_i − (Diag(α_i)S_{i−1})ᵀk_i solve (I + A)u = v − (e^G ⊙ k)S₀ with A_ij
    = β_j Σ_c k_i k_j e^{G_i − G_j} (j < i), o_i = S₀ᵀ(e^{G_i} ⊙ q_i) +
    Σ_{j≤i} β_j u_j Σ_c q_i k_j e^{G_i − G_j}, and the chunk's last state
    is Diag(e^{G_C})S₀ + Σ_j (e^{G_C − G_j} ⊙ β_j k_j)u_jᵀ: every decay
    between two positions is exp(G_i − G_j) with i ≥ j (``_pairwise``).
    What does not depend on S₀ is worked out for ``group`` positions'
    chunks at once; the chunks then pass the state on in order."""
    r, t, H, K = k.shape
    V = v.shape[-1]
    C = chunk
    n = -(-t // C)
    pad = n * C - t

    def heads_first(x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)                       # (r, H, t, ...)
        if pad:
            x = F.pad(x, (0, 0, 0, pad) if x.dim() == 4 else (0, pad))
        return x.reshape(r * H, n, C, *x.shape[3:])

    qh, kh, vh, ah, bh = map(heads_first, (q, k, v, a, beta))
    S = (q.new_zeros((r * H, K, V)) if state is None
         else state.reshape(r * H, K, V).clone())
    out = q.new_empty((r * H, n, C, V))
    eye = torch.eye(C, device=q.device, dtype=q.dtype)
    per = max(1, group // C)
    for g0 in range(0, n, per):
        g1 = min(g0 + per, n)
        m = g1 - g0

        def flat(x):
            return x[:, g0:g1].reshape(r * H * m, C, *x.shape[3:])

        qg, kg, vg, ag, bg = map(flat, (qh, kh, vh, ah, bh))
        G = ag.cumsum(1)
        mq, mk = _pairwise(qg, kg, G, sub)
        A = mk * bg[:, None, :]
        eg = G.exp()
        # (I + A)^-1 [e^G ⊙ k | v]: forward substitution, unit diagonal
        W1, U0 = torch.linalg.solve_triangular(
            eye + A, torch.cat([kg * eg, vg], -1), upper=False,
            unitriangular=True).split([K, V], -1)         # (N, C, K), (N, C, V)
        mqb = mq * bg[:, None, :]                          # j ≤ i
        Qe = qg * eg - mqb @ W1
        O0 = mqb @ U0
        last = G[:, -1]
        Kd = (kg * torch.exp(last[:, None] - G) * bg[..., None]
              ).transpose(1, 2)                           # (N, K, C)

        def per_chunk(x):            # (rH·m, ...) → (m, rH, ...), a view
            return x.reshape(r * H, m, *x.shape[1:]).transpose(0, 1)

        W1, U0, Kd = per_chunk(W1), per_chunk(U0), per_chunk(Kd)
        decay = per_chunk(last.exp())[..., None]          # (m, rH, K, 1)
        starts = q.new_empty((m + 1, r * H, K, V))        # S at each start
        starts[0] = S
        for c in range(m):
            u = torch.baddbmm(U0[c], W1[c], starts[c], alpha=-1.0)
            torch.baddbmm(decay[c] * starts[c], Kd[c], u, out=starts[c + 1])
        S = starts[m]
        out[:, g0:g1] = (per_chunk(O0) + per_chunk(Qe)
                         @ starts[:m]).transpose(0, 1)
    o = out.reshape(r, H, n * C, V)[:, :, :t].transpose(1, 2)
    return o, S.reshape(r, H, K, V)


def _ffn(cfg: KimiLinearConfig, params: KimiLinearParams, l: int,
         x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN on the normed ``x`` (n, d): (output, chosen experts
    or None for a dense layer); a routed layer adds the held experts'
    part."""
    if l < cfg.dense_layers:
        return swiglu(x, params.dense_gate_up[l], params.dense_down[l]), None
    return mla_moe.moe(cfg, params, l - cfg.dense_layers, x,
                       held=cfg.experts_held)


def _kda_gates(params: KimiLinearParams, i: int, proj: torch.Tensor):
    """The decay α (…, H, K) and β (…, H) of KDA layer ``i`` from its input
    product ``proj`` (…, kda_in_width), in float32."""
    cfg = params.cfg
    Hk, K, HK = cfg.kda_num_heads, cfg.kda_head_dim, cfg.kda_dim
    c = cfg.conv_channels
    lead = proj.shape[:-1]
    g = (proj[..., c:c + K] @ params.kda_fb[i]).float()
    g = (g + params.kda_dt_bias[i]).view(*lead, Hk, K)
    a = -torch.exp(params.kda_a_log[i])[:, None] * F.softplus(g)
    beta = torch.sigmoid(proj[..., c + 2 * K:].float())
    return a, beta


def _kda_out(params: KimiLinearParams, i: int, proj: torch.Tensor,
             o: torch.Tensor) -> torch.Tensor:
    """The gated norm of the recurrence's output ``o`` (…, H, V) and W_o."""
    cfg = params.cfg
    Hk, K, HK = cfg.kda_num_heads, cfg.kda_head_dim, cfg.kda_dim
    c = cfg.conv_channels
    lead = proj.shape[:-1]
    gate = torch.sigmoid((proj[..., c + K:c + 2 * K] @ params.kda_gb[i])
                         .float()).view(*lead, Hk, K)
    o = gated_norm(o, params.kda_o_norm[i], gate, cfg.rms_norm_eps)
    return o.reshape(*lead, HK) @ params.kda_wo[i]


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _kda_prefill(params: KimiLinearParams, i: int, h: torch.Tensor,
                 cache: KimiCache, r0: int) -> torch.Tensor:
    """KDA layer ``i`` over every position of ``h`` (r, t, d) from an empty
    state; its final state and tails written into the cache's rows
    ``r0 ..``."""
    cfg = params.cfg
    r, t, _ = h.shape
    Hk, K, W = cfg.kda_num_heads, cfg.kda_head_dim, cfg.short_conv_kernel_size
    c = cfg.conv_channels
    proj = h @ params.kda_in[i]
    xp = F.pad(proj[..., :c], (0, 0, W - 1, 0))       # (r, t + W - 1, c)
    taps = params.kda_conv[i].float()
    conv = xp[:, :t] * taps[0]                        # float32
    for j in range(1, W):
        conv.addcmul_(xp[:, j:j + t], taps[j])
    cache.conv[i, r0:r0 + r] = xp[:, t:]
    q, k, v = F.silu(conv, inplace=True).view(r, t, 3, Hk, K).unbind(2)
    del conv, xp
    a, beta = _kda_gates(params, i, proj)
    o, S = kda_chunked(l2_norm(q) * K ** -0.5, l2_norm(k), v.contiguous(), a,
                       beta, chunk=CHUNK, sub=SUB, group=GROUP)
    cache.kda[i, r0:r0 + r] = S
    return _kda_out(params, i, proj, o.to(h.dtype))


def _mla_prefill(params: KimiLinearParams, i: int, h: torch.Tensor,
                 cache: KimiCache, r0: int) -> torch.Tensor:
    """MLA layer ``i`` over every position of ``h`` (r, t, d), unrotated,
    a row at a time (32 heads' scores over 16k positions); its latents
    written into the cache."""
    return mla_moe.mla_prefill(params, i, h, cache.lat[i, r0:r0 + h.shape[0]],
                               rows=1)


def _prefill_rows(params: KimiLinearParams, tokens: torch.Tensor,
                  cache: KimiCache, r0: int):
    """Rows ``r0 ..`` of the prompt ``tokens`` (r, t): every layer over all
    t positions, the latents, states, tails and routes written into the
    cache; returns the last position's hidden state (r, d)."""
    cfg = params.cfg
    r, t = tokens.shape
    eps = cfg.rms_norm_eps
    x = params.embed.index_select(0, tokens.reshape(-1).long()).view(r, t, -1)
    for l, (kind, i) in enumerate(cfg.slots):
        h = rms_norm(x, params.attn_norm[l], eps)
        layer = _kda_prefill if kind == "kda" else _mla_prefill
        x = x + layer(params, i, h, cache, r0)
        del h
        h2 = rms_norm(x, params.ffn_norm[l], eps).view(r * t, -1)
        y = torch.empty_like(h2)
        tops = []
        for s in range(0, r * t, FFN_CHUNK):
            out, top = _ffn(cfg, params, l, h2[s:s + FFN_CHUNK])
            y[s:s + FFN_CHUNK] = out
            tops.append(top)
        if l >= cfg.dense_layers:
            cache.routes[l - cfg.dense_layers, r0:r0 + r, :t] = torch.cat(
                tops).view(r, t, -1).to(torch.uint8)
        x = x + y.view(r, t, -1)
        del h2, y, tops
    return rms_norm(x[:, -1], params.final_norm, eps)


@torch.no_grad()
def kimi_prefill(params: KimiLinearParams, tokens: torch.Tensor,
                 cache: KimiCache, rows: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, KimiCache]:
    """Process a prompt ``tokens`` (b, t) into an empty cache in place,
    ``rows`` rows at a time (default: as many as keep a chunk to 32768
    positions) and the FFN ``FFN_CHUNK`` positions at a time; then take
    the snapshot a rewind restores.  Returns ``(logits (b, V), hidden (b,
    d), cache)`` of each row's last position, the cache holding t
    positions."""
    if not isinstance(params, KimiLinearParams):
        raise TypeError("kimi_prefill: KimiLinearParams only (no tensor or "
                        "mesh parallel form of this family)")
    b, t = tokens.shape
    if t > cache.lat.shape[2]:
        raise IndexError(f"prompt of {t} tokens past max_len "
                         f"{cache.lat.shape[2]}")
    rows = rows or max(1, 32768 // max(t, 1))
    hidden = torch.cat([_prefill_rows(params, tokens[r0:r0 + rows], cache,
                                      r0) for r0 in range(0, b, rows)])
    cache.idx.fill_(t)
    cache.snap_kda.copy_(cache.kda)
    cache.snap_conv.copy_(cache.conv)
    return (hidden @ params.head, hidden,
            cache._replace(host_idx=t, snap_len=t))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _kda_step(params: KimiLinearParams, i: int, h: torch.Tensor,
              state: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """KDA layer ``i`` on ``h`` (b, d): the convolution over its tail
    (updated in place), the gates, one kernel launch on ``state`` (b, H, K,
    V, in place), the gated norm and W_o.  Spans: ``kda.mix`` around all
    but the launch, ``decode.kda`` around it."""
    cfg = params.cfg
    b = h.shape[0]
    Hk, K = cfg.kda_num_heads, cfg.kda_head_dim
    c = cfg.conv_channels
    with tracing.annotate("kda.mix"):
        proj = h @ params.kda_in[i]
        win = torch.cat([tail, proj[:, None, :c]], dim=1)    # (b, W, c)
        tail.copy_(win[:, 1:])
        conv = (win.float() * params.kda_conv[i].float()).sum(1)
        q, k, v = F.silu(conv).view(b, 3, Hk, K).unbind(1)
        q = l2_norm(q) * K ** -0.5
        k = l2_norm(k)
        a, beta = _kda_gates(params, i, proj)
        alpha = torch.exp(a)
    with tracing.annotate("decode.kda"):
        o = kda_decode.step(state, q.contiguous(), k.contiguous(),
                            v.contiguous(), alpha, beta, out_dtype=h.dtype)
    with tracing.annotate("kda.mix"):
        return _kda_out(params, i, proj, o)


def _kimi_step(params: KimiLinearParams, tokens: torch.Tensor, state):
    """The device core of :func:`kimi_step`: reads no device value on the
    host, writes each MLA layer's latent, each KDA layer's state and tail
    and the routes in place, and advances ``idx``."""
    lat, kda, conv, idx, routes = state
    cfg = params.cfg
    eps = cfg.rms_norm_eps
    at = idx.long().reshape(1)
    x = params.embed.index_select(0, tokens.reshape(-1).long())   # (b, d)
    chosen = []
    for l, (kind, i) in enumerate(cfg.slots):
        h = rms_norm(x, params.attn_norm[l], eps)
        if kind == "kda":
            x = x + _kda_step(params, i, h, kda[i], conv[i])
        else:
            x = mla_moe.mla_decode(params, i, h, x, lat[i], idx, at)
        y, top = _ffn(cfg, params, l, rms_norm(x, params.ffn_norm[l], eps))
        if top is not None:
            chosen.append(top)
        x = x + y
    routes.index_copy_(2, at, torch.stack(chosen)[:, :, None]
                       .to(torch.uint8))
    idx.add_(1)
    hidden = rms_norm(x, params.final_norm, eps)
    return hidden @ params.head, hidden


@torch.no_grad()
def kimi_step(params: KimiLinearParams, tokens: torch.Tensor,
              cache: KimiCache
              ) -> Tuple[torch.Tensor, torch.Tensor, KimiCache]:
    """One decode step of ``tokens`` (b,) at the cache's ``idx``. Returns
    ``(logits (b, V), hidden (b, d), cache)``: the cache written in place
    and returned with the count advanced.  The host checks the room left
    (a replay would not); the rest is the captured core."""
    if not isinstance(params, KimiLinearParams):
        raise TypeError("kimi_step: KimiLinearParams only (no tensor or "
                        "mesh parallel form of this family)")
    if cache.host_idx >= cache.lat.shape[2]:
        raise IndexError(f"kimi cache full: {cache.host_idx} positions of "
                         f"max_len {cache.lat.shape[2]}")
    logits, hidden = graphs.call(cache.graphs, _kimi_step, params, tokens,
                                 _state(cache))
    return logits, hidden, cache._replace(host_idx=cache.host_idx + 1)


__all__ = ["KimiLinearConfig", "KimiLinearParams", "KimiCache",
           "init_kimi_linear", "init_kimi_cache", "reset_kimi_cache",
           "kimi_prefill", "kimi_step", "kda_chunked"]
