"""Latent attention over a compressed cache and routed experts: the
DeepSeek-V3 block (``model_type`` ``deepseek_v3``) as Moonlight-16B-A3B
publishes it.  The JAX package has no such family.

Per layer, on x (b, d), with RMSNorm's statistics in float32:

- h = RMSNorm(x); q = h·W_q, 16 heads of [q_nope 128 | q_pe 64];
  [c | k_pe] = h·W_kva (d → 576), c = RMSNorm(c);
- RoPE (θ ``rope_theta``) rotates q_pe and k_pe at the position, with
  DeepSeek's interleaved pairing as the Hugging Face ``deepseek_v3`` code
  applies it: the pairs (2i, 2i+1) of the input, rotated by position ·
  θ^(-2i/64), come out as entries i and 32 + i;
- the prefill decompresses, [k_nope | v] = c·W_kvb (512 → 16 × 256), and
  attends causally at scale (128 + 64)^-0.5; a decode step absorbs W_kvb:
  q_lat_h = W_UK,h·q_nope_h, score = (q_lat_h·c_t + q_pe_h·k_pe_t)·scale,
  o_h = W_UV,h·Σ_t p_t c_t, which reads one 576-wide latent a position
  for every head (``ops/latent_attend.py``); x += o·W_o;
- h2 = RMSNorm(x); the first ``first_k_dense_replace`` layers add a SwiGLU
  of width ``intermediate_size``; the others route: s = sigmoid(h2·W_r) in
  float32, the top ``num_experts_per_tok`` of s + e_bias are chosen, their
  weights are s over the chosen s's sum times ``routed_scaling_factor``,
  and x += Σ w_i·E_i(h2) + S(h2), with S the shared experts as one SwiGLU.

The logits are the final RMSNorm's output times the untied head; the
retrieval query is that normed hidden state.  Weights, activations and the
cache are in the parameters' dtype (bfloat16 as served); the norms, the
router, RoPE and the softmax in float32; the products with float32
accumulation.

The cache (:class:`LatentCache`) holds one latent [c | k_pe] a layer and
position, 576 values where the 16 heads' K and V would take 4096.  A
decode step is a host shell around a device core captured as one CUDA
graph on the card (``utils/graphs.py``), as ``transformer.decoder_step``;
the MoE layer routes, sorts by expert and takes its offsets on the device
and runs one grouped product over the experts for the routed rows alone
(no capacity, no dropped rows), so a step reads no device value on the
host.  The prefill runs eagerly, in row chunks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from chamjax_torch import random as jr
from chamjax_torch.ops import latent_attend
from chamjax_torch.utils import graphs, tracing
from chamjax_torch.utils.device import resolve_device

MODEL_TYPE = "deepseek_v3"


@dataclass(frozen=True)
class MlaMoeConfig:
    """The block's settings under the Hugging Face ``config.json`` names,
    with the RALM loop's (``max_seq_len``, ``retrieval_interval``, ``k``)
    beside them; the defaults are Moonlight-16B-A3B's."""

    model_type: str = MODEL_TYPE
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    num_attention_heads: int = 16
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    n_group: int = 1
    topk_group: int = 1
    topk_method: str = "noaux_tc"
    scoring_func: str = "sigmoid"
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    max_position_embeddings: int = 8192
    max_seq_len: int = 8192
    retrieval_interval: int = 1
    k: int = 10
    dtype: str = "bfloat16"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MlaMoeConfig":
        """The config from a dict (a ``config.json``), other keys left
        out."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def __post_init__(self):
        if self.model_type != MODEL_TYPE:
            raise ValueError(f"MlaMoeConfig: model_type {self.model_type!r}")
        unsupported = {"q_lora_rank": self.q_lora_rank is not None,
                       "n_group": self.n_group != 1,
                       "topk_group": self.topk_group != 1,
                       "scoring_func": self.scoring_func != "sigmoid",
                       "topk_method": self.topk_method != "noaux_tc"}
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                f"MlaMoeConfig: {', '.join(bad)} not supported (no query "
                f"compression; one expert group; sigmoid scores with a "
                f"bias for the choice)")
        if self.max_seq_len > self.max_position_embeddings:
            raise ValueError("MlaMoeConfig: max_seq_len past "
                             "max_position_embeddings")

    @property
    def layers(self) -> int:
        return self.num_hidden_layers

    @property
    def dense_layers(self) -> int:
        return self.first_k_dense_replace

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def shared_width(self) -> int:
        return self.n_shared_experts * self.moe_intermediate_size

    @property
    def scale(self) -> float:
        return self.qk_head_dim ** -0.5


def dtype_of(cfg: MlaMoeConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _param(shape, fill: float, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, device=device, dtype=dtype),
                        requires_grad=False)


class MlaMoeParams(nn.Module):
    """The model's weights, each layer's stacked along a leading axis: the
    attention of all layers; the dense FFN of the first
    ``first_k_dense_replace``; the router, its bias, the routed experts
    (gate and up side by side) and the shared experts of the rest.
    ``uk_t`` and ``uv`` are W_kvb's two halves in the layout a decode step
    absorbs them in; :meth:`absorb` writes them from ``wkv_b``."""

    def __init__(self, cfg: MlaMoeConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        L, d, H = cfg.layers, cfg.hidden_size, cfg.num_attention_heads
        r, nope, rope, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                             cfg.qk_rope_head_dim, cfg.v_head_dim)
        Ld, Lm, E = cfg.dense_layers, cfg.moe_layers, cfg.n_routed_experts
        f, fe, fs = (cfg.intermediate_size, cfg.moe_intermediate_size,
                     cfg.shared_width)
        kw = dict(device=device, dtype=dtype)
        self.embed = _param((cfg.vocab_size, d), 0.0, **kw)
        self.attn_norm = _param((L, d), 1.0, **kw)
        self.wq = _param((L, d, H * (nope + rope)), 0.0, **kw)
        self.wkv_a = _param((L, d, r + rope), 0.0, **kw)
        self.kv_norm = _param((L, r), 1.0, **kw)
        self.wkv_b = _param((L, r, H * (nope + dv)), 0.0, **kw)
        self.wo = _param((L, H * dv, d), 0.0, **kw)
        self.ffn_norm = _param((L, d), 1.0, **kw)
        self.dense_gate_up = _param((Ld, d, 2 * f), 0.0, **kw)
        self.dense_down = _param((Ld, f, d), 0.0, **kw)
        self.router = _param((Lm, d, E), 0.0, **kw)
        self.e_bias = _param((Lm, E), 0.0, device=device, dtype=torch.float32)
        self.expert_gate_up = _param((Lm, E, d, 2 * fe), 0.0, **kw)
        self.expert_down = _param((Lm, E, fe, d), 0.0, **kw)
        self.shared_gate_up = _param((Lm, d, 2 * fs), 0.0, **kw)
        self.shared_down = _param((Lm, fs, d), 0.0, **kw)
        self.final_norm = _param((d,), 1.0, **kw)
        self.head = _param((d, cfg.vocab_size), 0.0, **kw)
        self.register_buffer("uk_t", torch.zeros((L, H, nope, r), **kw))
        self.register_buffer("uv", torch.zeros((L, H, r, dv), **kw))
        cos, sin = rope_tables(cfg, device)
        self.register_buffer("rope_cos", cos)
        self.register_buffer("rope_sin", sin)

    @torch.no_grad()
    def absorb(self) -> None:
        """Write the decode step's absorbed up-projections from ``wkv_b``:
        ``uk_t[l, h]`` = W_UK,h transposed (nope × r), ``uv[l, h]`` = W_UV,h
        (r × v)."""
        cfg = self.cfg
        H, nope = cfg.num_attention_heads, cfg.qk_nope_head_dim
        w = self.wkv_b.view(cfg.layers, cfg.kv_lora_rank, H, -1)
        self.uk_t.copy_(w[..., :nope].permute(0, 2, 3, 1))
        self.uv.copy_(w[..., nope:].permute(0, 2, 1, 3))


def rope_tables(cfg: MlaMoeConfig, device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """cos and sin of position · θ^(-2i/rope) for every position < max_seq_len
    and i < rope/2, worked out in float64, kept in float32."""
    half = cfg.qk_rope_head_dim // 2
    inv = cfg.rope_theta ** (-torch.arange(half, dtype=torch.float64)
                             * 2 / cfg.qk_rope_head_dim)
    ang = torch.arange(cfg.max_seq_len, dtype=torch.float64)[:, None] * inv
    return (ang.cos().float().to(device), ang.sin().float().to(device))


def init_mla_moe(key: jr.Key, cfg: MlaMoeConfig, device=None
                 ) -> MlaMoeParams:
    """Seeded weights (``chamjax_torch.random``): projections into a width
    at ``fan_in^-0.5`` (W_q at three times that, so that attention picks
    out a few positions), projections back into the residual also over
    ``(2·layers)^0.5``, the embedding at 1, the router bias at 1e-3; the
    norms at 1.  Then the absorbed up-projections."""
    dev = resolve_device(device)
    p = MlaMoeParams(cfg, device=dev, dtype=dtype_of(cfg))
    d, L = cfg.hidden_size, cfg.layers
    out = (2 * L) ** -0.5
    scales = {"embed": 1.0, "wq": 3 * d ** -0.5, "wkv_a": d ** -0.5,
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
    keys = jr.split(key, len(scales))
    with torch.no_grad():
        for k, (name, scale) in zip(keys, scales.items()):
            t = getattr(p, name)
            t.copy_(jr.normal(k, t.shape, scale=scale, device=dev))
    p.absorb()
    return p


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------


class LatentCache(NamedTuple):
    """A layer's latents [c | k_pe] a row and position (graph state, read
    and written in place) and the count held; the cache owns the graphs of
    the steps run on it.  ``routes`` holds the experts each held position
    chose in each routed layer (the record a check of the routing reads)."""

    lat: torch.Tensor       # (layers, b, max_len, kv_lora_rank + rope)
    idx: torch.Tensor       # () int32 on the cache's device
    routes: torch.Tensor    # (moe_layers, b, max_len, topk) uint8
    host_idx: int = 0
    graphs: Optional[graphs.Graphs] = None


def init_latent_cache(cfg: MlaMoeConfig, batch: int, device=None
                      ) -> LatentCache:
    dev = resolve_device(device)
    T = cfg.max_seq_len
    lat = graphs.state(torch.zeros((cfg.layers, batch, T, cfg.latent_dim),
                                   dtype=dtype_of(cfg), device=dev))
    idx = graphs.state(torch.zeros((), dtype=torch.int32, device=dev))
    rt = graphs.state(torch.zeros((cfg.moe_layers, batch, T,
                                   cfg.num_experts_per_tok),
                                  dtype=torch.uint8, device=dev))
    return LatentCache(lat=lat, idx=idx, routes=rt, graphs=graphs.Graphs())


def reset_latent_cache(cache: LatentCache, prompt_len: int = 0
                       ) -> LatentCache:
    """Empty ``cache`` in place; its storage and graphs stay.  Above 0,
    rewind it to its first ``prompt_len`` positions, as ``reset_cache``
    does."""
    if prompt_len:
        cache.idx.fill_(prompt_len)
        return cache._replace(host_idx=prompt_len)
    for t in (cache.lat, cache.idx, cache.routes):
        t.zero_()
    return cache._replace(host_idx=0)


def _state(cache: LatentCache):
    return cache.lat, cache.idx, cache.routes


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with its statistics in float32, rounded to ``x``'s dtype
    before the scale (the Hugging Face order)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return w * y.to(x.dtype)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """DeepSeek's interleaved rotary embedding of ``x`` (..., 2n) with
    ``cos``/``sin`` (..., n) broadcast against it: entries 2i and 2i + 1
    rotated, written to i and n + i; in float32, rounded once."""
    a, b = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.cat([a * cos - b * sin, b * cos + a * sin],
                     dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor
           ) -> torch.Tensor:
    """silu(x·W_gate) ⊙ (x·W_up) · W_down, gate and up side by side in
    ``gate_up``; the product of the two in float32, rounded once."""
    gu = x @ gate_up
    f = gu.shape[-1] // 2
    a = (F.silu(gu[..., :f].float()) * gu[..., f:].float()).to(x.dtype)
    return a @ down


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """Rows ``x`` (n, K) sorted by group against ``w`` (G, K, N): the rows
    ``[offs[g-1], offs[g])`` times ``w[g]`` → (n, N); rows past the last
    offset belong to no group and are left unwritten.  On the card one
    grouped GEMM (``torch._grouped_mm``, bfloat16 with float32
    accumulation) over offsets on the device; on the CPU a loop over the
    groups."""
    if x.is_cuda:
        return torch._grouped_mm(x, w, offs=offs)
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    start = 0
    for g, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[g]
        start = end
    return out


def route(cfg: MlaMoeConfig, h2: torch.Tensor, router: torch.Tensor,
          e_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The experts each row of ``h2`` (n, d) chooses and their weights,
    both (n, topk): sigmoid scores of h2·W_r in float32, the top of the
    scores plus the bias, the chosen scores over their sum times the
    scaling factor."""
    s = torch.sigmoid(h2.float() @ router.float())
    top = torch.topk(s + e_bias, cfg.num_experts_per_tok, dim=-1).indices
    w = s.gather(1, top)
    if cfg.norm_topk_prob:
        w = w / w.sum(-1, keepdim=True)
    return top, w * cfg.routed_scaling_factor


def moe(cfg: MlaMoeConfig, params: MlaMoeParams, m: int, h2: torch.Tensor,
        held: Optional[Tuple[int, int]] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed layer ``m`` on ``h2`` (n, d) → (its output (n, d), the
    chosen experts (n, topk)).  The rows are sorted by expert on the
    device, every routed row runs through its expert in one grouped
    product each way, and the weighted sum over a row's experts is taken
    in float32.  Spans: ``moe.route``, ``moe.experts``, ``moe.shared``.

    ``held``: the experts ``[lo, hi)`` whose weights ``params`` holds
    (``expert_gate_up[m][e - lo]``), the chip's share under expert
    parallelism; None (or all of them) holds every expert.  The router
    scores and weighs all ``n_routed_experts``; a route to an expert not
    held is sorted past the last group, runs through no product and adds
    nothing, so the output is the held experts' part (and the shared
    experts'), with no host sync and no held route dropped."""
    n, d = h2.shape
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    if held is not None and tuple(held) == (0, E):
        held = None
    with tracing.annotate("moe.route"):
        top, w = route(cfg, h2, params.router[m], params.e_bias[m])
        flat = top.reshape(-1)
        if held is None:
            groups, key = E, flat
        else:       # the experts not held: one group past the last
            lo, hi = held
            mine = (flat >= lo) & (flat < hi)
            groups = hi - lo
            key = torch.where(mine, flat - lo, groups)
        order = torch.argsort(key, stable=True)
        counts = torch.zeros(groups + (held is not None), dtype=torch.int32,
                             device=h2.device)
        counts.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
        offs = torch.cumsum(counts[:groups], 0, dtype=torch.int32)
    with tracing.annotate("moe.experts"):
        xs = h2.index_select(0, order // k)
        gu = grouped_mm(xs, params.expert_gate_up[m], offs)
        fe = gu.shape[-1] // 2
        a = (F.silu(gu[:, :fe].float()) * gu[:, fe:].float()).to(h2.dtype)
        y = grouped_mm(a, params.expert_down[m], offs)
        back = torch.empty_like(y).index_copy_(0, order, y)
        if held is not None:    # rows past the last group were not written
            back = torch.where(mine[:, None], back, 0)
        out = (back.view(n, k, d).float() * w[..., None]).sum(1)
    with tracing.annotate("moe.shared"):
        shared = swiglu(h2, params.shared_gate_up[m], params.shared_down[m])
    return (out + shared.float()).to(h2.dtype), top


def _ffn(cfg: MlaMoeConfig, params: MlaMoeParams, l: int, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN on the normed ``x`` (n, d): (output, chosen experts
    or None for a dense layer)."""
    if l < cfg.dense_layers:
        return swiglu(x, params.dense_gate_up[l], params.dense_down[l]), None
    return moe(cfg, params, l - cfg.dense_layers, x)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over a batch, accumulated in and returned as float32
    (bfloat16 operands on a card; float32 on the CPU)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, chunk: int = 512,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k (r, t, H, dq) and v (r, t, H, dv) → (r, t, H, dv), into ``out``
    where given: position i sees positions ≤ i; scores and softmax in
    float32, the probabilities rounded to ``v``'s dtype for p·V; queries
    taken ``chunk`` at a time against the keys up to the chunk's end."""
    r, t, H, dq = q.shape
    if out is None:
        out = torch.empty((r, t, H, v.shape[-1]), dtype=v.dtype,
                          device=v.device)
    kt = k.permute(0, 2, 3, 1).reshape(r * H, dq, t)
    vh = v.permute(0, 2, 1, 3).reshape(r * H, t, -1)
    for s in range(0, t, chunk):
        e = min(s + chunk, t)
        qh = q[:, s:e].permute(0, 2, 1, 3).reshape(r * H, e - s, dq)
        sc = bmm_f32(qh, kt[..., :e]).mul_(scale)
        pos = torch.arange(s, e, device=q.device)        # the diagonal block
        sc[..., s:e].masked_fill_(pos[None, :] > pos[:, None], float("-inf"))
        p = torch.softmax(sc, dim=-1).to(v.dtype)
        o = p @ vh[:, :e]
        out[:, s:e] = o.view(r, H, e - s, -1).transpose(1, 2)
    return out


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def mla_prefill(params, l: int, h: torch.Tensor, lat: torch.Tensor,
                rot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rows: Optional[int] = None) -> torch.Tensor:
    """MLA layer ``l`` of ``params`` over every position of ``h`` (r, t,
    d), decompressed and causal, ``rows`` rows at a time (all by default);
    its latents written into ``lat`` (r, max_len, 576).  ``rot``: the cos
    and sin (t, rope/2) of the positions, or None where no rotation is
    applied.  Returns the layer's output (r, t, d)."""
    cfg = params.cfg
    r, t, _ = h.shape
    H, nope, rope_d = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                       cfg.qk_rope_head_dim)
    kr = cfg.kv_lora_rank
    q = (h @ params.wq[l]).view(r, t, H, nope + rope_d)
    kv = h @ params.wkv_a[l]
    c = rms_norm(kv[..., :kr], params.kv_norm[l], cfg.rms_norm_eps)
    k_pe = kv[..., kr:] if rot is None else rope(kv[..., kr:], *rot)
    lat[:, :t] = torch.cat([c, k_pe], dim=-1)
    if rot is not None:
        q = torch.cat([q[..., :nope], rope(q[..., nope:], rot[0][:, None],
                                           rot[1][:, None])], dim=-1)
    rows = rows or r
    o = None if rows >= r else torch.empty(
        (r, t, H, cfg.v_head_dim), dtype=h.dtype, device=h.device)
    for j in range(0, r, rows):
        kvb = (c[j:j + rows] @ params.wkv_b[l]).view(-1, t, H,
                                                      nope + cfg.v_head_dim)
        n = kvb.shape[0]
        kh = torch.cat([kvb[..., :nope],
                        k_pe[j:j + rows, :, None].expand(n, t, H, rope_d)],
                       dim=-1)
        oj = causal_attention(q[j:j + rows], kh, kvb[..., nope:], cfg.scale,
                              out=None if o is None else o[j:j + rows])
        o = oj if o is None else o
        del kvb, kh
    del q, kv
    return o.reshape(r, t, -1) @ params.wo[l]


def _prefill_rows(params: MlaMoeParams, tokens: torch.Tensor,
                  cache: LatentCache, r0: int):
    """Rows ``r0 ..`` of the prompt ``tokens`` (r, t): every layer over
    all t positions (decompressed, causal), the latents and routes written
    into the cache; returns the last position's hidden state (r, d)."""
    cfg = params.cfg
    r, t = tokens.shape
    eps = cfg.rms_norm_eps
    rot = (params.rope_cos[:t], params.rope_sin[:t])
    x = params.embed.index_select(0, tokens.reshape(-1).long()).view(r, t, -1)
    for l in range(cfg.layers):
        h = rms_norm(x, params.attn_norm[l], eps)
        x = x + mla_prefill(params, l, h, cache.lat[l, r0:r0 + r], rot)
        y, top = _ffn(cfg, params, l, rms_norm(x, params.ffn_norm[l], eps)
                      .view(r * t, -1))
        if top is not None:
            cache.routes[l - cfg.dense_layers, r0:r0 + r, :t] = (
                top.view(r, t, -1).to(torch.uint8))
        x = x + y.view(r, t, -1)
    return rms_norm(x[:, -1], params.final_norm, eps)


@torch.no_grad()
def mla_moe_prefill(params: MlaMoeParams, tokens: torch.Tensor,
                    cache: LatentCache, rows: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, LatentCache]:
    """Process a prompt ``tokens`` (b, t) into the cache in place, ``rows``
    rows at a time (default: as many as keep a chunk to 32768 positions).
    Returns ``(logits (b, V), hidden (b, d), cache)`` of each row's last
    position, the cache holding t positions."""
    if isinstance(params, nn.Module) and not isinstance(params, MlaMoeParams):
        raise TypeError("mla_moe_prefill: MlaMoeParams only (no tensor or "
                        "mesh parallel form of this family)")
    b, t = tokens.shape
    if t > cache.lat.shape[2]:
        raise IndexError(f"prompt of {t} tokens past max_len "
                         f"{cache.lat.shape[2]}")
    rows = rows or max(1, 32768 // max(t, 1))
    hidden = torch.cat([_prefill_rows(params, tokens[r0:r0 + rows], cache, r0)
                        for r0 in range(0, b, rows)])
    cache.idx.fill_(t)
    return hidden @ params.head, hidden, cache._replace(host_idx=t)


def mla_decode(params, l: int, h: torch.Tensor, x: torch.Tensor,
               lat: torch.Tensor, idx: torch.Tensor, at: torch.Tensor,
               rot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """MLA layer ``l`` of ``params`` on ``h`` (b, d), absorbed, over the
    latents ``lat`` (b, max_len, 576) held below ``idx`` and the token's
    own, added to the residual ``x``; the latent written at ``at``.
    ``rot``: the cos and sin (1, rope/2) of the position, or None where no
    rotation is applied.  Span: ``decode.latent`` around the kernel."""
    cfg = params.cfg
    b = h.shape[0]
    H, nope = cfg.num_attention_heads, cfg.qk_nope_head_dim
    kr = cfg.kv_lora_rank
    q = (h @ params.wq[l]).view(b, H, -1)
    kv = h @ params.wkv_a[l]
    col = torch.cat([rms_norm(kv[:, :kr], params.kv_norm[l],
                              cfg.rms_norm_eps),
                     kv[:, kr:] if rot is None else rope(kv[:, kr:], *rot)],
                    dim=-1)                                       # (b, 576)
    q_lat = torch.bmm(q[..., :nope].transpose(0, 1), params.uk_t[l])
    q_pe = q[..., nope:]
    qq = torch.cat([q_lat.transpose(0, 1),
                    q_pe if rot is None else
                    rope(q_pe, rot[0][:, None], rot[1][:, None])],
                   dim=-1)                                        # (b, H, 576)
    with tracing.annotate("decode.latent"):   # held positions < idx
        o_lat = latent_attend.attend(qq, lat, idx, self_lat=col,
                                     scale=cfg.scale, v_dim=kr)
    o = torch.bmm(o_lat.transpose(0, 1), params.uv[l])        # (H, b, dv)
    x = x + o.transpose(0, 1).reshape(b, -1) @ params.wo[l]
    lat.index_copy_(1, at, col[:, None])
    return x


def _mla_moe_step(params: MlaMoeParams, tokens: torch.Tensor, state):
    """The device core of :func:`mla_moe_step`: reads no device value on
    the host, writes each layer's latent and routes at ``idx`` in place
    and advances ``idx``."""
    lat, idx, routes = state
    cfg = params.cfg
    eps = cfg.rms_norm_eps
    at = idx.long().reshape(1)
    rot = (params.rope_cos.index_select(0, at),             # (1, rope/2)
           params.rope_sin.index_select(0, at))
    x = params.embed.index_select(0, tokens.reshape(-1).long())   # (b, d)
    chosen = []
    for l in range(cfg.layers):
        h = rms_norm(x, params.attn_norm[l], eps)
        x = mla_decode(params, l, h, x, lat[l], idx, at, rot)
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
def mla_moe_step(params: MlaMoeParams, tokens: torch.Tensor,
                 cache: LatentCache
                 ) -> Tuple[torch.Tensor, torch.Tensor, LatentCache]:
    """One decode step of ``tokens`` (b,) at the cache's ``idx``. Returns
    ``(logits (b, V), hidden (b, d), cache)``: the cache written in place
    and returned with the count advanced.  The host checks the room left
    (a replay would not); the rest is the captured core."""
    if not isinstance(params, MlaMoeParams):
        raise TypeError("mla_moe_step: MlaMoeParams only (no tensor or mesh "
                        "parallel form of this family)")
    if cache.host_idx >= cache.lat.shape[2]:
        raise IndexError(f"latent cache full: {cache.host_idx} positions "
                         f"of max_len {cache.lat.shape[2]}")
    logits, hidden = graphs.call(cache.graphs, _mla_moe_step, params, tokens,
                                 _state(cache))
    return logits, hidden, cache._replace(host_idx=cache.host_idx + 1)


__all__ = ["MlaMoeConfig", "MlaMoeParams", "LatentCache", "init_mla_moe",
           "init_latent_cache", "reset_latent_cache", "mla_moe_prefill",
           "mla_moe_step"]
