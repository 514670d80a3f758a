"""RALM generation loops: retrieval-augmented decoding (the port of
``chamjax/serving/ralm.py``).

- ``RalmDecoder``        — decoder-only generation (the decoder and the
  llama families) with retrieval every ``retrieval_interval`` steps; the
  retrieval query is the last hidden state or a replayed ``query_set``.
- ``RalmEncoderDecoder`` — enc-dec RALM: a retrieval step encodes the query,
  retrieves k neighbours, encodes k·retrieval_token_len retrieved tokens and
  refreshes the decoder's cross-attention K/V; the other steps reuse it.

With a retriever that has ``retrieve_device`` and no query replay, the
whole step chain (decode → hidden state → search, and for enc-dec →
token synthesis → encode → cross K/V) stays on the device: no step reads a
device value on the host.  There the model and retriever timers time the
host's enqueue, and on the card a step's time is the card's, from CUDA
events at the step ends (``StepProfiler``).  ``batch_inference`` ends with
the one device sync of a batch.

On the card each stage is a replay of a captured CUDA graph
(``utils/graphs.py``): the decode step (owned by the KV cache), the search
(owned by the index) and, for enc-dec, the query encoder and the cross K/V
refresh.  So a loop writes into fixed buffers that the graphs read: the
token buffer, the KV cache, the cross K/V; ``reset_inference_state``
empties them in place.  The argmax stays one eager op.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from chamjax_torch.config import ModelConfig
from chamjax_torch.models import (
    KVCache,
    decoder_step,
    encoder_forward,
    init_decoder,
    init_encoder_decoder,
    init_kv_cache,
)
from chamjax_torch.models.kimi_linear import (MODEL_TYPE as KIMI_LINEAR,
                                              KimiLinearParams,
                                              init_kimi_cache,
                                              init_kimi_linear,
                                              kimi_prefill, kimi_step,
                                              reset_kimi_cache)
from chamjax_torch.models.llama import (init_llama, init_llama_kv_cache,
                                        llama_prefill, llama_step)
from chamjax_torch.models.mla_moe import (MODEL_TYPE as MLA_MOE,
                                          MlaMoeParams, init_latent_cache,
                                          init_mla_moe, mla_moe_prefill,
                                          mla_moe_step, reset_latent_cache)
from chamjax_torch.models.transformer import (TPParams, build_cross_kv,
                                              check_split, decoder_prefill,
                                              leaves, reset_cache,
                                              write_cross_kv)
from chamjax_torch.retrieval.interface import BaseRetriever
from chamjax_torch.serving.profiling import StepProfiler
from chamjax_torch.utils import graphs, tracing

_U32 = 0xFFFFFFFF


def _ids_to_tokens(ids: np.ndarray, tokens_per_doc: int, vocab: int,
                   seed: int = 7) -> np.ndarray:
    """Deterministically expand neighbour ids → pseudo token sequences
    (the reference synthesizes retrieved-document tokens for perf-parity
    benchmarking; derived from the ids, so reproducible and
    content-dependent)."""
    b, k = ids.shape
    base = (ids.astype(np.int64)[:, :, None] * 2654435761 + seed
            + np.arange(tokens_per_doc)[None, None, :] * 40503)
    return np.abs(base % max(vocab - 2, 1)).astype(np.int32).reshape(b, -1) + 1


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2^32`` for int64 ``x`` in [0, 2^32) and ``c`` < 2^32,
    with no intermediate past 2^49: ``c`` is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _ids_to_tokens_device(ids: torch.Tensor, tokens_per_doc: int, vocab: int,
                          seed: int = 7) -> torch.Tensor:
    """Device twin of ``_ids_to_tokens``, so the enc-dec retrieval step never
    leaves the device: the JAX package's uint32 wrapping hash, bit for bit
    (an id of -1 hashes as 4294967295).  torch has no full uint32
    arithmetic, so the hash runs in int64 reduced mod 2^32."""
    b, k = ids.shape
    x = ids.long() & _U32                                   # as uint32
    t = torch.arange(tokens_per_doc, dtype=torch.int64, device=ids.device)
    base = (_mul_u32(x, 2654435761)[:, :, None] + seed
            + t[None, None, :] * 40503) & _U32
    return (base % max(vocab - 2, 1)).to(torch.int32).reshape(b, -1) + 1


class Family(NamedTuple):
    """A model family's functions, as the loops and the benchmark call
    them: ``init(key, cfg, device=None)`` its parameters (a pair for the
    encoder-decoder), ``step(params, tokens, cache, **cross)`` with the
    config's heads (and rotary settings) bound, ``prefill(params, tokens,
    cache) -> (logits, hidden, cache)`` a whole prompt (b, t) of every row
    into the cache, ``new_cache(cfg, batch, device=None)``, and
    ``rewind(cache, prompt_len=0)``, which takes the cache back to its
    first ``prompt_len`` positions in place (at 0 it empties it)."""

    init: Callable
    step: Callable
    prefill: Callable
    new_cache: Callable
    rewind: Callable


def family(cfg: ModelConfig) -> Family:
    """The functions of ``cfg``'s family, by its ``model_type``: the one
    place outside ``models/`` that picks them.  The decoder's step is
    ``decoder_step`` as this module names it when this is called."""
    kind = cfg.model_type
    if kind == MLA_MOE:
        return Family(init_mla_moe, mla_moe_step, mla_moe_prefill,
                      init_latent_cache, reset_latent_cache)
    if kind == KIMI_LINEAR:
        return Family(init_kimi_linear, kimi_step, kimi_prefill,
                      init_kimi_cache, reset_kimi_cache)
    if kind == "llama":
        rope = dict(heads=cfg.attention_heads, kv_heads=cfg.kv_heads,
                    theta=cfg.rope_theta)
        return Family(init_llama, functools.partial(llama_step, **rope),
                      functools.partial(llama_prefill, **rope),
                      init_llama_kv_cache, reset_cache)
    if kind not in ("decoder", "encoder-decoder"):
        raise ValueError(f"family: unknown model_type {kind!r}")
    heads = cfg.attention_heads
    return Family(init_decoder if kind == "decoder" else init_encoder_decoder,
                  functools.partial(decoder_step, heads=heads),
                  functools.partial(decoder_prefill, heads=heads),
                  init_kv_cache, reset_cache)


def first_tokens(batch: int, device) -> torch.Tensor:
    """A loop's token buffer, holding the first token (1): graph state."""
    return graphs.state(torch.ones((batch,), dtype=torch.int32,
                                   device=device))


def _fill_cross_kv(enc, dec, ret_tokens, out, heads) -> None:
    """Encode the retrieved tokens and write the decoder's cross K/V into
    the buffers ``out`` in place: straight from the GEMMs on
    ``TransformerParams`` (``write_cross_kv``); on tensor-parallel
    parameters a copy, leaf by leaf, of ``build_cross_kv``'s grid."""
    enc_out = encoder_forward(enc, ret_tokens, heads)
    if not isinstance(dec, TPParams):
        write_cross_kv(dec, enc_out, heads, out)
        return
    for buf, new in zip(leaves(out), leaves(build_cross_kv(
            dec, enc_out, heads))):
        buf.copy_(new)


def _fill_cross_kv_from_ids(enc, dec, ids, out, heads, tokens_per_doc,
                            vocab, max_len) -> None:
    _fill_cross_kv(enc, dec, _ids_to_tokens_device(
        ids, tokens_per_doc, vocab)[:, :max_len], out, heads)


class CrossKV:
    """An encoder-decoder batch's cross-attention K/V: fixed buffers (graph
    state) that a retrieval step refills in place and the decode step's
    graph reads, and the graphs that refill them.

    On ``TransformerParams`` the buffers are one (layers, b, s, h, hd) K/V
    pair; on ``TPParams`` they take ``build_cross_kv``'s layout there: a
    ``[i][j]`` grid of (layers, b/dp, s, h/tp, hd) K and V, each on
    position (i, j)'s device.  A refill is one graph where every position
    lies on one device, and runs eagerly where they span devices."""

    def __init__(self, enc, dec, cfg: ModelConfig, tokens_per_doc: int):
        self.enc, self.dec, self.cfg = enc, dec, cfg
        self.tokens_per_doc = tokens_per_doc
        self.kv = None
        self.graphs = graphs.Graphs()

    def _buffers(self, b: int, s: int):
        cfg, dec = self.cfg, self.dec
        h = cfg.attention_heads
        if isinstance(dec, TPParams):
            check_split(dec, h, b)
            shape = (cfg.layers, b // dec.dp, s, h // dec.tp,
                     cfg.embed_dim // h)
            like = tuple(tuple(r.cwk for r in row) for row in dec.rank_grid)
        else:
            shape = (cfg.layers, b, s, h, cfg.embed_dim // h)
            like = dec.cross_layers.wkv

        def zeros(w):
            if isinstance(w, torch.Tensor):
                return graphs.state(torch.zeros(shape, dtype=w.dtype,
                                                device=w.device))
            return tuple(zeros(x) for x in w)
        if self.kv is None or leaves(self.kv)[0].shape != shape:
            self.kv = (zeros(like), zeros(like))
        return self.kv

    def _refill(self, fn, *args) -> None:
        if any(isinstance(p, TPParams) and not p.one_device
               for p in (self.enc, self.dec)):
            with graphs.disable_capture():    # one graph cannot span devices
                fn(*args)
        else:
            graphs.call(self.graphs, fn, *args)

    def from_ids(self, ids: torch.Tensor):
        """Refill from retrieved ids on the device (token synthesis,
        encoder and K/V in one graph); returns the buffers.  A span,
        ``ralm.refill``."""
        cfg = self.cfg
        s = min(ids.shape[1] * self.tokens_per_doc, cfg.max_seq_len)
        with tracing.annotate("ralm.refill"):
            self._refill(_fill_cross_kv_from_ids, self.enc, self.dec, ids,
                         self._buffers(ids.shape[0], s), cfg.attention_heads,
                         self.tokens_per_doc, cfg.vocab_size,
                         cfg.max_seq_len)
        return self.kv

    def from_tokens(self, ret_tokens: torch.Tensor):
        """Refill from retrieved tokens (the host path); returns the
        buffers.  A span, ``ralm.refill``."""
        with tracing.annotate("ralm.refill"):
            self._refill(_fill_cross_kv, self.enc, self.dec, ret_tokens,
                         self._buffers(*ret_tokens.shape),
                         self.cfg.attention_heads)
        return self.kv


def _block(t) -> None:
    """Wait for ``t``, a tensor or nested tuples of them
    (``block_until_ready``): on the host-retriever path only."""
    for device in {x.device for x in leaves(t) if x.is_cuda}:
        torch.cuda.synchronize(device)


def _finish(device: torch.device) -> None:
    """The one device sync of a batch; allowed under
    ``torch.cuda.set_sync_debug_mode``, which flags every other."""
    if device.type != "cuda":
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        torch.cuda.synchronize(device)
    finally:
        torch.cuda.set_sync_debug_mode(mode)


# the families that run on one device, by the parameters they take
ONE_DEVICE = {MLA_MOE: MlaMoeParams, KIMI_LINEAR: KimiLinearParams}


class RalmDecoder:
    """Decoder-only RALM loop (reference ``ralmDecoder``), for the decoder,
    the llama, the ``deepseek_v3`` and the ``kimi_linear`` families.  Runs on the parameters'
    device.

    ``prefill`` processes a prompt of every row once; from then on
    ``reset_inference_state`` rewinds the cache to the prompt's end, so
    that each generation continues the same prompt.  With no prompt it
    empties the cache."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        retriever: BaseRetriever,
        batch_size: int,
        retrieval_interval: Optional[int] = None,
        nprobe: int = 32,
        k: Optional[int] = None,
        query_set: Optional[np.ndarray] = None,
        use_query_set: bool = False,
    ):
        one = ONE_DEVICE.get(cfg.model_type)
        if one is not None and not isinstance(params, one):
            raise NotImplementedError(
                f"RalmDecoder: the {cfg.model_type} family runs on one "
                f"device ({one.__name__}); it has no tensor-parallel or "
                f"mesh form")
        self.params = params
        self.cfg = cfg
        self.retriever = retriever
        self.batch = batch_size
        self.interval = retrieval_interval or cfg.retrieval_interval
        self.nprobe = nprobe
        self.k = k or cfg.k
        self.query_set = query_set      # (steps, b, dim) replay buffer
        self.use_query_set = use_query_set
        self.device = params.embed.device
        self.prof = StepProfiler(self.device if self._device_path else None)
        self.family = family(cfg)
        self.cache = self.family.new_cache(cfg, batch_size,
                                           device=self.device)
        self.tokens = first_tokens(batch_size, self.device)
        self.prompt_len = 0
        self.reset_inference_state()

    def prefill(self, prompt: torch.Tensor) -> None:
        """Process ``prompt`` (b, t) of every row into the cache, through
        the family's prefill; later resets rewind to its end."""
        self.cache = self.family.rewind(self.cache)
        _, _, self.cache = self.family.prefill(self.params, prompt,
                                               self.cache)
        self.prompt_len = prompt.shape[1]
        self.reset_inference_state()

    def reset_inference_state(self) -> None:
        """Back to the prompt's end (an empty cache where there is none)
        and the first token, in place."""
        self.cache = self.family.rewind(self.cache, self.prompt_len)
        self.tokens.fill_(1)
        self.step_count = 0
        self.last_result = None
        self.prof.reset()

    def _query_vector(self, hidden: torch.Tensor) -> np.ndarray:
        if self.use_query_set and self.query_set is not None:
            return self.query_set[self.step_count % len(self.query_set)]
        return hidden.float().cpu().numpy()

    @property
    def _device_path(self) -> bool:
        """Fused path: when the retriever takes device tensors and no query
        replay is requested, decode → retrieve stays on the device with no
        per-step host transfer."""
        return (hasattr(self.retriever, "retrieve_device")
                and not self.use_query_set)

    def single_step(self) -> None:
        with self.prof.step_span():
            with self.prof.model_span():
                logits, hidden, self.cache = self.family.step(
                    self.params, self.tokens, self.cache)
                self.tokens.copy_(torch.argmax(logits, dim=-1))
                if not self._device_path:
                    _block(hidden)
            if self.step_count % self.interval == 0:
                with self.prof.retriever_span():
                    if self._device_path:
                        self.last_result = self.retriever.retrieve_device(
                            hidden.float(), self.nprobe, self.k)
                    else:
                        self.last_result = self.retriever.retrieve(
                            self._query_vector(hidden), self.nprobe, self.k)
            else:
                self.prof.time_retriever.append(0.0)
        self.step_count += 1

    def multi_steps(self, n: int) -> None:
        for _ in range(n):
            self.single_step()

    def batch_inference(self, num_step: Optional[int] = None) -> None:
        """Runs ``num_step`` steps; ``self.total_wall_s`` then holds the
        wall-clock including a final device sync.  Of the per-step arrays
        (``get_profiling``), ``time_step`` is the card's clock on the fused
        device path on the card (CUDA events at the step ends) and the
        host's elsewhere; ``time_model`` and ``time_retriever`` are the
        host's, which on the fused path times the enqueue."""
        t0 = time.perf_counter()
        self.multi_steps(num_step or self.cfg.max_seq_len)
        _finish(self.device)
        self.total_wall_s = time.perf_counter() - t0

    def throughput_tokens_per_sec(self, num_step: Optional[int] = None
                                  ) -> float:
        n = num_step or self.step_count
        return self.batch * n / self.total_wall_s

    def get_profiling(self):
        return self.prof.get_profiling()

    def print_profiling_stats(self, warmup: int = 0) -> None:
        self.prof.print_stats(self.batch, warmup)


class RalmEncoderDecoder:
    """Encoder-decoder RALM loop (reference ``ralmEncoderDecoder``).  Runs
    on the parameters' device.  Over tensor-parallel parameters
    (``shard_decoder_params`` of both models) the caller shards the cache
    too (``loop.cache = shard_kv_cache(loop.cache, mesh)``), as the
    reference's tests do."""

    def __init__(
        self,
        enc_params,
        dec_params,
        cfg: ModelConfig,
        retriever: BaseRetriever,
        batch_size: int,
        retrieval_interval: Optional[int] = None,
        nprobe: int = 32,
        k: Optional[int] = None,
        retrieval_token_len: Optional[int] = None,
    ):
        self.enc = enc_params
        self.dec = dec_params
        self.cfg = cfg
        self.retriever = retriever
        self.batch = batch_size
        self.interval = retrieval_interval or cfg.retrieval_interval
        self.nprobe = nprobe
        self.k = k or cfg.k
        self.tok_len = retrieval_token_len or cfg.retrieval_token_len
        self.device = dec_params.embed.device
        self.prof = StepProfiler(self.device if hasattr(
            retriever, "retrieve_device") else None)
        self.family = family(cfg)
        self.cache: KVCache = self.family.new_cache(cfg, batch_size,
                                                    device=self.device)
        self.tokens = first_tokens(batch_size, self.device)
        self._cross = CrossKV(enc_params, dec_params, cfg, self.tok_len)
        self.reset_inference_state()

    def reset_inference_state(self) -> None:
        """Back to an empty cache, the first token and no cross K/V, in
        place."""
        self.cache = self.family.rewind(self.cache)
        self.tokens.fill_(1)
        self.step_count = 0
        self.cross_kv = None
        self.last_result = None
        self.prof.reset()

    def _retrieval_step(self) -> None:
        device_path = hasattr(self.retriever, "retrieve_device")
        # 1. encode the current query token window → query vector
        q_tokens = self.tokens[:, None].expand(self.batch, 1)
        with self.prof.model_span():
            enc_q = encoder_forward(self.enc, q_tokens,
                                    self.cfg.attention_heads)
        # 2. retrieve  3. encode retrieved tokens → fresh decoder cross K/V;
        # with a device retriever the chain stays on the device
        if device_path:
            with self.prof.retriever_span():
                res = self.retriever.retrieve_device(
                    enc_q[:, -1, :].float(), self.nprobe, self.k)
            with self.prof.model_span():
                self.cross_kv = self._cross.from_ids(res.ids)
        else:
            query = enc_q[:, -1, :].float().cpu().numpy()
            with self.prof.retriever_span():
                res = self.retriever.retrieve(query, self.nprobe, self.k)
            ids = res.ids if res is not None else np.zeros(
                (self.batch, self.k), np.int64)
            ret_tokens = torch.from_numpy(_ids_to_tokens(
                ids, self.tok_len, self.cfg.vocab_size
            )[:, : self.cfg.max_seq_len]).to(self.device)
            with self.prof.model_span():
                self.cross_kv = self._cross.from_tokens(ret_tokens)
                _block(self.cross_kv)
        self.last_result = res

    def single_step(self) -> None:
        with self.prof.step_span():
            if self.step_count % self.interval == 0 or self.cross_kv is None:
                self._retrieval_step()
            else:
                self.prof.time_retriever.append(0.0)
            with self.prof.model_span():
                logits, hidden, self.cache = decoder_step(
                    self.dec, self.tokens, self.cache,
                    self.cfg.attention_heads, cross_kv=self.cross_kv,
                )
                self.tokens.copy_(torch.argmax(logits, dim=-1))
                if not hasattr(self.retriever, "retrieve_device"):
                    _block(hidden)
        self.step_count += 1

    def multi_steps(self, n: int) -> None:
        for _ in range(n):
            self.single_step()

    def batch_inference(self, num_step: Optional[int] = None) -> None:
        """Runs ``num_step`` steps; ``self.total_wall_s`` holds the
        wall-clock including a final device sync.  The per-step arrays'
        clocks are ``RalmDecoder.batch_inference``'s."""
        t0 = time.perf_counter()
        self.multi_steps(num_step or self.cfg.max_seq_len)
        _finish(self.device)
        self.total_wall_s = time.perf_counter() - t0

    def throughput_tokens_per_sec(self, num_step: Optional[int] = None
                                  ) -> float:
        n = num_step or self.step_count
        return self.batch * n / self.total_wall_s

    def get_profiling(self):
        return self.prof.get_profiling()

    def print_profiling_stats(self, warmup: int = 0) -> None:
        self.prof.print_stats(self.batch, warmup)
