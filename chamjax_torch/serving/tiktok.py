"""Tik-tok scheduler: two interleaved micro-batches hide retrieval latency
(the port of ``chamjax/serving/tiktok.py``).

The reference's throughput-mode scheduler (``ralm/ralm/ralm_tiktok.py``):
two micro-batches ('tik', 'tok'), each with its own KV cache; retrieval is
split into a non-blocking ``send`` (issued right after the model step that
produced the query) and a polled ``recv``.  The loop walks both batches; a
batch stalls only on its own outstanding request, and answers are drained
in FIFO send order, so batch B's decode overlaps batch A's network and
scan, and the other way round.

Host pulls: with a host retriever (``retrieve_send`` / ``poll`` /
``retrieve_recv``), one pull of the query a send, and one completion pull
of the tokens a batch at the end; plain steps pull nothing.  With a
retriever that has ``retrieve_device`` the loop is fused: the search is one
more step on the device, and the only pulls are the completion's (the
tokens and the last retrieval's ids of each batch).

On the card each batch state has its own token buffer, KV cache (and, for
the encoder-decoder, cross K/V) and so its own captured graphs
(``utils/graphs.py``); on the fused path a state's decode step and its
search are graph replays on the one stream the loop enqueues on, in the
order it issues them, as in the reference's device FIFO.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from chamjax_torch.config import ModelConfig
from chamjax_torch.models import decoder_step, encoder_forward
from chamjax_torch.retrieval.interface import BaseRetriever
from chamjax_torch.serving.profiling import StepProfiler
from chamjax_torch.serving.ralm import (CrossKV, Family, _ids_to_tokens,
                                        family, first_tokens)


def _pull(t: torch.Tensor) -> np.ndarray:
    """One host pull (on the card: it waits for the device)."""
    return np.asarray(t.cpu())


class _BatchState:
    def __init__(self, fam: Family, cfg: ModelConfig, batch: int,
                 device: torch.device):
        self._rewind = fam.rewind
        self.cache = fam.new_cache(cfg, batch, device=device)
        self.tokens = first_tokens(batch, device)
        self.reset()

    def reset(self) -> None:
        """Back to an empty cache and the first token, in place (the graphs
        captured on them stay valid)."""
        self.cache = self._rewind(self.cache)
        self.tokens.fill_(1)
        self.step = 0
        self.sent = False
        self.finished = False
        self.last_result = None       # device path: most recent retrieval


class _Scheduler:
    """The state machine and FIFO both loops share (reference
    ``ralm_tiktok.py:197-239``)."""

    batch: int
    states: Dict[str, _BatchState]

    def reset_inference_state(self) -> None:
        for st in self.states.values():
            st.reset()
        self.in_flight: deque = deque()   # FIFO of batch names with sent reqs
        self.prof.reset()

    @property
    def _device_path(self) -> bool:
        """Fused path: the retriever consumes device tensors, so retrieval
        is one more step on the device; no send/recv host hop."""
        return hasattr(self.retriever, "retrieve_device")

    def _poll(self) -> bool:
        return True if self._device_path else self.retriever.poll()

    def _finish(self, t_start: float) -> None:
        # completion: one pull a batch forces its whole device chain
        # (tokens depend on every step), plus the last fused retrieval
        for st in self.states.values():
            _pull(st.tokens)
            if st.last_result is not None:
                _pull(st.last_result.ids)
        self.prof.time_step.append(time.perf_counter() - t_start)

    def throughput_tokens_per_sec(self, num_step: int) -> float:
        total = self.prof.time_step[-1]
        return 2 * self.batch * num_step / total

    def get_profiling(self):
        return self.prof.get_profiling()


class TikTokDecoder(_Scheduler):
    """Two-batch pipelined decoder-only RALM (reference
    ``ralmTikTokDecoder``), for the decoder, the llama and the
    ``deepseek_v3`` families.  Runs on the parameters' device."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        retriever: BaseRetriever,
        batch_size: int,
        retrieval_interval: Optional[int] = None,
        nprobe: int = 32,
        k: Optional[int] = None,
    ):
        self.params = params
        self.cfg = cfg
        self.retriever = retriever
        self.batch = batch_size
        self.interval = retrieval_interval or cfg.retrieval_interval
        self.nprobe = nprobe
        self.k = k or cfg.k
        self.prof = StepProfiler()
        fam = family(cfg)
        self._step_fn = fam.step
        device = params.embed.device
        self.states: Dict[str, _BatchState] = {
            name: _BatchState(fam, cfg, batch_size, device)
            for name in ("tik", "tok")}
        self.reset_inference_state()

    # --- primitive steps (reference :100-196) ---

    def _model_step(self, st: _BatchState) -> torch.Tensor:
        """One decode step, no host sync: ``hidden`` stays on the device;
        only a host-retriever send pulls it."""
        logits, hidden, st.cache = self._step_fn(self.params, st.tokens,
                                                 st.cache)
        st.tokens.copy_(torch.argmax(logits, dim=-1))
        return hidden

    def single_retrieve_step_send(self, name: str) -> None:
        st = self.states[name]
        with self.prof.model_span():
            hidden = self._model_step(st)
        if self._device_path:
            # the search follows the decode step on the device; its answer
            # is there when a later step reads it
            st.last_result = self.retriever.retrieve_device(
                hidden.float(), self.nprobe, self.k)
        else:
            self.retriever.retrieve_send(_pull(hidden.float()), self.nprobe,
                                         self.k)
        st.sent = True
        self.in_flight.append(name)

    def single_retrieve_step_recv(self, name: str) -> None:
        st = self.states[name]
        if not self._device_path:
            with self.prof.retriever_span():
                self.retriever.retrieve_recv(self.batch, self.k)
        st.sent = False
        st.step += 1
        self.in_flight.popleft()

    def single_inference_step(self, name: str) -> None:
        st = self.states[name]
        with self.prof.model_span():
            self._model_step(st)
        st.step += 1

    # --- scheduler loop (reference :197-239) ---

    def batch_inference(self, num_step: int) -> None:
        states = self.states
        t_start = time.perf_counter()
        while not all(s.finished for s in states.values()):
            progressed = False
            for name in ("tik", "tok"):
                st = states[name]
                if st.finished:
                    continue
                if st.step >= num_step:
                    st.finished = True
                    continue
                retrieval_step = st.step % self.interval == 0
                if retrieval_step and not st.sent:
                    self.single_retrieve_step_send(name)
                    progressed = True
                elif st.sent:
                    # FIFO: only the oldest in-flight request may recv
                    if self.in_flight and self.in_flight[0] == name \
                            and self._poll():
                        self.single_retrieve_step_recv(name)
                        progressed = True
                else:
                    self.single_inference_step(name)
                    progressed = True
            if not progressed and self.in_flight:
                # both batches blocked on their own requests: block on the
                # oldest
                self.single_retrieve_step_recv(self.in_flight[0])
        self._finish(t_start)


class _EncDecBatchState(_BatchState):
    def __init__(self, fam: Family, cfg: ModelConfig, batch: int,
                 device: torch.device, cross: CrossKV):
        self._cross = cross           # this batch's cross K/V and graphs
        super().__init__(fam, cfg, batch, device)

    def reset(self) -> None:
        super().reset()
        self.cross_kv = None
        self.last_ret = -1            # step whose retrieval has completed


class TikTokEncoderDecoder(_Scheduler):
    """Two-batch pipelined encoder-decoder RALM (reference
    ``ralmTikTokEncoderDecoder``): the retrieval step is split so that
    encoding the query, the retrieval, and encoding the retrieved tokens
    for cross-attention all overlap the other micro-batch's decode steps.
    Runs on the decoder parameters' device; over tensor-parallel
    parameters the caller shards each state's cache (``shard_kv_cache``)."""

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
        self.prof = StepProfiler()
        self.device = dec_params.embed.device
        fam = family(cfg)
        self.states: Dict[str, _EncDecBatchState] = {
            name: _EncDecBatchState(fam, cfg, batch_size, self.device,
                                    CrossKV(enc_params, dec_params, cfg,
                                            self.tok_len))
            for name in ("tik", "tok")}
        self.reset_inference_state()

    # --- primitive steps ---

    def single_retrieve_step_send(self, name: str) -> None:
        """Encode the query tokens, fire the retrieval (non-blocking)."""
        st = self.states[name]
        with self.prof.model_span():
            q_tokens = st.tokens[:, None].expand(self.batch, 1)
            enc_q = encoder_forward(self.enc, q_tokens,
                                    self.cfg.attention_heads)
        if self._device_path:
            st.last_result = self.retriever.retrieve_device(
                enc_q[:, -1, :].float(), self.nprobe, self.k)
        else:
            self.retriever.retrieve_send(_pull(enc_q[:, -1, :].float()),
                                         self.nprobe, self.k)
        st.sent = True
        self.in_flight.append(name)

    def single_retrieve_step_recv(self, name: str) -> None:
        """Drain the answer, encode retrieved tokens → fresh cross K/V."""
        st = self.states[name]
        if self._device_path:
            with self.prof.model_span():
                st.cross_kv = st._cross.from_ids(st.last_result.ids)
        else:
            with self.prof.retriever_span():
                res = self.retriever.retrieve_recv(self.batch, self.k)
            with self.prof.model_span():
                ids = (res.ids if res is not None
                       else np.zeros((self.batch, self.k), np.int64))
                ret_tokens = _ids_to_tokens(ids, self.tok_len,
                                            self.cfg.vocab_size)
                ret_tokens = torch.from_numpy(
                    ret_tokens[:, : self.cfg.max_seq_len]).to(self.device)
                st.cross_kv = st._cross.from_tokens(ret_tokens)
        st.sent = False
        self.in_flight.popleft()

    def single_inference_step(self, name: str) -> None:
        st = self.states[name]
        with self.prof.model_span():
            logits, _hidden, st.cache = decoder_step(
                self.dec, st.tokens, st.cache, self.cfg.attention_heads,
                cross_kv=st.cross_kv)
            st.tokens.copy_(torch.argmax(logits, dim=-1))
        st.step += 1

    # --- scheduler loop (same state machine as the decoder twin; here a
    # retrieval step is send → recv(refresh cross-KV) → decode, so recv does
    # not consume the step itself) ---

    def batch_inference(self, num_step: int) -> None:
        states = self.states
        t_start = time.perf_counter()
        while not all(s.finished for s in states.values()):
            progressed = False
            for name in ("tik", "tok"):
                st = states[name]
                if st.finished:
                    continue
                if st.step >= num_step:
                    st.finished = True
                    continue
                due = (st.step % self.interval == 0
                       and st.last_ret != st.step)
                if due and not st.sent:
                    self.single_retrieve_step_send(name)
                    progressed = True
                elif st.sent:
                    # FIFO: only the oldest in-flight request may recv
                    if self.in_flight and self.in_flight[0] == name \
                            and self._poll():
                        self.single_retrieve_step_recv(name)
                        st.last_ret = st.step
                        progressed = True
                else:
                    self.single_inference_step(name)
                    progressed = True
            if not progressed and self.in_flight:
                # both batches blocked on their own requests: block on oldest
                name = self.in_flight[0]
                self.single_retrieve_step_recv(name)
                states[name].last_ret = states[name].step
        # the device path's retrieval results are covered by the tokens:
        # the cross K/V feeds the decode chain
        self._finish(t_start)
