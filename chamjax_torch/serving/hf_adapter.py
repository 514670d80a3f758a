"""RALM loop over a HuggingFace causal LM — the Llama-variant adapter.

Parity with the reference's ``ralmDecoder_llama`` (``ralm/ralm/ralm.py:433-618``
— a ralmDecoder twin scaffolded for HF llama checkpoints): the same
single_step / multi_steps / batch_inference / profiling surface, with the
model step delegated to any ``transformers`` causal LM (KV cache via
``past_key_values``) and the retrieval query taken from the last hidden
state.  Works with locally-constructed configs (no weight download needed)
or any pretrained checkpoint.

The port of ``chamjax/serving/hf_adapter.py`` (which is already torch): the
same loop on the port's retriever contract and ``StepProfiler``, with
``device=None`` meaning the card (it raises without one unless given
``device="cpu"``).  It needs ``transformers``, imported by the caller's
model and by ``tiny_hf_model`` only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from chamjax_torch.retrieval.interface import BaseRetriever
from chamjax_torch.serving.profiling import StepProfiler
from chamjax_torch.utils.device import resolve_device


class RalmHFDecoder:
    """Decoder-only RALM loop on a HuggingFace model (torch)."""

    def __init__(
        self,
        model,                        # transformers causal LM (eval mode)
        retriever: BaseRetriever,
        batch_size: int,
        retrieval_interval: int = 1,
        nprobe: int = 32,
        k: int = 10,
        device=None,
        query_dim: Optional[int] = None,
    ):
        import torch
        self.torch = torch
        device = resolve_device(device)
        self.model = model.to(device).eval()
        self.retriever = retriever
        self.batch = batch_size
        self.interval = retrieval_interval
        self.nprobe = nprobe
        self.k = k
        self.device = device
        hidden = getattr(model.config, "hidden_size",
                         getattr(model.config, "n_embd", None))
        self.query_dim = query_dim or hidden
        self.prof = StepProfiler()
        self.reset_inference_state()

    def reset_inference_state(self) -> None:
        self.past = None
        self.tokens = self.torch.ones((self.batch, 1), dtype=self.torch.long,
                                      device=self.device)
        self.step_count = 0
        self.last_result = None
        self.prof.reset()

    def _query_vector(self, hidden) -> np.ndarray:
        q = hidden[:, -1, :].float().cpu().numpy()
        if q.shape[1] > self.query_dim:           # truncate to index dim
            q = q[:, : self.query_dim]
        elif q.shape[1] < self.query_dim:         # zero-pad up to index dim
            # (reference ralm.py sends the raw hidden state and relies on
            # matching dims; a narrow model must still produce a wire- and
            # matmul-valid query rather than an opaque shape error)
            q = np.pad(q, ((0, 0), (0, self.query_dim - q.shape[1])))
        return np.ascontiguousarray(q, np.float32)

    def single_step(self) -> None:
        with self.prof.step_span():
            with self.prof.model_span(), self.torch.no_grad():
                out = self.model(self.tokens, past_key_values=self.past,
                                 use_cache=True, output_hidden_states=True)
                self.past = out.past_key_values
                self.tokens = out.logits[:, -1, :].argmax(-1, keepdim=True)
                hidden = out.hidden_states[-1]
            if self.step_count % self.interval == 0:
                query = self._query_vector(hidden)
                with self.prof.retriever_span():
                    self.last_result = self.retriever.retrieve(
                        query, self.nprobe, self.k)
            else:
                self.prof.time_retriever.append(0.0)
        self.step_count += 1

    def multi_steps(self, n: int) -> None:
        for _ in range(n):
            self.single_step()

    def batch_inference(self, num_step: int) -> None:
        self.multi_steps(num_step)

    def get_profiling(self):
        return self.prof.get_profiling()

    def print_profiling_stats(self, warmup: int = 0) -> None:
        self.prof.print_stats(self.batch, warmup)


def tiny_hf_model(hidden: int = 64, layers: int = 2, heads: int = 4,
                  vocab: int = 256):
    """Locally-constructed random GPT-2 (no download) for tests/benchmarks."""
    from transformers import GPT2Config, GPT2LMHeadModel
    cfg = GPT2Config(n_embd=hidden, n_layer=layers, n_head=heads,
                     vocab_size=vocab, n_positions=512)
    return GPT2LMHeadModel(cfg)
