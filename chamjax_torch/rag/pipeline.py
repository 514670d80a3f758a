"""Advanced RAG pipeline: retrieve → rerank → prompt → generate, profiled
(the port of ``chamjax/rag/pipeline.py``).

Parity with the reference's demo & profiling loop
(``reranker_hf/advanced_rag.py:219-279``): ``answer(question)`` retrieves
``n_retrieved`` chunks from the vector store, optionally reranks down to
``n_final`` with the late-interaction reranker, assembles the context
prompt, and calls the reader LLM — every stage wrapped in a wall-clock
timer, a span of ``utils/tracing.py`` (a ``record_function`` range while a
``torch.profiler`` trace records, the JAX package's ``TraceAnnotation``)
and, where a card is present, an NVTX range, the reference's own.
"""

from __future__ import annotations

import contextlib
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from chamjax_torch.utils import tracing
from chamjax_torch.utils.device import resolve_device


class StageTimer:
    """Named stage spans: wall-clock + profiler spans (reference stage
    timers + nvtx, advanced_rag.py:228-279).  A stage's time ends when its
    body returns: the stages here end in a host read of their result, so
    the card's work is inside."""

    def __init__(self) -> None:
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        nvtx = (torch.cuda.nvtx.range(name) if torch.cuda.is_available()
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with tracing.annotate(name), nvtx:
            yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def stats_ms(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"p50": float(np.median(a) * 1e3),
                   "mean": float(np.mean(a) * 1e3),
                   "count": len(a)}
            for name, a in ((n, np.asarray(t))
                            for n, t in self.times.items())
        }

    def print_stats(self) -> None:
        for name, s in self.stats_ms().items():
            print(f"  {name}: p50={s['p50']:.2f}ms mean={s['mean']:.2f}ms "
                  f"(n={s['count']})", flush=True)


PROMPT_TEMPLATE = """Using the information contained in the context,
give a comprehensive answer to the question.
Respond only to the question asked; be concise and relevant.
If the answer cannot be deduced from the context, do not give an answer.

Context:
{context}
---
Question: {question}
Answer:"""


class AdvancedRAG:
    """retrieve(n_retrieved) → rerank(n_final) → prompt → generate."""

    def __init__(self, store, reader, reranker=None,
                 n_retrieved: int = 30, n_final: int = 5,
                 prompt_template: str = PROMPT_TEMPLATE):
        self.store = store
        self.reader = reader
        self.reranker = reranker
        self.n_retrieved = n_retrieved
        self.n_final = n_final
        self.prompt_template = prompt_template
        self.timer = StageTimer()

    def answer(self, question: str
               ) -> Tuple[str, List[Dict[str, str]]]:
        """Returns (answer_text, final_context_docs)."""
        with self.timer.span("retrieval"):
            hits = self.store.similarity_search(question, k=self.n_retrieved)
            docs = [d for d, _score in hits]

        if self.reranker is not None and docs:
            with self.timer.span("rerank"):
                corpus = {str(i): {"title": d.get("title", ""),
                                   "text": d.get("text", "")}
                          for i, d in enumerate(docs)}
                first = {"q": {str(i): float(len(docs) - i)
                               for i in range(len(docs))}}
                reranked = self.reranker.rerank(
                    corpus, {"q": question}, first, self.n_final)
                order = list(reranked["q"].keys())
                docs = [docs[int(i)] for i in order]
        else:
            docs = docs[: self.n_final]

        with self.timer.span("prompt_build"):
            context = "\n".join(
                f"Document {i}:::\n{d.get('text', '')}"
                for i, d in enumerate(docs))
            prompt = self.prompt_template.format(context=context,
                                                 question=question)

        with self.timer.span("generate"):
            answer = self.reader.generate(prompt)
        return answer, docs


class EchoReader:
    """Hermetic reader: answers with the most salient context line —
    enough to test the pipeline plumbing without model weights."""

    def generate(self, prompt: str, max_new_tokens: int = 64) -> str:
        ctx = prompt.split("Context:")[-1].split("---")[0]
        lines = [line for line in ctx.splitlines() if line.strip()
                 and not line.startswith("Document")]
        return lines[0].strip() if lines else ""


class DecoderReader:
    """Perf-parity reader: greedy generation with the port's transformer
    decoder (random weights from ``seed`` — the reference also benchmarks
    with random fairseq weights; quality readers plug in via the same
    ``generate`` contract).  The JAX package's ``JaxDecoderReader``.

    The reader owns one batch-1 KV cache, emptied at each ``generate``; on
    the card each ``decoder_step`` replays the graph that cache owns
    (``utils/graphs.py``), captured at the first step.  The tokens stay on
    the device until the last step."""

    def __init__(self, cfg=None, max_new_tokens: int = 32, seed: int = 0,
                 device=None):
        from chamjax_torch.config import ModelConfig
        from chamjax_torch.models import init_decoder, init_kv_cache
        self.device = resolve_device(device)
        self.cfg = cfg or ModelConfig(model_type="decoder", embed_dim=256,
                                      ffn_embed_dim=512, layers=4,
                                      attention_heads=8, vocab_size=32000,
                                      max_seq_len=256)
        self.params = init_decoder(seed, self.cfg, device=self.device)
        self.cache = init_kv_cache(self.cfg, 1, device=self.device)
        self.max_new_tokens = max_new_tokens

    def generate_ids(self, prompt: str,
                     max_new_tokens: Optional[int] = None) -> List[int]:
        from chamjax_torch.models import decoder_step
        from chamjax_torch.models.transformer import reset_cache
        n = max_new_tokens or self.max_new_tokens
        cache = reset_cache(self.cache)
        tok = torch.tensor(
            [zlib.crc32(prompt.encode()) % (self.cfg.vocab_size - 1) + 1],
            dtype=torch.int32, device=self.device)
        out = []
        for _ in range(n):
            logits, _h, cache = decoder_step(
                self.params, tok, cache, self.cfg.attention_heads)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
        return torch.cat(out).cpu().tolist() if out else []

    def generate(self, prompt: str, max_new_tokens: Optional[int] = None
                 ) -> str:
        return " ".join(f"<{t}>" for t in self.generate_ids(
            prompt, max_new_tokens))
