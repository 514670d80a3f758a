"""Reranking stage: late-interaction MaxSim (ColBERT-style) and the seq2seq
pointwise scorer (the port of ``chamjax/ir/rerank.py``).

Parity with the reference's rerank surface:
- ``beir/beir/reranking/rerank.py`` + ``models/`` (CrossEncoder, MonoT5),
- the ColBERTv2 rerank step in the advanced-RAG demo
  (``reranker_hf/advanced_rag.py:210-212, 244-249`` via RAGatouille).

MaxSim late interaction: queries and docs encode to per-token vectors; the
score is the sum over query tokens of the max similarity to any doc token —
one batched fp32 einsum (TF32 off), a max and a sum on the device.
``HFCrossEncoder`` scores pairs with a ``transformers`` sequence
classifier; it needs ``transformers``, imported when one is made.
"""

from __future__ import annotations

import zlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul


@fp32_matmul()
def maxsim_scores(q_tok: torch.Tensor, d_tok: torch.Tensor,
                  d_mask: torch.Tensor) -> torch.Tensor:
    """q_tok (nq_tok, dim); d_tok (n_docs, nd_tok, dim); d_mask (n_docs,
    nd_tok).  Returns (n_docs,) MaxSim scores: padding doc tokens are -inf
    before the max, and a query token whose max is not finite (a doc of
    padding alone) counts 0, in that order, as in the JAX package."""
    sim = torch.einsum("td,nsd->nts", q_tok, d_tok)
    sim = sim.masked_fill(~(d_mask[:, None, :] > 0), float("-inf"))
    per_q_tok = sim.amax(dim=-1)                          # (n_docs, nq_tok)
    per_q_tok = torch.where(torch.isfinite(per_q_tok), per_q_tok,
                            torch.zeros_like(per_q_tok))
    return per_q_tok.sum(dim=-1)


def _pair_text(doc: Dict[str, str]) -> str:
    return (doc.get("title", "") + " " + doc.get("text", "")).strip()


class MaxSimReranker:
    """Late-interaction reranker over a token-level encoder.

    ``token_encoder`` must expose ``encode_tokens(texts) ->
    (tok_emb (n, max_tok, dim) float32, mask (n, max_tok))``.  The default
    hashing token encoder makes the stage hermetic.  ``device=None`` means
    the card.
    """

    def __init__(self, token_encoder=None, max_tokens: int = 64,
                 dim: int = 128, device=None):
        self.enc = token_encoder or HashingTokenEncoder(dim=dim,
                                                        max_tokens=max_tokens)
        self.device = resolve_device(device)

    def rerank(self, corpus: Dict[str, Dict[str, str]],
               queries: Dict[str, str],
               results: Dict[str, Dict[str, float]], top_k: int
               ) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for qid, doc_scores in results.items():
            cand = sorted(doc_scores, key=doc_scores.get, reverse=True)
            if not cand:
                out[qid] = {}
                continue
            q_tok, q_mask = self.enc.encode_tokens([queries[qid]])
            d_tok, d_mask = self.enc.encode_tokens(
                [_pair_text(corpus[d]) for d in cand])
            scores = maxsim_scores(
                as_f32(q_tok[0] * q_mask[0][:, None], self.device),
                as_f32(d_tok, self.device),
                as_f32(d_mask, self.device)).cpu().numpy()
            order = np.argsort(-scores)[:top_k]
            out[qid] = {cand[int(i)]: float(scores[int(i)]) for i in order}
        return out


class Rerank:
    """Two-stage retrieve→rerank wrapper (reference
    ``beir/beir/reranking/rerank.py``): takes first-stage results, scores
    (query, doc) pairs with a cross-encoder-style scorer, returns re-scored
    top-k.  ``cross_encoder`` must expose ``predict(pairs) -> scores``."""

    def __init__(self, cross_encoder, batch_size: int = 128):
        self.model = cross_encoder
        self.batch_size = batch_size

    def rerank(self, corpus, queries, results, top_k: int
               ) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for qid, doc_scores in results.items():
            cand = sorted(doc_scores, key=doc_scores.get, reverse=True)
            pairs = [(queries[qid], _pair_text(corpus[d])) for d in cand]
            scores = []
            for i in range(0, len(pairs), self.batch_size):
                scores.extend(self.model.predict(pairs[i:i + self.batch_size]))
            order = np.argsort(-np.asarray(scores))[:top_k]
            out[qid] = {cand[int(i)]: float(scores[int(i)]) for i in order}
        return out


class HashingTokenEncoder:
    """Per-token hashing embeddings (hermetic ColBERT stand-in); numpy, the
    JAX package's code unchanged."""

    def __init__(self, dim: int = 128, max_tokens: int = 64):
        self.dim = dim
        self.max_tokens = max_tokens
        self._cache: Dict[str, np.ndarray] = {}

    def _tok_vec(self, tok: str) -> np.ndarray:
        v = self._cache.get(tok)
        if v is None:
            seed = zlib.crc32(tok.encode()) & 0x7FFFFFFF
            v = np.random.default_rng(seed).standard_normal(self.dim)
            v /= np.linalg.norm(v) + 1e-9
            self._cache[tok] = v.astype(np.float32)
        return self._cache[tok]

    def encode_tokens(self, texts: List[str]):
        n = len(texts)
        emb = np.zeros((n, self.max_tokens, self.dim), np.float32)
        mask = np.zeros((n, self.max_tokens), np.float32)
        for i, t in enumerate(texts):
            toks = t.lower().split()[: self.max_tokens]
            for j, tok in enumerate(toks):
                emb[i, j] = self._tok_vec(tok)
                mask[i, j] = 1.0
        return emb, mask


class HFCrossEncoder:
    """Cross-encoder scorer over a HuggingFace sequence-classification
    checkpoint (the reference's ``beir/beir/reranking/models/
    cross_encoder`` — e.g. ms-marco MiniLM); plugs into ``Rerank``.  Needs
    ``transformers`` (imported here); ``model_name`` is a hub name or a
    local checkpoint directory.  ``device=None`` means the card, and raises
    without one before anything loads."""

    def __init__(self, model_name: str =
                 "cross-encoder/ms-marco-MiniLM-L-6-v2",
                 device=None, max_length: int = 256):
        self.device = resolve_device(device)
        from transformers import (                     # gated import
            AutoModelForSequenceClassification, AutoTokenizer,
        )
        self.tok = AutoTokenizer.from_pretrained(model_name)
        self.model = AutoModelForSequenceClassification.from_pretrained(
            model_name).to(self.device).eval()
        self.max_length = max_length

    def predict(self, pairs, batch_size: int = 32):
        """One score a (query, doc) pair: the logit of a one-label head,
        else the softmax probability of the last label."""
        out = []
        with torch.no_grad():
            for i in range(0, len(pairs), batch_size):
                batch = pairs[i:i + batch_size]
                enc = self.tok([p[0] for p in batch], [p[1] for p in batch],
                               padding=True, truncation=True,
                               max_length=self.max_length,
                               return_tensors="pt").to(self.device)
                logits = self.model(**enc).logits
                score = logits[:, 0] if logits.shape[-1] == 1 else \
                    torch.softmax(logits, dim=-1)[:, -1]
                out.extend(score.cpu().numpy().tolist())
        return out


class Seq2SeqReranker:
    """MonoT5-style pointwise seq2seq reranker on the port's enc-dec.

    Parity target: ``beir/beir/reranking/models/mono_t5.py`` — score a
    (query, doc) pair as the "true"-vs-"false" first-token log-odds of a
    seq2seq model fed "Query: q Document: d Relevant:".  The model is the
    port's encoder-decoder (``encoder_forward``, ``build_cross_kv``,
    ``decoder_step``; hash-tokenized, random weights from ``seed`` through
    a ``torch.Generator``, or the JAX package's carried across by
    ``models/convert.py``).  On the card each of the three is a captured
    graph: one KV cache a batch size, emptied before each batch, owns the
    decode step's.  Exposes the ``predict(pairs)`` contract, so it plugs
    into ``Rerank``.
    """

    TRUE_TOK, FALSE_TOK = 2, 3
    BOS = 1

    def __init__(self, cfg=None, seed: int = 0, max_len: int = 64,
                 device=None):
        from chamjax_torch.config import ModelConfig
        from chamjax_torch.models import init_encoder_decoder
        self.device = resolve_device(device)
        self.cfg = cfg or ModelConfig(
            model_type="encoder-decoder", embed_dim=128, ffn_embed_dim=256,
            layers=2, attention_heads=4, encoder_layers=2, vocab_size=4096,
            max_seq_len=max_len, dtype="float32")
        self.max_len = min(max_len, self.cfg.max_seq_len)
        self.enc_params, self.dec_params = init_encoder_decoder(
            seed, self.cfg, device=self.device)
        self._caches: Dict[int, object] = {}

    def _tokens(self, texts) -> np.ndarray:
        out = np.zeros((len(texts), self.max_len), np.int32)
        for i, t in enumerate(texts):
            toks = t.lower().split()[: self.max_len]
            for j, tok in enumerate(toks):
                out[i, j] = 4 + (zlib.crc32(tok.encode()) %
                                 (self.cfg.vocab_size - 4))
        return out

    def _cache(self, batch: int):
        from chamjax_torch.models import init_kv_cache
        from chamjax_torch.models.transformer import reset_cache
        cache = self._caches.get(batch)
        if cache is None:
            cache = self._caches[batch] = init_kv_cache(
                self.cfg, batch, max_len=2, device=self.device)
        return reset_cache(cache)

    @torch.no_grad()
    def predict(self, pairs, batch_size: int = 64):
        from chamjax_torch.models import decoder_step, encoder_forward
        from chamjax_torch.models.transformer import build_cross_kv
        heads = self.cfg.attention_heads
        scores = []
        for i in range(0, len(pairs), batch_size):
            batch = pairs[i:i + batch_size]
            toks_np = self._tokens([f"query: {q} document: {d} relevant:"
                                    for q, d in batch])
            toks = torch.from_numpy(toks_np).to(self.device)
            valid = torch.from_numpy(
                (toks_np != 0).sum(axis=1).astype(np.int32)).to(self.device)
            enc_out = encoder_forward(self.enc_params, toks, heads,
                                      valid_len=valid)
            ck, cv = build_cross_kv(self.dec_params, enc_out, heads)
            bos = torch.full((len(batch),), self.BOS, dtype=torch.int32,
                             device=self.device)
            logits, _, _ = decoder_step(
                self.dec_params, bos, self._cache(len(batch)), heads,
                cross_kv=(ck, cv), cross_valid_len=valid)
            lp = F.log_softmax(logits.float(), dim=-1)
            s = lp[:, self.TRUE_TOK] - lp[:, self.FALSE_TOK]
            scores.extend(s.cpu().numpy().tolist())
        return scores
