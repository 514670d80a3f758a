"""Training-side utilities for dense retrievers: the losses (the port of
``chamjax/ir/train.py``).

Parity with the reference BEIR fork's training surface
(``beir/beir/losses/`` — MultipleNegativesRankingLoss, MarginMSELoss, BPR
losses): torch functions whose gradients come from autograd, usable in any
``torch.optim`` loop over a dual encoder.  The matmuls run in float32 with
TF32 off, the port of ``Precision.HIGHEST``.  ``QueryGenerator`` samples
queries from a ``transformers`` seq2seq checkpoint; it needs
``transformers``, imported when one is made.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from chamjax_torch.utils.device import resolve_device
from chamjax_torch.utils.precision import fp32_matmul


@fp32_matmul()
def cos_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-9)
    b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-9)
    return a @ b.T


def in_batch_nce(scores: torch.Tensor) -> torch.Tensor:
    """InfoNCE over a (b, n ≥ b) score matrix whose row i's positive is
    column i."""
    labels = torch.arange(scores.shape[0], device=scores.device)
    return -F.log_softmax(scores, dim=-1)[labels, labels].mean()


def multiple_negatives_ranking_loss(
    q_emb: torch.Tensor,     # (b, d) query embeddings
    pos_emb: torch.Tensor,   # (b, d) positive doc embeddings
    scale: float = 20.0,
) -> torch.Tensor:
    """In-batch negatives InfoNCE (reference
    ``losses/MultipleNegativesRankingLoss``): row i's positive is column i;
    every other column is a negative."""
    return in_batch_nce(cos_sim(q_emb, pos_emb) * scale)


def margin_mse_loss(
    q_emb: torch.Tensor,        # (b, d)
    pos_emb: torch.Tensor,      # (b, d)
    neg_emb: torch.Tensor,      # (b, d)
    teacher_margin: torch.Tensor,   # (b,) teacher score(pos) - score(neg)
) -> torch.Tensor:
    """Distillation loss (reference ``losses/MarginMSELoss``): student's
    dot-product margin regresses the cross-encoder teacher's margin."""
    s_pos = (q_emb * pos_emb).sum(dim=-1)
    s_neg = (q_emb * neg_emb).sum(dim=-1)
    return ((s_pos - s_neg - teacher_margin) ** 2).mean()


def bpr_loss(q_emb: torch.Tensor, pos_emb: torch.Tensor,
             neg_emb: torch.Tensor) -> torch.Tensor:
    """Bayesian personalized ranking (reference BPR models): -log sigmoid of
    the positive-negative margin."""
    margin = (q_emb * pos_emb).sum(dim=-1) - (q_emb * neg_emb).sum(dim=-1)
    return -F.logsigmoid(margin).mean()


class QueryGenerator:
    """Synthetic-query generation over a corpus (reference ``generation/``
    QGen, docT5query-style): nucleus sampling from a seq2seq checkpoint.
    Needs ``transformers`` (imported here); ``model_name`` is a hub name or
    a local checkpoint directory.  ``device=None`` means the card, and
    raises without one before anything loads.  Samples draw from torch's
    global generator: seed it (``torch.manual_seed``) to repeat them."""

    def __init__(self, model_name: str = "BeIR/query-gen-msmarco-t5-base-v1",
                 device=None):
        self.device = resolve_device(device)
        from transformers import AutoModelForSeq2SeqLM, AutoTokenizer
        self.tok = AutoTokenizer.from_pretrained(model_name)
        self.model = AutoModelForSeq2SeqLM.from_pretrained(model_name
                                                           ).to(self.device)

    def generate(self, texts: List[str], queries_per_doc: int = 3,
                 max_length: int = 64,
                 top_p: float = 0.95) -> List[List[str]]:
        out: List[List[str]] = []
        with torch.no_grad():
            for t in texts:
                enc = self.tok(t, truncation=True, max_length=512,
                               return_tensors="pt").to(self.device)
                gen = self.model.generate(
                    **enc, do_sample=True, top_p=top_p,
                    max_length=max_length,
                    num_return_sequences=queries_per_doc)
                out.append([self.tok.decode(g, skip_special_tokens=True)
                            for g in gen])
        return out
