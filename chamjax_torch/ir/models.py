"""Trainable encoder models for the IR harness (the port of
``chamjax/ir/models.py``).

The reference ships a zoo of pretrained encoder families
(``beir/beir/retrieval/models/__init__.py``: SBERT, DPR dual encoders,
SPLADE/UniCOIL learned-sparse, BPR, TLDR).  With no weight downloads the
zoo's *trainable* members are rebuilt as compact models over a hashed
vocabulary, trained with the losses of ``ir/train.py``:

- ``DualEncoder``   — DPR-style two-tower dense encoder (shared hashed
  embedding, per-tower MLP heads, L2-normalized outputs), trained with
  in-batch-negatives InfoNCE; the JAX package's ``JaxDualEncoder``.
  Duck-types ``encode_queries``/``encode_corpus`` for
  ``DenseRetrievalExactSearch`` exactly like the reference's
  ``models.SentenceBERT``.
- ``SparseEncoder`` — SPLADE-style learned-sparse encoder
  (``log1p(relu(E @ head))`` with max-pooling over positions), trained with
  the same InfoNCE over sparse dot products plus SPLADE's FLOPS
  regularizer; emits weighted bucket dicts for ``SparseSearch``; the JAX
  package's ``JaxSparseEncoder``.

Both are ``nn.Module``s whose parameter names are the JAX package's
(``embed``, ``q.w1`` …, ``head``), so ``models/convert.py`` carries its
parameters across.  They live on ``device`` (``None`` means the card) and
draw their initial values from ``seed``'s threefry streams
(``chamjax_torch.random``), the JAX package's, so a seed gives its initial
parameters.  ``fit`` trains
with autograd and ``torch.optim.Adam`` (optax's ``adam``: the same update,
``eps_root`` 0) with TF32 off; its minibatches are the reference's numpy
``default_rng(seed)`` draws, call for call, so both packages train on the
same batches.  The tokenized pairs move to the device once and each step
indexes them there.
"""

from __future__ import annotations

import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chamjax_torch import random as jr
from chamjax_torch.ir.train import in_batch_nce, multiple_negatives_ranking_loss
from chamjax_torch.utils.device import resolve_device
from chamjax_torch.utils.precision import fp32_matmul


def _hash_token(tok: str, vocab: int) -> int:
    return zlib.crc32(tok.encode()) % vocab


def tokenize_ids(text: str, vocab: int, max_len: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Whitespace-lowercase tokens → (ids (max_len,), mask (max_len,))."""
    toks = text.lower().split()[:max_len]
    ids = np.zeros(max_len, np.int32)
    mask = np.zeros(max_len, np.float32)
    for i, t in enumerate(toks):
        ids[i] = _hash_token(t, vocab)
        mask[i] = 1.0
    return ids, mask


def _batch_ids(texts: Sequence[str], vocab: int, max_len: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``(ids (n, max_len) int32, mask (n, max_len) f32)`` numpy arrays."""
    ids = np.zeros((len(texts), max_len), np.int32)
    mask = np.zeros((len(texts), max_len), np.float32)
    for i, t in enumerate(texts):
        ids[i], mask[i] = tokenize_ids(t, vocab, max_len)
    return ids, mask


def _doc_text(d) -> str:
    if isinstance(d, dict):
        return (d.get("title", "") + " " + d.get("text", "")).strip()
    return str(d)


def training_pairs(queries: Dict[str, str], qrels: Dict[str, Dict[str, int]],
                   corpus: Dict[str, Dict[str, str]],
                   min_score: int = 0,
                   ) -> List[Tuple[str, str]]:
    """(query text, positive doc text) pairs from BEIR-format qrels — the
    input shape of the reference's ``TrainRetriever`` dataloader.

    ``min_score``: with graded qrels, train on positives of at least this
    grade.  0 keeps every judged-positive doc (score > 0, fractional grades
    included); min_score > 0 is an inclusive grade floor."""
    pairs = []
    for qid, rel in qrels.items():
        if qid not in queries:
            continue
        for did, score in rel.items():
            keep = score > 0 if min_score <= 0 else score >= min_score
            if keep and did in corpus:
                pairs.append((queries[qid], _doc_text(corpus[did])))
    return pairs


def _on(a: np.ndarray, dev: torch.device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def _draws(n: int, batch: int, steps: int, seed: int) -> np.ndarray:
    """The reference's minibatch draws, ``rng.choice(n, size=batch,
    replace=batch > n // 2)`` once a step from ``default_rng(seed)``, made
    before the loop: ``(steps, batch)``."""
    rng = np.random.default_rng(seed)
    rows = [rng.choice(n, size=batch, replace=batch > n // 2)
            for _ in range(steps)]
    return np.stack(rows) if rows else np.zeros((0, batch), np.int64)


def _adam(params, lr: float) -> torch.optim.Adam:
    """optax's ``adam(lr)``: b1 0.9, b2 0.999, eps 1e-8, ``eps_root`` 0."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _train(module: nn.Module, loss_fn, steps: int, lr: float, name: str,
           verbose: bool) -> List[float]:
    """``steps`` Adam steps of ``loss_fn(i)``; returns the loss curve.  The
    losses stay on the device until the end (no host sync a step)."""
    opt = _adam(module.parameters(), lr)
    losses = []
    with fp32_matmul():
        for i in range(steps):
            loss = loss_fn(i)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if verbose and i % 50 == 0:
                print(f"  {name} step {i}: loss {float(loss):.4f}")
    return torch.stack(losses).cpu().tolist() if losses else []


def mining_branch(device: torch.device, n_docs: int, use_ivfpq: bool
                  ) -> str:
    """``"ivfpq"`` on a card (the reference's TPU branch), ``"exact"`` on
    the CPU (as the reference off the TPU) or where the caller asks for it
    with ``use_ivfpq=False``; raises on a card for a corpus too small for
    the index, rather than mine exactly unasked."""
    if device.type != "cuda" or not use_ivfpq:
        return "exact"
    if n_docs < 4096:
        raise ValueError(
            f"mine_hard_negatives: {n_docs} docs are too few for the IVF-PQ "
            "branch on the card (4096 at least); pass use_ivfpq=False to "
            "mine exactly")
    return "ivfpq"


class _Tower(nn.Module):
    def __init__(self, emb_dim: int, dim: int, device: torch.device):
        super().__init__()
        z = dict(device=device, dtype=torch.float32)
        self.w1 = nn.Parameter(torch.zeros(emb_dim, dim, **z))
        self.b1 = nn.Parameter(torch.zeros(dim, **z))
        self.w2 = nn.Parameter(torch.zeros(dim, dim, **z))
        self.b2 = nn.Parameter(torch.zeros(dim, **z))


class DualEncoder(nn.Module):
    """DPR-style dual encoder: shared hashed embedding, two MLP towers.

    Reference anchor: ``beir/beir/retrieval/models/sentence_bert.py`` (the
    duck-typed surface) + ``models/dpr.py`` (the two-tower structure).
    ``shared_towers`` starts both towers from the same values; they train
    apart, as in the JAX package."""

    def __init__(self, vocab: int = 8192, dim: int = 128,
                 emb_dim: int = 64, max_len: int = 32, seed: int = 0,
                 shared_towers: bool = False, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.vocab = vocab
        self.dim = dim
        self.max_len = max_len
        self.shared = shared_towers
        dev = self.device
        ke, k1, k2 = jr.split(seed, 3)
        self.embed = nn.Parameter(jr.normal(ke, (vocab, emb_dim),
                                            scale=emb_dim ** -0.5, device=dev))
        self.q = _Tower(emb_dim, dim, dev)
        self.d = _Tower(emb_dim, dim, dev)
        with torch.no_grad():
            for tower, key in ((self.q, k1),
                               (self.d, k1 if shared_towers else k2)):
                ka, kb = jr.split(key)
                tower.w1.copy_(jr.normal(ka, (emb_dim, dim),
                                         scale=emb_dim ** -0.5, device=dev))
                tower.w2.copy_(jr.normal(kb, (dim, dim), scale=dim ** -0.5,
                                         device=dev))
        # which branch each mine_hard_negatives call took, and its seconds
        self.mining: List[dict] = []

    def _encode(self, tower: str, ids: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        e = self.embed[ids]                               # (b, L, emb)
        denom = mask.sum(dim=1, keepdim=True) + 1e-9
        pooled = (e * mask[..., None]).sum(dim=1) / denom
        t = getattr(self, tower)
        h = F.gelu(pooled @ t.w1 + t.b1, approximate="tanh")
        out = h @ t.w2 + t.b2
        return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True)
                      + 1e-9)

    def _tokens(self, texts: Sequence[str]):
        ids, mask = _batch_ids(list(texts), self.vocab, self.max_len)
        return _on(ids, self.device, torch.long), _on(mask, self.device)

    def _pair_tokens(self, pairs):
        """The pairs' query and doc tokens on the device.  They are kept
        for the next ``fit`` on the same list object (the hard-negative
        rounds train on the warmup's pairs): tokenizing is host Python,
        ~45 µs a text."""
        kept = getattr(self, "_pairs", None)
        if kept is None or kept[0] is not pairs:
            kept = self._pairs = (pairs, self._tokens([p[0] for p in pairs]),
                                  self._tokens([p[1] for p in pairs]))
        return kept[1], kept[2]

    def fit(self, pairs: Sequence[Tuple[str, str]], *, steps: int = 200,
            batch: int = 32, lr: float = 3e-3, seed: int = 0,
            scale: float = 20.0, verbose: bool = False,
            neg_tokens=None, neg_idx: Optional[np.ndarray] = None,
            ) -> List[float]:
        """Train with in-batch-negatives InfoNCE; returns the loss curve.

        ``neg_tokens=(ids (n_docs,L), mask (n_docs,L))`` +
        ``neg_idx (n_pairs, H)`` appends H *mined hard negatives* per pair
        to the candidate pool: the InfoNCE denominator becomes the B
        in-batch positives followed by the batch's B·H mined docs, in that
        order (MS-MARCO hard-negative practice).  The corpus is tokenized
        once, by the caller."""
        (q_ids, q_mask), (d_ids, d_mask) = self._pair_tokens(pairs)
        n = len(pairs)
        batch = min(batch, n)
        sels = _on(_draws(n, batch, steps, seed), self.device, torch.long)
        hard = neg_idx is not None
        if hard:
            nt_ids = _on(np.asarray(neg_tokens[0]), self.device, torch.long)
            nt_mask = _on(np.asarray(neg_tokens[1], np.float32), self.device)
            neg = _on(np.asarray(neg_idx, np.int64), self.device)

        def loss_fn(i):
            sel = sels[i]
            qe = self._encode("q", q_ids[sel], q_mask[sel])   # (B, dim)
            de = self._encode("d", d_ids[sel], d_mask[sel])   # (B, dim)
            if not hard:
                return multiple_negatives_ranking_loss(qe, de, scale=scale)
            ni = neg[sel].reshape(-1)                         # (B*H,)
            ne = self._encode("d", nt_ids[ni], nt_mask[ni])   # (B*H, dim)
            cand = torch.cat([de, ne], dim=0)                 # (B+B*H, dim)
            return in_batch_nce((scale * qe) @ cand.T)

        return _train(self, loss_fn, steps, lr, "dual-encoder", verbose)

    @torch.no_grad()
    def _embed_tokens(self, tower: str, ids, mask, chunk: int = 8192
                      ) -> torch.Tensor:
        """Encode host token arrays in chunks; the embeddings stay on the
        device."""
        out = []
        with fp32_matmul():
            for s in range(0, ids.shape[0], chunk):
                out.append(self._encode(
                    tower, _on(ids[s:s + chunk], self.device, torch.long),
                    _on(np.asarray(mask[s:s + chunk], np.float32),
                        self.device)))
        return (torch.cat(out) if out else
                torch.zeros((0, self.dim), device=self.device))

    def mine_hard_negatives(self, queries: Sequence[str],
                            doc_tokens, *, positives: Sequence[set],
                            n_neg: int = 4, depth: int = 32,
                            use_ivfpq: bool = True,
                            encode_batch: int = 8192,
                            seed: int = 0) -> np.ndarray:
        """Top-ranked non-judged docs per query under the CURRENT model —
        mined with the repo's own IVF-PQ engine (the reference pipeline
        mines hard negatives with its retriever between epochs).

        ``doc_tokens=(ids (n_docs,L), mask)`` is the once-tokenized
        corpus; ``positives[i]`` is the set of judged doc indices for
        ``queries[i]`` (excluded — judged docs of ANY grade are not
        negatives).  Returns ``(n_queries, n_neg) int64`` doc indices.

        On a card the IVF-PQ branch runs (``build_ivfpq`` and
        ``IVFSearcher``: the ``adc_scan_tiles`` kernel), the counterpart
        of the reference's TPU branch; a corpus under 4096 docs raises
        there, and ``use_ivfpq=False`` asks for the exact branch.  On the
        CPU the exact branch runs, as the reference's does off the TPU.
        Each call appends its branch to ``self.mining``."""
        t0 = time.perf_counter()
        nd = doc_tokens[0].shape[0]
        demb = self._embed_tokens("d", doc_tokens[0], doc_tokens[1],
                                  encode_batch)
        qids, qmask = _batch_ids(list(queries), self.vocab, self.max_len)
        qemb = self._embed_tokens("q", qids, qmask, encode_batch)
        info = dict(branch=mining_branch(self.device, nd, use_ivfpq),
                    n_docs=nd, n_queries=len(queries))
        if info["branch"] == "ivfpq":
            from chamjax_torch.config import IndexConfig, SearchConfig
            from chamjax_torch.index import build_ivfpq
            from chamjax_torch.searcher import IVFSearcher
            d = demb.shape[1]
            cfg = IndexConfig(dim=d, nlist=max(16, min(1024, nd // 64)),
                              m=max(4, d // 16))
            idx = build_ivfpq(demb, cfg, kmeans_iters=6, pq_iters=6,
                              device=self.device)
            s = IVFSearcher(idx, SearchConfig(
                nprobe=min(32, cfg.nlist), k=depth + 16), device=self.device)
            _dd, ranked = s.search(qemb)
            info.update(nlist=cfg.nlist, m=cfg.m, nprobe=s.scfg.nprobe)
        else:           # exact (cosine — embeddings are L2-normalized)
            with fp32_matmul():
                scores = qemb @ demb.T
            top = min(depth + 16, nd)
            ranked = torch.topk(scores, top, dim=1).indices.cpu().numpy()

        rng = np.random.default_rng(seed)
        out = np.zeros((len(queries), n_neg), np.int64)
        for qi in range(len(queries)):
            cand = [int(d_) for d_ in ranked[qi][:depth]
                    if d_ >= 0 and d_ not in positives[qi]]
            if len(cand) < n_neg:      # pad with random non-judged docs
                pool = rng.integers(0, nd, size=4 * n_neg)
                cand += [int(d_) for d_ in pool
                         if d_ not in positives[qi]][: n_neg - len(cand)]
            out[qi] = np.asarray(cand[:n_neg], np.int64)
        info["seconds"] = time.perf_counter() - t0
        self.mining.append(info)
        return out

    # --- DenseRetrievalExactSearch duck-typed surface ---

    def _embed_texts(self, texts: List[str], tower: str) -> np.ndarray:
        ids, mask = _batch_ids(texts, self.vocab, self.max_len)
        return self._embed_tokens(tower, ids, mask).cpu().numpy()

    def encode_queries(self, texts: List[str], batch_size: int = 0,
                       **kw) -> np.ndarray:
        return self._embed_texts(list(texts), "q")

    def encode_corpus(self, docs, batch_size: int = 0, **kw) -> np.ndarray:
        return self._embed_texts([_doc_text(d) for d in docs], "d")


class DualEncoderTokenAdapter:
    """Token-level view of a trained :class:`DualEncoder` for the
    late-interaction reranker (``rerank.MaxSimReranker``): normalized
    per-token rows of the shared embedding table, a *trained* token space
    for MaxSim (reference analogue: ColBERT reranking over a trained
    checkpoint, ``beir/beir/reranking/models``)."""

    def __init__(self, dual: DualEncoder, max_tokens: int = 48):
        self.dual = dual
        self.max_tokens = max_tokens

    @torch.no_grad()
    def encode_tokens(self, texts: Sequence[str]):
        ids, mask = _batch_ids(list(texts), self.dual.vocab,
                               self.max_tokens)
        e = self.dual.embed[_on(ids, self.dual.device, torch.long)]
        e = e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-9)
        return e.cpu().numpy(), mask


class SparseEncoder(nn.Module):
    """SPLADE-style trainable learned-sparse encoder.

    Reference anchor: ``beir/beir/retrieval/models/splade.py`` /
    ``unicoil.py``.  Activation ``max_pool_t(log1p(relu(E[tok] @ head)))``
    over vocab buckets; trained with the same in-batch InfoNCE as the
    dense tower plus the SPLADE FLOPS regularizer
    ``λ·Σ_j (mean_i a_ij)²`` that drives bucket sparsity.  The max-pool is
    ``amax``, whose gradient splits among ties as ``jnp.max``'s does."""

    def __init__(self, vocab: int = 8192, n_buckets: int = 1024,
                 latent: int = 64, max_len: int = 32,
                 max_expansion: int = 64, seed: int = 3, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.vocab = vocab
        self.n_buckets = n_buckets
        self.max_len = max_len
        self.max_expansion = max_expansion
        ke, kh = jr.split(seed)
        self.embed = nn.Parameter(jr.normal(
            ke, (vocab, latent), scale=latent ** -0.5, device=self.device))
        self.head = nn.Parameter(jr.normal(
            kh, (latent, n_buckets), scale=latent ** -0.5,
            device=self.device))

    def _activate(self, ids: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
        e = self.embed[ids]                               # (b, L, latent)
        a = torch.log1p(torch.relu(e @ self.head))        # (b, L, buckets)
        return torch.amax(a * mask[..., None], dim=1)     # (b, buckets)

    def fit(self, pairs: Sequence[Tuple[str, str]], *, steps: int = 200,
            batch: int = 32, lr: float = 3e-3, flops_lambda: float = 1e-3,
            seed: int = 0, verbose: bool = False) -> List[float]:
        q_ids, q_mask = _batch_ids([p[0] for p in pairs], self.vocab,
                                   self.max_len)
        d_ids, d_mask = _batch_ids([p[1] for p in pairs], self.vocab,
                                   self.max_len)
        dev = self.device
        q_ids, q_mask = _on(q_ids, dev, torch.long), _on(q_mask, dev)
        d_ids, d_mask = _on(d_ids, dev, torch.long), _on(d_mask, dev)
        n = len(pairs)
        batch = min(batch, n)
        sels = _on(_draws(n, batch, steps, seed), dev, torch.long)

        def loss_fn(i):
            sel = sels[i]
            qa = self._activate(q_ids[sel], q_mask[sel])
            da = self._activate(d_ids[sel], d_mask[sel])
            nce = in_batch_nce(qa @ da.T)                 # sparse dot (b, b)
            flops = ((qa.mean(dim=0) ** 2).sum()
                     + (da.mean(dim=0) ** 2).sum())
            return nce + flops_lambda * flops

        return _train(self, loss_fn, steps, lr, "sparse-encoder", verbose)

    # --- SparseSearch duck-typed surface (weighted bucket dicts) ---

    @torch.no_grad()
    def activations(self, texts: Sequence[str], chunk: int = 1024
                    ) -> np.ndarray:
        """``(n, n_buckets)`` f32 activations, encoded in chunks."""
        ids, mask = _batch_ids(list(texts), self.vocab, self.max_len)
        out = []
        with fp32_matmul():
            for s in range(0, ids.shape[0], chunk):
                out.append(self._activate(
                    _on(ids[s:s + chunk], self.device, torch.long),
                    _on(mask[s:s + chunk], self.device)).cpu().numpy())
        return (np.concatenate(out) if out else
                np.zeros((0, self.n_buckets), np.float32))

    def _expand_row(self, act: np.ndarray) -> Dict[str, float]:
        top = np.argsort(-act)[: self.max_expansion]
        return {f"b{int(i)}": float(act[i]) for i in top if act[i] > 0}

    def encode_corpus(self, docs) -> List[Dict[str, float]]:
        act = self.activations([_doc_text(d) for d in docs])
        return [self._expand_row(a) for a in act]

    def encode_query(self, text: str) -> Dict[str, float]:
        return self._expand_row(self.activations([text])[0])
