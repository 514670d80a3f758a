"""Hermetic BEIR-shaped benchmark corpus with graded qrels.

The reference's quality harness runs on real BEIR datasets
(``beir/beir/retrieval/evaluation.py:9-67``); this environment has no
egress, so quality numbers need a *shipped* corpus whose relevance
structure actually differentiates retrieval methods (VERDICT r3 #7).
This generator produces an MS-MARCO-shaped dataset:

- **topics → entities → concepts**: each topic owns a pool of concepts;
  each entity (the unit of high relevance) draws a subset of its topic's
  concepts.  Documents are about one entity: title = entity concepts,
  body = entity/topic concepts mixed with Zipf-weighted general
  vocabulary.
- **synonym surface forms**: every concept has several surface strings;
  each occurrence samples one.  Queries therefore share *concepts* with
  relevant documents but only probabilistically share *tokens* — the
  vocabulary-mismatch regime where lexical matchers degrade and trained
  dense encoders (which learn form co-occurrence from training pairs)
  pull ahead, exactly the BEIR phenomenology.
- **graded qrels**: same entity → grade 2, same topic → grade 1, else 0
  (MS-MARCO/TREC-DL style), so NDCG's gain function is exercised, not
  just binary recall.
- **train/test splits**: disjoint query sets from the same process, so
  ``DualEncoder.fit`` has honest supervision.

Deterministic given (seed, sizes); writes the standard BEIR directory
layout via ``save_beir_dataset`` so ``GenericDataLoader`` and
``examples/evaluate_retrieval.py`` consume it unchanged.

The port's own copy of ``chamjax/ir/synth.py``, which imports no
framework: the same code, so results equal the JAX package's to the last bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Corpus = Dict[str, Dict[str, str]]
Queries = Dict[str, str]
Qrels = Dict[str, Dict[str, int]]


def _zipf_weights(n: int, a: float) -> np.ndarray:
    w = (np.arange(n) + 1.0) ** (-a)
    return w / w.sum()


def generate_beir_corpus(
    n_docs: int = 100_000,
    n_queries: int = 500,
    n_train_queries: int = 2000,
    n_topics: int = 500,
    entities_per_topic: int = 10,
    concepts_per_topic: int = 24,
    concepts_per_entity: int = 5,
    surface_forms: int = 2,
    word_pool: int = 1500,
    cross_rate: float = 0.12,
    general_vocab: int = 4000,
    doc_len: int = 48,
    query_len: int = 7,
    topical_frac: float = 0.55,
    seed: int = 0,
) -> Tuple[Corpus, Queries, Qrels, Queries, Qrels]:
    """Returns ``(corpus, queries, qrels, train_queries, train_qrels)``.

    Tokens are drawn from a shared ``word_pool`` (``p123``) plus a Zipf
    ``general_vocab`` (``w123``), so every tokenizer in ``ir/`` treats
    them as ordinary terms.

    **Vocabulary mismatch + polysemy** (the BEIR regime): every concept
    maps to ``surface_forms`` document-side words and ``surface_forms``
    query-side words, all sampled from the SAME shared pool — so (a)
    queries and documents about one concept only share a token with
    probability ``cross_rate`` (question-phrasing vs written-prose
    asymmetry), and (b) a token match does not imply a concept match
    (with ~``n_topics·concepts_per_topic·surface_forms/word_pool``
    concepts per word, exact matching is polysemous).  Together these are
    the two failure modes that cap lexical retrieval on MS-MARCO-like
    data; trained encoders learn the word↔concept geometry from training
    pairs and disambiguate through co-occurrence pooling."""
    rng = np.random.default_rng(seed)
    topic_mass = _zipf_weights(n_topics, 1.05)
    gen_mass = _zipf_weights(general_vocab, 1.1)

    # concept → surface word ids, document side and query side, drawn
    # from the shared ambiguous pool
    doc_words = rng.integers(
        0, word_pool, size=(n_topics, concepts_per_topic, surface_forms))
    query_words = rng.integers(
        0, word_pool, size=(n_topics, concepts_per_topic, surface_forms))

    # entity e of topic t uses a fixed subset of t's concepts
    ent_concepts = rng.integers(
        0, concepts_per_topic,
        size=(n_topics, entities_per_topic, concepts_per_entity))

    def concept_token(t: int, c: int, side: str = "doc") -> str:
        cross = rng.random() < cross_rate
        use_doc_side = (side == "doc") != cross
        table = doc_words if use_doc_side else query_words
        return f"p{table[t, c, rng.integers(0, surface_forms)]}"

    def general_token() -> str:
        return f"w{rng.choice(general_vocab, p=gen_mass)}"

    # --- documents --------------------------------------------------------
    doc_topic = rng.choice(n_topics, size=n_docs, p=topic_mass)
    doc_entity = rng.integers(0, entities_per_topic, size=n_docs)
    corpus: Corpus = {}
    # entity → doc-id list (for qrels)
    ent_docs: Dict[Tuple[int, int], list] = {}
    topic_docs: Dict[int, list] = {}
    for i in range(n_docs):
        t, e = int(doc_topic[i]), int(doc_entity[i])
        own = ent_concepts[t, e]
        title = " ".join(concept_token(t, int(c))
                         for c in rng.choice(own, size=2, replace=False))
        body = []
        for _ in range(doc_len):
            r = rng.random()
            if r < topical_frac * 0.6:
                body.append(concept_token(t, int(rng.choice(own))))
            elif r < topical_frac:
                body.append(concept_token(
                    t, int(rng.integers(0, concepts_per_topic))))
            else:
                body.append(general_token())
        did = f"d{i}"
        corpus[did] = {"title": title, "text": " ".join(body)}
        ent_docs.setdefault((t, e), []).append(did)
        topic_docs.setdefault(t, []).append(did)

    # --- queries + graded qrels ------------------------------------------
    def make_queries(n: int, prefix: str) -> Tuple[Queries, Qrels]:
        queries: Queries = {}
        qrels: Qrels = {}
        made = 0
        while made < n:
            t = int(rng.choice(n_topics, p=topic_mass))
            e = int(rng.integers(0, entities_per_topic))
            if not ent_docs.get((t, e)):
                continue          # entity with no documents: unanswerable
            own = ent_concepts[t, e]
            toks = [concept_token(t, int(rng.choice(own)), side="query")
                    for _ in range(max(query_len - 2, 3))]
            toks += [concept_token(t, int(rng.integers(
                0, concepts_per_topic)), side="query")]
            toks += [general_token()]
            qid = f"{prefix}{made}"
            queries[qid] = " ".join(toks)
            rel = {did: 2 for did in ent_docs[(t, e)]}
            # same-topic, different-entity docs are partially relevant;
            # cap the per-query qrel size (BEIR judges pools, not corpora)
            others = [did for did in topic_docs[t] if did not in rel]
            for did in others[:200]:
                rel[did] = 1
            qrels[qid] = rel
            made += 1
        return queries, qrels

    queries, qrels = make_queries(n_queries, "q")
    train_queries, train_qrels = make_queries(n_train_queries, "tq")
    return corpus, queries, qrels, train_queries, train_qrels


def write_beir_dataset(path: str, n_docs: int = 100_000, seed: int = 0,
                       **kw) -> str:
    """Generate + write the BEIR directory (corpus/queries/qrels with both
    ``test`` and ``train`` splits).  Returns ``path``.  Skips generation
    when the directory already holds a corpus of the requested size."""
    import json
    import os

    from chamjax_torch.ir.dataloader import save_beir_dataset

    marker = os.path.join(path, ".synth_meta.json")
    want = {"n_docs": n_docs, "seed": seed, **{k: str(v)
                                              for k, v in kw.items()}}
    if os.path.exists(marker):
        with open(marker) as f:
            if json.load(f) == want:
                return path
    corpus, queries, qrels, tq, tqr = generate_beir_corpus(
        n_docs=n_docs, seed=seed, **kw)
    save_beir_dataset(path, corpus, queries, qrels, split="test")
    # append the train split (save_beir_dataset writes corpus+queries too;
    # train queries go into the same queries.jsonl)
    with open(os.path.join(path, "queries.jsonl"), "a") as f:
        for qid, q in tq.items():
            f.write(json.dumps({"_id": qid, "text": q}) + "\n")
    with open(os.path.join(path, "qrels", "train.tsv"), "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for qid, rel in tqr.items():
            for did, s in rel.items():
                f.write(f"{qid}\t{did}\t{s}\n")
    with open(marker, "w") as f:
        json.dump(want, f)
    return path
