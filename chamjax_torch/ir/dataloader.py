"""BEIR-format dataset loading.

Parity with the reference's ``GenericDataLoader``
(``beir/beir/datasets/data_loader.py``): a dataset directory holds
``corpus.jsonl`` ({_id, title, text}), ``queries.jsonl`` ({_id, text}), and
``qrels/{split}.tsv`` (query-id \\t corpus-id \\t score, with header).
Returns ``(corpus, queries, qrels)`` with the same dict shapes BEIR uses.

The port's own copy of ``chamjax/ir/dataloader.py``, which imports no
framework: the same code, so results equal the JAX package's to the last bit.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Tuple

Corpus = Dict[str, Dict[str, str]]
Queries = Dict[str, str]
Qrels = Dict[str, Dict[str, int]]


class GenericDataLoader:
    def __init__(self, data_folder: str, corpus_file: str = "corpus.jsonl",
                 query_file: str = "queries.jsonl",
                 qrels_folder: str = "qrels"):
        self.corpus_file = os.path.join(data_folder, corpus_file)
        self.query_file = os.path.join(data_folder, query_file)
        self.qrels_folder = os.path.join(data_folder, qrels_folder)

    def load(self, split: str = "test") -> Tuple[Corpus, Queries, Qrels]:
        corpus = self.load_corpus()
        queries = self._load_queries()
        qrels = self._load_qrels(split)
        # BEIR keeps only queries that have qrels
        queries = {qid: q for qid, q in queries.items() if qid in qrels}
        return corpus, queries, qrels

    def load_corpus(self) -> Corpus:
        corpus: Corpus = {}
        with open(self.corpus_file) as f:
            for line in f:
                row = json.loads(line)
                corpus[str(row["_id"])] = {
                    "title": row.get("title", ""),
                    "text": row.get("text", ""),
                }
        return corpus

    def _load_queries(self) -> Queries:
        queries: Queries = {}
        with open(self.query_file) as f:
            for line in f:
                row = json.loads(line)
                queries[str(row["_id"])] = row.get("text", "")
        return queries

    def _load_qrels(self, split: str) -> Qrels:
        qrels: Qrels = {}
        path = os.path.join(self.qrels_folder, f"{split}.tsv")
        with open(path) as f:
            reader = csv.reader(f, delimiter="\t")
            header = next(reader, None)
            # tolerate files without a header row
            if header and header[-1].isdigit():
                rows = [header]
            else:
                rows = []
            rows.extend(reader)
        for qid, did, score in (r[:3] for r in rows if len(r) >= 3):
            qrels.setdefault(str(qid), {})[str(did)] = int(score)
        return qrels


def save_beir_dataset(path: str, corpus: Corpus, queries: Queries,
                      qrels: Qrels, split: str = "test") -> None:
    """Writer for the same layout (used by tests and the RAG demo)."""
    os.makedirs(os.path.join(path, "qrels"), exist_ok=True)
    with open(os.path.join(path, "corpus.jsonl"), "w") as f:
        for did, doc in corpus.items():
            f.write(json.dumps({"_id": did, **doc}) + "\n")
    with open(os.path.join(path, "queries.jsonl"), "w") as f:
        for qid, text in queries.items():
            f.write(json.dumps({"_id": qid, "text": text}) + "\n")
    with open(os.path.join(path, "qrels", f"{split}.tsv"), "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for qid, docs in qrels.items():
            for did, score in docs.items():
                f.write(f"{qid}\t{did}\t{score}\n")
