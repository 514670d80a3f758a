"""A tiny registry for the CPU tests: the benchmark's own traffic mixes
and metric readers beside small configurations of both model families,
written into a temporary directory."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.spec import HERE, Registry

MODEL = {"model_type": "decoder", "embed_dim": 32, "ffn_embed_dim": 64,
         "layers": 2, "attention_heads": 4, "vocab_size": 97,
         "max_seq_len": 16, "dtype": "float32", "retrieval_interval": 1,
         "k": 4}
INDEX = {"nb": 4096, "nt": 2048, "dim": 32, "n_clusters": 64, "nlist": 32,
         "m": 4, "nbits": 8, "opq": False, "list_pad": 128,
         "balanced": True, "balance_factor": 1.3, "kmeans_iters": 4,
         "pq_iters": 4}
SEARCH = {"nprobe": 4, "k": 4, "lut_bf16": True, "seg_group": 8}
LIMITS_RALM = {"logit_gap": 1e-3, "query_err": 1e-3, "dist_err": 1e-3,
               "miss": 1e-3, "encode_gap": 1e-4, "id_coverage": 0}
LIMITS_SEARCH = {"dist_err": 1e-3, "miss": 1e-3, "kth_excess": 4.0,
                 "encode_gap": 1e-4, "id_coverage": 0}


def registry(tmp: Path) -> Registry:
    for folder in ("metrics", "traffic"):
        shutil.copytree(HERE / folder, tmp / folder)
    for folder in ("configs", "limits"):
        (tmp / folder).mkdir()
    enc = dict(MODEL, model_type="encoder-decoder", encoder_layers=1,
               retrieval_interval=4, retrieval_token_len=8)
    for name, m in (("tiny-dec", MODEL), ("tiny-encdec", enc)):
        (tmp / "configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "model": m, "index": INDEX, "search": SEARCH}))
    traffic = {"kind": "ralm", "batch": 4, "steps": 16, "check_steps": 4,
               "trace_steps": 4}
    (tmp / "traffic" / "tiny-ralm.json").write_text(json.dumps(traffic))
    (tmp / "traffic" / "tiny-search.json").write_text(json.dumps(
        {"kind": "search", "batch": 8, "pool": 512, "check_batches": 4,
         "trace_batches": 2}))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = [
        {"name": "tiny-dec.ralm", "config": "tiny-dec",
         "traffic": "tiny-ralm", "chips": 1},
        {"name": "tiny-encdec.ralm", "config": "tiny-encdec",
         "traffic": "tiny-ralm", "chips": 1},
        {"name": "tiny-dec.search", "config": "tiny-dec",
         "traffic": "tiny-search", "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "search" if "search" in m["workloads"][0] else "ralm"
            m["workloads"] = [w["name"] for w in bench["workloads"]
                              if w["name"].endswith(kind)]
    for w in bench["workloads"]:
        lim = LIMITS_SEARCH if w["name"].endswith("search") else LIMITS_RALM
        (tmp / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Registry(tmp / "BENCHMARK.json", tmp)
