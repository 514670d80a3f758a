"""The ``ralm_doc_hybrid`` traffic on a tiny ``kimi_linear`` configuration
on the CPU: a run's result and its check, the reference against the
program's prefill and steps, the planted faults the check has to catch
(a rewind that skips the restore, the KDA state held in bfloat16), and the
work counts at the published widths."""

import argparse
import json
import shutil
import time

import pytest
import torch

from portbench import (check, faults_kimi, kimi_inputs, kimi_program, run,
                       work_kimi)
from portbench.reference import kimi_linear as ref_kimi
from portbench.spec import HERE, Registry
from portbench.tests import tiny

CPU = torch.device("cpu")
MODEL = {"model_type": "kimi_linear", "vocab_size": 97, "hidden_size": 32,
         "intermediate_size": 48, "moe_intermediate_size": 16,
         "num_hidden_layers": 4, "first_k_dense_replace": 1,
         "moe_layer_freq": 1, "hidden_act": "silu",
         "num_attention_heads": 4, "num_key_value_heads": 4,
         "q_lora_rank": None, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
         "qk_rope_head_dim": 8, "v_head_dim": 8, "mla_use_nope": True,
         "linear_attn_config": {"full_attn_layers": [2], "kda_layers":
                                [1, 3, 4], "num_heads": 2, "head_dim": 8,
                                "short_conv_kernel_size": 4},
         "num_experts": 4, "router_experts": 8, "num_experts_per_token": 2,
         "num_shared_experts": 1, "moe_router_activation_func": "sigmoid",
         "moe_renormalize": True, "routed_scaling_factor": 2.446,
         "num_expert_group": 1, "topk_group": 1, "rms_norm_eps": 1e-5,
         "tie_word_embeddings": False, "max_seq_len": 64,
         "dtype": "float32", "retrieval_interval": 1, "k": 4}
TRAFFIC = {"kind": "ralm_doc_hybrid", "batch": 4, "prompt": 10, "steps": 6,
           "check_rows": 2, "check_steps": 3, "trace_steps": 2}
LIMITS = {"logit_gap": 1e-3, "query_err": 1e-3, "route_gap": 0.04,
          "dist_err": 1e-3, "miss": 1e-3, "encode_gap": 1e-4,
          "id_coverage": 0, "state_err": 1e-3}
CELL = "tiny-kimi.ralm-doc16k"
REAL = "kimi-linear-48b-a3b.ralm-doc16k"


def _cfg():
    return dict(MODEL, index=dict(tiny.INDEX), search=dict(tiny.SEARCH))


def _registry(tmp) -> Registry:
    for folder in ("metrics", "traffic"):
        shutil.copytree(HERE / folder, tmp / folder)
    for folder in ("configs", "limits"):
        (tmp / folder).mkdir()
    (tmp / "configs" / "tiny-kimi.json").write_text(json.dumps(_cfg()))
    (tmp / "traffic" / "tiny-doc16k.json").write_text(json.dumps(TRAFFIC))
    (tmp / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": CELL, "config": "tiny-kimi",
                           "traffic": "tiny-doc16k", "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", [CELL]):
            m["workloads"] = [CELL]
        elif "workloads" in m:
            m["workloads"] = []
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Registry(tmp / "BENCHMARK.json", tmp)


@pytest.mark.parametrize("traced", [0, 1])
def test_result_and_check(tmp_path, traced):
    reg = _registry(tmp_path)
    args = argparse.Namespace(workload=CELL, seed=2 ** 31 + 5, seconds=0.2,
                              trace=traced)
    out = run.execute(args, reg, CPU, time.time())
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0
    names = {m["name"] for m in (reg.per_layer(CELL) if traced
                                 else reg.end_to_end(CELL))}
    assert set(out["metrics"]) <= names
    if traced:
        assert "step_mfu.ralm-doc16k" in out["metrics"]
    else:
        assert {"tok_s", "setup_s"} <= set(out["metrics"])
    assert set(out["checks"]) == set(LIMITS)


def _judged(reg, seed=9):
    r = run.runner("ralm_doc_hybrid")(reg.config("tiny-kimi"), TRAFFIC, seed,
                                      CPU, False)
    r.setup()
    r.window(0.1)
    got = r.collect()
    r.free()
    return r, got


def test_control_fails(tmp_path):
    """The control (float8 weights) reads above the limits."""
    reg = _registry(tmp_path)
    r, got = _judged(reg)
    assert check.compare(r.judge(got), LIMITS)[0]
    ctrl = r.judge(got, control=True)
    assert ctrl["query_err"] > LIMITS["query_err"]
    assert not check.compare(ctrl, LIMITS)[0]


@pytest.mark.parametrize("fault", ["skip_restore", "bf16_state"])
def test_planted_faults_show(tmp_path, monkeypatch, fault):
    """A rewind that sets the count but keeps the answer's KDA states, and
    a state rounded to bfloat16 after the prefill and every step, each
    move ``query_err`` and ``state_err`` a hundredfold over the program's
    own readings (float32 at this size) and read above a limit."""
    from chamjax_torch.serving import ralm as loop_mod
    reg = _registry(tmp_path)
    r, got = _judged(reg)
    clean = r.judge(got)
    for name in ("reset_kimi_cache", "kimi_step", "kimi_prefill"):
        monkeypatch.setattr(loop_mod, name, getattr(loop_mod, name))
    faults_kimi.plant(fault)
    r, got = _judged(reg)
    nums = r.judge(got)
    for key in ("query_err", "state_err"):
        assert nums[key] > 100 * clean[key] + 1e-6, (key, nums, clean)
    assert not check.compare(nums, LIMITS)[0]


def test_reference_matches_program_prefill_and_steps():
    """The layer-by-layer reference (weights drawn again a layer, the
    recurrence position by position) against the program's prefill and
    steps, float32 on the CPU, through a rewind."""
    from chamjax_torch.models import kimi_linear as kl
    cfg = _cfg()
    p = kimi_program.params(cfg, 3, CPU)
    mc = kimi_program.model_config(cfg)
    assert mc.held == (0, 4) and mc.num_experts == 8
    tokens = torch.randint(1, MODEL["vocab_size"], (3, 9),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    cache = kl.init_kimi_cache(mc, 3, device=CPU)
    _, _, cache = kl.kimi_prefill(p, tokens[:, :6], cache)
    for i in range(6, 9):
        _, _, cache = kl.kimi_step(p, tokens[:, (i + 1) % 9], cache)
    cache = kl.reset_kimi_cache(cache, 6)
    hidden = []
    for i in range(6, 9):
        _, h, cache = kl.kimi_step(p, tokens[:, i], cache)
        hidden.append(h)
    outer = kimi_inputs.outer_weights(cfg, 3, CPU, torch.float32)
    want = ref_kimi.forward(
        cfg, tokens, lambda l: kimi_inputs.layer_weights(cfg, 3, l, CPU,
                                                         torch.float32),
        outer, 6, follow=cache.routes[:, :, :9])
    torch.testing.assert_close(torch.stack(hidden, 1), want.hidden,
                               rtol=1e-4, atol=1e-5)
    assert want.stats.near_ties == 0 and want.stats.route_gap == 0.0


def test_step_work_counts():
    """The byte bound of a Kimi-Linear-48B-A3B step at b 64 and 16,640
    held positions: 38.0 GB, 11.3 ms at 3.35 TB/s; the KDA kernel's 273 MB
    a layer; 55.6 of the 64 held experts touched."""
    m = json.loads((HERE / "configs" / "kimi-linear-48b-a3b.json")
                   .read_text())
    _, nbytes = work_kimi.decode_step(m, 64, 16640)
    assert 37.5e9 < nbytes < 38.5e9
    _, kbytes = work_kimi.kda_kernel(m, 64)
    assert kbytes == pytest.approx(64 * 32 * (2 * 65536 + 4 * 512 + 4
                                              + 256))
    assert work_kimi.experts_touched(m, 64) == pytest.approx(55.61, abs=0.01)
