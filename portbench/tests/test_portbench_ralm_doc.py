"""The ``ralm_doc`` traffic on a tiny ``deepseek_v3`` configuration on the
CPU: a run's result and its check, the reference against the program's
prefill and steps, the routing near-tie rule, and the planted faults that
the check has to catch."""

import argparse
import json
import shutil
import time

import pytest
import torch

from portbench import check, mla_inputs, mla_program, run, work_mla
from portbench.reference import mla_moe as ref_mla
from portbench.spec import HERE, Registry
from portbench.tests import tiny

CPU = torch.device("cpu")
MODEL = {"model_type": "deepseek_v3", "vocab_size": 97, "hidden_size": 32,
         "intermediate_size": 48, "moe_intermediate_size": 16,
         "num_hidden_layers": 2, "first_k_dense_replace": 1,
         "num_attention_heads": 4, "q_lora_rank": None, "kv_lora_rank": 16,
         "qk_nope_head_dim": 8, "qk_rope_head_dim": 8, "v_head_dim": 8,
         "n_routed_experts": 8, "n_shared_experts": 2,
         "num_experts_per_tok": 2, "n_group": 1, "topk_group": 1,
         "topk_method": "noaux_tc", "scoring_func": "sigmoid",
         "norm_topk_prob": True, "routed_scaling_factor": 2.446,
         "rms_norm_eps": 1e-5, "rope_theta": 50000,
         "max_position_embeddings": 64, "max_seq_len": 64,
         "dtype": "float32", "retrieval_interval": 1, "k": 4}
TRAFFIC = {"kind": "ralm_doc", "batch": 4, "prompt": 10, "steps": 6,
           "check_rows": 2, "check_steps": 3, "trace_steps": 2}
LIMITS = {"logit_gap": 1e-3, "query_err": 1e-3, "route_gap": 0.04,
          "dist_err": 1e-3, "miss": 1e-3, "encode_gap": 1e-4,
          "id_coverage": 0}
CELL = "tiny-mla.ralm-doc"


def _cfg():
    return dict(MODEL, index=dict(tiny.INDEX), search=dict(tiny.SEARCH))


def _registry(tmp) -> Registry:
    for folder in ("metrics", "traffic"):
        shutil.copytree(HERE / folder, tmp / folder)
    for folder in ("configs", "limits"):
        (tmp / folder).mkdir()
    (tmp / "configs" / "tiny-mla.json").write_text(json.dumps(_cfg()))
    (tmp / "traffic" / "tiny-doc.json").write_text(json.dumps(TRAFFIC))
    (tmp / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": CELL, "config": "tiny-mla",
                           "traffic": "tiny-doc", "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "moonlight-16b-a3b.ralm-doc" in m.get("workloads", [CELL]):
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
        assert "step_mfu.ralm-doc" in out["metrics"]
    else:
        assert {"tok_s", "setup_s"} <= set(out["metrics"])
    assert set(out["checks"]) == set(LIMITS)


def test_control_and_a_broken_router_fail(tmp_path, monkeypatch):
    """The control (float8 weights) and a program whose router takes the
    bottom experts read above the limits."""
    reg = _registry(tmp_path)
    cfg = reg.config("tiny-mla")
    r = run.runner("ralm_doc")(cfg, TRAFFIC, 9, CPU, False)
    r.setup()
    r.window(0.1)
    got = r.collect()
    r.free()
    assert check.compare(r.judge(got), LIMITS)[0]
    ctrl = r.judge(got, control=True)
    assert ctrl["query_err"] > LIMITS["query_err"]
    assert not check.compare(ctrl, LIMITS)[0]

    from chamjax_torch.models import mla_moe as mm
    real = mm.route

    def bottom(cfg_, h2, router, e_bias):
        top, w = real(cfg_, h2, router, -e_bias - 10 * torch.sigmoid(
            h2.float() @ router.float()))
        return top, w
    monkeypatch.setattr(mm, "route", bottom)
    r = run.runner("ralm_doc")(cfg, TRAFFIC, 9, CPU, False)
    r.setup()
    r.window(0.1)
    got = r.collect()
    r.free()
    nums = r.judge(got)
    assert nums["route_gap"] > LIMITS["route_gap"]


def test_reference_follows_near_ties_only():
    """A followed choice that is a top set to within the bound is taken
    and counted; one beyond it is not taken, and its shortfall read."""
    m = dict(MODEL, n_routed_experts=4, num_experts_per_tok=2)
    h2 = torch.zeros(2, 1)
    w = {"router": torch.zeros(1, 4),
         "e_bias": torch.tensor([0.30, 0.20, 0.19, 0.0])}
    # row 0 takes experts 0 and 2 (a near tie with 1); row 1 takes 2 and 3
    follow = torch.tensor([[0, 2], [2, 3]])
    stats = ref_mla.RouteStats()
    chosen, _ = ref_mla.route(m, h2, w, follow, 0.02, stats)
    assert chosen[0].sort().values.tolist() == [0, 2]
    assert chosen[1].sort().values.tolist() == [0, 1]
    assert stats.near_ties == 1
    assert stats.route_gap == pytest.approx(0.30, abs=1e-6)


def test_reference_matches_program_prefill_and_steps():
    """The layer-by-layer reference (weights drawn again a layer) against
    the program's prefill and absorbed steps, float32 on the CPU."""
    from chamjax_torch.models import mla_moe as mm
    cfg = _cfg()
    p = mla_program.params(cfg, 3, CPU)
    mc = mla_program.model_config(cfg)
    tokens = torch.randint(1, MODEL["vocab_size"], (3, 9),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    cache = mm.init_latent_cache(mc, 3, device=CPU)
    _, _, cache = mm.mla_moe_prefill(p, tokens[:, :6], cache)
    hidden = []
    for i in range(6, 9):
        _, h, cache = mm.mla_moe_step(p, tokens[:, i], cache)
        hidden.append(h)
    outer = mla_inputs.outer_weights(cfg, 3, CPU, torch.float32)
    want = ref_mla.forward(
        cfg, tokens, lambda l: mla_inputs.layer_weights(cfg, 3, l, CPU,
                                                        torch.float32),
        outer, 6, follow=cache.routes[:, :, :9])
    torch.testing.assert_close(torch.stack(hidden, 1), want.hidden,
                               rtol=1e-4, atol=1e-5)
    assert want.stats.near_ties == 0 and want.stats.route_gap == 0.0


def test_step_work_counts():
    """The byte bound of a Moonlight-16B-A3B step at b 64 and 7424 held
    positions: 31.2 GB of weights, 14.8 GB of latents."""
    m = json.loads((HERE / "configs" / "moonlight-16b-a3b.json").read_text())
    ops, nbytes = work_mla.decode_step(m, 64, 7424)
    assert 45.5e9 < nbytes < 46.5e9
    _, kbytes = work_mla.latent_kernel(m, 64, 7424)
    assert kbytes == pytest.approx(64 * 7425 * 1152 + 64 * 16 * 1088 * 2)
    assert work_mla.experts_touched(m, 64) == pytest.approx(63.88, abs=0.01)
