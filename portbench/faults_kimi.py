"""Readings of a ``kimi_linear`` cell's check on a program with a planted
fault: what the limits of ``correct`` must catch.

    python3 -m portbench.faults_kimi --workload kimi-linear-48b-a3b.ralm-doc16k \\
        --fault skip_restore --seeds 301,302 --seconds 8

- ``skip_restore``: the loop's rewind sets the count back to the prompt
  but keeps the KDA states and convolution tails of the answer before
  (the latents alone are right);
- ``bf16_state``: the KDA state rounded to bfloat16 after the prefill and
  after every step, as if it were held in bfloat16.

For each seed, in one process: the cell's set-up, a short window, the
numbers ``check.py`` compares and whether they pass the cell's limits;
one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench.run import _environment, runner

FAULTS = ("skip_restore", "bf16_state")


def plant(fault: str) -> None:
    """Break the loop's family functions as ``fault`` says (the family
    record reads them from ``serving/ralm.py`` when a loop is built)."""
    from chamjax_torch.models import kimi_linear as kl
    from chamjax_torch.serving import ralm as loop_mod
    if fault == "skip_restore":
        def rewind(cache, prompt_len=0):
            if prompt_len:
                cache.idx.fill_(prompt_len)
                return cache._replace(host_idx=prompt_len)
            return kl.reset_kimi_cache(cache)
        loop_mod.reset_kimi_cache = rewind
        return
    step, prefill = loop_mod.kimi_step, loop_mod.kimi_prefill

    def rounded(cache):
        cache.kda.copy_(cache.kda.bfloat16().float())
        cache.snap_kda.copy_(cache.snap_kda.bfloat16().float())

    def step_bf16(params, tokens, cache):
        out = step(params, tokens, cache)
        rounded(cache)
        return out

    def prefill_bf16(params, tokens, cache, **kw):
        out = prefill(params, tokens, cache, **kw)
        rounded(cache)
        return out
    loop_mod.kimi_step, loop_mod.kimi_prefill = step_bf16, prefill_bf16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=FAULTS, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from portbench import check
    from portbench.spec import Registry

    if not torch.cuda.is_available():
        print("faults_kimi: no CUDA device", file=sys.stderr)
        return 2
    reg = Registry()
    w = reg.workload(args.workload)
    cfg, traffic = reg.config(w["config"]), reg.traffic(w["traffic"])
    limits = reg.limits(args.workload)
    plant(args.fault)
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        run = runner(traffic["kind"])(cfg, traffic, seed,
                                      torch.device("cuda", 0), False)
        run.setup()
        run.window(args.seconds)
        got = run.collect()
        run.free()
        nums = run.judge(got)
        correct, checks = check.compare(nums, limits)
        print(json.dumps({"seed": seed, "side": "fault:" + args.fault,
                          "correct": correct, **nums,
                          "beyond": [k for k, c in checks.items()
                                     if not c["value"] <= c["limit"]]}),
              flush=True)
        del run, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
