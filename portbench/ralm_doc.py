"""The ``ralm_doc`` traffic: long-document RAG through the program's RALM
loop (``RalmDecoder.single_step`` over the fused
``LocalRetriever.retrieve_device``) for a ``deepseek_v3`` configuration.

Each row holds a document prompt drawn from the seed, prefilled once in
set-up through the family's prefill.  Then a closed loop of answers: an
answer is a seeded first token a row and ``steps`` greedy steps with a
retrieval every ``retrieval_interval``; the loop's reset rewinds the cache
to the prompt's end between answers, so every answer asks its question of
the same document and every step attends over the prompt and the answer so
far.  The window, its CUDA events, the served-token ring and the retriever
wrapper are the ``ralm`` traffic's (``ralm.py``).

The check teacher-forces prompt and answer through the plain reference
(``reference/mla_moe.py``) for ``check_rows`` rows drawn from the seed,
every answer position of the last answer finished in the window, following
the experts the program recorded where they are a top set to within the
reference's bound (routing near-ties).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict

import torch

from portbench import check, inputs, mla_inputs, mla_program, program, ralm
from portbench.reference import mla_moe as ref_mla
from portbench.reference import model as ref
from portbench.reference import search as ref_search


class Run(ralm.Run):
    """One run of a ``ralm_doc`` cell."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 tracing: bool):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev, self.tracing = device, tracing
        self.m = cfg
        self.batch, self.steps = traffic["batch"], traffic["steps"]
        self.prompt = traffic["prompt"]
        self.interval = cfg["retrieval_interval"]
        self.enc_dec = False

    # -- set-up ---------------------------------------------------------
    def _phase(self, name: str) -> None:
        """The set-up's phases on standard error, each with its seconds."""
        ralm._sync(self.dev)
        now = time.perf_counter()
        print(f"portbench: setup {name} {now - self._t:.2f} s",
              file=sys.stderr, flush=True)
        self._t = now

    def setup(self) -> None:
        cfg, dev = self.cfg, self.dev
        self._t = time.perf_counter()
        self.retriever, self.tables, _ = program.build(cfg, self.seed, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self._phase("index")
        params = mla_program.params(cfg, self.seed, dev)
        self._phase("weights")
        retrievals = self.steps // self.interval
        keep = [j * self.interval for j in inputs.sample(
            self.seed, "check_steps", retrievals, self.traffic["check_steps"])]
        if self.tracing:
            keep += [s for s in ralm.DISTINCT_STEPS if s < self.steps]
        self.check_steps = sorted(set(keep))
        self.rows = torch.tensor(inputs.sample(
            self.seed, "check_rows", self.batch, self.traffic["check_rows"]),
            device=dev)
        self.rec = ralm.Recorder(self.retriever, self.interval, keep)
        self.loop = mla_program.loop(cfg, params, self.rec, self.batch)
        del params
        self.prompts = mla_inputs.prompts(self.seed, self.batch, self.prompt,
                                          cfg["vocab_size"], dev)
        self.loop.prefill(self.prompts)
        self._phase("prefill")
        routes = self.loop.cache.routes
        self.prompt_routes = routes[:, self.rows, :self.prompt].clone()
        self.answer_routes = torch.zeros(
            (2, routes.shape[0], len(self.rows), self.steps, routes.shape[3]),
            dtype=routes.dtype, device=dev)
        self.first = inputs.first_tokens(self.seed, ralm.GENERATIONS,
                                         self.batch, cfg["vocab_size"], dev)
        self.served = torch.zeros((2, self.steps, self.batch),
                                  dtype=torch.int32, device=dev)
        # warm-up: the step's graph and the search's (every step retrieves)
        self._start(0)
        for _ in range(min(self.steps, 2 * self.interval)):
            self.loop.single_step()
        self.rec.gens.clear()
        self.events = [torch.cuda.Event(enable_timing=True)
                       for _ in range(4096)] if dev.type == "cuda" else []
        if self.tracing:
            ralm.trace.warm_profiler()
            self.stretch = ralm.trace.Stretch()
        self._phase("warm-up")

    # -- window ---------------------------------------------------------
    def _advance(self) -> int:
        """The ``ralm`` step; at an answer's end its checked rows' routes
        are kept (one gather every ``steps`` steps)."""
        held = super()._advance()
        if self.pos == self.steps:
            self.answer_routes[self.gen % 2].copy_(
                self.loop.cache.routes[:, self.rows,
                                       self.prompt:self.prompt + self.steps])
        return held

    # -- after the window -----------------------------------------------
    def collect(self) -> Dict:
        got = super().collect()
        got["routes"] = torch.cat([self.prompt_routes,
                                   self.answer_routes[self.done % 2]], 2)
        got["prompts"] = self.prompts[self.rows]
        return got

    def judge(self, got: Dict, control: bool = False) -> Dict[str, float]:
        """The numbers compared: ``logit_gap`` over every answer position
        of the checked rows, ``query_err`` at the kept retrieval steps (of
        the checked rows), ``route_gap`` (the reference's routing against
        the program's record), the search's ``dist_err``/``miss`` over all
        rows' queries at the kept steps, and the build's
        ``encode_gap``/``id_coverage``.  The control is the reference in
        float8 weights, its own routes followed."""
        m, dev, seed = self.cfg, self.dev, self.seed
        t0 = time.perf_counter()
        dtype = mla_program.model_dtype(m)
        rows = self.rows
        tokens = torch.cat([got["prompts"],
                            got["tokens"][rows, :self.steps]], 1)
        served = got["tokens"][rows, 1:]
        answers = got["answers"]

        def layer_w(layer):
            return {n: t.float() for n, t in mla_inputs.layer_weights(
                m, seed, layer, dev, dtype).items()}

        outer = {n: t.float() for n, t in mla_inputs.outer_weights(
            m, seed, dev, dtype).items()}
        nums = {"logit_gap": 0.0, "query_err": 0.0}
        with ref.no_tf32(), torch.no_grad():
            run = None
            follow = got["routes"]
            if control:
                run_outer = ref.fp8_copy(outer)
                run = ref_mla.forward(
                    m, tokens, lambda l: ref.fp8_copy(layer_w(l)), run_outer,
                    self.prompt)
                follow = run.routes
            want = ref_mla.forward(m, tokens, layer_w, outer, self.prompt,
                                   follow=follow)
            nums["route_gap"] = want.stats.route_gap
            for i in range(len(rows)):
                logits = want.hidden[i] @ outer["head"]
                targets = (served[i] if run is None else
                           (run.hidden[i] @ run_outer["head"]).argmax(-1))
                best = logits.max(-1).values
                at = logits.gather(1, targets.long()[:, None])[:, 0]
                nums["logit_gap"] = max(nums["logit_gap"],
                                        float((best - at).max()))
            ix = ref_search.Index.from_tables(
                self.tables, m["search"]["nprobe"], m["search"]["k"],
                m["search"]["seg_group"], dev)
            for step, (q, ids, dists) in sorted(answers.items()):
                if step not in self.check_steps:
                    continue
                refq = want.hidden[:, step]
                query = (run.hidden[:, step] if control
                         else q.float()[rows])
                err = ((query - refq).norm(dim=1) / refq.norm(dim=1)).max()
                nums["query_err"] = max(nums["query_err"], float(err))
                # a query at a time: at 2048 dims a query's probed rows
                # take gigabytes in float64
                if control:
                    ids, dists = ref_search.control_answers(ix, query,
                                                            chunk=1)
                    query_all = query
                else:
                    query_all = q.float()
                j = ref_search.judge(ix, query_all, ids, dists, chunk=1)
                for key, v in j.items():
                    nums[key] = max(nums.get(key, 0.0), v)
            print(json.dumps({"routing": {
                "near_ties": want.stats.near_ties,
                "pairs": want.stats.pairs, "route_gap": want.stats.route_gap,
                "bound": ref_mla.TAU}}), flush=True)
            del want, run
            xb = program.corpus(m, seed, dev)
            nums.update(check.build_numbers(ix, self.tables, xb, seed,
                                            control))
            del xb
        print(f"portbench: check {time.perf_counter() - t0:.2f} s",
              file=sys.stderr, flush=True)
        return nums
