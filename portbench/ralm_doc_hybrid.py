"""The ``ralm_doc_hybrid`` traffic: the ``ralm_doc`` traffic (long-document
RAG through ``RalmDecoder.single_step`` over the fused
``LocalRetriever.retrieve_device``) for a ``kimi_linear`` configuration,
whose KDA layers carry a recurrent state.

Each row's document prompt is drawn from the seed and prefilled once in
set-up; the prefill takes a snapshot of the KDA states and convolution
tails at the prompt's end, and the loop's reset before every answer
restores it (``reset_kimi_cache``), so every answer asks its question of
the same document.  The window, the served-token ring, the routes kept at
an answer's end and the retriever wrapper are ``ralm_doc``'s.

The check teacher-forces prompt and answer through the plain reference
(``reference/kimi_linear.py``: the recurrence position by position from
the document's start, latent attention decompressed, the held experts in
a loop) for ``check_rows`` rows drawn from the seed, every answer position
of the last answer finished in the window (which follows at least one
rewind), following the program's recorded experts at routing near-ties
over all the router's choices; and it holds the KDA states the program
kept at that answer's end against the reference's (``state_err``).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict

import torch

from portbench import (check, inputs, kimi_inputs, kimi_program, mla_inputs,
                       program, ralm, ralm_doc)
from portbench.reference import kimi_linear as ref_kimi
from portbench.reference import mla_moe as ref_mla
from portbench.reference import model as ref
from portbench.reference import search as ref_search


class Run(ralm_doc.Run):
    """One run of a ``ralm_doc_hybrid`` cell."""

    def setup(self) -> None:
        cfg, dev = self.cfg, self.dev
        self._t = time.perf_counter()
        self.retriever, self.tables, _ = program.build(cfg, self.seed, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self._phase("index")
        params = kimi_program.params(cfg, self.seed, dev)
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
        self.loop = kimi_program.loop(cfg, params, self.rec, self.batch)
        del params
        self._phase("cache")
        self.prompts = mla_inputs.prompts(self.seed, self.batch, self.prompt,
                                          cfg["vocab_size"], dev)
        self.loop.prefill(self.prompts)
        self._phase("prefill")
        routes, kda = self.loop.cache.routes, self.loop.cache.kda
        self.answer_states = torch.zeros(
            (2, kda.shape[0], len(self.rows)) + kda.shape[2:],
            dtype=kda.dtype, device=dev)
        self.prompt_routes = routes[:, self.rows, :self.prompt].clone()
        self.answer_routes = torch.zeros(
            (2, routes.shape[0], len(self.rows), self.steps, routes.shape[3]),
            dtype=routes.dtype, device=dev)
        self.first = inputs.first_tokens(self.seed, ralm.GENERATIONS,
                                         self.batch, cfg["vocab_size"], dev)
        self.served = torch.zeros((2, self.steps, self.batch),
                                  dtype=torch.int32, device=dev)
        self.events = [torch.cuda.Event(enable_timing=True)
                       for _ in range(4096)] if dev.type == "cuda" else []
        # warm-up: the window's own steps over a whole answer, its end (the
        # routes and states kept), a rewind and the next answer's start, so
        # that the window meets no graph, search, copy or allocation first
        self.gen, self.pos, self.n = -1, self.steps, 0
        for _ in range(self.steps + 2 * self.interval):
            self._advance()
        self.rec.gens.clear()
        if self.tracing:
            ralm.trace.warm_profiler()
            self.stretch = ralm.trace.Stretch()
        self._phase("warm-up")

    def _advance(self) -> int:
        """The ``ralm_doc`` step; at an answer's end its checked rows' KDA
        states are kept too (one gather every ``steps`` steps)."""
        held = super()._advance()
        if self.pos == self.steps:
            self.answer_states[self.gen % 2].copy_(
                self.loop.cache.kda[:, self.rows])
        return held

    def collect(self) -> Dict:
        got = super().collect()
        got["states"] = self.answer_states[self.done % 2]
        return got

    def judge(self, got: Dict, control: bool = False) -> Dict[str, float]:
        """``ralm_doc``'s numbers (``logit_gap``, ``query_err``,
        ``route_gap``, ``dist_err``, ``miss``, ``encode_gap``,
        ``id_coverage``) against the Kimi-Linear reference, and
        ``state_err``: the largest over KDA layers, checked rows and heads
        of the Frobenius distance of the state (128 x 128) kept at the
        answer's end from the reference's, over the reference's.  The control is the reference
        in float8 weights, its own routes followed (its states for the
        program's)."""
        m, dev, seed = self.cfg, self.dev, self.seed
        t0 = time.perf_counter()
        dtype = kimi_program.model_dtype(m)
        rows = self.rows
        tokens = torch.cat([got["prompts"],
                            got["tokens"][rows, :self.steps]], 1)
        served = got["tokens"][rows, 1:]
        answers = got["answers"]

        def layer_w(layer):
            return {n: t.float() for n, t in kimi_inputs.layer_weights(
                m, seed, layer, dev, dtype).items()}

        outer = {n: t.float() for n, t in kimi_inputs.outer_weights(
            m, seed, dev, dtype).items()}
        nums = {"logit_gap": 0.0, "query_err": 0.0}
        with ref.no_tf32(), torch.no_grad():
            run = None
            follow = got["routes"]
            if control:
                run_outer = ref.fp8_copy(outer)
                run = ref_kimi.forward(
                    m, tokens, lambda l: ref.fp8_copy(layer_w(l)), run_outer,
                    self.prompt)
                follow = run.routes
            want = ref_kimi.forward(m, tokens, layer_w, outer, self.prompt,
                                    follow=follow)
            nums["route_gap"] = want.stats.route_gap
            have = run.states if control else got["states"]
            nums["state_err"] = float(
                ((have - want.states).flatten(-2).norm(dim=-1)
                 / want.states.flatten(-2).norm(dim=-1)).max())
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
                # a query at a time: at 2304 dims a query's probed rows
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
