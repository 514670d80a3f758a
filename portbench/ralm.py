"""The ``ralm`` traffic: closed-loop offline batches through the program's
RALM loop (``RalmDecoder`` / ``RalmEncoderDecoder.single_step`` over the
fused ``LocalRetriever.retrieve_device``).

A generation is ``steps`` greedy decode steps of ``batch`` rows from a
seeded first token a row, written into the loop's token buffer after its
reset; then the next.  A CUDA event after every step gives the gaps
between tokens; the served tokens are copied into a ring of two
generations, and a retriever wrapper keeps the queries and answers the
check needs, so that the last generation finished in the window is judged
whole once it has closed (a window closes only once one is whole).
"""

from __future__ import annotations

import statistics
import time
from collections import Counter
from typing import Dict, List

import torch

from portbench import check, inputs, program, trace
from portbench.reference import model as ref
from portbench.reference import search as ref_search

GENERATIONS = 64         # seeded first tokens drawn; generations wrap past it
DISTINCT_STEPS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 511)
RETRIEVE = "portbench.retrieve"


class Recorder:
    """Wraps the retriever the loop calls: keeps the answers (and queries)
    of the steps the check reads, by generation, and, while tracing, puts
    each call in a ``record_function`` range."""

    def __init__(self, inner, interval: int, keep_steps):
        self.inner = inner
        self.interval = interval
        self.keep = set(keep_steps)
        self.tracing = False
        self.gens: Dict[int, Dict[int, tuple]] = {}
        self.gen = -1
        self.calls = 0
        self.total = 0

    def new_generation(self, g: int) -> None:
        self.gen = g
        self.calls = 0
        self.gens[g] = {}
        self.gens.pop(g - 2, None)

    def retrieve_device(self, q, nprobe, k):
        step = self.calls * self.interval
        self.calls += 1
        self.total += 1
        if self.tracing:
            with torch.profiler.record_function(RETRIEVE):
                res = self.inner.retrieve_device(q, nprobe, k)
        else:
            res = self.inner.retrieve_device(q, nprobe, k)
        if step in self.keep:
            self.gens[self.gen][step] = (q, res.ids, res.dists)
        return res


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Run:
    """One run of a ``ralm`` cell: ``setup()``, ``window()``, then what
    the result needs (``end_to_end``, ``collect``, ``counts``), ``free()``
    and ``judge()``."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 tracing: bool):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev, self.tracing = device, tracing
        self.m = cfg["model"]
        self.batch, self.steps = traffic["batch"], traffic["steps"]
        self.interval = self.m["retrieval_interval"]
        self.enc_dec = self.m["model_type"] == "encoder-decoder"

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        cfg, dev = self.cfg, self.dev
        self.retriever, self.tables, _ = program.build(cfg, self.seed, dev)
        weights = inputs.make_weights(self.m, self.seed, dev,
                                      program.model_dtype(cfg))
        retrievals = self.steps // self.interval
        if self.enc_dec:
            keep = [j * self.interval for j in range(retrievals)]
        else:
            keep = [j * self.interval for j in inputs.sample(
                self.seed, "check_steps", retrievals,
                self.traffic["check_steps"])]
            if self.tracing:
                keep += [s for s in DISTINCT_STEPS if s < self.steps]
        self.check_steps = sorted(set(keep))
        self.rec = Recorder(self.retriever, self.interval, keep)
        self.loop = program.loop(cfg, weights, self.rec, self.batch, dev)
        del weights     # drawn again for the check: the window holds the
        #                 program's copy alone
        self.first = inputs.first_tokens(self.seed, GENERATIONS, self.batch,
                                         self.m["vocab_size"], dev)
        self.served = torch.zeros((2, self.steps, self.batch),
                                  dtype=torch.int32, device=dev)
        # warm-up: a generation's start reaches every graph key (the first
        # step retrieves; on an encoder-decoder so does step `interval`)
        self._start(0)
        for _ in range(min(self.steps, 2 * self.interval)):
            self.loop.single_step()
        self.rec.gens.clear()
        self.events = [torch.cuda.Event(enable_timing=True)
                       for _ in range(4096)] if dev.type == "cuda" else []
        if self.tracing:
            trace.warm_profiler()
            self.stretch = trace.Stretch()
        _sync(dev)

    def _start(self, g: int) -> None:
        self.loop.reset_inference_state()
        self.loop.tokens.copy_(self.first[g % GENERATIONS])
        self.rec.new_generation(g)

    # -- window ---------------------------------------------------------
    def _event(self, i: int) -> None:
        if self.dev.type != "cuda":
            return
        if i >= len(self.events):
            self.events.append(torch.cuda.Event(enable_timing=True))
        self.events[i].record()

    def _advance(self) -> int:
        """One step of the traffic: a reset and a first token where a
        generation starts, the step, the served token kept."""
        if self.pos == self.steps:
            self.gen += 1
            self._start(self.gen)
            self.pos = 0
        held = self.pos
        self.loop.single_step()
        self.served[self.gen % 2, self.pos].copy_(self.loop.tokens)
        self.pos += 1
        self.n += 1
        self._event(self.n)
        if self.pos == self.steps:
            self.done = self.gen
        return held

    def window(self, seconds: float) -> None:
        dev = self.dev
        self.gen, self.pos, self.n, self.done = -1, self.steps, 0, -1
        self.held_out: Counter = Counter()   # positions of untraced steps
        self.held_in: Counter = Counter()
        self.t0 = time.perf_counter()
        self._event(0)
        traced_span = 0.0
        while True:
            self.held_out[self._advance()] += 1
            now = time.perf_counter()
            if (self.tracing and not self.held_in
                    and now - self.t0 >= seconds / 2):
                _sync(dev)
                ta = time.perf_counter()
                self.stretch.start()
                self.rec.tracing = True
                self.in_first = self.rec.total
                for _ in range(self.traffic["trace_steps"]):
                    self.held_in[self._advance()] += 1
                self.stretch.stop(lambda: _sync(dev))
                self.rec.tracing = False
                self.retrievals_in = self.rec.total - self.in_first
                traced_span = time.perf_counter() - ta
                now = time.perf_counter()
            if now - self.t0 >= seconds and self.done >= 0:
                break           # past the close, once a generation is whole
        _sync(dev)
        self.wall = time.perf_counter() - self.t0
        self.wall_out = self.wall - traced_span
        self.peak = (torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else 0)

    # -- after the window -----------------------------------------------
    def attempted(self) -> int:
        return self.n * self.batch

    def end_to_end(self) -> Dict[str, float]:
        tok_s = self.batch * self.n / self.wall
        out = {"tok_s": tok_s}
        if self.events:
            gaps = [self.events[i].elapsed_time(self.events[i + 1])
                    for i in range(self.n)]
            out["step_p95_ms"] = statistics.quantiles(gaps, n=20)[-1]
        return out

    def collect(self) -> Dict:
        """What the check and the readers need, taken before the
        program's state is freed."""
        g = self.done
        tokens = torch.cat([self.first[g % GENERATIONS][None],
                            self.served[g % 2]], 0).T.contiguous()
        return {"tokens": tokens, "answers": self.rec.gens[g]}

    def free(self) -> None:
        del self.loop, self.rec, self.retriever
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, got: Dict, control: bool = False) -> Dict[str, float]:
        """The numbers compared: ``logit_gap`` over every position of the
        finished generation's rows, ``query_err`` and the search's
        ``dist_err``/``miss`` at the kept retrieval steps, and the build's
        ``encode_gap``/``id_coverage``."""
        m, dev = self.m, self.dev
        heads = m["attention_heads"]
        tokens = got["tokens"]
        answers = got["answers"]
        ix = ref_search.Index.from_tables(
            self.tables, self.cfg["search"]["nprobe"],
            self.cfg["search"]["k"], self.cfg["search"]["seg_group"], dev)
        w = {part: {n: t.float() for n, t in ws.items()}
             for part, ws in inputs.make_weights(
                 m, self.seed, dev, program.model_dtype(self.cfg)).items()}
        w_run = ({part: ref.fp8_copy(ws) for part, ws in w.items()}
                 if control else w)
        nums = {"logit_gap": 0.0, "query_err": 0.0}
        refq: Dict[int, torch.Tensor] = {}
        runq: Dict[int, torch.Tensor] = {}
        with ref.no_tf32(), torch.no_grad():
            if self.enc_dec:
                self._decode_enc_dec(w, w_run, tokens, answers, nums, refq,
                                     runq, control)
            else:
                self._decode(w, w_run, tokens, nums, refq, runq, control)
            for step, (q, ids, dists) in sorted(answers.items()):
                if step not in self.check_steps:
                    continue
                query = runq[step] if control else q.float()
                err = ((query - refq[step]).norm(dim=1)
                       / refq[step].norm(dim=1)).max()
                nums["query_err"] = max(nums["query_err"], float(err))
                if control:
                    ids, dists = ref_search.control_answers(ix, query)
                j = ref_search.judge(ix, query, ids, dists)
                for key, v in j.items():
                    nums[key] = max(nums.get(key, 0.0), v)
            xb = program.corpus(self.cfg, self.seed, dev)
            nums.update(check.build_numbers(ix, self.tables, xb, self.seed,
                                            control))
            del xb
        return nums

    def _gap(self, logits, run_logits, targets, nums):
        """Largest amount by which the served token's (or, for the
        control, its own first token's) reference logit lies below the
        reference's best."""
        best = logits.max(-1).values
        if run_logits is not None:
            targets = run_logits.argmax(-1)
        got = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        nums["logit_gap"] = max(nums["logit_gap"], float((best - got).max()))

    def _decode(self, w, w_run, tokens, nums, refq, runq, control):
        heads = self.m["attention_heads"]
        steps = self.steps
        for r in range(0, self.batch, 16):
            rows = tokens[r:r + 16]
            logits, hidden = ref.decode(w["decoder"], rows[:, :steps], heads)
            run_logits = run_hidden = None
            if control:
                run_logits, run_hidden = ref.decode(
                    w_run["decoder"], rows[:, :steps], heads)
            self._gap(logits, run_logits, rows[:, 1:], nums)
            for step in self.check_steps:
                refq.setdefault(step, []).append(hidden[:, step])
                if control:
                    runq.setdefault(step, []).append(run_hidden[:, step])
            del logits, hidden, run_logits, run_hidden
        for d in (refq, runq):
            for step in list(d):
                d[step] = torch.cat(d[step], 0)

    def _decode_enc_dec(self, w, w_run, tokens, answers, nums, refq, runq,
                        control):
        m = self.m
        heads = m["attention_heads"]
        cache, run_cache = [], []
        for j in range(self.steps // self.interval):
            s = j * self.interval
            ids = answers[s][1]
            ret = ref.retrieved_tokens(ids, m["retrieval_token_len"],
                                       m["vocab_size"], m["max_seq_len"])
            cur = tokens[:, s:s + 1]
            refq[s] = ref.encode(w["encoder"], cur, heads)[:, -1]
            cross = ref.cross_kv(w["decoder"],
                                 ref.encode(w["encoder"], ret, heads))
            chunk = tokens[:, s:s + self.interval]
            logits, _ = ref.decode(w["decoder"], chunk, heads, cache=cache,
                                   cross=cross, start=s)
            del cross
            run_logits = None
            if control:
                runq[s] = ref.encode(w_run["encoder"], cur, heads)[:, -1]
                rc = ref.cross_kv(w_run["decoder"],
                                  ref.encode(w_run["encoder"], ret, heads))
                run_logits, _ = ref.decode(w_run["decoder"], chunk, heads,
                                           cache=run_cache, cross=rc,
                                           start=s)
                del rc
            self._gap(logits, run_logits,
                      tokens[:, s + 1:s + 1 + self.interval], nums)

    def counts(self, got: Dict) -> Dict:
        """The window's work counts for the readers."""
        ix = ref_search.Index.from_tables(
            self.tables, self.cfg["search"]["nprobe"],
            self.cfg["search"]["k"], self.cfg["search"]["seg_group"],
            self.dev)
        per = [ref_search.probed_rows(ix, ref_search.probe_sets(ix, q))
               for q, _, _ in got["answers"].values()]
        return {
            "batch": self.batch, "steps": self.steps,
            "interval": self.interval,
            "held_out": dict(self.held_out), "held_in": dict(self.held_in),
            "wall_out_s": self.wall_out,
            "units_in": sum(self.held_in.values()),
            "units_out": sum(self.held_out.values()),
            "retrievals_in": getattr(self, "retrievals_in", 0),
            "rows_probed": sum(p["rows_probed"] for p in per) / len(per),
            "union_rows": sum(p["union_rows"] for p in per) / len(per),
        }

    def distinct(self, got: Dict) -> Dict[str, List[int]]:
        """Distinct queries and distinct probe sets in a retrieval batch,
        step by step, over the finished generation."""
        ix = ref_search.Index.from_tables(
            self.tables, self.cfg["search"]["nprobe"],
            self.cfg["search"]["k"], self.cfg["search"]["seg_group"],
            self.dev)
        out = {"step": [], "queries": [], "probe_sets": [], "tokens": []}
        for step, (q, _, _) in sorted(got["answers"].items()):
            out["step"].append(step)
            out["queries"].append(int(torch.unique(q, dim=0).shape[0]))
            out["probe_sets"].append(int(torch.unique(
                ref_search.probe_sets(ix, q), dim=0).shape[0]))
            out["tokens"].append(int(torch.unique(
                got["tokens"][:, step]).shape[0]))
        return out
