"""Device time a decode step of the ``kimi_linear`` family spends in its
routed layers: the ``moe.route`` (router over all experts, top-k, sort by
held expert, offsets), ``moe.experts`` (the gather, the two grouped
products over the held experts, the weighted sum) and ``moe.shared`` runs
of each whole traced replay of the step's graph (``spans.py``), a
step."""

from portbench import spans


def read(ctx):
    if ctx.kind != "ralm_doc_hybrid":
        return None
    return spans.stage_ms(ctx.trace, "_kimi_step",
                          ("moe.route", "moe.experts", "moe.shared"))
