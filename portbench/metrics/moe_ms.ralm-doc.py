"""Device time a decode step of the ``deepseek_v3`` family spends in its
routed layers: the ``moe.route`` (router, top-k, sort by expert, offsets),
``moe.experts`` (the gather, the two grouped products, the weighted sum)
and ``moe.shared`` runs of each whole traced replay of the step's graph
(``spans.py``), a step."""

from portbench import spans


def read(ctx):
    if ctx.kind != "ralm_doc":
        return None
    return spans.stage_ms(ctx.trace, "_mla_moe_step",
                          ("moe.route", "moe.experts", "moe.shared"))
