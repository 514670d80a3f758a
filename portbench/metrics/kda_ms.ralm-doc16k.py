"""Device time a decode step of the ``kimi_linear`` family spends in its
KDA layers' token mixing: the ``decode.kda`` runs (one kernel launch a
layer) and the ``kda.mix`` runs (projections, convolution, gates, gated
norm, W_o) of each whole traced replay of the step's graph (``spans.py``),
a step."""

from portbench import spans


def read(ctx):
    if ctx.kind != "ralm_doc_hybrid":
        return None
    return spans.stage_ms(ctx.trace, "_kimi_step", ("decode.kda", "kda.mix"))
