"""Device time a decode step of the ``kimi_linear`` family spends in the
latent attention of its MLA layers: the ``decode.latent`` runs (one
``latent_attend`` launch a layer, 32 heads) of each whole traced replay
of the step's graph (``spans.py``), a step."""

from portbench import spans


def read(ctx):
    if ctx.kind != "ralm_doc_hybrid":
        return None
    return spans.stage_ms(ctx.trace, "_kimi_step", ("decode.latent",))
