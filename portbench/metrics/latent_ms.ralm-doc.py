"""Device time a decode step of the ``deepseek_v3`` family spends in its
latent attention over all layers: the ``decode.latent`` runs (one
``latent_attend`` launch a layer) of each whole traced replay of the
step's graph (``spans.py``), a step."""

from portbench import spans


def read(ctx):
    if ctx.kind != "ralm_doc":
        return None
    return spans.stage_ms(ctx.trace, "_mla_moe_step", ("decode.latent",))
