"""The KDA decode kernel's share of its roofline: the least time of its
launches in a step (``work_kimi.kda_kernel``: each state read and written
once in float32, q, k, v, alpha and beta read, o written; bytes bound it)
over the device time of the ``decode.kda`` runs of the traced steps, both
a step."""

from portbench import spans, work, work_kimi


def read(ctx):
    c = ctx.counts
    if ctx.kind != "ralm_doc_hybrid" or not c.get("held_in"):
        return None
    ms = spans.stage_ms(ctx.trace, "_kimi_step", ("decode.kda",))
    if not ms:
        return None
    m = ctx.cfg
    layers = len(m["linear_attn_config"]["kda_layers"])
    least = layers * work.least_s(*work_kimi.kda_kernel(m, c["batch"]))
    return 100.0 * least / (ms * 1e-3)
