"""The latent attention kernel's share of its roofline: the least time of
its launches in the traced steps (``work_mla.latent_kernel``: each held
latent read once a row and layer, q read, the output written; bytes bound
it) over their device time (``latent_ms.ralm-doc``'s runs), both a step."""

from portbench import spans, work, work_mla


def read(ctx):
    c = ctx.counts
    if ctx.kind != "ralm_doc" or not c.get("held_in"):
        return None
    ms = spans.stage_ms(ctx.trace, "_mla_moe_step", ("decode.latent",))
    if not ms:
        return None
    m, b = ctx.cfg, c["batch"]
    prompt = ctx.traffic["prompt"]
    least = sum(times * work.least_s(*work_mla.latent_kernel(m, b,
                                                             prompt + held))
                for held, times in c["held_in"].items())
    least *= m["num_hidden_layers"] / sum(c["held_in"].values())
    return 100.0 * least / (ms * 1e-3)
