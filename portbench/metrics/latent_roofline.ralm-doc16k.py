"""The latent attention kernel's share of its roofline at 32 heads: the
least time of its launches in the traced steps (``work_kimi.latent_kernel``:
1152 bytes a held latent a row and layer, read once for all heads, q read,
the output written; bytes bound it) over their device time
(``latent_ms.ralm-doc16k``'s runs), both a step."""

from portbench import spans, work, work_kimi


def read(ctx):
    c = ctx.counts
    if ctx.kind != "ralm_doc_hybrid" or not c.get("held_in"):
        return None
    ms = spans.stage_ms(ctx.trace, "_kimi_step", ("decode.latent",))
    if not ms:
        return None
    m, b = ctx.cfg, c["batch"]
    prompt = ctx.traffic["prompt"]
    least = sum(times * work.least_s(*work_kimi.latent_kernel(
        m, b, prompt + held)) for held, times in c["held_in"].items())
    least *= (len(m["linear_attn_config"]["full_attn_layers"])
              / sum(c["held_in"].values()))
    return 100.0 * least / (ms * 1e-3)
