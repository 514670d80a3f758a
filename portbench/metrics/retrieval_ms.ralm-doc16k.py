"""Device time a retrieval of the ``kimi_linear`` RALM loop (one every
step, 2304-dim queries): the kernels launched under the benchmark's range
around ``retrieve_device`` in the traced stretch, over the retrievals made
there."""

RETRIEVE = "portbench.retrieve"


def read(ctx):
    t, n = ctx.trace, ctx.counts.get("retrievals_in", 0)
    if ctx.kind != "ralm_doc_hybrid" or t is None or not n:
        return None
    us = t.device_us_under(RETRIEVE)
    return us / n / 1e3 if us > 0 else None
