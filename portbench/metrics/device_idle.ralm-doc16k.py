"""The share of the traced stretch of ``kimi_linear`` RALM steps (one graph
replay and one fused retrieval a step) in which no kernel, copy or set ran
on the card (``busy_s`` against ``window_s``).  It counts the host time
that tracing adds, so it reads above the untraced run's."""


def read(ctx):
    t = ctx.trace
    if ctx.kind != "ralm_doc_hybrid" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
