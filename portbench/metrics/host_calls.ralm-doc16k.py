"""Host calls that put work on the card a ``kimi_linear`` RALM step (graph
launches, kernel launches, copies and sets), counted in the traced
stretch."""


def read(ctx):
    t, steps = ctx.trace, ctx.counts.get("units_in", 0)
    if ctx.kind != "ralm_doc_hybrid" or t is None or not steps:
        return None
    return t.launches() / steps
