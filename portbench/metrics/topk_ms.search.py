"""Device time a search batch spends in its final selection (top-k over
the scanned candidates and the row-to-id map): the ``search.topk`` run
of each whole traced replay of ``ivfpq_search``'s graph (``spans.py``),
a batch."""

from portbench import spans


def read(ctx):
    if ctx.kind != "search":
        return None
    return spans.stage_ms(ctx.trace, "ivfpq_search", ("search.topk",))
