"""Device time a search batch spends expanding its probed lists into the
scan's window table: the ``search.windows`` run of each whole traced
replay of ``ivfpq_search``'s graph (``spans.py``), a batch."""

from portbench import spans


def read(ctx):
    if ctx.kind != "search":
        return None
    return spans.stage_ms(ctx.trace, "ivfpq_search", ("search.windows",))
