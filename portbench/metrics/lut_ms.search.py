"""Device time a search batch spends building its ADC tables and packing
them for the scan: the ``search.lut`` and ``search.pack`` runs of each
whole traced replay of ``ivfpq_search``'s graph (``spans.py``), a
batch."""

from portbench import spans


def read(ctx):
    if ctx.kind != "search":
        return None
    return spans.stage_ms(ctx.trace, "ivfpq_search",
                          ("search.lut", "search.pack"))
