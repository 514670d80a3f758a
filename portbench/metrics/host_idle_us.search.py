"""Idle time of the card while the host is inside the program's own
search call: the median over the batches of the stretch of the
microseconds with no kernel, copy or set running inside the program's
``retrieve`` span (keying the graph, copying the queries in, the replay's
launch, cloning the results).  Only batches whose replay the profiler
recorded whole count (``spans.py``).  The client's time (the read-back)
is outside the span; the tracer's own host time inflates both."""

from portbench import spans


def read(ctx):
    if ctx.kind != "search":
        return None
    return spans.idle_inside(ctx.trace, "retrieve", "ivfpq_search")
