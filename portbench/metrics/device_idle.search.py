"""The share of the untraced part of the window in which no kernel, copy
or set ran on the card: the traced stretch's device time a batch
(``busy_s`` over its batches), times the untraced batches, against the
wall time they took.  The tracer's own host time, which the stretch's
idle share holds, is left out."""


def read(ctx):
    t, c = ctx.trace, ctx.counts
    if (ctx.kind != "search" or t is None or not c.get("units_in")
            or not c.get("units_out") or c["wall_out_s"] <= 0):
        return None
    busy = t.busy_s() / c["units_in"] * c["units_out"]
    return 100.0 * (1.0 - busy / c["wall_out_s"])
