"""A search batch's share of the card's peak: the least time of the work
of the window's untraced batches (``work.py``: the coarse and LUT GEMMs
and the ADC sums of each batch's probes, the probed lists' codes, the
tables, queries and results) over the wall time they took."""

from portbench import work


def read(ctx):
    c = ctx.counts
    if ctx.kind != "search" or not c.get("batches_out") or c["wall_out_s"] <= 0:
        return None
    ix = {**ctx.cfg["index"], **ctx.cfg["search"]}
    total = 0.0
    for j, times in c["batches_out"].items():
        r = c["batch_rows"][j]
        ops, nbytes = work.search_batch(ix, c["batch"], r["rows_probed"],
                                        r["union_rows"], ix["k"])
        total += times * work.least_s(ops, nbytes)
    return 100.0 * total / c["wall_out_s"]
