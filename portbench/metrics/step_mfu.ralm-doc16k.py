"""The hybrid long-document RALM step's share of the card's peak: the
least time of the work of the untraced steps of the window
(``work_kimi.decode_step`` at the positions each step held, prompt and
answer so far: the held experts touched, the latents, the KDA states read
and written, the other weights; the search of every retrieval step,
``work.search_batch``) over the wall time they took."""

from portbench import work, work_kimi


def read(ctx):
    c = ctx.counts
    if (ctx.kind != "ralm_doc_hybrid" or not c.get("held_out")
            or c["wall_out_s"] <= 0):
        return None
    m = ctx.cfg
    ix = {**m["index"], **m["search"]}
    b, interval = c["batch"], c["interval"]
    prompt = ctx.traffic["prompt"]
    total = 0.0
    for held, times in c["held_out"].items():
        ops, nbytes = work_kimi.decode_step(m, b, prompt + held)
        if held % interval == 0:
            s_ops, s_bytes = work.search_batch(ix, b, c["rows_probed"],
                                               c["union_rows"], ix["k"])
            ops, nbytes = ops + s_ops, nbytes + s_bytes
        total += times * work.least_s(ops, nbytes)
    return 100.0 * total / c["wall_out_s"]
