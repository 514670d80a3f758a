"""The RALM step's share of the card's peak: the least time of the work
of the untraced steps of the window (``work.py``: every layer and the
head at the positions each step held, cross-attention, the encoder and
cross K/V refill a retrieval step, the retrieval's search) over the wall
time they took."""

from portbench import work


def read(ctx):
    c = ctx.counts
    if ctx.kind != "ralm" or not c.get("held_out") or c["wall_out_s"] <= 0:
        return None
    m = ctx.cfg["model"]
    ix = {**ctx.cfg["index"], **ctx.cfg["search"]}
    b, interval = c["batch"], c["interval"]
    enc_dec = m["model_type"] == "encoder-decoder"
    cross = (min(ix["k"] * m.get("retrieval_token_len", 0),
                 m["max_seq_len"]) if enc_dec else 0)
    total = 0.0
    for held, times in c["held_out"].items():
        ops, nbytes = work.decoder_step(m, b, held, cross)
        if held % interval == 0:
            s_ops, s_bytes = work.search_batch(ix, b, c["rows_probed"],
                                               c["union_rows"], ix["k"])
            ops, nbytes = ops + s_ops, nbytes + s_bytes
            if enc_dec:
                r_ops, r_bytes = work.cross_refill(m, b, cross)
                ops, nbytes = ops + r_ops, nbytes + r_bytes
        total += times * work.least_s(ops, nbytes)
    return 100.0 * total / c["wall_out_s"]
