"""Device time a RALM decode step spends at the elementwise junctions of
its blocks: the ``block.norm`` runs (the residual add and the layernorm
after it, one ``add_ln`` launch each) and ``block.act`` runs (the FFN's
bias and GELU, one ``bias_gelu`` launch a layer) of each whole traced
replay of the decode step's graph (``spans.py``), a step.  A program whose
step opens no such span gives nothing to read."""

from portbench import spans

STEP = "_decoder_step"
SPANS = ("block.norm", "block.act")


def read(ctx):
    if ctx.kind != "ralm" or ctx.trace is None:
        return None
    reps = spans.whole(ctx.trace, STEP)
    if not reps or not any(span in SPANS for runs in reps
                           for span, _ in runs):
        return None
    return spans.stage_ms(ctx.trace, STEP, SPANS)
