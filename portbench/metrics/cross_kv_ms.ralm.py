"""Device time an encoder-decoder retrieval step's refill spends writing
the decoder's cross K/V: the ``cross_kv.write`` runs (one GEMM a layer for
K and one for V, straight into the loop's buffers) of each whole traced
replay of the refill's graph (``_fill_cross_kv_from_ids``, ``spans.py``),
a refill.  A decoder-only loop has no refill; a program whose refill opens
no such span gives nothing to read."""

from portbench import spans

REFILL = "_fill_cross_kv_from_ids"
SPAN = "cross_kv.write"


def read(ctx):
    if ctx.kind != "ralm" or ctx.trace is None:
        return None
    reps = spans.whole(ctx.trace, REFILL)
    if not reps or not any(span == SPAN for runs in reps
                           for span, _ in runs):
        return None
    return spans.stage_ms(ctx.trace, REFILL, (SPAN,))
