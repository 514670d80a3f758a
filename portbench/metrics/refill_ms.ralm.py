"""Device time of an encoder-decoder retrieval step's cross K/V refill:
the activities launched under the program's ``ralm.refill`` spans
(``CrossKV``: token synthesis, the encoder over the retrieved tokens and
every layer's cross K/V) in the traced stretch, over the refills there.
A decoder-only loop has none."""

REFILL = "ralm.refill"


def read(ctx):
    t = ctx.trace
    if ctx.kind != "ralm" or t is None or not t.device:
        return None
    n = len(t.ranges.get(REFILL, []))
    us = t.device_us_under(REFILL) if n else 0.0
    return us / n / 1e3 if us > 0 else None
