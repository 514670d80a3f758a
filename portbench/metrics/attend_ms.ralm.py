"""Device time a RALM step spends in attention over all layers: the
``decode.attend`` (self-attention over the K/V cache and the step's own
token) and ``decode.cross`` (cross-attention) runs of each whole traced
replay of the decode step's graph (``spans.py``), a step."""

from portbench import spans


def read(ctx):
    if ctx.kind != "ralm":
        return None
    return spans.stage_ms(ctx.trace, "_decoder_step",
                          ("decode.attend", "decode.cross"))
