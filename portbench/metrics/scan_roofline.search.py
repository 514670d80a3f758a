"""The tiled ADC scan's share of its roofline: the least time of the
scans of the traced batches (``work.py``: one add a sub-quantizer a probed
row, the probed lists' codes once and each query's tables for its probes
at the configuration's LUT precision) over the device time of
``adc_scan_tiles`` (the staged body over tiles) in the traced stretch."""

from portbench import work


def _tiles_kernel(name: str) -> bool:
    """The staged scan body instantiated over tiles (``kFlat`` false)."""
    if "adc_scan_staged_kernel<" not in name:
        return False
    args = name.split("<", 1)[1].split(">", 1)[0].split(",")
    return len(args) >= 4 and args[3].strip() == "false"


def read(ctx):
    c, t = ctx.counts, ctx.trace
    if ctx.kind != "search" or t is None or not c.get("batches_in"):
        return None
    us, n = t.device_us_where(_tiles_kernel)
    if not n or us <= 0:
        return None
    ix = {**ctx.cfg["index"], **ctx.cfg["search"]}
    lut_bytes = 2 if ix["lut_bf16"] else 4
    total = 0.0
    for j, times in c["batches_in"].items():
        r = c["batch_rows"][j]
        ops, nbytes = work.scan(ix, c["batch"], r["rows_probed"],
                                r["union_rows"], lut_bytes)
        total += times * work.least_s(ops, nbytes)
    return 100.0 * total / (us * 1e-6)
