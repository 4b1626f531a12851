"""K1's share of its roofline in a chained tick, in %: the least time the
chip could take for one tick's K1 work (``roofline/k1.py``), over K1's
device time a tick (its x0 = 0 body and its Q x pass, from the trace)."""

from benchmark.readers import K1_NAMES, k1_parts, least_seconds, named, \
    seconds


def read(ctx):
    spent = seconds(named(ctx.ops, K1_NAMES))
    if spent <= 0 or ctx.ticks <= 0:
        return None
    return 100.0 * least_seconds(k1_parts(ctx), ctx.peaks) / (
        spent / ctx.ticks)
