"""K4's share of its roofline in the served ticks, in %: the least time
the chip could take for the iterations K4 ran (``roofline/k4.py``: the
warm budget every tick, the top-up where it ran), over K4's device time
(every launch, skipped top-ups included)."""

from benchmark.readers import K4_NAMES, k4_parts, least_seconds, named, \
    seconds


def read(ctx):
    spent = seconds(named(ctx.ops, K4_NAMES))
    parts = k4_parts(ctx)
    if spent <= 0 or not parts:
        return None
    return 100.0 * least_seconds(parts, ctx.peaks) / spent
