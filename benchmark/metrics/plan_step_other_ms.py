"""Device ms a tick of every operation that is not K1: the accurate
step's f64 seed map, combine, snapping and status, and the chain's copies
of its inputs and outputs."""

from benchmark.readers import K1_NAMES, named, seconds


def read(ctx):
    if ctx.ticks <= 0 or not ctx.ops:
        return None
    k1 = seconds(named(ctx.ops, K1_NAMES))
    return 1e3 * (seconds(ctx.ops) - k1) / ctx.ticks
