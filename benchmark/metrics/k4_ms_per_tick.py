"""K4's device ms a served tick, its top-up launches included."""

from benchmark.readers import K4_NAMES, named, seconds


def read(ctx):
    spent = seconds(named(ctx.ops, K4_NAMES))
    if spent <= 0 or ctx.ticks <= 0:
        return None
    return 1e3 * spent / ctx.ticks
