"""The Riccati gains kernel's device ms a served tick: the per-tick
refactor of the rebuilt problem's gains (``csrc/riccati_gains.cu``)."""

from benchmark.readers import named, seconds

GAINS_NAMES = ("riccati_gains_kernel",)


def read(ctx):
    spent = seconds(named(ctx.ops, GAINS_NAMES))
    if spent <= 0 or ctx.ticks <= 0:
        return None
    return 1e3 * spent / ctx.ticks
