"""The device's idle share over a chained window: 1 - busy / span, busy
the interval union of the device's operations per stream, span the
window from its first call to its closing synchronise."""


def read(ctx):
    s, e = ctx.window
    if e <= s or not ctx.ops:
        return None
    return 1.0 - ctx.trace.busy_ns(ctx.ops, [ctx.window]) / (e - s)
