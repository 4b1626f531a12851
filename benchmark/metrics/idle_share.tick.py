"""The device's idle share while a served tick is in flight: 1 - busy /
span over the ticks' spans (issue to synchronised controls), so the wait
for the next tick's due time is left out."""


def read(ctx):
    ticks = ctx.spans.get("bench.tick", [])
    span = sum(e - s for s, e in ticks)
    if span <= 0 or not ctx.ops:
        return None
    return 1.0 - ctx.trace.busy_ns(ctx.ops, ticks) / span
