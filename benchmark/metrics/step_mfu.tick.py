"""The whole served tick's share of the chip's peak, in %: the
operations of the iterations K4 ran (``roofline/k4.py``) over the peak,
over the ticks' time in flight (issue to synchronised controls)."""

from benchmark.readers import compute_seconds, k4_parts


def read(ctx):
    ticks = ctx.spans.get("bench.tick", [])
    span = sum(e - s for s, e in ticks) / 1e9
    parts = k4_parts(ctx)
    if span <= 0 or not parts:
        return None
    return 100.0 * compute_seconds(parts, ctx.peaks) / span
