"""The whole chained tick's share of the chip's peak, in %: the
operations a tick needs (K1's products and iterations in float32, the
seed map and combine in float64), each over the peak of its precision,
over the window's time a tick."""

from benchmark.readers import K1_NAMES, compute_seconds, k1_parts, named


def read(ctx):
    s, e = ctx.window
    if ctx.ticks <= 0 or e <= s or not named(ctx.ops, K1_NAMES):
        return None
    cfg = ctx.cfg
    B, n, x = float(cfg["lanes"]), float(cfg["horizon"]), 2.0
    step = [("seed map", 2.0 * B * n * x, 0.0, "float64"),
            ("combine and status", 12.0 * B * n, 0.0, "float64")]
    need = compute_seconds(k1_parts(ctx) + step, ctx.peaks)
    return 100.0 * need / ((e - s) / 1e9 / ctx.ticks)
