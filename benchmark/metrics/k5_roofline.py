"""K5's share of its roofline in the served ticks, in %: the least time
the chip could take for the iterations K5 ran (``roofline/k5.py``, K4's
count: the warm budget every tick, the top-up where it ran, the launches
told apart as ``readers.k4_launches`` tells them) over K5's device time
(every launch, skipped top-ups included).  It differs from
``k4_roofline`` only in its lanes: one a robot (``readers.k4_parts``
counts two, the ZMP robot's two axes)."""

from benchmark.readers import K4_NAMES, k4_launches, least_seconds, named, \
    seconds


def read(ctx):
    spent = seconds(named(ctx.ops, K4_NAMES))
    if spent <= 0:
        return None
    cfg = ctx.cfg
    x, u, r = (int(cfg["stage_dims"][k]) for k in ("x", "u", "r"))
    parts = [ctx.roofline("k5").work(int(cfg["robots"]), int(cfg["horizon"]),
                                     x, u, r, n)
             for _, n in k4_launches(ctx) if n > 0]
    if not parts:
        return None
    return 100.0 * least_seconds(parts, ctx.peaks) / spent
