"""The Riccati gains kernel's share of its roofline in the served ticks,
in %: the least time the chip could take for the recursions it ran
(``roofline/gains.py``, one a launch) over its device time."""

from benchmark.readers import least_seconds, named, seconds

GAINS_NAMES = ("riccati_gains_kernel",)


def read(ctx):
    ops = named(ctx.ops, GAINS_NAMES)
    spent = seconds(ops)
    if spent <= 0:
        return None
    cfg = ctx.cfg
    x, u, r = (int(cfg["stage_dims"][k]) for k in ("x", "u", "r"))
    one = ctx.roofline("gains").work(int(cfg["robots"]), int(cfg["horizon"]),
                                     x, u, r)
    return 100.0 * least_seconds([one] * len(ops), ctx.peaks) / spent
