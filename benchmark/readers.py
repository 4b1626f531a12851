"""What the per-layer metric readers share: the kernels' names as the
profiler shows them, the least time of counted work, and the device ops
of each served tick.

A reader (``benchmark/metrics/<name>.py``) has ``read(ctx)``, which returns
the metric's value, or None where the traced window holds nothing to read
(the harness then leaves the metric out).  ``ctx`` holds ``ops`` (the
device operations of the window, :class:`benchmark.trace.Op`), ``spans``
(the benchmark's own host spans), ``window``, ``ticks``, ``calls``,
``cfg``, ``traffic``, ``peaks``, ``roofline(name)`` (the module
``benchmark/roofline/<name>.py``), ``trace`` and ``untraced`` (the window
run with the profiler off before the traced one, where a reader of the
cell sets ``UNTRACED = True``; else None).
"""

from __future__ import annotations

K1_NAMES = ("box_register_kernel", "box_streamed_kernel", "box_qx_kernel")
K4_NAMES = ("stagewise_tick_kernel",)


def named(ops, names):
    return [o for o in ops if any(n in o.name for n in names)]


def seconds(ops) -> float:
    return sum(o.end - o.start for o in ops) / 1e9


def least_seconds(parts, peaks) -> float:
    """The least time the chip could take for ``parts`` (``(name,
    operations, bytes, precision)`` each): per part the larger of its
    operations over the peak of its precision and its bytes over the
    memory rate, summed."""
    return sum(max(f / peaks["flops_per_s"][p], b / peaks["hbm_bytes_per_s"])
               for _, f, b, p in parts)


def compute_seconds(parts, peaks) -> float:
    """The operations of ``parts`` over the peaks of their precisions."""
    return sum(f / peaks["flops_per_s"][p] for _, f, _, p in parts)


def k1_parts(ctx):
    cfg = ctx.cfg
    return ctx.roofline("k1").work(
        int(cfg["lanes"]), int(cfg["horizon"]), int(cfg["admm_iterations"]),
        int(cfg["accurate_rounds"]))


def k4_launches(ctx):
    """``[(op, iterations)]`` of every K4 launch in the window.  Every
    tick launches its warm budget, and then the top-up, which returns at
    its entry where every lane converged: a launch took under a tenth of
    the longest one only when it returned so, every tick's warm launch
    ran, and the other launches that ran are top-ups."""
    cfg = ctx.cfg
    warm, topup = int(cfg["warm_iterations"]), int(cfg["topup_iterations"])
    k4 = named(ctx.ops, K4_NAMES)
    if not k4:
        return []
    longest = max(o.end - o.start for o in k4)
    ran = [o for o in k4 if o.end - o.start >= 0.1 * longest]
    topups = max(len(ran) - ctx.ticks, 0)
    ran.sort(key=lambda o: o.end - o.start)
    # the longest launches are the top-ups (more iterations, same work
    # an iteration)
    return ([(o, warm) for o in ran[:len(ran) - topups]]
            + [(o, topup) for o in ran[len(ran) - topups:]])


def k4_parts(ctx):
    cfg = ctx.cfg
    lanes = 2 * int(cfg["robots"])
    x, u, r = (int(cfg["stage_dims"][k]) for k in ("x", "u", "r"))
    return [ctx.roofline("k4").work(lanes, int(cfg["horizon"]), x, u, r, n)
            for _, n in k4_launches(ctx) if n > 0]
