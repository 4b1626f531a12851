"""The useful share of the top-up's work: the lanes that missed the
tolerance at the top-up's decision (``stagewise.topup_lanes``) over the
lanes the top-ups ran (every lane, each tick whose top-up ran:
``stagewise.topups``), both the program's device counters' changes since
this reader was loaded; nothing where no top-up ran."""

from benchmark.program_counters import since_load

_change = since_load()


def read(ctx):
    got = _change()
    if not got or not got.get("stagewise.topups"):
        return None
    lanes = 2 * int(ctx.cfg["robots"])
    return got["stagewise.topup_lanes"] / (lanes * got["stagewise.topups"])
