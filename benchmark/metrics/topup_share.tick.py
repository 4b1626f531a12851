"""The share of the served ticks whose top-up ran: the changes of the
program's device counters ``stagewise.topups`` over ``stagewise.ticks``
(ticks that took the top-up's decision) since this reader was loaded."""

from benchmark.program_counters import since_load

_change = since_load()


def read(ctx):
    got = _change()
    if not got or not got.get("stagewise.ticks"):
        return None
    return got["stagewise.topups"] / got["stagewise.ticks"]
