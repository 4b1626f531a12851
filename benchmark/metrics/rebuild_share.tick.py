"""The share of the served ticks that rebuilt their problem from their
initial states: the changes of the program's device counters
``stagewise.rebuilds`` over ``stagewise.ticks`` since this reader was
loaded (1.0 when every tick re-linearised and refactored its gains).  A
program without the rebuild counter gives nothing."""

from benchmark.program_counters import since_load

_change = since_load()


def read(ctx):
    got = _change()
    if not got or not got.get("stagewise.ticks") \
            or "stagewise.rebuilds" not in got:
        return None
    return got["stagewise.rebuilds"] / got["stagewise.ticks"]
