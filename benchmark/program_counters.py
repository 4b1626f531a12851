"""The program's own counters (``copra_tpu_torch.profiling.counters``) as
a per-layer reader sees them: each counter's change since the reader was
loaded.  The harness loads the readers of a traced run after set-up, so
the change covers the run's measured windows (the untraced one, where a
reader of the cell asks for it, the traced one and the call before it)
and none of set-up's ticks.  A program that keeps no counters gives
nothing, and nothing raises."""

from __future__ import annotations


def since_load():
    """A function that returns ``{name: change}`` of every counter since
    this call, or None where the program keeps no counters (reading the
    device counters waits for the work queued on their devices)."""
    from copra_tpu_torch import profiling

    read = getattr(profiling, "counters", None)
    if read is None:
        return lambda: None
    base = read()
    return lambda: {k: v - base.get(k, 0) for k, v in read().items()}
