"""Host ms to issue a served tick (the call into the serving entry: the
copy of the tick's inputs, a graph replay and the copies of its outputs,
before its synchronise), the mean over the ticks of a window run with the
profiler off, so that the profiler's cost a launch is not in it."""

UNTRACED = True


def read(ctx):
    w = ctx.untraced
    if w is None or not w.parts:
        return None
    return 1e3 * sum(p[1] for p in w.parts) / len(w.parts)
