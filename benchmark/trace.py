"""Reading a ``torch.profiler`` run: the device's operations, the
benchmark's own spans, busy time and the breakdown.

Busy time is the interval union of the device's operations per stream,
then across streams, as ``copra_tpu_torch.profiling.trace_device_time``
takes it (a copy of its arithmetic, here so that the benchmark owns it).
The device's operations are the profiler's kernels, copies and memsets;
the spans are the harness's own host ranges around its calls into the
program (``bench.*``), on the clock of the profiler's events.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

class Op(tuple):
    """``(name, start_ns, end_ns, stream)`` of one device operation."""
    __slots__ = ()
    name = property(lambda s: s[0])
    start = property(lambda s: s[1])
    end = property(lambda s: s[2])
    stream = property(lambda s: s[3])


def collect(prof) -> List[Op]:
    """The device operations of a finished ``torch.profiler.profile``,
    sorted by start."""
    from torch.autograd import DeviceType

    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and _is_device_op(e):
            s = int(e.start_ns())
            ops.append(Op((e.name(), s, s + int(e.duration_ns()),
                           (e.device_index(), e.device_resource_id()))))
    ops.sort(key=lambda o: o.start)
    return ops


def _is_device_op(e) -> bool:
    """A kernel, copy or memset: not a user annotation projected onto the
    device's timeline (the card's torch build names no activity type)."""
    return not e.is_user_annotation() and not e.name().startswith("bench.")


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The disjoint union of ``intervals``, sorted."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def length(intervals: Sequence[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in intervals)


def clip(intervals, windows) -> List[Tuple[int, int]]:
    """The parts of ``intervals`` inside the union of ``windows``."""
    out, wins = [], union(windows)
    j = 0
    for s, e in union(intervals):
        while j < len(wins) and wins[j][1] <= s:
            j += 1
        k = j
        while k < len(wins) and wins[k][0] < e:
            a, b = max(s, wins[k][0]), min(e, wins[k][1])
            if b > a:
                out.append((a, b))
            k += 1
    return out


def busy_ns(ops: Sequence[Op], windows=None) -> int:
    """Nanoseconds in which some device operation ran (per stream first,
    then across streams), inside ``windows`` when given."""
    per_stream: Dict[object, list] = {}
    for o in ops:
        per_stream.setdefault(o.stream, []).append((o.start, o.end))
    ivs = [iv for v in per_stream.values() for iv in union(v)]
    if windows is not None:
        return length(clip(ivs, windows))
    return length(union(ivs))


def breakdown(ops: Sequence[Op], spans: Dict[str, list], window,
              top: int = 10) -> dict:
    """``{"device_ops": [[name, s]], "idle_gaps": [[host activity, s]]}``:
    the device operations that took most time in ``window``, and the
    device's idle time in it summed by what the host was doing at each
    gap's middle (the innermost benchmark span; ``harness`` outside every
    span), the largest first."""
    inside = [o for o in ops if o.start >= window[0] and o.end <= window[1]]
    by_name: Dict[str, int] = {}
    for o in inside:
        by_name[o.name] = by_name.get(o.name, 0) + (o.end - o.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union([(o.start, o.end) for o in inside])
    edges = [window[0]] + [t for iv in busy for t in iv] + [window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    # the device's idle time summed by what the host was doing: the
    # innermost span (the shortest) that holds each gap's middle
    mids = np.array([(a + b) // 2 for a, b in gaps], dtype=np.int64)
    length = np.array([b - a for a, b in gaps], dtype=np.int64)
    best = np.full(len(gaps), np.iinfo(np.int64).max)
    label = np.full(len(gaps), -1)
    names = [n for n in sorted(spans) if n != "bench.window"]
    for k, n in enumerate(names):
        iv = np.array(sorted(spans[n]), dtype=np.int64).reshape(-1, 2)
        j = np.searchsorted(iv[:, 0], mids, side="right") - 1
        ok = j >= 0
        jj = np.where(ok, j, 0)
        dur = iv[jj, 1] - iv[jj, 0]
        hold = ok & (mids <= iv[jj, 1]) & (dur < best)
        best = np.where(hold, dur, best)
        label = np.where(hold, k, label)
    by_host: Dict[str, int] = {}
    for k, ns in zip(label.tolist(), length.tolist()):
        key = names[k] if k >= 0 else "harness"
        by_host[key] = by_host.get(key, 0) + ns
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], ns / 1e9] for n, ns in device_ops],
            "idle_gaps": [[n, ns / 1e9] for n, ns in idle]}
