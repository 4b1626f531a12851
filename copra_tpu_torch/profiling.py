"""Tracing, counters, timing and metrics.

Port of ``copra_tpu/profiling.py``:

* :func:`trace_span` -- a named region of the program: recorded in memory
  while :func:`record` is on (:func:`take_spans` hands the spans out), a
  ``torch.profiler`` region while a torch profiler runs, and an NVTX range
  while either holds; :func:`traced` puts a function's calls in one;
* :func:`count`, :func:`device_counter`, :func:`counters` -- the program's
  counters, on the host and accumulated on the device;
* :func:`timed` -- a host wall-clock span that waits for the CUDA devices
  of the tensors it is given before the clock stops;
* :func:`solve_metrics` -- structured metrics of a (possibly batched)
  ``QPSolution``;
* :func:`trace_device_time` -- device busy time and the top device ops of an
  exported ``torch.profiler`` Chrome trace;
* :func:`synchronize`, :func:`timer_basis`, :func:`elapsed_ms` -- the timer
  of the ``LMPC`` deadline calibration: CUDA events on a CUDA device, the
  host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import gzip
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# Chrome-trace categories of the work a CUDA device runs (the profiler's
# ``cuda_runtime`` and ``cpu_op`` events are the host's side of it)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# The span recorder: one switch for the process, the spans recorded since
# the last take, the (index, call id) of each span open now, innermost last
_recording = False
_spans: List[list] = []
_open: List[Tuple[int, int]] = []
_calls = 0
_NULL = contextlib.nullcontext()

# Host counters, and the device counters: one int64 tensor per set of
# names and device, never reallocated (captured CUDA graphs hold its
# address), so readers take differences
_counts: Dict[str, int] = {"ops.compiles": 0, "chain.captures": 0}
_device_counts: Dict[Tuple[Tuple[str, ...], torch.device], torch.Tensor] = {}


def record(on: bool) -> None:
    """Turn the span recorder on or off."""
    global _recording
    _recording = bool(on)


def take_spans() -> List[Tuple[str, int, Optional[int], int, int]]:
    """The spans recorded since the last take, in the order they began,
    and an empty record: ``(name, start_ns, end_ns, parent, call)`` each,
    on ``time.time_ns()``; ``parent`` is the index of the enclosing span
    in the returned list (-1 for none), ``call`` an id that every span
    under one outermost span shares.  Take them while no span is open
    (an open span's ``end_ns`` is None)."""
    global _spans
    out = [tuple(s) for s in _spans]
    _spans = []
    _open.clear()
    return out


def _profiler_region(name: str):
    """A ``torch.profiler`` region: the profiler's light record function
    where this torch build has one (about a tenth of ``record_function``'s
    host time), else ``record_function``."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return (fast(name) if fast is not None
            else torch.profiler.record_function(name))


class _Span:
    """A span while recording is on or a torch profiler runs."""

    __slots__ = ("name", "profiled", "rec", "region", "nvtx")

    def __init__(self, name: str, profiled: bool):
        self.name = name
        self.profiled = profiled
        self.rec = self.region = None

    def __enter__(self):
        global _calls
        if _recording:
            if _open:
                parent, call = _open[-1]
            else:
                _calls += 1
                parent, call = -1, _calls
            self.rec = [self.name, time.time_ns(), None, parent, call]
            _open.append((len(_spans), call))
            _spans.append(self.rec)
        if self.profiled:
            self.region = _profiler_region(self.name)
            self.region.__enter__()
        self.nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.region is not None:
            self.region.__exit__(*exc)
        if self.rec is not None:
            self.rec[2] = time.time_ns()
            if _open:
                _open.pop()
        return False


def trace_span(name: str):
    """A named region of the program.  While recording is off and no torch
    profiler runs it is a shared no-op context (nothing allocated, nothing
    entered).  Else it is an NVTX range on a CUDA device that is already
    initialised, so Nsight shows it; while a torch profiler runs, a region
    of its trace; while recording is on, a span kept in memory for
    :func:`take_spans`.  A CPU-only build never touches NVTX."""
    profiled = torch.autograd._profiler_enabled()
    if not _recording and not profiled:
        return _NULL
    return _Span(name, profiled)


def traced(name: str):
    """Decorate a function so that each of its calls runs in
    ``trace_span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with trace_span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def device_counter(names: Tuple[str, ...], device) -> torch.Tensor:
    """The int64 tensor ``[len(names)]`` on ``device`` into which device
    code adds the counts ``names``, without a host sync.  It is made on
    first use, which must not be inside a CUDA graph capture (the capture
    would record its zeroing): a captured chain runs its function once
    before capturing it."""
    device = torch.device(device)
    key = (tuple(names), device)
    t = _device_counts.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the device counters {names} are first used inside a CUDA "
                f"graph capture; run the captured function once before "
                f"capturing it")
        t = torch.zeros(len(names), dtype=torch.int64, device=device)
        _device_counts[key] = t
    return t


def counters() -> Dict[str, int]:
    """Every counter's total so far, the device counters summed over the
    devices (reading them waits for the work queued on their devices)."""
    out = dict(_counts)
    for (names, _), t in _device_counts.items():
        for name, v in zip(names, t.tolist()):
            out[name] = out.get(name, 0) + int(v)
    return out


def _cuda_devices(tree) -> set:
    from ._graph import tree_map

    devices = set()

    def note(t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda:
            devices.add(t.device)
        return t

    tree_map(note, tree)
    return devices


@contextlib.contextmanager
def timed(result_box: Optional[Dict] = None, key: str = "seconds",
          block_on=None):
    """Wall-clock a block; ``block_on`` (a tensor or a tree of them) makes
    the clock wait for every CUDA device it holds (device-honest timing)."""
    t0 = time.perf_counter()
    yield
    if block_on is not None:
        for dev in _cuda_devices(block_on):
            torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if result_box is not None:
        result_box[key] = dt


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(v))


def solve_metrics(solution, elapsed_s: Optional[float] = None) -> Dict:
    """Structured metrics for one (possibly batched) QPSolution."""
    status = _host(solution.status)
    rp = _host(solution.primal_residual)
    rd = _host(solution.dual_residual)
    iters = _host(solution.iterations)
    n = status.shape[0]
    out = {
        "batch": int(n),
        "converged": int((status == 0).sum()),
        "convergence_rate": float((status == 0).mean()),
        "max_primal_residual": float(rp.max()),
        "max_dual_residual": float(rd.max()),
        "mean_iterations": float(iters.mean()),
        "max_iterations": int(iters.max()),
    }
    if elapsed_s is not None:
        out["seconds"] = float(elapsed_s)
        out["solves_per_s"] = float(n / elapsed_s) if elapsed_s > 0 else 0.0
    return out


def _load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def trace_device_time(trace_dir, top_k: int = 8
                      ) -> Optional[Tuple[float, List[Tuple[str, float]]]]:
    """Device busy time (s) and the top-k device ops by time of the newest
    ``torch.profiler`` Chrome trace under ``trace_dir`` (``*.json`` from
    ``export_chrome_trace``, ``*.pt.trace.json[.gz]`` from
    ``tensorboard_trace_handler``): ``(busy_s, [(name, s), ...])``, or
    ``None`` when the trace has no device track (a CPU run).

    A device event is a complete event (``ph == "X"``) whose category is a
    kernel, a device copy or a device memset; a track is its ``(pid,
    tid)``, the device and the stream.  Busy time is the INTERVAL UNION per
    track, summed over tracks: enclosing or overlapping records of one
    stream (graph-replayed kernels among them) are counted once, where a
    sum of durations would count them twice.
    """
    cands = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat),
                                recursive=True)]
    if not cands:
        return None
    data = _load_trace(max(cands, key=os.path.getmtime))
    evs = data.get("traceEvents", []) if isinstance(data, dict) else data
    per_op: Dict[str, float] = {}
    intervals: Dict[tuple, list] = {}
    for e in evs:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        ts = float(e.get("ts", 0.0)) * 1e-6
        dur = float(e.get("dur", 0.0)) * 1e-6
        name = e.get("name", "?")
        per_op[name] = per_op.get(name, 0.0) + dur
        intervals.setdefault((e.get("pid"), e.get("tid")), []).append(
            (ts, ts + dur))
    if not per_op:
        return None
    busy = 0.0
    for iv in intervals.values():
        iv.sort()
        cur_s, cur_e = iv[0]
        for s, e_ in iv[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e_
            else:
                cur_e = max(cur_e, e_)
        busy += cur_e - cur_s
    if busy == 0.0:
        return None
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:top_k]
    return busy, top


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timer_basis(device) -> str:
    """What :func:`elapsed_ms` measures on ``device``: ``"cuda-events"`` or
    ``"wall"``."""
    return "cuda-events" if torch.device(device).type == "cuda" else "wall"


def elapsed_ms(fn: Callable[[], object], device, reps: int = 1) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls: the span between
    two CUDA events on a CUDA ``device`` (device time, without the host's
    dispatch before the first launch), the host clock on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps
