"""Tracing, timing, metrics and logging.

Port of ``copra_tpu/profiling.py``:

* :func:`trace_span` -- a named region in ``torch.profiler`` traces (and an
  NVTX range on an initialised CUDA device, so Nsight shows it too);
* :func:`timed` -- a host wall-clock span that waits for the CUDA devices
  of the tensors it is given before the clock stops;
* :func:`solve_metrics` / :func:`log_metrics` -- structured metrics of a
  (possibly batched) ``QPSolution`` and their log line;
* :func:`trace_device_time` -- device busy time and the top device ops of an
  exported ``torch.profiler`` Chrome trace;
* :func:`synchronize`, :func:`timer_basis`, :func:`elapsed_ms` -- the timer
  of the ``LMPC`` deadline calibration: CUDA events on a CUDA device, the
  host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("copra_tpu_torch")

# Chrome-trace categories of the work a CUDA device runs (the profiler's
# ``cuda_runtime`` and ``cpu_op`` events are the host's side of it)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace_span(name: str):
    """Annotate a region for ``torch.profiler`` (a ``record_function``
    span); on a CUDA device that is already initialised, also an NVTX
    range.  A CPU-only build never touches NVTX."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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


def log_metrics(metrics: Dict, prefix: str = "solve") -> None:
    logger.info("%s: %s", prefix,
                " ".join(f"{k}={v}" for k, v in metrics.items()))


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
