"""Timing on the device the work runs on.

Port of the part of ``copra_tpu/profiling.py`` that the ``LMPC`` deadline
calibration needs: one timer that gives device milliseconds from CUDA events
on a CUDA device and wall milliseconds on the CPU.  ``trace_span``,
``solve_metrics`` and ``trace_device_time`` are not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


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
