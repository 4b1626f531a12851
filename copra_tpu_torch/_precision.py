"""Float32 matmul precision control.

Port of ``copra_tpu/_precision.py``.  There the trap is the TPU's bf16 MXU
passes; on Hopper it is TF32: a float32 product allowed to run on the
tensor cores in TF32 keeps about three decimal digits, which the solver's
1e4-conditioned operators turn into garbage.  Matmul TF32 is off by default
in PyTorch but cuDNN's is on, and both are process-wide switches, so every
numerical entry point of the package runs under :func:`full_f32` (the
previous settings come back on exit, so nothing leaks into user code).
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def full_f32():
    """Run the body with TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def highest_precision(fn):
    """Run ``fn`` under :func:`full_f32`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_f32():
            return fn(*args, **kwargs)

    return wrapped
