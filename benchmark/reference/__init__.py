"""Plain references of the benchmark's configurations, one module a
configuration, each with ``controls(cfg, raw, x0, lanes, precision)``.

``precision`` is ``"float64"`` (the reference), or a lower precision for
the control: ``"float32"``, or ``"tf32"`` (float32 with TF32 matrix
products on a CUDA device).
"""

from contextlib import contextmanager

import torch


@contextmanager
def precision(name: str):
    """The dtype of ``name``, with TF32 products switched on inside the
    block for ``"tf32"`` (and off for the others)."""
    dtype = {"float64": torch.float64, "float32": torch.float32,
             "tf32": torch.float32}[name]
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    try:
        yield dtype
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
