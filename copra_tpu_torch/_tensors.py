"""Tensor conversion and dtype promotion shared by the port's modules."""

from __future__ import annotations

import functools

import numpy as np
import torch


def as_tensor(x, device=None) -> torch.Tensor:
    """Tensors pass through and numpy arrays keep their dtype; Python
    numbers and lists become float64, as they do in the reference, which
    runs with ``jax_enable_x64``."""
    if isinstance(x, torch.Tensor):
        t = x
    elif isinstance(x, np.ndarray):
        t = torch.tensor(x)
    else:
        t = torch.tensor(x, dtype=torch.float64)
    return t if device is None else t.to(device)


def common(*ts, device) -> tuple:
    """Cast ``ts`` to their promoted dtype on ``device`` (matmul and einsum
    take one dtype; the reference promotes f32 with f64 to f64)."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return tuple(t.to(device=device, dtype=dt) for t in ts)


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M @ v`` over the trailing dims, batch dims broadcast."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def matvec_t(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M' @ v`` over the trailing dims, batch dims broadcast."""
    return (M.mT @ v.unsqueeze(-1)).squeeze(-1)
