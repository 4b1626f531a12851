"""The package's default device, tensor conversion and dtype promotion
shared by the port's modules."""

from __future__ import annotations

import functools

import numpy as np
import torch

_default_device = torch.device("cuda")


def set_default_device(device) -> None:
    """Where the entry points put what they build from numpy arrays and
    Python numbers.  ``torch.device("cuda")`` unless set; tests and
    CPU-only callers set ``"cpu"``.  Tensors keep their own device."""
    global _default_device
    _default_device = torch.device(device)


def default_device() -> torch.device:
    """The package's default device (see :func:`set_default_device`)."""
    return _default_device


def resolve_device(device=None) -> torch.device:
    """``device``, or the package's default; raises for a CUDA device on a
    host without one (no silent fallback to the CPU)."""
    dev = torch.device(_default_device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"copra_tpu_torch places new tensors on {dev}, but no CUDA "
            f"device is available; call copra_tpu_torch.set_default_device("
            f"'cpu') (or pass CPU tensors) to run on the CPU")
    return dev


def as_tensor(x, device=None) -> torch.Tensor:
    """Tensors keep their device unless ``device`` is given; numpy arrays
    keep their dtype; Python numbers and lists become float64, as they do
    in the reference, which runs with ``jax_enable_x64``.  A non-tensor
    goes to ``device``, or to the package's default device."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    dev = resolve_device(device)
    if isinstance(x, np.ndarray):
        return torch.tensor(x, device=dev)
    return torch.tensor(x, dtype=torch.float64, device=dev)


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
