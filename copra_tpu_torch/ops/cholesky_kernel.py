"""Batched small-matrix Cholesky: the plain PyTorch version and the wrapper
of the hand-written CUDA kernel.

Port of ``copra_tpu/ops/cholesky_kernel.py``.  MPC plan builds factorize
thousands of small KKT matrices at once (``K = Q + (sigma + rho) I`` per
scenario, n ~ 10..128); :func:`chol_batched` runs the right-looking
(outer-product) recursion

    for j in 0..n-1:   c_j = K[:, j] / sqrt(K[j, j]);  K -= c_j c_j'

per matrix in ``copra_tpu_torch/csrc/chol_batched.cu`` (a warp per matrix
up to n = 32, a block per matrix up to n = 128, float32 or float64).
:func:`chol_plain` is the same recursion step by step on tensors.

Not ported, being TPU layout: the batch on the 128-wide lane axis
(``[n, n, 128]`` blocks), the identity pad of the batch to a multiple of 128
and the VMEM working-set rule.  The one size rule kept is the reference's
``n > 128``: such matrices go to ``torch.linalg.cholesky`` (as the reference
sends them to ``jnp.linalg.cholesky``) and count no launch.  Otherwise the
wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.  A matrix that is not positive
definite gives NaN, not an error, on every route.
"""

from __future__ import annotations

import ctypes

import torch

from ..qp.admm import _cholesky
from .build import load_library

Tensor = torch.Tensor

# widest matrix the kernel takes (the reference's size rule)
MAX_KERNEL_N = 128

_lib = None


def _load() -> ctypes.CDLL:
    """The library of ``csrc/chol_batched.cu`` with its signatures set."""
    global _lib
    if _lib is None:
        lib = load_library("chol_batched")
        lib.copra_chol_batched.restype = ctypes.c_int
        lib.copra_chol_batched.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.copra_chol_batched_error_string.restype = ctypes.c_char_p
        lib.copra_chol_batched_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def chol_plain(K: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel: the right-looking recursion on
    ``K [..., n, n]``, one column per step, the strict upper triangle of the
    result zero.  What lies above the diagonal during the recursion never
    feeds the lower triangle."""
    n = K.shape[-1]
    A = K
    cols = []
    for j in range(n):
        dinv = 1.0 / torch.sqrt(A[..., j:j + 1, j:j + 1])
        c = A[..., :, j:j + 1] * dinv
        cols.append(c)
        if j + 1 < n:
            A = A - c * c.mT
    return torch.tril(torch.cat(cols, dim=-1))


def chol_batched(K: Tensor) -> Tensor:
    """Lower Cholesky factors ``L [B, n, n]`` (``L L' = K``) of a batch of
    small SPD matrices ``K [B, n, n]``, float32 or float64.

    ``n <= 128``: CPU tensors run :func:`chol_plain`; CUDA tensors launch
    ``csrc/chol_batched.cu``.  ``n > 128`` goes to
    ``torch.linalg.cholesky`` on either device and counts no launch.  The
    TPU's ``interpret`` has no meaning here."""
    if K.dim() != 3 or K.shape[-1] != K.shape[-2] or K.shape[0] < 1 \
            or K.shape[-1] < 1:
        raise ValueError(f"K must be [B, n, n] with B, n >= 1, got "
                         f"{tuple(K.shape)}")
    if K.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K must be float32 or float64, got {K.dtype}")
    B, n, _ = K.shape
    if n > MAX_KERNEL_N:
        return _cholesky(K)
    if K.device.type == "cpu":
        return chol_plain(K)
    if not K.is_contiguous():
        raise ValueError("K must be contiguous")
    lib = _load()
    L = torch.empty_like(K)
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        rc = lib.copra_chol_batched(K.data_ptr(), L.data_ptr(), B, n,
                                    int(K.dtype == torch.float64), stream)
    if rc != 0:
        msg = lib.copra_chol_batched_error_string(rc).decode()
        raise RuntimeError(f"copra_chol_batched kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    chol_batched.launches += 1
    return L


chol_batched.launches = 0
