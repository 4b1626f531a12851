"""Batched small-matrix Cholesky: the plain PyTorch version and the wrapper
of the hand-written CUDA kernel.

Port of ``copra_tpu/ops/cholesky_kernel.py``.  MPC plan builds factorize
thousands of small KKT matrices at once (``K = Q + (sigma + rho) I`` per
scenario, n ~ 10..128); :func:`chol_batched` runs the right-looking
(outer-product) recursion

    for j in 0..n-1:   c_j = K[:, j] / sqrt(K[j, j]);  K -= c_j c_j'

per matrix in ``copra_tpu_torch/csrc/chol_batched.cu``, float32 or float64,
reading only the lower triangle of ``K``: a group of 8, 16 or 32 threads per
matrix up to n = 32 (the small body), a block of 256 threads per matrix with
the factor in registers up to n = 128 (the block body); :func:`chol_config`
is the launch plan.  :func:`chol_plain` is the same recursion step by step
on tensors.

Above the diagonal both give what the reference's ``L * tril`` gives: zero
in every column of a matrix that factors, NaN in the columns from the first
failed pivot on.

Not ported, being TPU layout: the batch on the 128-wide lane axis
(``[n, n, 128]`` blocks), the identity pad of the batch to a multiple of 128
and the VMEM working-set rule, which sends 88 < n <= 128 to
``jnp.linalg.cholesky``; the kernel takes every n <= 128.  Wider matrices go
to ``torch.linalg.cholesky_ex`` (as the reference sends them to
``jnp.linalg.cholesky``) and count no launch.  Otherwise the wrapper takes
the plain version only for tensors on the CPU; on a CUDA tensor it launches
the kernel or raises.  A matrix that is not positive definite gives NaN,
not an error, on every route.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..qp.admm import _cholesky
from ._derivative import refuse_gradient
from .build import load_library
from .counts import counted

Tensor = torch.Tensor

# widest matrix the kernel takes (the reference's size rule)
MAX_KERNEL_N = 128
CHOL_BODIES = {"small": 1, "block": 2}
_SMALL_MAX_N, _SMALL_WARPS, _BLOCK_THREADS, _TILE = 32, 4, 256, 16
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}

_I, _P = ctypes.c_int, ctypes.c_void_p
_lib = None


def chol_config(n: int, dtype: torch.dtype, body: str = "auto"
                ) -> Tuple[int, int, int, int, int]:
    """The launch plan of ``csrc/chol_batched.cu`` for ``n`` in ``dtype``
    (mirrored by ``make_config`` there and checked when the library loads):
    ``(body, width, threads, matrices_per_block, smem_bytes)``.

    ``body`` "auto" takes "small" (1) for n <= 32: a group of ``width`` =
    8, 16 or 32 threads per matrix (n rounded up), a row a thread, 32 /
    width matrices a warp, 4 warps a block, a per-warp shared stage of 32
    rows of width + 1 values for the loads and stores.  Wider n take
    "block" (2), which takes every n <= 128: a matrix per block of 256
    threads, ``width`` = ceil(n / 16) tiles of 16 a side, a shared band of
    2 x 16 rows of 16 width + 2 floats (+ 1 doubles) and two column vectors
    and the diagonal of 16 width values.  Shared memory is static, under
    48 KB."""
    if dtype not in _ITEMSIZE:
        raise TypeError(f"chol_batched kernel takes float32 or float64, got "
                        f"{dtype}")
    if not 1 <= n <= MAX_KERNEL_N:
        raise ValueError(f"chol_batched kernel takes 1 <= n <= "
                         f"{MAX_KERNEL_N}, got n = {n}")
    size = _ITEMSIZE[dtype]
    small = n <= _SMALL_MAX_N
    if body == "auto":
        body = "small" if small else "block"
    if body not in CHOL_BODIES or (body == "small" and not small):
        raise ValueError(f"chol_batched kernel: body {body!r} does not take "
                         f"n = {n}")
    if body == "small":
        g = 8 if n <= 8 else 16 if n <= 16 else 32
        return (1, g, 32 * _SMALL_WARPS, _SMALL_WARPS * (32 // g),
                size * _SMALL_WARPS * 32 * (g + 1))
    t = -(-n // _TILE)
    ld = _TILE * t + (2 if size == 4 else 1)
    return (2, t, _BLOCK_THREADS, 1, size * (2 * _TILE * ld + 3 * _TILE * t))


def _check_chol_plans(lib) -> None:
    for n in range(MAX_KERNEL_N + 2):
        for dtype in _ITEMSIZE:
            for body in ("auto", *CHOL_BODIES):
                out = (ctypes.c_int * 5)()
                rc = lib.copra_chol_batched_config(
                    n, int(dtype == torch.float64), CHOL_BODIES.get(body, 0),
                    out)
                try:
                    want = chol_config(n, dtype, body)
                except ValueError:
                    want = None
                if (rc != 0) != (want is None) or (want is not None
                                                  and tuple(out) != want):
                    raise RuntimeError(
                        f"csrc/chol_batched.cu's launch plan for n = {n}, "
                        f"{dtype}, body {body}, is {tuple(out)} (rc {rc}), "
                        f"not {want}")


def _load() -> ctypes.CDLL:
    """The library of ``csrc/chol_batched.cu`` with its signatures set and
    its launch plans checked against :func:`chol_config`."""
    global _lib
    if _lib is None:
        lib = load_library("chol_batched")
        for sym, res, args in (
                ("copra_chol_batched", _I, [_P, _P, _I, _I, _I, _I, _P]),
                ("copra_chol_batched_config", _I, [_I, _I, _I, _P]),
                ("copra_chol_batched_attributes", _I, [_I, _I, _I, _P]),
                ("copra_chol_batched_error_string", ctypes.c_char_p, [_I])):
            fn = getattr(lib, sym)
            fn.restype, fn.argtypes = res, args
        _check_chol_plans(lib)
        _lib = lib
    return _lib


def _raise_on(rc: int, lib) -> None:
    if rc != 0:
        msg = lib.copra_chol_batched_error_string(rc).decode()
        raise RuntimeError(f"copra_chol_batched kernel launch failed: CUDA "
                           f"error {rc} ({msg})")


def _chol_attributes(n: int, dtype: torch.dtype, body: str = "auto"
                     ) -> Tuple[int, int, int, int, int]:
    """``(registers a thread, spill bytes a thread, largest block, blocks
    an SM holds, static shared bytes)`` of the compiled kernel that serves
    the plan (``cudaFuncGetAttributes``, the occupancy calculator)."""
    chol_config(n, dtype, body)
    lib = _load()
    out = (ctypes.c_int * 5)()
    _raise_on(lib.copra_chol_batched_attributes(
        n, int(dtype == torch.float64), CHOL_BODIES.get(body, 0), out), lib)
    return tuple(out)


def chol_plain(K: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel: the right-looking recursion on
    ``K [..., n, n]``, one column per step, masked by a lower-triangular
    ones matrix as the reference masks it.  What lies above the diagonal
    never feeds the lower triangle: above it the result is zero where the
    factorization holds and NaN in the columns of a failed pivot and after
    it."""
    n = K.shape[-1]
    A = K
    cols = []
    for j in range(n):
        dinv = 1.0 / torch.sqrt(A[..., j:j + 1, j:j + 1])
        c = A[..., :, j:j + 1] * dinv
        cols.append(c)
        if j + 1 < n:
            A = A - c * c.mT
    tril = torch.tril(torch.ones((n, n), dtype=K.dtype, device=K.device))
    return torch.cat(cols, dim=-1) * tril


def _launch_chol(K: Tensor, body: str = "auto") -> Tensor:
    """One launch of ``csrc/chol_batched.cu`` on the CUDA tensor ``K [B, n,
    n]`` with the body ``body`` ("auto", "small" or "block")."""
    refuse_gradient("chol_batched (csrc/chol_batched.cu)",
                    "torch.linalg.cholesky (or chol_plain)", K)
    if not K.is_contiguous():
        raise ValueError("K must be contiguous")
    B, n, _ = K.shape
    chol_config(n, K.dtype, body)
    lib = _load()
    L = torch.empty_like(K)
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        rc = lib.copra_chol_batched(K.data_ptr(), L.data_ptr(), B, n,
                                    int(K.dtype == torch.float64),
                                    CHOL_BODIES.get(body, 0), stream)
    _raise_on(rc, lib)
    return L


@counted
def chol_batched(K: Tensor) -> Tensor:
    """Lower Cholesky factors ``L [B, n, n]`` (``L L' = K``) of a batch of
    small SPD matrices ``K [B, n, n]``, float32 or float64; only the lower
    triangle of ``K`` is read.

    ``n <= 128``: CPU tensors run :func:`chol_plain`; CUDA tensors launch
    ``csrc/chol_batched.cu``.  ``n > 128`` goes to
    ``torch.linalg.cholesky_ex`` on either device and counts no launch.  The
    TPU's ``interpret`` has no meaning here."""
    if K.dim() != 3 or K.shape[-1] != K.shape[-2] or K.shape[0] < 1 \
            or K.shape[-1] < 1:
        raise ValueError(f"K must be [B, n, n] with B, n >= 1, got "
                         f"{tuple(K.shape)}")
    if K.dtype not in _ITEMSIZE:
        raise TypeError(f"K must be float32 or float64, got {K.dtype}")
    if K.shape[-1] > MAX_KERNEL_N:
        return _cholesky(K)
    if K.device.type == "cpu":
        return chol_plain(K)
    L = _launch_chol(K)
    chol_batched.launches += 1
    return L
