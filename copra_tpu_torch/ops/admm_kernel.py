"""Fixed-count box-only ADMM over a batch of lanes: the plain PyTorch
version and the wrappers of the hand-written CUDA kernel.

Port of ``copra_tpu/ops/admm_kernel.py``: :func:`admm_box_plain` is the
counterpart of ``xla_admm_box``; :func:`fused_admm_box_lanes` and
:func:`fused_admm_box` are the counterparts of the Pallas entry points of
the same names, both served by one kernel,
``copra_tpu_torch/csrc/admm_box.cu``.  That kernel replaces the TPU's
``fused_admm_box_lanes`` (``_lanes_box_kernel_z0``, ``_lanes_qx_kernel``,
``_lanes_box_kernel``) and ``fused_admm_box``.

What bounds it on an H100 is the bytes of the per-lane operators: at the
main path's B = 4096, n = 100, ``Kinv`` is 164 MB, more than three times
the L2, and the plain version streams it from device memory once per
iteration.  The kernel gives each lane one thread block, stages the lane's
operator in shared memory once and runs every iteration there, so device
memory sees each operator once per call.

The TPU-only layout machinery is not ported: ``pack_lanes_operator``,
``_pack_lanes_vec``/``_unpack_lanes_vec`` and ``_pad8`` (the lane-major
``[nc, n8, n8, 128]`` packing and its identity pad existed for Mosaic's
vector layout), ``lanes_kernel_fits``/``default_sub_batch`` (VMEM budgets)
and the ``COPRA_*`` environment switches.  Operators stay ``[B, n, n]``.

A wrapper takes the plain version only for tensors on the CPU.  On a CUDA
tensor it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import load_library

Tensor = torch.Tensor

# kernel modes (csrc/admm_box.cu)
MODE_X0_ZERO = 1
MODE_QX = 2
MODE_GENERAL = 3

_lib = None


def kernel_mode(n_iter: int, refine: int, assume_x0_zero: bool) -> int:
    """Which body serves a call (the reference's branch order,
    ``admm_kernel.py:629-673``; ``n_iter == 0`` with ``refine > 0`` gives
    the same ``g = Q x0`` as the pure pass, so it takes that pass)."""
    if assume_x0_zero and refine == 0 and n_iter > 0:
        return MODE_X0_ZERO
    if n_iter == 0:
        return MODE_QX
    return MODE_GENERAL


def _mv(v: Tensor, M: Tensor) -> Tensor:
    """Row-vector product ``out[b, i] = sum_j M[b, j, i] v[b, j]`` (rank-3,
    per lane) or ``v @ M`` (rank-2, shared), as ``xla_admm_box`` sums it."""
    if M.dim() == 2:
        return v @ M
    return torch.bmm(v.unsqueeze(-2), M).squeeze(-2)


def admm_box_plain(Kinv: Tensor, K: Tensor, c: Tensor, l: Tensor, u: Tensor,
                   x0: Tensor, y0: Tensor, z0: Tensor, *, n_iter: int,
                   sigma: float, alpha: float, rho: float, refine: int = 0,
                   assume_x0_zero: bool = False
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the kernel (counterpart of
    ``xla_admm_box``), in all three of its modes.

    ``Kinv``/``K`` are ``[B, n, n]`` (per lane) or ``[n, n]`` (shared);
    vectors are ``[B, n]``.  Returns ``(x, y, z, g)`` with ``g = Q x =
    x K - (sigma + rho) x``.  With ``assume_x0_zero`` (and ``refine == 0``)
    the iteration starts from ``x = 0`` whatever ``x0`` holds, ``K`` is not
    read and ``g`` comes from the recurrence ``w <- alpha rhs + (1-alpha) w``
    (``K x_t = rhs`` by construction), as the kernel computes it.
    """
    mode = kernel_mode(n_iter, refine, assume_x0_zero)
    spr = sigma + rho
    if mode == MODE_QX:
        return x0.clone(), y0.clone(), z0.clone(), _mv(x0, K) - spr * x0
    rho_inv = 1.0 / rho
    oma = 1.0 - alpha
    x = torch.zeros_like(c) if mode == MODE_X0_ZERO else x0
    z, y = z0, y0
    w = torch.zeros_like(c)
    for _ in range(n_iter):
        rhs = sigma * x - c + rho * z - y
        x_t = _mv(rhs, Kinv)
        if mode == MODE_GENERAL:
            for _ in range(refine):
                x_t = x_t + _mv(rhs - _mv(x_t, K), Kinv)
        x_n = alpha * x_t + oma * x
        z_rel = alpha * x_t + oma * z
        z = torch.clamp(z_rel + rho_inv * y, l, u)
        y = y + rho * (z_rel - z)
        if mode == MODE_X0_ZERO:
            w = alpha * rhs + oma * w
        x = x_n
    if mode == MODE_X0_ZERO:
        g = w - spr * x
    else:
        g = _mv(x, K) - spr * x
    return x, y, z, g


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = load_library("admm_box")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.copra_admm_box.restype = i
    lib.copra_admm_box.argtypes = [p] * 12 + [i] * 5 + [f] * 6 + [p]
    lib.copra_admm_box_smem_bytes.restype = ctypes.c_size_t
    lib.copra_admm_box_smem_bytes.argtypes = [i, i]
    lib.copra_admm_box_max_smem.restype = i
    lib.copra_admm_box_max_smem.argtypes = [i]
    lib.copra_cuda_error_string.restype = ctypes.c_char_p
    lib.copra_cuda_error_string.argtypes = [i]
    _lib = lib
    return lib


def _check(Kinv: Tensor, K: Tensor, vecs) -> None:
    if Kinv.dim() == 2 or K.dim() == 2:
        raise NotImplementedError("K3 fused_admm_box_shared not yet ported")
    if Kinv.dim() != 3 or K.dim() != 3:
        raise ValueError(f"operators must be [B, n, n], got {tuple(Kinv.shape)}"
                         f" and {tuple(K.shape)}")
    B, n = vecs[0].shape if vecs[0].dim() == 2 else (-1, -1)
    if B < 1 or n < 1:
        raise ValueError(f"vectors must be [B, n] with B, n >= 1, got "
                         f"{tuple(vecs[0].shape)}")
    dev = Kinv.device
    for name, t, shape in (("Kinv", Kinv, (B, n, n)), ("K", K, (B, n, n)),
                           *((nm, v, (B, n)) for nm, v in
                             zip(("c", "l", "u", "x0", "y0", "z0"), vecs))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, Kinv on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(Kinv, K, c, l, u, x0, y0, z0, *, n_iter, sigma, alpha, rho,
            refine, assume_x0_zero):
    vecs = (c, l, u, x0, y0, z0)
    _check(Kinv, K, vecs)
    if n_iter < 0 or refine < 0:
        raise ValueError(f"n_iter and refine must be >= 0, got {n_iter}, "
                         f"{refine}")
    B, n = c.shape
    mode = kernel_mode(n_iter, refine, assume_x0_zero)
    lib = _load()
    dev = c.device
    need = lib.copra_admm_box_smem_bytes(n, mode)
    limit = lib.copra_admm_box_max_smem(dev.index)
    if need > limit or n > 1024:
        raise ValueError(
            f"admm_box kernel: n = {n} needs {need} bytes of shared memory "
            f"per block in mode {mode} (operators resident); this device "
            f"allows {limit} bytes and 1024 threads per block")
    outs = [torch.empty_like(c) for _ in range(4)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.copra_admm_box(
            *(t.data_ptr() for t in (Kinv, K, *vecs, *outs)),
            B, n, int(n_iter), int(refine), mode,
            float(sigma), float(alpha), float(1.0 - alpha), float(rho),
            float(1.0 / rho), float(sigma + rho), stream)
    if rc != 0:
        raise RuntimeError(f"admm_box kernel launch failed: CUDA error {rc} "
                           f"({lib.copra_cuda_error_string(rc).decode()})")
    return tuple(outs)


def fused_admm_box_lanes(Kinv: Tensor, K: Tensor, c: Tensor, l: Tensor,
                         u: Tensor, x0: Tensor, y0: Tensor, z0: Tensor, *,
                         n_iter: int, sigma: float, alpha: float, rho: float,
                         refine: int = 0, assume_x0_zero: bool = False
                         ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Box ADMM with a distinct ``Kinv``/``K [B, n, n]`` per lane; vectors
    ``[B, n]`` f32.  Returns ``(x, y, z, g)``, ``g = Q x``.

    ``assume_x0_zero`` (with ``refine == 0``, ``n_iter > 0``) selects the
    K-free body; ``n_iter == 0`` the pure ``g = Q x0`` pass.  CPU tensors
    run :func:`admm_box_plain`; CUDA tensors launch the kernel.
    """
    kw = dict(n_iter=n_iter, sigma=sigma, alpha=alpha, rho=rho,
              refine=refine, assume_x0_zero=assume_x0_zero)
    if Kinv.device.type == "cpu":
        return admm_box_plain(Kinv, K, c, l, u, x0, y0, z0, **kw)
    out = _launch(Kinv, K, c, l, u, x0, y0, z0, **kw)
    fused_admm_box_lanes.launches += 1
    return out


def fused_admm_box(Kinv: Tensor, K: Tensor, c: Tensor, l: Tensor, u: Tensor,
                   x0: Tensor, y0: Tensor, z0: Tensor, *, n_iter: int,
                   sigma: float, alpha: float, rho: float, refine: int = 1
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The per-lane entry point of the reference (same math as
    :func:`fused_admm_box_lanes`, general body); served by the same
    kernel.  The TPU's ``sub_batch`` and ``interpret`` have no meaning
    here."""
    kw = dict(n_iter=n_iter, sigma=sigma, alpha=alpha, rho=rho,
              refine=refine, assume_x0_zero=False)
    if Kinv.device.type == "cpu":
        return admm_box_plain(Kinv, K, c, l, u, x0, y0, z0, **kw)
    out = _launch(Kinv, K, c, l, u, x0, y0, z0, **kw)
    fused_admm_box.launches += 1
    return out


fused_admm_box_lanes.launches = 0
fused_admm_box.launches = 0
