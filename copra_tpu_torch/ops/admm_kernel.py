"""Fixed-count ADMM over a batch of lanes: the plain PyTorch versions and
the wrappers of the hand-written CUDA kernels.

Port of ``copra_tpu/ops/admm_kernel.py``.  Four kernels serve five entry
points:

* ``copra_tpu_torch/csrc/admm_box.cu``: :func:`fused_admm_box_lanes` and
  :func:`fused_admm_box`, box ADMM with a distinct ``Kinv``/``K [B, n, n]``
  per lane (the TPU's ``fused_admm_box_lanes`` bodies
  ``_lanes_box_kernel_z0``, ``_lanes_qx_kernel``, ``_lanes_box_kernel``,
  and ``fused_admm_box``).  What bounds it on an H100 is the bytes of the
  per-lane operators (164 MB for ``Kinv`` at B = 4096, n = 100, three
  times the L2): one thread block per lane stages its operator in shared
  memory once per call.
* ``copra_tpu_torch/csrc/admm_box_shared.cu``: :func:`fused_admm_box_shared`,
  box ADMM where every lane shares one ``Kinv``/``K [n, n]`` (the TPU's
  ``fused_admm_box_shared``).  Each iteration is a ``[B, n] x [n, n]``
  product, so it is bound by f32 arithmetic; a block keeps a tile of 32
  lanes in registers and streams the operators through shared memory.
* ``copra_tpu_torch/csrc/admm_general_shared.cu``:
  :func:`fused_admm_general_shared`, general ADMM with a shared dense
  ``C [m, n]`` and one penalty per row (the TPU's
  ``fused_admm_general_shared``), a dependent chain of small products per
  lane: one warp per lane.
* ``copra_tpu_torch/csrc/admm_general.cu``: :func:`fused_admm_general`,
  general ADMM in x-space with a dense ``C [B, m, n]``, penalties
  ``rho [B, m]`` and ``Kinv [B, n, n]`` per lane (the TPU's
  ``fused_admm_general``), the fixed-count iteration of
  :func:`copra_tpu_torch.qp.admm.solve_qp` with ``kkt_solve="inverse"`` and
  no refinement: one warp per lane, its operators staged in shared memory
  where they fit.

:func:`admm_box_plain` (the counterpart of ``xla_admm_box``, rank-3 or
rank-2 operators), :func:`admm_general_shared_plain` and
:func:`admm_general_plain` are the plain versions.
:func:`solve_qp_batched_fused` is the reference's batched box-only solve
over :func:`fused_admm_box`.

The TPU-only layout machinery is not ported: ``sub_batch``, ``pack_lanes_operator``,
``_pack_lanes_vec``/``_unpack_lanes_vec`` and ``_pad8`` (the lane-major
``[nc, n8, n8, 128]`` packing and its identity pad existed for Mosaic's
vector layout), ``lanes_kernel_fits``/``default_sub_batch`` and
``default_lane_block`` (VMEM budgets), the shared kernels' two interleaved
half-streams (an MXU/VPU overlap), the padding of B with copies of lane 0
(the kernels mask their ragged edge) and the ``COPRA_*`` environment
switches.

A wrapper takes the plain version only for tensors on the CPU.  On a CUDA
tensor it launches its kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .._precision import highest_precision
from ..qp.admm import _inf_norm, _jacobi_inverse, _polish, _tolerances
from ..qp.types import (STATUS_MAX_ITER, STATUS_SOLVED, DenseQP, QPSolution,
                        SolverOptions)
from .build import load_library

Tensor = torch.Tensor

# kernel modes (csrc/admm_box.cu)
MODE_X0_ZERO = 1
MODE_QX = 2
MODE_GENERAL = 3


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
    """Plain PyTorch version of the box kernels (counterpart of
    ``xla_admm_box``): per-lane operators in all three modes of
    ``admm_box.cu``, shared operators in the general mode that
    ``admm_box_shared.cu`` computes.

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


def admm_general_shared_plain(Kinv: Tensor, K: Tensor, C: Tensor,
                              rho_vec: Tensor, l: Tensor, u: Tensor,
                              e0: Tensor, y0: Tensor, z0: Tensor, *,
                              n_iter: int, sigma: float, alpha: float,
                              refine: int = 0
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the shared general kernel: the update order
    of the reference body (``_general_kernel_shared``'s ``one``) on batched
    tensors.  ``Kinv``/``K [n, n]``, ``C [m, n]``, ``rho_vec [m]``;
    ``l``/``u``/``y0``/``z0 [B, m]``, ``e0 [B, n]``.  Returns ``(e, y,
    z)``.

    Each product is summed in float64 and rounded once to the inputs'
    dtype, as the kernel's compensated f32 sums give it: with plain f32
    sums the iteration's rounding leaves config 2's worst lanes ~5e-5 from
    the exact solution (``csrc/admm_general_shared.cu``)."""
    oma = 1.0 - alpha
    rho_inv = 1.0 / rho_vec

    def mm(a: Tensor, b: Tensor) -> Tensor:
        return (a.double() @ b.double()).to(a.dtype)

    e, z, y = e0, z0, y0
    for _ in range(n_iter):
        rhs = sigma * e + mm(rho_vec * z - y, C)
        e_t = mm(rhs, Kinv)
        for _ in range(refine):
            e_t = e_t + mm(rhs - mm(e_t, K), Kinv)
        z_t = mm(e_t, C.mT)
        e = alpha * e_t + oma * e
        z_rel = alpha * z_t + oma * z
        z_n = torch.clamp(z_rel + rho_inv * y, l, u)
        y = y + rho_vec * (z_rel - z_n)
        z = z_n
    return e, y, z


def admm_general_plain(Kinv: Tensor, C: Tensor, c: Tensor, l: Tensor,
                       u: Tensor, rho: Tensor, x0: Tensor, y0: Tensor,
                       z0: Tensor, *, n_iter: int, sigma: float, alpha: float
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the per-lane general kernel: the update
    order of the reference body (``_general_kernel``) on batched tensors.
    ``Kinv [B, n, n]``, ``C [B, m, n]``, ``c``/``x0 [B, n]``,
    ``l``/``u``/``rho``/``y0``/``z0 [B, m]``.  Returns ``(x, y, z)``.

    ``rhs Kinv`` contracts ``Kinv``'s first axis, as the reference does (an
    explicit inverse is symmetric only to rounding).  Products are summed
    in the inputs' dtype, as the kernel's f32 sums."""
    oma = 1.0 - alpha
    rho_inv = 1.0 / rho
    x, z, y = x0, z0, y0
    for _ in range(n_iter):
        rhs = sigma * x - c + _mv(rho * z - y, C)
        x_t = _mv(rhs, Kinv)
        z_t = torch.bmm(C, x_t.unsqueeze(-1)).squeeze(-1)
        x = alpha * x_t + oma * x
        z_rel = alpha * z_t + oma * z
        z_n = torch.clamp(z_rel + rho_inv * y, l, u)
        y = y + rho * (z_rel - z_n)
        z = z_n
    return x, y, z


# ctypes signatures of each kernel library: {symbol: (restype, argtypes)}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "admm_box": {
        "copra_admm_box": (_I, [_P] * 12 + [_I] * 5 + [_F] * 6 + [_P]),
        "copra_admm_box_smem_bytes": (ctypes.c_size_t, [_I, _I]),
        "copra_admm_box_max_smem": (_I, [_I]),
        "copra_admm_box_error_string": (ctypes.c_char_p, [_I]),
    },
    "admm_box_shared": {
        "copra_admm_box_shared": (_I, [_P] * 12 + [_I] * 4 + [_F] * 6
                                  + [_P]),
        "copra_admm_box_shared_smem_bytes": (ctypes.c_size_t, [_I]),
        "copra_admm_box_shared_max_n": (_I, []),
        "copra_admm_box_shared_max_smem": (_I, [_I]),
        "copra_admm_box_shared_error_string": (ctypes.c_char_p, [_I]),
    },
    "admm_general_shared": {
        "copra_admm_general_shared": (_I, [_P] * 12 + [_I] * 5 + [_F] * 3
                                      + [_P]),
        "copra_admm_general_shared_smem_bytes": (ctypes.c_size_t, [_I, _I]),
        "copra_admm_general_shared_max_n": (_I, []),
        "copra_admm_general_shared_max_m": (_I, []),
        "copra_admm_general_shared_max_smem": (_I, [_I]),
        "copra_admm_general_shared_error_string": (ctypes.c_char_p, [_I]),
    },
    "admm_general": {
        "copra_admm_general": (_I, [_P] * 12 + [_I] * 4 + [_F] * 3 + [_I, _P]),
        "copra_admm_general_max_n": (_I, []),
        "copra_admm_general_max_m": (_I, []),
        "copra_admm_general_error_string": (ctypes.c_char_p, [_I]),
    },
}
_loaded = {}


def _load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with its signatures set."""
    lib = _loaded.get(name)
    if lib is None:
        lib = load_library(name)
        for sym, (res, args) in _SIGNATURES[name].items():
            fn = getattr(lib, sym)
            fn.restype, fn.argtypes = res, args
        _loaded[name] = lib
    return lib


def _check(named, dev) -> None:
    """Each ``(name, tensor, shape)`` lies on ``dev``, is float32,
    contiguous and of ``shape``."""
    for name, t, shape in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _vec_shape(v: Tensor) -> Tuple[int, int]:
    if v.dim() != 2 or v.shape[0] < 1 or v.shape[1] < 1:
        raise ValueError(f"vectors must be [B, n] with B, n >= 1, got "
                         f"{tuple(v.shape)}")
    return tuple(v.shape)


def _counts(n_iter: int, refine: int) -> None:
    if n_iter < 0 or refine < 0:
        raise ValueError(f"n_iter and refine must be >= 0, got {n_iter}, "
                         f"{refine}")


def _raise_on(rc: int, lib, sym: str) -> None:
    if rc != 0:
        msg = getattr(lib, f"{sym}_error_string")(rc).decode()
        raise RuntimeError(f"{sym} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


_BOX_VECS = ("c", "l", "u", "x0", "y0", "z0")


def _launch(Kinv, K, c, l, u, x0, y0, z0, *, n_iter, sigma, alpha, rho,
            refine, assume_x0_zero):
    vecs = (c, l, u, x0, y0, z0)
    if Kinv.dim() != 3 or K.dim() != 3:
        raise ValueError(
            f"operators must be per lane, [B, n, n], got {tuple(Kinv.shape)}"
            f" and {tuple(K.shape)}; shared [n, n] operators go to "
            f"fused_admm_box_shared")
    B, n = _vec_shape(c)
    dev = Kinv.device
    _check((("Kinv", Kinv, (B, n, n)), ("K", K, (B, n, n)),
            *((nm, v, (B, n)) for nm, v in zip(_BOX_VECS, vecs))), dev)
    _counts(n_iter, refine)
    mode = kernel_mode(n_iter, refine, assume_x0_zero)
    lib = _load("admm_box")
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
    _raise_on(rc, lib, "copra_admm_box")
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


def _launch_box_shared(Kinv, K, c, l, u, x0, y0, z0, *, n_iter, sigma,
                       alpha, rho, refine):
    vecs = (c, l, u, x0, y0, z0)
    B, n = _vec_shape(c)
    dev = Kinv.device
    _check((("Kinv", Kinv, (n, n)), ("K", K, (n, n)),
            *((nm, v, (B, n)) for nm, v in zip(_BOX_VECS, vecs))), dev)
    _counts(n_iter, refine)
    lib = _load("admm_box_shared")
    need = lib.copra_admm_box_shared_smem_bytes(n)
    limit = lib.copra_admm_box_shared_max_smem(dev.index)
    widest = lib.copra_admm_box_shared_max_n()
    if n > widest or need > limit:
        raise ValueError(
            f"admm_box_shared kernel: n = {n} needs {need} bytes of shared "
            f"memory per block; it takes n <= {widest} and this device "
            f"allows {limit} bytes")
    outs = [torch.empty_like(c) for _ in range(4)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.copra_admm_box_shared(
            *(t.data_ptr() for t in (Kinv, K, *vecs, *outs)),
            B, n, int(n_iter), int(refine),
            float(sigma), float(alpha), float(1.0 - alpha), float(rho),
            float(1.0 / rho), float(sigma + rho), stream)
    _raise_on(rc, lib, "copra_admm_box_shared")
    return tuple(outs)


def fused_admm_box_shared(Kinv: Tensor, K: Tensor, c: Tensor, l: Tensor,
                          u: Tensor, x0: Tensor, y0: Tensor, z0: Tensor, *,
                          n_iter: int, sigma: float, alpha: float,
                          rho: float, refine: int = 0
                          ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Box ADMM for SHARED operators: ``Kinv``/``K [n, n]`` serve every
    lane; vectors ``[B, n]`` f32.  Returns ``(x, y, z, g)`` with ``g = x K
    - (sigma + rho) x``, always from ``K``.  CPU tensors run
    :func:`admm_box_plain` (general mode); CUDA tensors launch
    ``csrc/admm_box_shared.cu``.  The TPU's ``lane_block`` and
    ``interpret`` have no meaning here."""
    kw = dict(n_iter=n_iter, sigma=sigma, alpha=alpha, rho=rho,
              refine=refine)
    if Kinv.device.type == "cpu":
        return admm_box_plain(Kinv, K, c, l, u, x0, y0, z0, **kw)
    out = _launch_box_shared(Kinv, K, c, l, u, x0, y0, z0, **kw)
    fused_admm_box_shared.launches += 1
    return out


def _launch_general_shared(Kinv, K, C, rho_vec, l, u, e0, y0, z0, *,
                           n_iter, sigma, alpha, refine):
    B, m = _vec_shape(l)
    n = Kinv.shape[-1] if Kinv.dim() == 2 else -1
    dev = Kinv.device
    _check((("Kinv", Kinv, (n, n)), ("K", K, (n, n)), ("C", C, (m, n)),
            ("rho_vec", rho_vec, (m,)), ("l", l, (B, m)), ("u", u, (B, m)),
            ("e0", e0, (B, n)), ("y0", y0, (B, m)), ("z0", z0, (B, m))),
           dev)
    _counts(n_iter, refine)
    lib = _load("admm_general_shared")
    need = lib.copra_admm_general_shared_smem_bytes(n, m)
    limit = lib.copra_admm_general_shared_max_smem(dev.index)
    max_n = lib.copra_admm_general_shared_max_n()
    max_m = lib.copra_admm_general_shared_max_m()
    if n > max_n or m > max_m or need > limit:
        raise ValueError(
            f"admm_general_shared kernel: (n, m) = ({n}, {m}) needs {need} "
            f"bytes of shared memory per block; it takes n <= {max_n}, "
            f"m <= {max_m} and this device allows {limit} bytes")
    outs = (torch.empty_like(e0), torch.empty_like(y0), torch.empty_like(z0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.copra_admm_general_shared(
            *(t.data_ptr() for t in (Kinv, K, C, rho_vec, l, u, e0, y0, z0,
                                     *outs)),
            B, n, m, int(n_iter), int(refine),
            float(sigma), float(alpha), float(1.0 - alpha), stream)
    _raise_on(rc, lib, "copra_admm_general_shared")
    return outs


def fused_admm_general_shared(Kinv: Tensor, K: Tensor, C: Tensor,
                              rho_vec: Tensor, l: Tensor, u: Tensor,
                              e0: Tensor, y0: Tensor, z0: Tensor, *,
                              n_iter: int, sigma: float, alpha: float,
                              refine: int = 0
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    """General ADMM for SHARED operators: ``Kinv``/``K [n, n]``, ``C [m,
    n]`` and ``rho_vec [m]`` serve every lane; ``l``/``u``/``y0``/``z0 [B,
    m]``, ``e0 [B, n]``, all f32.  Returns ``(e, y, z)``.  CPU tensors run
    :func:`admm_general_shared_plain`; CUDA tensors launch
    ``csrc/admm_general_shared.cu``."""
    kw = dict(n_iter=n_iter, sigma=sigma, alpha=alpha, refine=refine)
    if Kinv.device.type == "cpu":
        return admm_general_shared_plain(Kinv, K, C, rho_vec, l, u, e0, y0,
                                         z0, **kw)
    out = _launch_general_shared(Kinv, K, C, rho_vec, l, u, e0, y0, z0, **kw)
    fused_admm_general_shared.launches += 1
    return out


def _launch_general(Kinv, C, c, l, u, rho, x0, y0, z0, *, n_iter, sigma,
                    alpha):
    if C.dim() != 3:
        raise ValueError(
            f"C must be per lane, [B, m, n], got {tuple(C.shape)}; a shared "
            f"[m, n] matrix goes to fused_admm_general_shared")
    B, m, n = C.shape
    dev = Kinv.device
    _check((("Kinv", Kinv, (B, n, n)), ("C", C, (B, m, n)), ("c", c, (B, n)),
            ("l", l, (B, m)), ("u", u, (B, m)), ("rho", rho, (B, m)),
            ("x0", x0, (B, n)), ("y0", y0, (B, m)), ("z0", z0, (B, m))), dev)
    _counts(n_iter, 0)
    lib = _load("admm_general")
    max_n = lib.copra_admm_general_max_n()
    max_m = lib.copra_admm_general_max_m()
    if B < 1 or n < 1 or m < 1 or n > max_n or m > max_m:
        raise ValueError(
            f"admm_general kernel: (B, n, m) = ({B}, {n}, {m}); it takes "
            f"B, n, m >= 1, n <= {max_n} and m <= {max_m}")
    outs = (torch.empty_like(x0), torch.empty_like(y0), torch.empty_like(z0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.copra_admm_general(
            *(t.data_ptr() for t in (Kinv, C, c, l, u, rho, x0, y0, z0,
                                     *outs)),
            B, n, m, int(n_iter), float(sigma), float(alpha),
            float(1.0 - alpha), dev.index, stream)
    _raise_on(rc, lib, "copra_admm_general")
    return outs


def fused_admm_general(Kinv: Tensor, C: Tensor, c: Tensor, l: Tensor,
                       u: Tensor, rho: Tensor, x0: Tensor, y0: Tensor,
                       z0: Tensor, *, n_iter: int, sigma: float,
                       alpha: float) -> Tuple[Tensor, Tensor, Tensor]:
    """General fused ADMM with operators PER LANE: ``Kinv [B, n, n]``,
    ``C [B, m, n]``, ``c``/``x0 [B, n]``, ``l``/``u``/``rho``/``y0``/``z0
    [B, m]``, all f32, n <= 128 and m <= 384.  Returns ``(x, y, z)``.  CPU
    tensors run :func:`admm_general_plain`; CUDA tensors launch
    ``csrc/admm_general.cu``.  The TPU's ``sub_batch`` and ``interpret``
    have no meaning here."""
    kw = dict(n_iter=n_iter, sigma=sigma, alpha=alpha)
    if Kinv.device.type == "cpu":
        return admm_general_plain(Kinv, C, c, l, u, rho, x0, y0, z0, **kw)
    out = _launch_general(Kinv, C, c, l, u, rho, x0, y0, z0, **kw)
    fused_admm_general.launches += 1
    return out


@highest_precision
def solve_qp_batched_fused(qp: DenseQP, options=None, warm_start=None
                           ) -> QPSolution:
    """Batched box-only QP solve through the fused kernel
    (:func:`fused_admm_box`, ``refine=1``).

    Drop-in for ``solve_qp_batched`` when the QPs have no eq/ineq rows,
    ``early_exit=False`` semantics are acceptable, and f32 is the compute
    dtype: the production receding-horizon configuration.  Residuals,
    status, and (optional) polish run vectorized outside the kernel.
    """
    options = options or SolverOptions()
    if qp.nr_eq or qp.nr_ineq:
        raise ValueError("fused batched path is box-only; use solve_qp_"
                         "batched for general constraint rows.")
    Q = qp.Q
    if Q.dim() != 3:
        raise ValueError("expected a batched QP (Q of rank 3).")
    B, n, _ = Q.shape
    dt, dev = torch.float32, Q.device
    Q = Q.to(dt)
    c = qp.c.expand(B, n).to(dt).contiguous()
    lb = qp.lb.expand(B, n).to(dt).contiguous()
    ub = qp.ub.expand(B, n).to(dt).contiguous()

    sigma, rho, alpha = options.sigma, options.rho, options.alpha
    K = (Q + (sigma + rho) * torch.eye(n, dtype=dt, device=dev)).contiguous()
    # symmetric Jacobi preconditioning, as in solve_qp
    Kinv = _jacobi_inverse(K).contiguous()

    if warm_start is not None:
        x0, y0, z0 = (getattr(warm_start, f).to(dt).contiguous()
                      for f in ("x", "y", "z"))
    else:
        x0 = y0 = z0 = torch.zeros((B, n), dtype=dt, device=dev)

    x, y, z, gq = fused_admm_box(
        Kinv, K, c, lb, ub, x0, y0, z0, n_iter=options.max_iter,
        sigma=sigma, alpha=alpha, rho=rho, refine=1)

    if options.polish:
        one = DenseQP(Q=Q, c=c, Aeq=qp.Aeq.to(dt), beq=qp.beq.to(dt),
                      Aineq=qp.Aineq.to(dt), bineq=qp.bineq.to(dt), lb=lb,
                      ub=ub)
        x, y = _polish(one, torch.eye(n, dtype=dt, device=dev), lb, ub, x, y,
                       z, options)
        z = torch.clamp(x, lb, ub)
        # polish replaced x, so the kernel's Q x no longer holds
        gq = torch.bmm(Q, x.unsqueeze(-1)).squeeze(-1)

    # unscaled residuals (C = I)
    r_prim = _inf_norm(x - z)
    r_dual = _inf_norm(gq + c + y)
    eps_abs, eps_rel = _tolerances(options, dt)
    scale_p = torch.maximum(_inf_norm(x), _inf_norm(z))
    # dual scale follows the OSQP convention max(|Qx|, |C'y|, |c|): the
    # gradient TERMS, never the gradient itself.  C = I on this box-only
    # path, so C'y = y.
    scale_d = torch.maximum(_inf_norm(gq),
                            torch.maximum(_inf_norm(y), _inf_norm(c)))
    conv = ((r_prim <= eps_abs + eps_rel * scale_p)
            & (r_dual <= eps_abs + eps_rel * scale_d))
    status = torch.where(conv, STATUS_SOLVED, STATUS_MAX_ITER).to(torch.int32)
    iters = torch.full((B,), options.max_iter, dtype=torch.int32, device=dev)
    return QPSolution(x=x, y=y, z=z, status=status, iterations=iters,
                      primal_residual=r_prim, dual_residual=r_dual)


fused_admm_box_lanes.launches = 0
fused_admm_box.launches = 0
fused_admm_box_shared.launches = 0
fused_admm_general_shared.launches = 0
fused_admm_general.launches = 0
