"""Fixed-count ADMM over a batch of lanes: the plain PyTorch versions and
the wrappers of the hand-written CUDA kernels.

Port of ``copra_tpu/ops/admm_kernel.py``.  Four kernels serve five entry
points:

* ``copra_tpu_torch/csrc/admm_box.cu``: :func:`fused_admm_box_lanes` and
  :func:`fused_admm_box`, box ADMM with a distinct ``Kinv``/``K [B, n, n]``
  per lane (the TPU's ``fused_admm_box_lanes`` bodies
  ``_lanes_box_kernel_z0``, ``_lanes_qx_kernel``, ``_lanes_box_kernel``,
  and ``fused_admm_box``), n <= 1024.  What bounds it on an H100 is the
  bytes of the per-lane operators (164 MB for ``Kinv`` at B = 4096, n =
  100, three times the L2): a block per lane, up to n = 128 with the
  lane's ``Kinv`` loaded once into registers, above that streamed from
  device memory every product (:func:`box_lanes_config`).
* ``copra_tpu_torch/csrc/admm_box_shared.cu``: :func:`fused_admm_box_shared`,
  box ADMM where every lane shares one ``Kinv``/``K [n, n]`` (the TPU's
  ``fused_admm_box_shared``), n <= 1024.  Each iteration is a ``[B, n] x
  [n, n]`` product: up to n = 32 a group of threads per lane with no block
  barrier, above that a block per lane tile fed by bulk TMA copies of
  operator slices (:func:`box_shared_config`).
* ``copra_tpu_torch/csrc/admm_general_shared.cu``:
  :func:`fused_admm_general_shared`, general ADMM with a shared dense
  ``C [m, n]`` and one penalty per row (the TPU's
  ``fused_admm_general_shared``), n <= 256 and m <= 1024, a dependent
  chain of small products per lane summed in f64: a group of 8 threads
  per lane up to n = 16, m = 96 (config 2), a warp per lane with the
  operators read from L2 above (:func:`general_shared_config`).
* ``copra_tpu_torch/csrc/admm_general.cu``: :func:`fused_admm_general`,
  general ADMM in x-space with a dense ``C [B, m, n]``, penalties
  ``rho [B, m]`` and ``Kinv [B, n, n]`` per lane (the TPU's
  ``fused_admm_general``), the fixed-count iteration of
  :func:`copra_tpu_torch.qp.admm.solve_qp` with ``kkt_solve="inverse"`` and
  no refinement, n <= 256 and m <= 1024: up to n = 16, m = 96 (config 2) a
  group of 16 threads per lane with the lane's rows of ``C``, its ``Kinv``
  columns and its state in registers, a warp per lane above
  (:func:`general_lanes_config`).

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
import itertools
from typing import Tuple

import torch

from .._precision import highest_precision
from ..qp.admm import _inf_norm, _jacobi_inverse, _polish, _tolerances
from ..qp.types import (STATUS_MAX_ITER, STATUS_SOLVED, DenseQP, QPSolution,
                        SolverOptions)
from .build import load_library
from .counts import counted

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
    dtype, as the kernel's f64 sums give it: with plain f32 sums the
    iteration's rounding leaves config 2's worst lanes ~5e-5 from the
    exact solution (``csrc/admm_general_shared.cu``)."""
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
        "copra_admm_box": (_I, [_P] * 12 + [_I] * 6 + [_F] * 6 + [_P]),
        "copra_admm_box_config": (_I, [_I, _I, _I, _I, _P]),
        "copra_admm_box_attributes": (_I, [_I, _I, _I, _I, _P]),
        "copra_admm_box_max_smem": (_I, [_I]),
        "copra_admm_box_prepare": (_I, []),
        "copra_admm_box_error_string": (ctypes.c_char_p, [_I]),
    },
    "admm_box_shared": {
        "copra_admm_box_shared": (_I, [_P] * 12 + [_I] * 4 + [_F] * 6
                                  + [_I, _P]),
        "copra_admm_box_shared_config": (_I, [_I, _I, _P]),
        "copra_admm_box_shared_max_smem": (_I, [_I]),
        "copra_admm_box_shared_prepare": (_I, []),
        "copra_admm_box_shared_error_string": (ctypes.c_char_p, [_I]),
    },
    "admm_general_shared": {
        "copra_admm_general_shared": (_I, [_P] * 12 + [_I] * 5 + [_F] * 3
                                      + [_I, _P]),
        "copra_admm_general_shared_config": (_I, [_I, _I, _I, _P]),
        "copra_admm_general_shared_max_smem": (_I, [_I]),
        "copra_admm_general_shared_prepare": (_I, []),
        "copra_admm_general_shared_error_string": (ctypes.c_char_p, [_I]),
    },
    "admm_general": {
        "copra_admm_general": (_I, [_P] * 12 + [_I] * 5 + [_F] * 3 + [_P]),
        "copra_admm_general_config": (_I, [_I, _I, _I, _P]),
        "copra_admm_general_attributes": (_I, [_I, _I, _I, _P]),
        "copra_admm_general_error_string": (ctypes.c_char_p, [_I]),
    },
}
_loaded = {}


def _load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with its signatures set; the
    launch plans of the ADMM kernels are checked against this module's
    mirrors (:func:`box_lanes_config`, :func:`box_shared_config`,
    :func:`general_shared_config`, :func:`general_lanes_config`)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = load_library(name)
        for sym, (res, args) in _SIGNATURES[name].items():
            fn = getattr(lib, sym)
            fn.restype, fn.argtypes = res, args
        check = _PLAN_CHECKS.get(name)
        if check is not None:
            check(lib)
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


_smem_limits = {}


def _max_smem(lib, sym: str, dev) -> int:
    """``lib.<sym>(dev.index)``, the dynamic shared memory a block may opt
    into on ``dev``, queried once per library and device.  The first query
    also runs the library's ``..._prepare`` on ``dev``, which opts every
    kernel into that memory, so that no launch sets an attribute (a
    captured launch is one kernel node)."""
    key = (sym, dev.index)
    if key not in _smem_limits:
        prep = sym.replace("_max_smem", "_prepare")
        with torch.cuda.device(dev):
            rc = getattr(lib, prep)()
        if rc != 0:
            msg = getattr(lib, sym.replace("_max_smem", "_error_string"))(
                rc).decode()
            raise RuntimeError(f"{prep} failed: CUDA error {rc} ({msg})")
        _smem_limits[key] = getattr(lib, sym)(dev.index)
    return _smem_limits[key]


def _raise_on(rc: int, lib, sym: str) -> None:
    if rc != 0:
        msg = getattr(lib, f"{sym}_error_string")(rc).decode()
        raise RuntimeError(f"{sym} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


_BOX_VECS = ("c", "l", "u", "x0", "y0", "z0")


BOX_LANES_MAX_N = 1024
BOX_REGISTER_MAX_N = 128   # widest n of the register body
BOX_LANES_BODIES = {"register": 1, "streamed": 2, "qx": 3}
_STREAM_THREADS = 256


def box_lanes_config(n: int, mode: int, refine: int = 0, body: str = "auto"
                     ) -> Tuple[int, int, int, int]:
    """The launch plan of ``csrc/admm_box.cu`` at width ``n`` in kernel
    ``mode`` (:func:`kernel_mode`) with ``refine`` steps (mirrored by
    ``make_config`` there and checked when the library loads): ``(body,
    chunks, threads, smem_bytes)``, one block per lane.

    The Q x pass (``MODE_QX``) takes body "qx" (3): a thread per
    coordinate (``threads`` = n rounded to 32), the vector in shared
    memory.  The iterating modes take "register" (1) up to n =
    ``BOX_REGISTER_MAX_N`` and "streamed" (2) above; either can be forced
    where it takes the width.  ``chunks`` = ceil(n / 16): a thread owns a
    column quad and ``chunks`` row chunks of 4.  Register body: n rounded
    to 32 threads holding ``Kinv`` in registers, two product buffers of
    ``16 chunks`` floats, and ``K`` staged in shared memory (``16 chunks``
    rows of ``threads`` floats) in ``MODE_GENERAL`` with ``refine >= 1``.
    Streamed body: 256 threads, the operators read from device memory
    every product, two buffers of ``16 chunks`` floats."""
    if not 1 <= n <= BOX_LANES_MAX_N:
        raise ValueError(f"admm_box kernel takes 1 <= n <= "
                         f"{BOX_LANES_MAX_N}, got n = {n}; {_USE_PLAIN}")
    if body != "auto" and body not in BOX_LANES_BODIES:
        raise ValueError(f"body must be 'auto', 'register', 'streamed' or "
                         f"'qx', got {body!r}")
    if mode == MODE_QX:
        if body not in ("auto", "qx"):
            raise ValueError(f"the Q x pass has one body, got {body!r}")
        return (3, 0, _round_up(n, 32), 4 * n)
    if mode not in (MODE_X0_ZERO, MODE_GENERAL) or body == "qx":
        raise ValueError(f"admm_box kernel: body {body!r} does not serve "
                         f"mode {mode}")
    chunks = -(-n // 16)
    if body == "auto":
        body = "register" if n <= BOX_REGISTER_MAX_N else "streamed"
    vectors = 4 * 2 * 16 * chunks
    if body == "register":
        if n > BOX_REGISTER_MAX_N:
            raise ValueError(f"the register body takes n <= "
                             f"{BOX_REGISTER_MAX_N}, got n = {n}")
        threads = _round_up(n, 32)
        staged = mode == MODE_GENERAL and refine > 0
        return (1, chunks, threads,
                vectors + (4 * 16 * chunks * threads if staged else 0))
    return (2, chunks, _STREAM_THREADS, vectors)


def _check_box_lanes_plans(lib) -> None:
    for n, (mode, refine), body in itertools.product(
            range(1, BOX_LANES_MAX_N + 1),
            ((MODE_X0_ZERO, 0), (MODE_QX, 0), (MODE_GENERAL, 0),
             (MODE_GENERAL, 1)), ("auto", *BOX_LANES_BODIES)):
        out = (ctypes.c_int * 4)()
        rc = lib.copra_admm_box_config(n, mode, refine,
                                       BOX_LANES_BODIES.get(body, 0), out)
        try:
            want = box_lanes_config(n, mode, refine, body)
        except ValueError:
            want = None
        if (rc != 0) != (want is None) or (want is not None
                                          and tuple(out) != want):
            raise RuntimeError(
                f"csrc/admm_box.cu's launch plan for n = {n}, mode {mode}, "
                f"refine {refine}, body {body} is {tuple(out)} (rc {rc}), "
                f"not {want}")


def _box_lanes_attributes(n: int, mode: int, refine: int = 0,
                          body: str = "auto") -> Tuple[int, int, int, int]:
    """``(registers a thread, spill bytes a thread, largest block, blocks
    an SM holds)`` of the compiled kernel that serves the plan
    (``cudaFuncGetAttributes``, the occupancy calculator)."""
    box_lanes_config(n, mode, refine, body)
    lib = _load("admm_box")
    _max_smem(lib, "copra_admm_box_max_smem",
              torch.device("cuda", torch.cuda.current_device()))
    out = (ctypes.c_int * 4)()
    _raise_on(lib.copra_admm_box_attributes(
        n, mode, refine, BOX_LANES_BODIES.get(body, 0), out), lib,
        "copra_admm_box")
    return tuple(out)


def _launch(Kinv, K, c, l, u, x0, y0, z0, *, n_iter, sigma, alpha, rho,
            refine, assume_x0_zero, body="auto"):
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
    cfg = box_lanes_config(n, mode, refine, body)
    lib = _load("admm_box")
    limit = _max_smem(lib, "copra_admm_box_max_smem", dev)
    if cfg[-1] > limit:
        raise ValueError(
            f"admm_box kernel: n = {n} needs {cfg[-1]} bytes of shared "
            f"memory per block in mode {mode}; this device allows {limit} "
            f"bytes")
    outs = [torch.empty_like(c) for _ in range(4)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.copra_admm_box(
            *(t.data_ptr() for t in (Kinv, K, *vecs, *outs)),
            B, n, int(n_iter), int(refine), mode,
            BOX_LANES_BODIES.get(body, 0),
            float(sigma), float(alpha), float(1.0 - alpha), float(rho),
            float(1.0 / rho), float(sigma + rho), stream)
    _raise_on(rc, lib, "copra_admm_box")
    return tuple(outs)


@counted
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


@counted
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


SMEM_LIMIT = 232448      # shared memory one H100 block may use (227 KB)
BOX_SHARED_MAX_N = 1024
BOX_SMALL_MAX_N = 32     # widest n of K3's small body
BOX_BODIES = {"small": 1, "tile": 2}
_BOX_MAX_STAGES, _BOX_MAX_ROWS, _BOX_SMALL_THREADS = 4, 32, 64
_USE_PLAIN = ("serve it with use_fused=False (the plain iteration) "
              "instead")


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def box_shared_config(n: int, body: str = "auto"
                      ) -> Tuple[int, int, int, int, int, int, int, int, int]:
    """The launch plan of ``csrc/admm_box_shared.cu`` at width ``n``
    (mirrored by ``make_config`` there and checked when the library loads):
    ``(body, a, b, lanes, threads, rows, stages, stage_words,
    smem_bytes)``.

    ``body`` "auto" takes the small body for ``n <= BOX_SMALL_MAX_N`` and
    the tile body above.  Small body (1): ``a = G`` threads per lane, the
    least power of two that gives a thread ``b = P <= 4`` coordinates and
    ``n P <= 64`` Kinv entries in registers; 64 threads a block; ``Kinv``
    and ``K`` staged in shared memory.  Tile body (2): a block of
    ``lanes`` = 32, 16 or 8 lanes (by ``n`` rounded to 64: up to 256, 512,
    1024), threads of 4 lanes x 8 columns, a warp covering ``a`` lane
    groups x ``b`` column groups; beside the left-operand tiles and c, l,
    u, a ring of ``rows`` operator rows a stage (the most, a multiple of 4
    and at most 32, for which two stages fit in ``SMEM_LIMIT``) and as
    many stages as fit, at most 4."""
    if not 1 <= n <= BOX_SHARED_MAX_N:
        raise ValueError(f"admm_box_shared kernel takes 1 <= n <= "
                         f"{BOX_SHARED_MAX_N}, got n = {n}; {_USE_PLAIN}")
    if body == "auto":
        body = "small" if n <= BOX_SMALL_MAX_N else "tile"
    if body not in BOX_BODIES:
        raise ValueError(f"body must be 'auto', 'small' or 'tile', got "
                         f"{body!r}")
    if body == "small":
        if n > BOX_SMALL_MAX_N:
            raise ValueError(f"the small body takes n <= {BOX_SMALL_MAX_N},"
                             f" got n = {n}")
        g = 1
        while -(-n // g) > 4 or n * -(-n // g) > 64:
            g *= 2
        return (1, g, -(-n // g), _BOX_SMALL_THREADS // g,
                _BOX_SMALL_THREADS, 0, 0, 0, 8 * n * n)
    np64 = _round_up(n, 64)
    lanes = 32 if np64 <= 256 else 16 if np64 <= 512 else 8
    lg = lanes // 4
    lw = min(lg, 4)
    cw = 32 // lw
    npad = _round_up(n, 8 * cw)
    threads = lg * (npad // 8)
    sp = _round_up(n, 4)
    slack = npad - sp
    budget = SMEM_LIMIT - 4 * (2 * n * lanes + 96 * threads)
    rows = min(_BOX_MAX_ROWS, sp)
    while rows > 4 and 2 * (4 * (rows * sp + slack) + 16) > budget:
        rows -= 4
    stage_words = rows * sp + slack
    stages = min(_BOX_MAX_STAGES, budget // (4 * stage_words + 16))
    return (2, lw, cw, lanes, threads, rows, stages, stage_words,
            SMEM_LIMIT - budget + stages * (4 * stage_words + 16))


def _check_box_plans(lib) -> None:
    for n in range(1, BOX_SHARED_MAX_N + 1):
        for body in (("small", "tile") if n <= BOX_SMALL_MAX_N
                     else ("tile",)):
            out = (ctypes.c_int * 9)()
            rc = lib.copra_admm_box_shared_config(n, BOX_BODIES[body], out)
            want = box_shared_config(n, body)
            if rc != 0 or tuple(out) != want:
                raise RuntimeError(
                    f"csrc/admm_box_shared.cu's launch plan for n = {n} "
                    f"({body}) is {tuple(out)} (rc {rc}), not {want}")


def _launch_box_shared(Kinv, K, c, l, u, x0, y0, z0, *, n_iter, sigma,
                       alpha, rho, refine, body="auto"):
    vecs = (c, l, u, x0, y0, z0)
    B, n = _vec_shape(c)
    dev = Kinv.device
    _check((("Kinv", Kinv, (n, n)), ("K", K, (n, n)),
            *((nm, v, (B, n)) for nm, v in zip(_BOX_VECS, vecs))), dev)
    _counts(n_iter, refine)
    cfg = box_shared_config(n, body)
    lib = _load("admm_box_shared")
    limit = _max_smem(lib, "copra_admm_box_shared_max_smem", dev)
    if cfg[-1] > limit:
        raise ValueError(
            f"admm_box_shared kernel: n = {n} needs {cfg[-1]} bytes of "
            f"shared memory per block; this device allows {limit} bytes")
    outs = [torch.empty_like(c) for _ in range(4)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.copra_admm_box_shared(
            *(t.data_ptr() for t in (Kinv, K, *vecs, *outs)),
            B, n, int(n_iter), int(refine),
            float(sigma), float(alpha), float(1.0 - alpha), float(rho),
            float(1.0 / rho), float(sigma + rho), BOX_BODIES.get(body, 0),
            stream)
    _raise_on(rc, lib, "copra_admm_box_shared")
    return tuple(outs)


@counted
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


GENERAL_SHARED_MAX_N, GENERAL_SHARED_MAX_M = 256, 1024
GENERAL_BODIES = {"group": 1, "wide": 2}
_GEN_WIDE_WARPS = 4
_GEN_GROUP, _GEN_GROUP_THREADS, _GEN_GROUP_COLS = 8, 128, 16
_GEN_GROUP_MAX_ROWS = 12   # rows a thread of the group body, at most


def general_shared_config(n: int, m: int, body: str = "auto"
                          ) -> Tuple[int, int, int, int, int]:
    """The launch plan of ``csrc/admm_general_shared.cu`` at ``(n, m)``
    (mirrored by ``make_config`` there and checked when the library loads):
    ``(body, row_slots, col_slots, lanes_per_block, smem_bytes)``.

    ``body`` "auto" takes "group" (1) for n <= 16, m <= 96: a lane per
    group of 8 threads, thread g owning rows g + 8 r (``row_slots`` = 4, 8
    or 12) and the column vectors whole (``col_slots``: n rounded to 4), 16
    lanes a block, C (rows padded to an even length), Kinv and K staged in
    f64 and rho, 1 / rho in f32.  Every other shape takes "wide" (2; up to
    n = 256, m = 1024): a warp per lane, 4 a block, the lane's vectors in
    its warp's slice of shared memory (an f64 buffer of ``max(m, n)``,
    five f32 row vectors and four column vectors, rounded to 16 bytes),
    the operators read from device memory; ``row_slots = col_slots =
    0``."""
    if not (1 <= n <= GENERAL_SHARED_MAX_N and 1 <= m <= GENERAL_SHARED_MAX_M):
        raise ValueError(
            f"admm_general_shared kernel takes 1 <= n <= "
            f"{GENERAL_SHARED_MAX_N} and 1 <= m <= {GENERAL_SHARED_MAX_M}, "
            f"got (n, m) = ({n}, {m}); {_USE_PLAIN}")
    group = n <= _GEN_GROUP_COLS and m <= _GEN_GROUP * _GEN_GROUP_MAX_ROWS
    if body == "auto":
        body = "group" if group else "wide"
    if body not in GENERAL_BODIES or (body == "group" and not group):
        raise ValueError(f"admm_general_shared kernel: body {body!r} does "
                         f"not take (n, m) = ({n}, {m})")
    if body == "group":
        rs = 4
        while m > _GEN_GROUP * rs:
            rs += 4
        smem = 8 * (m * _round_up(n, 2) + 2 * n * n) + 8 * m
        return (1, rs, _round_up(n, 4), _GEN_GROUP_THREADS // _GEN_GROUP,
                smem)
    per_warp = _round_up(8 * max(m, n) + 4 * (5 * m + 4 * n), 16)
    return (2, 0, 0, _GEN_WIDE_WARPS, _GEN_WIDE_WARPS * per_warp)


# m at which _load checks the plans of every n <= 256 against the C++: both
# sides of each multiple of 8 up to the group body's edge (96), then the
# wide body's up to the envelope's (1024)
_GENERAL_CHECKED_M = (1, *(m + d for m in range(8, 97, 8) for d in (0, 1)),
                      128, 255, 256, 257, 512, 1023, 1024)


def _check_general_plans(lib) -> None:
    for n, m in itertools.product(range(1, GENERAL_SHARED_MAX_N + 1),
                                  _GENERAL_CHECKED_M):
        for body in ("auto", *GENERAL_BODIES):
            out = (ctypes.c_int * 5)()
            rc = lib.copra_admm_general_shared_config(
                n, m, GENERAL_BODIES.get(body, 0), out)
            try:
                want = general_shared_config(n, m, body)
            except ValueError:
                want = None
            if (rc != 0) != (want is None) or (want is not None
                                              and tuple(out) != want):
                raise RuntimeError(
                    f"csrc/admm_general_shared.cu's launch plan for (n, m) "
                    f"= ({n}, {m}), body {body}, is {tuple(out)} (rc {rc}),"
                    f" not {want}")


def _launch_general_shared(Kinv, K, C, rho_vec, l, u, e0, y0, z0, *,
                           n_iter, sigma, alpha, refine, body="auto"):
    B, m = _vec_shape(l)
    n = Kinv.shape[-1] if Kinv.dim() == 2 else -1
    dev = Kinv.device
    _check((("Kinv", Kinv, (n, n)), ("K", K, (n, n)), ("C", C, (m, n)),
            ("rho_vec", rho_vec, (m,)), ("l", l, (B, m)), ("u", u, (B, m)),
            ("e0", e0, (B, n)), ("y0", y0, (B, m)), ("z0", z0, (B, m))),
           dev)
    _counts(n_iter, refine)
    cfg = general_shared_config(n, m, body)
    lib = _load("admm_general_shared")
    limit = _max_smem(lib, "copra_admm_general_shared_max_smem", dev)
    if cfg[-1] > limit:
        raise ValueError(
            f"admm_general_shared kernel: (n, m) = ({n}, {m}) needs "
            f"{cfg[-1]} bytes of shared memory per block; this device "
            f"allows {limit} bytes")
    outs = (torch.empty_like(e0), torch.empty_like(y0), torch.empty_like(z0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.copra_admm_general_shared(
            *(t.data_ptr() for t in (Kinv, K, C, rho_vec, l, u, e0, y0, z0,
                                     *outs)),
            B, n, m, int(n_iter), int(refine),
            float(sigma), float(alpha), float(1.0 - alpha),
            GENERAL_BODIES.get(body, 0), stream)
    _raise_on(rc, lib, "copra_admm_general_shared")
    return outs


@counted
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


GENERAL_LANES_MAX_N, GENERAL_LANES_MAX_M = 256, 1024
GENERAL_LANES_BODIES = {"register": 1, "wide": 2}
_LANE_GROUP, _LANE_THREADS = 16, 128
_LANE_REG_MAX_N, _LANE_REG_MAX_M = 16, 96


def general_lanes_config(n: int, m: int, body: str = "auto"
                         ) -> Tuple[int, int, int, int, int, int]:
    """The launch plan of ``csrc/admm_general.cu`` at ``(n, m)`` (mirrored
    by ``make_config`` there and checked when the library loads):
    ``(body, row_slots, col_slots, lanes_per_block, threads,
    smem_bytes)``.

    ``body`` "auto" takes "register" (1) for n <= 16, m <= 96 (config 2's
    class): a lane per group of 16 threads, 8 lanes a 128-thread block,
    thread g owning rows g + 16 r of the lane's ``C`` (``row_slots`` = 2,
    4 or 6: m rounded up to 32, over 16) and column g of its ``Kinv``
    (``col_slots``: n rounded up to 2), no shared memory.  Every other
    shape takes "wide" (2; up to n = 256, m = 1024): a warp per lane and
    per block, the lane's vectors (7 m + 4 n floats, rounded to 16 bytes)
    in shared memory, the operators read from device memory; ``row_slots
    = col_slots = 0``.  Wider problems go to ``solve_qp_batched``."""
    if not (1 <= n <= GENERAL_LANES_MAX_N and 1 <= m <= GENERAL_LANES_MAX_M):
        raise ValueError(
            f"admm_general kernel takes 1 <= n <= {GENERAL_LANES_MAX_N} and "
            f"1 <= m <= {GENERAL_LANES_MAX_M}, got (n, m) = ({n}, {m}); "
            f"solve wider problems with solve_qp_batched")
    reg = n <= _LANE_REG_MAX_N and m <= _LANE_REG_MAX_M
    if body == "auto":
        body = "register" if reg else "wide"
    if body not in GENERAL_LANES_BODIES or (body == "register" and not reg):
        raise ValueError(f"admm_general kernel: body {body!r} does not take "
                         f"(n, m) = ({n}, {m})")
    if body == "register":
        return (1, -(-m // (2 * _LANE_GROUP)) * 2, _round_up(n, 2),
                _LANE_THREADS // _LANE_GROUP, _LANE_THREADS, 0)
    return (2, 0, 0, 1, 32, _round_up(4 * (7 * m + 4 * n), 16))


def _check_general_lanes_plans(lib) -> None:
    for n, m in itertools.product(range(GENERAL_LANES_MAX_N + 2),
                                  (0, *_GENERAL_CHECKED_M, 1025)):
        for body in ("auto", *GENERAL_LANES_BODIES):
            out = (ctypes.c_int * 6)()
            rc = lib.copra_admm_general_config(
                n, m, GENERAL_LANES_BODIES.get(body, 0), out)
            try:
                want = general_lanes_config(n, m, body)
            except ValueError:
                want = None
            if (rc != 0) != (want is None) or (want is not None
                                              and tuple(out) != want):
                raise RuntimeError(
                    f"csrc/admm_general.cu's launch plan for (n, m) = ({n}, "
                    f"{m}), body {body}, is {tuple(out)} (rc {rc}), not "
                    f"{want}")


_PLAN_CHECKS = {"admm_box": _check_box_lanes_plans,
                "admm_box_shared": _check_box_plans,
                "admm_general_shared": _check_general_plans,
                "admm_general": _check_general_lanes_plans}


def _general_lanes_attributes(n: int, m: int, body: str = "auto"
                              ) -> Tuple[int, int, int, int]:
    """``(registers a thread, spill bytes a thread, largest block, blocks
    an SM holds)`` of the compiled kernel that serves the plan
    (``cudaFuncGetAttributes``, the occupancy calculator)."""
    general_lanes_config(n, m, body)
    lib = _load("admm_general")
    out = (ctypes.c_int * 4)()
    _raise_on(lib.copra_admm_general_attributes(
        n, m, GENERAL_LANES_BODIES.get(body, 0), out), lib,
        "copra_admm_general")
    return tuple(out)


def _launch_general(Kinv, C, c, l, u, rho, x0, y0, z0, *, n_iter, sigma,
                    alpha, body="auto"):
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
    if B < 1:
        raise ValueError("admm_general kernel: B must be >= 1")
    general_lanes_config(n, m, body)
    lib = _load("admm_general")
    outs = (torch.empty_like(x0), torch.empty_like(y0), torch.empty_like(z0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.copra_admm_general(
            *(t.data_ptr() for t in (Kinv, C, c, l, u, rho, x0, y0, z0,
                                     *outs)),
            B, n, m, int(n_iter), GENERAL_LANES_BODIES.get(body, 0),
            float(sigma), float(alpha), float(1.0 - alpha), stream)
    _raise_on(rc, lib, "copra_admm_general")
    return outs


@counted
def fused_admm_general(Kinv: Tensor, C: Tensor, c: Tensor, l: Tensor,
                       u: Tensor, rho: Tensor, x0: Tensor, y0: Tensor,
                       z0: Tensor, *, n_iter: int, sigma: float,
                       alpha: float) -> Tuple[Tensor, Tensor, Tensor]:
    """General fused ADMM with operators PER LANE: ``Kinv [B, n, n]``,
    ``C [B, m, n]``, ``c``/``x0 [B, n]``, ``l``/``u``/``rho``/``y0``/``z0
    [B, m]``, all f32, n <= 256 and m <= 1024 (wider problems go to
    ``solve_qp_batched``).  Returns ``(x, y, z)``.  CPU tensors run
    :func:`admm_general_plain`; CUDA tensors launch
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
