"""The Riccati gains of a stagewise plan, refactored on the device: the
quadratic recursion of :func:`~copra_tpu_torch.ops.stagewise_kernel.
precompute_lqr_gains` written straight into the tick kernel's packed plan.

A tick whose problem data change with its initial state (a QP
re-linearised every MPC step) needs the gains again every tick, inside the
tick's CUDA graph.  :func:`riccati_gains_into_plan` does that in one
launch of ``csrc/riccati_gains.cu`` (a lane a block, the N dependent
stages in shared memory), which writes the plan's data-dependent columns
(``A``, ``B``, ``d``, ``K``, ``nF``, ``qb``, ``rb`` of
:class:`~copra_tpu_torch.ops.stagewise_kernel._Layout`) in place and leaves
the others (penalties, bounds, rows) as they are.  On CPU tensors the
plain route runs: ``precompute_lqr_gains`` and the same columns written
with torch ops.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import profiling
from ._derivative import refuse_gradient
from .build import load_library
from .counts import counted
from .stagewise_kernel import _Layout, precompute_lqr_gains

Tensor = torch.Tensor

MAX_DIM = 32                 # x and u the kernel takes, at most
# the host counter of the kernel's launches (each launch the host issues; a
# graph's replays are not issued)
LAUNCH_COUNTER = "stagewise.launches.gains"

_lib = None
_prepared = set()
_P, _I = ctypes.c_void_p, ctypes.c_int


def smem_bytes(x: int, u: int, itemsize: int) -> int:
    """Shared memory of a lane's block (mirrored by ``smem_values`` in
    ``csrc/riccati_gains.cu`` and checked when the library loads): V and
    A'V; B'V, G and K; [F | I] twice; avd and bvd; and two stages'
    operands (A, B, S, Ru, d, Qx, qx, ru), the double buffer that the next
    stage's copies land in."""
    stage = 2 * x * x + 2 * x * u + u * u + 2 * x + u
    return (2 * x * x + 3 * x * u + 4 * u * u + x + u + 2 * stage) * itemsize


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("riccati_gains")
        for sym, res, args in (
                ("copra_riccati_gains", _I,
                 [_P] * 9 + [_I] * 5 + [ctypes.POINTER(_I),
                                        ctypes.POINTER(ctypes.c_longlong),
                                        _P]),
                ("copra_riccati_gains_smem", _I, [_I, _I, _I]),
                ("copra_riccati_gains_prepare", _I, []),
                ("copra_riccati_gains_error_string", ctypes.c_char_p, [_I])):
            fn = getattr(lib, sym)
            fn.restype, fn.argtypes = res, args
        for x, u in ((12, 12), (3, 1), (32, 32), (1, 7)):
            for itemsize in (4, 8):
                got = lib.copra_riccati_gains_smem(x, u, int(itemsize == 8))
                if got != smem_bytes(x, u, itemsize):
                    raise RuntimeError(
                        f"csrc/riccati_gains.cu's shared memory at {(x, u)} "
                        f"x {itemsize} B is {got}, not "
                        f"{smem_bytes(x, u, itemsize)}")
        _lib = lib
    return _lib


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"riccati gains kernel: {what} failed: CUDA error {rc} "
            f"({lib.copra_riccati_gains_error_string(rc).decode()})")


def _stage_view(plan: Tensor, lane_first: bool) -> Tensor:
    """The plan as ``[B, N+1, C]`` (a view)."""
    return plan if lane_first else plan.permute(2, 0, 1)


def riccati_gains_plain(plan: Tensor, *, lane_first: bool, x: int, u: int,
                        r: int, A: Tensor, B: Tensor, d: Tensor,
                        Qx_r: Tensor, Ru_r: Tensor, S: Optional[Tensor],
                        qx: Tensor, ru: Tensor) -> None:
    """Plain PyTorch version of the kernel: :func:`precompute_lqr_gains`
    and the plan's data-dependent columns written with torch ops."""
    g = precompute_lqr_gains(A, B, d, Qx_r, Ru_r, S)
    lo = _Layout(x, u, r)
    view = _stage_view(plan, lane_first)
    nb, N = A.shape[0], A.shape[1]

    def put(off, a, stages=N):
        a = a.reshape(nb, stages, -1)
        view[:, :stages, off:off + a.shape[-1]] = a

    put(lo.A, A)
    put(lo.B, B)
    put(lo.d, d)
    put(lo.K, g.K)
    put(lo.nF, g.nF)
    put(lo.qb, torch.cat([qx[:, :-1] + g.avd, qx[:, -1:]], dim=1), N + 1)
    put(lo.rb, ru + g.bvd)


@counted
def riccati_gains_into_plan(plan: Tensor, *, lane_first: bool, x: int,
                            u: int, r: int, A: Tensor, B: Tensor, d: Tensor,
                            Qx_r: Tensor, Ru_r: Tensor, S: Optional[Tensor],
                            qx: Tensor, ru: Tensor) -> None:
    """Refactor the gains of a batched problem into ``plan`` in place.

    ``plan`` is the tick kernel's lane-first copy ``[B, N+1, Cp]``
    (``lane_first=True``) or the lane-last plan ``[N+1, C, B]``; ``A [B,
    N, x, x]``, ``B [B, N, x, u]``, ``d [B, N, x]``, the ridged ``Qx_r
    [B, N+1, x, x]`` and ``Ru_r [B, N, u, u]``, the rows' cross term ``S
    [B, N, x, u]`` (or None), ``qx [B, N+1, x]`` and ``ru [B, N, u]``, all
    of the plan's dtype and device.  CPU tensors run
    :func:`riccati_gains_plain`; CUDA tensors launch
    ``csrc/riccati_gains.cu`` (float32 or float64, ``x, u <= 32``), which
    allocates nothing and does not sync, so the launch can be captured in
    a CUDA graph.  Returns nothing: the plan's ``A``, ``B``, ``d``, ``K``,
    ``nF``, ``qb`` and ``rb`` columns hold the new problem."""
    nb, N = A.shape[0], A.shape[1]
    lo = _Layout(x, u, r)
    dt, dev = plan.dtype, plan.device
    cols = plan.shape[2] if lane_first else plan.shape[1]
    want = {"A": (nb, N, x, x), "B": (nb, N, x, u), "d": (nb, N, x),
            "Qx_r": (nb, N + 1, x, x), "Ru_r": (nb, N, u, u),
            "S": (nb, N, x, u), "qx": (nb, N + 1, x), "ru": (nb, N, u)}
    got = dict(A=A, B=B, d=d, Qx_r=Qx_r, Ru_r=Ru_r, S=S, qx=qx, ru=ru)
    stages = plan.shape[1] if lane_first else plan.shape[0]
    lanes = plan.shape[0] if lane_first else plan.shape[2]
    if (stages, lanes) != (N + 1, nb) or cols < lo.C:
        raise ValueError(f"plan {tuple(plan.shape)} does not hold {nb} "
                         f"lanes of {N + 1} stages of {lo.C} columns")
    for name, t in got.items():
        if t is None:
            continue
        if tuple(t.shape) != want[name] or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name} must be a {dt} {want[name]} tensor on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if plan.device.type == "cpu":
        riccati_gains_plain(plan, lane_first=lane_first, x=x, u=u, r=r, **got)
        return
    refuse_gradient("riccati_gains_into_plan (csrc/riccati_gains.cu)",
                    "precompute_lqr_gains", plan, *got.values())
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the gains kernel takes float32 or float64, got {dt}")
    if not (1 <= x <= MAX_DIM and 1 <= u <= MAX_DIM):
        raise ValueError(f"the gains kernel takes 1 <= x, u <= {MAX_DIM}, "
                         f"got x = {x}, u = {u}")
    for name, t in got.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _load()
    if dev.index not in _prepared:
        with torch.cuda.device(dev):
            _raise_on(lib.copra_riccati_gains_prepare(), lib,
                      "setting its shared-memory attribute")
        _prepared.add(dev.index)
    st = plan.stride()
    strides = (ctypes.c_longlong * 3)(*(st if lane_first
                                        else (st[2], st[0], st[1])))
    offsets = (ctypes.c_int * 7)(lo.A, lo.B, lo.d, lo.K, lo.nF, lo.qb, lo.rb)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.copra_riccati_gains(
            ptr(A), ptr(B), ptr(d), ptr(Qx_r), ptr(Ru_r), ptr(S), ptr(qx),
            ptr(ru), plan.data_ptr(), nb, N, x, u, int(dt == torch.float64),
            offsets, strides, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "launch")
    profiling.count(LAUNCH_COUNTER)
    riccati_gains_into_plan.launches += 1
