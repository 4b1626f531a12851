"""Stagewise (uncondensed) MPC solver: Riccati-in-ADMM.

Port of ``copra_tpu/qp/riccati.py``.  The QP keeps its stagewise structure
(variables ``(X, U)``, dynamics as equality structure) and every ADMM
w-update is one Riccati (LQR) sweep: O(N) work and memory per iteration.
Boxes on states and controls and general per-stage rows are handled by the
ADMM projection.

    min  sum_k 1/2 x_k'Qx_k x_k + qx_k'x_k + 1/2 u_k'Ru_k u_k + ru_k'u_k
    s.t. x_{k+1} = A_k x_k + B_k u_k + d_k,   x_0 fixed,
         xlb <= x <= xub,  ulb <= u <= uub,  clo <= Cx x + Cu u <= chi

Where the reference vmaps one problem over a fleet, the port writes the
lane axis out: every function here takes one problem (``A [N, x, x]``) or a
batch (``A [B, N, x, x]``), and a batched early-exit solve stops each lane
at its own convergence, as the vmapped ``lax.while_loop`` does.  The
serial sweeps are Python loops over stages, batched over lanes; the
log-depth forms (:func:`lqr_solve_assoc`, ``parallel_scan=True``, the
parallel dual residual) run :func:`~copra_tpu_torch._scan.associative_scan`.
:func:`make_stagewise_multistep` serves a chain of ticks, on a CUDA device
as one CUDA graph.

On a CUDA device an early-exit :func:`solve_stagewise` runs on the
stagewise tick kernel in chunks (``ops.stagewise_kernel.
solve_stagewise_fused``); the measured serving policies
(:func:`auto_rho_stagewise`, :func:`auto_iters_stagewise`) and the
no-knobs :func:`make_stagewise_server` build on it.  Dropped:
``warn_if_emulated_f64`` (the H100 has FP64), pinning the policies' probes
to the CPU (the reference's f64 oracle could not run on the TPU; here it
runs on the problem's device), the module-level jit caches and their
``TICK_TRACE_COUNTERS`` (PyTorch runs eagerly; the multistep chain keeps
one graph per chain length).
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import profiling
from .._precision import highest_precision
from .._scan import affine_combine, associative_scan
from .._tensors import (common, matvec as _mv, matvec_t as _mtv,
                        resolve_device)
from ..constraints import (Constraint, ControlBoundConstraint,
                           ControlConstraint, MixedConstraint,
                           TrajectoryBoundConstraint, TrajectoryConstraint)
from ..costs import (ControlCost, CostFunction, SimpleControlCost,
                     SimpleTrajectoryCost, TargetCost, TrajectoryCost)
from ..errors import DimensionError, InfeasibleProblemError
from ..systems import LTISystem, System
from .types import (STATUS_MAX_ITER, STATUS_PRIMAL_INFEASIBLE,
                    STATUS_SOLVED, QPSolution, SolverOptions)

Tensor = torch.Tensor

@dataclasses.dataclass(frozen=True)
class StagewiseQP:
    """Stagewise LQ problem with boxes and general per-stage rows.

        clo_k <= Cx_k x_k + Cu_k u_k <= chi_k,   k = 0..N-1

    (``Cx/Cu/clo/chi`` are ``None`` for the box-only problem).  A batch
    adds a leading lane axis to every field.
    """

    A: Tensor       # [N, x, x]
    B: Tensor       # [N, x, u]
    d: Tensor       # [N, x]
    Qx: Tensor      # [N+1, x, x]
    qx: Tensor      # [N+1, x]
    Ru: Tensor      # [N, u, u]
    ru: Tensor      # [N, u]
    x0: Tensor      # [x]
    xlb: Tensor     # [N+1, x]
    xub: Tensor     # [N+1, x]
    ulb: Tensor     # [N, u]
    uub: Tensor     # [N, u]
    Cx: Optional[Tensor] = None   # [N, r, x]
    Cu: Optional[Tensor] = None   # [N, r, u]
    clo: Optional[Tensor] = None  # [N, r]
    chi: Optional[Tensor] = None  # [N, r]

    @property
    def horizon(self) -> int:
        return self.A.shape[-3]

    @property
    def xdim(self) -> int:
        return self.A.shape[-1]

    @property
    def udim(self) -> int:
        return self.B.shape[-1]

    @property
    def nr_rows(self) -> int:
        """General rows per stage (0 when box-only)."""
        return 0 if self.Cx is None else self.Cx.shape[-2]


def _lead(sqp: StagewiseQP) -> StagewiseQP:
    """A single problem as a batch of one lane."""
    return StagewiseQP(**{f.name: (None if getattr(sqp, f.name) is None
                                   else getattr(sqp, f.name).unsqueeze(0))
                          for f in dataclasses.fields(StagewiseQP)})


class TickData(NamedTuple):
    """The data of a batched problem that a tick rebuilds from its initial
    states, in original units: ``A [B, N, x, x]``, ``B [B, N, x, u]``,
    ``d [B, N, x]`` and the linear costs ``qx [B, N+1, x]``, ``ru [B, N,
    u]``.  What the ``problem`` callable of :func:`make_stagewise_multistep`
    (and :func:`make_stagewise_step`) returns for the tick's ``x0 [B, x]``;
    the quadratic costs, boxes and rows stay as built."""

    A: Tensor
    B: Tensor
    d: Tensor
    qx: Tensor
    ru: Tensor


# the device counter of the rebuilds: a tick that rebuilt its problem from
# its x0 adds one, inside a captured graph too
REBUILD_COUNTERS = ("stagewise.rebuilds",)


def _tick_data(problem, x0: Tensor, sqp: StagewiseQP) -> TickData:
    """``problem(x0)``, checked against the batched problem it replaces
    (shapes and dtypes; a host check, no sync)."""
    data = TickData(*problem(x0))
    for name, t in zip(TickData._fields, data):
        held = getattr(sqp, name)
        if tuple(t.shape) != tuple(held.shape) or t.dtype != held.dtype:
            raise DimensionError(
                f"the problem callable gave {name} {t.dtype} "
                f"{tuple(t.shape)}; the tick's problem holds {held.dtype} "
                f"{tuple(held.shape)}")
    return data


def _scale_data(data: TickData, scale) -> TickData:
    """The fields a tick rebuilds, equilibrated by ``scale = (Dx, Du)`` as
    :func:`scale_stagewise` does the whole problem (``None``: as they
    are)."""
    if scale is None:
        return data
    Dx, Du = scale
    Dxi = 1.0 / Dx
    return TickData(A=Dxi[:, None] * data.A * Dx[None, :],
                    B=Dxi[:, None] * data.B * Du[None, :], d=data.d * Dxi,
                    qx=data.qx * Dx, ru=data.ru * Du)


def _refuse_stale_plan(problem, options: "SolverOptions", rows: bool,
                       backend: str) -> None:
    """A fused tick that rebuilds its problem every tick refreshes the
    plan's data-dependent columns; it does not rebuild the f64 polish's
    plan, nor the unridged gains that reseed a warm tick without rows."""
    if problem is None or backend != "fused":
        return
    if getattr(options, "polish_iters", 0) > 0:
        raise ValueError(
            "a per-tick problem on the fused backend does not rebuild the "
            "f64 polish's plan: set polish_iters=0, or use backend='xla'")
    if not rows and options.seed != "zero":
        raise ValueError(
            "a per-tick problem without rows on the fused backend would "
            "reseed each warm tick from gains it does not rebuild: set "
            "seed='zero', or use backend='xla'")


def _ein(eq: str, *ts) -> Tensor:
    """``einsum`` in the promoted dtype of its operands (as ``jnp.einsum``
    promotes; torch requires one dtype)."""
    return torch.einsum(eq, *common(*ts, device=ts[0].device))


# Products of stage-batched blocks by vectors as one elementwise product
# and a sum: a batched GEMV of small blocks ([B, N, x, x] with x of a few
# units) costs the card ~0.1 ms a call whatever its size (measured on the
# H100 in config 5's status pass), an elementwise pass a few us; the
# intermediate is the block's size.
def _smv(M: Tensor, v: Tensor) -> Tensor:
    """``M v`` over the trailing dims."""
    return (M * v.unsqueeze(-2)).sum(-1)


def _smtv(M: Tensor, v: Tensor) -> Tensor:
    """``M' v`` over the trailing dims."""
    return (M * v.unsqueeze(-1)).sum(-2)


def _lane_max(t: Tensor) -> Tensor:
    """Max over every axis but the lane axis (0 for an empty tensor)."""
    flat = t.reshape(t.shape[0], -1)
    if flat.shape[1] == 0:
        return torch.zeros(t.shape[0], dtype=t.dtype, device=t.device)
    return flat.amax(dim=1)


def _lane_sum(t: Tensor) -> Tensor:
    return t.reshape(t.shape[0], -1).sum(dim=1)


def _blockdiag_blocks(Mfull, n_blocks: int, coldim: int):
    """If ``Mfull [(n_blocks*r), (n_blocks*coldim)]`` is block-diagonal with
    equal-sized blocks, return the diagonal blocks ``[n_blocks, r,
    coldim]`` (a tensor of ``Mfull``'s dtype and device); else ``None``.

    Host-side: the off-diagonal mass is summed exactly in f64 with the
    diagonal blocks zeroed, and anything beyond element roundoff of the
    diagonal scale counts as real coupling (the reference's absolute
    test)."""
    M = Mfull.detach().cpu().numpy() if isinstance(Mfull, Tensor) \
        else np.asarray(Mfull)
    if M.ndim != 2:
        return None
    rows, cols = M.shape
    if cols != n_blocks * coldim or rows % n_blocks:
        return None
    r = rows // n_blocks
    blocks = M.reshape(n_blocks, r, n_blocks, coldim)
    diag = blocks[np.arange(n_blocks), :, np.arange(n_blocks), :]
    off = np.abs(blocks.astype(np.float64, copy=True))
    off[np.arange(n_blocks), :, np.arange(n_blocks), :] = 0.0
    unit = max(1.0, float(np.abs(diag).max(initial=0.0)))
    if off.sum() > 1e-12 * unit * max(1, rows):
        return None
    dev = Mfull.device if isinstance(Mfull, Tensor) else resolve_device()
    return torch.tensor(np.ascontiguousarray(diag), device=dev)


def _float_dtypes(obj):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, Tensor) and v.is_floating_point():
            yield v.dtype


def from_mpc(system: System,
             costs: Sequence[CostFunction],
             constraints: Sequence[Constraint]) -> StagewiseQP:
    """Map costs/constraints onto stagewise data (host-side builder).

    Costs: TargetCost; TrajectoryCost/SimpleTrajectoryCost (per-step, or
    full-horizon when block-diagonal); ControlCost/SimpleControlCost.
    Bounds: TrajectoryBoundConstraint, ControlBoundConstraint.  General
    rows: TrajectoryConstraint, ControlConstraint, MixedConstraint become
    per-stage rows ``Cx_k x_k + Cu_k u_k``; rows on ``x_{k+1}`` are
    re-expressed through the dynamics (``Cx = E A_k``, ``Cu = E B_k``,
    bounds shifted by ``E d_k``).  Trajectory rows on ``x_0`` are checked
    at build time and dropped: a violated one raises
    :class:`InfeasibleProblemError`.  MixedCost and non-block-diagonal
    full-horizon entries couple stages and raise with guidance to the
    condensed path.  Assembly runs in the widest floating dtype of the
    system and the user data; the result is cast to the system dtype.
    """
    from ..mpc import HESSIAN_RIDGE

    N = system.horizon
    x, u = system.xdim, system.udim
    if isinstance(system, LTISystem):
        A = system.A.expand(N, x, x)
        B = system.B.expand(N, x, u)
        d = system.d.expand(N, x)
    else:
        A, B, d = system.A, system.B, system.d
    dt = A.dtype
    dev = A.device
    wide = dt
    for obj in tuple(costs) + tuple(constraints):
        for odt in _float_dtypes(obj):
            wide = torch.promote_types(wide, odt)
    kw = dict(dtype=wide, device=dev)

    Qx = torch.zeros((N + 1, x, x), **kw)
    qx = torch.zeros((N + 1, x), **kw)
    Ru = (HESSIAN_RIDGE * torch.eye(u, **kw)).expand(N, u, u)
    ru = torch.zeros((N, u), **kw)

    for cost in costs:
        if isinstance(cost, TargetCost):
            M, p, w = cost.M, cost.p, cost.weights
            Qx = torch.cat([Qx[:-1], (Qx[-1] + _ein("rx,r,ry->xy", M, w, M)
                                      )[None]])
            qx = torch.cat([qx[:-1], (qx[-1] - _ein("r,r,rx->x", p, w, M)
                                      )[None]])
        elif isinstance(cost, TrajectoryCost):
            M, p, w = cost.M, cost.p, cost.weights
            if M.shape[1] == x:          # per-step, constant
                Qx = Qx + _ein("rx,r,ry->xy", M, w, M)[None]
                qx = qx - _ein("r,r,rx->x", p, w, M)[None]
            else:                        # full-horizon: block-diag only
                Mk = _blockdiag_blocks(M, N + 1, x)
                if Mk is None:
                    raise DimensionError(
                        "full-horizon TrajectoryCost with a non-block-"
                        "diagonal M couples stages; use the condensed "
                        "path ('admm' solver) for it.")
                rr = Mk.shape[1]
                pk = p.reshape(N + 1, rr)
                wk = w.reshape(N + 1, rr)
                Qx = Qx + _ein("krx,kr,kry->kxy", Mk, wk, Mk)
                qx = qx - _ein("kr,kr,krx->kx", pk, wk, Mk)
        elif isinstance(cost, SimpleTrajectoryCost):
            w, p = cost.weights, cost.p
            if p.shape[0] == x:
                Qx = Qx + torch.diag(w)[None]
                qx = qx - (w * p)[None]
            else:                        # full-horizon (time-varying)
                Qx = Qx + torch.diag_embed(w.reshape(N + 1, x))
                qx = qx - (w * p).reshape(N + 1, x)
        elif isinstance(cost, ControlCost) and cost.N.shape[1] == u:
            Nm, p, w = cost.N, cost.p, cost.weights
            Ru = Ru + _ein("ru,r,rv->uv", Nm, w, Nm)[None]
            ru = ru - _ein("r,r,ru->u", p, w, Nm)[None]
        elif isinstance(cost, SimpleControlCost):
            w, p = cost.weights, cost.p
            if p.shape[0] == u:
                Ru = Ru + torch.diag(w)[None]
                ru = ru - (w * p)[None]
            else:
                Ru = Ru + torch.diag_embed(w.reshape(N, u))
                ru = ru - (w * p).reshape(N, u)
        else:
            raise DimensionError(
                f"{type(cost).__name__} (or its full-horizon mode) couples "
                f"stages; use the condensed path ('admm' solver) for it.")

    kd = dict(dtype=dt, device=dev)
    xlb = torch.full((N + 1, x), -torch.inf, **kd)
    xub = torch.full((N + 1, x), torch.inf, **kd)
    ulb = torch.full((N, u), -torch.inf, **kd)
    uub = torch.full((N, u), torch.inf, **kd)
    row_sets = []          # (Cx [N,r,x], Cu [N,r,u], lo [N,r], hi [N,r])

    def check_x0_rows(E0, f0, is_ineq):
        """Build-time feasibility of the dropped ``x_0`` trajectory rows
        (x_0 is data; reference constraint tolerance 1e-6).  Skipped
        inside a ``torch.func`` transform, whose tensors have no values to
        read, as the reference skips it under a tracer."""
        try:
            E0c, f0c, x0c = (t.detach().cpu().numpy()
                             for t in (E0, f0, system.x0))
        except RuntimeError:
            return
        v = np.einsum("rx,...x->...r", E0c, x0c)
        fin = np.isfinite(f0c)
        if not fin.any():
            return
        scale = max(1.0, float(np.abs(f0c[fin]).max(initial=0.0)),
                    float(np.abs(v).max(initial=0.0)))
        gap = (v - f0c) if is_ineq else np.abs(v - f0c)
        gap = np.where(np.broadcast_to(fin, gap.shape), gap, -np.inf)
        worst = float(gap.max(initial=-np.inf))
        if worst > 1e-6 * scale:
            kind = "E x_0 <= f" if is_ineq else "E x_0 = f"
            raise InfeasibleProblemError(
                f"TrajectoryConstraint row on the fixed initial state is "
                f"violated at build time: worst '{kind}' gap "
                f"{worst:.3e} (tolerance {1e-6 * scale:.1e}).  The "
                f"stagewise path treats x_0 as data; fix x_0 or the "
                f"constraint, or use the condensed path to see the "
                f"solver-level infeasibility certificate.")

    def traj_rows(Ek, fk, is_ineq):
        """Rows ``E_k x_k (<=|=) f_k`` for k=1..N expressed at stage k-1
        through the dynamics."""
        E1, f1 = Ek[1:], fk[1:]
        Cx_r = _ein("krx,kxy->kry", E1, A)
        Cu_r = _ein("krx,kxu->kru", E1, B)
        hi = f1 - _ein("krx,kx->kr", E1, d)
        lo = hi if not is_ineq else torch.full_like(hi, -torch.inf)
        return (Cx_r, Cu_r, lo, hi)

    for constr in constraints:
        if isinstance(constr, TrajectoryBoundConstraint):
            lo, up = constr.lower_bound.to(dev), constr.upper_bound.to(dev)
            if lo.shape[0] != x:
                lo, up = lo.reshape(N + 1, x), up.reshape(N + 1, x)
            xlb = torch.maximum(xlb, lo)
            xub = torch.minimum(xub, up)
        elif isinstance(constr, ControlBoundConstraint):
            lo, up = constr.lower_bound.to(dev), constr.upper_bound.to(dev)
            if lo.shape[0] != u:
                lo, up = lo.reshape(N, u), up.reshape(N, u)
            ulb = torch.maximum(ulb, lo)
            uub = torch.minimum(uub, up)
        elif isinstance(constr, MixedConstraint):
            E, G, f = constr.E, constr.G, constr.f
            if E.shape[1] != x:
                raise DimensionError(
                    "full-horizon MixedConstraint couples stages; use the "
                    "condensed path ('admm' solver) for it.")
            # row k pairs x_k with u_k, k=0..N-1
            r0 = E.shape[0]
            hi = f.expand(N, r0)
            lo = hi if not constr.is_inequality \
                else torch.full_like(hi, -torch.inf)
            row_sets.append((E.expand(N, r0, x), G.expand(N, r0, u), lo, hi))
        elif isinstance(constr, TrajectoryConstraint):
            E, f = constr.E, constr.f
            if E.shape[1] == x:           # per-step, constant rows
                r0 = E.shape[0]
                Ek = E.expand(N + 1, r0, x)
                fk = f.expand(N + 1, r0)
            else:                         # full-horizon: block-diag only
                Ek = _blockdiag_blocks(E, N + 1, x)
                if Ek is None:
                    raise DimensionError(
                        "full-horizon TrajectoryConstraint with a non-"
                        "block-diagonal E couples stages; use the "
                        "condensed path ('admm' solver) for it.")
                fk = f.reshape(N + 1, Ek.shape[1])
            check_x0_rows(Ek[0], fk[0], constr.is_inequality)
            row_sets.append(traj_rows(Ek, fk, constr.is_inequality))
        elif isinstance(constr, ControlConstraint):
            G, f = constr.G, constr.f
            if G.shape[1] == u:
                r0 = G.shape[0]
                Gk = G.expand(N, r0, u)
                fk = f.expand(N, r0)
            else:
                Gk = _blockdiag_blocks(G, N, u)
                if Gk is None:
                    raise DimensionError(
                        "full-horizon ControlConstraint with a non-block-"
                        "diagonal G couples stages; use the condensed "
                        "path ('admm' solver) for it.")
                fk = f.reshape(N, Gk.shape[1])
            r0 = Gk.shape[1]
            lo = fk if not constr.is_inequality \
                else torch.full_like(fk, -torch.inf)
            row_sets.append((torch.zeros((N, r0, x), **kd), Gk, lo, fk))
        else:
            raise DimensionError(
                f"{type(constr).__name__} is not expressible stagewise; "
                f"use the condensed path ('admm' solver) for it.")

    cast = lambda a: None if a is None else a.to(**kd).contiguous()
    if row_sets:
        Cx, Cu, clo, chi = (torch.cat([cast(s[i]) for s in row_sets], dim=1)
                            for i in range(4))
    else:
        Cx = Cu = clo = chi = None
    return StagewiseQP(A=cast(A), B=cast(B), d=cast(d), Qx=cast(Qx),
                       qx=cast(qx), Ru=cast(Ru), ru=cast(ru),
                       x0=cast(system.x0), xlb=cast(xlb), xub=cast(xub),
                       ulb=cast(ulb), uub=cast(uub), Cx=Cx, Cu=Cu, clo=clo,
                       chi=chi)


@highest_precision
def lqr_solve(A: Tensor, B: Tensor, d: Tensor, Qx: Tensor, qx: Tensor,
              Ru: Tensor, ru: Tensor, x0: Tensor,
              S: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Equality-constrained stagewise LQ solve by one Riccati sweep
    (backward value recursion + forward rollout); leading batch dims
    allowed.  Returns ``(X [N+1, x], U [N, u])``.  ``S [N, x, u]`` adds
    cross costs ``x_k' S_k u_k``; the joint stage Hessian must be PD."""
    N, xdim, udim = A.shape[-3], A.shape[-1], B.shape[-1]
    if S is None:
        S = torch.zeros(A.shape[:-1] + (udim,), dtype=A.dtype,
                        device=A.device)
    V, v = Qx[..., N, :, :], qx[..., N, :]
    Ks, ks = [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        A_k, B_k, d_k = A[..., k, :, :], B[..., k, :, :], d[..., k, :]
        BtV = B_k.mT @ V
        F = Ru[..., k, :, :] + BtV @ B_k
        G = S[..., k, :, :].mT + BtV @ A_k
        h = ru[..., k, :] + _mtv(B_k, v) + _mv(BtV, d_k)
        L = torch.linalg.cholesky(F)
        Ks[k] = -torch.cholesky_solve(G, L)
        ks[k] = -torch.cholesky_solve(h.unsqueeze(-1), L).squeeze(-1)
        AtV = A_k.mT @ V
        V = Qx[..., k, :, :] + AtV @ A_k + G.mT @ Ks[k]
        v = qx[..., k, :] + _mtv(A_k, v) + _mv(AtV, d_k) + _mtv(G, ks[k])
        V = 0.5 * (V + V.mT)
    X, U = [x0], []
    for k in range(N):
        U.append(_mv(Ks[k], X[-1]) + ks[k])
        X.append(_mv(A[..., k, :, :], X[-1]) + _mv(B[..., k, :, :], U[-1])
                 + d[..., k, :])
    return torch.stack(X, dim=-2), torch.stack(U, dim=-2)


def _solve(M: Tensor, R: Tensor) -> Tensor:
    """``M^{-1} R`` without the error check (and its host sync) of
    ``torch.linalg.solve``: a singular ``M`` gives non-finite values, as
    in the reference."""
    return torch.linalg.solve_ex(M, R)[0]


def _inv(M: Tensor) -> Tensor:
    return torch.linalg.inv_ex(M)[0]


def _interval_combine(ei, ej):
    """Compose the value-function intervals ``ei`` (earlier) and ``ej``
    (later), each the 5-tuple ``(A, b, C, J, eta)`` of
    :func:`lqr_solve_assoc`."""
    A1, b1, C1, J1, h1 = ei
    A2, b2, C2, J2, h2 = ej
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    M1 = _inv(eye + C1 @ J2)
    M2 = _inv(eye + J2 @ C1)
    A2M1 = A2 @ M1
    return (A2M1 @ A1,
            _mv(A2M1, b1 + _mv(C1, h2)) + b2,
            A2M1 @ C1 @ A2.mT + C2,
            A1.mT @ M2 @ J2 @ A1 + J1,
            _mtv(A1, _mv(M2, h2 - _mv(J2, b1))) + h1)


@highest_precision
def lqr_solve_assoc(A: Tensor, B: Tensor, d: Tensor, Qx: Tensor,
                    qx: Tensor, Ru: Tensor, ru: Tensor, x0: Tensor,
                    S: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Log-depth LQ solve: the same problem, signature and result as
    :func:`lqr_solve`, by two associative scans in place of the serial
    sweeps (leading batch dims allowed).

    The conditional value functions over stage intervals compose
    associatively.  An interval is the 5-tuple ``(A, b, C, J, eta)``:
    travelling ``x -> y`` costs ``1/2 x'Jx - eta'x`` plus the least control
    effort ``1/2 s' C^+ s`` for the displacement ``s = y - Ax - b``
    (``C = B R^{-1} B'``).  The combine (earlier ``i``, later ``j``) is::

        M   = (I + C_i J_j)^{-1}
        A   = A_j M A_i
        b   = A_j M (b_i + C_i eta_j) + b_j
        C   = A_j M C_i A_j' + C_j
        eta = A_i' (I + J_j C_i)^{-1} (eta_j - J_j b_i) + eta_i
        J   = A_i' (I + J_j C_i)^{-1} J_j A_i + J_i

    The value functions come from one reverse scan, the gains from them
    stage by stage at once, and the closed-loop rollout from a second,
    affine, scan.  Cross costs ``S [N, x, u]`` are eliminated first by
    completing the square (``u = u~ - R^{-1} S' x``): ``A~ = A - B R^{-1}
    S'``, ``Qx~ = Qx - S R^{-1} S'``, ``qx~ = qx - S R^{-1} ru``.
    """
    x = A.shape[-1]
    batch = torch.broadcast_shapes(
        A.shape[:-3], B.shape[:-3], d.shape[:-2], Qx.shape[:-3],
        qx.shape[:-2], Ru.shape[:-3], ru.shape[:-2], x0.shape[:-1],
        () if S is None else S.shape[:-3])
    A, B, d, Qx, qx, Ru, ru = (
        t.expand(*batch, *t.shape[-k:]) for t, k in
        ((A, 3), (B, 3), (d, 2), (Qx, 3), (qx, 2), (Ru, 3), (ru, 2)))
    x0 = x0.expand(*batch, x)
    if S is not None:
        S = S.expand(*batch, *S.shape[-3:])
        RinvSt = _solve(Ru, S.mT)                            # [.., N, u, x]
        Rinv_r = _solve(Ru, ru.unsqueeze(-1)).squeeze(-1)    # [.., N, u]
        Qx_t = torch.cat([Qx[..., :-1, :, :] - S @ RinvSt,
                          Qx[..., -1:, :, :]], dim=-3)
        qx_t = torch.cat([qx[..., :-1, :] - _mv(S, Rinv_r),
                          qx[..., -1:, :]], dim=-2)
        X, U_t = lqr_solve_assoc(A - B @ RinvSt, B, d, Qx_t, qx_t, Ru, ru,
                                 x0)
        return X, U_t - _mv(RinvSt, X[..., :-1, :])
    sd = len(batch)
    kd = dict(dtype=A.dtype, device=A.device)
    # per-stage intervals; the linear control cost ru is absorbed by the
    # least-norm shift u -> u + R^{-1} ru
    Rinv_ru = _solve(Ru, ru.unsqueeze(-1)).squeeze(-1)
    BRB = B @ _inv(Ru) @ B.mT
    elems = (
        torch.cat([A, torch.eye(x, **kd).expand(*batch, 1, x, x)], dim=-3),
        torch.cat([d - _mv(B, Rinv_ru), torch.zeros(*batch, 1, x, **kd)],
                  dim=-2),
        torch.cat([BRB, torch.zeros(*batch, 1, x, x, **kd)], dim=-3),
        Qx, -qx)
    # the reverse scan hands (later suffix, earlier stage); the combine
    # takes (earlier, later)
    suffix = associative_scan(lambda a, b: _interval_combine(b, a), elems,
                              dim=sd, reverse=True)
    Vn, vn = suffix[3][..., 1:, :, :], -suffix[4][..., 1:, :]
    BtV = B.mT @ Vn
    Rb = Ru + BtV @ B
    Ks = -_solve(Rb, BtV @ A)
    ks = -_solve(Rb, (ru + _mtv(B, vn + _mv(Vn, d))).unsqueeze(-1)
                 ).squeeze(-1)
    Mp, cp = associative_scan(affine_combine, (A + B @ Ks, _mv(B, ks) + d),
                              dim=sd)
    X = torch.cat([x0.unsqueeze(-2), _mv(Mp, x0.unsqueeze(-2)) + cp],
                  dim=-2)
    return X, _mv(Ks, X[..., :-1, :]) + ks


def _box_penalties(lb: Tensor, ub: Tensor, rho: float) -> Tensor:
    """Per-coordinate penalty: ``rho`` where a finite bound exists, else 0
    (no consensus split on an unbounded coordinate)."""
    return torch.where(torch.isfinite(lb) | torch.isfinite(ub),
                       torch.tensor(rho, dtype=lb.dtype, device=lb.device),
                       torch.zeros((), dtype=lb.dtype, device=lb.device))


class _Rows(NamedTuple):
    """General rows, L2-normalized (an exact reparametrization): the
    normalization ``Es``, the normalized ``Cx``/``Cu`` and bounds, and the
    per-row penalties (``rho * rho_eq_scale`` on equality rows)."""

    Es: Tensor       # [B, N, r]
    Cx: Tensor
    Cu: Tensor
    slo: Tensor
    shi: Tensor
    rho_s: Tensor

    def eval(self, X: Tensor, U: Tensor) -> Tensor:
        """``Cx x_k + Cu u_k`` in the normalized metric."""
        return _smv(self.Cx, X[:, :-1]) + _smv(self.Cu, U)


def _penalized(sqp: StagewiseQP, options: SolverOptions, rho_x: Tensor,
               rho_u: Tensor):
    """The iteration-invariant stage Hessians of a batched problem: the
    sigma ridge and box penalties, plus the row penalties' constant blocks
    and ``x'(Cx'Cu)u`` cross term.  Returns ``(Qx_r, Ru_r, S, rows)``
    (``S`` and ``rows`` ``None`` when box-only)."""
    x, u = sqp.xdim, sqp.udim
    kd = dict(dtype=sqp.A.dtype, device=sqp.A.device)
    sigma, rho = float(options.sigma), float(options.rho)
    Qx_r = sqp.Qx + sigma * torch.eye(x, **kd) + torch.diag_embed(rho_x)
    Ru_r = sqp.Ru + sigma * torch.eye(u, **kd) + torch.diag_embed(rho_u)
    if not sqp.nr_rows:
        return Qx_r, Ru_r, None, None
    rn = torch.sqrt((sqp.Cx * sqp.Cx).sum(-1) + (sqp.Cu * sqp.Cu).sum(-1))
    Es = torch.where(rn > 1e-12, 1.0 / rn, torch.ones_like(rn))
    rows = _Rows(Es=Es, Cx=sqp.Cx * Es[..., None], Cu=sqp.Cu * Es[..., None],
                 slo=sqp.clo * Es, shi=sqp.chi * Es,
                 rho_s=torch.where(sqp.clo == sqp.chi,
                                   torch.tensor(rho * options.rho_eq_scale,
                                                **kd),
                                   torch.tensor(rho, **kd)))
    Qx_r = torch.cat([Qx_r[:, :-1] + torch.einsum(
        "bkrx,bkr,bkry->bkxy", rows.Cx, rows.rho_s, rows.Cx), Qx_r[:, -1:]],
        dim=1)
    Ru_r = Ru_r + torch.einsum("bkru,bkr,bkrv->bkuv", rows.Cu, rows.rho_s,
                               rows.Cu)
    S = torch.einsum("bkrx,bkr,bkru->bkxu", rows.Cx, rows.rho_s, rows.Cu)
    return Qx_r, Ru_r, S, rows


def _initial_state(sqp: StagewiseQP, options: SolverOptions, warm_start,
                   rows: Optional[_Rows], sweep):
    """``(zX, zU, yX, yU, zS, yS)`` to start from: the carried warm tuple
    (box-only problems reseed z at the clipped unconstrained optimum of
    the new problem, ``sweep()``, and keep the duals: with rows the split
    state encodes the active set and is carried whole), the clipped
    unconstrained optimum cold, or zeros with ``seed='zero'``."""
    nb, N, x, u, r = (sqp.A.shape[0], sqp.horizon, sqp.xdim, sqp.udim,
                      sqp.nr_rows)
    kd = dict(dtype=sqp.A.dtype, device=sqp.A.device)
    zS0 = yS0 = torch.zeros((nb, N, r), **kd)
    if rows is not None:
        zS0 = torch.clamp(zS0, rows.slo, rows.shi)
    if warm_start is not None:
        zX0, zU0, yX0, yU0 = warm_start[:4]
        if rows is not None and len(warm_start) > 4:
            zS0, yS0 = warm_start[4], warm_start[5]
        if options.seed != "zero" and rows is None:
            Xu, Uu = sweep()
            zX0 = torch.clamp(Xu, sqp.xlb, sqp.xub)
            zU0 = torch.clamp(Uu, sqp.ulb, sqp.uub)
        return zX0, zU0, yX0, yU0, zS0, yS0
    yX0 = torch.zeros((nb, N + 1, x), **kd)
    yU0 = torch.zeros((nb, N, u), **kd)
    if options.seed == "zero":
        return torch.zeros_like(yX0), torch.zeros_like(yU0), yX0, yU0, \
            zS0, yS0
    Xu, Uu = sweep()
    if rows is not None:
        zS0 = torch.clamp(rows.eval(Xu, Uu), rows.slo, rows.shi)
    return (torch.clamp(Xu, sqp.xlb, sqp.xub),
            torch.clamp(Uu, sqp.ulb, sqp.uub), yX0, yU0, zS0, yS0)


def _result(sqp: StagewiseQP, rows: Optional[_Rows], X, U, warm, res,
            iters: Tensor, infeas_code: Tensor, single: bool,
            return_warm: bool):
    """``(X, U, info[, warm])`` from delivered iterates: status from the
    residuals, a confirmed infeasibility certificate, and crossed bounds
    (every projection set empty); ``info.y``/``info.z`` in the original
    row metric, the warm tuple in the internal one."""
    nb = sqp.A.shape[0]
    zX, zU, yX, yU, zS, yS = warm
    r_prim, r_dual, conv = res
    status = torch.where(conv, STATUS_SOLVED, STATUS_MAX_ITER)
    status = torch.where(infeas_code > 0, infeas_code, status)
    lane_any = lambda m: m.reshape(nb, -1).any(dim=1)
    crossed = lane_any(sqp.xlb > sqp.xub) | lane_any(sqp.ulb > sqp.uub)
    if rows is not None:
        crossed = crossed | lane_any(sqp.clo > sqp.chi)
    status = torch.where(crossed, STATUS_PRIMAL_INFEASIBLE, status)
    flat = lambda a: a.reshape(nb, -1)
    info = QPSolution(
        x=flat(U),
        y=torch.cat([flat(yX), flat(yU),
                     flat(yS * rows.Es if rows is not None else yS)], dim=1),
        z=torch.cat([flat(zX), flat(zU),
                     flat(zS / rows.Es if rows is not None else zS)], dim=1),
        status=status.to(torch.int32), iterations=iters.to(torch.int32),
        primal_residual=r_prim, dual_residual=r_dual)
    if rows is None:
        warm = warm[:4]
    if single:
        X, U = X[0], U[0]
        info = QPSolution(**{f.name: getattr(info, f.name)[0]
                             for f in dataclasses.fields(QPSolution)})
        warm = tuple(w[0] for w in warm)
    return (X, U, info, warm) if return_warm else (X, U, info)


@highest_precision
def solve_stagewise(sqp: StagewiseQP,
                    options: SolverOptions = SolverOptions(),
                    warm_start=None,
                    parallel_scan: bool = False,
                    return_warm: bool = False):
    """Stagewise MPC by Riccati-in-ADMM: boxes + general per-stage rows.

    Split ``w = (X_1..N, U_0..N-1)`` against its box projection ``z`` and,
    with general rows, ``s_k = Cx_k x_k + Cu_k u_k`` against its interval
    projection ``zS``; the w-update is one LQR sweep with the iteration-
    invariant gains (:func:`~copra_tpu_torch.ops.stagewise_kernel.
    precompute_lqr_gains`) whose stage costs absorb the row penalties.
    Rows are L2-normalized internally; equality rows get the
    ``rho_eq_scale`` boost.  Returns ``(X, U, info)`` (and the warm tuple,
    in the internal row metric, with ``return_warm``); ``warm_start`` is
    ``(zX, zU, yX, yU)`` or ``(zX, zU, yX, yU, zS, yS)``.

    ``options.early_exit`` runs chunks of ``check_interval`` iterations
    with a residual check after each; each lane of a batch stops at its
    own convergence.  Both loop modes report primal-infeasibility
    certificates from the dual-delta directions, and crossed bounds report
    ``STATUS_PRIMAL_INFEASIBLE`` directly.

    ``parallel_scan=True`` runs every LQ solve (the seed sweep and each
    iteration's w-update, with the ridged stage Hessians and the rows'
    cross term) through :func:`lqr_solve_assoc` in place of the serial
    sweeps with precomputed gains.

    On a CUDA device the early-exit solve (without ``parallel_scan``) runs
    on the stagewise tick kernel, one launch a chunk
    (``ops.stagewise_kernel.solve_stagewise_fused``): the same iterations,
    statuses and iterates.  A problem outside the kernel's envelope
    raises there; ``parallel_scan=True`` keeps the plain loop on the
    device.  On CPU tensors, and for the fixed count, the plain loop runs.

    The plain loop differentiates (``torch.autograd``, ``torch.func``),
    as the reference's loop does; the kernel has no derivative.  So when
    a gradient is asked of ``sqp`` or ``warm_start`` (requires_grad under
    grad mode, a ``torch.func`` transform or a forward-mode tangent), the
    early-exit solve runs the plain loop on the device too, and launches
    no kernel; with no gradient asked it runs the kernel.
    """
    from ..ops._derivative import asks_gradient
    from ..ops.stagewise_kernel import (_lane_residuals, lqr_solve_fixed,
                                        precompute_lqr_gains)

    if (options.early_exit and not parallel_scan and sqp.A.is_cuda
            and not asks_gradient(sqp, warm_start)):
        from ..ops.stagewise_kernel import (check_fused_envelope,
                                            solve_stagewise_fused)
        try:
            check_fused_envelope(sqp.horizon, sqp.xdim, sqp.udim,
                                 sqp.nr_rows, sqp.A.dtype)
        except ValueError as e:
            raise ValueError(
                f"solve_stagewise: on a CUDA device the early-exit solve "
                f"runs on the stagewise tick kernel, and this problem is "
                f"outside its envelope ({e}).  parallel_scan=True runs the "
                f"plain loop on the device; CPU tensors run it too.") from e
        return solve_stagewise_fused(sqp, options, warm_start, return_warm)

    single = sqp.A.dim() == 3
    if single:
        sqp = _lead(sqp)
        if warm_start is not None:
            warm_start = tuple(w.unsqueeze(0) for w in warm_start)
    nb, N = sqp.A.shape[0], sqp.horizon
    dev = sqp.A.device
    kd = dict(dtype=sqp.A.dtype, device=dev)
    sigma, alpha = float(options.sigma), float(options.alpha)
    oma = 1.0 - alpha

    rho_x = _box_penalties(sqp.xlb, sqp.xub, float(options.rho))
    rho_u = _box_penalties(sqp.ulb, sqp.uub, float(options.rho))
    rho_x_safe, rho_u_safe = rho_x.clamp_min(1e-30), rho_u.clamp_min(1e-30)
    box_x, box_u = rho_x > 0, rho_u > 0
    Qx_r, Ru_r, S_cross, rows = _penalized(sqp, options, rho_x, rho_u)
    sweep = lqr_solve_assoc if parallel_scan else lqr_solve
    if not parallel_scan:
        gains_r = precompute_lqr_gains(sqp.A, sqp.B, sqp.d, Qx_r, Ru_r,
                                       S_cross)
    warm0 = _initial_state(
        sqp, options, warm_start, rows,
        lambda: sweep(sqp.A, sqp.B, sqp.d, sqp.Qx, sqp.qx, sqp.Ru, sqp.ru,
                      sqp.x0))

    def one_iter(carry):
        zX, zU, yX, yU, zS, yS, wX, wU = carry
        qx_k = sqp.qx - (rho_x * zX - yX) - sigma * wX
        ru_k = sqp.ru - (rho_u * zU - yU) - sigma * wU
        if rows is not None:
            vS = rows.rho_s * zS - yS
            qx_k = torch.cat([qx_k[:, :-1] - torch.einsum(
                "bkrx,bkr->bkx", rows.Cx, vS), qx_k[:, -1:]], dim=1)
            ru_k = ru_k - torch.einsum("bkru,bkr->bku", rows.Cu, vS)
        if parallel_scan:
            X, U = lqr_solve_assoc(sqp.A, sqp.B, sqp.d, Qx_r, qx_k, Ru_r,
                                   ru_k, sqp.x0, S=S_cross)
        else:
            X, U = lqr_solve_fixed(gains_r, sqp.A, sqp.B, sqp.d, qx_k, ru_k,
                                   sqp.x0)
        Xr = alpha * X + oma * zX
        Ur = alpha * U + oma * zU
        zX_n = torch.where(box_x, torch.clamp(Xr + yX / rho_x_safe,
                                              sqp.xlb, sqp.xub), Xr)
        zU_n = torch.where(box_u, torch.clamp(Ur + yU / rho_u_safe,
                                              sqp.ulb, sqp.uub), Ur)
        # x_0 is data, not a variable: pin its copy
        zX_n = torch.cat([X[:, :1], zX_n[:, 1:]], dim=1)
        yX_n = yX + rho_x * (Xr - zX_n)
        yU_n = yU + rho_u * (Ur - zU_n)
        if rows is not None:
            sr = alpha * rows.eval(X, U) + oma * zS
            zS_n = torch.clamp(sr + yS / rows.rho_s, rows.slo, rows.shi)
            yS_n = yS + rows.rho_s * (sr - zS_n)
        else:
            zS_n, yS_n = zS, yS
        return (zX_n, zU_n, yX_n, yU_n, zS_n, yS_n, X, U)

    def residuals(state):
        return _lane_residuals(sqp, options, rho_x, rho_u, rows, state[6],
                               state[7], *state[:6])

    a_scale = torch.maximum(torch.maximum(_lane_max(sqp.A.abs()),
                                          _lane_max(sqp.B.abs())),
                            torch.ones((), **kd))

    def infeas_cert(state, state_e):
        return _infeas_cert(sqp, options, rows, a_scale, state, state_e)

    izero = torch.zeros((nb,), dtype=torch.int32, device=dev)
    state = warm0 + warm0[:2]
    if options.early_exit:
        # chunks of check_interval iterations, one residual check each;
        # a lane stops updating once it converged or confirmed a
        # certificate (the vmapped while-loop's per-lane select)
        chunk = max(1, min(int(options.check_interval),
                           int(options.max_iter)))
        done = torch.zeros((nb,), dtype=torch.bool, device=dev)
        iters, infeas_code, pend = izero, izero, izero
        while True:
            active = (~done) & (iters < options.max_iter)
            if not bool(active.any()):
                break
            todo = min(chunk, int(options.max_iter)
                       - int(iters[active].max()))
            new = state
            for _ in range(todo):
                new = one_iter(new)
            conv = residuals(new)[2]
            if options.infeasibility_detection:
                infeas = infeas_cert(new, one_iter(new))
            else:
                infeas = izero
            confirmed = torch.where((infeas > 0) & (infeas == pend),
                                    infeas, izero)
            sel = lambda a, b: torch.where(
                active.view((nb,) + (1,) * (a.dim() - 1)), a, b)
            state = tuple(sel(a, b) for a, b in zip(new, state))
            done = sel(conv | (confirmed > 0), done)
            iters = sel(iters + todo, iters)
            infeas_code = sel(torch.maximum(infeas_code, confirmed),
                              infeas_code)
            pend = sel(infeas, pend)
    else:
        for _ in range(int(options.max_iter)):
            state = one_iter(state)
        iters = torch.full((nb,), int(options.max_iter), dtype=torch.int32,
                           device=dev)
        if options.infeasibility_detection:
            # one extra iteration's dual deltas are the certificate
            # directions; two consecutive ones must agree
            state_e = one_iter(state)
            state_e2 = one_iter(state_e)
            a = infeas_cert(state, state_e)
            b = infeas_cert(state_e, state_e2)
            infeas_code = torch.where((a > 0) & (a == b), a, izero)
        else:
            infeas_code = izero
    return _result(sqp, rows, state[6], state[7], state[:6],
                   residuals(state), iters, infeas_code, single,
                   return_warm)


def _infeas_cert(sqp: StagewiseQP, options: SolverOptions,
                 rows: Optional[_Rows], a_scale: Tensor, state,
                 state_e) -> Tensor:
    """Per-lane primal-infeasibility certificate of a batched problem from
    one iteration's dual deltas (the adjoint restricted to the
    dynamics-feasible subspace; the support carries the offset ``<dy, C
    w>`` of the current LQR iterate).  ``state`` and ``state_e`` are
    ``(zX, zU, yX, yU, zS, yS, X, U)`` before and after the iteration.
    The adjoint recursion is that of :func:`stagewise_dual_residual` on
    costs set to zero, taken as its log-depth scan."""
    kd = dict(dtype=sqp.A.dtype, device=sqp.A.device)
    dyX = state_e[2] - state[2]
    dyU = state_e[3] - state[3]
    dyS = state_e[5] - state[5]
    X, U = state_e[6], state_e[7]
    dy_norm = torch.maximum(torch.maximum(_lane_max(dyX.abs()),
                                          _lane_max(dyU.abs())),
                            _lane_max(dyS.abs()))
    free = dataclasses.replace(
        sqp, Qx=torch.zeros_like(sqp.Qx), qx=torch.zeros_like(sqp.qx),
        Ru=torch.zeros_like(sqp.Ru), ru=torch.zeros_like(sqp.ru))
    adj = stagewise_dual_residual(
        free, X, U, dyX, dyU, None if rows is None else dyS * rows.Es,
        parallel=True)
    zero = torch.zeros((), **kd)
    dX = dyX[:, 1:]
    sup = (_lane_sum(torch.where(dX > 0, sqp.xub[:, 1:], zero) * dX
                     + torch.where(dX < 0, sqp.xlb[:, 1:], zero) * dX)
           + _lane_sum(torch.where(dyU > 0, sqp.uub, zero) * dyU
                       + torch.where(dyU < 0, sqp.ulb, zero) * dyU))
    off = _lane_sum(dX * X[:, 1:]) + _lane_sum(dyU * U)
    if rows is not None:
        sup = sup + _lane_sum(
            torch.where(dyS > 0, rows.shi, zero) * dyS
            + torch.where(dyS < 0, rows.slo, zero) * dyS)
        off = off + _lane_sum(dyS * rows.eval(X, U))
    tiny = 1e-30
    prim = ((adj <= options.eps_prim_inf * a_scale
             * dy_norm.clamp_min(tiny))
            & (sup - off <= -1e-3 * dy_norm) & (dy_norm > tiny))
    return torch.where(prim, STATUS_PRIMAL_INFEASIBLE, 0).to(torch.int32)


def _dual_scale(sqp: StagewiseQP) -> Tensor:
    """Natural scale of the stagewise gradient, per lane of a batched
    problem (scalar for one problem)."""
    single = sqp.A.dim() == 3
    s = _lead(sqp) if single else sqp
    one = torch.ones((), dtype=s.A.dtype, device=s.A.device)
    out = torch.maximum(
        torch.maximum(_lane_max(s.Qx.abs()), _lane_max(s.Ru.abs())),
        torch.maximum(torch.maximum(_lane_max(s.qx.abs()),
                                    _lane_max(s.ru.abs())), one))
    return out[0] if single else out


@highest_precision
def stagewise_dual_residual(sqp: StagewiseQP, X: Tensor, U: Tensor,
                            yX: Tensor, yU: Tensor,
                            yS: Optional[Tensor] = None,
                            parallel: bool = False) -> Tensor:
    """True dual (stationarity) residual of the stagewise KKT system.

    The dynamics multipliers are eliminated by the adjoint recursion

        lam_N = Qx_N x_N + qx_N + yX_N
        lam_k = Qx_k x_k + qx_k + A_k' lam_{k+1} + yX_k [+ Cx_k' yS_k]

    leaving ``r_k = Ru_k u_k + ru_k + B_k' lam_{k+1} + yU_k [+ Cu_k' yS_k]``;
    returns ``max |r|`` (per lane of a batch).  The lam-free terms are
    formed in bulk first.  ``parallel=False`` runs the recursion as one
    reverse loop over stages (two fused products a stage);
    ``parallel=True``, the status pass of the serving paths, as the reverse
    associative scan of the affine maps ``lam_k = A_k' lam_{k+1} + c_k``:
    ``ceil(log2 N)`` levels of batched products and no loop over stages.
    """
    single = sqp.A.dim() == 3
    if single:
        sqp = _lead(sqp)
        X, U, yX, yU = (a.unsqueeze(0) for a in (X, U, yX, yU))
        yS = None if yS is None else yS.unsqueeze(0)
    N = sqp.horizon
    cx = _smv(sqp.Qx, X) + sqp.qx + yX                    # [B, N+1, x]
    cu = _smv(sqp.Ru, U) + sqp.ru + yU                    # [B, N, u]
    if yS is not None and sqp.Cx is not None:
        cx = torch.cat([cx[:, :-1] + _smtv(sqp.Cx, yS), cx[:, -1:]], dim=1)
        cu = cu + _smtv(sqp.Cu, yS)
    if parallel:
        # element k = 1..N maps lam_{k+1} to lam_k (the last is the
        # constant lam_N); the reverse scan applies the later suffix first
        nb, x = cx.shape[0], sqp.xdim
        M = torch.cat([sqp.A[:, 1:].mT, sqp.A.new_zeros(nb, 1, x, x)],
                      dim=1)
        _, lam = associative_scan(affine_combine, (M, cx[:, 1:]), dim=1,
                                  reverse=True)
        r_u = cu + _smtv(sqp.B, lam)                      # lam[k] = lam_{k+1}
    else:
        lam = cx[:, N].unsqueeze(-1)                      # [B, x, 1]
        r_u = [None] * N
        for k in range(N - 1, -1, -1):
            r_u[k] = torch.baddbmm(cu[:, k].unsqueeze(-1), sqp.B[:, k].mT,
                                   lam)
            lam = torch.baddbmm(cx[:, k].unsqueeze(-1), sqp.A[:, k].mT, lam)
        r_u = torch.stack(r_u, dim=1)
    out = _lane_max(r_u.abs())
    return out[0] if single else out


def solve_mpc_stagewise(system: System,
                        costs: Sequence[CostFunction] = (),
                        constraints: Sequence[Constraint] = (),
                        options: SolverOptions = SolverOptions(),
                        warm_start=None,
                        parallel_scan: bool = False):
    """One-call stagewise solve: :func:`from_mpc` then
    :func:`solve_stagewise`."""
    sqp = from_mpc(system, costs, constraints)
    return solve_stagewise(sqp, options, warm_start, parallel_scan)


def stack_stagewise(sqps: Sequence[StagewiseQP],
                    repeats: int = 1) -> StagewiseQP:
    """Stack per-lane problems into one batch; ``repeats`` tiles the
    stacked lanes (``[sqp_x, sqp_y]`` with ``repeats=R`` -> 2R lanes)."""
    fields = {}
    for f in dataclasses.fields(StagewiseQP):
        vals = [getattr(s, f.name) for s in sqps]
        if vals[0] is None:
            fields[f.name] = None
            continue
        st = torch.stack(vals)
        fields[f.name] = st.repeat((repeats,) + (1,) * (st.dim() - 1))
    return StagewiseQP(**fields)


def stagewise_scales(sqp: StagewiseQP,
                     sample_lanes: int = 4) -> Tuple[Tensor, Tensor]:
    """Curvature-based diagonal equilibration scales ``(Dx, Du)``.

    ``Du = diag(F_k)^(-1/2)`` (inner control Hessians) and ``Dx =
    diag(V_k)^(-1/2)`` (value Hessians) of the unconstrained Riccati
    recursion, geometric-averaged over stages and over ``sample_lanes``
    lanes of a batch.  Computed on the host in f64; pair with
    :func:`scale_stagewise`.
    """
    batched = sqp.A.dim() == 4
    np64 = lambda t: t.detach().cpu().numpy().astype(np.float64)
    A = np64(sqp.A if batched else sqp.A[None])
    Bm = np64(sqp.B if batched else sqp.B[None])
    Qx = np64(sqp.Qx if batched else sqp.Qx[None])
    Ru = np64(sqp.Ru if batched else sqp.Ru[None])
    nb = A.shape[0]
    idx = np.unique(np.linspace(0, nb - 1,
                                min(sample_lanes, nb)).astype(int))
    A, Bm, Qx, Ru = A[idx], Bm[idx], Qx[idx], Ru[idx]
    nl, N, x = A.shape[0], A.shape[1], A.shape[2]
    u = Bm.shape[3]
    logF = np.zeros(u)
    logV = np.zeros(x)
    for li in range(nl):
        V = Qx[li, -1].copy()
        dF = np.zeros((N, u))
        dV = np.zeros((N + 1, x))
        dV[N] = np.diag(V)
        for k in range(N - 1, -1, -1):
            BtV = Bm[li, k].T @ V
            F = Ru[li, k] + BtV @ Bm[li, k]
            G = BtV @ A[li, k]
            K = -np.linalg.solve(F, G)
            V = Qx[li, k] + A[li, k].T @ V @ A[li, k] + G.T @ K
            V = 0.5 * (V + V.T)
            dF[k] = np.diag(F)
            dV[k] = np.diag(V)
        logF += np.mean(np.log(np.maximum(dF, 1e-30)), axis=0) / nl
        logV += np.mean(np.log(np.maximum(dV, 1e-30)), axis=0) / nl
    kd = dict(dtype=sqp.A.dtype, device=sqp.A.device)
    return (torch.tensor(np.exp(-0.5 * logV), **kd),
            torch.tensor(np.exp(-0.5 * logF), **kd))


def scale_stagewise(sqp: StagewiseQP, Dx: Tensor, Du: Tensor
                    ) -> StagewiseQP:
    """Exact diagonal reparametrization ``x' = x / Dx``, ``u' = u / Du``
    (single or batched problems).  ``X = X' * Dx``, ``U = U' * Du``; row
    values are invariant, so ``clo``/``chi`` are unchanged."""
    Dxi, Dui = 1.0 / Dx, 1.0 / Du
    r = sqp.nr_rows
    data = _scale_data(TickData(sqp.A, sqp.B, sqp.d, sqp.qx, sqp.ru),
                       (Dx, Du))
    return dataclasses.replace(
        sqp, **data._asdict(), x0=sqp.x0 * Dxi,
        Qx=Dx[:, None] * sqp.Qx * Dx[None, :],
        Ru=Du[:, None] * sqp.Ru * Du[None, :],
        xlb=sqp.xlb * Dxi, xub=sqp.xub * Dxi,
        ulb=sqp.ulb * Dui, uub=sqp.uub * Dui,
        Cx=(sqp.Cx * Dx[None, :]) if r else sqp.Cx,
        Cu=(sqp.Cu * Du[None, :]) if r else sqp.Cu)


def _resolve_auto_backend(sqp: StagewiseQP, parallel_scan: bool) -> str:
    """``backend='auto'``: the fused kernel for a problem on a CUDA device
    inside the kernel's envelope, the plain batched path otherwise; outside
    the envelope it warns (an explicit ``backend='fused'`` raises)."""
    if parallel_scan or sqp.A.device.type != "cuda":
        return "xla"
    from ..ops.stagewise_kernel import check_fused_envelope
    try:
        check_fused_envelope(sqp.horizon, sqp.xdim, sqp.udim, sqp.nr_rows,
                             sqp.A.dtype)
    except ValueError as e:
        warnings.warn(
            f"backend='auto': the fused stagewise tick kernel cannot serve "
            f"this problem size; falling back to backend='xla'. ({e})",
            RuntimeWarning, stacklevel=3)
        return "xla"
    return "fused"


def _scale_io(scale, x0):
    """Scale x0 into the equilibrated space; return (x0', unscale_fn)."""
    if scale is None:
        return x0, lambda out: out
    Dx_s, Du_s = scale

    def unscale(out):
        X, U, info, warm = out
        X = X * Dx_s
        U = U * Du_s
        info = dataclasses.replace(info, x=U.reshape(U.shape[:-2] + (-1,)))
        return X, U, info, warm

    return x0 / Dx_s, unscale


def _fused_tick_exec(plan, sqp, scale, x0, warm, options):
    """One fused-kernel tick over a batched (scaled) problem."""
    from ..ops.stagewise_kernel import solve_stagewise_fused
    x0, unscale = _scale_io(scale, x0)
    s = dataclasses.replace(sqp, x0=x0)
    # a serving tick is the fixed count, whatever options.early_exit says
    # (the reference's fused tick has no early exit)
    out = solve_stagewise_fused(s, options.replace(early_exit=False),
                                warm_start=warm,
                                return_warm=True,
                                plan=dataclasses.replace(plan, sqp=s))
    return unscale(out)


def _xla_tick_exec(sqp, scale, x0, warm, options, parallel_scan=False):
    """One tick of the plain batched path (the reference's XLA backend):
    lockstep fixed count across lanes, then the batch-level top-up."""
    opts = options.replace(early_exit=False)
    x0, unscale = _scale_io(scale, x0)
    s = dataclasses.replace(sqp, x0=x0)
    out = solve_stagewise(s, opts, warm_start=warm,
                          parallel_scan=parallel_scan, return_warm=True)
    return unscale(_xla_topup(s, opts, out, parallel_scan))


def _xla_topup(s, opts, out, parallel_scan=False):
    """When any lane's delivered status is non-converged after the fixed
    count, continue all lanes from the delivered warm state for
    ``opts.topup_iters`` more iterations (converged lanes sit at their
    fixed point); a tick where the whole fleet converged skips it.

    The decision is a host check, one sync a tick: this is the plain
    path, run eagerly on the device its tensors are on, and the oracle of
    the fused path, which makes the same decision on the device."""
    topup = int(getattr(opts, "topup_iters", 0))
    if topup <= 0 or not bool((out[2].status == STATUS_MAX_ITER).any()):
        return out
    # seed="zero": a pure continuation of the delivered split state
    t_opts = opts.replace(max_iter=topup, seed="zero", topup_iters=0)
    return solve_stagewise(s, t_opts, warm_start=out[3],
                           parallel_scan=parallel_scan, return_warm=True)


def _leaf_shapes(sqp: StagewiseQP):
    return tuple(None if getattr(sqp, f.name) is None else
                 (tuple(getattr(sqp, f.name).shape),
                  getattr(sqp, f.name).dtype)
                 for f in dataclasses.fields(StagewiseQP))


class StagewiseTick:
    """Callable serving facade built by :func:`make_stagewise_step`.

    ``tick(x0, warm) -> (X, U, info, warm)``; :meth:`replan` swaps the
    problem data in place (same shapes and dtype: a footstep replan, gait
    retarget or model drift) at plan-rebuild cost, and the first post-swap
    tick with a carried warm tuple runs the ``swap_options`` budget.
    """

    def __init__(self, sqp_scaled: StagewiseQP, batched: bool,
                 backend: str, options: SolverOptions,
                 cold_options: SolverOptions,
                 swap_options: SolverOptions, scale,
                 parallel_scan: bool = False, problem=None):
        self._problem = problem
        self._batched = batched
        self._backend = backend
        self._parallel_scan = parallel_scan
        self._options = options
        self._cold_options = cold_options
        self._swap_options = swap_options
        self._scale = scale
        self._swap_pending = False
        self._shapes = _leaf_shapes(sqp_scaled)
        self._set_problem(sqp_scaled)

    @property
    def backend(self) -> str:
        return self._backend

    def _set_problem(self, sqp_scaled: StagewiseQP) -> None:
        """Hold the problem and, on the fused backend, one plan per
        distinct plan key, in tensors of the facade's own.  A replan
        refills them in place, so a graph captured around a tick keeps
        reading them; where a gradient is asked it takes new tensors, so
        that the derivative reaches the new data."""
        from .._graph import copy_into, tree_map
        from ..ops._derivative import asks_gradient

        held = getattr(self, "_sqp", None)
        refill = held is not None and not asks_gradient(held, sqp_scaled)
        if not refill:
            sqp_scaled = tree_map(
                lambda t: t.clone(memory_format=torch.contiguous_format),
                sqp_scaled)
        plans = {}
        if self._backend == "fused":
            from ..ops.stagewise_kernel import build_fused_plan
            for opts in (self._options, self._cold_options,
                         self._swap_options):
                key = self._plan_key(opts)
                if key not in plans:
                    plans[key] = build_fused_plan(sqp_scaled, opts)
        if refill:
            keys = list(plans)
            copy_into([self._sqp] + [self._plans[k] for k in keys],
                      [sqp_scaled] + [plans[k] for k in keys])
        else:
            self._sqp, self._plans = sqp_scaled, plans

    @staticmethod
    def _plan_key(opts: SolverOptions):
        # the plan tensors depend only on these option fields
        return tuple(getattr(opts, f) for f in
                     ("rho", "sigma", "rho_eq_scale", "seed",
                      "polish_iters"))

    def _run(self, opts: SolverOptions, x0, warm):
        if self._backend == "fused":
            return _fused_tick_exec(self._plans[self._plan_key(opts)],
                                    self._sqp, self._scale, x0, warm, opts)
        return _xla_tick_exec(self._sqp, self._scale, x0, warm, opts,
                              self._parallel_scan)

    def _rebuild(self, x0: Tensor) -> None:
        """The problem rebuilt eagerly at ``x0 [B, x]`` (original units):
        the callable's data, scaled, and every plan built again, in the
        facade's own tensors."""
        data = _scale_data(_tick_data(self._problem, x0, self._sqp),
                           self._scale)
        self._set_problem(dataclasses.replace(self._sqp, **data._asdict()))
        profiling.device_counter(REBUILD_COUNTERS, x0.device).add_(1)

    @profiling.traced("copra.stagewise_tick")
    def __call__(self, x0, warm=None):
        if not self._batched:
            x0 = x0[None]
        if self._problem is not None:
            with profiling.trace_span("copra.stagewise.rebuild"):
                self._rebuild(x0)
        if warm is None:
            out = self._run(self._cold_options, x0, None)
        elif self._swap_pending:
            # first post-swap tick: carried duals + the swap budget
            out = self._run(self._swap_options, x0, warm)
        else:
            out = self._run(self._options, x0, warm)
        self._swap_pending = False
        if not self._batched:
            # the warm tuple keeps its lane axis (opaque, fed back as is)
            X, U, info, warm = out
            info = QPSolution(**{f.name: getattr(info, f.name)[0]
                                 for f in dataclasses.fields(QPSolution)})
            out = (X[0], U[0], info, warm)
        return out

    def replan(self, sqp_new: StagewiseQP, *,
               swap_budget: bool = True) -> None:
        """Swap the problem data (same shapes and dtypes) behind the tick.

        Rebuilds only the data-dependent plan tensors, into the facade's
        own (the same buffers; new ones where a gradient is asked); the
        measured scale and every option stay.  The next call with a
        carried ``warm`` runs the ``swap_options`` budget once
        (``swap_budget=False`` disables it).  Raises
        :class:`~copra_tpu_torch.errors.DimensionError` when the shapes or
        dtypes differ: that is a new facade, not a replan.
        """
        if not self._batched and sqp_new.A.dim() == 3:
            sqp_new = _lead(sqp_new)
        if _leaf_shapes(sqp_new) != self._shapes:
            raise DimensionError(
                "StagewiseTick.replan: the new problem's shapes/dtypes "
                "differ from the facade's — build a new facade with "
                "make_stagewise_step instead.  (A replan is a same-shape "
                "DATA swap: new footsteps, references, bounds, or "
                "drifted dynamics.)")
        if self._scale is not None:
            sqp_new = scale_stagewise(sqp_new, *self._scale)
        self._set_problem(sqp_new)
        self._swap_pending = bool(swap_budget)


def make_stagewise_step(sqp: StagewiseQP,
                        options: SolverOptions = SolverOptions(),
                        cold_options: Optional[SolverOptions] = None,
                        parallel_scan: bool = False,
                        backend: str = "auto",
                        scaling="none",
                        swap_options: Optional[SolverOptions] = None,
                        problem=None) -> StagewiseTick:
    """Serving facade for the stagewise engine (the config-5/6 pattern).

    Returns ``tick(x0, warm) -> (X, U, info, warm)`` over a batched
    ``sqp`` (leading lane axis on every leaf; ``x0 [B, x]``).  The first
    call (``warm=None``) runs ``cold_options`` (default: ``options`` with
    10x the iteration budget); later calls run ``options`` with the
    carried warm tuple, plus ``options.topup_iters`` more iterations for
    the whole batch when any lane missed the tolerance.

    ``backend``: ``"fused"`` runs the iterations through the hand-written
    CUDA tick kernel (``ops.stagewise_kernel``; its plain PyTorch version
    on CPU tensors), ``"xla"`` the plain batched :func:`solve_stagewise`
    path (the reference's XLA backend; with ``parallel_scan=True`` its LQ
    solves are :func:`lqr_solve_assoc`), ``"auto"`` (default) the kernel
    for a problem on a CUDA device inside the kernel's envelope.  The
    kernel has no derivative: on a CUDA device a gradient asked of a
    fused tick raises, naming ``backend='xla'``, whose ticks
    differentiate.

    With ``scaling='auto'`` (or an explicit ``(Dx, Du)`` pair) the problem
    is equilibrated once at build; ticks take and return original units,
    but the warm tuple and the reported residuals and statuses live in the
    scaled space.

    ``problem(x0 [B, x]) -> TickData`` (optional): the problem's
    data-dependent fields at each tick's initial states, in original units
    (a QP linearised again at every MPC step); each call rebuilds the
    problem from it before it solves (eagerly: the scale stays the one of
    the build, every plan is built again).
    """
    if backend == "fused" and parallel_scan:
        raise ValueError(
            "make_stagewise_step(backend='fused', parallel_scan=True) is "
            "contradictory: the fused tick kernel runs the serial "
            "lane-batched sweeps.  Use backend='xla' for the "
            "associative-scan path, or drop parallel_scan for the kernel.")
    if backend not in ("auto", "fused", "xla"):
        raise ValueError(f"backend must be 'auto', 'fused' or 'xla', got "
                         f"{backend!r}")
    if cold_options is None:
        cold_options = options.replace(max_iter=10 * options.max_iter)
    batched = sqp.A.dim() == 4

    scale = None
    if isinstance(scaling, str) and scaling == "auto":
        scale = stagewise_scales(sqp)
    elif isinstance(scaling, tuple):
        scale = scaling
    if scale is not None:
        sqp = scale_stagewise(sqp, *scale)
    if backend == "auto":
        backend = _resolve_auto_backend(sqp, parallel_scan)
    elif backend == "fused" and sqp.A.device.type == "cuda":
        from ..ops.stagewise_kernel import check_fused_envelope
        check_fused_envelope(sqp.horizon, sqp.xdim, sqp.udim, sqp.nr_rows,
                             sqp.A.dtype)
    if backend != "fused" and getattr(options, "polish_iters", 0) > 0:
        # the f64 polish continues the kernel's delivered iterate: a
        # plain-path tick serving the unpolished iteration says so
        warnings.warn(
            "make_stagewise_step: options.polish_iters is applied by the "
            "FUSED backend only; this plain-path tick serves the plain "
            "float32 iteration (~2e-5 floor on stiff problems).  Use "
            "backend='fused', or float64 data.", stacklevel=2)
    sqp_b = sqp if batched else _lead(sqp)
    if swap_options is None:
        swap_options = cold_options
    return StagewiseTick(sqp_b, batched, backend, options, cold_options,
                         swap_options, scale, parallel_scan, problem)


def _curvature_spread(sqp: StagewiseQP) -> float:
    """max / min of the positive diagonal entries of the stage Hessians
    ``Qx`` and ``Ru`` (host-side): the cheap predictor of whether
    equilibration is needed (forces O(100 N) against states O(0.1), the
    config-6 regime, stall raw ADMM)."""
    d = np.abs(np.concatenate([
        torch.diagonal(t, dim1=-2, dim2=-1).detach().cpu().numpy()
        .astype(np.float64).ravel() for t in (sqp.Qx, sqp.Ru)]))
    d = d[d > 0]
    return float(d.max() / d.min()) if d.size else 1.0


def _probe_setup(sqp: StagewiseQP, probe_lanes: int, probe_steps: int,
                 drift_scale):
    """Probe scaffolding of the measured serving policies: ``probe_lanes``
    lanes spread over the batch and a drifting receding-horizon ``x0``
    sequence (consecutive ticks one small step apart, the deployment
    pattern), drawn from ``np.random.default_rng(0)`` as the reference
    draws it, so both probes see the same states.  ``drift_scale`` is a
    scalar or a per-coordinate ``[x]`` vector (a caller probing an
    equilibrated problem passes the physical drift mapped into scaled
    space).  Returns ``(sqp_p, nl, x0_p, drift, x0_seq)``; ``x0_seq``
    tensors on the problem's device in its dtype.  The probe lanes are
    detached: a policy only reads the problem's values, so a problem that
    asks for a gradient gets a server whose plain ticks differentiate."""
    sqp_b = sqp if sqp.A.dim() == 4 else _lead(sqp)
    nb = sqp_b.A.shape[0]
    idx = np.unique(np.linspace(0, nb - 1,
                                min(probe_lanes, nb)).astype(int))
    sel = torch.as_tensor(idx, device=sqp_b.A.device)
    sqp_p = StagewiseQP(**{
        f.name: None if getattr(sqp_b, f.name) is None
        else getattr(sqp_b, f.name).detach().index_select(0, sel)
        for f in dataclasses.fields(StagewiseQP)})
    nl, x = len(idx), sqp_p.xdim
    rng = np.random.default_rng(0)
    drift = rng.normal(scale=np.broadcast_to(
        np.asarray(drift_scale, np.float64), (x,)),
        size=(probe_steps + 1, nl, x)).cumsum(0)
    x0_p = sqp_p.x0.detach().cpu().numpy().astype(np.float64)
    np_dt = sqp_p.x0.detach().cpu().numpy().dtype
    x0_seq = [torch.tensor((x0_p + drift[t]).astype(np_dt),
                           device=sqp_p.x0.device)
              for t in range(probe_steps + 1)]
    return sqp_p, nl, x0_p, drift, x0_seq


def _probe_exact(sqp_p: StagewiseQP, nl: int, x0_p, drift,
                 options: SolverOptions, parallel_scan: bool):
    """The exactness reference every candidate is gated against: float64
    early-exit solves of the probe lanes at the final probe state, with
    ``max(200 max_iter, 20000)`` iterations at ``eps_abs = min(eps_abs,
    1e-8)``.  Runs on the problem's device (the reference pins it to the
    CPU, where its TPU had no float64; here the CPU loop is Python): on a
    CUDA device the float64 tick kernel in chunks (:func:`solve_stagewise`),
    every lane of one batched solve, each stopping at its own
    convergence.  Returns one ``U [N, u]`` numpy array a lane."""
    sqp64 = StagewiseQP(**{
        f.name: None if getattr(sqp_p, f.name) is None
        else getattr(sqp_p, f.name).to(torch.float64)
        for f in dataclasses.fields(StagewiseQP)})
    oracle_opts = options.replace(
        max_iter=max(200 * options.max_iter, 20_000), early_exit=True,
        eps_abs=min(options.eps_abs, 1e-8), eps_rel=0.0)
    x0 = torch.tensor(x0_p + drift[-1], dtype=torch.float64,
                      device=sqp64.A.device)
    _, U_e, _ = solve_stagewise(dataclasses.replace(sqp64, x0=x0),
                                oracle_opts, parallel_scan=parallel_scan)
    U_e = U_e.cpu().numpy()
    return [U_e[k] for k in range(nl)]


def _probe_ticks(sqp_p: StagewiseQP, x0_seq, options: SolverOptions,
                 cold_options: Optional[SolverOptions],
                 parallel_scan: bool) -> np.ndarray:
    """The real cold-then-warm tick pattern over ``x0_seq`` on the probe
    lanes; the last tick's ``U`` in float64.  The ticks run the fused
    backend on a CUDA device and the plain one on the CPU (the two are
    update-identical), without the polish: the probes measure the plain
    iteration, as the reference's do."""
    backend = ("fused" if sqp_p.A.is_cuda and not parallel_scan
               else "xla")
    options = options.replace(polish_iters=0)
    if cold_options is not None:
        cold_options = cold_options.replace(polish_iters=0)
    tick = make_stagewise_step(sqp_p, options, cold_options=cold_options,
                               parallel_scan=parallel_scan, backend=backend)
    warm = U = None
    for x0 in x0_seq:
        _, U, _, warm = tick(x0, warm)
    return U.double().cpu().numpy()


def auto_rho_stagewise(sqp: StagewiseQP,
                       options: SolverOptions = SolverOptions(),
                       cold_options: Optional[SolverOptions] = None,
                       probe_lanes: int = 2,
                       probe_steps: int = 3,
                       candidates=(0.03, 0.1, 0.3, 1.0, 3.0),
                       drift_scale: float = 0.002,
                       parallel_scan: bool = False,
                       return_probe: bool = False):
    """Measured static ADMM penalty for fixed-count stagewise serving.

    Runs the real cold+warm tick pattern (``options`` budget) at each
    candidate penalty over ``probe_lanes`` lanes spread over the batch,
    gates each against the float64 high-budget early-exit oracle of the
    same problems (:func:`_probe_exact`) and returns the ``rho`` whose
    last tick's controls are closest (with ``return_probe=True`` also the
    ``{candidate: max |U - U_exact|}`` probe).  Candidates are absolute:
    rows are L2-normalized inside the solver, so the penalty is
    dimensionless against unit-norm rows.  A one-time build cost.  Probe
    a batched fleet: a one-lane probe can pick a penalty tuned to one
    ``x0`` that fails fleet-wide.

    The probe runs on the problem's device: on a CUDA device the ticks on
    the stagewise tick kernel and the oracle on its float64 early-exit
    route.
    """
    sqp_p, nl, x0_p, drift, x0_seq = _probe_setup(
        sqp, probe_lanes, probe_steps, drift_scale)
    exact = _probe_exact(sqp_p, nl, x0_p, drift, options, parallel_scan)
    probe = {}
    for cand in candidates:
        U = _probe_ticks(
            sqp_p, x0_seq, options.replace(rho=float(cand)),
            None if cold_options is None
            else cold_options.replace(rho=float(cand)), parallel_scan)
        probe[cand] = max(float(np.abs(U[k] - exact[k]).max())
                          for k in range(nl))
    best = min(probe, key=probe.get)
    if return_probe:
        return float(best), probe
    return float(best)


def auto_iters_stagewise(sqp: StagewiseQP,
                         options: SolverOptions = SolverOptions(),
                         cold_options: Optional[SolverOptions] = None,
                         probe_lanes: int = 2,
                         probe_steps: int = 3,
                         candidates=(10, 20, 30, 50, 80, 120, 200),
                         target_applied_err: float = 1e-5,
                         drift_scale: float = 0.002,
                         parallel_scan: bool = False,
                         return_probe: bool = False,
                         target_tail_err: Optional[float] = None):
    """Measured warm-tick iteration budget for receding-horizon serving.

    Runs the real cold+warm tick pattern over a drifting ``x0`` sequence
    on the probe lanes for each candidate iteration count and measures
    the error of the applied control ``U[0]`` (and of the whole horizon,
    ``tail_err``) against the float64 oracle at the same state.  Returns
    the smallest candidate whose ``applied_err`` meets
    ``target_applied_err`` (and, when given, whose ``tail_err`` meets
    ``target_tail_err``, the gate of throughput lines that span the whole
    control vector); if none does, the candidate with the smallest error
    (``tail_err`` when a tail target is given, else ``applied_err``).
    ``return_probe=True`` also returns the measured Pareto, candidate ->
    ``{"applied_err", "tail_err"}``.

    The probe does not apply ``options.polish_iters``: the errors are
    those of the plain float32 iteration.  When the serving options
    polish, pick targets at the pre-polish floor (e.g.
    ``target_tail_err=3e-5``) and gate the delivered accuracy apart.
    Runs on the problem's device, as :func:`auto_rho_stagewise`.
    """
    sqp_p, nl, x0_p, drift, x0_seq = _probe_setup(
        sqp, probe_lanes, probe_steps, drift_scale)
    exact = _probe_exact(sqp_p, nl, x0_p, drift, options, parallel_scan)
    probe = {}
    for cand in sorted(int(c) for c in candidates):
        U = _probe_ticks(sqp_p, x0_seq, options.replace(max_iter=cand),
                         cold_options, parallel_scan)
        probe[cand] = {
            "applied_err": max(float(np.abs(U[k][0] - exact[k][0]).max())
                               for k in range(nl)),
            "tail_err": max(float(np.abs(U[k] - exact[k]).max())
                            for k in range(nl)),
        }
    meeting = [c for c, e in probe.items()
               if e["applied_err"] <= target_applied_err
               and (target_tail_err is None
                    or e["tail_err"] <= target_tail_err)]
    rank = (lambda c: probe[c]["tail_err"]) if target_tail_err \
        else (lambda c: probe[c]["applied_err"])
    best = min(meeting) if meeting else min(probe, key=rank)
    if return_probe:
        return int(best), probe
    return int(best)


def make_stagewise_server(sqp: StagewiseQP, *,
                          target_applied_err: float = 1e-5,
                          drift_scale=0.002,
                          backend: str = "auto",
                          parallel_scan: bool = False,
                          return_policy: bool = False):
    """No-knobs serving facade: one call in place of the hand-assembled
    recipe.  It measures whether curvature equilibration is warranted
    (:func:`stagewise_scales` when the stage Hessians' diagonal spread
    exceeds 1e4, the quadruped force-against-state regime), measures the
    serving ``rho`` (:func:`auto_rho_stagewise`) and the warm iteration
    budget for the applied-control contract (:func:`auto_iters_stagewise`),
    both with 4 probe lanes and 2000-iteration cold ticks at ``eps_abs =
    max(target_applied_err, 25 eps(dtype))``, arms a top-up of 4 times
    the warm budget, and returns the :class:`StagewiseTick`.

    ``drift_scale`` is the per-tick ``x0`` drift of the deployment in
    physical units (mapped into the scaled space for the probes).
    ``return_policy=True`` also returns ``{"rho", "warm_iters", "scaled",
    "options"}``.
    """
    sqp_b = sqp if sqp.A.dim() == 4 else _lead(sqp)
    scale = stagewise_scales(sqp_b) if _curvature_spread(sqp_b) > 1e4 \
        else None
    probe = sqp_b if scale is None else scale_stagewise(sqp_b, *scale)
    p_drift = (drift_scale if scale is None
               else np.asarray(drift_scale, np.float64)
               / scale[0].detach().cpu().numpy().astype(np.float64))
    eps_abs = max(float(target_applied_err),
                  25.0 * float(torch.finfo(sqp_b.A.dtype).eps))
    cold = SolverOptions(max_iter=2000, early_exit=False, polish=False,
                         eps_abs=eps_abs)
    rho = auto_rho_stagewise(probe, cold.replace(max_iter=30),
                             cold_options=cold, probe_lanes=4,
                             drift_scale=p_drift)
    cold = cold.replace(rho=float(rho))
    witers = auto_iters_stagewise(probe, cold, cold_options=cold,
                                  probe_lanes=4,
                                  target_applied_err=target_applied_err,
                                  drift_scale=p_drift)
    wopts = cold.replace(max_iter=witers, topup_iters=4 * witers)
    tick = make_stagewise_step(sqp, wopts, cold_options=cold,
                               parallel_scan=parallel_scan, backend=backend,
                               scaling="none" if scale is None else scale)
    if return_policy:
        return tick, {"rho": float(rho), "warm_iters": int(witers),
                      "scaled": scale is not None, "options": wopts}
    return tick


# the eager route of a captured stagewise chain, which differentiates
_PLAIN_TICKS = "make_stagewise_step(..., backend='xla') tick by tick"
_NO_SPAN = contextlib.nullcontext()


class StagewiseMultistep:
    """Callable chain facade built by :func:`make_stagewise_multistep`:
    ``step_many(x0, n_ticks, warm=None, x0_seq=None) -> (states, U0s,
    statuses, info, warm)``; :meth:`replan` swaps same-shape problem data
    behind the chain and its leading cold tick."""

    def __init__(self, sqp_b: StagewiseQP, scale, batched: bool,
                 backend: str, parallel_scan: bool, options: SolverOptions,
                 plant, cold_tick: StagewiseTick, problem=None):
        self._problem = problem
        self._batched = batched
        self._backend = backend
        self._parallel_scan = parallel_scan
        self._options = options
        self._scale = scale
        self._plant_fn = plant
        self._cold_tick = cold_tick
        self._shapes = _leaf_shapes(sqp_b)
        self._device = sqp_b.A.device
        self._dtype = sqp_b.A.dtype
        # the chain's data: its own tensors, which a replan refills in
        # place, so a captured graph keeps reading them
        self._data = self._build(sqp_b)
        self._graph = backend == "fused" and self._device.type == "cuda"
        self._chains = {}
        self._served = None

    @property
    def backend(self) -> str:
        return self._backend

    @property
    def chains(self):
        """The captured chains by ``(n_ticks, exogenous)`` (CUDA, fused
        backend)."""
        return self._chains

    def _build(self, sqp_b: StagewiseQP):
        """``(sqp_b, sqp_s, plant data, fused plan or None, the ridged
        stage Hessians or None)``, every tensor with storage of its own (so
        that it can take a replan, or a tick's rebuild, in place).  The
        ridged Hessians ``(Qx_r, Ru_r, S)`` are kept where a fused tick
        refactors its gains from each tick's data; such a plan on the card
        keeps only its lane-first copy ``plan_lf`` (``plan`` is None)."""
        from .._graph import tree_map

        sqp_b = tree_map(
            lambda t: t.clone(memory_format=torch.contiguous_format), sqp_b)
        sqp_s = (sqp_b if self._scale is None
                 else scale_stagewise(sqp_b, *self._scale))
        pargs = tuple(t[:, 0].contiguous() for t in
                      (sqp_b.A, sqp_b.B, sqp_b.d))
        fp = ridged = None
        if self._backend == "fused":
            from ..ops.stagewise_kernel import build_fused_plan
            fp = build_fused_plan(sqp_s, self._options)
            sqp_s = fp.sqp
            if self._problem is not None:
                ridged = tuple(
                    None if t is None else t.contiguous() for t in
                    _penalized(sqp_s, self._options, fp.rho_x,
                               fp.rho_u)[:3])
                if fp.plan_lf is not None:
                    # the rebuild refreshes only the copy the kernel reads:
                    # the lane-last plan would go stale, so it is dropped
                    fp = dataclasses.replace(fp, plan=None)
        return sqp_b, sqp_s, pargs, fp, ridged

    def _rebuild(self, xk: Tensor) -> None:
        """The tick's problem rebuilt at ``xk`` (original units) in the
        chain's own tensors: the callable's data, scaled by the build's
        equilibration, into the problem, and on the fused backend the
        plan's data-dependent columns and gains refactored on the device
        (:func:`~copra_tpu_torch.ops.gains_kernel.riccati_gains_into_plan`,
        one launch, into the copy of the plan the tick kernel reads).
        Nothing here syncs the host, so a captured chain holds it."""
        sqp_b, sqp_s, pargs, fp, ridged = self._data
        data = _tick_data(self._problem, xk, sqp_b)
        for t, v in zip(pargs, (data.A, data.B, data.d)):
            t.copy_(v[:, 0])
        for name, v in zip(TickData._fields,
                           _scale_data(data, self._scale)):
            getattr(sqp_s, name).copy_(v)
        if fp is not None:
            from ..ops.gains_kernel import riccati_gains_into_plan
            lane_first = fp.plan_lf is not None
            riccati_gains_into_plan(
                fp.plan_lf if lane_first else fp.plan, lane_first=lane_first,
                x=sqp_s.xdim, u=sqp_s.udim, r=sqp_s.nr_rows, A=sqp_s.A,
                B=sqp_s.B, d=sqp_s.d, Qx_r=ridged[0], Ru_r=ridged[1],
                S=ridged[2], qx=sqp_s.qx, ru=sqp_s.ru)
        profiling.device_counter(REBUILD_COUNTERS, xk.device).add_(1)

    def _tick(self, xk: Tensor, warm):
        """One warm tick at the original-units state ``xk`` (its problem
        rebuilt there first, where a callable gives it)."""
        if self._problem is not None:
            with profiling.trace_span("copra.stagewise.rebuild"):
                self._rebuild(xk)
        _, sqp_s, _, fp, _ = self._data
        if fp is not None:
            return _fused_tick_exec(fp, sqp_s, self._scale, xk, warm,
                                    self._options)
        return _xla_tick_exec(sqp_s, self._scale, xk, warm, self._options,
                              self._parallel_scan)

    def _plant(self, xk: Tensor, U: Tensor) -> Tensor:
        if self._plant_fn is not None:
            return self._plant_fn(xk, U)
        A0, B0, d0 = self._data[2]
        return _smv(A0, xk) + _smv(B0, U[:, 0]) + d0

    def _chain(self, n_ticks: int, x0: Tensor, warm, xs=None):
        """The ticks of one call: ``(next states [T, B, x], first controls
        [T, B, u], statuses [T, B], the last tick's info, warm)``; tick
        ``t`` solves at ``xs[t]`` when given, else at the plant's
        state."""
        x_prev, nexts, u0s, statuses = x0, [], [], []
        for t in range(n_ticks):
            xk = x_prev if xs is None else xs[t]
            _, U, info, warm = self._tick(xk, warm)
            x_prev = self._plant(xk, U)
            nexts.append(x_prev)
            u0s.append(U[:, 0])
            statuses.append(info.status)
        return (torch.stack(nexts), torch.stack(u0s), torch.stack(statuses),
                info, warm)

    def _run(self, n_ticks: int, x0: Tensor, warm, xs):
        if not self._graph:
            return self._chain(n_ticks, x0, warm, xs)
        from .._graph import CapturedChain, tree_map

        exogenous = xs is not None
        key = (n_ticks, exogenous)
        warm = tuple(warm)
        chain = self._chains.get(key)
        if chain is None:
            if self._plant_fn is not None:
                self._check_plant(x0)
            if exogenous:
                fn = lambda xs_, *w: self._chain(n_ticks, xs_[0], w, xs_)
            else:
                fn = lambda x0_, *w: self._chain(n_ticks, x0_, w)
            with (profiling.trace_span("copra.stagewise.rebuild")
                  if self._problem is not None else _NO_SPAN):
                chain = self._chains[key] = CapturedChain(
                    fn, (xs if exogenous else x0,) + warm,
                    "make_stagewise_multistep", _PLAIN_TICKS)
        out = chain(xs if exogenous else x0, *warm)
        with profiling.trace_span("copra.chain.copy_out"):
            return tree_map(torch.clone, out)

    def _check_plant(self, x0: Tensor) -> None:
        """Capture the custom plant alone, so that one the chain cannot
        hold raises naming it."""
        from .._graph import CapturedChain

        B = self._data[0].B
        U = x0.new_zeros(B.shape[:2] + B.shape[-1:])
        name = getattr(self._plant_fn, "__name__", repr(self._plant_fn))
        CapturedChain(self._plant_fn, (x0, U),
                      f"make_stagewise_multistep: the plant {name!r}",
                      _PLAIN_TICKS)

    def replan(self, sqp_new: StagewiseQP) -> None:
        """Swap the problem data (same shapes and dtypes) behind the chain
        and its leading cold tick.  The new data is copied into the
        chain's own tensors (the fused plan's too), so a captured chain
        runs it without a new capture.  Raises
        :class:`~copra_tpu_torch.errors.DimensionError` when the shapes or
        dtypes differ: that is a new facade, not a replan."""
        from .._graph import copy_into

        if not self._batched and sqp_new.A.dim() == 3:
            sqp_new = _lead(sqp_new)
        if _leaf_shapes(sqp_new) != self._shapes:
            raise DimensionError(
                "StagewiseMultistep.replan: the new problem's shapes/dtypes "
                "differ from the facade's — build a new facade with "
                "make_stagewise_multistep instead.")
        copy_into(self._data, self._build(sqp_new))
        self._cold_tick.replan(sqp_new)

    @profiling.traced("copra.stagewise_serve")
    def serve(self, x0) -> Tensor:
        """One tick of an exogenous state stream, the warm state held by the
        chain: the controls ``U [B, N * u]`` (``[N * u]`` unbatched) of the
        tick at ``x0 [B, x]`` in original units, the call's own tensor.
        Each call is one warm tick from the state the last one left (the
        first from the leading cold tick's at ``x0``): the controls of
        ``step_many(None, 1, warm, x0_seq=x0[None])`` with the warm tuple
        carried, without handing the warm state, the states or the
        statuses out.  On a CUDA device with the fused backend the tick is
        one CUDA graph, captured on the first warm call, that also writes
        its new warm state over its input: a call copies ``x0`` in,
        replays and clones ``U``."""
        kd = dict(dtype=self._dtype, device=self._device)
        x0 = torch.as_tensor(x0).to(**kd)
        if not self._batched:
            x0 = x0[None]
        if self._served is None:
            # the leading cold tick: a warm-up solve at the first state
            self._served = tuple(w.clone() for w in self._cold_tick(x0)[3])
        if not self._graph:
            _, U, _, warm = self._tick(x0, self._served)
            self._served = tuple(warm)
            U = U.reshape(U.shape[0], -1)
        else:
            U = self._serve_chain(x0)
        return U if self._batched else U[0]

    def _serve_chain(self, x0: Tensor) -> Tensor:
        from .._graph import CapturedChain

        chain = self._chains.get("serve")
        if chain is None:
            def fn(x, *w):
                _, U, _, new = self._tick(x, w)
                for dst, src in zip(w, new):
                    dst.copy_(src)
                return U.reshape(U.shape[0], -1)

            held = self._served
            with (profiling.trace_span("copra.stagewise.rebuild")
                  if self._problem is not None else _NO_SPAN):
                chain = self._chains["serve"] = CapturedChain(
                    fn, (x0,) + held, "make_stagewise_multistep(...).serve",
                    _PLAIN_TICKS)
            # the run before the capture ticked the chain's warm state: the
            # first replay starts from the cold tick's again
            for dst, src in zip(chain.inputs[1:], held):
                dst.copy_(src)
            self._served = chain.inputs[1:]
        U = chain(x0)
        with profiling.trace_span("copra.chain.copy_out"):
            return U.clone()

    @profiling.traced("copra.stagewise_multistep")
    def __call__(self, x0, n_ticks: int, warm=None, x0_seq=None):
        n_ticks = int(n_ticks)
        if n_ticks < 1:
            raise ValueError(f"n_ticks must be >= 1, got {n_ticks}")
        if x0_seq is not None and x0_seq.shape[0] != n_ticks:
            raise ValueError(
                f"x0_seq has {x0_seq.shape[0]} ticks but n_ticks="
                f"{n_ticks}; the exogenous stream defines the chain length "
                f"— pass matching values.")
        kd = dict(dtype=self._dtype, device=self._device)
        exogenous = x0_seq is not None
        if exogenous:
            x0_seq = torch.as_tensor(x0_seq).to(**kd)
            if not self._batched:
                x0_seq = x0_seq[:, None]
            x0 = x0_seq[0]
        else:
            x0 = torch.as_tensor(x0).to(**kd)
            if not self._batched:
                x0 = x0[None]
        states0 = x0
        cold = None
        if warm is None:
            # the leading cold tick: its own budget, outside the chain
            _, Uc, infoc, warm = self._cold_tick(states0)
            if not exogenous:
                x0 = self._plant(x0, Uc)
                cold = (Uc[:, 0], infoc.status)
        nexts, u0s, statuses, info, warm = self._run(n_ticks, x0, warm,
                                                     x0_seq)
        with profiling.trace_span("copra.chain.copy_out"):
            if cold is not None:
                # the cold tick's control was applied to the plant: return
                # it, so that states[k+1] == plant(states[k], U0s[k])
                # throughout
                u0s = torch.cat([cold[0][None], u0s])
                statuses = torch.cat([cold[1][None], statuses])
                nexts = torch.cat([x0[None], nexts])
            states = torch.cat([states0[None], nexts])
        if not self._batched:
            states, u0s, statuses = states[:, 0], u0s[:, 0], statuses[:, 0]
            info = QPSolution(**{f.name: getattr(info, f.name)[0]
                                 for f in dataclasses.fields(QPSolution)})
        return states, u0s, statuses, info, warm


@profiling.traced("copra.make_stagewise_multistep")
def make_stagewise_multistep(sqp: StagewiseQP,
                             options: SolverOptions = SolverOptions(),
                             cold_options: Optional[SolverOptions] = None,
                             parallel_scan: bool = False,
                             backend: str = "auto",
                             plant=None,
                             scaling="none",
                             problem=None) -> StagewiseMultistep:
    """Multi-tick serving for the stagewise engine: ``n_ticks`` receding-
    horizon ticks per call, with the plant rollout (or an exogenous state
    stream) between them.

    Returns ``step_many(x0, n_ticks, warm=None, x0_seq=None)``:

    * ``x0 [B, x]``: the fleet's state at the first tick (``[x]`` for an
      unbatched ``sqp``).
    * ``warm``: the carried warm tuple; ``None`` runs one leading cold
      tick (``cold_options``, through :func:`make_stagewise_step`, outside
      the chain) whose control is applied before the chain starts.
    * ``x0_seq [n_ticks, B, x]``: an exogenous state stream (an
      estimator's output); tick ``k`` solves at ``x0_seq[k]``, and ``x0``
      is ignored.  Its length must equal ``n_ticks``.
    * ``plant(x [B, x], U [B, N, u]) -> next x [B, x]`` (factory
      argument), by default each lane's stage-0 dynamics on the first
      control.

    It returns ``(states, U0s, statuses, info, warm)``, ``info`` the last
    tick's :class:`QPSolution`.  The arrays form one closed-loop rollout,
    ``states[k+1] == plant(states[k], U0s[k])``: in plant mode with
    ``warm=None`` the cold tick's control is included, so ``states`` is
    ``[n_ticks+2, B, x]`` and ``U0s``, ``statuses`` ``[n_ticks+1, ...]``;
    otherwise (a carried ``warm``, or ``x0_seq`` mode, where the cold tick
    is a warm-up solve at ``x0_seq[0]``) ``[n_ticks+1]`` and ``[n_ticks]``.
    With ``scaling``, states and controls are in original units and the
    statuses and residuals in the scaled space, as for
    :func:`make_stagewise_step`.

    On a CUDA device with ``backend="fused"`` (or ``"auto"`` choosing it)
    the chain is one CUDA graph per ``(n_ticks, exogenous)``, captured on
    its first call: the kernel tick (K4 or K5), the top-up decided on the
    device, the log-depth status pass and the plant, with no host sync; a
    custom plant the graph cannot hold raises, naming it.  ``replan``
    copies the new data into the captured tensors, so it needs no new
    capture.  The returned tensors are the call's own.  With
    ``backend="xla"`` or on CPU tensors the same ticks run eagerly.

    ``problem(x0 [B, x]) -> TickData`` (optional) makes each tick's problem
    a function of its initial states (a QP linearised again at every MPC
    step): ``A``, ``B``, ``d``, ``qx`` and ``ru`` in original units, which
    the tick scales by the build's fixed equilibration and writes into the
    chain's tensors; on the fused backend it then refactors the Riccati
    gains into the plan's data-dependent columns on the device (one launch
    of ``csrc/riccati_gains.cu``) and runs K4 or K5 and the top-up as
    before.  On the card that is part of the tick's one CUDA graph (the
    callable must be torch ops without a host sync); the penalties, row
    normalisation and boxes stay as built.  The leading cold tick rebuilds
    eagerly.  Each rebuild adds one to the device counter
    ``stagewise.rebuilds``.  On the fused backend a callable needs
    ``polish_iters=0``, and rows or ``seed='zero'``.  Without a callable
    the chain is as it was.
    """
    if backend == "fused" and parallel_scan:
        raise ValueError(
            "make_stagewise_multistep(backend='fused', parallel_scan=True) "
            "is contradictory: the fused tick kernel runs the serial "
            "lane-batched sweeps.  Use backend='xla' for the associative-"
            "scan path, or drop parallel_scan.")
    batched = sqp.A.dim() == 4
    sqp_b = sqp if batched else _lead(sqp)
    scale = None
    if isinstance(scaling, str) and scaling == "auto":
        scale = stagewise_scales(sqp_b)
    elif isinstance(scaling, tuple):
        scale = scaling
    cold_tick = make_stagewise_step(sqp_b, options,
                                    cold_options=cold_options,
                                    parallel_scan=parallel_scan,
                                    backend=backend,
                                    scaling="none" if scale is None
                                    else scale, problem=problem)
    _refuse_stale_plan(problem, options, sqp_b.Cx is not None,
                       cold_tick.backend)
    return StagewiseMultistep(sqp_b, scale, batched, cold_tick.backend,
                              parallel_scan, options, plant, cold_tick,
                              problem)
