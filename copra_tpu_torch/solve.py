"""No-knobs one-shot solve: the reference's ``LMPC::solve()`` experience.

Port of ``copra_tpu/solve.py``.  :func:`solve` takes one well-posed MPC
problem cold, with no solver options: it inspects the problem, picks the
engine and its policies, escalates budgets until the accuracy contract is
met, and falls back to the exact native active-set engine
(``native/activeset.cpp``) when the iterative engines cannot close.  The
caller gets a contract-meeting answer or an honest non-converged status.

Engine selection (``"auto"``):

* **condensed** (default): dense QP and ADMM with scaling, adaptive rho
  and the active-set polish, for reference-scale problems;
* **stagewise**: Riccati-in-ADMM, O(N) an iteration, when the problem is
  per-stage expressible and its condensed form would be large (``N u``
  variables beyond 300), equilibrated by
  :func:`~copra_tpu_torch.qp.riccati.stagewise_scales` when the stage
  Hessians' spread warrants it; a problem with no bounds and no rows is
  one exact Riccati sweep (``iterations == 1``).  On a CUDA device its
  early-exit solves run on the stagewise tick kernel;
* **native**: the exact float64 active-set engine, also selectable
  directly; and the route of float32 data whose precision cannot certify
  the requested accuracy.

Batched fleets and receding-horizon serving have their own facades
(:func:`~copra_tpu_torch.plan.make_plan_step`,
:func:`~copra_tpu_torch.qp.riccati.make_stagewise_step`,
:func:`~copra_tpu_torch.qp.riccati.make_stagewise_server`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .constraints import Constraint
from .costs import CostFunction
from .errors import DimensionError, InfeasibleProblemError
from .mpc import MPCResult, build_qp
from .qp.types import STATUS_SOLVED, QPSolution, SolverOptions, WarmStart
from .systems import System, condense

__all__ = ["solve"]

# condensed size above which the stagewise engine is preferred (dense KKT
# factorization is O((N u)^3); the stagewise sweep O(N))
_STAGEWISE_NVAR = 300

ENGINES = ("auto", "condensed", "stagewise", "native")


def _dtype_floor(dt) -> float:
    return 50.0 * float(torch.finfo(dt).eps)


def _native_solve(system, preview, qp) -> Optional[MPCResult]:
    from .qp.native import native_available, solve_qp_native

    if not native_available():                     # pragma: no cover
        return None
    sol = solve_qp_native(qp)
    u = sol.x.to(dtype=qp.Q.dtype, device=qp.Q.device)
    return MPCResult(control=u, trajectory=preview.trajectory(system.x0, u),
                     solution=sol)


def _unconstrained(sqp) -> bool:
    """No finite bounds and no general rows: an equality-constrained LQ
    problem, one exact Riccati sweep."""
    if sqp.nr_rows:
        return False
    return not any(bool(torch.isfinite(t).any())
                   for t in (sqp.xlb, sqp.xub, sqp.ulb, sqp.uub))


def _route(system: System, costs: Tuple[CostFunction, ...],
           constraints: Tuple[Constraint, ...], engine: str,
           accuracy: float):
    """The inspection: ``(stagewise, floor, sqp)``.  ``stagewise``: the
    stagewise engine serves the problem; ``floor``: the data's dtype
    cannot certify ``accuracy``, so the exact float64 engine is tried
    first; ``sqp``: the stagewise form, or ``None`` where the problem has
    none (or the engine does not need it)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: expected 'auto', "
                         f"'condensed', 'stagewise', or 'native'")
    sqp = None
    if engine in ("auto", "stagewise"):
        from .qp.riccati import from_mpc
        try:
            sqp = from_mpc(system, costs, constraints)
        except (DimensionError, InfeasibleProblemError):
            if engine == "stagewise":
                raise
    nvar = system.horizon * system.udim
    stagewise = engine == "stagewise" or (
        engine == "auto" and sqp is not None
        and (nvar > _STAGEWISE_NVAR or _unconstrained(sqp)))
    dt = system.A.dtype if hasattr(system, "A") else torch.float32
    floor = engine == "auto" and _dtype_floor(dt) > accuracy * 0.1
    return stagewise, floor, sqp


def solve(system: System,
          costs: Sequence[CostFunction] = (),
          constraints: Sequence[Constraint] = (),
          *,
          accuracy: float = 1e-5,
          engine: str = "auto",
          warm_start: Optional[WarmStart] = None) -> MPCResult:
    """Solve one MPC problem with no solver knobs.

    ``accuracy`` is the relative control-accuracy contract (default 1e-5;
    the reference library's golden tolerance is 2e-4).  ``engine``:
    ``"auto" | "condensed" | "stagewise" | "native"``.

    Returns an :class:`~copra_tpu_torch.mpc.MPCResult` whose
    ``solution.status`` is honest: ``STATUS_SOLVED`` only when the
    delivered KKT residuals meet the derived tolerance; infeasibility
    certificates propagate.  When the iterative engines cannot close and
    the exact native engine is available (one problem, not a batch), the
    fallback answer is exact by construction.
    """
    costs = tuple(costs)
    constraints = tuple(constraints)
    stagewise, floor, sqp = _route(system, costs, constraints, engine,
                                   accuracy)
    dt = system.A.dtype if hasattr(system, "A") else torch.float32
    eps = max(accuracy * 1e-4, _dtype_floor(dt))

    if floor:
        # the compute dtype cannot certify the requested accuracy (the
        # float32 floor ~6e-6 against a 1e-5 contract): the exact float64
        # engine on the assembled QP.  A batch, or no native engine, falls
        # through to the iterative path, whose status stays honest in its
        # dtype
        preview = condense(system)
        qp = build_qp(preview, system.x0, costs, constraints)
        if qp.Q.dim() == 2:
            res = _native_solve(system, preview, qp)
            if res is not None:
                return res

    if stagewise:
        return _solve_stagewise_auto(system, costs, constraints, sqp, eps)

    preview = condense(system)
    qp = build_qp(preview, system.x0, costs, constraints)
    if engine == "native":
        res = _native_solve(system, preview, qp)
        if res is None:
            raise RuntimeError("engine='native' requested but the native "
                               "active-set engine is unavailable (make -C "
                               "native failed?)")
        return res

    # condensed ADMM with escalating budgets
    from .qp.registry import get_solver

    solver = get_solver(None)
    best: Optional[QPSolution] = None
    for max_iter in (5_000, 50_000):
        opts = SolverOptions(max_iter=max_iter, eps_abs=eps, eps_rel=0.0,
                             early_exit=True, adaptive_rho=True,
                             polish=True)
        sol = solver(qp, opts, warm_start)
        status = int(sol.status)
        if status == STATUS_SOLVED or status >= 2:
            # solved, or a (double-checked) infeasibility certificate:
            # both are final answers
            best = sol
            break
        if best is None or float(sol.dual_residual) < \
                float(best.dual_residual):
            best = sol
        warm_start = WarmStart(x=sol.x, y=sol.y, z=sol.z)
    sol = best
    if int(sol.status) != STATUS_SOLVED and int(sol.status) < 2 \
            and qp.Q.dim() == 2:
        exact = _native_solve(system, preview, qp)
        if exact is not None:
            return exact
    return MPCResult(control=sol.x,
                     trajectory=preview.trajectory(system.x0, sol.x),
                     solution=sol)


def _solve_stagewise_auto(system, costs, constraints, sqp, eps):
    from .qp.riccati import (_curvature_spread, lqr_solve, scale_stagewise,
                             solve_stagewise, stagewise_scales)

    if _unconstrained(sqp):
        # direct LQR: exact (up to the dtype) in one sweep; cost-only
        # problems need no first-order iteration at all
        X, U = lqr_solve(sqp.A, sqp.B, sqp.d, sqp.Qx, sqp.qx, sqp.Ru,
                         sqp.ru, sqp.x0)
        zeros = U.new_zeros((U.numel(),))
        info = QPSolution(
            x=U.reshape(-1), y=zeros, z=U.reshape(-1),
            status=torch.tensor(STATUS_SOLVED, dtype=torch.int32,
                                device=U.device),
            iterations=torch.tensor(1, dtype=torch.int32, device=U.device),
            primal_residual=U.new_zeros(()), dual_residual=U.new_zeros(()))
        return MPCResult(control=U.reshape(-1), trajectory=X.reshape(-1),
                         solution=info)

    scale = None
    sqp_s = sqp
    if _curvature_spread(sqp) > 1e4:
        scale = stagewise_scales(sqp)
        sqp_s = scale_stagewise(sqp, *scale)

    best = None
    # rho ladder: the row-normalized stagewise metric is dimensionless, so
    # a short decade sweep covers the practical range; budgets escalate
    # only if the first pass misses
    for max_iter in (5_000, 30_000):
        for rho in (0.1, 1.0, 0.01):
            opts = SolverOptions(max_iter=max_iter, eps_abs=eps,
                                 eps_rel=0.0, early_exit=True, rho=rho)
            X, U, info = solve_stagewise(sqp_s, opts)
            status = int(info.status)
            score = max(float(info.primal_residual),
                        float(info.dual_residual))
            if best is None or score < best[3]:
                best = (X, U, info, score)
            if status == STATUS_SOLVED or status >= 2:
                best = (X, U, info, score)
                break
        else:
            continue
        break
    X, U, info, _ = best
    if scale is not None:
        X = X * scale[0]
        U = U * scale[1]
    if int(info.status) != STATUS_SOLVED and int(info.status) < 2:
        # honest fallback: the exact native engine on the condensed form
        preview = condense(system)
        qp = build_qp(preview, system.x0, costs, constraints)
        if qp.Q.dim() == 2:
            exact = _native_solve(system, preview, qp)
            if exact is not None:
                return exact
    info = dataclasses.replace(info, x=U.reshape(-1))
    return MPCResult(control=U.reshape(-1), trajectory=X.reshape(-1),
                     solution=info)
