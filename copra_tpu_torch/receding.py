"""Receding-horizon (closed-loop) MPC: warm-started, on the caller's device.

Port of ``copra_tpu/receding.py``.  Each tick solves, applies the first
control, propagates the plant and shifts the warm start, in the
reference's order.  The reference's ``lax.scan`` is a Python loop here, on
the device of the system's tensors, and its ``jax.vmap`` over scenario
batches is a leading lane dimension: a system whose ``x0`` (or whose
``A``, ``B``, ``d``, ``x0``, as :func:`~copra_tpu_torch.parallel.batch.
stack_systems` stacks them) carries one runs the lanes as one batch through
the batched solver, and the result is laid out as the vmap lays it out.

The rebuild route keeps the solver's host syncs (``solve_qp``'s early exit
reads its residuals every ``check_interval`` iterations).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ._graph import tree_map
from ._tensors import matvec
from .constraints import Constraint
from .costs import CostFunction
from .mpc import build_qp
from .qp.registry import get_solver
from .qp.types import QPSolution, SolverOptions, WarmStart
from .systems import LTISystem, Preview, System, condense

Tensor = torch.Tensor


def shift_warm_start(warm: WarmStart, udim: int) -> WarmStart:
    """Shift the primal one control step forward (receding-horizon seed).

    ``U = [u_0..u_{N-1}]`` becomes ``[u_1..u_{N-1}, u_{N-1}]`` on the last
    axis; the duals are kept as they are.
    """
    x = warm.x
    shifted = torch.cat([x[..., udim:], x[..., -udim:]], dim=-1)
    return dataclasses.replace(warm, x=shifted)


def cold_start(preview: Preview, nr_eq: int, nr_ineq: int,
               dtype=torch.float32) -> WarmStart:
    """All-zeros warm start with the QP's shapes, on the preview's
    device."""
    n = preview.full_udim
    m = nr_eq + nr_ineq + n
    kd = dict(dtype=dtype, device=preview.Psi.device)
    return WarmStart(x=torch.zeros((n,), **kd), y=torch.zeros((m,), **kd),
                     z=torch.zeros((m,), **kd))


@dataclasses.dataclass(frozen=True)
class ClosedLoopResult:
    """Trace of one closed-loop rollout (lanes lead where the system has
    them)."""

    states: Tensor         # [T+1, x] realized plant states
    controls: Tensor       # [T, u] applied first controls
    solutions: QPSolution  # stacked per-tick QP solutions, [T, ...]


def _first_step_plant(system: System) -> Callable[[Tensor, Tensor], Tensor]:
    """Default plant = the model's own step-0 dynamics (each lane's stage 0
    when the lanes lead an LTV system's leaves)."""
    if isinstance(system, LTISystem):
        A, B, d = system.A, system.B, system.d
    else:
        A, B, d = (system.A[..., 0, :, :], system.B[..., 0, :, :],
                   system.d[..., 0, :])

    def plant(x, u):
        return matvec(A, x) + matvec(B, u) + d

    return plant


def _lanes(system: System) -> torch.Size:
    """The system's lane dimensions: those of ``x0`` and of the dynamics'
    leading dimensions, broadcast."""
    rank = 2 if isinstance(system, LTISystem) else 3
    return torch.broadcast_shapes(system.x0.shape[:-1],
                                  system.A.shape[:system.A.dim() - rank])


def make_receding_step(system: System,
                       costs: Sequence[CostFunction],
                       constraints: Sequence[Constraint],
                       options: SolverOptions = SolverOptions(),
                       solver=None):
    """Build ``step(x0, warm) -> (u0, full_U, solution, next_warm)``.

    The preview matrices are condensed once (the dynamics model is fixed
    across ticks); only the x0-dependent QP vectors are rebuilt each tick.
    ``x0`` may carry lane dimensions (``u0 [..., u]``).
    """
    solve = solver or get_solver(None)
    costs = tuple(costs)
    constraints = tuple(constraints)
    preview = condense(system)
    udim = preview.udim

    def step(x0: Tensor, warm: Optional[WarmStart]):
        qp = build_qp(preview, x0, costs, constraints)
        sol = solve(qp, options, warm)
        nxt = shift_warm_start(WarmStart(x=sol.x, y=sol.y, z=sol.z), udim)
        return sol.x[..., :udim], sol.x, sol, nxt

    return step, preview


def closed_loop(system: System,
                costs: Sequence[CostFunction],
                constraints: Sequence[Constraint],
                n_ticks: int,
                options: SolverOptions = SolverOptions(),
                plant: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
                solver=None,
                use_plan: bool = False) -> ClosedLoopResult:
    """Run ``n_ticks`` of warm-started receding-horizon control.

    ``plant`` maps ``(x, u) -> next x`` and defaults to the model's own
    step-0 dynamics (perfect-model rollout).  Lane dimensions on the system
    (see the module docstring) give ``states [B, T+1, x]``, ``controls [B,
    T, u]`` and every ``solutions`` field ``[B, T, ...]``.

    ``use_plan=True`` drives the loop through the control plan
    (:func:`~copra_tpu_torch.plan.make_plan_step`, unbatched: factorize
    once, x0-affine tick updates) instead of the per-tick QP rebuild; it
    requires the default solver and a system without lanes, as the
    reference's plan route does.
    """
    plant_fn = plant or _first_step_plant(system)
    lanes = _lanes(system)

    if use_plan and solver is None:
        from .plan import make_control_plan, make_plan_step

        if len(lanes):
            raise ValueError(
                f"closed_loop(use_plan=True) runs one unbatched plan; this "
                f"system has lane dimensions {tuple(lanes)}.  Use the "
                f"rebuild route (use_plan=False) for a batch of scenarios.")
        plan = make_control_plan(system, costs, constraints)
        plan_step = make_plan_step(plan, options)
        udim = system.udim

        def tick(x, warm):
            U, sol, nxt = plan_step(x, warm)
            return U[:udim], sol, nxt

        # probe once to size the warm state, then start it at zeros
        warm = tree_map(torch.zeros_like, plan_step(system.x0, None)[2])
    else:
        step_fn, preview = make_receding_step(system, costs, constraints,
                                              options, solver)

        def tick(x, warm):
            u0, _, sol, nxt = step_fn(x, warm)
            return u0, sol, nxt

        # a probe build sizes the warm start; it starts at zeros
        qp0 = build_qp(preview, system.x0, tuple(costs), tuple(constraints))
        warm = cold_start(preview, qp0.nr_eq, qp0.nr_ineq, qp0.Q.dtype)

    x = system.x0.expand(*lanes, system.x0.shape[-1])
    xs, us, sols = [x], [], []
    for _ in range(n_ticks):
        u0, sol, warm = tick(x, warm)
        x = plant_fn(x, u0)
        xs.append(x)
        us.append(u0)
        sols.append(sol)
    # the tick axis follows the lanes, as under the reference's vmap
    dim = len(lanes)
    return ClosedLoopResult(
        states=torch.stack(xs, dim), controls=torch.stack(us, dim),
        solutions=QPSolution(**{
            f.name: torch.stack([getattr(s, f.name) for s in sols], dim)
            for f in dataclasses.fields(QPSolution)}))
