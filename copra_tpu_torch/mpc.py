"""QP assembly and the LMPC controller.

Port of ``copra_tpu/mpc.py``.  The functional core is::

    preview = condense(system)
    qp      = build_qp(preview, x0, costs, constraints)
    sol     = solver(qp, options, warm_start)
    X       = preview.trajectory(x0, sol.x)

and takes batched scenarios directly (leading batch dimensions on the
system's leaves).  The ``LMPC`` class is a thin stateful facade over it that
mirrors the reference API (``add_cost/add_constraint/solve/control/
trajectory/solve_time...``), with explicit lists for the registered costs
and constraints.  PyTorch runs eagerly, so the reference's jit caches
(``_jitted``, ``_jitted_opts``) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import profiling
from ._precision import highest_precision
from .constraints import (Constraint, ConstraintKind, ControlBoundConstraint,
                          ControlConstraint)
from .costs import CostFunction
from .errors import InitializationError
from .qp.registry import get_solver
from .qp.types import (STATUS_EXPLANATIONS, STATUS_MESSAGES, DenseQP,
                       QPSolution, SolverOptions, WarmStart)
from .systems import Preview, System, condense

# PD ridge seeded into the Hessian so the QP stays positive definite with no
# registered costs.
HESSIAN_RIDGE = 1e-6


@highest_precision
def build_qp(preview: Preview, x0: torch.Tensor,
             costs: Sequence[CostFunction],
             constraints: Sequence[Constraint],
             ridge: float = HESSIAN_RIDGE) -> DenseQP:
    """Assemble the dense QP.

    * ``Q = ridge*I + sum(cost.Q)``, ``c = sum(cost.c)``;
    * equality / inequality rows stacked in registration order;
    * bounds start at +-inf and each bound constraint overwrites (the last
      registered one is effective).

    Leading batch dimensions of the preview carry into ``Q`` and the rows;
    extra leading dimensions of ``x0`` broadcast into ``c`` and the
    right-hand sides.
    """
    n = preview.full_udim
    dt = preview.Psi.dtype
    dev = preview.Psi.device
    Q = ridge * torch.eye(n, dtype=dt, device=dev)
    c = torch.zeros((n,), dtype=dt, device=dev)
    for cost in costs:
        Qi, ci = cost.lower(preview, x0)
        Q = Q + Qi
        c = c + ci
    # exact symmetrization: the f32 M'WM products carry ~eps asymmetry,
    # which the ill-conditioned directions amplify into ~1e-4 ambiguity
    # about WHICH QP is being solved
    Q = 0.5 * (Q + Q.transpose(-1, -2))

    eq_A, eq_b, ineq_A, ineq_b = [], [], [], []
    lb = torch.full((n,), -torch.inf, dtype=dt, device=dev)
    ub = torch.full((n,), torch.inf, dtype=dt, device=dev)
    for constr in constraints:
        kind = constr.kind()
        if kind is ConstraintKind.BOUND:
            lo, up = constr.lower(preview, x0)
            lb, ub = lo.to(dt), up.to(dt)
        elif kind is ConstraintKind.EQUALITY:
            A, b = constr.lower(preview, x0)
            eq_A.append(A)
            eq_b.append(b)
        else:
            A, b = constr.lower(preview, x0)
            ineq_A.append(A)
            ineq_b.append(b)

    a_batch = preview.batch_shape
    b_batch = torch.broadcast_shapes(a_batch, torch.as_tensor(x0).shape[:-1])

    def _stack(As, bs):
        if not As:
            return (torch.zeros((*a_batch, 0, n), dtype=dt, device=dev),
                    torch.zeros((*b_batch, 0), dtype=dt, device=dev))
        return (torch.cat([A.expand(*a_batch, *A.shape[-2:]) for A in As],
                          dim=-2),
                torch.cat([b.expand(*b_batch, b.shape[-1]) for b in bs],
                          dim=-1))

    Aeq, beq = _stack(eq_A, eq_b)
    Aineq, bineq = _stack(ineq_A, ineq_b)
    return DenseQP(Q=Q, c=c, Aeq=Aeq, beq=beq, Aineq=Aineq, bineq=bineq,
                   lb=lb, ub=ub)


@dataclasses.dataclass(frozen=True)
class MPCResult:
    """One MPC solve: optimal controls, reconstructed trajectory, QP info."""

    control: torch.Tensor      # [N*u]
    trajectory: torch.Tensor   # [(N+1)*x]
    solution: QPSolution


def solve_mpc(system: System,
              costs: Sequence[CostFunction] = (),
              constraints: Sequence[Constraint] = (),
              options: SolverOptions = SolverOptions(),
              warm_start: Optional[WarmStart] = None,
              solver: Optional[Callable] = None) -> MPCResult:
    """Functional one-shot MPC solve (condense -> build -> solve -> replay).

    Leading batch dimensions on the system's (and the warm start's) leaves
    give one solve per scenario.
    """
    solve = solver or get_solver(None)
    preview = condense(system)
    qp = build_qp(preview, system.x0, tuple(costs), tuple(constraints))
    sol = solve(qp, options, warm_start)
    X = preview.trajectory(system.x0, sol.x)
    return MPCResult(control=sol.x, trajectory=X, solution=sol)


class LMPC:
    """Stateful controller facade mirroring ``copra::LMPC``.

    Lifecycle parity:

    * ``add_cost``/``add_constraint`` validate shapes immediately;
    * adding the *same* ``ControlConstraint``/``ControlBoundConstraint``
      instance twice raises, mirroring the reference's move-semantics
      double-init error;
    * removal is explicit (``remove_cost``/``remove_constraint``); there is
      no use-count auto-eviction.
    """

    def __init__(self, system: System,
                 solver: str = "default",
                 options: SolverOptions = SolverOptions()):
        self._system = system
        self._preview = condense(system)
        self._costs: List[CostFunction] = []
        self._constraints: List[Constraint] = []
        self._solver_name = solver
        self._solver_fn = get_solver(solver)
        self._options = options
        self._result: Optional[MPCResult] = None
        self._warm: Optional[WarmStart] = None
        self._solve_time = 0.0
        self._build_and_solve_time = 0.0
        self._deadline = None

    # ---- solver selection ----
    def select_qp_solver(self, name: str) -> None:
        self._solver_fn = get_solver(name)
        self._solver_name = name
        self._deadline = None

    def use_solver(self, fn: Callable) -> None:
        """Inject a custom solve callable ``(qp, options, warm_start) ->
        QPSolution``."""
        self._solver_fn = fn
        self._solver_name = "<custom>"
        self._deadline = None

    @property
    def options(self) -> SolverOptions:
        return self._options

    @options.setter
    def options(self, opts: SolverOptions) -> None:
        self._options = opts
        self._deadline = None

    # ---- system swap ----
    def initialize_controller(self, system: System) -> None:
        self._system = system
        self._preview = condense(system)
        self._deadline = None

    @property
    def system(self) -> System:
        return self._system

    def set_initial_state(self, x0) -> None:
        """Receding-horizon re-seed."""
        self._system = self._system.with_x0(x0)

    # ---- cost / constraint registry ----
    def add_cost(self, cost: CostFunction) -> CostFunction:
        cost.validate(self._preview)
        self._costs.append(cost)
        self._deadline = None
        return cost

    def add_constraint(self, constr: Constraint) -> Constraint:
        if getattr(constr, "_consumed", False):
            raise InitializationError(
                f"this {type(constr).__name__} instance was already "
                f"registered; the reference forbids re-initialization of "
                f"move-semantics constraints.")
        constr.validate(self._preview)
        # isinstance, not a name check: user subclasses must keep the
        # move-semantics double-init guard of the reference
        if isinstance(constr, (ControlConstraint, ControlBoundConstraint)):
            object.__setattr__(constr, "_consumed", True)
        self._constraints.append(constr)
        self._deadline = None
        return constr

    def remove_cost(self, cost: CostFunction) -> None:
        self._costs = [c for c in self._costs if c is not cost]
        self._deadline = None

    def remove_constraint(self, constr: Constraint) -> None:
        self._constraints = [c for c in self._constraints if c is not constr]
        self._deadline = None

    def reset_costs(self) -> None:
        self._costs = []
        self._deadline = None

    def reset_constraints(self) -> None:
        self._constraints = []
        self._deadline = None

    @property
    def costs(self) -> Tuple[CostFunction, ...]:
        return tuple(self._costs)

    @property
    def constraints(self) -> Tuple[Constraint, ...]:
        return tuple(self._constraints)

    # ---- solve path ----
    def _run(self, options: SolverOptions, system: System,
             warm: Optional[WarmStart]) -> MPCResult:
        """The pipeline on the registered problem, ended by a wait for the
        device."""
        result = solve_mpc(system, tuple(self._costs),
                           tuple(self._constraints), options, warm,
                           solver=self._solver_fn)
        profiling.synchronize(result.control.device)
        return result

    def _calibrate_deadline(self) -> dict:
        """Measure this problem's iters/ms conversion for the
        ``max_wall_time_ms`` budget (the analog of qpOASES' ``maxCpuTime``).

        The budget is enforced by measurement: time two
        fixed-iteration-count solves of the ACTUAL registered problem,
        derive the marginal ms/iteration and the per-call overhead
        (dispatch included: a real-time caller pays it too), and precompute
        the iteration budget that fits.  On a CUDA device the marginal
        comes from CUDA events (device time); the wall stays only in the
        additive overhead term.  Re-runs when the registry changes.
        """
        budget_ms = float(self._options.max_wall_time_ms)
        lo_i, hi_i = 16, 116
        device = self._system.A.device
        wall = {}
        dev = {}
        rng = np.random.default_rng(0)
        x0 = self._system.x0
        for n in (lo_i, hi_i):
            popts = self._options.replace(
                max_iter=n, early_exit=False, max_wall_time_ms=None,
                print_level=0, infeasibility_detection=False)
            self._run(popts, self._system, None)   # first use loads kernels
            walls = []
            for _ in range(3):
                # vary x0 per probe call: a jittered initial state keeps
                # each call genuinely distinct at identical cost
                jitter = torch.as_tensor(
                    rng.normal(scale=1e-4, size=tuple(x0.shape)),
                    dtype=x0.dtype, device=x0.device)
                sys_j = self._system.with_x0(x0 + jitter)
                t0 = time.perf_counter()
                self._run(popts, sys_j, None)
                walls.append((time.perf_counter() - t0) * 1e3)
            wall[n] = float(np.median(walls))
            if device.type == "cuda":
                dev[n] = profiling.elapsed_ms(
                    lambda: self._run(popts, self._system, None), device,
                    reps=3)
        if len(dev) == 2:
            marginal = max((dev[hi_i] - dev[lo_i]) / (hi_i - lo_i), 1e-7)
            overhead = max(wall[lo_i] - dev[lo_i], 0.0) \
                + max(dev[lo_i] - marginal * lo_i, 0.0)
        else:
            marginal = max((wall[hi_i] - wall[lo_i]) / (hi_i - lo_i),
                           1e-7)
            overhead = max(wall[lo_i] - marginal * lo_i, 0.0)
        budget_iters = int((budget_ms - overhead) / marginal)
        budget_iters = max(1, min(budget_iters, self._options.max_iter))
        return {"budget_ms": budget_ms,
                "marginal_ms_per_iter": marginal,
                "overhead_ms": overhead,
                "budget_iters": budget_iters,
                "calibration_basis": profiling.timer_basis(device),
                # honest infeasibility: when the measured per-call overhead
                # alone exceeds the budget, no iteration count can meet the
                # wall deadline in THIS environment; the caller sees it
                # rather than a silently-meaningless budget_iters
                "budget_feasible": overhead < budget_ms,
                "probe_wall_ms": wall,
                "probe_device_ms": dev or None}

    def deadline_info(self) -> Optional[dict]:
        """The measured ``max_wall_time_ms`` calibration (None until the
        first deadline-budgeted solve): marginal ms/iteration, per-call
        overhead, and the derived iteration budget."""
        return self._deadline

    def _effective_options(self) -> SolverOptions:
        opts = self._options
        if opts.max_wall_time_ms is None:
            return opts
        if self._deadline is None:
            self._deadline = self._calibrate_deadline()
        return opts.replace(max_iter=self._deadline["budget_iters"],
                            max_wall_time_ms=None)

    def _report(self, sol: QPSolution, ok: bool) -> None:
        """``print_level`` solve-time verbosity (0-3)."""
        level = self._options.print_level
        if level <= 0 or (level == 1 and ok):
            return
        import logging

        log = logging.getLogger("copra_tpu_torch.lmpc")
        log.log(logging.INFO if ok else logging.WARNING,
                "solve (%.3f ms): %s", self._solve_time * 1e3,
                sol.inform())
        if level >= 3:
            for code in sorted(set(sol.status.reshape(-1).tolist())):
                log.info("  status %d (%s): %s", code,
                         STATUS_MESSAGES.get(code, "?"),
                         STATUS_EXPLANATIONS.get(code, ""))
            worst = sol.failed_lanes(10)
            if worst:
                log.info("  worst failed lanes: %s", worst)

    def solve(self, warm_start: bool = False) -> bool:
        """Build the QP and solve it; returns success like the reference.

        ``warm_start=True`` reuses the previous solution's ADMM state, the
        receding-horizon fast path.

        Note for serving: this facade condenses and assembles on every
        call; the production serving path is :meth:`as_plan` (condense +
        assembly + KKT factorization once, then cheap per-tick steps).
        """
        t0 = time.perf_counter()
        opts = self._effective_options()
        warm = self._warm if warm_start else None
        t1 = time.perf_counter()
        result = self._run(opts, self._system, warm)
        t2 = time.perf_counter()
        self._result = result
        sol = result.solution
        self._warm = WarmStart(x=sol.x, y=sol.y, z=sol.z)
        self._solve_time = t2 - t1
        self._build_and_solve_time = t2 - t0
        ok = bool((sol.status == 0).all())
        self._report(sol, ok)
        return ok

    # ---- results ----
    def control(self) -> torch.Tensor:
        """Optimal control sequence U."""
        self._require_result()
        return self._result.control

    def trajectory(self) -> torch.Tensor:
        """Reconstructed state stack X."""
        self._require_result()
        return self._result.trajectory

    def results(self) -> MPCResult:
        self._require_result()
        return self._result

    def solve_time(self) -> float:
        """Solve wall time in seconds, to the end of the device's work."""
        return self._solve_time

    def solve_and_build_time(self) -> float:
        """Build+solve wall time in seconds."""
        return self._build_and_solve_time

    def inform(self) -> str:
        self._require_result()
        return self._result.solution.inform()

    def as_plan(self, options: Optional[SolverOptions] = None,
                batched: bool = False):
        """Freeze the registered costs/constraints into a serving plan.

        Returns ``(plan, step)`` from :mod:`copra_tpu_torch.plan`:
        condensing, QP assembly, and the KKT factorization are done once
        here; ``step(x0, warm)`` then runs production receding-horizon
        ticks.
        """
        from .plan import make_control_plan, make_plan_step

        plan = make_control_plan(self._system, tuple(self._costs),
                                 tuple(self._constraints))
        step = make_plan_step(plan, options or self._options,
                              batched=batched)
        return plan, step

    def as_stagewise_step(self,
                          options: Optional[SolverOptions] = None,
                          cold_options: Optional[SolverOptions] = None,
                          backend: str = "auto"):
        """Freeze the registry into a STAGEWISE serving tick (config-5
        pattern: long horizons / per-step constraint rows; O(N) per
        iteration, no condensed matrices).

        Returns ``tick(x0, warm) -> (X, U, info, warm)`` (see
        :func:`copra_tpu_torch.qp.riccati.make_stagewise_step`).  Requires
        every registered cost/constraint to be per-stage-expressible
        (:func:`copra_tpu_torch.qp.riccati.from_mpc` raises with guidance
        to :meth:`as_plan` otherwise).
        """
        from .qp.riccati import from_mpc, make_stagewise_step

        sqp = from_mpc(self._system, tuple(self._costs),
                       tuple(self._constraints))
        return make_stagewise_step(sqp, options or self._options,
                                   cold_options=cold_options,
                                   backend=backend)

    def _require_result(self) -> None:
        if self._result is None:
            raise InitializationError("call solve() first.")
