"""Solver registry.

Port of ``copra_tpu/qp/registry.py``: a string-keyed registry of solve
functions ``(qp, options, warm_start) -> QPSolution``; the default is the
batched ADMM of :mod:`copra_tpu_torch.qp.admm`, and ``"active_set"`` is the
exact native oracle, on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..errors import SolverError
from .admm import solve_qp
from .native import solve_qp_native
from .types import DenseQP, QPSolution, SolverOptions, WarmStart

SolveFn = Callable[..., QPSolution]

_REGISTRY: Dict[str, SolveFn] = {}

DEFAULT_SOLVER = "admm"


def register_solver(name: str, fn: SolveFn) -> None:
    """Register a solver callable ``(qp, options, warm_start) ->
    QPSolution``."""
    _REGISTRY[name] = fn


def get_solver(name: Optional[str] = None) -> SolveFn:
    key = name or DEFAULT_SOLVER
    if key not in _REGISTRY:
        raise SolverError(
            f"unknown QP solver '{key}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def available_solvers():
    return sorted(_REGISTRY)


def _active_set(qp: DenseQP, options: SolverOptions = SolverOptions(),
                warm_start: Optional[WarmStart] = None) -> QPSolution:
    """Exact native (C++ Goldfarb-Idnani) oracle: host-only, f64,
    cold-start; see :mod:`copra_tpu_torch.qp.native`.  The solution comes
    back on the device of ``qp.Q``."""
    sol = solve_qp_native(qp, options, warm_start)
    dev = qp.Q.device
    return QPSolution(**{f: getattr(sol, f).to(dev)
                         for f in ("x", "y", "z", "status", "iterations",
                                   "primal_residual", "dual_residual")})


# host_only: the solve leaves the device (ctypes call on numpy copies)
_active_set.host_only = True  # type: ignore[attr-defined]

register_solver("admm", solve_qp)
register_solver("default", solve_qp)
register_solver("active_set", _active_set)
