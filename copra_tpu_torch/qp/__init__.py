"""Batched on-device dense QP solving (see ``admm.py``), containers,
options, the solver registry and the native exact oracle."""

from .admm import solve_qp, solve_qp_batched, stack_constraints
from .native import native_available, solve_qp_native
from .registry import available_solvers, get_solver, register_solver
from .types import DenseQP, QPSolution, SolverOptions, WarmStart

__all__ = ["solve_qp", "solve_qp_batched", "stack_constraints",
           "register_solver", "get_solver", "available_solvers",
           "DenseQP", "QPSolution", "SolverOptions", "WarmStart",
           "native_available", "solve_qp_native"]
