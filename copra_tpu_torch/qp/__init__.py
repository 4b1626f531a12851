"""QP containers, options and the native exact oracle."""

from .native import native_available, solve_qp_native
from .types import DenseQP, QPSolution, SolverOptions, WarmStart

__all__ = ["DenseQP", "QPSolution", "SolverOptions", "WarmStart",
           "native_available", "solve_qp_native"]
