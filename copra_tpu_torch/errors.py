"""Dimension-diagnostic exceptions.

Port of ``copra_tpu/errors.py``.  That module imports no JAX, but importing
it runs ``copra_tpu/__init__.py``, which does; hence this copy.
"""

from __future__ import annotations


class CopraError(Exception):
    """Base class for all copra errors."""


class DimensionError(CopraError, ValueError):
    """Shape mismatch between user inputs and the system dimensions."""


class InitializationError(CopraError, RuntimeError):
    """Object used before/after its valid lifecycle point."""


class SolverError(CopraError, RuntimeError):
    """QP backend failure (unknown solver name, invalid options...)."""


class InfeasibleProblemError(CopraError, ValueError):
    """Problem data is provably infeasible at build time."""


def _shape(arr) -> tuple:
    return tuple(getattr(arr, "shape", ()))


def rows_mismatch(name1: str, name2: str, arr1, arr2) -> str:
    """Two operands that must have the same leading dimension do not."""
    return (
        f"'{name1}' and '{name2}' must have the same number of rows, got "
        f"{_shape(arr1)} and {_shape(arr2)}. If one is a per-step quantity and "
        f"the other a full-horizon quantity, call auto_span() first."
    )


def bad_trailing_dim(name: str, arr, expected_step: int, expected_full: int,
                     what: str) -> str:
    """An operand's trailing dim matches neither the per-step nor full size."""
    return (
        f"'{name}' has shape {_shape(arr)}; its trailing dimension must be "
        f"either the per-step {what} dimension ({expected_step}) or the "
        f"full-horizon {what} dimension ({expected_full})."
    )


def bad_dim(name: str, arr, expected: int) -> str:
    """An operand's leading dimension does not match ``expected``."""
    return (
        f"'{name}' has shape {_shape(arr)}; expected leading dimension "
        f"{expected}."
    )
