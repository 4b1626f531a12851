"""Constraints lowering to dense-QP blocks.

Port of ``copra_tpu/constraints.py``.  Each constraint lowers against the
preview matrices into equality rows ``A U = b``, inequality rows
``A U <= b`` or box bounds ``lb <= U <= ub``.  As in :mod:`.costs`, ``A``
carries the preview's batch dimensions and ``b`` the broadcast of those with
``x0``'s.  Infinite trajectory bounds are masked rows ``0 * U <= 1`` with a
static row count, exactly as the reference lowers them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np
import torch

from ._tensors import as_tensor, common
from .autospan import span_matrix, span_vector
from .errors import DimensionError, bad_trailing_dim, rows_mismatch
from .systems import Preview

Tensor = torch.Tensor


class ConstraintKind(enum.Enum):
    """Equality rows, inequality rows or box bounds."""

    EQUALITY = "eq"
    INEQUALITY = "ineq"
    BOUND = "bound"


class Constraint:
    """Common constraint API."""

    name: str = "constraint"

    def kind(self) -> ConstraintKind:
        raise NotImplementedError

    def nr_constr(self, preview: Preview) -> int:
        """Number of (active) constraint rows."""
        raise NotImplementedError

    def auto_span(self) -> "Constraint":
        return self

    def validate(self, preview: Preview) -> None:
        """Shape validation."""

    def lower(self, preview: Preview, x0: Tensor):
        """Lower to ``(A, b)`` rows or ``(lb, ub)`` bounds."""
        raise NotImplementedError


def _kind_eq_ineq(is_inequality: bool) -> ConstraintKind:
    return (ConstraintKind.INEQUALITY if is_inequality
            else ConstraintKind.EQUALITY)


def _psi_blocks(preview: Preview, Psi: Tensor) -> Tensor:
    return Psi.reshape(*preview.batch_shape, preview.nr_x_step,
                       preview.xdim, preview.full_udim)


def _fr_blocks(preview: Preview, fr: Tensor) -> Tensor:
    return fr.reshape(*fr.shape[:-1], preview.nr_x_step, preview.xdim)


@dataclasses.dataclass(frozen=True)
class TrajectoryConstraint(Constraint):
    """``E X <= f`` (or ``= f``) over the stacked trajectory; per-step mode
    constrains every block row of X including x_0."""

    E: Tensor
    f: Tensor
    is_inequality: bool = True
    name = "TrajectoryConstraint"

    @classmethod
    def create(cls, E, f, is_inequality: bool = True):
        return cls(E=torch.atleast_2d(as_tensor(E)),
                   f=torch.atleast_1d(as_tensor(f)),
                   is_inequality=bool(is_inequality))

    def kind(self) -> ConstraintKind:
        return _kind_eq_ineq(self.is_inequality)

    def auto_span(self) -> "TrajectoryConstraint":
        max_dim = max(self.E.shape[0], self.f.shape[0])
        return dataclasses.replace(self, E=span_matrix(self.E, max_dim),
                                   f=span_vector(self.f, max_dim))

    def validate(self, preview: Preview) -> None:
        if self.E.shape[0] != self.f.shape[0]:
            raise DimensionError(rows_mismatch("E", "f", self.E, self.f))
        if self.E.shape[1] not in (preview.xdim, preview.full_xdim):
            raise DimensionError(bad_trailing_dim(
                "E", self.E, preview.xdim, preview.full_xdim, "state"))

    def nr_constr(self, preview: Preview) -> int:
        if self.E.shape[1] == preview.xdim:
            return self.E.shape[0] * preview.nr_x_step
        return self.E.shape[0]

    def lower(self, preview: Preview, x0: Tensor) -> Tuple[Tensor, Tensor]:
        fr = preview.free_response(x0)
        E, f, Psi, fr = common(self.E, self.f, preview.Psi, fr,
                               device=preview.Psi.device)
        if self.E.shape[1] == preview.xdim:  # per-step, x_0 included
            A = torch.einsum("rx,...kxU->...krU", E, _psi_blocks(preview, Psi))
            b = f - torch.einsum("rx,...kx->...kr", E, _fr_blocks(preview, fr))
            return (A.reshape(*A.shape[:-3], -1, preview.full_udim),
                    b.reshape(*b.shape[:-2], -1))
        return E @ Psi, f - torch.einsum("rR,...R->...r", E, fr)


@dataclasses.dataclass(frozen=True)
class ControlConstraint(Constraint):
    """``G U <= f`` (or ``= f``) on the control sequence."""

    G: Tensor
    f: Tensor
    is_inequality: bool = True
    name = "ControlConstraint"

    @classmethod
    def create(cls, G, f, is_inequality: bool = True):
        return cls(G=torch.atleast_2d(as_tensor(G)),
                   f=torch.atleast_1d(as_tensor(f)),
                   is_inequality=bool(is_inequality))

    def kind(self) -> ConstraintKind:
        return _kind_eq_ineq(self.is_inequality)

    def auto_span(self) -> "ControlConstraint":
        max_dim = max(self.G.shape[0], self.f.shape[0])
        return dataclasses.replace(self, G=span_matrix(self.G, max_dim),
                                   f=span_vector(self.f, max_dim))

    def validate(self, preview: Preview) -> None:
        if self.G.shape[0] != self.f.shape[0]:
            raise DimensionError(rows_mismatch("G", "f", self.G, self.f))
        if self.G.shape[1] not in (preview.udim, preview.full_udim):
            raise DimensionError(bad_trailing_dim(
                "G", self.G, preview.udim, preview.full_udim, "input"))

    def nr_constr(self, preview: Preview) -> int:
        if self.G.shape[1] == preview.udim:
            return self.G.shape[0] * preview.nr_u_step
        return self.G.shape[0]

    def lower(self, preview: Preview, x0: Tensor) -> Tuple[Tensor, Tensor]:
        dev = preview.Psi.device
        G, f = self.G.to(dev), self.f.to(dev)
        if self.G.shape[1] == preview.udim:  # block-diagonal placement
            eye = torch.eye(preview.nr_u_step, dtype=G.dtype, device=dev)
            return torch.kron(eye, G), f.repeat(preview.nr_u_step)
        return G, f


@dataclasses.dataclass(frozen=True)
class MixedConstraint(Constraint):
    """``E x_k + G u_k <= f`` (or ``= f``); row k pairs state block k with
    input block k, k = 0..N-1, assembled from the actual Psi blocks (exact
    for LTV systems too)."""

    E: Tensor
    G: Tensor
    f: Tensor
    is_inequality: bool = True
    name = "MixedConstraint"

    @classmethod
    def create(cls, E, G, f, is_inequality: bool = True):
        return cls(E=torch.atleast_2d(as_tensor(E)),
                   G=torch.atleast_2d(as_tensor(G)),
                   f=torch.atleast_1d(as_tensor(f)),
                   is_inequality=bool(is_inequality))

    def kind(self) -> ConstraintKind:
        return _kind_eq_ineq(self.is_inequality)

    def auto_span(self) -> "MixedConstraint":
        max_dim = max(self.E.shape[0], self.G.shape[0], self.f.shape[0])
        return dataclasses.replace(
            self, E=span_matrix(self.E, max_dim, add_cols=1),
            G=span_matrix(self.G, max_dim),
            f=span_vector(self.f, max_dim))

    def validate(self, preview: Preview) -> None:
        if self.E.shape[0] != self.f.shape[0]:
            raise DimensionError(rows_mismatch("E", "f", self.E, self.f))
        if self.G.shape[0] != self.f.shape[0]:
            raise DimensionError(rows_mismatch("G", "f", self.G, self.f))
        per_step = (self.E.shape[1] == preview.xdim
                    and self.G.shape[1] == preview.udim)
        full = (self.E.shape[1] == preview.full_xdim
                and self.G.shape[1] == preview.full_udim)
        if not (per_step or full):
            raise DimensionError(
                f"'E' {tuple(self.E.shape)} / 'G' {tuple(self.G.shape)} must "
                f"be jointly per-step ({preview.xdim}/{preview.udim}) or "
                f"full-horizon ({preview.full_xdim}/{preview.full_udim}).")

    def nr_constr(self, preview: Preview) -> int:
        if self.E.shape[1] == preview.xdim:
            return self.E.shape[0] * preview.nr_u_step
        return self.E.shape[0]

    def lower(self, preview: Preview, x0: Tensor) -> Tuple[Tensor, Tensor]:
        fr = preview.free_response(x0)
        E, G, f, Psi, fr = common(self.E, self.G, self.f, preview.Psi, fr,
                                  device=preview.Psi.device)
        if self.E.shape[1] == preview.xdim:  # per-step
            Nn = preview.nr_u_step
            psi = _psi_blocks(preview, Psi)[..., :-1, :, :]
            A = torch.einsum("rx,...kxU->...krU", E, psi)
            eye = torch.eye(Nn, dtype=A.dtype, device=A.device)
            A = A + torch.kron(eye, G).reshape(Nn, G.shape[0],
                                               preview.full_udim)
            frb = _fr_blocks(preview, fr)[..., :-1, :]
            b = f - torch.einsum("rx,...kx->...kr", E, frb)
            return (A.reshape(*A.shape[:-3], -1, preview.full_udim),
                    b.reshape(*b.shape[:-2], -1))
        return E @ Psi + G, f - torch.einsum("rR,...R->...r", E, fr)


@dataclasses.dataclass(frozen=True)
class TrajectoryBoundConstraint(Constraint):
    """``xl <= X <= xu`` lowered to inequality rows on U.

    Every row is kept, infinite bounds masked to ``0 * U <= 1`` so the row
    count is static (``nr_constr`` still reports the finite count).  Lower
    bounds lower to ``-Psi_row U <= delta - lower``, the mathematically
    correct sign, as in the reference.
    """

    lower_bound: Tensor
    upper_bound: Tensor
    finite_lower: tuple = ()
    finite_upper: tuple = ()
    name = "TrajectoryBoundConstraint"

    @classmethod
    def create(cls, lower, upper):
        lo = torch.atleast_1d(as_tensor(lower))
        up = torch.atleast_1d(as_tensor(upper))
        return cls(lower_bound=lo, upper_bound=up,
                   finite_lower=tuple(torch.isfinite(lo).tolist()),
                   finite_upper=tuple(torch.isfinite(up).tolist()))

    def kind(self) -> ConstraintKind:
        return ConstraintKind.INEQUALITY

    def auto_span(self) -> "TrajectoryBoundConstraint":
        max_dim = max(self.lower_bound.shape[0], self.upper_bound.shape[0])
        lo = span_vector(self.lower_bound, max_dim)
        up = span_vector(self.upper_bound, max_dim)
        n_lo = max_dim // self.lower_bound.shape[0]
        n_up = max_dim // self.upper_bound.shape[0]
        return dataclasses.replace(
            self, lower_bound=lo, upper_bound=up,
            finite_lower=self.finite_lower * n_lo,
            finite_upper=self.finite_upper * n_up)

    def validate(self, preview: Preview) -> None:
        if self.lower_bound.shape[0] != self.upper_bound.shape[0]:
            raise DimensionError(rows_mismatch(
                "lower", "upper", self.lower_bound, self.upper_bound))
        if self.lower_bound.shape[0] not in (preview.xdim,
                                             preview.full_xdim):
            raise DimensionError(bad_trailing_dim(
                "lower", self.lower_bound, preview.xdim, preview.full_xdim,
                "state"))

    def _masks(self) -> Tuple[np.ndarray, np.ndarray]:
        return (np.asarray(self.finite_lower, dtype=bool),
                np.asarray(self.finite_upper, dtype=bool))

    def nr_constr(self, preview: Preview) -> int:
        lo_m, up_m = self._masks()
        n = int(lo_m.sum() + up_m.sum())
        if self.lower_bound.shape[0] == preview.xdim:
            return n * preview.nr_x_step
        return n

    def lower(self, preview: Preview, x0: Tensor) -> Tuple[Tensor, Tensor]:
        dev = preview.Psi.device
        fr = preview.free_response(x0)
        lo_np, up_np = self._masks()
        lo_mask = torch.as_tensor(lo_np, device=dev)
        up_mask = torch.as_tensor(up_np, device=dev)
        lo = torch.where(lo_mask, self.lower_bound.to(dev), 0.0)
        up = torch.where(up_mask, self.upper_bound.to(dev), 0.0)
        if self.lower_bound.shape[0] == preview.xdim:  # per-step
            psi = preview.psi_blocks()
            frb = _fr_blocks(preview, fr)
            # lower rows: -Psi_row U <= delta - lower   (masked -> 0 <= 1)
            A_lo = torch.where(lo_mask[:, None], -psi, 0.0)
            b_lo = torch.where(lo_mask, frb - lo, 1.0)
            # upper rows:  Psi_row U <= upper - delta
            A_up = torch.where(up_mask[:, None], psi, 0.0)
            b_up = torch.where(up_mask, up - frb, 1.0)
            A = torch.cat([A_lo.reshape(*A_lo.shape[:-3], -1,
                                        preview.full_udim),
                           A_up.reshape(*A_up.shape[:-3], -1,
                                        preview.full_udim)], dim=-2)
            b = torch.cat([b_lo.reshape(*b_lo.shape[:-2], -1),
                           b_up.reshape(*b_up.shape[:-2], -1)], dim=-1)
            return A, b
        # full-size: one row per entry of each side
        A_lo = torch.where(lo_mask[:, None], -preview.Psi, 0.0)
        b_lo = torch.where(lo_mask, fr - lo, 1.0)
        A_up = torch.where(up_mask[:, None], preview.Psi, 0.0)
        b_up = torch.where(up_mask, up - fr, 1.0)
        return torch.cat([A_lo, A_up], dim=-2), torch.cat([b_lo, b_up], -1)


@dataclasses.dataclass(frozen=True)
class ControlBoundConstraint(Constraint):
    """``ul <= U <= uu`` kept as true box bounds for the QP."""

    lower_bound: Tensor
    upper_bound: Tensor
    name = "ControlBoundConstraint"

    @classmethod
    def create(cls, lower, upper):
        return cls(lower_bound=torch.atleast_1d(as_tensor(lower)),
                   upper_bound=torch.atleast_1d(as_tensor(upper)))

    def kind(self) -> ConstraintKind:
        return ConstraintKind.BOUND

    def auto_span(self) -> "ControlBoundConstraint":
        max_dim = max(self.lower_bound.shape[0], self.upper_bound.shape[0])
        return dataclasses.replace(
            self, lower_bound=span_vector(self.lower_bound, max_dim),
            upper_bound=span_vector(self.upper_bound, max_dim))

    def validate(self, preview: Preview) -> None:
        if self.lower_bound.shape[0] != self.upper_bound.shape[0]:
            raise DimensionError(rows_mismatch(
                "lower", "upper", self.lower_bound, self.upper_bound))
        if self.lower_bound.shape[0] not in (preview.udim,
                                             preview.full_udim):
            raise DimensionError(bad_trailing_dim(
                "lower", self.lower_bound, preview.udim, preview.full_udim,
                "input"))

    def nr_constr(self, preview: Preview) -> int:
        return preview.full_udim

    def lower(self, preview: Preview, x0: Tensor) -> Tuple[Tensor, Tensor]:
        dev = preview.Psi.device
        lo, up = self.lower_bound.to(dev), self.upper_bound.to(dev)
        if self.lower_bound.shape[0] == preview.udim:  # per-step replicate
            return lo.repeat(preview.nr_u_step), up.repeat(preview.nr_u_step)
        return lo, up
