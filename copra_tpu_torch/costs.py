"""Cost functions lowering to dense-QP (Q, c) terms.

Port of ``copra_tpu/costs.py``.  Every cost contributes ``Q`` and ``c`` such
that the solver minimizes ``1/2 U^T Q U + c^T U``.  ``lower`` takes a
:class:`~copra_tpu_torch.systems.Preview` with optional leading batch
dimensions and an ``x0`` whose extra leading dimensions broadcast against
them; ``Q`` carries the preview's batch dimensions, ``c`` the broadcast of
both.  Per-step mode is checked first, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ._tensors import as_tensor, common
from .autospan import span_matrix, span_vector
from .errors import DimensionError, bad_trailing_dim, rows_mismatch
from .systems import Preview

Tensor = torch.Tensor


def _ones_like_rows(p: Tensor) -> Tensor:
    return torch.ones((p.shape[0],), dtype=p.dtype)


def _fit_weights(weights, target_len: int) -> Tensor:
    """Accept a same-length weight vector, or tile a divisor-length one."""
    w = torch.atleast_1d(as_tensor(weights))
    if w.shape[0] == target_len:
        return w
    if target_len % w.shape[0] == 0:
        return w.repeat(target_len // w.shape[0])
    raise DimensionError(
        f"weights of length {w.shape[0]} cannot be fit to {target_len}.")


class CostFunction:
    """Common cost API."""

    name: str = "cost"
    weights: Tensor
    p: Tensor

    def with_weights(self, weights) -> "CostFunction":
        return dataclasses.replace(
            self, weights=_fit_weights(weights, self.p.shape[0]))

    def with_weight(self, weight: float) -> "CostFunction":
        return dataclasses.replace(
            self, weights=torch.full((self.p.shape[0],), weight,
                                     dtype=self.weights.dtype))

    def auto_span(self) -> "CostFunction":
        return self

    def validate(self, preview: Preview) -> None:
        """Shape validation."""

    def lower(self, preview: Preview, x0: Tensor) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError


def _wq(tmp: Tensor, w: Tensor, per_step: bool) -> Tensor:
    """``sum_k tmp_k^T diag(w) tmp_k`` (``tmp [..., K, r, U]`` per step,
    ``[..., r, U]`` full)."""
    if per_step:
        return torch.einsum("...krU,r,...krV->...UV", tmp, w, tmp)
    return torch.einsum("...rU,r,...rV->...UV", tmp, w, tmp)


def _wc(resid: Tensor, w: Tensor, tmp: Tensor, per_step: bool) -> Tensor:
    if per_step:
        return torch.einsum("...kr,r,...krU->...U", resid, w, tmp)
    return torch.einsum("...r,r,...rU->...U", resid, w, tmp)


def _blocks(v: Tensor, rows: int, width: int) -> Tensor:
    """Split the trailing axis of ``v`` into ``[rows, width]``."""
    return v.reshape(*v.shape[:-1], rows, width)


@dataclasses.dataclass(frozen=True)
class TrajectoryCost(CostFunction):
    """``(M X - p)^T W (M X - p)`` over the whole stacked trajectory
    (per-step mode applies ``M`` to every block row of X, x_0 included)."""

    M: Tensor
    p: Tensor
    weights: Tensor
    name = "TrajectoryCost"

    @classmethod
    def create(cls, M, p, weights=None) -> "TrajectoryCost":
        M = torch.atleast_2d(as_tensor(M))
        p = torch.atleast_1d(as_tensor(p))
        w = _ones_like_rows(p) if weights is None else _fit_weights(
            weights, p.shape[0])
        return cls(M=M, p=p, weights=w)

    def auto_span(self) -> "TrajectoryCost":
        max_dim = max(self.M.shape[0], self.p.shape[0], self.weights.shape[0])
        return dataclasses.replace(
            self, M=span_matrix(self.M, max_dim),
            p=span_vector(self.p, max_dim),
            weights=span_vector(self.weights, max_dim))

    def validate(self, preview: Preview) -> None:
        if self.M.shape[0] != self.p.shape[0]:
            raise DimensionError(rows_mismatch("M", "p", self.M, self.p))
        if self.M.shape[1] not in (preview.xdim, preview.full_xdim):
            raise DimensionError(bad_trailing_dim(
                "M", self.M, preview.xdim, preview.full_xdim, "state"))

    def lower(self, preview: Preview, x0: Tensor) -> Tuple[Tensor, Tensor]:
        fr = preview.free_response(x0)
        M, p, w, Psi, fr = common(self.M, self.p, self.weights, preview.Psi,
                                  fr, device=preview.Psi.device)
        if self.M.shape[1] == preview.xdim:  # per-step
            psib = Psi.reshape(*preview.batch_shape, preview.nr_x_step,
                               preview.xdim, preview.full_udim)
            tmp = torch.einsum("rx,...kxU->...krU", M, psib)
            frb = _blocks(fr, preview.nr_x_step, preview.xdim)
            resid = torch.einsum("rx,...kx->...kr", M, frb) - p
            return _wq(tmp, w, True), _wc(resid, w, tmp, True)
        tmp = M @ Psi
        resid = torch.einsum("rR,...R->...r", M, fr) - p
        return _wq(tmp, w, False), _wc(resid, w, tmp, False)


@dataclasses.dataclass(frozen=True)
class SimpleTrajectoryCost(CostFunction):
    """TrajectoryCost with ``M = I``."""

    p: Tensor
    weights: Tensor
    name = "SimpleTrajectoryCost"

    @classmethod
    def create(cls, p, weights=None) -> "SimpleTrajectoryCost":
        p = torch.atleast_1d(as_tensor(p))
        w = _ones_like_rows(p) if weights is None else _fit_weights(
            weights, p.shape[0])
        return cls(p=p, weights=w)

    def auto_span(self) -> "SimpleTrajectoryCost":
        max_dim = max(self.p.shape[0], self.weights.shape[0])
        return dataclasses.replace(
            self, p=span_vector(self.p, max_dim),
            weights=span_vector(self.weights, max_dim))

    def validate(self, preview: Preview) -> None:
        if self.p.shape[0] not in (preview.xdim, preview.full_xdim):
            raise DimensionError(bad_trailing_dim(
                "p", self.p, preview.xdim, preview.full_xdim, "state"))

    def lower(self, preview: Preview, x0: Tensor) -> Tuple[Tensor, Tensor]:
        fr = preview.free_response(x0)
        p, w, Psi, fr = common(self.p, self.weights, preview.Psi, fr,
                               device=preview.Psi.device)
        if self.p.shape[0] == preview.xdim:  # per-step
            tmp = Psi.reshape(*preview.batch_shape, preview.nr_x_step,
                              preview.xdim, preview.full_udim)
            resid = _blocks(fr, preview.nr_x_step, preview.xdim) - p
            return _wq(tmp, w, True), _wc(resid, w, tmp, True)
        Q = torch.einsum("...RU,R,...RV->...UV", Psi, w, Psi)
        c = torch.einsum("...R,...RU->...U", (fr - p) * w, Psi)
        return Q, c


@dataclasses.dataclass(frozen=True)
class TargetCost(CostFunction):
    """Terminal cost ``(M x_N - p)^T W (M x_N - p)`` (bottom block row
    only; ``M`` is per-step sized)."""

    M: Tensor
    p: Tensor
    weights: Tensor
    name = "TargetCost"

    @classmethod
    def create(cls, M, p, weights=None) -> "TargetCost":
        M = torch.atleast_2d(as_tensor(M))
        p = torch.atleast_1d(as_tensor(p))
        w = _ones_like_rows(p) if weights is None else _fit_weights(
            weights, p.shape[0])
        return cls(M=M, p=p, weights=w)

    def validate(self, preview: Preview) -> None:
        if self.M.shape[0] != self.p.shape[0]:
            raise DimensionError(rows_mismatch("M", "p", self.M, self.p))
        if self.M.shape[1] != preview.xdim:
            raise DimensionError(
                f"'M' has shape {tuple(self.M.shape)}; TargetCost applies to "
                f"the terminal state only, so its trailing dimension must "
                f"equal the per-step state dimension ({preview.xdim}).")

    def lower(self, preview: Preview, x0: Tensor) -> Tuple[Tensor, Tensor]:
        x = preview.xdim
        dev = preview.Psi.device
        Phi_N, x0_, xi_N = common(preview.Phi[..., -x:, :], as_tensor(x0),
                                  preview.xi[..., -x:], device=dev)
        x_N = (Phi_N @ x0_.unsqueeze(-1)).squeeze(-1) + xi_N
        M, p, w, Psi_N, x_N = common(self.M, self.p, self.weights,
                                     preview.Psi[..., -x:, :], x_N,
                                     device=dev)
        tmp = M @ Psi_N
        resid = torch.einsum("rx,...x->...r", M, x_N) - p
        return _wq(tmp, w, False), _wc(resid, w, tmp, False)


@dataclasses.dataclass(frozen=True)
class ControlCost(CostFunction):
    """``(N U - p)^T W (N U - p)`` on the control sequence (per-step mode
    is a block-diagonal Hessian built from the small ``N^T W N``)."""

    N: Tensor
    p: Tensor
    weights: Tensor
    name = "ControlCost"

    @classmethod
    def create(cls, N, p, weights=None) -> "ControlCost":
        N = torch.atleast_2d(as_tensor(N))
        p = torch.atleast_1d(as_tensor(p))
        w = _ones_like_rows(p) if weights is None else _fit_weights(
            weights, p.shape[0])
        return cls(N=N, p=p, weights=w)

    def auto_span(self) -> "ControlCost":
        max_dim = max(self.N.shape[0], self.p.shape[0], self.weights.shape[0])
        return dataclasses.replace(
            self, N=span_matrix(self.N, max_dim),
            p=span_vector(self.p, max_dim),
            weights=span_vector(self.weights, max_dim))

    def validate(self, preview: Preview) -> None:
        if self.N.shape[0] != self.p.shape[0]:
            raise DimensionError(rows_mismatch("N", "p", self.N, self.p))
        if self.N.shape[1] not in (preview.udim, preview.full_udim):
            raise DimensionError(bad_trailing_dim(
                "N", self.N, preview.udim, preview.full_udim, "input"))

    def lower(self, preview: Preview, x0: Tensor) -> Tuple[Tensor, Tensor]:
        N, p, w = common(self.N, self.p, self.weights,
                         device=preview.Psi.device)
        if self.N.shape[1] == preview.udim:  # per-step block diagonal
            small_q = torch.einsum("ru,r,rv->uv", N, w, N)
            small_c = -torch.einsum("r,r,ru->u", p, w, N)
            eye = torch.eye(preview.nr_u_step, dtype=small_q.dtype,
                            device=small_q.device)
            return (torch.kron(eye, small_q),
                    small_c.repeat(preview.nr_u_step))
        Q = torch.einsum("RU,R,RV->UV", N, w, N)
        c = -torch.einsum("R,R,RU->U", p, w, N)
        return Q, c


@dataclasses.dataclass(frozen=True)
class SimpleControlCost(CostFunction):
    """ControlCost with ``N = I``: a purely diagonal term."""

    p: Tensor
    weights: Tensor
    name = "SimpleControlCost"

    @classmethod
    def create(cls, p, weights=None) -> "SimpleControlCost":
        p = torch.atleast_1d(as_tensor(p))
        w = _ones_like_rows(p) if weights is None else _fit_weights(
            weights, p.shape[0])
        return cls(p=p, weights=w)

    def auto_span(self) -> "SimpleControlCost":
        max_dim = max(self.p.shape[0], self.weights.shape[0])
        return dataclasses.replace(
            self, p=span_vector(self.p, max_dim),
            weights=span_vector(self.weights, max_dim))

    def validate(self, preview: Preview) -> None:
        if self.p.shape[0] not in (preview.udim, preview.full_udim):
            raise DimensionError(bad_trailing_dim(
                "p", self.p, preview.udim, preview.full_udim, "input"))

    def lower(self, preview: Preview, x0: Tensor) -> Tuple[Tensor, Tensor]:
        p, w = common(self.p, self.weights, device=preview.Psi.device)
        if self.p.shape[0] == preview.udim:  # per-step
            w = w.repeat(preview.nr_u_step)
            p = p.repeat(preview.nr_u_step)
        return torch.diag(w), -(p * w)


@dataclasses.dataclass(frozen=True)
class MixedCost(CostFunction):
    """``(M X + N U - p)^T W (M X + N U - p)``.

    Parity with the reference, quirks included: per-step mode pairs state
    block k with input block k over the N control steps, so the terminal
    state ``x_N`` is not penalized; ``auto_span`` pads ``M`` with one extra
    zero column-block.
    """

    M: Tensor
    N: Tensor
    p: Tensor
    weights: Tensor
    name = "MixedCost"

    @classmethod
    def create(cls, M, N, p, weights=None) -> "MixedCost":
        M = torch.atleast_2d(as_tensor(M))
        N = torch.atleast_2d(as_tensor(N))
        p = torch.atleast_1d(as_tensor(p))
        w = _ones_like_rows(p) if weights is None else _fit_weights(
            weights, p.shape[0])
        return cls(M=M, N=N, p=p, weights=w)

    def auto_span(self) -> "MixedCost":
        max_dim = max(self.M.shape[0], self.N.shape[0], self.p.shape[0],
                      self.weights.shape[0])
        return dataclasses.replace(
            self,
            M=span_matrix(self.M, max_dim, add_cols=1),
            N=span_matrix(self.N, max_dim),
            p=span_vector(self.p, max_dim),
            weights=span_vector(self.weights, max_dim))

    def validate(self, preview: Preview) -> None:
        if self.M.shape[0] != self.p.shape[0]:
            raise DimensionError(rows_mismatch("M", "p", self.M, self.p))
        if self.N.shape[0] != self.p.shape[0]:
            raise DimensionError(rows_mismatch("N", "p", self.N, self.p))
        per_step = (self.M.shape[1] == preview.xdim
                    and self.N.shape[1] == preview.udim)
        full = (self.M.shape[1] == preview.full_xdim
                and self.N.shape[1] == preview.full_udim)
        if not (per_step or full):
            raise DimensionError(
                f"'M' {tuple(self.M.shape)} / 'N' {tuple(self.N.shape)} must "
                f"be jointly per-step ({preview.xdim}/{preview.udim}) or "
                f"full-horizon ({preview.full_xdim}/{preview.full_udim}).")

    def lower(self, preview: Preview, x0: Tensor) -> Tuple[Tensor, Tensor]:
        fr = preview.free_response(x0)
        M, N, p, w, Psi, fr = common(self.M, self.N, self.p, self.weights,
                                     preview.Psi, fr,
                                     device=preview.Psi.device)
        if self.M.shape[1] == preview.xdim:  # per-step over N control steps
            Nn, u = preview.nr_u_step, preview.udim
            psi = Psi.reshape(*preview.batch_shape, preview.nr_x_step,
                              preview.xdim, preview.full_udim)[..., :-1, :, :]
            tmp = torch.einsum("rx,...kxU->...krU", M, psi)
            # deposit N at column block k of row k via block-row selectors
            sel = torch.eye(Nn * u, dtype=tmp.dtype,
                            device=tmp.device).reshape(Nn, u, Nn * u)
            tmp = tmp + torch.einsum("ru,kuU->krU", N, sel)
            frb = _blocks(fr, preview.nr_x_step, preview.xdim)[..., :-1, :]
            resid = torch.einsum("rx,...kx->...kr", M, frb) - p
            return _wq(tmp, w, True), _wc(resid, w, tmp, True)
        tmp = M @ Psi + N
        resid = torch.einsum("rR,...R->...r", M, fr) - p
        return _wq(tmp, w, False), _wc(resid, w, tmp, False)
