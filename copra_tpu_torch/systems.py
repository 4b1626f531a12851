"""System specifications and preview-matrix condensing.

Port of ``copra_tpu/systems.py``.  The algebraic contract is the same:

    X = Phi @ x0 + Psi @ U + xi,   with X = [x_0; x_1; ...; x_N]

``Phi`` is ``[(N+1)*x, x]`` with an identity top block, ``Psi`` is
``[(N+1)*x, N*u]`` with a zero top block-row, ``xi`` is ``[(N+1)*x]`` with
a zero top block.  Where JAX vmaps over a fleet, every function here takes
leading batch dimensions directly: an :class:`LTVSystem` whose ``A`` is
``[B, N, x, x]`` condenses into a :class:`Preview` whose ``Phi`` is
``[B, (N+1)*x, x]``.  The serial recursions are Python loops over N small
batched products (the reference's ``lax.scan``); the log-depth ``_assoc``
forms run :func:`~copra_tpu_torch._scan.associative_scan` (the reference's
``lax.associative_scan``).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from ._precision import highest_precision
from ._scan import affine_combine, associative_scan
from ._tensors import as_tensor, common, matvec
from .errors import DimensionError, bad_dim

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LTISystem:
    """Linear time-invariant system ``x_{k+1} = A x_k + B u_k + d``.

    ``A [x, x]``, ``B [x, u]``, ``d [x]``, ``x0 [x]`` (leading batch
    dimensions allowed), ``horizon`` N.
    """

    A: Tensor
    B: Tensor
    d: Tensor
    x0: Tensor
    horizon: int

    @classmethod
    def create(cls, A, B, d, x0, horizon: int) -> "LTISystem":
        """Validating constructor."""
        A, B, d, x0 = map(as_tensor, (A, B, d, x0))
        if A.dim() != 2 or A.shape[0] != A.shape[1]:
            raise DimensionError(
                f"'A' must be square, got shape {tuple(A.shape)}.")
        x = A.shape[0]
        if B.dim() != 2 or B.shape[0] != x:
            raise DimensionError(
                f"'B' must have shape ({x}, u), got {tuple(B.shape)}.")
        if tuple(d.shape) != (x,):
            raise DimensionError(bad_dim("d", tuple(d.shape), x))
        if tuple(x0.shape) != (x,):
            raise DimensionError(bad_dim("x0", tuple(x0.shape), x))
        if horizon < 1:
            raise DimensionError(f"'horizon' must be >= 1, got {horizon}.")
        return cls(A=A, B=B, d=d, x0=x0, horizon=int(horizon))

    @property
    def xdim(self) -> int:
        return self.A.shape[-1]

    @property
    def udim(self) -> int:
        return self.B.shape[-1]

    @property
    def nr_u_step(self) -> int:
        return self.horizon

    @property
    def nr_x_step(self) -> int:
        return self.horizon + 1

    @property
    def full_xdim(self) -> int:
        return self.xdim * (self.horizon + 1)

    @property
    def full_udim(self) -> int:
        return self.udim * self.horizon

    def with_x0(self, x0) -> "LTISystem":
        return dataclasses.replace(self, x0=as_tensor(x0))


@dataclasses.dataclass(frozen=True)
class LTVSystem:
    """Linear time-variant system ``x_{k+1} = A_k x_k + B_k u_k + d_k``.

    ``A [N, x, x]``, ``B [N, x, u]``, ``d [N, x]``, ``x0 [x]``; a fleet
    adds a leading batch dimension to every field (``A [B, N, x, x]``).
    """

    A: Tensor
    B: Tensor
    d: Tensor
    x0: Tensor

    @classmethod
    def create(cls, A, B, d, x0) -> "LTVSystem":
        A, B, d, x0 = map(as_tensor, (A, B, d, x0))
        if A.dim() != 3 or A.shape[1] != A.shape[2]:
            raise DimensionError(
                f"'A' must have shape (N, x, x), got {tuple(A.shape)}.")
        N, x = A.shape[0], A.shape[1]
        if B.dim() != 3 or B.shape[0] != N or B.shape[1] != x:
            raise DimensionError(
                f"'B' must have shape ({N}, {x}, u), got {tuple(B.shape)}.")
        if tuple(d.shape) != (N, x):
            raise DimensionError(
                f"'d' must have shape ({N}, {x}), got {tuple(d.shape)}.")
        if tuple(x0.shape) != (x,):
            raise DimensionError(bad_dim("x0", tuple(x0.shape), x))
        return cls(A=A, B=B, d=d, x0=x0)

    @classmethod
    def from_step_fns(cls, state_fn, input_fn, drift_fn, x0, horizon: int
                      ) -> "LTVSystem":
        """Build the stacked arrays from per-step callables."""
        A = torch.stack([as_tensor(state_fn(k)) for k in range(horizon)])
        B = torch.stack([as_tensor(input_fn(k)) for k in range(horizon)])
        d = torch.stack([as_tensor(drift_fn(k)) for k in range(horizon)])
        return cls.create(A, B, d, x0)

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
    def nr_u_step(self) -> int:
        return self.horizon

    @property
    def nr_x_step(self) -> int:
        return self.horizon + 1

    @property
    def full_xdim(self) -> int:
        return self.xdim * (self.horizon + 1)

    @property
    def full_udim(self) -> int:
        return self.udim * self.horizon

    def with_x0(self, x0) -> "LTVSystem":
        return dataclasses.replace(self, x0=as_tensor(x0))


System = Union[LTISystem, LTVSystem]


@dataclasses.dataclass(frozen=True)
class Preview:
    """Condensed preview matrices: ``X = Phi @ x0 + Psi @ U + xi``.

    ``Phi [..., (N+1)*x, x]``, ``Psi [..., (N+1)*x, N*u]``,
    ``xi [..., (N+1)*x]``.
    """

    Phi: Tensor
    Psi: Tensor
    xi: Tensor
    xdim: int
    udim: int
    horizon: int

    @property
    def nr_x_step(self) -> int:
        return self.horizon + 1

    @property
    def nr_u_step(self) -> int:
        return self.horizon

    @property
    def full_xdim(self) -> int:
        return self.xdim * (self.horizon + 1)

    @property
    def full_udim(self) -> int:
        return self.udim * self.horizon

    @property
    def batch_shape(self) -> torch.Size:
        return self.Psi.shape[:-2]

    def phi_blocks(self) -> Tensor:
        """``[..., N+1, x, x]`` view of Phi."""
        return self.Phi.reshape(*self.batch_shape, self.nr_x_step,
                                self.xdim, self.xdim)

    def psi_blocks(self) -> Tensor:
        """``[..., N+1, x, N*u]`` view of Psi (row blocks)."""
        return self.Psi.reshape(*self.batch_shape, self.nr_x_step,
                                self.xdim, self.full_udim)

    def xi_blocks(self) -> Tensor:
        """``[..., N+1, x]`` view of xi."""
        return self.xi.reshape(*self.batch_shape, self.nr_x_step, self.xdim)

    def free_response(self, x0: Tensor) -> Tensor:
        """``Phi @ x0 + xi``, the input-free trajectory ``[..., (N+1)*x]``;
        extra leading dimensions of ``x0`` broadcast against the batch."""
        Phi, x0, xi = common(self.Phi, as_tensor(x0), self.xi,
                             device=self.Phi.device)
        return matvec(Phi, x0) + xi

    def trajectory(self, x0: Tensor, U: Tensor) -> Tensor:
        """Reconstruct ``X`` from a control sequence."""
        Phi, Psi, x0, U, xi = common(self.Phi, self.Psi, as_tensor(x0),
                                     as_tensor(U), self.xi,
                                     device=self.Phi.device)
        return matvec(Phi, x0) + matvec(Psi, U) + xi


def _toeplitz_psi(imps: Tensor, batch, N: int, x: int, u: int) -> Tensor:
    """Psi from the impulse stack ``imps [..., N, x, u]``: block (i, j) is
    ``imps[i-1-j]`` for ``0 <= i-1-j < N``, else the zero block."""
    imps_pad = torch.cat([imps, imps.new_zeros(*batch, 1, x, u)], dim=-3)
    i_idx = torch.arange(N + 1, device=imps.device)[:, None]
    j_idx = torch.arange(N, device=imps.device)[None, :]
    k = i_idx - 1 - j_idx
    k = torch.where((k >= 0) & (k < N), k, N)
    blocks = imps_pad[..., k, :, :]            # [..., N+1, N, x, u]
    return blocks.transpose(-3, -2).reshape(*batch, (N + 1) * x, N * u)


@highest_precision
def condense_lti(A, B, d, horizon: int) -> Preview:
    """Condense an LTI system over ``horizon`` steps: ``Phi``/``xi`` and
    the impulse stack ``[B, AB, A^2 B, ...]`` by an N-step loop, then
    ``Psi`` by one Toeplitz gather of the impulse stack."""
    A = as_tensor(A)
    A, B, d = common(A, as_tensor(B), as_tensor(d), device=A.device)
    N = int(horizon)
    x, u = A.shape[-1], B.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2], d.shape[:-1])
    kw = dict(dtype=A.dtype, device=A.device)
    eye = torch.eye(x, **kw).expand(*batch, x, x)
    zero = torch.zeros(*batch, x, **kw)

    phi, xi_k, imp = eye, zero, B.expand(*batch, x, u)
    phis, xis, imps = [eye], [zero], []
    for _ in range(N):
        imps.append(imp)
        phi = A @ phi
        xi_k = matvec(A, xi_k) + d
        imp = A @ imp
        phis.append(phi)
        xis.append(xi_k)
    Phi = torch.stack(phis, dim=-3)            # [..., N+1, x, x]
    xi = torch.stack(xis, dim=-2)              # [..., N+1, x]
    Psi = _toeplitz_psi(torch.stack(imps, dim=-3), batch, N, x, u)
    return Preview(Phi=Phi.reshape(*batch, (N + 1) * x, x), Psi=Psi,
                   xi=xi.reshape(*batch, (N + 1) * x), xdim=x, udim=u,
                   horizon=N)


@highest_precision
def condense_ltv(A, B, d) -> Preview:
    """Condense an LTV system from stacked ``A [..., N, x, x]``,
    ``B [..., N, x, u]``, ``d [..., N, x]``: each step applies ``A_k`` to
    the growing Psi row block and deposits ``B_k`` in column block k."""
    A = as_tensor(A)
    A, B, d = common(A, as_tensor(B), as_tensor(d), device=A.device)
    N, x = A.shape[-3], A.shape[-1]
    u = B.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-3], B.shape[:-3], d.shape[:-2])
    kw = dict(dtype=A.dtype, device=A.device)
    eye = torch.eye(x, **kw).expand(*batch, x, x)
    zero = torch.zeros(*batch, x, **kw)

    phi, psi, xi_k = eye, torch.zeros(*batch, x, N * u, **kw), zero
    phis, psis, xis = [eye], [psi], [zero]
    for k in range(N):
        A_k = A[..., k, :, :]
        phi = A_k @ phi
        # column block k of A_k @ psi is exactly zero, so adding B_k there
        # equals the reference's A_k @ psi + B_k @ sel_k bit for bit
        psi = A_k @ psi
        psi[..., k * u:(k + 1) * u] += B[..., k, :, :]
        xi_k = matvec(A_k, xi_k) + d[..., k, :]
        phis.append(phi)
        psis.append(psi)
        xis.append(xi_k)
    return Preview(
        Phi=torch.stack(phis, dim=-3).reshape(*batch, (N + 1) * x, x),
        Psi=torch.stack(psis, dim=-3).reshape(*batch, (N + 1) * x, N * u),
        xi=torch.stack(xis, dim=-2).reshape(*batch, (N + 1) * x),
        xdim=x, udim=u, horizon=N)


@highest_precision
def condense_lti_assoc(A, B, d, horizon: int) -> Preview:
    """Log-depth LTI condensing: the affine steps ``x -> A x + d`` compose
    as ``(A2 A1, A2 b1 + b2)``, so ``Phi``/``xi`` and the impulse stack
    come from one associative scan of ``ceil(log2 N)`` levels in place of
    :func:`condense_lti`'s N steps; the same Toeplitz gather gives
    ``Psi``.  Leading batch dimensions as in :func:`condense_lti`."""
    A = as_tensor(A)
    A, B, d = common(A, as_tensor(B), as_tensor(d), device=A.device)
    N = int(horizon)
    x, u = A.shape[-1], B.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2], d.shape[:-1])
    kw = dict(dtype=A.dtype, device=A.device)
    As = A.unsqueeze(-3).expand(*batch, N, x, x)
    ds = d.unsqueeze(-2).unsqueeze(-1).expand(*batch, N, x, 1)
    phis, xis = associative_scan(affine_combine, (As, ds), dim=len(batch))
    xis = xis.squeeze(-1)
    # phis[k] = A^{k+1}, xis[k] = sum_{i<=k} A^i d
    Bb = B.expand(*batch, x, u)
    Bb = Bb.unsqueeze(-3)
    imps = torch.cat([Bb, phis[..., :-1, :, :] @ Bb], dim=-3)
    eye = torch.eye(x, **kw).expand(*batch, 1, x, x)
    Phi = torch.cat([eye, phis], dim=-3)
    xi = torch.cat([torch.zeros(*batch, 1, x, **kw), xis], dim=-2)
    return Preview(Phi=Phi.reshape(*batch, (N + 1) * x, x),
                   Psi=_toeplitz_psi(imps, batch, N, x, u),
                   xi=xi.reshape(*batch, (N + 1) * x), xdim=x, udim=u,
                   horizon=N)


@highest_precision
def condense_ltv_assoc(A, B, d) -> Preview:
    """Log-depth LTV condensing: the whole recursion of
    :func:`condense_ltv`, with the growing Psi row block, is the
    composition of the pairs ``(A_k, [d_k | B_k e_k'])`` acting as ``m ->
    A_k m + [d_k | B_k e_k']`` on one ``[x, 1 + N u]`` block ``[xi_k |
    Psi-row_k]`` per stage, so one associative scan builds it.  Leading
    batch dimensions as in :func:`condense_ltv`."""
    A = as_tensor(A)
    A, B, d = common(A, as_tensor(B), as_tensor(d), device=A.device)
    N, x = A.shape[-3], A.shape[-1]
    u = B.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-3], B.shape[:-3], d.shape[:-2])
    kw = dict(dtype=A.dtype, device=A.device)
    # block-row selectors [N, u, N u]: sel_k deposits B_k at column block k
    sel = torch.eye(N * u, **kw).reshape(N, u, N * u)
    U = torch.einsum("...kxu,kuv->...kxv", B.expand(*batch, N, x, u), sel)
    rhs = torch.cat([d.expand(*batch, N, x).unsqueeze(-1), U], dim=-1)
    phis, outs = associative_scan(
        affine_combine, (A.expand(*batch, N, x, x), rhs), dim=len(batch))
    eye = torch.eye(x, **kw).expand(*batch, 1, x, x)
    Phi = torch.cat([eye, phis], dim=-3)
    Psi = torch.cat([torch.zeros(*batch, 1, x, N * u, **kw), outs[..., 1:]],
                    dim=-3)
    xi = torch.cat([torch.zeros(*batch, 1, x, **kw), outs[..., 0]], dim=-2)
    return Preview(Phi=Phi.reshape(*batch, (N + 1) * x, x),
                   Psi=Psi.reshape(*batch, (N + 1) * x, N * u),
                   xi=xi.reshape(*batch, (N + 1) * x), xdim=x, udim=u,
                   horizon=N)


def condense(system: System, method: str = "scan") -> Preview:
    """Condense either system kind.  ``method``: ``"scan"`` (the serial
    recursion, fewest operations) or anything else for the log-depth
    ``_assoc`` form, as the reference dispatches."""
    if isinstance(system, LTISystem):
        fn = condense_lti if method == "scan" else condense_lti_assoc
        return fn(system.A, system.B, system.d, system.horizon)
    if isinstance(system, LTVSystem):
        fn = condense_ltv if method == "scan" else condense_ltv_assoc
        return fn(system.A, system.B, system.d)
    raise TypeError(f"unknown system type: {type(system)!r}")


def lti_as_ltv(system: LTISystem) -> LTVSystem:
    """Broadcast an LTI system into the stacked LTV layout."""
    N = system.horizon

    def rep(t: Tensor, trailing: int) -> Tensor:
        lead = t.shape[:t.dim() - trailing]
        return t.unsqueeze(-trailing - 1).expand(
            *lead, N, *t.shape[t.dim() - trailing:])

    return LTVSystem(A=rep(system.A, 2), B=rep(system.B, 2),
                     d=rep(system.d, 1), x0=system.x0)


def replay_dynamics(system: System, X, U) -> Tensor:
    """Max dynamics-consistency residual
    ``max_k |x_{k+1} - A_k x_k - B_k u_k - d_k|``."""
    x, u, N = system.xdim, system.udim, system.horizon
    A, B, d, X, U = common(system.A, system.B, system.d, as_tensor(X),
                           as_tensor(U), device=system.A.device)
    Xb = X.reshape(*X.shape[:-1], N + 1, x)
    Ub = U.reshape(*U.shape[:-1], N, u)
    if isinstance(system, LTISystem):
        pred = Xb[..., :-1, :] @ A.mT + Ub @ B.mT + d.unsqueeze(-2)
    else:
        pred = matvec(A, Xb[..., :-1, :]) + matvec(B, Ub) + d
    return torch.max(torch.abs(Xb[..., 1:, :] - pred))
