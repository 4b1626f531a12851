"""Model-parallel (TP-analog) QP solving: constraint rows split over a mesh
axis.

Port of ``copra_tpu/parallel/model.py``.  For long horizons the dense
constraint matrix ``C [m, n]`` dominates memory and matvec time, so each
rank of the ``"model"`` axis owns a block of its rows (and of ``l``, ``u``,
``rho``, ``y``, ``z``) while the n-sized primal state is replicated: the
x-update's ``C' (rho z - y)`` is one all-reduce of n elements an iteration
over the model axis.  With a ``"batch"`` axis for scenarios, a 2-D
``("batch", "model")`` mesh is DP x TP (:func:`solve_qp_dp_tp`).

The iteration is ``copra_tpu_torch.qp.admm.solve_qp``'s with
``early_exit=False``, step for step; that solver is the single-device
oracle in the tests.  Each rank runs the reference's ``shard_map`` body on
its own plain tensors; the collectives go through
:mod:`~copra_tpu_torch.parallel._collectives`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from .._precision import highest_precision
from .._tensors import matvec, matvec_t
from ..qp.admm import _BASE_NDIM, _inf_norm, stack_constraints
from ..qp.types import (STATUS_MAX_ITER, STATUS_SOLVED, DenseQP, QPSolution,
                        SolverOptions, WarmStart)
from . import _collectives as coll
from .mesh import _sharded, make_mesh

Tensor = torch.Tensor

MODEL_AXIS = "model"
BATCH_AXIS = "batch"


def _pad_rows(arr: Tensor, m_pad: int, fill: float, dim: int = 0
              ) -> Tensor:
    """``arr`` with rows of ``fill`` appended along ``dim`` up to
    ``m_pad``."""
    pad = m_pad - arr.shape[dim]
    if pad == 0:
        return arr
    shape = list(arr.shape)
    shape[dim] = pad
    return torch.cat([arr, arr.new_full(shape, fill)], dim=dim)


def shard_constraints(qp: DenseQP, options: SolverOptions, n_shards: int
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor, int]:
    """Stack to two-sided form and pad rows to a multiple of ``n_shards``:
    ``(C, l, u, rho, m)`` with ``m`` the row count before padding.

    Padded rows are the trivially satisfied ``0 x <= 1`` with ``l = -inf``
    (the masking idiom the constraint layer uses for infinite bounds).
    Batched leaves pad their row dimension.
    """
    C, l, u, rho = stack_constraints(qp, options)
    m = C.shape[-2]
    m_pad = math.ceil(m / n_shards) * n_shards
    row = C.dim() - 2
    return (_pad_rows(C, m_pad, 0.0, row),
            _pad_rows(l, m_pad, -math.inf, row),
            _pad_rows(u, m_pad, 1.0, row),
            _pad_rows(rho, m_pad, options.rho, row), m)


def _row_scaling(C: Tensor, options: SolverOptions) -> Tensor:
    """The row normalisation ``E`` (ones without ``row_normalize``; 1 on
    the zero rows of padding)."""
    if options.row_normalize:
        rn = torch.sqrt((C * C).sum(-1))
        return torch.where(rn > 1e-12, 1.0 / rn, 1.0)
    return torch.ones(C.shape[:-1], dtype=C.dtype, device=C.device)


def _warm_rows(warm_start: Optional[WarmStart], E: Tensor, x_shape):
    """``(x0, y0, z0)`` in the scaled metric: the warm start's duals and
    slacks padded to ``E``'s rows (``y0 = pad(y) / E``, ``z0 = pad(z) E``),
    or zeros."""
    if warm_start is None:
        return (E.new_zeros(x_shape), torch.zeros_like(E),
                torch.zeros_like(E))
    m = E.shape[-1]
    row = E.dim() - 1
    return (warm_start.x, _pad_rows(warm_start.y, m, 0.0, row) / E,
            _pad_rows(warm_start.z, m, 0.0, row) * E)


def _local_solve(Q, c, C_s, l_s, u_s, rho_s, x0, y0_s, z0_s,
                 options: SolverOptions, mesh: DeviceMesh, axis: str):
    """One rank's share of the row-split ADMM (the reference's
    ``local_solve`` / ``lane_solve``), over leading lane dimensions when
    the leaves carry them: ``(x, z_s, y_s, r_prim, r_dual)``."""
    n = Q.shape[-1]
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
    sigma, alpha = options.sigma, options.alpha
    # K = Q + sigma I + sum over shards of C_s' rho_s C_s, by the same
    # all-reduce the iterations use
    CtpC = coll.psum((C_s.mT * rho_s.unsqueeze(-2)) @ C_s, mesh, axis)
    K = Q + sigma * eye + CtpC
    S = 1.0 / torch.sqrt(torch.diagonal(K, dim1=-2, dim2=-1))
    Ss = S.unsqueeze(-1) * S.unsqueeze(-2)
    Ls = torch.linalg.cholesky(K * Ss)
    Lsi = torch.linalg.solve_triangular(Ls, eye.expand_as(Ls), upper=False)
    Kinv = (Lsi.mT @ Lsi) * Ss
    rho_inv_s = 1.0 / rho_s

    def body(x, z_s, y_s):
        # C' (rho z - y): the local partial product, summed over shards
        ctw = coll.psum(matvec_t(C_s, rho_s * z_s - y_s), mesh, axis)
        x_t = matvec(Kinv, sigma * x - c + ctw)
        z_t_s = matvec(C_s, x_t)
        x_n = alpha * x_t + (1 - alpha) * x
        z_rel = alpha * z_t_s + (1 - alpha) * z_s
        z_n = torch.clamp(z_rel + rho_inv_s * y_s, l_s, u_s)
        y_n = y_s + rho_s * (z_rel - z_n)
        return x_n, z_n, y_n

    x, z_s, y_s = x0, z0_s, y0_s
    for _ in range(options.max_iter):
        x, z_s, y_s = body(x, z_s, y_s)

    # residuals: local maxima reduced by all-reduce (max, sum)
    r_prim = coll.pmax(_inf_norm(matvec(C_s, x) - z_s), mesh, axis)
    cty = coll.psum(matvec_t(C_s, y_s), mesh, axis)
    r_dual = (matvec(Q, x) + c + cty).abs().amax(-1)
    return x, z_s, y_s, r_prim, r_dual


def _status(r_prim: Tensor, r_dual: Tensor, options: SolverOptions
            ) -> Tensor:
    """The reference's rule: solved when both residuals are within ten
    times ``eps_abs``, floored at 25 machine eps of the dtype."""
    eps_floor = 25.0 * float(torch.finfo(r_prim.dtype).eps)
    tol = max(options.eps_abs, eps_floor) * 10
    conv = (r_prim <= tol) & (r_dual <= tol)
    return torch.where(conv, STATUS_SOLVED, STATUS_MAX_ITER).to(torch.int32)


def _gather_rows(y_s: Tensor, z_s: Tensor, mesh: DeviceMesh, axis: str
                 ) -> Tuple[Tensor, Tensor]:
    """``y`` and ``z`` in the unsplit (padded) row layout, by one
    all-gather of both over ``axis``."""
    g = coll.all_gather(torch.stack((y_s, z_s)), mesh, axis)  # [D, 2, .., ms]
    g = g.movedim(0, -2)                                      # [2, .., D, ms]
    g = g.reshape(*g.shape[:-2], -1)
    return g[0], g[1]


@highest_precision
def solve_qp_model_parallel(qp: DenseQP,
                            options: SolverOptions = SolverOptions(),
                            warm_start: Optional[WarmStart] = None,
                            mesh: Optional[DeviceMesh] = None,
                            axis: str = MODEL_AXIS) -> QPSolution:
    """Solve ONE dense QP with its constraint rows split over ``axis``.

    Every rank passes the whole QP; the returned solution is the same on
    every rank, in the unsplit layout: duals and slacks have the padded
    row count (slice ``[:m]`` for the original rows).  A fixed iteration
    count (no early exit), so all shards step in lockstep.  The default
    mesh is every process on one axis.
    """
    if mesh is None:
        mesh = make_mesh(axis_names=(axis,))
    n_shards = coll.axis_size(mesh, axis)
    C, l, u, rho, _ = shard_constraints(qp, options, n_shards)
    # the same exact row reparametrization as the single-device solver;
    # duals come back in the original metric below
    E = _row_scaling(C, options)
    C, l, u = C * E.unsqueeze(-1), E * l, E * u
    x0, y0, z0 = _warm_rows(warm_start, E, (qp.nr_vars,))
    own = lambda t: coll.local_rows(t, mesh, axis)
    x, z_s, y_s, r_prim, r_dual = _local_solve(
        qp.Q, qp.c, own(C), own(l), own(u), own(rho), x0, own(y0), own(z0),
        options, mesh, axis)
    y, z = _gather_rows(y_s, z_s, mesh, axis)
    return QPSolution(x=x, y=E * y, z=z / E,
                      status=_status(r_prim, r_dual, options),
                      iterations=torch.tensor(options.max_iter,
                                              dtype=torch.int32,
                                              device=x.device),
                      primal_residual=r_prim, dual_residual=r_dual)


@highest_precision
def solve_qp_dp_tp(qp: DenseQP,
                   options: SolverOptions = SolverOptions(),
                   warm_start: Optional[WarmStart] = None,
                   mesh: Optional[DeviceMesh] = None,
                   batch_axis: str = BATCH_AXIS,
                   model_axis: str = MODEL_AXIS) -> QPSolution:
    """DP x TP: a BATCH of dense QPs over a 2-D ``(batch, model)`` mesh.

    The leaves of ``qp`` carry a leading batch dimension (``Q [B, n, n]``,
    ``c [B, n]``, ...; a leaf without one is shared by the lanes), the
    same full tensors on every rank; a warm start may be full tensors or
    an earlier result's DTensors.
    Scenarios are split over ``batch_axis`` and each scenario's constraint
    rows over ``model_axis``; the per-lane ``C' (rho z - y)`` reductions
    run over the model axis only, and lanes never communicate.  ``B`` must
    divide by the batch-axis size.  The result's leaves are DTensors split
    over ``batch_axis`` (and replicated over ``model_axis``), duals and
    slacks in the padded row layout.  Fixed iteration count, as
    :func:`solve_qp_model_parallel`.  The default mesh is every process
    reshaped to ``(2, -1)``.
    """
    if mesh is None:
        mesh = make_mesh(shape=(2, -1), axis_names=(batch_axis, model_axis))
    n_row_shards = coll.axis_size(mesh, model_axis)
    n_batch_shards = coll.axis_size(mesh, batch_axis)
    B = qp.Q.shape[0]
    if B % n_batch_shards:
        raise ValueError(
            f"batch {B} not divisible by {n_batch_shards} batch shards")
    # this rank's lanes (a DTensor warm start from an earlier call is read
    # locally), then the rows of this rank's model shard
    lanes = lambda t: coll.local_rows(t, mesh, batch_axis)
    qp = DenseQP(**{f: lanes(getattr(qp, f))
                    if getattr(qp, f).dim() > nd else getattr(qp, f)
                    for f, nd in _BASE_NDIM.items()})
    if warm_start is not None:
        warm_start = WarmStart(*(lanes(t) for t in (
            warm_start.x, warm_start.y, warm_start.z)))
    C, l, u, rho, _ = shard_constraints(qp, options, n_row_shards)
    E = _row_scaling(C, options)
    C, l, u = C * E.unsqueeze(-1), E * l, E * u
    x0, y0, z0 = _warm_rows(warm_start, E, (E.shape[0], qp.nr_vars))
    own = lambda t: coll.local_rows(t, mesh, model_axis, dim=1)
    x, z_s, y_s, r_prim, r_dual = _local_solve(
        qp.Q, qp.c, own(C), own(l), own(u), own(rho), x0, own(y0), own(z0),
        options, mesh, model_axis)
    y, z = _gather_rows(y_s, z_s, mesh, model_axis)
    return _sharded(QPSolution(
        x=x, y=E * y, z=z / E, status=_status(r_prim, r_dual, options),
        iterations=torch.full(r_prim.shape, options.max_iter,
                              dtype=torch.int32, device=x.device),
        primal_residual=r_prim, dual_residual=r_dual), mesh, batch_axis)
