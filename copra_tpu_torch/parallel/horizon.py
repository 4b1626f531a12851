"""Horizon-sharded (sequence-parallel) LQR over a device mesh.

Port of ``copra_tpu/parallel/horizon.py``: the multi-device form of the
log-depth Riccati solve (:func:`copra_tpu_torch.qp.riccati.lqr_solve_assoc`).
The stages are split over a ``"seq"`` mesh axis; each rank runs a local
associative suffix scan over its interval elements, the per-shard totals
(one 5-tuple of x-by-x matrices a shard) are exchanged by one all-gather,
folded into the suffix of the later shards and spliced onto the local
scan.  The closed-loop rollout does the same with affine maps.  Traffic:
O(D x^2) a solve, whatever N; then the result as the reference returns
it, ``U`` split over the axis and ``X = [x0, states]`` whole on every rank
(one all-gather of the N states, as the reference's concatenation).

Where the reference traces one program for all shards, and so folds the
shard totals with an identity element selected by ``jnp.where``, each rank
here folds only the totals it needs (plain Python conditions on its index
along the axis).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .._precision import highest_precision
from .._scan import affine_combine, associative_scan
from .._tensors import matvec as _mv
from ..qp.riccati import _interval_combine, _inv, _solve
from . import _collectives as coll
from .mesh import make_mesh

Tensor = torch.Tensor

SEQ_AXIS = "seq"
BATCH_AXIS = "batch"


def _stage_elements(A, B, d, Qx, qx, Ru, ru):
    """Interval elements of the stages of ``A`` and the terminal element
    (``Qx``, ``qx`` carry one more entry, the terminal pair, than ``A``);
    the linear control cost is absorbed as in ``lqr_solve_assoc``.
    Leading lane dimensions are allowed."""
    x = A.shape[-1]
    Rinv_ru = _solve(Ru, ru.unsqueeze(-1)).squeeze(-1)
    BRB = B @ _inv(Ru) @ B.mT
    elems = (A, d - _mv(B, Rinv_ru), BRB, Qx[..., :-1, :, :],
             -qx[..., :-1, :])
    eye = torch.eye(x, dtype=A.dtype, device=A.device)
    QxN, qxN = Qx[..., -1, :, :], qx[..., -1, :]
    term = (eye.expand(QxN.shape), torch.zeros_like(qxN),
            torch.zeros_like(QxN), QxN, -qxN)
    return elems, term


def _pack(parts, lead: int) -> Tensor:
    """Tensors ``[*lanes, *tail_i]`` (``lead`` lane dimensions) as one
    ``[*lanes, K]`` tensor: one all-gather moves them all."""
    return torch.cat([p.reshape(*p.shape[:lead], -1) for p in parts], dim=-1)


def _unpack(flat: Tensor, like, lead: int) -> Tuple[Tensor, ...]:
    """Inverse of :func:`_pack` on the last dimension of ``flat``, the
    tails taken from ``like``; ``flat``'s leading dimensions are kept."""
    out, at = [], 0
    for p in like:
        size = p[(0,) * lead].numel()
        out.append(flat[..., at:at + size].reshape(*flat.shape[:-1],
                                                   *p.shape[lead:]))
        at += size
    return tuple(out)


def _make_local(mesh: DeviceMesh, axis: str):
    """One rank's LQ solve over its stages (the stage dimension follows the
    lane dimensions, if any): suffix scan, one all-gather of the shard
    totals, gains, closed-loop prefix scan, one all-gather of the affine
    totals.  Returns ``(Xs, U)``: the state leaving each local stage, and
    its control."""
    _, D, s = coll.axis_group(mesh, axis)

    def local(eA, eb, eC, eJ, eh, term, Bv, dv, Ruv, ruv, x0v):
        sd = eA.dim() - 3                   # the stage dimension
        x = eA.shape[-1]
        eye = torch.eye(x, dtype=eA.dtype, device=eA.device)
        at = lambda t, k: t.select(sd, k)

        # local suffix scan (this shard's stages only); the reverse scan
        # hands (later suffix, earlier stage), the combine takes (earlier,
        # later)
        loc = associative_scan(lambda a, b: _interval_combine(b, a),
                               (eA, eb, eC, eJ, eh), dim=sd, reverse=True)
        total = tuple(at(t, 0) for t in loc)
        # every shard's total, then the suffix of the later shards and the
        # terminal element: R_s = total_{s+1} (x) ... (x) total_{D-1} (x)
        # term
        gathered = _unpack(coll.all_gather(_pack(total, sd), mesh, axis),
                           total, sd)
        R = term
        for k in range(D - 1, s, -1):
            R = _interval_combine(tuple(g[k] for g in gathered), R)
        # the global suffix at each local stage: loc[i] (x) R
        suff = _interval_combine(loc, tuple(r.unsqueeze(sd) for r in R))
        # V_{k+1} for each local stage: shifted left, R's J at the boundary
        Vn = torch.cat([suff[3].narrow(sd, 1, eA.shape[sd] - 1),
                        R[3].unsqueeze(sd)], dim=sd)
        vn = -torch.cat([suff[4].narrow(sd, 1, eA.shape[sd] - 1),
                         R[4].unsqueeze(sd)], dim=sd)

        BtV = Bv.mT @ Vn
        Rb = Ruv + BtV @ Bv
        Ks = -_solve(Rb, BtV @ eA)
        ks = -_solve(Rb, (ruv + _mv(Bv.mT, vn + _mv(Vn, dv))).unsqueeze(-1)
                     ).squeeze(-1)

        # closed-loop rollout: a prefix scan of the affine maps, then the
        # maps of the earlier shards: P_s = tot_{s-1} o ... o tot_0
        Mp, cp = associative_scan(affine_combine,
                                  (eA + Bv @ Ks, _mv(Bv, ks) + dv), dim=sd)
        last = eA.shape[sd] - 1
        tot = (at(Mp, last), at(cp, last))
        gM, gc = _unpack(coll.all_gather(_pack(tot, sd), mesh, axis), tot, sd)
        Pm, pc = eye.expand_as(at(Mp, 0)), torch.zeros_like(at(cp, 0))
        for k in range(s):
            Pm, pc = affine_combine((Pm, pc), (gM[k], gc[k]))

        x_start = _mv(Pm, x0v) + pc           # the state entering the shard
        Xs = _mv(Mp, x_start.unsqueeze(sd)) + cp
        X_in = torch.cat([x_start.unsqueeze(sd), Xs.narrow(sd, 0, last)],
                         dim=sd)
        return Xs, _mv(Ks, X_in) + ks

    return local


def _solve_shard(A, B, d, Qx, qx, Ru, ru, x0, mesh, axis,
                 batch_axis=None) -> Tuple[DTensor, DTensor]:
    """Elements of this rank's stages (the stage dimension after the
    lane dimensions of ``x0``) and the local solve; returns the global
    ``X`` (replicated over ``axis``) and ``U`` (split over it) as
    DTensors, their lane dimension split over ``batch_axis`` if given."""
    sd = x0.dim() - 1
    N = A.shape[sd]
    stages = lambda t: coll.local_rows(t.narrow(sd, 0, N), mesh, axis, sd)
    Qx_l = torch.cat([stages(Qx), Qx.narrow(sd, N, 1)], dim=sd)
    qx_l = torch.cat([stages(qx), qx.narrow(sd, N, 1)], dim=sd)
    elems, term = _stage_elements(stages(A), stages(B), stages(d), Qx_l,
                                  qx_l, stages(Ru), stages(ru))
    Xs, U = _make_local(mesh, axis)(
        *elems, term, stages(B), stages(d), stages(Ru), stages(ru), x0)
    Xs = torch.cat(coll.all_gather(Xs, mesh, axis).unbind(0), dim=sd)
    X = torch.cat([x0.unsqueeze(sd), Xs], dim=sd)

    def placed(t, seq):
        return DTensor.from_local(t, mesh, [
            seq if name == axis else Shard(0) if name == batch_axis
            else Replicate() for name in mesh.mesh_dim_names],
            run_check=False)

    return placed(X, Replicate()), placed(U, Shard(sd))


@highest_precision
def lqr_solve_sharded(A: Tensor, B: Tensor, d: Tensor, Qx: Tensor,
                      qx: Tensor, Ru: Tensor, ru: Tensor, x0: Tensor,
                      mesh: Optional[DeviceMesh] = None,
                      axis: str = SEQ_AXIS) -> Tuple[DTensor, DTensor]:
    """LQ solve with the horizon split over ``axis`` of ``mesh``.

    The arguments are :func:`copra_tpu_torch.qp.riccati.lqr_solve`'s,
    whole on every rank; ``N`` must divide by the axis size ``D``.
    ``Qx``/``qx`` carry ``N + 1`` entries: the terminal pair is folded in
    through the cross-shard suffix, so every shard holds exactly ``L = N /
    D`` stages.  Returns ``lqr_solve``'s ``(X [N + 1, x], U [N, u])`` as
    DTensors: ``U`` split over ``axis`` (rank ``s`` holds ``U[sL : sL +
    L]``), ``X`` whole on every rank.
    """
    if mesh is None:
        mesh = make_mesh(axis_names=(axis,))
    D = coll.axis_size(mesh, axis)
    N = A.shape[0]
    if N % D:
        raise ValueError(f"horizon {N} not divisible by {D} shards")
    return _solve_shard(A, B, d, Qx, qx, Ru, ru, x0, mesh, axis)


@highest_precision
def lqr_solve_sharded_batch(A: Tensor, B: Tensor, d: Tensor, Qx: Tensor,
                            qx: Tensor, Ru: Tensor, ru: Tensor, x0: Tensor,
                            mesh: Optional[DeviceMesh] = None,
                            batch_axis: str = BATCH_AXIS,
                            axis: str = SEQ_AXIS) -> Tuple[DTensor, DTensor]:
    """Batch x seq LQR: scenarios split over ``batch_axis``, each
    scenario's horizon over ``axis``, on one 2-D mesh.

    Inputs carry a leading batch dimension (``A [Bn, N, x, x]``, ``x0 [Bn,
    x]``, ...), whole on every rank; the shard-total all-gathers run over
    ``axis`` only, and scenarios never communicate.  ``Bn`` must divide by
    the batch-axis size and ``N`` by the seq-axis size.  Returns ``X [Bn,
    N + 1, x]`` and ``U [Bn, N, u]`` as DTensors, lanes split over
    ``batch_axis``; over ``axis``, ``U`` is split and ``X`` whole, as
    :func:`lqr_solve_sharded` returns them.  The default mesh is every
    process reshaped to ``(2, -1)``.
    """
    if mesh is None:
        mesh = make_mesh(shape=(2, -1), axis_names=(batch_axis, axis))
    D = coll.axis_size(mesh, axis)
    Bn, N = A.shape[0], A.shape[1]
    if N % D:
        raise ValueError(f"horizon {N} not divisible by {D} shards")
    n_batch = coll.axis_size(mesh, batch_axis)
    if Bn % n_batch:
        raise ValueError(f"batch {Bn} not divisible by {n_batch} batch "
                         f"shards")
    lanes = lambda t: coll.local_rows(t, mesh, batch_axis)
    return _solve_shard(*(lanes(t) for t in (A, B, d, Qx, qx, Ru, ru, x0)),
                        mesh, axis, batch_axis)
