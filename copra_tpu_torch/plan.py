"""Control plans: precompiled receding-horizon MPC with x0-affine updates.

Port of ``copra_tpu/plan.py``.  For a fixed model every QP ingredient
except the initial state is constant, and every linear term is affine in
x0, so a plan holds ``Q``, the rows, the bounds and the affine maps; a
serving tick only applies the maps and runs a fixed number of ADMM
iterations.

Ported here: :class:`ControlPlan`, :func:`make_control_plan`,
:func:`plan_qp`, :func:`plan_trajectory`, the host-f64 :class:`SeedMap`,
:func:`auto_rho`, :func:`suggest_rho` and every step of
:func:`make_plan_step`: the accurate tick (per-lane and shared operators),
the f32 fused tick, the box-only and general-row steps (batched and
unbatched) and the general tick through the shared general kernel, with the
general path's ``polish`` through ``qp/admm``'s ``_polish``, and
:func:`make_plan_multistep`, which serves T accurate ticks per call, on a
CUDA plan as one CUDA graph.

Where the reference vmaps over a fleet, the port takes a batch dimension:
``make_control_plan`` of an :class:`LTVSystem` whose ``A`` is
``[B, N, x, x]`` gives a plan whose every field has a leading ``B``.

Dropped with the TPU (each was a workaround for it):

* ``_commit_default_layout``: XLA operand relayouts; PyTorch keeps the
  ``[B, n, n]`` operators contiguous as built.
* ``warn_if_emulated_f64`` and the ``jax_enable_x64`` check: the H100 has
  hardware FP64, so the seed map, the combine and the bound snapping run
  as plain f64 tensors on the device.
* the per-lane f64 seed decomposition: one f64 batched product.
* the hi/lo f32 split of the refinement-round gradient GEMM: one f64
  product.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import profiling
from ._graph import CapturedChain, tree_map
from ._precision import highest_precision
from ._tensors import as_tensor, common, matvec, matvec_t
from .constraints import Constraint
from .costs import CostFunction
from .mpc import build_qp
from .ops.admm_kernel import (admm_box_plain, fused_admm_box,
                               fused_admm_box_lanes, fused_admm_box_shared,
                               fused_admm_general_shared)
from .ops._derivative import refuse_gradient
from .qp.admm import _auto_refine, _jacobi_inverse, _polish, _tolerances
from .qp.native import solve_qp_native
from .qp.types import DenseQP, QPSolution, SolverOptions, WarmStart
from .systems import System, condense

Tensor = torch.Tensor

# rank of each ControlPlan field without a batch dimension
_BASE_RANK = dict(Q=2, c0=1, Cmap=2, Aeq=2, beq0=1, Beqmap=2, Aineq=2,
                  bineq0=1, Bineqmap=2, lb=1, ub=1, Phi=2, Psi=2, xi=1)


@dataclasses.dataclass(frozen=True)
class ControlPlan:
    """All x0-independent QP data plus the affine maps for the linear terms
    (``Phi``/``Psi``/``xi`` kept for trajectory reconstruction)."""

    Q: Tensor          # [n, n]
    c0: Tensor         # [n]
    Cmap: Tensor       # [x, n]: c(x0) = c0 + x0 @ Cmap
    Aeq: Tensor        # [me, n]
    beq0: Tensor       # [me]
    Beqmap: Tensor     # [x, me]
    Aineq: Tensor      # [mi, n]
    bineq0: Tensor     # [mi]
    Bineqmap: Tensor   # [x, mi]
    lb: Tensor         # [n]
    ub: Tensor         # [n]
    Phi: Tensor
    Psi: Tensor
    xi: Tensor
    xdim: int
    udim: int
    horizon: int


def _rowvec(v: Tensor, M: Tensor) -> Tensor:
    """``v @ M`` with batch dims broadcast (``[..., k] x [..., k, m]``)."""
    return (v.unsqueeze(-2) @ M).squeeze(-2)


@profiling.traced("copra.make_control_plan")
@highest_precision
def make_control_plan(system: System,
                      costs: Sequence[CostFunction],
                      constraints: Sequence[Constraint]) -> ControlPlan:
    """Extract the plan by exact affine probing of the QP build: the build
    is evaluated at ``x0 = 0`` and at the ``x`` unit vectors (one batched
    build), and the linear terms' affine maps follow.  A batched system
    gives a plan with a leading batch dimension on every field."""
    preview = condense(system)
    x = preview.xdim
    batch = preview.batch_shape
    kw = dict(dtype=preview.Phi.dtype, device=preview.Phi.device)
    probes = torch.cat([torch.zeros(1, x, **kw), torch.eye(x, **kw)])
    probes = probes.reshape(x + 1, *([1] * len(batch)), x)
    qp = build_qp(preview, probes, tuple(costs), tuple(constraints))

    def affine(v: Tensor):
        v = v.expand(x + 1, *batch, v.shape[-1])
        return v[0].contiguous(), (v[1:] - v[:1]).movedim(0, -2).contiguous()

    def full(t: Tensor, rank: int) -> Tensor:
        return t.expand(*batch, *t.shape[t.dim() - rank:]).contiguous()

    c0, Cmap = affine(qp.c)
    beq0, Beqmap = affine(qp.beq)
    bineq0, Bineqmap = affine(qp.bineq)
    return ControlPlan(
        Q=full(qp.Q, 2), c0=c0, Cmap=Cmap,
        Aeq=full(qp.Aeq, 2), beq0=beq0, Beqmap=Beqmap,
        Aineq=full(qp.Aineq, 2), bineq0=bineq0, Bineqmap=Bineqmap,
        lb=full(qp.lb, 1), ub=full(qp.ub, 1),
        Phi=preview.Phi, Psi=preview.Psi, xi=preview.xi,
        xdim=x, udim=preview.udim, horizon=preview.horizon)


def plan_qp(plan: ControlPlan, x0) -> DenseQP:
    """Instantiate the QP for one initial state (or one per lane)."""
    dev = plan.Q.device
    x0 = as_tensor(x0, dev)

    def lin(b0, bmap):
        b0, bmap, x0_ = common(b0, bmap, x0, device=dev)
        return b0 + _rowvec(x0_, bmap)

    return DenseQP(
        Q=plan.Q, c=lin(plan.c0, plan.Cmap),
        Aeq=plan.Aeq, beq=lin(plan.beq0, plan.Beqmap),
        Aineq=plan.Aineq, bineq=lin(plan.bineq0, plan.Bineqmap),
        lb=plan.lb, ub=plan.ub)


def plan_trajectory(plan: ControlPlan, x0, U) -> Tensor:
    """``X = Phi x0 + Psi U + xi``."""
    Phi, Psi, xi, x0, U = common(plan.Phi, plan.Psi, plan.xi,
                                 as_tensor(x0), as_tensor(U),
                                 device=plan.Phi.device)
    return ((Phi @ x0.unsqueeze(-1)).squeeze(-1)
            + (Psi @ U.unsqueeze(-1)).squeeze(-1) + xi)


@highest_precision
def _box_fast_state(plan: ControlPlan, options: SolverOptions):
    """KKT operator ``K = Q + (sigma+rho) I`` and its inverse for box-only
    steps (per lane for batched plans)."""
    n = plan.Q.shape[-1]
    K = plan.Q + (options.sigma + options.rho) * torch.eye(
        n, dtype=plan.Q.dtype, device=plan.Q.device)
    return _jacobi_inverse(K), K


@dataclasses.dataclass(frozen=True)
class SeedMap:
    """x0-affine map to the unconstrained minimum: ``u(x0) = u0 + (x0 -
    x0c) @ Umap``.  Computed on the host in f64 (:func:`make_seed_map`):
    the raw MPC Hessian is ~1e8-conditioned, so an f32 solve of it is
    meaningless while the f64 result is a good warm start."""

    u0: Tensor     # [n] (or [B, n])
    Umap: Tensor   # [x, n] (or [B, x, n])
    x0c: Tensor    # [x] (or [B, x])

    def seed(self, x0: Tensor) -> Tensor:
        """``u(x0) = u0 + (x0 - x0c) @ Umap``."""
        return self.u0 + _rowvec(x0 - self.x0c, self.Umap)


def make_seed_map(plan: ControlPlan, center=None,
                  keep_f64: bool = False) -> SeedMap:
    """Host-side f64 construction of the unconstrained-seed affine map
    (the reference's numpy code, unchanged).  ``center``: state(s) to
    expand around (default 0).  ``keep_f64``: keep the map in f64 on the
    plan's device (the accurate step applies it in f64); otherwise it takes
    the plan's dtype.

    The map is built in numpy, so it has no derivative in the plan's
    ``Q``, ``c0`` and ``Cmap``: a gradient asked of them raises (a
    gradient in ``x0`` flows through the map's application)."""
    refuse_gradient("make_seed_map (the seed map is built on the host in "
                    "numpy)", "solve_mpc or solve_qp (the condensed solve, "
                    "differentiable in the problem's data)", plan.Q,
                    plan.c0, plan.Cmap)
    Q = plan.Q.detach().cpu().numpy().astype(np.float64)
    c0 = plan.c0.detach().cpu().numpy().astype(np.float64)
    Cmap = plan.Cmap.detach().cpu().numpy().astype(np.float64)
    u0 = -np.linalg.solve(Q, c0[..., None])[..., 0]
    Umap = -np.swapaxes(np.linalg.solve(Q, np.swapaxes(Cmap, -1, -2)),
                        -1, -2)
    x = Cmap.shape[-2]
    if center is None:
        x0c = np.zeros(u0.shape[:-1] + (x,))
    else:
        center = np.asarray(center, np.float64)
        if center.ndim > len(u0.shape[:-1]) + 1:
            raise ValueError(
                f"seed center has shape {center.shape} but the plan is "
                f"unbatched (Q {Q.shape}) — a shared plan takes one shared "
                f"center (shape ({x},)); per-lane centers need a batched "
                f"plan.")
        x0c = np.broadcast_to(center, u0.shape[:-1] + (x,))
        u0 = u0 + np.einsum("...x,...xn->...n", x0c, Umap)
    dt = torch.float64 if keep_f64 else plan.Q.dtype
    dev = plan.Q.device
    return SeedMap(u0=torch.tensor(u0, dtype=dt, device=dev),
                   Umap=torch.tensor(Umap, dtype=dt, device=dev),
                   x0c=torch.tensor(np.array(x0c), dtype=dt, device=dev))


def _spectral_gm(plan: ControlPlan, sample_lanes: int = 4):
    """Host-f64 ``(sqrt(lmin*lmax), lmin, lmax)`` of the plan Hessian (a few
    lanes sampled for batched plans)."""
    Q = plan.Q
    if Q.dim() == 3:
        idx = np.unique(np.linspace(0, Q.shape[0] - 1,
                                    min(sample_lanes, Q.shape[0])
                                    ).astype(int))
        ev = np.linalg.eigvalsh(
            Q[torch.as_tensor(idx, device=Q.device)].cpu().numpy()
            .astype(np.float64))
        lmin = max(float(ev[:, 0].min()), 1e-12)
        lmax = float(ev[:, -1].max())
    else:
        ev = np.linalg.eigvalsh(Q.cpu().numpy().astype(np.float64))
        lmin = max(float(ev[0]), 1e-12)
        lmax = float(ev[-1])
    return float(np.sqrt(lmin * lmax)), lmin, lmax


def _slice_plan(plan: ControlPlan, idx) -> ControlPlan:
    """Select lanes ``idx`` (an int or an index array) from every batched
    field; shared fields pass through."""
    kw = {}
    for name, rank in _BASE_RANK.items():
        leaf = getattr(plan, name)
        if leaf.dim() > rank:
            sel = idx if isinstance(idx, int) else torch.as_tensor(
                np.asarray(idx), device=leaf.device)
            leaf = leaf[sel]
        kw[name] = leaf
    return dataclasses.replace(plan, **kw)


@profiling.traced("copra.auto_rho")
def auto_rho(plan: ControlPlan,
             x0s,
             options: SolverOptions,
             seed_center=None,
             accurate: bool = False,
             accurate_rounds: int = 1,
             use_fused=None,
             probe_lanes: int = 8,
             probe_steps: int = 3,
             candidates=(0.01, 0.1, 0.33, 1.0, 3.3),
             drift_scale: float = 0.02,
             return_probe: bool = False):
    """Measured static ADMM penalty for fixed-count serving.

    Builds the real serving step at gm-relative candidates (gm = geometric
    mean of the Hessian's extreme eigenvalues) over a few sampled lanes,
    runs the cold+warm tick pattern, gates each against the exact f64
    native oracle of the same QPs and returns the winner (with
    ``return_probe``, also the ``{multiple: error}`` map).  Same policy,
    draws and candidates as the reference.  ``seed_center``, ``accurate``,
    ``accurate_rounds`` and ``use_fused`` mirror the :func:`make_plan_step`
    call the caller will build, so the probe runs the same step.
    """
    x0s = np.asarray(x0s, np.float64)
    B = x0s.shape[0]
    idx = np.unique(np.linspace(0, B - 1, min(probe_lanes, B)).astype(int))
    q_batched = plan.Q.dim() == 3
    plan_p = _slice_plan(plan, idx) if q_batched else plan
    x0_p = x0s[idx]
    center = seed_center
    if center is not None:
        center = np.asarray(center, np.float64)
        if center.ndim == 2:
            center = center[idx]
    gm, _, _ = _spectral_gm(plan)

    rng = np.random.default_rng(0)
    drift = rng.normal(scale=drift_scale,
                       size=(probe_steps + 1, len(idx), x0_p.shape[-1])
                       ).cumsum(0)
    dev = plan.Q.device
    x0_seq = [torch.tensor((x0_p + drift[t]).astype(np.float32), device=dev)
              for t in range(probe_steps + 1)]

    # exact f64 oracle at the last probe state, once per lane
    exact = []
    for k, lane in enumerate(idx):
        pl = _slice_plan(plan, int(lane)) if q_batched else plan
        qp = plan_qp(pl, np.asarray(x0_p[k] + drift[-1][k], np.float64))
        exact.append(solve_qp_native(qp).x.numpy())

    probe = {}
    for mult in candidates:
        rho = gm * mult
        step = make_plan_step(plan_p, options.replace(rho=rho),
                              batched=True, seed_center=center,
                              accurate=accurate,
                              accurate_rounds=accurate_rounds,
                              use_fused=use_fused)
        warm = None
        u = None
        for t in range(probe_steps + 1):
            u, _, warm = step(plan_p, x0_seq[t], warm)
        u = u.detach().cpu().numpy().astype(np.float64)
        probe[mult] = max(float(np.abs(u[k] - exact[k]).max())
                          for k in range(len(idx)))
    best = min(probe, key=probe.get)
    rho = float(gm * best)
    if return_probe:
        return rho, probe
    return rho


def suggest_rho(plan: ControlPlan, sample_lanes: int = 4) -> float:
    """Spectrum-aware static ADMM penalty ``0.1 * sqrt(lmin * lmax)``;
    :func:`auto_rho` is the robust choice for fixed-count serving."""
    gm, _, _ = _spectral_gm(plan, sample_lanes)
    return 0.1 * gm


def _amax(t: Tensor) -> Tensor:
    return t.abs().amax(-1)


def _status(conv: Tensor) -> Tensor:
    return torch.where(conv, 0, 1).to(torch.int32)


def _iterations(shape, count: int, device) -> Tensor:
    return torch.full(tuple(shape), count, dtype=torch.int32, device=device)


def _qv(Q: Tensor, v: Tensor) -> Tensor:
    """``Q v`` per lane for batched ``Q [B, n, n]``; ``v @ Q`` (Q
    symmetric) for a shared ``Q [n, n]``, as the reference forms each."""
    return matvec(Q, v) if Q.dim() == 3 else v @ Q


def _make_accurate_step(plan: ControlPlan, options: SolverOptions,
                        seed_center, rounds: int = 2,
                        use_fused: bool = True):
    """f64-exact batched box-only serving tick (see :func:`make_plan_step`).

    Per tick: the f64 seed map, ``rounds`` f32 correction-space ADMM runs,
    an f64 combine with exact bound snapping, and a status from the KKT
    residual of the delivered solution.  Per-lane ``[B, n, n]`` operators
    run :func:`fused_admm_box_lanes` (the x0 = 0 body, and its ``n_iter =
    0`` pass for the status's ``Q s``); shared ``[n, n]`` operators run
    :func:`fused_admm_box_shared` from x0 = 0, and ``Q s`` is one product.
    ``use_fused=False`` runs the plain version :func:`admm_box_plain`
    instead, as the reference's ``False`` runs its XLA twin.
    """
    f32, f64 = torch.float32, torch.float64
    opts = options.replace(early_exit=False)
    Kinv_pre, K_pre = _box_fast_state(plan, opts)
    Kinv_pre = Kinv_pre.to(f32).contiguous()
    K_pre = K_pre.to(f32).contiguous()
    seed_map = make_seed_map(plan, center=seed_center, keep_f64=True)
    refine = max(opts.kkt_refine, 0)
    assume_x0_zero = opts.kkt_refine <= 0
    admm = dict(n_iter=opts.max_iter, sigma=opts.sigma, alpha=opts.alpha,
                rho=opts.rho)

    def correction(Kinv, Kf, r32, lb_e, ub_e, czero, wy, wz):
        if not use_fused:
            return admm_box_plain(Kinv, Kf, r32, lb_e, ub_e, czero, wy, wz,
                                  refine=refine, **admm)
        if Kinv.dim() == 3:
            return fused_admm_box_lanes(Kinv, Kf, r32, lb_e, ub_e, czero, wy,
                                        wz, refine=refine,
                                        assume_x0_zero=assume_x0_zero,
                                        **admm)
        return fused_admm_box_shared(Kinv, Kf, r32, lb_e, ub_e, czero, wy,
                                     wz, refine=refine, **admm)

    @highest_precision
    def acc_step(plan_b, Kinv, Kf, seed, x0_b, warm_b):
        n = plan_b.Q.shape[-1]
        dev = plan_b.Q.device
        x0_b = as_tensor(x0_b, dev)
        bsz = x0_b.shape[0]
        xs64 = seed.u0 + _rowvec(x0_b.to(f64) - seed.x0c, seed.Umap)
        lb64 = plan_b.lb.expand(bsz, n).to(f64)
        ub64 = plan_b.ub.expand(bsz, n).to(f64)
        czero = torch.zeros((bsz, n), dtype=f32, device=dev)
        wy = czero if warm_b is None else warm_b.y.to(f32).contiguous()
        # Composite-level iterative refinement: each extra round re-runs
        # the correction ADMM around the current iterate with its f64
        # gradient as the linear term (contracts the saturated-lane f32
        # floor by ~cond(K)*eps_f32 per round).
        base64 = xs64
        r32 = czero
        for rnd in range(rounds):
            lb_e = (lb64 - base64).to(f32)
            ub_e = (ub64 - base64).to(f32)
            wz = torch.clamp(czero, lb_e, ub_e)
            e, y, ze, gq = correction(Kinv, Kf, r32, lb_e, ub_e, czero, wy,
                                      wz)
            wy = y
            base64 = base64 + e.to(f64)
            if rnd < rounds - 1:
                # gradient at the composite iterate: Q (x - xs), exactly,
                # because Q xs + c = 0 by seed construction (one f64
                # product)
                r32 = _qv(plan_b.Q.to(f64), base64 - xs64).to(f32)
        # f64 combine; snap active coordinates to their exact bounds
        thr = 1e-6 * torch.clamp(y.abs().amax(-1, keepdim=True), min=1.0)
        at_up = y > thr
        at_lo = y < -thr
        x64 = torch.where(at_up, ub64, torch.where(at_lo, lb64, base64))
        x64 = torch.clamp(x64, lb64, ub64)
        x32 = x64.to(f32)
        # status from the KKT residual of the DELIVERED x64: grad = Q(x64 -
        # xs) = r + gq + Q s, with gq = Q e from the kernel and s the snap
        # delta
        s32 = (x64 - base64).to(f32)
        if use_fused and Kinv.dim() == 3:
            # the per-lane operators' n_iter = 0 pass
            gqs = fused_admm_box_lanes(
                Kinv, Kf, czero, lb_e, ub_e, s32, czero, czero, n_iter=0,
                refine=0, sigma=opts.sigma, alpha=opts.alpha,
                rho=opts.rho)[3]
        else:
            gqs = _qv(plan_b.Q, s32.to(plan_b.Q.dtype))
        grad = r32 + gq + gqs
        on_up = x64 >= ub64
        on_lo = x64 <= lb64
        # at the upper bound optimality needs grad <= 0, at the lower
        # grad >= 0; lb == ub pins the coordinate (any sign is optimal)
        kkt = torch.where(
            on_up & on_lo, 0.0,
            torch.where(on_up, torch.clamp(grad, min=0.0),
                        torch.where(on_lo, torch.clamp(-grad, min=0.0),
                                    grad.abs())))
        r_dual = kkt.amax(-1)
        r_prim = _amax(e - ze)   # diagnostic only
        eps, eps_rel = _tolerances(opts, f32)
        d_scale = torch.maximum(_amax(grad), _amax(y))
        conv = r_dual <= eps + eps_rel * d_scale
        sol = QPSolution(
            x=x64, y=y, z=x32, status=_status(conv),
            iterations=_iterations((bsz,), rounds * opts.max_iter, dev),
            primal_residual=r_prim, dual_residual=r_dual)
        return x64, sol, WarmStart(x=x32, y=y, z=x32)

    def step(plan_b, x0_b, warm_b):
        return acc_step(plan_b, Kinv_pre, K_pre, seed_map, x0_b, warm_b)

    # the inner tick and its precomputed state, for make_plan_multistep
    step.acc_step = acc_step
    step.state = (Kinv_pre, K_pre, seed_map)
    return step


def _make_fused_step(plan: ControlPlan, options: SolverOptions, seed_center):
    """The f32 fused tick (batched box-only f32 plans): the correction-space
    substitution ``x = x_seed + e`` around the exact unconstrained seed, so
    the correction QP has ``c = 0`` and its fixed point ``e = 0`` is exact
    in f32.  Shared operators run :func:`fused_admm_box_shared`, per-lane
    ones :func:`fused_admm_box`; the status is the kernel's ``g = Q e``
    plus the duals."""
    f32 = torch.float32
    opts = options.replace(early_exit=False)
    Kinv_pre, K_pre = (t.contiguous() for t in _box_fast_state(plan, opts))
    seed_map = make_seed_map(plan, center=seed_center)
    refine = _auto_refine(opts.kkt_refine, f32)
    kernel = fused_admm_box_shared if Kinv_pre.dim() == 2 else fused_admm_box
    eps, eps_rel = _tolerances(opts, f32)

    @highest_precision
    def fused_step(plan_b, x0_b, warm_b):
        n = plan_b.Q.shape[-1]
        dev = plan_b.Q.device
        x0_b = as_tensor(x0_b, dev).to(plan_b.Q.dtype)
        bsz = x0_b.shape[0]
        x_seed = seed_map.seed(x0_b)
        lb = plan_b.lb.expand(bsz, n) - x_seed
        ub = plan_b.ub.expand(bsz, n) - x_seed
        czero = torch.zeros((bsz, n), dtype=f32, device=dev)
        # every tick re-seeds the primal at the exact unconstrained
        # minimum; only the duals persist across ticks
        wz = torch.clamp(czero, lb, ub)
        wy = czero if warm_b is None else warm_b.y.contiguous()
        e, y, ze, gq = kernel(Kinv_pre, K_pre, czero, lb, ub, czero, wy, wz,
                              n_iter=opts.max_iter, sigma=opts.sigma,
                              alpha=opts.alpha, rho=opts.rho, refine=refine)
        x = x_seed + e
        z = x_seed + ze
        r_prim = _amax(e - ze)
        # grad = Q x + c + y = gq + y in correction space
        r_dual = _amax(gq + y)
        d_scale = torch.maximum(_amax(gq), _amax(y))
        conv = ((r_prim <= eps + eps_rel * _amax(x))
                & (r_dual <= eps + eps_rel * d_scale))
        sol = QPSolution(
            x=x, y=y, z=z, status=_status(conv),
            iterations=_iterations((bsz,), opts.max_iter, dev),
            primal_residual=r_prim, dual_residual=r_dual)
        return x, sol, WarmStart(x=x, y=y, z=z)

    fused_step.state = (Kinv_pre, K_pre, seed_map)
    return fused_step


def _make_box_step(plan: ControlPlan, options: SolverOptions, seed_center,
                   batched: bool):
    """The plain box-only step (the reference's ``single``): ``max_iter``
    iterations of the pre-factorized KKT solve from the unconstrained seed,
    in the plan's dtype.  Batched: the lanes form a leading dimension
    (plan fields with or without it); unbatched: one state."""
    opts = options.replace(early_exit=False)
    Kinv, K = _box_fast_state(plan, opts)
    seed_map = make_seed_map(plan, center=seed_center)
    dt = plan.Q.dtype
    refine = _auto_refine(opts.kkt_refine, dt)
    eps, eps_rel = _tolerances(opts, dt)
    sigma, rho, alpha = opts.sigma, opts.rho, opts.alpha

    @highest_precision
    def single(plan_s, x0, warm):
        x0 = as_tensor(x0, plan_s.Q.device).to(dt)
        c = plan_s.c0 + _rowvec(x0, plan_s.Cmap)
        # primal re-seeded at the unconstrained minimum; only the duals
        # persist across ticks
        x = seed_map.seed(x0)
        z = torch.clamp(x, plan_s.lb, plan_s.ub)
        y = torch.zeros_like(x) if warm is None else warm.y
        for _ in range(opts.max_iter):
            rhs = sigma * x - c + rho * z - y
            x_t = matvec(Kinv, rhs)
            for _ in range(refine):
                x_t = x_t + matvec(Kinv, rhs - matvec(K, x_t))
            x_n = alpha * x_t + (1 - alpha) * x
            z_rel = alpha * x_t + (1 - alpha) * z
            z = torch.clamp(z_rel + y / rho, plan_s.lb, plan_s.ub)
            y = y + rho * (z_rel - z)
            x = x_n
        r_prim = _amax(x - z)
        Qx = matvec(plan_s.Q, x)
        r_dual = _amax(Qx + c + y)
        d_scale = torch.maximum(_amax(Qx),
                                torch.maximum(_amax(y), _amax(c)))
        conv = ((r_prim <= eps + eps_rel * _amax(x))
                & (r_dual <= eps + eps_rel * d_scale))
        sol = QPSolution(
            x=x, y=y, z=z, status=_status(conv),
            iterations=_iterations(conv.shape, opts.max_iter, x.device),
            primal_residual=r_prim, dual_residual=r_dual)
        return x, sol, WarmStart(x=x, y=y, z=z)

    if batched:
        return single
    return lambda x0, warm: single(plan, x0, warm)


@highest_precision
def _general_fast_state(plan: ControlPlan, opts: SolverOptions):
    """``C = [Aeq; Aineq; I]`` with its row normalisation ``E``, the row
    penalties ``rho_vec`` (``rho_eq_scale`` on the equality rows), ``K =
    Q + sigma I + C' diag(rho) C`` and its inverse; batched plan fields
    give batched results."""
    Q = plan.Q
    dt, dev, n = Q.dtype, Q.device, Q.shape[-1]
    me, mi = plan.Aeq.shape[-2], plan.Aineq.shape[-2]
    batch = torch.broadcast_shapes(plan.Aeq.shape[:-2], plan.Aineq.shape[:-2])
    eye = torch.eye(n, dtype=dt, device=dev)
    C = torch.cat([plan.Aeq.expand(*batch, me, n),
                   plan.Aineq.expand(*batch, mi, n),
                   eye.expand(*batch, n, n)], dim=-2)
    if opts.row_normalize:
        # exact reparametrization: uniform dual pressure across rows
        rn = torch.sqrt((C * C).sum(-1))
        E = torch.where(rn > 1e-12, 1.0 / rn, 1.0)
    else:
        E = torch.ones(C.shape[:-1], dtype=dt, device=dev)
    C = C * E[..., None]
    rho_vec = torch.cat([
        torch.full((me,), opts.rho * opts.rho_eq_scale, dtype=dt, device=dev),
        torch.full((mi + n,), opts.rho, dtype=dt, device=dev)])
    K = Q + opts.sigma * eye + (C.mT * rho_vec) @ C
    return C, E, rho_vec, K, _jacobi_inverse(K)


def _general_bounds(plan_s: ControlPlan, E: Tensor, x0: Tensor):
    """Row-normalised two-sided bounds ``(l, u)`` of ``C = [Aeq; Aineq;
    I]`` at ``x0`` (inequality rows have ``l = -inf``)."""
    beq = plan_s.beq0 + _rowvec(x0, plan_s.Beqmap)
    bineq = plan_s.bineq0 + _rowvec(x0, plan_s.Bineqmap)
    n, mi = plan_s.lb.shape[-1], bineq.shape[-1]
    batch = torch.broadcast_shapes(beq.shape[:-1], bineq.shape[:-1],
                                   plan_s.lb.shape[:-1], E.shape[:-1])
    beq = beq.expand(*batch, beq.shape[-1])
    bineq = bineq.expand(*batch, mi)
    lb = plan_s.lb.expand(*batch, n)
    ub = plan_s.ub.expand(*batch, n)
    ninf = torch.full((*batch, mi), -torch.inf, dtype=lb.dtype,
                      device=lb.device)
    l = E * torch.cat([beq, ninf, lb], dim=-1)
    u = E * torch.cat([beq, bineq, ub], dim=-1)
    return l, u


def _make_general_step(plan: ControlPlan, options: SolverOptions,
                       seed_center, batched: bool, fused: bool):
    """The general-row step: ``C = [Aeq; Aineq; I]`` and the KKT inverse are
    x0-independent, so they are built once; per tick only the affine bound
    stacks change.  Same correction-space substitution as the box path.
    ``fused`` (batched shared f32 plans): the iterations run in
    :func:`fused_admm_general_shared`; otherwise the plain iteration of the
    reference's ``single``."""
    opts = options.replace(early_exit=False)
    C, E, rho_vec, K, Kinv = (t.contiguous()
                              for t in _general_fast_state(plan, opts))
    seed_map = make_seed_map(plan, center=seed_center)
    dt = plan.Q.dtype
    refine = _auto_refine(opts.kkt_refine, dt)
    eps, eps_rel = _tolerances(opts, dt)
    sigma, alpha = opts.sigma, opts.alpha
    rho_inv = 1.0 / rho_vec

    def iterate(l_e, u_e, e, z, y):
        for _ in range(opts.max_iter):
            rhs = sigma * e + matvec_t(C, rho_vec * z - y)
            e_t = matvec(Kinv, rhs)
            for _ in range(refine):
                e_t = e_t + matvec(Kinv, rhs - matvec(K, e_t))
            z_t = matvec(C, e_t)
            e_n = alpha * e_t + (1 - alpha) * e
            z_rel = alpha * z_t + (1 - alpha) * z
            z = torch.clamp(z_rel + rho_inv * y, l_e, u_e)
            y = y + rho_vec * (z_rel - z)
            e = e_n
        return e, y, z

    def kernel(l_e, u_e, e, z, y):
        return fused_admm_general_shared(
            Kinv, K, C, rho_vec, l_e, u_e, e, y.contiguous(), z,
            n_iter=opts.max_iter, sigma=sigma, alpha=alpha, refine=refine)

    run = kernel if fused else iterate

    @highest_precision
    def single(plan_s, x0, warm):
        x0 = as_tensor(x0, plan_s.Q.device).to(dt)
        l, u = _general_bounds(plan_s, E, x0)
        # correction space around the unconstrained seed
        x_seed = seed_map.seed(x0)
        Cxs = matvec(C, x_seed)
        l_e = l - Cxs
        u_e = u - Cxs
        e0 = torch.zeros_like(x_seed)
        z0 = torch.clamp(torch.zeros_like(l_e), l_e, u_e)
        # external warm duals are in the original row metric
        y0 = torch.zeros_like(l_e) if warm is None else warm.y / E
        e, y, z = run(l_e, u_e, e0, z0, y0)
        x = x_seed + e
        c_tick = plan_s.c0 + _rowvec(x0, plan_s.Cmap)
        if opts.polish:
            # active-set KKT polish (same machinery as the full solver)
            # recovers exactness once ADMM has identified the active set
            me, mi = plan_s.Aeq.shape[-2], plan_s.Aineq.shape[-2]
            qp_t = DenseQP(Q=plan_s.Q, c=c_tick, Aeq=plan_s.Aeq,
                           beq=l[..., :me], Aineq=plan_s.Aineq,
                           bineq=u[..., me:me + mi], lb=plan_s.lb,
                           ub=plan_s.ub)
            x, y = _polish(qp_t, C, l, u, x, y, Cxs + z, opts)
            e = x - x_seed
            z = torch.clamp(matvec(C, e), l_e, u_e)
        Ce = matvec(C, e)
        r_prim = _amax(Ce - z)
        Qx = matvec(plan_s.Q, x)
        CTy = matvec_t(C, y)
        r_dual = _amax(Qx + c_tick + CTy)
        d_scale = torch.maximum(_amax(Qx),
                                torch.maximum(_amax(CTy), _amax(c_tick)))
        conv = ((r_prim <= eps + eps_rel * _amax(Cxs + Ce))
                & (r_dual <= eps + eps_rel * d_scale))
        y_orig = E * y                 # back to the original metric
        sol = QPSolution(
            x=x, y=y_orig, z=Cxs + z, status=_status(conv),
            iterations=_iterations(conv.shape, opts.max_iter, x.device),
            primal_residual=r_prim, dual_residual=r_dual)
        return x, sol, WarmStart(x=x, y=y_orig, z=Cxs + z)

    single.state = (C, E, rho_vec, K, Kinv, seed_map)
    if batched:
        return single
    return lambda x0, warm: single(plan, x0, warm)


def make_plan_step(plan: ControlPlan,
                   options: SolverOptions = SolverOptions(),
                   batched: bool = False,
                   use_fused: Optional[bool] = None,
                   seed_center=None,
                   accurate: bool = False,
                   accurate_rounds: int = 2):
    """Build the serving step: ``step(plan, x0, warm) -> (U, solution,
    next_warm)`` with ``batched=True`` (a leading lane dimension on ``x0``
    and on any plan field), ``step(x0, warm)`` without.

    Box-only plans (no eq/ineq rows) run a fixed count of pre-factorized
    iterations from the unconstrained seed; plans with general rows run the
    general-row step (``C = [Aeq; Aineq; I]`` factorized once).

    ``use_fused`` (batched box-only f32 plans): the f32 fused tick through
    the CUDA kernels, :func:`fused_admm_box_shared` for a shared plan and
    :func:`fused_admm_box` for per-lane plans.  Default: on when the plan
    lies on a CUDA device (the reference's "on for TPU backends").  For a
    batched SHARED general-row f32 plan, ``use_fused=True`` (explicit only,
    as in the reference) runs :func:`fused_admm_general_shared`.

    ``accurate`` (batched box-only plans): the f64-exact serving tick.  It
    returns ``U`` in float64, matching the exact solution of the plan's QP
    to ~1e-9 on unsaturated lanes: the seed map is applied in f64, the f32
    kernel computes only the bound-activation correction, and active
    coordinates are snapped to their exact bounds in f64.  It runs the
    kernels unless ``use_fused=False`` asks for their plain versions.

    ``options.polish`` on the general-row path runs the active-set polish
    of :mod:`copra_tpu_torch.qp.admm` on each tick's iterate.

    The kernels have no derivative: on a CUDA device a gradient asked of a
    tick that launches one raises, naming ``use_fused=False``, whose
    ticks differentiate in ``x0`` (the seed map is built in numpy, so not
    in the plan's data).
    """
    box_only = plan.Aeq.shape[-2] == 0 and plan.Aineq.shape[-2] == 0
    accurate_fused = use_fused is not False
    explicit_fused = use_fused is True
    if use_fused is None:
        use_fused = plan.Q.device.type == "cuda"
    f32_plan = plan.Q.dtype == torch.float32
    use_fused = bool(use_fused and batched and box_only and f32_plan)
    if accurate:
        if not (batched and box_only):
            raise ValueError("accurate=True requires a batched box-only "
                             "plan (general rows: use the stagewise or "
                             "full-solver paths).")
        return _make_accurate_step(plan, options, seed_center,
                                   rounds=max(int(accurate_rounds), 1),
                                   use_fused=accurate_fused)
    if use_fused:
        return _make_fused_step(plan, options, seed_center)
    if box_only:
        return _make_box_step(plan, options, seed_center, batched)
    gen_fused = explicit_fused and batched and plan.Q.dim() == 2 and f32_plan
    return _make_general_step(plan, options, seed_center, batched, gen_fused)


@profiling.traced("copra.make_plan_multistep")
def make_plan_multistep(plan: ControlPlan,
                        options: SolverOptions = SolverOptions(),
                        seed_center=None,
                        accurate: bool = True,
                        accurate_rounds: int = 1,
                        use_fused=None):
    """T accurate ticks per call for a batched box-only plan:
    ``step_many(x0_seq [T, B, x], warm=None) -> (U [T, B, n], statuses [T,
    B], dual_residuals [T, B], warm)``, tick ``t`` solving at
    ``x0_seq[t]`` from the warm state tick ``t - 1`` left; ``warm=None``
    starts from zero duals, as the per-tick step's ``None`` does.

    On a CUDA plan the T ticks are one CUDA graph, captured on the first
    call of each ``(T, B, dtype of x0_seq)`` and replayed after: per-lane
    plans run the x0 = 0 body of :func:`fused_admm_box_lanes` and its Q x
    pass, shared plans :func:`fused_admm_box_shared`, and the host issues
    one graph launch a call instead of every tick's launches.  The
    returned tensors are the call's own (clones of the graph's outputs,
    which the next call overwrites).  On the CPU the ticks run eagerly in
    a loop.
    """
    step = make_plan_step(plan, options, batched=True,
                          seed_center=seed_center, accurate=accurate,
                          accurate_rounds=accurate_rounds,
                          use_fused=use_fused)
    inner = getattr(step, "acc_step", None)
    if inner is None:
        raise ValueError(
            "make_plan_multistep currently supports the batched ACCURATE "
            "path (box-only plans, accurate=True) — use "
            "make_stagewise_multistep for stagewise fleets or the "
            "per-tick step for other plan paths.")
    Kinv_pre, K_pre, seed_map = step.state
    dev = plan.Q.device
    chains = {}

    def ticks(x0_seq: Tensor, wy: Tensor):
        # the accurate tick reads only the duals of its warm state
        w = WarmStart(x=wy, y=wy, z=wy)
        us, statuses, rds = [], [], []
        for t in range(x0_seq.shape[0]):
            u, sol, w = inner(plan, Kinv_pre, K_pre, seed_map, x0_seq[t], w)
            us.append(u)
            statuses.append(sol.status)
            rds.append(sol.dual_residual)
        return (torch.stack(us), torch.stack(statuses), torch.stack(rds),
                w)

    @profiling.traced("copra.plan_multistep")
    def step_many(x0_seq, warm: Optional[WarmStart] = None):
        x0_seq = as_tensor(x0_seq, dev)
        if x0_seq.dim() != 3 or x0_seq.shape[0] < 1:
            raise ValueError(f"x0_seq must be [T, B, x] with T >= 1, got "
                             f"{tuple(x0_seq.shape)}")
        bsz, n = x0_seq.shape[1], plan.Q.shape[-1]
        wy = (torch.zeros((bsz, n), dtype=torch.float32, device=dev)
              if warm is None else warm.y.to(device=dev,
                                              dtype=torch.float32))
        if dev.type != "cuda":
            return ticks(x0_seq, wy)
        key = (tuple(x0_seq.shape), x0_seq.dtype)
        chain = chains.get(key)
        if chain is None:
            chain = chains[key] = CapturedChain(
                ticks, (x0_seq, wy), "make_plan_multistep",
                "make_plan_step(..., accurate=True, use_fused=False) tick "
                "by tick")
        out = chain(x0_seq, wy)
        with profiling.trace_span("copra.chain.copy_out"):
            return tree_map(torch.clone, out)

    step_many.chains = chains
    return step_many
