"""Control plans: precompiled receding-horizon MPC with x0-affine updates.

Port of ``copra_tpu/plan.py``.  For a fixed model every QP ingredient
except the initial state is constant, and every linear term is affine in
x0, so a plan holds ``Q``, the rows, the bounds and the affine maps; a
serving tick only applies the maps and runs a fixed number of ADMM
iterations.

Ported here: :class:`ControlPlan`, :func:`make_control_plan`,
:func:`plan_qp`, :func:`plan_trajectory`, the host-f64 :class:`SeedMap`,
:func:`auto_rho`, :func:`suggest_rho` and the accurate serving tick of
:func:`make_plan_step`.  The f32 fast step, the unbatched step, the
general-row step and ``make_plan_multistep`` are not ported yet (ROADMAP
queue 1, items 4 and 5).

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
from typing import Sequence

import numpy as np
import torch

from ._precision import highest_precision
from ._tensors import as_tensor, common
from .constraints import Constraint
from .costs import CostFunction
from .mpc import build_qp
from .ops.admm_kernel import fused_admm_box_lanes
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


def _jacobi_inverse(Mat: Tensor) -> Tensor:
    """Symmetric-Jacobi-preconditioned explicit inverse (batched)."""
    S = 1.0 / torch.sqrt(torch.diagonal(Mat, dim1=-2, dim2=-1))
    Ms = Mat * S[..., :, None] * S[..., None, :]
    Ls = torch.linalg.cholesky(Ms)
    eye = torch.eye(Mat.shape[-1], dtype=Mat.dtype, device=Mat.device)
    Lsi = torch.linalg.solve_triangular(Ls, eye.expand_as(Ls), upper=False)
    return (Lsi.transpose(-1, -2) @ Lsi) * S[..., :, None] * S[..., None, :]


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
    the plan's dtype."""
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


def auto_rho(plan: ControlPlan,
             x0s,
             options: SolverOptions,
             seed_center=None,
             accurate: bool = False,
             accurate_rounds: int = 1,
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
    draws and candidates as the reference.
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
                              accurate_rounds=accurate_rounds)
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


def _make_accurate_step(plan: ControlPlan, options: SolverOptions,
                        seed_center, rounds: int = 2):
    """f64-exact batched box-only serving tick (see :func:`make_plan_step`).

    Per tick: the f64 seed map, ``rounds`` f32 correction-space ADMM runs
    through :func:`fused_admm_box_lanes` (the CUDA kernel on a GPU), an f64
    combine with exact bound snapping, and a status from the KKT residual
    of the delivered solution, whose ``Q s`` term comes from the kernel's
    ``n_iter = 0`` pass.  One route serves every operator shape: per-lane
    ``[B, n, n]`` operators of any n the kernel's shared memory holds, and
    shared ``[n, n]`` operators on the CPU.
    """
    f32, f64 = torch.float32, torch.float64
    opts = options.replace(early_exit=False)
    Kinv_pre, K_pre = _box_fast_state(plan, opts)
    Kinv_pre = Kinv_pre.to(f32).contiguous()
    K_pre = K_pre.to(f32).contiguous()
    seed_map = make_seed_map(plan, center=seed_center, keep_f64=True)
    refine = max(opts.kkt_refine, 0)
    assume_x0_zero = opts.kkt_refine <= 0
    admm = dict(sigma=opts.sigma, alpha=opts.alpha, rho=opts.rho)

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
            e, y, ze, gq = fused_admm_box_lanes(
                Kinv, Kf, r32, lb_e, ub_e, czero, wy, wz,
                n_iter=opts.max_iter, refine=refine,
                assume_x0_zero=assume_x0_zero, **admm)
            wy = y
            base64 = base64 + e.to(f64)
            if rnd < rounds - 1:
                # gradient at the composite iterate: Q (x - xs), exactly,
                # because Q xs + c = 0 by seed construction
                dx64 = base64 - xs64
                Q64 = plan_b.Q.to(f64)
                if Q64.dim() == 3:
                    r64 = (Q64 @ dx64.unsqueeze(-1)).squeeze(-1)
                else:
                    r64 = dx64 @ Q64          # Q symmetric
                r32 = r64.to(f32)
        # f64 combine; snap active coordinates to their exact bounds
        thr = 1e-6 * torch.clamp(y.abs().amax(-1, keepdim=True), min=1.0)
        at_up = y > thr
        at_lo = y < -thr
        x64 = torch.where(at_up, ub64, torch.where(at_lo, lb64, base64))
        x64 = torch.clamp(x64, lb64, ub64)
        x32 = x64.to(f32)
        # status from the KKT residual of the DELIVERED x64: grad = Q(x64 -
        # xs) = r + gq + Q s, with gq = Q e from the kernel and s the snap
        # delta; Q s from the kernel's n_iter = 0 pass
        s32 = (x64 - base64).to(f32)
        gqs = fused_admm_box_lanes(
            Kinv, Kf, czero, lb_e, ub_e, s32, czero, czero, n_iter=0,
            refine=0, **admm)[3]
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
        r_prim = (e - ze).abs().amax(-1)   # diagnostic only
        eps_floor = 25.0 * float(torch.finfo(f32).eps)
        eps = max(opts.eps_abs, eps_floor)
        eps_rel = max(opts.eps_rel, eps_floor)
        d_scale = torch.maximum(grad.abs().amax(-1), y.abs().amax(-1))
        conv = r_dual <= eps + eps_rel * d_scale
        sol = QPSolution(
            x=x64, y=y, z=x32,
            status=torch.where(conv, 0, 1).to(torch.int32),
            iterations=torch.full((bsz,), rounds * opts.max_iter,
                                  dtype=torch.int32, device=dev),
            primal_residual=r_prim,
            dual_residual=r_dual)
        return x64, sol, WarmStart(x=x32, y=y, z=x32)

    def step(plan_b, x0_b, warm_b):
        return acc_step(plan_b, Kinv_pre, K_pre, seed_map, x0_b, warm_b)

    step.state = (Kinv_pre, K_pre, seed_map)
    return step


def make_plan_step(plan: ControlPlan,
                   options: SolverOptions = SolverOptions(),
                   batched: bool = False,
                   seed_center=None,
                   accurate: bool = False,
                   accurate_rounds: int = 2):
    """Build ``step(plan, x0, warm) -> (U, solution, next_warm)``.

    ``accurate`` (batched box-only plans): the f64-exact serving tick.  It
    returns ``U`` in float64, matching the exact solution of the plan's QP
    to ~1e-9 on unsaturated lanes: the seed map is applied in f64, the f32
    kernel computes only the bound-activation correction, and active
    coordinates are snapped to their exact bounds in f64.

    The other steps of the reference (the f32 fused and unbatched steps,
    the general-row step) are not ported yet and raise
    ``NotImplementedError``.
    """
    box_only = plan.Aeq.shape[-2] == 0 and plan.Aineq.shape[-2] == 0
    if accurate:
        if not (batched and box_only):
            raise ValueError("accurate=True requires a batched box-only "
                             "plan (general rows: use the stagewise or "
                             "full-solver paths).")
        return _make_accurate_step(plan, options, seed_center,
                                   rounds=max(int(accurate_rounds), 1))
    if not box_only:
        raise NotImplementedError(
            "plan steps with general rows are not ported yet (ROADMAP "
            "queue 1, item 4: qp/admm and the general plan path)")
    raise NotImplementedError(
        "the f32 plan steps (fused_step, single) are not ported yet "
        "(ROADMAP queue 1, item 5); use accurate=True")
