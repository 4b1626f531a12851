"""Batched on-device dense QP solver (OSQP-style ADMM + active-set polish).

Port of ``copra_tpu/qp/admm.py``:

* the QP is lowered once to the two-sided form ``l <= C x <= u`` with
  ``C = [Aeq; Aineq; I]``;
* the KKT matrix ``Q + sigma*I + C^T diag(rho) C`` is Cholesky-factorized
  once and reused across iterations;
* iterations run with residual-based early exit (with or without adaptive
  rho), or a fixed count for uniform progress across lanes;
* an optional active-set KKT polish with iterative refinement recovers
  active-set-solver accuracy, so first-order ADMM still meets the 1e-5
  golden tolerances.

Where the reference is one unbatched routine that ``jax.vmap`` maps over
lanes, the port writes the batch dimension out: every leaf may carry
leading batch dimensions, which broadcast; :func:`solve_qp` of unbatched
leaves is the one-lane call of the same routine.  ``vmap`` of a
``while_loop`` runs until every lane is done and freezes finished lanes by
select; here each loop carries a per-lane ``done`` mask and the host reads
it once per chunk or check, never per iteration.  The factorizations and
triangular solves are library calls (``torch.linalg``), as they are XLA's
in the reference.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .._precision import highest_precision
from .._tensors import matvec, matvec_t
from .types import (STATUS_DUAL_INFEASIBLE, STATUS_MAX_ITER,
                    STATUS_PRIMAL_INFEASIBLE, STATUS_SOLVED, DenseQP,
                    QPSolution, SolverOptions, WarmStart)

Tensor = torch.Tensor

# rank of each DenseQP leaf without a batch dimension
_BASE_NDIM = dict(Q=2, c=1, Aeq=2, beq=1, Aineq=2, bineq=1, lb=1, ub=1)


def _qp_batch(qp: DenseQP) -> torch.Size:
    """The broadcast of every leaf's leading batch dimensions."""
    return torch.broadcast_shapes(*(
        getattr(qp, f).shape[:getattr(qp, f).dim() - nd]
        for f, nd in _BASE_NDIM.items()))


def stack_constraints(qp: DenseQP, options: SolverOptions
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Lower to ``l <= C x <= u`` with per-row ADMM penalties.

    Equality rows get ``l = u = beq`` and a boosted penalty
    (``rho * rho_eq_scale``), the OSQP treatment; inequality rows get
    ``l = -inf``; box rows are the identity block.  Batched leaves give
    ``C [..., m, n]`` and ``l``/``u``/``rho [..., m]``.
    """
    n = qp.nr_vars
    dt, dev = qp.Q.dtype, qp.Q.device
    batch = _qp_batch(qp)
    me, mi = qp.nr_eq, qp.nr_ineq
    eye = torch.eye(n, dtype=dt, device=dev)
    C = torch.cat([qp.Aeq.expand(*batch, me, n),
                   qp.Aineq.expand(*batch, mi, n),
                   eye.expand(*batch, n, n)], dim=-2)
    neg_inf = torch.full((*batch, mi), -torch.inf, dtype=dt, device=dev)
    beq = qp.beq.expand(*batch, me)
    l = torch.cat([beq, neg_inf, qp.lb.expand(*batch, n)], dim=-1)
    u = torch.cat([beq, qp.bineq.expand(*batch, mi),
                   qp.ub.expand(*batch, n)], dim=-1)
    rho = torch.cat([
        torch.full((me,), options.rho * options.rho_eq_scale, dtype=dt,
                   device=dev),
        torch.full((mi + n,), options.rho, dtype=dt, device=dev),
    ]).expand(*batch, me + mi + n)
    return C, l, u, rho


def _inf_norm(v: Tensor) -> Tensor:
    """``max |v|`` over the last dimension; 0 for an empty one."""
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    return v.abs().amax(-1)


def _guard(norm: Tensor) -> Tensor:
    return torch.where(norm > 1e-12, norm, 1.0)


def ruiz_equilibrate(Q: Tensor, c: Tensor, C: Tensor, iters: int
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                Tensor]:
    """OSQP-style Ruiz equilibration of the stacked KKT data.

    Returns ``(Qs, cs, Cs, D, E, cost_scale)`` with ``Qs = cost*D Q D``,
    ``cs = cost*D c``, ``Cs = E C D``.  Scaling is what makes the f32
    explicit-inverse KKT path viable: raw MPC Hessians mix 1e-6 ridge terms
    with 1e4 cost weights, far beyond f32 inversion accuracy.  Zero
    rows/columns (masked constraint rows) keep scale 1.  Leading batch
    dimensions of the three inputs must agree.
    """
    dt, dev = Q.dtype, Q.device
    n, m = Q.shape[-1], C.shape[-2]
    batch = Q.shape[:-2]
    D = torch.ones((*batch, n), dtype=dt, device=dev)
    E = torch.ones((*batch, m), dtype=dt, device=dev)
    cost = torch.ones(batch, dtype=dt, device=dev)
    for _ in range(iters):
        col_norm = Q.abs().amax(-2)
        if m:
            col_norm = torch.maximum(col_norm, C.abs().amax(-2))
        d = 1.0 / torch.sqrt(_guard(col_norm))
        e = 1.0 / torch.sqrt(_guard(_inf_norm(C)))
        Q = Q * d[..., :, None] * d[..., None, :]
        c = c * d
        if m:
            C = C * e[..., :, None] * d[..., None, :]
        D = D * d
        E = E * e
        # cost normalization (OSQP's gamma step)
        g = 1.0 / _guard(torch.maximum(Q.abs().amax(-2).mean(-1),
                                       _inf_norm(c)))
        Q = Q * g[..., None, None]
        c = c * g[..., None]
        cost = cost * g
    return Q, c, C, D, E, cost


def _cholesky(K: Tensor) -> Tensor:
    """Lower Cholesky factor; NaN (not an error, and no host sync) where
    ``K`` is not positive definite, as ``jnp.linalg.cholesky`` gives."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, torch.nan), L)


def _jacobi_inverse(Mat: Tensor) -> Tensor:
    """Symmetric-Jacobi-preconditioned explicit inverse (batched): the
    preconditioning is mathematically the identity but keeps f32 usable
    when cost weights span 1e-6..1e4."""
    S = 1.0 / torch.sqrt(torch.diagonal(Mat, dim1=-2, dim2=-1))
    Ms = Mat * S[..., :, None] * S[..., None, :]
    Ls = _cholesky(Ms)
    eye = torch.eye(Mat.shape[-1], dtype=Mat.dtype, device=Mat.device)
    Lsi = torch.linalg.solve_triangular(Ls, eye.expand_as(Ls), upper=False)
    return (Lsi.mT @ Lsi) * S[..., :, None] * S[..., None, :]


def _auto_refine(kkt_refine: int, dt: torch.dtype) -> int:
    """``kkt_refine``, or when negative (auto) one refinement step in f32
    and none in f64."""
    if kkt_refine >= 0:
        return kkt_refine
    return 1 if torch.finfo(dt).eps > 1e-10 else 0


def _tolerances(opts: SolverOptions, dt: torch.dtype):
    """OSQP-convention ``(eps_abs, eps_rel)`` with the dtype floor: f32
    cannot meaningfully certify residuals below ~25 machine eps (~3e-6);
    f64 keeps the user's setting."""
    floor = 25.0 * float(torch.finfo(dt).eps)
    return max(opts.eps_abs, floor), max(opts.eps_rel, floor)


def _polish(qp: DenseQP, C: Tensor, l: Tensor, u: Tensor,
            x: Tensor, y: Tensor, z: Tensor,
            options: SolverOptions) -> Tuple[Tensor, Tensor]:
    """Active-set KKT polish with iterative refinement.

    The analog of OSQP's solution polishing: identify the active rows from
    the dual signs, solve the equality-constrained KKT system on them
    (masked to keep shapes static), refine, and accept only if the KKT
    residuals improved.  This recovers the vertex-exact accuracy of an
    active-set solver.  Every argument may carry leading batch dimensions
    (they broadcast); the accept test and the pivots are per lane.
    """
    del z
    n = qp.nr_vars
    m = C.shape[-2]
    dt, dev = qp.Q.dtype, qp.Q.device
    batch = torch.broadcast_shapes(_qp_batch(qp), C.shape[:-2], l.shape[:-1],
                                   u.shape[:-1], x.shape[:-1], y.shape[:-1])
    # dtype-aware regularization: refinement error contracts ~ delta*cond(K)
    # per step, so pick the smallest delta the dtype can represent cleanly
    delta = max(options.polish_delta, 100.0 * float(torch.finfo(dt).eps))
    Q = qp.Q.expand(*batch, n, n)
    c = qp.c.expand(*batch, n)
    l, u = l.expand(*batch, m), u.expand(*batch, m)
    x, y = x.expand(*batch, n), y.expand(*batch, m)

    thr = 1e-6 * torch.clamp(_inf_norm(y), min=1.0)[..., None]
    # equality rows (the leading nr_eq of C, see stack_constraints) are
    # always active regardless of dual magnitude
    row_idx = torch.arange(m, device=dev)
    eq_mask = row_idx < qp.nr_eq
    ineq_mask = ~eq_mask
    act_lo = (y < -thr) | eq_mask
    act_up = y > thr

    eye_n = torch.eye(n, dtype=dt, device=dev)
    eye_m = torch.eye(m, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def attempt(act_lo_c, act_up_c):
        act = act_lo_c | act_up_c
        actf = act.to(dt)
        Ca = (C * actf[..., None]).expand(*batch, m, n)
        b_act = torch.where(act, torch.where(act_up_c, u, l), zero)
        inact_diag = torch.diag_embed(1.0 - actf)
        K_reg = torch.cat([
            torch.cat([Q + delta * eye_n, Ca.mT], dim=-1),
            torch.cat([Ca, -delta * eye_m - inact_diag], dim=-1)], dim=-2)
        K0 = torch.cat([
            torch.cat([Q, Ca.mT], dim=-1),
            torch.cat([Ca, -inact_diag], dim=-1)], dim=-2)
        rhs = torch.cat([-c, b_act], dim=-1)
        lu, piv, _ = torch.linalg.lu_factor_ex(K_reg)
        solve = lambda r: torch.linalg.lu_solve(lu, piv, r[..., None])[..., 0]
        t = solve(rhs)
        for _ in range(options.polish_refine_steps):
            t = t + solve(rhs - matvec(K0, t))
        return t[..., :n], torch.where(act, t[..., n:], zero)

    def _res(xc, yc):
        Cx = matvec(C, xc)
        rp = _inf_norm(Cx - torch.clamp(Cx, l, u))
        rd = _inf_norm(matvec(Q, xc) + c + matvec_t(C, yc))
        return rp + rd

    x_out, y_out = x, y
    best_res = _res(x, y)
    # Iterative single-pivot active-set refinement (a mini dual active-set
    # method on top of the ADMM iterate): the one-shot dual-sign guess can
    # carry a spuriously-active row when the fixed-rho iteration stalls
    # with a primal gap; the KKT solve then pins that row to its bound, the
    # residual check rejects the candidate, and the stall survives
    # polishing.  Each extra round removes the worst wrong-sign active row
    # OR adds the worst violated row: ONE pivot per round, the classic
    # active-set step; updating all rows at once from a far-off candidate
    # diverges.
    for _ in range(max(1, int(options.polish_active_rounds))):
        x_pol, y_pol = attempt(act_lo, act_up)
        res_new = _res(x_pol, y_pol)
        # dual-feasibility guard: a wrong active-set guess can satisfy the
        # KKT equations exactly (polish solves them by construction) while
        # flipping multiplier signs; reject it
        sgn_tol = 1e-6 * torch.clamp(_inf_norm(y_pol), min=1.0)[..., None]
        up_in, lo_in = act_up & ineq_mask, act_lo & ineq_mask
        sign_ok = ((~up_in | (y_pol >= -sgn_tol))
                   & (~lo_in | (y_pol <= sgn_tol))).all(-1)
        finite = torch.isfinite(x_pol).all(-1)
        ok = (res_new < best_res) & sign_ok & finite
        x_out = torch.where(ok[..., None], x_pol, x_out)
        y_out = torch.where(ok[..., None], y_pol, y_out)
        best_res = torch.where(ok, res_new, best_res)
        # pivot scores from the candidate
        z_cand = matvec(C, x_pol)
        wrong = torch.maximum(torch.where(up_in, -y_pol, zero),
                              torch.where(lo_in, y_pol, zero))
        viol_up = torch.clamp(z_cand - u, min=0.0)
        viol_lo = torch.clamp(l - z_cand, min=0.0)
        inactive = ~(act_lo | act_up)
        add_score = torch.where(inactive, torch.maximum(viol_up, viol_lo),
                                zero)
        piv_tol = 1e-9 * torch.clamp(_inf_norm(z_cand), min=1.0)
        wrong_max, add_max = wrong.amax(-1), add_score.amax(-1)
        drop_better = wrong_max >= add_max
        do_pivot = (torch.maximum(wrong_max, add_max) > piv_tol) & finite
        drop_sel = ((row_idx == wrong.argmax(-1, keepdim=True))
                    & (drop_better & do_pivot)[..., None])
        add_sel = ((row_idx == add_score.argmax(-1, keepdim=True))
                   & (~drop_better & do_pivot)[..., None])
        act_up = (act_up & ~drop_sel) | (add_sel & (viol_up > viol_lo))
        act_lo = (((act_lo & ~drop_sel)
                   | (add_sel & (viol_up <= viol_lo))) | eq_mask)
    return x_out, y_out


def _where(mask: Tensor, new, old):
    """Per-lane select over a tuple of carries (``mask [B]``)."""
    return tuple(torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)),
                             a, b) for a, b in zip(new, old))


@highest_precision
def solve_qp(qp: DenseQP, options: SolverOptions = SolverOptions(),
             warm_start: Optional[WarmStart] = None) -> QPSolution:
    """Solve one dense QP, or one per lane when the leaves carry leading
    batch dimensions (unbatched leaves broadcast).  Runs on the device of
    ``qp.Q``; the result's fields carry the batch dimensions."""
    batch = _qp_batch(qp)
    if warm_start is not None:
        batch = torch.broadcast_shapes(batch, warm_start.x.shape[:-1])
    B = 1
    for s in batch:
        B *= s

    def flat(t: Tensor, nd: int) -> Tensor:
        tail = t.shape[t.dim() - nd:]
        return t.expand(*batch, *tail).reshape((B, *tail))

    qp_b = DenseQP(**{f: flat(getattr(qp, f), nd)
                      for f, nd in _BASE_NDIM.items()})
    warm_b = None
    if warm_start is not None:
        warm_b = WarmStart(*(flat(getattr(warm_start, f), 1)
                             for f in ("x", "y", "z")))
    sol = _solve_lanes(qp_b, options, warm_b)
    return QPSolution(**{
        f: getattr(sol, f).reshape((*batch, *getattr(sol, f).shape[1:]))
        for f in ("x", "y", "z", "status", "iterations", "primal_residual",
                  "dual_residual")})


def _solve_lanes(qp: DenseQP, options: SolverOptions,
                 warm_start: Optional[WarmStart]) -> QPSolution:
    """:func:`solve_qp` on leaves that all carry one leading lane dimension
    ``B``."""
    n = qp.nr_vars
    dt, dev = qp.Q.dtype, qp.Q.device
    B = qp.Q.shape[0]
    i32 = torch.int32
    C, l, u, rho = stack_constraints(qp, options)
    m = C.shape[-2]
    sigma, alpha = options.sigma, options.alpha
    eye_n = torch.eye(n, dtype=dt, device=dev)

    # Ruiz equilibration: ADMM runs in the scaled space; results and
    # residuals are reported unscaled.  Essential for f32 numerics.
    box_only = (qp.nr_eq == 0 and qp.nr_ineq == 0)
    if options.scaling > 0 and not box_only:
        Qs, cs, Cs, D, E, cost_s = ruiz_equilibrate(qp.Q, qp.c, C,
                                                    options.scaling)
    else:
        Qs, cs = qp.Q, qp.c
        D = torch.ones((B, n), dtype=dt, device=dev)
        cost_s = torch.ones((B,), dtype=dt, device=dev)
        if options.row_normalize and not box_only:
            # Row-normalize the constraint rows (an exact reparametrization
            # reusing the E-scaling transforms below).  Without it, rows
            # whose norms span orders of magnitude get vanishing dual
            # pressure at uniform rho.
            rn = torch.sqrt((C * C).sum(-1))
            E = torch.where(rn > 1e-12, 1.0 / rn, 1.0)
        else:
            E = torch.ones((B, m), dtype=dt, device=dev)
        Cs = C * E[..., None]
    ls, us = E * l, E * u
    D_inv, E_inv = 1.0 / D, 1.0 / E
    rho_inv = 1.0 / rho
    cost_col = cost_s[:, None]
    cost_inv = 1.0 / cost_col

    # Static specialization: with no eq/ineq rows the unscaled C is the
    # identity, so the scaled C is the diagonal E*D and matvecs stay
    # elementwise.
    if box_only:
        cdiag = E * D
        C_mv = CT_mv = lambda v: cdiag * v
    else:
        C_mv = functools.partial(matvec, Cs)
        CT_mv = functools.partial(matvec_t, Cs)
    Q_mv = functools.partial(matvec, Qs)

    kkt = options.kkt_solve
    if kkt == "auto":
        # an explicit inverse turns every iteration's KKT solve into one
        # matvec on the card; triangular solves are the better numerics on
        # the CPU
        kkt = "chol" if dev.type == "cpu" else "inverse"
    refine = _auto_refine(options.kkt_refine, dt)

    def build_K(rho_vec):
        if box_only:
            return (Qs + sigma * eye_n
                    + torch.diag_embed(rho_vec * cdiag * cdiag))
        return Qs + sigma * eye_n + (Cs.mT * rho_vec[:, None, :]) @ Cs

    def make_kkt_solve(rho_vec):
        """KKT operator for the x-update at the given penalties."""
        K = build_K(rho_vec)
        if kkt == "inverse":
            Kinv = _jacobi_inverse(K)

            def kkt_solve(rhs):
                x = matvec(Kinv, rhs)
                for _ in range(refine):
                    x = x + matvec(Kinv, rhs - matvec(K, x))
                return x
        else:
            L = _cholesky(K)

            def kkt_solve(rhs):
                return torch.cholesky_solve(rhs[..., None], L)[..., 0]
        return kkt_solve

    kkt_solve = make_kkt_solve(rho)

    if warm_start is not None:
        # incoming warm start is in the unscaled space
        x0 = warm_start.x * D_inv
        y0 = warm_start.y * cost_col * E_inv
        z0 = warm_start.z * E
    elif (box_only and (options.seed == "unconstrained"
                        or (options.seed == "auto"
                            and torch.finfo(dt).eps < 1e-10))):
        # Seed from the (clipped) unconstrained minimum: MPC QPs often have
        # few active bounds, and ADMM from this point converges orders of
        # magnitude faster than from zero (instantly when nothing is
        # active).  One extra n x n factorization, amortized immediately.
        Qr = Qs + sigma * eye_n
        Qinv = _jacobi_inverse(Qr)
        x_uc = -matvec(Qinv, cs)
        x_uc = x_uc - matvec(Qinv, matvec(Qr, x_uc) + cs)   # one refinement
        z0 = torch.clamp(C_mv(x_uc), ls, us)
        x0 = x_uc
        y0 = torch.zeros((B, m), dtype=dt, device=dev)
    else:
        x0 = torch.zeros((B, n), dtype=dt, device=dev)
        y0 = torch.zeros((B, m), dtype=dt, device=dev)
        z0 = torch.zeros((B, m), dtype=dt, device=dev)

    eps_abs, eps_rel = _tolerances(options, dt)
    c_norm = _inf_norm(qp.c)

    def one_iter_at(x, z, y, rho_vec, rho_inv_vec, solve_fn):
        rhs = sigma * x - cs + CT_mv(rho_vec * z - y)
        x_t = solve_fn(rhs)
        z_t = C_mv(x_t)
        x_n = alpha * x_t + (1 - alpha) * x
        z_rel = alpha * z_t + (1 - alpha) * z
        z_n = torch.clamp(z_rel + rho_inv_vec * y, ls, us)
        y_n = y + rho_vec * (z_rel - z_n)
        return x_n, z_n, y_n

    def one_iter(x, z, y):
        return one_iter_at(x, z, y, rho, rho_inv, kkt_solve)

    def unscaled_terms(x, z, y):
        """``(C x, z, Q x, C' y)`` in the unscaled space (OSQP convention):
        primal via E^-1, dual via D^-1 / cost_scale."""
        return (E_inv * C_mv(x), E_inv * z, D_inv * Q_mv(x) * cost_inv,
                D_inv * CT_mv(y) * cost_inv)

    def residuals(x, z, y):
        Cx, zu, Qx, CTy = unscaled_terms(x, z, y)
        r_prim = _inf_norm(Cx - zu)
        r_dual = _inf_norm(Qx + D_inv * cs * cost_inv + CTy)
        eps_prim = eps_abs + eps_rel * torch.maximum(_inf_norm(Cx),
                                                     _inf_norm(zu))
        eps_dual = eps_abs + eps_rel * torch.maximum(
            torch.maximum(_inf_norm(Qx), _inf_norm(CTy)), c_norm)
        return r_prim, r_dual, (r_prim <= eps_prim) & (r_dual <= eps_dual)

    zero = torch.zeros((), dtype=dt, device=dev)

    def infeasibility(dx, dy):
        """OSQP-style certificates from the iterate deltas (computed in the
        solve space).  Returns a status code per lane: 0 none, 2
        primal-inf, 3 dual-inf."""
        dy_n = _inf_norm(dy)
        dx_n = _inf_norm(dx)
        # default tolerances chosen from the measured separation between
        # feasible ADMM transients (|C'dy|/|dy| >~ 1e-5, support >~
        # -1e-6|dy|) and true certificates (|C'dy|/|dy| ~ 1e-13, support ~
        # -10|dy|); user-settable via SolverOptions (OSQP convention)
        eps_p = options.eps_prim_inf * torch.clamp(dy_n, min=1e-30)
        sup_p = 1e-3 * torch.clamp(dy_n, min=1e-30)
        eps_d = (options.eps_dual_inf * torch.clamp(dx_n, min=1e-30))[:, None]
        # primal: C^T dy ~ 0 and support function u'dy+ + l'dy- < 0
        support = ((torch.where(dy > 0, us, zero) * dy).sum(-1)
                   + (torch.where(dy < 0, ls, zero) * dy).sum(-1))
        prim_inf = ((_inf_norm(CT_mv(dy)) <= eps_p) & (support <= -sup_p)
                    & (dy_n > 1e-30))
        # dual: Q dx ~ 0, c'dx < 0, C dx in the recession cone
        Cdx = C_mv(dx)
        cone_ok = ((~torch.isfinite(us) | (Cdx <= eps_d))
                   & (~torch.isfinite(ls) | (Cdx >= -eps_d))).all(-1)
        dual_inf = ((_inf_norm(Q_mv(dx)) <= eps_d[:, 0])
                    & ((cs * dx).sum(-1) <= -1e-3 * dx_n) & cone_ok
                    & (dx_n > 1e-30))
        code = torch.where(prim_inf, STATUS_PRIMAL_INFEASIBLE,
                           torch.where(dual_inf, STATUS_DUAL_INFEASIBLE, 0))
        return code.to(i32)

    def certificate(x, z, y, step):
        """The status code of one extra iteration's deltas at ``(x, z, y)``
        (``step`` is the iteration), and that iteration's result."""
        x_e, z_e, y_e = step(x, z, y)
        return infeasibility(x_e - x, y_e - y), (x_e, z_e, y_e)

    no_code = torch.zeros((B,), dtype=i32, device=dev)
    x, z, y = x0, z0, y0
    if options.early_exit and options.adaptive_rho:
        # Chunked solve with OSQP-style rho adaptation: run
        # ``rho_update_interval`` iterations, check residuals, rescale rho
        # from the primal/dual residual ratio and refactorize (per chunk
        # and per lane).  Converged lanes freeze individually; the host
        # reads the done mask once per chunk.
        chunk = options.rho_update_interval
        scale = torch.ones((B,), dtype=dt, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        iters, code, pend = no_code, no_code, no_code
        prev_metric = torch.full((B,), torch.finfo(dt).max / 4, dtype=dt,
                                 device=dev)
        prev_scale = scale
        can_adapt = torch.ones((B,), dtype=torch.bool, device=dev)
        while True:
            active = ~done & (iters < options.max_iter)
            if not bool(active.any()):
                break
            rho_c = rho * scale[:, None]
            rho_inv_c = 1.0 / rho_c
            solve_fn = make_kkt_solve(rho_c)
            step = lambda a, b, c_: one_iter_at(a, b, c_, rho_c, rho_inv_c,
                                                solve_fn)
            x_n, z_n, y_n = x, z, y
            for _ in range(chunk):
                x_n, z_n, y_n = step(x_n, z_n, y_n)
            r_prim, r_dual, conv = residuals(x_n, z_n, y_n)
            if options.infeasibility_detection:
                # single-iteration deltas are the certificate directions
                infeas, _ = certificate(x_n, z_n, y_n, step)
            else:
                infeas = no_code
            # normalized residual ratio -> rho rescale (OSQP section 5.2),
            # with a self-guard: if the previous rescale made the worst
            # normalized residual worse, revert it and stop adapting
            Cx, zu, Qx, CTy = unscaled_terms(x_n, z_n, y_n)
            p_norm = torch.clamp(torch.maximum(_inf_norm(Cx), _inf_norm(zu)),
                                 min=1e-12)
            d_norm = torch.maximum(
                torch.maximum(_inf_norm(Qx), _inf_norm(CTy)),
                torch.clamp(c_norm, min=1e-12))
            rp_rel = r_prim / p_norm
            rd_rel = r_dual / d_norm
            metric = torch.maximum(rp_rel, rd_rel)
            regressed = (metric > prev_metric) & (scale != prev_scale)
            scale_eff = torch.where(regressed, prev_scale, scale)
            can_adapt_n = can_adapt & ~regressed
            ratio = torch.sqrt(rp_rel / torch.clamp(rd_rel, min=1e-30))
            ratio = torch.clamp(ratio, 0.1, 10.0)
            want = (ratio > 5.0) | (ratio < 0.2)
            new_scale = torch.where(
                can_adapt_n & want,
                torch.clamp(scale_eff * ratio, 1e-6, 1e6), scale_eff)
            # infeasibility must persist across two consecutive checks
            confirmed = torch.where((infeas > 0) & (infeas == pend), infeas,
                                    no_code)
            (x, z, y, scale, done, iters, code, pend, prev_metric,
             prev_scale, can_adapt) = _where(
                active,
                (x_n, z_n, y_n, new_scale, done | conv | (confirmed > 0),
                 iters + chunk, torch.maximum(code, confirmed), infeas,
                 torch.minimum(metric, prev_metric), scale_eff, can_adapt_n),
                (x, z, y, scale, done, iters, code, pend, prev_metric,
                 prev_scale, can_adapt))
        infeas_code = code
    elif options.early_exit:
        # Early exit on the residual check every ``check_interval``
        # iterations; lanes freeze individually and the host reads the
        # done mask at the checks only.
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        iters, code, pend = no_code, no_code, no_code
        active = ~done
        i = 0
        while i < options.max_iter:
            x, z, y = _where(active, one_iter(x, z, y), (x, z, y))
            i += 1
            iters = torch.where(active, i, iters).to(i32)
            if i % options.check_interval == 0 or i >= options.max_iter:
                _, _, conv = residuals(x, z, y)
                if options.infeasibility_detection:
                    # single-iteration deltas as certificate directions
                    infeas, _ = certificate(x, z, y, one_iter)
                else:
                    infeas = no_code
                confirmed = torch.where((infeas > 0) & (infeas == pend),
                                        infeas, no_code)
                done, code, pend = _where(
                    active, (conv | (confirmed > 0),
                             torch.maximum(code, confirmed), infeas),
                    (done, code, pend))
                active = ~done
                if not bool(active.any()):
                    break
        infeas_code = code
    else:
        for _ in range(options.max_iter):
            x, z, y = one_iter(x, z, y)
        iters = torch.full((B,), options.max_iter, dtype=i32, device=dev)
        if options.infeasibility_detection:
            # one extra iteration's deltas are the certificate directions;
            # an infeasible QP must not silently report max_iter (serving
            # paths run fixed-count).  Same two-consecutive-checks
            # confirmation as the early-exit paths.
            infeas_a, nxt = certificate(x, z, y, one_iter)
            infeas_b, _ = certificate(*nxt, one_iter)
            infeas_code = torch.where(
                (infeas_a > 0) & (infeas_a == infeas_b), infeas_a, no_code)
        else:
            infeas_code = no_code

    # back to the unscaled space
    x = D * x
    y = E * y * cost_inv
    z = E_inv * z

    if options.polish:
        x, y = _polish(qp, C, l, u, x, y, z, options)
        z = torch.clamp(matvec(C, x), l, u)

    Cx = x if box_only else matvec(C, x)
    r_prim = _inf_norm(Cx - z)
    Qx = matvec(qp.Q, x)
    CTy = y if box_only else matvec_t(C, y)
    r_dual = _inf_norm(Qx + qp.c + CTy)
    eps_prim = eps_abs + eps_rel * torch.maximum(_inf_norm(Cx), _inf_norm(z))
    eps_dual = eps_abs + eps_rel * torch.maximum(
        torch.maximum(_inf_norm(Qx), _inf_norm(CTy)), c_norm)
    conv = (r_prim <= eps_prim) & (r_dual <= eps_dual)
    # non-finite data or iterates must never report success
    finite = (torch.isfinite(x).all(-1)
              & torch.isfinite(qp.Q).all(-1).all(-1)
              & torch.isfinite(qp.c).all(-1))
    status = torch.where(conv & finite, STATUS_SOLVED,
                         STATUS_MAX_ITER).to(i32)
    status = torch.where(infeas_code > 0, infeas_code, status)
    # crossed bounds/rows make the projection set provably EMPTY:
    # clamp(v, lo, hi) with lo > hi silently collapses to hi and the
    # consensus gap reads zero, so the Farkas machinery never sees it
    crossed = (qp.lb > qp.ub).any(-1)
    status = torch.where(crossed, STATUS_PRIMAL_INFEASIBLE, status).to(i32)
    return QPSolution(x=x, y=y, z=z, status=status, iterations=iters,
                      primal_residual=r_prim, dual_residual=r_dual)


def solve_qp_batched(qp: DenseQP, options: SolverOptions = SolverOptions(),
                     warm_start: Optional[WarmStart] = None) -> QPSolution:
    """:func:`solve_qp` over a leading batch dimension.

    Leaves carrying a batch dimension (rank one above their canonical rank)
    are per lane; unbatched leaves (e.g. shared bounds or empty constraint
    blocks) broadcast.  In the port this is :func:`solve_qp` itself, which
    takes batched leaves; the name is kept, and a QP with no batched leaf
    is refused as the reference's ``vmap`` refuses it.
    """
    if not len(_qp_batch(qp)):
        raise ValueError("solve_qp_batched needs at least one leaf with a "
                         "leading batch dimension; use solve_qp for one QP")
    return solve_qp(qp, options, warm_start)
