"""Plain reference of the trotting SRB quadruped fleet: the exact forces of
each sampled robot, its QP rebuilt from the configuration, the robot's
gait phase and its state alone, following Di Carlo et al. (IROS 2018).

At the robot's yaw ``psi`` (``x0[2]``), with ``R = R_z(psi)``, the world
inertia ``I_w = R I_b R'`` and the lever arms ``r_i = R r_i^b`` of the
nominal feet,

    d(rpy)/dt = R' omega,   d omega/dt = I_w^-1 sum_i [r_i]x f_i,
    dp/dt = v,              dv/dt = sum_i f_i / m + g,

discretised by forward Euler over ``dt``.  A foot stands when its diagonal
pair does: the first pair for the first ``duty`` of the gait's period,
counted from the robot's phase.  Only the standing feet's forces are
variables (a swinging foot's force is 0); the problem is

    minimise 1/2 sum_{k=1..N} (x_k - x_ref)' W_k (x_k - x_ref)
             + 1/2 r sum_k |f_k|^2
    subject to |f_x|, |f_y| <= mu f_z, 0 <= f_z <= fz_max (standing feet),
               |roll|, |pitch| <= tilt, height in its range (k = 1..N)

with ``x_ref`` the robot's position and heading at the standing height,
every rate zero, ``W_k = diag(w)`` and ``W_N = terminal diag(w)``.
Condensed over the horizon it is a QP in the forces with general rows,
solved exactly by :func:`solve_qp_rows`.  ``U [n, N * 12]`` holds every
foot's force, 0 in swing.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

from . import precision as _precision


def _cross(r):
    z = torch.zeros_like(r[..., 0])
    return torch.stack([torch.stack([z, -r[..., 2], r[..., 1]], -1),
                        torch.stack([r[..., 2], z, -r[..., 0]], -1),
                        torch.stack([-r[..., 1], r[..., 0], z], -1)], -2)


def stance(cfg: dict, phase, N: int):
    """``[L, N, 4]`` bool: the feet standing at each stage of robots whose
    gaits are ``phase [L]`` steps into their period."""
    g = cfg["gait"]
    dt = float(cfg["dt"])
    period = int(round(float(g["period_s"]) / dt))
    down = int(round(float(g["duty"]) * period))
    k = torch.arange(N, device=phase.device)
    first = ((phase[:, None] + k[None]) % period) < down
    out = torch.zeros(first.shape + (4,), dtype=torch.bool,
                      device=phase.device)
    for leg in g["pairs"][0]:
        out[..., leg] = first
    for leg in g["pairs"][1]:
        out[..., leg] = ~first
    return out


def dynamics(cfg: dict, x0, contact):
    """``(A [L, 12, 12], B [L, N, 12, 12], d [12])`` at each robot's yaw,
    in ``x0``'s dtype."""
    kd = dict(dtype=x0.dtype, device=x0.device)
    L, N = x0.shape[0], contact.shape[1]
    dt, m = float(cfg["dt"]), float(cfg["mass"])
    psi = x0[:, 2]
    c, s = torch.cos(psi), torch.sin(psi)
    R = torch.zeros((L, 3, 3), **kd)
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = c, -s, s, c
    R[:, 2, 2] = 1.0
    Ib = torch.diag(torch.tensor(cfg["inertia"], **kd))
    Iw_inv = torch.linalg.inv(R @ Ib @ R.mT)                 # [L, 3, 3]
    feet = torch.tensor(cfg["feet"], **kd)                    # [4, 3]
    r = torch.einsum("lij,fj->lfi", R, feet)                  # [L, 4, 3]
    A = torch.eye(12, **kd).repeat(L, 1, 1)
    A[:, 0:3, 6:9] += dt * R.mT
    A[:, 3:6, 9:12] += dt * torch.eye(3, **kd)
    B = torch.zeros((L, N, 12, 12), **kd)
    for leg in range(4):
        ang = dt * Iw_inv @ _cross(r[:, leg])                 # [L, 3, 3]
        on = contact[:, :, leg].to(x0.dtype)[..., None, None]
        B[:, :, 6:9, 3 * leg:3 * leg + 3] = on * ang[:, None]
        B[:, :, 9:12, 3 * leg:3 * leg + 3] = on * (dt / m) * torch.eye(
            3, **kd)
    d = torch.zeros(12, **kd)
    d[11] = -float(cfg["gravity"]) * dt
    return A, B, d


def condensed(cfg: dict, x0, contact):
    """The QP of each robot in its standing feet's forces: ``(H [L, n,
    n], g [L, n], G [L, m, n], h [L, m], pick [L, n])``, ``G z <= h``,
    with ``pick`` the columns of ``U`` (stage-major, 12 a stage) that the
    ``n`` variables are.  Every robot stands on two feet at every stage
    (a trot), so ``n = 6 N`` for all of them."""
    kd = dict(dtype=x0.dtype, device=x0.device)
    L, N = x0.shape[0], contact.shape[1]
    A, B, d = dynamics(cfg, x0, contact)
    cols = contact.repeat_interleave(3, dim=-1).reshape(L, N * 12)
    pick = torch.stack([torch.nonzero(cols[lane])[:, 0]
                        for lane in range(L)])               # [L, n]
    n = pick.shape[1]
    # x_k = Phi_k x0 + Psi_k U + xi_k over the full U, then its columns
    Phi, Psi, xi = [], [], []
    X, P, c = x0, torch.zeros((L, 12, N * 12), **kd), torch.zeros((L, 12),
                                                                  **kd)
    for k in range(N):
        X = (A @ X[..., None])[..., 0]
        P = A @ P
        P[:, :, 12 * k:12 * k + 12] += B[:, k]
        c = (A @ c[..., None])[..., 0] + d
        Phi.append(X)
        Psi.append(P)
        xi.append(c)
    xoff = torch.stack(Phi, 1) + torch.stack(xi, 1)           # [L, N, 12]
    Psi = torch.stack(Psi, 1)                                 # [L, N, 12, NU]
    Psi = torch.gather(Psi, 3, pick[:, None, None, :].expand(
        L, N, 12, n))                                         # [L, N, 12, n]
    w = torch.tensor(cfg["state_weights"], **kd)
    W = w.repeat(N, 1)
    W[-1] *= float(cfg["terminal_factor"])                    # [N, 12]
    ref = torch.zeros((L, 12), **kd)
    ref[:, 2:5] = x0[:, 2:5]
    ref[:, 5] = float(cfg["height"])
    Pw = Psi * W[None, :, :, None]
    H = torch.einsum("lkin,lkim->lnm", Pw, Psi) + float(
        cfg["force_weight"]) * torch.eye(n, **kd)
    g = torch.einsum("lkin,lki->ln", Pw, xoff - ref[:, None])
    # rows: the pyramid and the f_z box of each standing foot, the tilt
    # and height corridor of each stage's state
    mu, fz_max = float(cfg["mu"]), float(cfg["fz_max"])
    feet = n // 3
    Gf = torch.zeros((6, 3), **kd)
    Gf[0, 0], Gf[1, 0], Gf[2, 1], Gf[3, 1] = 1.0, -1.0, 1.0, -1.0
    Gf[:4, 2] = -mu
    Gf[4, 2], Gf[5, 2] = -1.0, 1.0
    hf = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, fz_max], **kd)
    Gforce = torch.block_diag(*([Gf] * feet))                 # [6 feet, n]
    hforce = hf.repeat(feet)
    lo_t, hi_t = float(-cfg["tilt"]), float(cfg["tilt"])
    h_lo, h_hi = (float(v) for v in cfg["height_range"])
    sel = Psi[:, :, [0, 1, 5]]                                # [L, N, 3, n]
    off = xoff[:, :, [0, 1, 5]]
    hi = torch.tensor([hi_t, hi_t, h_hi], **kd)
    lo = torch.tensor([lo_t, lo_t, h_lo], **kd)
    Gstate = torch.cat([sel, -sel], 2).reshape(L, N * 6, n)
    hstate = torch.cat([hi - off, off - lo], 2).reshape(L, N * 6)
    G = torch.cat([Gforce.expand(L, -1, -1), Gstate], 1)
    h = torch.cat([hforce.expand(L, -1), hstate], 1)
    return 0.5 * (H + H.mT), g, G, h, pick


def natural_residual(H, g, G, h, z, lam):
    """The min-map residual of the KKT system per lane: ``max(|H z + g +
    G' lam|, |min(lam, h - G z)|)``, 0 exactly at a solution and its
    multipliers."""
    stat = (H @ z[..., None])[..., 0] + g + (G.mT @ lam[..., None])[..., 0]
    slack = h - (G @ z[..., None])[..., 0]
    return torch.maximum(stat.abs().amax(-1),
                         torch.minimum(lam, slack).abs().amax(-1))


def _interior_point(H, g, G, h, iters: int):
    """Mehrotra's predictor-corrector for ``G z <= h`` with slacks of their
    own, from ``z = 0``; a step that leaves the finite numbers is not
    taken."""
    L, m = G.shape[0], G.shape[1]
    z = torch.zeros_like(g)
    s = torch.clamp(h, min=1.0)
    lam = torch.ones_like(h)

    def solve(M, rhs):
        return torch.linalg.solve_ex(M, rhs[..., None])[0][..., 0]

    def longest(v, dv):
        neg = dv < 0
        ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(
            dv)), torch.full_like(v, float("inf")))
        return ratio.amin(-1).clamp(max=1.0)[..., None]

    for _ in range(iters):
        mu = (s * lam).sum(-1, keepdim=True) / m
        r_d = (H @ z[..., None])[..., 0] + g + (G.mT @ lam[..., None])[..., 0]
        r_p = (G @ z[..., None])[..., 0] + s - h
        D = lam / s
        M = H + G.mT @ (D[..., None] * G)

        def direction(r_c):
            rhs = -r_d - (G.mT @ (D * r_p + r_c / s)[..., None])[..., 0]
            dz = solve(M, rhs)
            dlam = D * ((G @ dz[..., None])[..., 0] + r_p) + r_c / s
            ds = -r_p - (G @ dz[..., None])[..., 0]
            return dz, ds, dlam

        dz, ds, dlam = direction(-s * lam)
        a = torch.minimum(longest(s, ds), longest(lam, dlam))
        mu_aff = ((s + a * ds) * (lam + a * dlam)).sum(-1, keepdim=True) / m
        sigma = (mu_aff / mu.clamp(min=torch.finfo(mu.dtype).tiny)
                 ).clamp(0.0, 1.0) ** 3
        dz, ds, dlam = direction(-s * lam - ds * dlam + sigma * mu)
        a = 0.99 * torch.minimum(longest(s, ds), longest(lam, dlam))
        zn, sn, ln = z + a * dz, s + a * ds, lam + a * dlam
        ok = (torch.isfinite(zn).all(-1) & torch.isfinite(sn).all(-1)
              & torch.isfinite(ln).all(-1))[..., None]
        z = torch.where(ok, zn, z)
        s = torch.where(ok, sn, s)
        lam = torch.where(ok, ln, lam)
    return z, lam, s


def solve_qp_rows(H, g, G, h, iters: int = 60, polish_rounds: int = 4,
                  refine: int = 3):
    """``(z, residual)``: the solution of ``minimise 1/2 z'Hz + g'z
    subject to G z <= h`` for every lane, and its
    :func:`natural_residual`, in the dtype of ``H``.  After the interior
    point, each round takes as active the rows whose multiplier exceeds
    their slack and solves the KKT system on that set (the rows of the
    others hold their multiplier at 0).  Where more rows bind than the
    variables they hold (a foot at f_z = 0 under its whole pyramid) that
    system is singular: it is solved with ``-delta I`` on the active rows'
    diagonal (``delta`` at rounding of the rows' scale) and ``refine``
    steps of iterative refinement against the unperturbed system.  The
    best iterate by residual is kept."""
    z, lam, s = _interior_point(H, g, G, h, iters)
    best_z, best_l = z, lam.clamp(min=0.0)
    best = natural_residual(H, g, G, h, best_z, best_l)
    n = H.shape[-1]
    delta = 100 * torch.finfo(H.dtype).eps
    for _ in range(polish_rounds):
        act = lam > h - (G @ z[..., None])[..., 0]
        a = act.to(H.dtype)
        top = torch.cat([H, G.mT * a[:, None, :]], -1)
        K = torch.cat([top, torch.cat([G * a[..., None],
                                       torch.diag_embed(1.0 - a)], -1)], -2)
        Kd = torch.cat([top, torch.cat([G * a[..., None], torch.diag_embed(
            1.0 - a - delta * a)], -1)], -2)
        rhs = torch.cat([-g, a * h], -1)[..., None]
        lu, piv, _ = torch.linalg.lu_factor_ex(Kd)
        sol = torch.linalg.lu_solve(lu, piv, rhs)
        for _ in range(refine):
            sol = sol + torch.linalg.lu_solve(lu, piv, rhs - K @ sol)
        sol = sol[..., 0]
        z, lam = sol[..., :n], sol[..., n:]
        res = natural_residual(H, g, G, h, z, lam)
        better = res < best
        best_z = torch.where(better[..., None], z, best_z)
        best_l = torch.where(better[..., None], lam, best_l)
        best = torch.where(better, res, best)
    return best_z, best


def controls(cfg: dict, raw: dict, x0, lanes, precision="float64"):
    """``(U [L, N * 12], residual [L])``: the exact forces of the robots
    ``lanes`` at their states ``x0 [L, 12]``, computed in ``precision``.
    ``raw`` holds each robot's gait phase, ``phase [robots]`` (steps into
    its period)."""
    with _precision(precision) as dtype:
        x0 = x0.to(dtype)
        phase = raw["phase"][torch.as_tensor(lanes,
                                             device=raw["phase"].device)]
        N = int(cfg["horizon"])
        contact = stance(cfg, phase.to(x0.device), N)
        H, g, G, h, pick = condensed(cfg, x0, contact)
        z, res = solve_qp_rows(H, g, G, h)
        U = torch.zeros((x0.shape[0], N * 12), dtype=dtype,
                        device=x0.device)
        U.scatter_(1, pick, z)
        return U, res
