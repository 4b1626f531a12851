"""The exact solution of a batch of box-constrained QPs, in plain PyTorch.

    minimise 1/2 z' H z + g' z   subject to   lo <= z <= hi

for every lane of ``H [L, n, n]`` (symmetric positive definite), ``g, lo,
hi [L, n]`` (a bound may be infinite).  A primal-dual interior-point
method (Mehrotra's predictor-corrector) finds the active set; one solve of
the KKT system on that set then gives the solution to rounding, and the
natural residual ``|z - clamp(z - (H z + g), lo, hi)|`` checks it.

It imports nothing of the program.  ``dtype`` sets the precision of every
operation, so the same code gives the benchmark's reference (float64) and
its lower-precision control.
"""

from __future__ import annotations

import torch


def _step_to_boundary(v, dv, mask):
    """The largest step in (0, 1] that keeps ``v + a dv`` positive where
    ``mask``, per lane."""
    neg = mask & (dv < 0)
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return ratio.amin(-1).clamp(max=1.0)


def natural_residual(H, g, lo, hi, z):
    """``max |z - clamp(z - (H z + g), lo, hi)|`` per lane: 0 exactly at
    the solution."""
    grad = (H @ z.unsqueeze(-1)).squeeze(-1) + g
    return (z - torch.clamp(z - grad, lo, hi)).abs().amax(-1)


def _interior_point(H, g, lo, hi, iters: int):
    """Mehrotra's predictor-corrector from the middle of the box; the
    slacks ``z - lo`` and ``hi - z`` are variables of their own, so that
    rounding never drives one to zero."""
    fl, fu = torch.isfinite(lo), torch.isfinite(hi)
    zero = torch.zeros_like(g)
    one = torch.ones_like(g)
    lo0, hi0 = torch.where(fl, lo, zero), torch.where(fu, hi, zero)
    # start inside the box: the midpoint, or one unit inside a lone bound
    z = torch.where(fl & fu, 0.5 * (lo0 + hi0),
                    torch.where(fl, lo0 + 1.0,
                                torch.where(fu, hi0 - 1.0, zero)))
    sl = torch.where(fl, z - lo0, one)
    su = torch.where(fu, hi0 - z, one)
    ll, lu = torch.where(fl, one, zero), torch.where(fu, one, zero)
    n_bounds = (fl.sum(-1) + fu.sum(-1)).clamp(min=1).to(z.dtype)
    for _ in range(iters):
        mu = ((ll * sl).sum(-1) + (lu * su).sum(-1)) / n_bounds
        M = H + torch.diag_embed(ll / sl + lu / su)
        chol, _ = torch.linalg.cholesky_ex(M)
        base = -((H @ z.unsqueeze(-1)).squeeze(-1) + g - ll + lu)

        def direction(tl, tu):
            # tl, tu: the targets of ll sl and lu su after the step
            rhs = base + torch.where(fl, (tl - ll * sl) / sl, zero) \
                - torch.where(fu, (tu - lu * su) / su, zero)
            dz = torch.cholesky_solve(rhs.unsqueeze(-1), chol).squeeze(-1)
            dll = torch.where(fl, (tl - ll * sl - ll * dz) / sl, zero)
            dlu = torch.where(fu, (tu - lu * su + lu * dz) / su, zero)
            return dz, dll, dlu

        def longest(dz, dll, dlu):
            return torch.minimum(
                torch.minimum(_step_to_boundary(sl, dz, fl),
                              _step_to_boundary(su, -dz, fu)),
                torch.minimum(_step_to_boundary(ll, dll, fl),
                              _step_to_boundary(lu, dlu, fu))).unsqueeze(-1)

        dz, dll, dlu = direction(zero, zero)
        a = longest(dz, dll, dlu)
        mu_aff = (torch.where(fl, (ll + a * dll) * (sl + a * dz), zero)
                  .sum(-1) + torch.where(fu, (lu + a * dlu) * (su - a * dz),
                                         zero).sum(-1)) / n_bounds
        sigma = (mu_aff / mu.clamp(min=torch.finfo(mu.dtype).tiny)
                 ).clamp(0.0, 1.0) ** 3
        tau = (sigma * mu).unsqueeze(-1)
        dz, dll, dlu = direction(tau - dz * dll, tau + dz * dlu)
        a = 0.995 * longest(dz, dll, dlu)
        z = z + a * dz
        sl = torch.where(fl, sl + a * dz, one)
        su = torch.where(fu, su - a * dz, one)
        ll = torch.where(fl, ll + a * dll, zero)
        lu = torch.where(fu, lu + a * dlu, zero)
    return z


def _active_set_solve(H, g, lo, hi, at_lo, at_hi):
    """The KKT system on one active set: active coordinates sit on their
    bound, the free ones make the gradient zero."""
    active = at_lo | at_hi
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    bound = torch.where(at_lo, lo, torch.where(at_hi, hi, torch.zeros_like(g)))
    # rows of free coordinates: H z = -g; rows of active ones: z = bound
    rows = torch.where(active.unsqueeze(-1), eye.expand_as(H), H)
    rhs = torch.where(active, bound, -g)
    return torch.linalg.solve(rows, rhs.unsqueeze(-1)).squeeze(-1)


def solve_box_qp(H, g, lo, hi, iters: int = 60, polish_rounds: int = 4):
    """``(z, residual)``: the solution of every lane and its natural
    residual, all in the dtype of ``H``.  After the interior point, each
    round takes as active the coordinates that a projected gradient step
    would push past their bound (a primal-dual active-set step) and
    solves the KKT system there; the best iterate by residual is kept."""
    z = _interior_point(H, g, lo, hi, iters)
    best = z.clamp(lo, hi)
    best_res = natural_residual(H, g, lo, hi, best)
    for _ in range(polish_rounds):
        grad = (H @ z.unsqueeze(-1)).squeeze(-1) + g
        at_lo = torch.isfinite(lo) & (z - grad < lo)
        at_hi = torch.isfinite(hi) & (z - grad > hi) & ~at_lo
        z = _active_set_solve(H, g, lo, hi, at_lo, at_hi)
        cand = z.clamp(lo, hi)
        res = natural_residual(H, g, lo, hi, cand)
        better = res < best_res
        best = torch.where(better.unsqueeze(-1), cand, best)
        best_res = torch.where(better, res, best_res)
    return best, best_res
