"""The f64 polish of the stagewise engine's float32 fixed-count tick.

Port of ``copra_tpu/ops/df32_polish.py``.  The float32 tick converges to
an accuracy floor of ~2e-5 on 1e4-curvature problems (the config-1
class): f32 rounding amplified through the Riccati sweeps, which more f32
iterations cannot lower.  The polish runs a few dozen iterations of the
same ADMM update in float64 from the delivered state, which contracts the
floor's error at the iteration's linear rate.

The reference emulates float64 on the TPU with compensated float32 pairs
(``ops/df32.py``: two-sum, Veltkamp splits) and writes the iteration out
again in that arithmetic (``_polish_lane``, the mirror of
``solve_stagewise``'s ``one_iter``).  The H100 has float64 in hardware,
so here the polish is the stagewise tick kernel itself
(``csrc/stagewise_tick.cu``, K4 or K5 by the problem's entry point) run in
float64: one launch of ``polish_iters`` iterations on a float64 plan, from
the delivered float32 state cast up, its result cast back.  ``df32.py``
has no counterpart.

What the float64 plan keeps of the float32 phase, as the reference's
polish plan does (``build_df32_polish_plan``): the per-coordinate
penalties ``rho_x``/``rho_u``, the row normalization ``Es`` and the
per-row penalties ``rho_s`` as the float32 phase computed them (the warm
``zS``/``yS`` live in that row-scaled space), ``sigma`` and ``alpha`` as
their float32 values, the data cast up.  The gains come from the float64
Riccati recursion of those ridged Hessians; ``avd = (A'V) d``.  A float32
bound at or beyond ``finfo(float32).max / 8``, which the float32 phase
takes as infinite, becomes ``+-finfo(float64).max / 4``, so that the
penalties and the kernel's clip agree in float64 too.  The proximal
centre of the first polish iteration is the delivered iterate ``(X,
U)``, as in the reference: the kernel's ``carry`` flag.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._precision import highest_precision

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PolishPlan:
    """The float64 plan ``[N+1, C, B]`` of a polish, its entry point and,
    on CUDA, its lane-first copy."""

    plan: Tensor
    mode: str
    plan_lf: Optional[Tensor] = None


def check_polish_envelope(N: int, x: int, u: int, r: int) -> None:
    """Raise ``ValueError`` unless the float64 tick kernel can run the
    polish of a problem of this size."""
    from .stagewise_kernel import check_fused_envelope

    try:
        check_fused_envelope(N, x, u, r, torch.float64)
    except ValueError as e:
        raise ValueError(
            f"options.polish_iters: the f64 polish runs the stagewise "
            f"tick kernel in float64, whose envelope this problem exceeds "
            f"({e}).  Serve it with polish_iters=0, or on the plain path "
            f"(make_stagewise_step(backend='xla'), which does not "
            f"polish).") from e


@highest_precision
def build_polish_plan(sqp, rho_x: Tensor, rho_u: Tensor, rows,
                      options) -> PolishPlan:
    """The float64 plan of the polish of a batched float32 problem
    ``sqp``, from the float32 plan's penalties ``rho_x``, ``rho_u`` and
    normalized ``rows`` (``riccati._Rows`` or ``None``).  On CUDA it
    raises when the float64 kernel cannot take the shape."""
    from ..qp.riccati import _Rows
    from .stagewise_kernel import (fused_mode, lane_first_plan, pack_plan,
                                   precompute_lqr_gains)

    N, x, u, r = sqp.horizon, sqp.xdim, sqp.udim, sqp.nr_rows
    if sqp.A.is_cuda:
        check_polish_envelope(N, x, u, r)
    f64 = lambda t: None if t is None else t.to(torch.float64)
    s64 = dataclasses.replace(sqp, **{
        f.name: f64(getattr(sqp, f.name)) for f in dataclasses.fields(sqp)})
    kd = dict(dtype=torch.float64, device=sqp.A.device)
    sigma = float(np.float32(options.sigma))
    rho_x, rho_u = f64(rho_x), f64(rho_u)
    Qx_r = s64.Qx + sigma * torch.eye(x, **kd) + torch.diag_embed(rho_x)
    Ru_r = s64.Ru + sigma * torch.eye(u, **kd) + torch.diag_embed(rho_u)
    S = rows64 = None
    if rows is not None:
        Es = f64(rows.Es)
        rows64 = _Rows(Es=Es, Cx=s64.Cx * Es[..., None],
                       Cu=s64.Cu * Es[..., None], slo=s64.clo * Es,
                       shi=s64.chi * Es, rho_s=f64(rows.rho_s))
        Qx_r = torch.cat([Qx_r[:, :-1] + torch.einsum(
            "bkrx,bkr,bkry->bkxy", rows64.Cx, rows64.rho_s, rows64.Cx),
            Qx_r[:, -1:]], dim=1)
        Ru_r = Ru_r + torch.einsum("bkru,bkr,bkrv->bkuv", rows64.Cu,
                                   rows64.rho_s, rows64.Cu)
        S = torch.einsum("bkrx,bkr,bkru->bkxu", rows64.Cx, rows64.rho_s,
                         rows64.Cu)
    gains = precompute_lqr_gains(s64.A, s64.B, s64.d, Qx_r, Ru_r, S)
    big32 = float(np.finfo(np.float32).max) / 8
    big64 = torch.finfo(torch.float64).max / 4
    plan = pack_plan(s64, gains, rho_x, rho_u, rows64,
                     lambda t: torch.where(t <= -big32, -big64, t),
                     lambda t: torch.where(t >= big32, big64, t))
    return PolishPlan(plan=plan, mode=fused_mode(N, x, u, r, torch.float64),
                      plan_lf=lane_first_plan(plan) if plan.is_cuda
                      else None)


def polish(pp: PolishPlan, entry, x0: Tensor, warm: Tensor, work: Tensor,
           *, n_iter: int, N: int, x: int, u: int, r: int, options,
           skip: Optional[Tensor] = None):
    """``n_iter`` float64 iterations of the tick from the delivered
    float32 kernel state ``(warm [N+1, W, B], work [N+1, Kw, B])``, lane
    last, at ``x0 [x, B]``: one launch of ``entry`` (the tick wrapper of
    the float32 phase, so the launch counts with it) on ``pp``, the
    proximal centre carried from ``work``.  Returns the polished
    ``(warm, work)`` in float32.  ``skip``: the device flag of a top-up
    (set, the launch returns its state as given).  No host sync."""
    f64 = torch.float64
    w64, k64 = entry(pp.plan, x0.to(f64), warm.to(f64), n_iter=int(n_iter),
                     N=N, x=x, u=u, r=r,
                     sigma=float(np.float32(options.sigma)),
                     alpha=float(np.float32(options.alpha)),
                     plan_lf=pp.plan_lf, work=work.to(f64), skip=skip,
                     carry=True)
    return w64.to(warm.dtype), k64.to(work.dtype)
