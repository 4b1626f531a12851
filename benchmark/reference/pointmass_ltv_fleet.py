"""Plain reference of the point-mass LTV fleet: the exact controls of each
lane's MPC problem, worked out from the raw arrays alone.

Each lane is ``x_{k+1} = A_k x_k + B_k u_k + d_k`` over ``N`` stages with
a terminal target cost ``1/2 (x_N - p)' W (x_N - p)``, a per-stage control
cost ``1/2 w_u (u_k - p_u)^2``, a ridge ``1/2 r |U|^2`` and a box
``|u_k| <= bound``.  Condensing gives ``x_N = Phi x0 + Psi U + xi``; the
condensed QP in ``U`` is a box QP, solved exactly by
:func:`reference.qp.solve_box_qp`.
"""

from __future__ import annotations

import torch

from . import precision as _precision
from .qp import solve_box_qp


def _terminal_maps(A, B, d):
    """``(Phi [L, x, x], Psi [L, x, N u], xi [L, x])`` of the terminal
    state, by the backward product ``G = A_{N-1} ... A_{k+1}``."""
    L, N, x, u = B.shape
    G = torch.eye(x, dtype=A.dtype, device=A.device).expand(L, x, x)
    cols = [None] * N
    xi = torch.zeros((L, x), dtype=A.dtype, device=A.device)
    for k in range(N - 1, -1, -1):
        cols[k] = G @ B[:, k]
        xi = xi + (G @ d[:, k].unsqueeze(-1)).squeeze(-1)
        G = G @ A[:, k]
    return G, torch.cat(cols, dim=-1), xi


def box_qp(cfg: dict, raw: dict, x0, lanes, dtype):
    """``(H, g, lo, hi)`` in ``dtype`` of the condensed QPs of ``lanes``
    of ``raw`` (``A [B, N, x, x]``, ``B [B, N, x, u]``, ``d [B, N, x]``)
    at their initial states ``x0 [L, x]``."""
    idx = torch.as_tensor(lanes, device=raw["A"].device)
    A, B, d = (raw[k][idx].to(dtype) for k in ("A", "B", "d"))
    x0 = x0.to(dtype)
    L, N, x, u = B.shape
    Phi, Psi, xi = _terminal_maps(A, B, d)
    t = cfg["target"]
    M = torch.tensor(t["M"], dtype=dtype, device=A.device)
    p = torch.tensor(t["p"], dtype=dtype, device=A.device)
    W = torch.diag(torch.tensor(t["weights"], dtype=dtype, device=A.device))
    c = cfg["control_cost"]
    Nu = torch.tensor(c["N"], dtype=dtype, device=A.device)
    pu = torch.tensor(c["p"], dtype=dtype, device=A.device)
    Wu = torch.diag(torch.tensor(c["weights"], dtype=dtype, device=A.device))
    MP = M @ Psi                                       # [L, r, N u]
    resid = (M @ ((Phi @ x0.unsqueeze(-1)).squeeze(-1) + xi).unsqueeze(-1)
             ).squeeze(-1) - p
    H = MP.mT @ W @ MP
    g = (MP.mT @ (W @ resid.unsqueeze(-1))).squeeze(-1)
    small = Nu.mT @ Wu @ Nu                            # [u, u]
    eye_n = torch.eye(N, dtype=dtype, device=A.device)
    H = H + torch.kron(eye_n, small) + cfg["hessian_ridge"] * torch.eye(
        N * u, dtype=dtype, device=A.device)
    g = g - (Nu.mT @ Wu @ pu).repeat(N)
    H = 0.5 * (H + H.mT)
    bound = float(cfg["control_bound"])
    lo = torch.full_like(g, -bound)
    return H, g, lo, -lo


def controls(cfg: dict, raw: dict, x0, lanes, precision="float64"):
    """``(U [L, N u], residual [L])``: the exact controls of ``lanes`` at
    ``x0 [L, x]``, computed in ``precision``."""
    with _precision(precision) as dtype:
        H, g, lo, hi = box_qp(cfg, raw, x0, lanes, dtype)
        return solve_box_qp(H, g, lo, hi)
