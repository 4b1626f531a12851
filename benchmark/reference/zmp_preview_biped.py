"""Plain reference of the ZMP preview fleet: the exact jerk sequence of
each lane (one axis of one robot), worked out from the raw arrays alone.

Per axis the cart-table model ``x = (c, c', c'')`` runs ``x_{k+1} = A x_k +
B u_k + d`` with the jerk ``u_k``; the ZMP is ``z_k = zmp_row . x_k``.  The
problem is

    minimise 1/2 w sum_{k=0..N} (z_k - ref_k)^2 + 1/2 eps sum_k u_k^2
    subject to lo_k <= z_k <= hi_k, k = 1..N

(``w`` the ZMP weight, ``eps`` the jerk weight plus the Hessian ridge;
the ZMP of stage 0 is
fixed by x0 and bounds nothing).  Condensing gives ``z_{1..N} = L U +
zoff`` with ``L`` lower triangular and invertible (its diagonal is
``zmp_row . B``), so in ``w = z_{1..N}`` the problem is a box QP with the
Hessian ``w I + eps L^-T L^-1``; it is solved exactly by
:func:`reference.qp.solve_box_qp` and mapped back, ``U = L^-1 (w - zoff)``.
"""

from __future__ import annotations

import torch

from . import precision as _precision
from .qp import solve_box_qp


def _maps(A, B, d, zmp_row, N: int):
    """``(Zphi [N + 1, x], Zpsi [N + 1, N], Zxi [N + 1])``: the ZMP of stage
    k is ``Zphi[k] x0 + Zpsi[k] U + Zxi[k]``."""
    x = A.shape[0]
    Phi = [torch.eye(x, dtype=A.dtype, device=A.device)]
    Psi = [torch.zeros((x, N), dtype=A.dtype, device=A.device)]
    xi = [torch.zeros(x, dtype=A.dtype, device=A.device)]
    for k in range(1, N + 1):
        Phi.append(A @ Phi[-1])
        nxt = A @ Psi[-1]
        nxt[:, k - 1] += B[:, 0]
        Psi.append(nxt)
        xi.append(A @ xi[-1] + d)
    Phi, Psi, xi = torch.stack(Phi), torch.stack(Psi), torch.stack(xi)
    return Phi.mT @ zmp_row, (zmp_row @ Psi), xi @ zmp_row


def controls(cfg: dict, raw: dict, x0, lanes, precision="float64"):
    """``(U [L, N], residual [L])``: the exact jerks of ``lanes`` (lane
    ``l`` is axis ``l % 2``) at ``x0 [L, x]``, computed in ``precision``.
    ``raw`` holds ``A [x, x]``, ``B [x, 1]``, ``d [x]``, ``zmp_row [x]`` and
    the footstep plan's ``ref``, ``lo``, ``hi [2, N + 1]``."""
    with _precision(precision) as dtype:
        return _controls(cfg, raw, x0, lanes, dtype)


def _controls(cfg, raw, x0, lanes, dtype):
    A, B, d, zr, ref, lo, hi = (raw[k].to(dtype) for k in
                                ("A", "B", "d", "zmp_row", "ref", "lo", "hi"))
    x0 = x0.to(dtype)
    N = ref.shape[-1] - 1
    eps = float(cfg["jerk_weight"]) + float(cfg["hessian_ridge"])
    Zphi, Zpsi, Zxi = _maps(A, B, d, zr, N)
    L = Zpsi[1:]
    eye = torch.eye(N, dtype=dtype, device=A.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    wz = float(cfg["zmp_weight"])
    M = Linv.mT @ Linv
    H = wz * eye + eps * M
    H = 0.5 * (H + H.mT)
    axis = torch.as_tensor(lanes, device=A.device) % 2
    zoff = x0 @ Zphi[1:].mT + Zxi[1:]                  # [L, N]
    g = -wz * ref[axis, 1:] - eps * (zoff @ M)         # M symmetric
    w, res = solve_box_qp(H.expand(len(axis), N, N).contiguous(), g,
                          lo[axis, 1:], hi[axis, 1:])
    U = (w - zoff) @ Linv.mT
    return U, res
