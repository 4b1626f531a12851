"""QP assembly (port of ``copra_tpu/mpc.py:build_qp``).

``solve_mpc`` and the ``LMPC`` facade need the general ADMM solver and are
not ported yet (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ._precision import highest_precision
from .constraints import Constraint, ConstraintKind
from .costs import CostFunction
from .qp.types import DenseQP
from .systems import Preview

# PD ridge seeded into the Hessian so the QP stays positive definite with no
# registered costs.
HESSIAN_RIDGE = 1e-6


@highest_precision
def build_qp(preview: Preview, x0: torch.Tensor,
             costs: Sequence[CostFunction],
             constraints: Sequence[Constraint],
             ridge: float = HESSIAN_RIDGE) -> DenseQP:
    """Assemble the dense QP.

    * ``Q = ridge*I + sum(cost.Q)``, ``c = sum(cost.c)``;
    * equality / inequality rows stacked in registration order;
    * bounds start at +-inf and each bound constraint overwrites (the last
      registered one is effective).

    Leading batch dimensions of the preview carry into ``Q`` and the rows;
    extra leading dimensions of ``x0`` broadcast into ``c`` and the
    right-hand sides.
    """
    n = preview.full_udim
    dt = preview.Psi.dtype
    dev = preview.Psi.device
    Q = ridge * torch.eye(n, dtype=dt, device=dev)
    c = torch.zeros((n,), dtype=dt, device=dev)
    for cost in costs:
        Qi, ci = cost.lower(preview, x0)
        Q = Q + Qi
        c = c + ci
    # exact symmetrization: the f32 M'WM products carry ~eps asymmetry,
    # which the ill-conditioned directions amplify into ~1e-4 ambiguity
    # about WHICH QP is being solved
    Q = 0.5 * (Q + Q.transpose(-1, -2))

    eq_A, eq_b, ineq_A, ineq_b = [], [], [], []
    lb = torch.full((n,), -torch.inf, dtype=dt, device=dev)
    ub = torch.full((n,), torch.inf, dtype=dt, device=dev)
    for constr in constraints:
        kind = constr.kind()
        if kind is ConstraintKind.BOUND:
            lo, up = constr.lower(preview, x0)
            lb, ub = lo.to(dt), up.to(dt)
        elif kind is ConstraintKind.EQUALITY:
            A, b = constr.lower(preview, x0)
            eq_A.append(A)
            eq_b.append(b)
        else:
            A, b = constr.lower(preview, x0)
            ineq_A.append(A)
            ineq_b.append(b)

    a_batch = preview.batch_shape
    b_batch = torch.broadcast_shapes(a_batch, torch.as_tensor(x0).shape[:-1])

    def _stack(As, bs):
        if not As:
            return (torch.zeros((*a_batch, 0, n), dtype=dt, device=dev),
                    torch.zeros((*b_batch, 0), dtype=dt, device=dev))
        return (torch.cat([A.expand(*a_batch, *A.shape[-2:]) for A in As],
                          dim=-2),
                torch.cat([b.expand(*b_batch, b.shape[-1]) for b in bs],
                          dim=-1))

    Aeq, beq = _stack(eq_A, eq_b)
    Aineq, bineq = _stack(ineq_A, ineq_b)
    return DenseQP(Q=Q, c=c, Aeq=Aeq, beq=beq, Aineq=Aineq, bineq=bineq,
                   lb=lb, ub=ub)
