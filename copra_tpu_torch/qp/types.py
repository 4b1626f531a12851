"""Dense-QP problem/solution containers and solver options.

Port of ``copra_tpu/qp/types.py``: the same canonical form

    min 1/2 x^T Q x + c^T x
    s.t. Aeq x = beq,  Aineq x <= bineq,  lb <= x <= ub

held in frozen dataclasses of tensors (leading batch dimensions allowed
where JAX vmaps).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._tensors import as_tensor

Tensor = torch.Tensor

STATUS_SOLVED = 0
STATUS_MAX_ITER = 1
STATUS_PRIMAL_INFEASIBLE = 2
STATUS_DUAL_INFEASIBLE = 3

STATUS_MESSAGES = {
    STATUS_SOLVED: "solved",
    STATUS_MAX_ITER: "maximum iterations reached",
    STATUS_PRIMAL_INFEASIBLE: "primal infeasible",
    STATUS_DUAL_INFEASIBLE: "dual infeasible",
}

STATUS_EXPLANATIONS = {
    STATUS_SOLVED: "converged: primal and dual residuals within tolerance",
    STATUS_MAX_ITER: ("iteration budget exhausted before the residual "
                      "tolerances were met; the returned iterate is the "
                      "best found — raise max_iter, loosen eps_abs/eps_rel, "
                      "or warm-start from a nearby solution"),
    STATUS_PRIMAL_INFEASIBLE: ("primal infeasibility certificate found: a "
                               "dual direction dy with C'dy ~ 0 and "
                               "negative support proves no x satisfies the "
                               "constraints; check bounds/rows for "
                               "contradictions"),
    STATUS_DUAL_INFEASIBLE: ("dual infeasibility certificate found: a "
                             "primal ray dx with Q dx ~ 0 and c'dx < 0 "
                             "proves the objective is unbounded below on "
                             "the feasible set; the QP is not positive "
                             "definite on the constraint recession cone"),
}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


@dataclasses.dataclass(frozen=True)
class DenseQP:
    """One dense QP (or a batch of them along leading dimensions)."""

    Q: Tensor        # [n, n]
    c: Tensor        # [n]
    Aeq: Tensor      # [me, n]  (me may be 0)
    beq: Tensor      # [me]
    Aineq: Tensor    # [mi, n]  (mi may be 0)
    bineq: Tensor    # [mi]
    lb: Tensor       # [n]
    ub: Tensor       # [n]

    @property
    def nr_vars(self) -> int:
        return self.Q.shape[-1]

    @property
    def nr_eq(self) -> int:
        return self.Aeq.shape[-2]

    @property
    def nr_ineq(self) -> int:
        return self.Aineq.shape[-2]

    @classmethod
    def create(cls, Q, c, Aeq=None, beq=None, Aineq=None, bineq=None,
               lb=None, ub=None) -> "DenseQP":
        Q = as_tensor(Q)
        c = as_tensor(c, Q.device)
        n = Q.shape[-1]
        kw = dict(dtype=Q.dtype, device=Q.device)
        if Aeq is None:
            Aeq, beq = torch.zeros((0, n), **kw), torch.zeros((0,), **kw)
        if Aineq is None:
            Aineq, bineq = torch.zeros((0, n), **kw), torch.zeros((0,), **kw)
        if lb is None:
            lb = torch.full((n,), -torch.inf, **kw)
        if ub is None:
            ub = torch.full((n,), torch.inf, **kw)
        return cls(Q=Q, c=c, Aeq=as_tensor(Aeq, Q.device),
                   beq=as_tensor(beq, Q.device),
                   Aineq=as_tensor(Aineq, Q.device),
                   bineq=as_tensor(bineq, Q.device),
                   lb=as_tensor(lb, Q.device), ub=as_tensor(ub, Q.device))


@dataclasses.dataclass(frozen=True)
class QPSolution:
    """Solver result."""

    x: Tensor            # [n] primal solution
    y: Tensor            # [m] dual for the stacked constraint rows
    z: Tensor            # [m] slack (projection of Cx)
    status: Tensor       # int32 status code
    iterations: Tensor   # int32 ADMM iterations executed
    primal_residual: Tensor
    dual_residual: Tensor

    def inform(self) -> str:
        """Human-readable status: one solve's label, explanation and
        residuals, or a batch summary with the worst lanes named."""
        status = _np(self.status)
        rp = _np(self.primal_residual)
        rd = _np(self.dual_residual)
        iters = _np(self.iterations)
        if status.ndim == 0:
            code = int(status)
            label = STATUS_MESSAGES.get(code, f"unknown status {code}")
            expl = STATUS_EXPLANATIONS.get(code, "")
            msg = (f"{label} ({int(iters)} iterations, "
                   f"primal residual {float(rp):.3e}, "
                   f"dual residual {float(rd):.3e})")
            return f"{msg}: {expl}" if expl else msg
        total = status.size
        solved = int((status == STATUS_SOLVED).sum())
        parts = [f"{solved}/{total} solved"]
        for code, label in STATUS_MESSAGES.items():
            if code == STATUS_SOLVED:
                continue
            k = int((status == code).sum())
            if k:
                parts.append(f"{k} {label}")
        parts.append(f"worst primal residual {float(rp.max()):.3e}")
        parts.append(f"worst dual residual {float(rd.max()):.3e}")
        parts.append(f"max iterations {int(iters.max())}")
        worst = self.failed_lanes(3)
        if worst:
            rp_b = np.broadcast_to(rp, status.shape).reshape(-1)
            rd_b = np.broadcast_to(rd, status.shape).reshape(-1)
            st_b = status.reshape(-1)
            descr = ", ".join(
                f"lane {i} ({STATUS_MESSAGES.get(int(st_b[i]), '?')}, "
                f"prim {float(rp_b[i]):.2e}, dual {float(rd_b[i]):.2e})"
                for i in worst)
            parts.append(f"worst lanes: {descr}")
        return "; ".join(parts)

    def failed_lanes(self, k: int = 10) -> list:
        """Indices of the (up to) ``k`` worst non-converged lanes, ranked by
        their worst residual; ``[]`` when every lane solved."""
        status_full = _np(self.status)
        status = status_full.reshape(-1)
        rp = np.broadcast_to(_np(self.primal_residual),
                             status_full.shape).reshape(-1)
        rd = np.broadcast_to(_np(self.dual_residual),
                             status_full.shape).reshape(-1)
        bad = status != STATUS_SOLVED
        if not bad.any():
            return []
        score = np.where(bad, np.maximum(rp, rd), -np.inf)
        order = np.argsort(-score, kind="stable")
        return [int(i) for i in order[: max(0, int(k))] if bad[i]]


@dataclasses.dataclass(frozen=True)
class WarmStart:
    """ADMM warm-start state: previous ``(x, y, z)``."""

    x: Tensor
    y: Tensor
    z: Tensor


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration; field for field the reference's
    (``copra_tpu/qp/types.py``), where each field is documented.  The
    accurate plan step reads ``max_iter``, ``eps_abs``, ``eps_rel``,
    ``rho``, ``sigma``, ``alpha`` and ``kkt_refine``."""

    max_iter: int = 2000
    eps_abs: float = 1e-7
    eps_rel: float = 1e-7
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    check_interval: int = 10
    adaptive_rho: bool = True
    seed: str = "auto"
    rho_update_interval: int = 50
    polish: bool = True
    polish_delta: float = 1e-10
    polish_refine_steps: int = 3
    polish_iters: int = 0
    polish_active_rounds: int = 2
    early_exit: bool = True
    topup_iters: int = 0
    infeasibility_detection: bool = True
    eps_prim_inf: float = 1e-6
    eps_dual_inf: float = 1e-6
    kkt_solve: str = "auto"
    scaling: int = 3
    row_normalize: bool = True
    kkt_refine: int = -1
    max_wall_time_ms: Optional[float] = None
    print_level: int = 0

    def replace(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)
