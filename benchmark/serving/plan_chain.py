"""The condensed engine's chained serving path: a fleet of per-lane LTV
point-mass problems behind ``make_plan_multistep``, T accurate ticks a
call, one CUDA graph a call on the card.

``make_inputs`` draws the raw arrays the program and the reference both
get; ``Served`` builds the program's serving entry from them and calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.traffic import generator


def lanes(cfg: dict) -> int:
    return int(cfg["lanes"])


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """``A [B, N, 2, 2]``, ``B [B, N, 2, 1]``, ``d [B, N, 2]`` in float32:
    the point mass of ``cfg`` (step ``T``, mass, gravity) with every entry
    of every lane's A perturbed by ``N(0, A_perturbation)``."""
    T, m, g = float(cfg["T"]), float(cfg["mass"]), float(cfg["gravity"])
    L, N = lanes(cfg), int(cfg["horizon"])
    f64 = dict(dtype=torch.float64, device=device)
    A = torch.tensor([[1.0, T], [0.0, 1.0]], **f64).expand(L, N, 2, 2)
    A = A + float(cfg["A_perturbation"]) * torch.randn(
        (L, N, 2, 2), generator=generator(seed, 20, device), **f64)
    B = torch.tensor([[0.5 * T * T / m], [T / m]], **f64).expand(L, N, 2, 1)
    d = torch.tensor([-g / 2.0 * T * T, -g * T], **f64).expand(L, N, 2)
    return {k: v.to(torch.float32).contiguous()
            for k, v in (("A", A), ("B", B), ("d", d))}


class Served:
    """``call(x0_seq [T, B, 2]) -> U [T, B, N]``: T ticks of the fleet, the
    warm start carried from call to call.  ``center`` (the lanes' states
    at build time) seeds the plan's f64 seed map and ``auto_rho``."""

    def __init__(self, cfg: dict, raw: dict, center: torch.Tensor):
        import copra_tpu_torch as tt

        c = cfg["control_cost"]
        t = cfg["target"]
        bound = float(cfg["control_bound"])
        system = tt.LTVSystem(raw["A"], raw["B"], raw["d"],
                              center.to(torch.float32))
        costs = (tt.TargetCost.create(np.asarray(t["M"], np.float64),
                                      t["p"], weights=t["weights"]),
                 tt.ControlCost.create(np.asarray(c["N"], np.float64),
                                       c["p"], weights=c["weights"]))
        constraints = (tt.ControlBoundConstraint.create([-bound], [bound]),)
        plan = tt.make_control_plan(system, costs, constraints)
        opts = tt.SolverOptions(max_iter=int(cfg["admm_iterations"]),
                                early_exit=False, polish=False, rho=1.0,
                                kkt_refine=0)
        rounds = int(cfg["accurate_rounds"])
        x0s = center.double().cpu().numpy()
        rho = tt.auto_rho(plan, x0s, opts, seed_center=x0s, accurate=True,
                          accurate_rounds=rounds)
        self.rho = float(rho)
        self.step_many = tt.make_plan_multistep(
            plan, opts.replace(rho=rho), seed_center=x0s,
            accurate_rounds=rounds)
        self.warm = None

    def call(self, x0_seq: torch.Tensor) -> torch.Tensor:
        U, _, _, self.warm = self.step_many(x0_seq, self.warm)
        return U
