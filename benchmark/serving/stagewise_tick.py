"""The stagewise engine's serving tick: a fleet of ZMP preview problems
(both axes of every robot) behind ``make_stagewise_multistep(backend=
"fused")`` fed one tick a call from the state stream (``x0_seq`` of one
tick): each tick one CUDA graph replay, K4 and the top-up decided on the
device, so that the host's issue of a tick's ops does not set its latency.

``make_inputs`` builds the raw arrays the program and the reference both
get: the cart-table model and the footstep plan of the configuration.
"""

from __future__ import annotations

import numpy as np
import torch


def lanes(cfg: dict) -> int:
    return 2 * int(cfg["robots"])


def footstep_plan(cfg: dict):
    """Reference ZMP and its bounds for the axes (x, y), each ``[2, N +
    1]``: step ``i`` lasts ``duration`` seconds, lies ``i * length``
    ahead and alternates ``+-width`` sideways (the first step centred), the
    bounds ``margin`` either side."""
    f = cfg["footsteps"]
    T, N = float(cfg["T"]), int(cfg["horizon"])
    per_step = int(round(float(f["duration"]) / T))
    ref = np.zeros((2, N + 1))
    for k in range(N + 1):
        idx = min(k // per_step, int(f["count"]) - 1)
        ref[0, k] = idx * float(f["length"])
        ref[1, k] = (float(f["width"]) if idx % 2 else -float(f["width"])) \
            if idx > 0 else 0.0
    m = float(f["margin"])
    return ref, ref - m, ref + m


def _cart_table(cfg: dict):
    """``(A, B, zmp_row)`` of one axis, float64: the state ``(c, c', c'')``
    under the jerk over one model step, and the ZMP ``c - (h / g) c''``."""
    T, h, g = float(cfg["T"]), float(cfg["com_height"]), float(cfg["gravity"])
    A = np.array([[1.0, T, T * T / 2.0], [0.0, 1.0, T], [0.0, 0.0, 1.0]])
    B = np.array([[T ** 3 / 6.0], [T * T / 2.0], [T]])
    return A, B, np.array([1.0, 0.0, -h / g])


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """The cart-table model of one axis (``A``, ``B``, ``d``, the ZMP row
    ``zmp_row``) and the footstep plan (``ref``, ``lo``, ``hi``), float32.
    Nothing here depends on the seed: the traffic's states do."""
    A, B, zr = _cart_table(cfg)
    ref, lo, hi = footstep_plan(cfg)
    arrays = dict(A=A, B=B, d=np.zeros(3), zmp_row=zr, ref=ref, lo=lo, hi=hi)
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in arrays.items()}


def plant(cfg: dict) -> dict:
    """One lane's plant for the traffic (``benchmark/traffic.py``): the
    cart-table model at the model step, the configuration's ZMP and jerk
    weights as the plain controller's cost, the column through which a
    force on the CoM held for one step enters (``(T^2/2, T, 0)`` per
    m/s^2) and that of a CoM velocity step (``(0, 1, 0)`` per m/s)."""
    T = float(cfg["T"])
    A, B, zr = _cart_table(cfg)
    return dict(A=A, B=B, Q=float(cfg["zmp_weight"]) * np.outer(zr, zr),
                R=np.array([[float(cfg["jerk_weight"])]]),
                force=np.array([T * T / 2.0, T, 0.0]),
                velocity=np.array([0.0, 1.0, 0.0]), step_s=T)


class Served:
    """``call(x0 [B, 3]) -> U [B, N]``: one tick of the fleet, the warm
    start carried from tick to tick (the first call runs the cold budget,
    then captures the tick's graph)."""

    def __init__(self, cfg: dict, raw: dict, center: torch.Tensor):
        import copra_tpu_torch as tt
        from copra_tpu_torch.qp.riccati import (from_mpc,
                                                make_stagewise_multistep,
                                                stack_stagewise)

        N = int(cfg["horizon"])
        dev = raw["A"].device
        f32 = dict(dtype=torch.float32, device=dev)
        Z = torch.kron(torch.eye(N + 1, **f32), raw["zmp_row"][None])
        system = tt.LTISystem.create(raw["A"], raw["B"], raw["d"],
                                     torch.zeros(3, **f32), N)

        def axis(ax):
            costs = (tt.TrajectoryCost(
                M=Z, p=raw["ref"][ax],
                weights=torch.full((N + 1,), float(cfg["zmp_weight"]), **f32)),
                tt.SimpleControlCost(
                    p=torch.zeros(N, **f32),
                    weights=torch.full((N,), float(cfg["jerk_weight"]),
                                       **f32)))
            constraints = (tt.TrajectoryConstraint(E=Z, f=raw["hi"][ax]),
                           tt.TrajectoryConstraint(E=-Z, f=-raw["lo"][ax]))
            return from_mpc(system, costs, constraints)

        fleet = stack_stagewise([axis(0), axis(1)],
                                repeats=int(cfg["robots"]))
        cold = tt.SolverOptions(max_iter=int(cfg["cold_iterations"]),
                                early_exit=False, polish=False,
                                eps_abs=float(cfg["eps_abs"]),
                                rho=float(cfg["rho"]))
        warm = cold.replace(max_iter=int(cfg["warm_iterations"]),
                            topup_iters=int(cfg["topup_iterations"]))
        self.step = make_stagewise_multistep(fleet, warm, cold_options=cold,
                                             backend="fused")
        self.warm = None

    def call(self, x0: torch.Tensor) -> torch.Tensor:
        # the tick's info carries its whole plan: x is U [B, N] (u = 1)
        _, _, _, info, self.warm = self.step(None, 1, warm=self.warm,
                                             x0_seq=x0[None])
        return info.x
