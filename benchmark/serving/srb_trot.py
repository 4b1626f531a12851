"""The trotting SRB quadruped fleet under convex MPC rebuilt every tick:
``make_stagewise_multistep(backend="fused").serve`` fed one tick a call
from the state stream, with the program's SRB linearisation
(``copra_tpu_torch.srb.linearise``) as the tick's ``problem``.  Each tick is
one CUDA graph replay: the QP re-linearised at the tick's states, the
Riccati gains refactored on the device (``csrc/riccati_gains.cu``), then
K5 and the top-up decided on the device.

``make_inputs`` draws each robot's gait phase from the seed: the raw data
the program and the reference both get.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.traffic import _rng


def lanes(cfg: dict) -> int:
    return int(cfg["robots"])


def period_steps(cfg: dict) -> int:
    return int(round(float(cfg["gait"]["period_s"]) / float(cfg["dt"])))


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """Each robot's gait phase, ``phase [robots]`` (int64, whole steps into
    the gait's period), drawn from the seed and fixed for the run."""
    phase = _rng(seed, 21).integers(0, period_steps(cfg), lanes(cfg))
    return {"phase": torch.tensor(phase, dtype=torch.int64, device=device)}


def _model(cfg: dict, phase, device, dtype=torch.float32):
    from copra_tpu_torch import srb

    if [tuple(f) for f in cfg["feet"]] != list(srb.FEET) or \
            [tuple(p) for p in cfg["gait"]["pairs"]] != list(srb.PAIRS):
        raise ValueError("the configuration's feet or gait pairs are not "
                         "the program's SRB model's")
    return srb.TrotModel.create(
        phase, N=int(cfg["horizon"]), dt=float(cfg["dt"]),
        mass=float(cfg["mass"]), inertia=cfg["inertia"],
        w=cfg["state_weights"], terminal=float(cfg["terminal_factor"]),
        r=float(cfg["force_weight"]), height=float(cfg["height"]),
        period_s=float(cfg["gait"]["period_s"]),
        duty=float(cfg["gait"]["duty"]), gravity=float(cfg["gravity"]),
        dtype=dtype, device=device)


def _box(cfg: dict) -> dict:
    return dict(mu=float(cfg["mu"]), fz_max=float(cfg["fz_max"]),
                tilt=float(cfg["tilt"]), height_range=cfg["height_range"])


def plant(cfg: dict) -> dict:
    """One robot's plant for the traffic (``benchmark/traffic.py``), in
    numpy: the SRB at the nominal stance (yaw 0, all four feet down) over
    one forward Euler step of ``dt``, the configuration's weights as the
    plain controller's cost, the column through which a horizontal
    acceleration at 45 degrees held for one step enters (``dt`` on the two
    horizontal velocities, per m/s^2) and that of a forward velocity
    step."""
    dt, m = float(cfg["dt"]), float(cfg["mass"])
    A = np.eye(12)
    A[0:3, 6:9] += dt * np.eye(3)
    A[3:6, 9:12] += dt * np.eye(3)
    Ib_inv = np.linalg.inv(np.diag(cfg["inertia"]))
    B = np.zeros((12, 12))
    for leg, (x, y, z) in enumerate(cfg["feet"]):
        cross = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
        B[6:9, 3 * leg:3 * leg + 3] = dt * Ib_inv @ cross
        B[9:12, 3 * leg:3 * leg + 3] = dt / m * np.eye(3)
    force = np.zeros(12)
    force[9] = force[10] = dt / np.sqrt(2.0)
    velocity = np.zeros(12)
    velocity[9] = 1.0
    return dict(A=A, B=B, Q=np.diag(cfg["state_weights"]),
                R=float(cfg["force_weight"]) * np.eye(12), force=force,
                velocity=velocity, step_s=dt)


class Served:
    """``call(x0 [B, 12]) -> U [B, N * 12]``: one tick of the fleet, its QP
    re-linearised at ``x0``, the warm start carried from tick to tick (the
    first call runs the cold budget, then captures the tick's graph)."""

    def __init__(self, cfg: dict, raw: dict, center: torch.Tensor):
        import copra_tpu_torch as tt
        from copra_tpu_torch import srb
        from copra_tpu_torch.qp.riccati import (make_stagewise_multistep,
                                                stagewise_scales)

        dev = center.device
        model = _model(cfg, raw["phase"], dev)
        sqp = srb.trot_qp(model, center, **_box(cfg))
        nominal = torch.tensor([cfg["x0_nominal"]], dtype=torch.float32,
                               device=dev)
        scales = stagewise_scales(srb.trot_qp(srb.stance_model(model),
                                              nominal, **_box(cfg)))
        cold = tt.SolverOptions(max_iter=int(cfg["cold_iterations"]),
                                early_exit=False, polish=False,
                                eps_abs=float(cfg["eps_abs"]),
                                rho=float(cfg["rho"]))
        warm = cold.replace(max_iter=int(cfg["warm_iterations"]),
                            topup_iters=int(cfg["topup_iterations"]))
        self.step = make_stagewise_multistep(
            sqp, warm, cold_options=cold, backend="fused", scaling=scales,
            problem=lambda x0: srb.linearise(model, x0))

    def call(self, x0: torch.Tensor) -> torch.Tensor:
        # one tick, the warm state kept inside the chain: U [B, N * 12]
        return self.step.serve(x0)
