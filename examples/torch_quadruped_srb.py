"""Quadruped single-rigid-body MPC on the PyTorch port.

The workload of ``examples/quadruped_srb.py`` through ``copra_tpu_torch``:
x=12 states (rpy, position, angular rate, velocity), u=12 ground-reaction
forces (3-D per leg), 16 friction-cone rows per stage (all four pyramid
faces), LTV dynamics over the gait (footholds move with phase), built
from the public front end:

* ``LTVSystem`` with per-stage ``A_k/B_k/d_k`` (the torque arm follows the
  gait phase);
* per-step ``TrajectoryCost`` tracking a stand-height + forward-velocity
  reference, ``SimpleControlCost`` force regularization;
* ``ControlConstraint`` friction pyramids (``|f_x|, |f_y| <= mu f_z``),
  ``ControlBoundConstraint`` force boxes (normal force >= 0),
  ``TrajectoryBoundConstraint`` attitude/height corridor;
* serving: ``make_stagewise_server`` (measured equilibration, rho and warm
  budget), or ``make_stagewise_step`` with ``rho``/``warm_iters`` given.
  On the GPU each tick runs the stagewise tick kernel with the plan
  streamed (x = 12 takes the streamed entry point).

Everything runs on the package's default device, the GPU; ``--device cpu``
runs it on the CPU.

Run:  PYTHONPATH=. python examples/torch_quadruped_srb.py [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import copra_tpu_torch as tt
from copra_tpu_torch.profiling import timed
from copra_tpu_torch.qp.riccati import (from_mpc, make_stagewise_server,
                                        make_stagewise_step, stack_stagewise,
                                        stagewise_scales)

GRAVITY = 9.81


def _f32(device):
    dev = torch.device(device) if device is not None else tt.default_device()
    return lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)


def srb_gait_system(N: int = 40, dt: float = 0.025, mass: float = 25.0,
                    height: float = 0.3, device=None):
    """LTV single-rigid-body dynamics over one gait cycle.

    State ``[rpy, p, omega, v]`` (12), control = stacked per-leg ground
    reaction forces (12).  The torque arm of each leg's force follows
    the gait phase, so ``B_k`` is time-varying.
    """
    Ibinv = np.linalg.inv(np.diag([0.35, 1.2, 1.3]))
    Ac = np.zeros((12, 12))
    Ac[0:3, 6:9] = np.eye(3)
    Ac[3:6, 9:12] = np.eye(3)
    Ad = np.eye(12) + Ac * dt
    feet0 = np.array([[0.22, 0.15, -height], [0.22, -0.15, -height],
                      [-0.22, 0.15, -height], [-0.22, -0.15, -height]])
    Bs = []
    for k in range(N):
        phase = 2 * np.pi * k / N
        Bk = np.zeros((12, 12))
        for leg in range(4):
            r_i = feet0[leg] + np.array(
                [0.04 * np.sin(phase + leg * np.pi / 2), 0.0, 0.0])
            rx = np.array([[0, -r_i[2], r_i[1]],
                           [r_i[2], 0, -r_i[0]],
                           [-r_i[1], r_i[0], 0]])
            Bk[6:9, 3 * leg:3 * leg + 3] = Ibinv @ rx * dt
            Bk[9:12, 3 * leg:3 * leg + 3] = np.eye(3) / mass * dt
        Bs.append(Bk)
    d = np.zeros(12)
    d[11] = -GRAVITY * dt
    # start standing at rest (the height corridor includes x_0 -- a
    # grounded start would be reported primal-infeasible, honestly)
    x0 = np.zeros(12, np.float32)
    x0[5] = height
    f32 = _f32(device)
    return tt.LTVSystem.create(f32([Ad] * N), f32(Bs),
                               f32(np.repeat(d[None], N, 0)), f32(x0))


def build_problem(N: int = 40, dt: float = 0.025, mu: float = 0.6,
                  v_ref: float = 0.4, height: float = 0.3, device=None):
    """Public-front-end costs + constraints for the SRB workload."""
    f32 = _f32(device)
    system = srb_gait_system(N, dt, height=height, device=device)

    x_ref = np.zeros(12, np.float32)
    x_ref[5] = height
    x_ref[9] = v_ref
    w = np.array([50.0, 50, 10, 10, 10, 100, 1, 1, 1, 5, 5, 5],
                 np.float32)
    # per-step TrajectoryCost: M = I (12x12), reference x_ref; weights
    # enter the quadratic form linearly (sum_i w_i (M x - p)_i^2)
    costs = (
        tt.TrajectoryCost(M=f32(np.eye(12)), p=f32(x_ref), weights=f32(w)),
        tt.SimpleControlCost(p=f32(np.zeros(12)),
                             weights=f32(np.full(12, 1e-5))),
    )

    # friction pyramids, per step: all FOUR faces per leg
    # (+/-fx - mu fz <= 0, +/-fy - mu fz <= 0) -- 16 rows
    G = np.zeros((16, 12), np.float32)
    for leg in range(4):
        r0, c0 = 4 * leg, 3 * leg
        G[r0 + 0, c0 + 0], G[r0 + 0, c0 + 2] = 1.0, -mu
        G[r0 + 1, c0 + 0], G[r0 + 1, c0 + 2] = -1.0, -mu
        G[r0 + 2, c0 + 1], G[r0 + 2, c0 + 2] = 1.0, -mu
        G[r0 + 3, c0 + 1], G[r0 + 3, c0 + 2] = -1.0, -mu
    xlb = np.full(12, -np.inf, np.float32)
    xub = np.full(12, np.inf, np.float32)
    xlb[0:3], xub[0:3] = -0.4, 0.4          # attitude envelope
    xlb[5], xub[5] = 0.2, 0.4               # height corridor
    constraints = (
        tt.ControlConstraint(G=f32(G), f=f32(np.zeros(16))),
        tt.ControlBoundConstraint.create(
            f32([-150.0, -150.0, 0.0] * 4), f32([150.0, 150.0, 250.0] * 4)),
        tt.TrajectoryBoundConstraint.create(f32(xlb), f32(xub)),
    )
    return system, costs, constraints, x_ref


def serve(robots: int = 4, N: int = 40, ticks: int = 5,
          warm_iters=None, rho=None, verbose: bool = True, device=None,
          record=None):
    """Receding-horizon fleet serving, NO solver knobs.

    ``make_stagewise_server`` measures everything (equilibration, rho,
    warm budget) and arms the convergence top-up; ``rho``/``warm_iters``
    override the probes (tests pass both to skip the probe cost).
    ``record``, a dict, receives each tick's host seconds (``"tick_s"``,
    the cold tick first), the server (``"tick"``) and the state and warm
    tuple its next tick would take (``"x0"``, ``"warm"``)."""
    system, costs, constraints, x_ref = build_problem(N, device=device)
    sqp = from_mpc(system, costs, constraints)
    fleet = stack_stagewise([sqp], repeats=robots)

    if rho is None or warm_iters is None:
        # no-knobs path: one call, all policies measured
        tick, policy = make_stagewise_server(fleet, return_policy=True)
        warm_iters = policy["warm_iters"]
    else:
        # explicit override path (tests: skip the probe cost)
        opts = tt.SolverOptions(max_iter=300, early_exit=False,
                                polish=False, eps_abs=1e-4, rho=float(rho))
        tick = make_stagewise_step(
            fleet, opts.replace(max_iter=int(warm_iters)),
            cold_options=opts, scaling=stagewise_scales(sqp))

    record = {} if record is None else record
    record["tick_s"] = []

    def timed_tick(x0, warm=None):
        box = {}
        with timed(box, block_on=x0):
            out = tick(x0, warm)
        record["tick_s"].append(box["seconds"])
        return out

    x0 = system.x0.expand(robots, 12).clone()
    X, U, info, warm = timed_tick(x0)               # cold start
    for t in range(ticks):
        x0 = X[:, 1]                                 # plant step
        X, U, info, warm = timed_tick(x0, warm)
        if verbose:
            print(f"tick {t}: statuses {info.status.tolist()}, "
                  f"height {float(X[0, 1, 5]):+.3f}, "
                  f"v_x {float(X[0, 1, 9]):+.3f}")
    record.update(tick=tick, x0=X[:, 1], warm=warm)
    return X, U, info, warm_iters


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args()
    X, U, info, wi = serve(device=args.device)
    forces = U[0, 0].reshape(4, 3).cpu().numpy()
    print(f"warm iters (measured): {wi}")
    print("applied per-leg forces [N]:")
    for leg, f in enumerate(forces):
        print(f"  leg {leg}: fx {f[0]:+7.2f}  fy {f[1]:+7.2f} "
              f" fz {f[2]:+7.2f}")
    print("all lanes converged:",
          bool((info.status == tt.STATUS_SOLVED).all()))
