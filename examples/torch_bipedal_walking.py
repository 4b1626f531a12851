"""Bipedal walking on the PyTorch port: CoM preview control with ZMP
constraints (LIPM).

The problem of ``examples/bipedal_walking.py`` through ``copra_tpu_torch``:
a linear inverted pendulum tracks a reference ZMP trajectory over an N=300
preview horizon while keeping the realized ZMP inside the moving support
polygon:

* state ``x = [c, cdot, cddot]`` per horizontal axis, control ``u = jerk``;
* triple-integrator dynamics ``A/B`` over sampling period ``T``;
* ZMP output row ``z = c - (h/g) cddot``;
* ZMP tracking as a full-size ``TrajectoryCost``, jerk smoothing as a
  ``SimpleControlCost``;
* the support polygon as a full-size ``TrajectoryConstraint`` pair.

Both horizontal axes are stacked into one batch of two lanes
(``stack_stagewise``) and solved together; on the GPU the early-exit solve
runs on the stagewise tick kernel.  ``serve_fleet`` is the serving pattern:
a fleet of robots, receding horizon, warm-started ticks of the no-knobs
server.  Everything runs on the package's default device, the GPU;
``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=. python examples/torch_bipedal_walking.py [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import copra_tpu_torch as tt
from copra_tpu_torch.profiling import timed
from copra_tpu_torch.qp.riccati import from_mpc

GRAVITY = 9.81


def lipm_system(T: float, com_height: float):
    """Triple-integrator per-axis dynamics + ZMP output row."""
    A = np.array([[1.0, T, T * T / 2.0],
                  [0.0, 1.0, T],
                  [0.0, 0.0, 1.0]])
    B = np.array([[T ** 3 / 6.0], [T * T / 2.0], [T]])
    d = np.zeros(3)
    zmp_row = np.array([[1.0, 0.0, -com_height / GRAVITY]])
    return A, B, d, zmp_row


def footstep_plan(n_steps: int, horizon: int, T: float,
                  step_length: float = 0.2, step_width: float = 0.1,
                  step_duration: float = 0.8, margin: float = 0.05):
    """Reference ZMP per tick + support-polygon bounds for both axes.

    Returns ``(zmp_ref[2, H+1], zmp_min[2, H+1], zmp_max[2, H+1])`` for
    axes (x, y): the ZMP reference jumps to each new footstep location; the
    polygon is a box of ±margin around it.
    """
    ticks = horizon + 1
    per_step = int(round(step_duration / T))
    ref = np.zeros((2, ticks))
    for k in range(ticks):
        idx = min(k // per_step, n_steps - 1)
        ref[0, k] = idx * step_length
        ref[1, k] = (step_width if idx % 2 else -step_width) \
            if idx > 0 else 0.0
    lo = ref - margin
    hi = ref + margin
    return ref, lo, hi


def _axis_problems(horizon: int, T: float, com_height: float, dtype,
                   device):
    """The per-axis stagewise problems, stacked as lanes (x, y), and the
    full-horizon ZMP map ``Zfull`` (float64 numpy)."""
    dev = torch.device(device) if device is not None else tt.default_device()
    ten = lambda a: torch.tensor(np.asarray(a, dtype), device=dev)
    A, B, d, zmp_row = lipm_system(T, com_height)
    ref, lo, hi = footstep_plan(n_steps=4, horizon=horizon, T=T)
    Zfull = tt.span_matrix(torch.tensor(zmp_row), horizon + 1).numpy()
    Z = ten(Zfull)
    base = tt.LTISystem(A=ten(A), B=ten(B), d=ten(d), x0=ten(np.zeros(3)),
                        horizon=horizon)

    def axis_sqp(ax):
        costs = (tt.TrajectoryCost(M=Z, p=ten(ref[ax]),
                                   weights=ten(np.ones(horizon + 1))),
                 tt.SimpleControlCost(p=ten(np.zeros(horizon)),
                                      weights=ten(np.full(horizon, 1e-6))))
        constraints = (tt.TrajectoryConstraint(E=Z, f=ten(hi[ax])),
                       tt.TrajectoryConstraint(E=-Z, f=ten(-lo[ax])))
        return from_mpc(base, costs, constraints)

    return [axis_sqp(0), axis_sqp(1)], Zfull, (ref, lo, hi)


def solve_preview(horizon: int = 300, T: float = 0.005,
                  com_height: float = 0.8,
                  options: tt.SolverOptions = tt.SolverOptions(max_iter=3000),
                  device=None):
    """One batched preview solve for both horizontal axes, in float64.

    Returns ``(X[2,(H+1)*3], U[2,H], zmp[2,H+1], (ref, lo, hi), sol)``.
    """
    # the stagewise engine is the documented config-5 path: O(N) per
    # iteration with per-stage polygon rows
    sqps, Zfull, plan = _axis_problems(horizon, T, com_height, np.float64,
                                       device)
    X, U, sol = tt.solve_stagewise(tt.stack_stagewise(sqps), options)
    X = X.reshape(2, -1)
    U = U.reshape(2, -1)
    # diagnostic on the HOST in float64: an f32 product on the card outside
    # the package's precision guard may run TF32 and report a phantom
    # polygon violation
    zmp = X.detach().cpu().numpy().astype(np.float64) @ Zfull.T
    return X, U, zmp, plan, sol


def serve_fleet(robots: int = 4, horizon: int = 300, T: float = 0.005,
                com_height: float = 0.8, ticks: int = 3, device=None,
                record=None):
    """The production serving pattern: a fleet of robots, receding
    horizon, warm-started stagewise ticks in float32.

    ``make_stagewise_server`` measures rho, the warm budget and the
    equilibration; on the GPU each tick runs the stagewise tick kernel.
    ``record``, a dict, receives each tick's host seconds (``"tick_s"``,
    the cold tick first), the server (``"tick"``) and the state and warm
    tuple its next tick would take (``"x0"``, ``"warm"``).
    """
    sqps, _, _ = _axis_problems(horizon, T, com_height, np.float32, device)
    fleet = tt.stack_stagewise(sqps, repeats=robots)
    # no-knobs serving: rho / warm budget / equilibration all MEASURED
    tick = tt.make_stagewise_server(fleet)
    record = {} if record is None else record
    record["tick_s"] = []

    def timed_tick(x0, warm=None):
        box = {}
        with timed(box, block_on=x0):
            out = tick(x0, warm)
        record["tick_s"].append(box["seconds"])
        return out

    lanes = 2 * robots
    x0 = torch.zeros((lanes, 3), dtype=torch.float32,
                     device=fleet.A.device)
    X, U, info, warm = timed_tick(x0)                # cold start
    for _ in range(ticks):                           # receding ticks
        x0 = X[:, 1]                                 # step the plant
        X, U, info, warm = timed_tick(x0, warm)
    record.update(tick=tick, x0=X[:, 1], warm=warm)
    return X, U, info


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args()
    X, U, zmp, (ref, lo, hi), sol = solve_preview(device=args.device)
    print("status:", sol.status.tolist())
    print("zmp tracking err (x):", np.abs(zmp[0] - ref[0]).max())
    print("zmp in polygon:", bool((zmp <= hi + 1e-6).all()
                                  and (zmp >= lo - 1e-6).all()))
    print("final CoM x:", float(X[0, -3]))
    Xf, Uf, info = serve_fleet(device=args.device)
    status = info.status.cpu().numpy()
    print("fleet receding ticks:", status, "converged:",
          bool((status == 0).all()))
