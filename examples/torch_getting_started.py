"""Getting started, on the PyTorch port: the reference's point-mass-under-
gravity problem.

The script of ``examples/getting_started.py`` through ``copra_tpu_torch``:
a 1-D point mass with a force input, driven to a target descent velocity
under a force cap and a no-upward-velocity bound, solved by the ``LMPC``
facade in float64.  It runs on the package's default device, the GPU;
``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=. python examples/torch_getting_started.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import copra_tpu_torch as tt

T, mass = 0.005, 5.0
A = np.array([[1.0, T], [0.0, 1.0]])
B = np.array([[0.5 * T * T / mass], [T / mass]])
d = np.array([-9.81 / 2 * T * T, -9.81 * T])   # gravity drift
x0 = np.array([0.0, -5.0])                     # start falling at 5 m/s


def main(horizon: int = 300, device=None):
    """Solve the problem over ``horizon`` steps on ``device`` (the
    package's default unless given); returns ``(X, U, controller)`` with
    the trajectory and controls as float64 numpy arrays."""
    dev = torch.device(device) if device is not None else tt.default_device()
    f64 = lambda a: torch.tensor(np.asarray(a, np.float64), device=dev)
    system = tt.LTISystem.create(f64(A), f64(B), f64(d), f64(x0),
                                 horizon=horizon)
    controller = tt.LMPC(system, options=tt.SolverOptions(
        max_iter=8000, eps_abs=1e-7, eps_rel=0.0))

    # drive velocity to -1 m/s, prefer small force
    controller.add_cost(tt.TargetCost.create(f64(np.eye(2)), f64([0.0, -1.0]),
                                             weights=f64([10.0, 1e4])))
    controller.add_cost(tt.ControlCost.create(f64([[1.0]]), f64([2.0]),
                                              weights=f64([1e-4])))
    # velocity may never be positive; force capped at 200 N
    controller.add_constraint(tt.TrajectoryBoundConstraint.create(
        f64([-np.inf, -np.inf]), f64([np.inf, 0.0])))
    controller.add_constraint(tt.ControlBoundConstraint.create(
        f64([-np.inf]), f64([200.0])))

    if not controller.solve():
        raise RuntimeError(controller.inform())
    X = controller.trajectory().cpu().numpy()
    U = controller.control().cpu().numpy()

    print(f"solved in {controller.solve_time() * 1e3:.1f} ms on {dev} "
          f"({controller.inform()})")
    print(f"terminal velocity: {X[-1]:+.4f} m/s (target -1)")
    print(f"max force used:    {U.max():.1f} N (cap 200)")
    print(f"max velocity:      {X[1::2].max():+.2e} m/s (must be <= 0)")
    return X, U, controller


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    parser.add_argument("--horizon", type=int, default=300)
    args = parser.parse_args()
    main(args.horizon, args.device)
