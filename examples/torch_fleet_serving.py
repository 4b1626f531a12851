"""Production fleet serving on the PyTorch port: measured rho, one-call
tick chains, honest statuses.

The serving recipe of ``examples/fleet_serving.py`` through
``copra_tpu_torch`` on a small double-integrator fleet:

1. build the stagewise problem once (``from_mpc``), stack it per lane;
2. let the MEASURED policy pick the ADMM penalty (``auto_rho_stagewise``
   probes the real serving step on sampled fleet lanes against the exact
   f64 oracle -- no hand-tuned constants);
3. serve the whole control loop in ONE call per horizon-of-ticks
   (``make_stagewise_multistep``: the plant inside the loop; on the GPU
   the ticks are one CUDA graph of stagewise tick kernels);
4. trust the statuses: they are per tick, per lane, and honest.

Everything runs on the package's default device, the GPU; ``--device
cpu`` runs it on the CPU.

Run:  PYTHONPATH=. python examples/torch_fleet_serving.py [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

import copra_tpu_torch as tt
from copra_tpu_torch.profiling import timed
from copra_tpu_torch.qp.riccati import (auto_rho_stagewise, from_mpc,
                                        make_stagewise_multistep,
                                        stack_stagewise)


def main(device=None, rho=None, record=None, ticks: int = 50):
    """Serve two chains of ``ticks`` ticks; returns ``(statuses, states,
    converged share)`` of the first chain.  ``rho`` given skips the
    measured policy's probes.  ``record``, a dict, receives each chain's
    host seconds (``"chain_s"``), the chain facade (``"tick"``) and the
    state and warm tuple the second chain starts from (``"x0"``,
    ``"warm"``)."""
    dev = torch.device(device) if device is not None else tt.default_device()
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)

    # --- model: point mass under gravity, 5 ms tick -------------------
    T, mass, g = 0.005, 5.0, 9.81
    A = np.array([[1.0, T], [0.0, 1.0]], np.float32)
    B = np.array([[0.5 * T * T / mass], [T / mass]], np.float32)
    d = np.array([-g / 2.0 * T * T, -g * T], np.float32)
    N = 12

    system = tt.LTISystem.create(f32(A), f32(B), f32(d), f32(np.zeros(2)), N)
    costs = (tt.TargetCost.create(f32(np.eye(2)), f32([0.0, -1.0]),
                                  weights=f32([10.0, 1e4])),
             tt.ControlCost.create(f32([[1.0]]), f32([2.0]),
                                   weights=f32([1e-4])))
    cons = (tt.ControlBoundConstraint.create(f32([-150.0]), f32([150.0])),)

    # --- fleet: one problem per robot, per-lane states ----------------
    robots = 16
    sqp = from_mpc(system, costs, cons)
    fleet = stack_stagewise([sqp], repeats=robots)
    rng = np.random.default_rng(0)
    x0s = f32(rng.normal(scale=[0.05, 0.5], size=(robots, 2))
              .astype(np.float32) + np.float32([0.0, -1.5]))
    fleet = dataclasses.replace(fleet, x0=x0s)

    # --- measured serving penalty --------------------------------------
    opts = tt.SolverOptions(max_iter=120, early_exit=False)
    if rho is None:
        rho, probe = auto_rho_stagewise(fleet, opts, probe_lanes=4,
                                        return_probe=True)
        print("auto_rho_stagewise picked rho =", rho,
              "(probe gate errs:",
              {k: float(f"{v:.2g}") for k, v in probe.items()}, ")")
    opts = opts.replace(rho=rho)

    # --- one-call closed loop ------------------------------------------
    step_many = make_stagewise_multistep(fleet, opts)
    record = {} if record is None else record
    box = {}
    with timed(box, block_on=x0s):
        states, u0s, statuses, info, warm = step_many(x0s, ticks)
    record.update(chain_s=[box["seconds"]], tick=step_many,
                  x0=states[-1], warm=warm)
    print(f"{ticks} ticks x {robots} robots in one call on {dev}")
    print("final tick:", info.inform())
    conv = float((statuses == tt.STATUS_SOLVED).double().mean())
    print(f"per-tick/per-lane converged fraction: {conv:.4f}")
    vel = states[:, 0, 1].cpu().numpy()
    print("robot 0 velocity: start %.3f -> end %.3f (target -1.0)"
          % (vel[0], vel[-1]))

    # keep serving: thread the warm state into the next chain
    with timed(box, block_on=x0s):
        states2, u0s2, statuses2, info2, warm = step_many(
            states[-1], ticks, warm=warm)
    record["chain_s"].append(box["seconds"])
    print("next chain final tick:", info2.inform())
    return statuses, states, conv


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    main(parser.parse_args().device)
