"""Production serving on the PyTorch port: thousands of warm-started MPC
scenarios a step, split over the processes of a mesh.

The recipe of ``examples/batched_serving.py`` through ``copra_tpu_torch``:
one process per device joined by ``distributed_init``, the fleet placed on
a ``("batch",)`` mesh by ``shard_batch``, and a fixed-iteration,
warm-started step (``make_sharded_mpc_step``) whose health metrics are
all-reduced over the mesh.

Everything runs on the package's default device, the GPU; ``--device cpu``
runs it on the CPU (gloo).  Without torchrun's environment the script is a
world of one process.

Run:  PYTHONPATH=. python examples/torch_batched_serving.py [--device cpu]
or, with N devices on one host,
      PYTHONPATH=. torchrun --nproc-per-node=N \
          examples/torch_batched_serving.py
"""

import argparse
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

import copra_tpu_torch as tt
from copra_tpu_torch.parallel import (batch_axes, distributed_init,
                                      make_mesh, make_sharded_mpc_step,
                                      shard_batch)

BATCH, HORIZON = 1024, 50


def build_fleet(batch: int = BATCH, horizon: int = HORIZON):
    """The reference script's fleet: point masses under gravity (5 ms
    tick), each robot's ``A`` perturbed by 1e-4 (model error), its own
    initial state; float32 dynamics, a +-300 N force bound.  Returns
    ``(fleet, costs, constraints)`` on the default device."""
    dev = tt.default_device()
    T, mass = 0.005, 5.0
    A = np.array([[1.0, T], [0.0, 1.0]])
    B = np.array([[0.5 * T * T / mass], [T / mass]])
    d = np.array([-9.81 / 2 * T * T, -9.81 * T])

    rng = np.random.default_rng(0)
    As = np.repeat(np.repeat(A[None], horizon, 0)[None], batch, 0)
    As += rng.normal(scale=1e-4, size=As.shape)      # per-robot model error
    x0s = np.array([0.0, -1.5]) + rng.normal(scale=[0.02, 0.1],
                                             size=(batch, 2))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    fleet = tt.LTVSystem(
        A=f32(As),
        B=f32(np.repeat(np.repeat(B[None], horizon, 0)[None], batch, 0)),
        d=f32(np.repeat(np.repeat(d[None], horizon, 0)[None], batch, 0)),
        x0=f32(x0s))
    costs = (tt.TargetCost.create(np.eye(2), [0.0, -1.0],
                                  weights=[10.0, 1e4]),
             tt.ControlCost.create([[1.0]], [2.0], weights=[1e-4]))
    constraints = (tt.ControlBoundConstraint.create([-300.0], [300.0]),)
    return fleet, costs, constraints


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(batch: int = BATCH, horizon: int = HORIZON, device=None,
         record=None) -> dict:
    """Serve the fleet: a cold step, a warm one, then 5 timed warm steps.
    ``device`` sets the package's default device.  Joins the process group
    that exists, else torchrun's, else a world of one.  Returns the
    printed numbers; ``record``, a dict, receives the sharded fleet, the
    costs, constraints, options and step, and the cold step's result and
    stats."""
    if device is not None:
        tt.set_default_device(device)
    if not dist.is_initialized():
        if "RANK" in os.environ:
            distributed_init()
        else:
            distributed_init(f"127.0.0.1:{_free_port()}", 1, 0)
    fleet, costs, constraints = build_fleet(batch, horizon)
    options = tt.SolverOptions(max_iter=60)
    mesh = make_mesh()
    fleet = shard_batch(fleet, mesh, reference=batch_axes(fleet))
    step = make_sharded_mpc_step(mesh, costs, constraints, options)

    def sync(res):
        if res.control.device.type == "cuda":
            torch.cuda.synchronize(res.control.device)

    res, stats = step(fleet, None)               # cold start
    if record is not None:
        record.update(fleet=fleet, costs=costs, constraints=constraints,
                      options=options, step=step, cold=res, cold_stats=stats)
    warm = tt.WarmStart(x=res.solution.x, y=res.solution.y, z=res.solution.z)
    res, stats = step(fleet, warm)               # first warm step
    sync(res)

    K = 5                                        # steady state: the mean
    t0 = time.perf_counter()
    for _ in range(K):
        res, stats = step(fleet, warm)
        warm = tt.WarmStart(x=res.solution.x, y=res.solution.y,
                            z=res.solution.z)
    sync(res)
    dt = (time.perf_counter() - t0) / K

    out = {"devices": dist.get_world_size(), "batch": batch,
           "horizon": horizon, "warm_step_ms": dt * 1e3,
           "solves_per_s": batch / dt, "converged": int(stats["converged"]),
           "total": int(stats["total"]),
           "max_primal_residual": float(stats["max_primal_residual"])}
    if dist.get_rank() == 0:
        print(f"devices: {out['devices']}   batch: {batch}   N={horizon}")
        print(f"warm step: {out['warm_step_ms']:.1f} ms -> "
              f"{out['solves_per_s']:,.0f} solves/s")
        print(f"converged: {out['converged']}/{out['total']}   max primal "
              f"residual: {out['max_primal_residual']:.2e}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    main(device=parser.parse_args().device)
    dist.destroy_process_group()
