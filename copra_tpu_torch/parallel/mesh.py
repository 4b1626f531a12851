"""Device meshes, placements and the multi-process solve path.

Port of ``copra_tpu/parallel/mesh.py`` on ``torch.distributed``: one
process per device, a :class:`~torch.distributed.device_mesh.DeviceMesh`
over the processes with named axes, the scenario batch placed as DTensors
(``Shard(0)`` along the batch axis, ``Replicate()`` elsewhere), and the
serving step whose batch statistics are all-reduced over the batch axis
(NCCL between GPUs, gloo on the CPU).

Where the reference lets GSPMD partition one program
(``with_sharding_constraint``), each rank here solves its own rows with
:func:`~copra_tpu_torch.parallel.batch.solve_mpc_batch` on plain local
tensors: scenario parallelism needs no communication inside the solve, so
no DTensor reaches the solver.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .._graph import tree_map
from .._tensors import default_device, resolve_device
from ..constraints import Constraint
from ..costs import CostFunction
from ..mpc import MPCResult
from ..qp.types import SolverOptions, WarmStart
from ..systems import System
from . import _collectives as coll
from .batch import batch_axes, solve_mpc_batch, warm_start_axes

BATCH_AXIS = "batch"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join this process to the process group.

    ``coordinator_address`` (``"host:port"``), ``num_processes`` and
    ``process_id`` are the reference's arguments; each one not given is
    read from torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``), and a value found in neither raises.  The
    backend follows the package's default device: NCCL with this rank's
    GPU (``LOCAL_RANK``, else the rank modulo the visible GPUs) for
    ``cuda``, gloo for ``cpu``.
    """
    dev = resolve_device()
    if coordinator_address is None and "MASTER_ADDR" in os.environ \
            and "MASTER_PORT" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    world = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None or world is None or rank is None:
        raise ValueError(
            "distributed_init needs the coordinator address, the number of "
            "processes and this process's id: pass coordinator_address, "
            "num_processes and process_id, or run under torchrun "
            "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    kw = dict(init_method=f"tcp://{coordinator_address}", world_size=world,
              rank=rank)
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        local = rank % torch.cuda.device_count() if local is None else local
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local),
                                **kw)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", **kw)
    else:
        raise ValueError(f"distributed_init runs on cuda (NCCL) or cpu "
                         f"(gloo), not {dev.type}")


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = (BATCH_AXIS,),
              devices=None) -> DeviceMesh:
    """A mesh over the processes (``devices``: the ranks to use, all by
    default), one device each; the default shape is the 1-D ``("batch",)``
    mesh, scenario parallelism being the natural split of batched MPC.
    ``shape`` may hold one ``-1``.  Every rank of the group calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "copra_tpu_torch.parallel.distributed_init first")
    ranks = np.arange(dist.get_world_size()) if devices is None \
        else np.asarray(devices)
    if shape is None:
        shape = (ranks.size,) + (1,) * (len(axis_names) - 1)
    return DeviceMesh(default_device().type, ranks.reshape(shape).tolist(),
                      mesh_dim_names=tuple(axis_names))


def batch_sharding(mesh: DeviceMesh, axis: str = BATCH_AXIS) -> list:
    """The placements that split the leading (scenario) dimension over
    ``axis`` and replicate over the other mesh axes."""
    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def shard_batch(tree, mesh: DeviceMesh, axis: str = BATCH_AXIS,
                reference=None):
    """Place a batched tree on the mesh as DTensors: batched leaves split
    on their leading dimension over ``axis``, unbatched leaves replicated.

    Every rank passes the whole tree and keeps its own rows (no
    communication).  ``reference``: the ``*_axes`` tree
    (:func:`~copra_tpu_torch.parallel.batch.batch_axes`) marking which
    leaves are batched; by default every leaf is.  A batched leaf whose
    leading size does not divide by the axis size raises ``ValueError``.
    """
    shard, repl = batch_sharding(mesh, axis), [Replicate()] * mesh.ndim

    def place(leaf, ax):
        if ax == 0:
            local = coll.local_rows(leaf, mesh, axis).contiguous()
            return DTensor.from_local(local, mesh, shard, run_check=False)
        return DTensor.from_local(leaf, mesh, repl, run_check=False)

    if reference is None:
        return tree_map(lambda leaf: place(leaf, 0), tree)
    return tree_map(place, tree, reference)


def _to_local(tree, axes, mesh: DeviceMesh, axis: str):
    """Each leaf as this rank's plain tensor: a DTensor's local tensor, a
    full batched leaf's rows of this rank, an unbatched leaf as it is."""

    def local(leaf, ax):
        if isinstance(leaf, DTensor):
            return leaf.to_local()
        return coll.local_rows(leaf, mesh, axis) if ax == 0 else leaf

    return tree_map(local, tree, axes)


def _local_inputs(system: System, warm: Optional[WarmStart], mesh, axis):
    system = _to_local(system, batch_axes(system), mesh, axis)
    if warm is not None:
        warm = _to_local(warm, warm_start_axes(warm), mesh, axis)
    return system, warm


def _sharded(tree, mesh: DeviceMesh, axis: str):
    """Every leaf of a local result (the rank's rows) as a DTensor split
    over ``axis``."""
    shard = batch_sharding(mesh, axis)
    return tree_map(lambda t: DTensor.from_local(t, mesh, shard,
                                                 run_check=False), tree)


def sharded_solve_mpc(system: System,
                      costs: Sequence[CostFunction] = (),
                      constraints: Sequence[Constraint] = (),
                      options: SolverOptions = SolverOptions(),
                      warm_start: Optional[WarmStart] = None,
                      mesh: Optional[DeviceMesh] = None,
                      axis: str = BATCH_AXIS) -> MPCResult:
    """One batched solve over the mesh: each rank solves its rows of the
    scenario batch with ``options`` as given (``solve_mpc_batch``; every
    lane stops on its own residuals, so a lane's result does not depend on
    the rows beside it).  ``system`` and ``warm_start`` are full tensors or
    DTensors from :func:`shard_batch`; the result's leaves are DTensors
    split over ``axis``.
    """
    if mesh is None:
        mesh = make_mesh()
    system, warm = _local_inputs(system, warm_start, mesh, axis)
    res = solve_mpc_batch(system, costs, constraints, options, warm)
    return _sharded(res, mesh, axis)


def make_sharded_mpc_step(mesh: DeviceMesh,
                          costs: Sequence[CostFunction],
                          constraints: Sequence[Constraint],
                          options: SolverOptions = SolverOptions(),
                          axis: str = BATCH_AXIS,
                          with_stats: bool = True):
    """The receding-horizon step of production serving.

    Returns ``step(system, warm) -> (MPCResult, stats)``: each rank solves
    its rows (full tensors are sliced, DTensors read locally) with
    ``early_exit`` forced off, so every lane and rank runs the same count
    and none straggles; the result's leaves are DTensors split over
    ``axis``.  ``stats`` (empty without ``with_stats``) are the batch's
    ``converged`` and ``total`` lanes (all-reduced sums) and its
    ``max_primal_residual`` and ``max_dual_residual`` (all-reduced
    maxima): 0-dim tensors, the same on every rank.
    """
    costs, constraints = tuple(costs), tuple(constraints)
    opts = options.replace(early_exit=False)

    def step(system: System, warm: Optional[WarmStart]):
        system, warm = _local_inputs(system, warm, mesh, axis)
        res = solve_mpc_batch(system, costs, constraints, opts, warm)
        stats = {}
        if with_stats:
            sol = res.solution
            stats = {
                "converged": coll.psum((sol.status == 0).sum(), mesh, axis),
                "total": coll.psum(torch.tensor(
                    sol.status.shape[0], device=sol.status.device), mesh,
                    axis),
                "max_primal_residual": coll.pmax(
                    sol.primal_residual.max(), mesh, axis),
                "max_dual_residual": coll.pmax(sol.dual_residual.max(),
                                               mesh, axis),
            }
        return _sharded(res, mesh, axis), stats

    return step
