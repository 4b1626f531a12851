"""Scenario-parallel and mesh-split MPC solving.

Port of ``copra_tpu/parallel`` on ``torch.distributed``, one process per
device:

* **scenario batch** (``batch.py``) -- one solve over a leading lane
  dimension on one device;
* **mesh and serving** (``mesh.py``) -- :func:`distributed_init` (NCCL on
  the GPU, gloo on the CPU), a named ``DeviceMesh``, the scenario batch
  placed as DTensors and the serving step whose batch statistics are
  all-reduced over the batch axis;
* **model parallel** (``model.py``) -- one QP's constraint rows split over
  a ``"model"`` axis, and DP x TP on a ``("batch", "model")`` mesh;
* **horizon parallel** (``horizon.py``) -- the LQ solve's stages split
  over a ``"seq"`` axis, one all-gather each way.
"""

from .batch import (batch_axes, batch_size, solve_mpc_batch, stack_systems,
                    warm_start_axes)
from .horizon import lqr_solve_sharded
from .mesh import (batch_sharding, distributed_init, make_mesh,
                   make_sharded_mpc_step, shard_batch, sharded_solve_mpc)
from .model import solve_qp_model_parallel

__all__ = [
    "batch_axes", "batch_size", "solve_mpc_batch", "stack_systems",
    "warm_start_axes",
    "make_mesh", "batch_sharding", "shard_batch", "sharded_solve_mpc",
    "make_sharded_mpc_step", "distributed_init",
    "solve_qp_model_parallel", "lqr_solve_sharded",
]
