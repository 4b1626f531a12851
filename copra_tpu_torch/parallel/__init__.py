"""Scenario-parallel MPC solving.

Port of ``copra_tpu/parallel``: so far the scenario batch of
``parallel/batch.py``.  The mesh, model-parallel and horizon-sharded
paths (``mesh.py``, ``model.py``, ``horizon.py``) are not ported yet.
"""

from .batch import (batch_axes, batch_size, solve_mpc_batch, stack_systems,
                    warm_start_axes)

__all__ = ["batch_axes", "batch_size", "solve_mpc_batch", "stack_systems",
           "warm_start_axes"]
