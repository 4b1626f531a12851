"""Batched MPC solving: scenario data-parallelism on one device.

Port of ``copra_tpu/parallel/batch.py``.  A batch of scenarios is one system
with a leading batch dimension on some or all leaves.  Where the reference
vmaps the condense -> build -> solve -> replay pipeline over it, the port's
pipeline takes the batch dimension directly, so :func:`solve_mpc_batch` is
:func:`copra_tpu_torch.solve_mpc` on the batched system; unbatched leaves
(e.g. shared dynamics with per-scenario initial states) broadcast.  The
``*_axes`` helpers keep the reference's names and say which leaves are
batched.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..constraints import Constraint
from ..costs import CostFunction
from ..mpc import MPCResult, solve_mpc
from ..qp.types import SolverOptions, WarmStart
from ..systems import LTISystem, System

# Canonical (unbatched) ranks of each system leaf; a leaf with higher rank
# carries a leading batch dimension.
_LTI_NDIM = dict(A=2, B=2, d=1, x0=1)
_LTV_NDIM = dict(A=3, B=3, d=2, x0=1)


def _ndim(system: System) -> dict:
    return _LTI_NDIM if isinstance(system, LTISystem) else _LTV_NDIM


def batch_axes(system: System) -> System:
    """Which leaves of a possibly-batched system carry the batch dimension:
    a system of the same kind whose leaves are ``0`` (batched, rank above
    the canonical one) or ``None`` (shared)."""
    return dataclasses.replace(system, **{
        f: (0 if getattr(system, f).dim() > n else None)
        for f, n in _ndim(system).items()})


def warm_start_axes(warm: WarmStart) -> WarmStart:
    """Which leaves of a warm start are batched (rank > 1): ``0`` or
    ``None`` per leaf."""
    return WarmStart(*[0 if getattr(warm, f).dim() > 1 else None
                       for f in ("x", "y", "z")])


def batch_size(system: System) -> int:
    """Leading batch dimension of a batched system (error if unbatched)."""
    for f, n in _ndim(system).items():
        if getattr(system, f).dim() > n:
            return getattr(system, f).shape[0]
    raise ValueError("system has no batched leaf.")


def stack_systems(systems: Sequence[System]) -> System:
    """Stack scenarios into one batched system (all leaves batched)."""
    first = systems[0]
    return dataclasses.replace(first, **{
        f: torch.stack([getattr(s, f) for s in systems])
        for f in _ndim(first)})


def solve_mpc_batch(system: System,
                    costs: Sequence[CostFunction] = (),
                    constraints: Sequence[Constraint] = (),
                    options: SolverOptions = SolverOptions(),
                    warm_start: Optional[WarmStart] = None,
                    solver=None) -> MPCResult:
    """:func:`copra_tpu_torch.solve_mpc` over the scenario batch dimension.

    Costs/constraints are shared across the batch (their tensors
    broadcast).  For uniform progress across lanes prefer
    ``options.replace(early_exit=False)``: one schedule with no per-lane
    freezing.
    """
    batch_size(system)   # an unbatched system is refused, as vmap refuses it
    return solve_mpc(system, tuple(costs), tuple(constraints), options,
                     warm_start, solver)
