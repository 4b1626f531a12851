"""Build the port's containers from numpy arrays (for example the leaves of
a reference ``ControlPlan`` or system), so one problem can be fed to both
implementations.  ``device=None`` is the package's default device
(:func:`copra_tpu_torch.set_default_device`)."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Union

import numpy as np
import torch

from ._tensors import resolve_device
from .plan import ControlPlan
from .qp.riccati import StagewiseQP
from .qp.types import DenseQP, WarmStart
from .systems import LTISystem, LTVSystem

_STATIC = ("xdim", "udim", "horizon")


def _tensor(v, device) -> torch.Tensor:
    return torch.tensor(np.array(v), device=resolve_device(device))


def plan_from_numpy(fields: Mapping[str, np.ndarray],
                    device=None) -> ControlPlan:
    """``ControlPlan`` from a mapping of field name to array (the static
    ``xdim``/``udim``/``horizon`` as integers), dtypes kept."""
    kw = {}
    for f in dataclasses.fields(ControlPlan):
        v = fields[f.name]
        kw[f.name] = int(v) if f.name in _STATIC else _tensor(v, device)
    return ControlPlan(**kw)


def system_from_numpy(fields: Mapping[str, np.ndarray], device=None
                      ) -> Union[LTISystem, LTVSystem]:
    """``LTISystem`` when ``fields`` has a ``horizon``, else ``LTVSystem``;
    fields ``A``, ``B``, ``d``, ``x0`` (batch dimensions allowed)."""
    arrays = {k: _tensor(fields[k], device) for k in ("A", "B", "d", "x0")}
    if "horizon" in fields:
        return LTISystem(horizon=int(fields["horizon"]), **arrays)
    return LTVSystem(**arrays)


def stagewise_from_numpy(fields: Mapping[str, np.ndarray],
                         device=None) -> StagewiseQP:
    """``StagewiseQP`` from a mapping of field name to array (the leaves of
    a reference ``StagewiseQP``, single or batched), dtypes kept; the row
    fields may be missing or ``None`` for a box-only problem."""
    kw = {}
    for f in dataclasses.fields(StagewiseQP):
        v = fields.get(f.name)
        kw[f.name] = None if v is None else _tensor(v, device)
    return StagewiseQP(**kw)


def qp_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> DenseQP:
    """``DenseQP`` from a mapping of field name to array (the leaves of a
    reference ``DenseQP``, single or batched), dtypes kept."""
    return DenseQP(**{f.name: _tensor(fields[f.name], device)
                      for f in dataclasses.fields(DenseQP)})


def warm_from_numpy(fields: Mapping[str, np.ndarray],
                    device=None) -> WarmStart:
    """``WarmStart`` from a mapping with ``x``, ``y`` and ``z`` (for
    example the fields of a reference ``QPSolution``), dtypes kept."""
    return WarmStart(**{k: _tensor(fields[k], device)
                        for k in ("x", "y", "z")})
