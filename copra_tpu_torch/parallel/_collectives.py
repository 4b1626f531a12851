"""The collectives of the parallel layer on ``torch.distributed``.

Where the reference names a mesh axis inside ``shard_map`` (``psum``,
``pmax``, ``all_gather``, ``axis_index``), the port names the same axis
of a :class:`~torch.distributed.device_mesh.DeviceMesh`: :func:`axis_group`
turns ``(mesh, axis)`` into its process group, size and this rank's index
along it.  ``model.py`` and ``horizon.py`` communicate through this module
only, so it is the one place that counts their traffic: inside
:func:`recording`, every call is noted as ``(op, elements, caller)``.
"""

from __future__ import annotations

import contextlib
import sys
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

Tensor = torch.Tensor

_calls: Optional[List[Tuple[str, int, str]]] = None


@contextlib.contextmanager
def recording():
    """Note every collective called inside the block: yields a list that
    receives ``(op, elements, caller)`` per call, ``op`` one of
    ``"psum"``, ``"pmax"``, ``"all_gather"`` and ``caller`` the name of
    the function that called it (``"body"``: an ADMM iteration)."""
    global _calls
    outer, _calls = _calls, []
    try:
        yield _calls
    finally:
        _calls = outer


def _note(op: str, t: Tensor) -> None:
    if _calls is not None:
        _calls.append((op, t.numel(), sys._getframe(2).f_code.co_name))


def axis_group(mesh, axis: str) -> Tuple[object, int, int]:
    """``(process group, size, this rank's index)`` of the mesh axis
    ``axis``."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def psum(t: Tensor, mesh, axis: str) -> Tensor:
    """The sum of ``t`` over the ranks of ``axis`` (a new tensor)."""
    _note("psum", t)
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis_group(mesh, axis)[0])
    return out


def pmax(t: Tensor, mesh, axis: str) -> Tensor:
    """The elementwise maximum of ``t`` over the ranks of ``axis``."""
    _note("pmax", t)
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis_group(mesh, axis)[0])
    return out


def all_gather(t: Tensor, mesh, axis: str) -> Tensor:
    """Every rank's ``t`` along ``axis``, stacked on a new leading dim in
    the axis's order."""
    _note("all_gather", t)
    group, size, _ = axis_group(mesh, axis)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def local_rows(t: Tensor, mesh, axis: str, dim: int = 0) -> Tensor:
    """This rank's block of ``t`` along ``dim`` when ``dim`` is split over
    ``axis``: a DTensor's local tensor, or the rank's even share of a full
    tensor (the size must divide)."""
    if isinstance(t, DTensor):
        return t.to_local()
    _, size, index = axis_group(mesh, axis)
    rows = t.shape[dim]
    if rows % size:
        raise ValueError(f"dimension {dim} of size {rows} does not divide "
                         f"over the {size} ranks of mesh axis {axis!r}")
    block = rows // size
    return t.narrow(dim, index * block, block)
