"""Checkpoint / resume for solver and controller state.

Port of ``copra_tpu/checkpoint.py``.  The receding-horizon state -- a
``WarmStart``, a ``QPSolution``, the stagewise warm tuple of
``solve_stagewise(..., return_warm=True)``, or any tree of them -- packs
into a flat numpy ``.npz`` archive in the reference's layout (``leaf_{i}``,
``__treedef__`` and ``__meta__`` as uint8 bytes), written atomically, so a
serving process restarts and resumes warm-started solving with
bit-identical state.

A tree here is what :func:`copra_tpu_torch._graph.tree_map` walks: frozen
dataclasses, tuples (named or not), lists, ``None`` (an empty subtree)
and tensor leaves.  Its structure string stands for the
reference's ``str(treedef)``.

Names, and the reference function each stands for:

* :func:`save_pytree` / :func:`load_pytree` -- ``save_pytree`` /
  ``load_pytree`` (the npz archive);
* :func:`save_warm_start` / :func:`load_warm_start` -- the same names (the
  tick in the metadata);
* :func:`save_pytree_dcp` / :func:`load_pytree_dcp` --
  ``save_pytree_orbax`` / ``load_pytree_orbax``, the sharding-aware backend,
  on ``torch.distributed.checkpoint`` (part of PyTorch).
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ._graph import tree_map
from ._tensors import resolve_device


def _structure(tree) -> str:
    """The structure string of a tree (``*`` a tensor leaf), in the order
    :func:`~copra_tpu_torch._graph.tree_map` walks it."""
    if tree is None:
        return "None"
    if isinstance(tree, torch.Tensor):
        return "*"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        inner = ",".join(f"{f.name}={_structure(getattr(tree, f.name))}"
                         for f in dataclasses.fields(tree) if f.init)
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        inner = ",".join(f"{k}={_structure(v)}"
                         for k, v in zip(tree._fields, tree))
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, tuple):
        return "(" + "".join(_structure(v) + "," for v in tree) + ")"
    if isinstance(tree, list):
        return "[" + ",".join(_structure(v) for v in tree) + "]"
    raise TypeError(f"a checkpoint tree holds tensors, dataclasses, tuples, "
                    f"lists and None, not {type(tree).__name__}")


def _flatten(tree) -> Tuple[List[torch.Tensor], str]:
    """The tensor leaves in ``tree_map``'s order and the structure
    string."""
    struct = _structure(tree)
    leaves: List[torch.Tensor] = []
    tree_map(lambda t: leaves.append(t) or t, tree)
    return leaves, struct


def _unflatten(like, leaves: List[torch.Tensor]):
    """``like``'s structure with its tensors replaced, in order, by
    ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _bytes(text: str) -> np.ndarray:
    return np.frombuffer(text.encode(), dtype=np.uint8)


def _check_shapes(saved: List[tuple], flat_like: List[torch.Tensor]
                  ) -> None:
    for i, (sshape, tmpl) in enumerate(zip(saved, flat_like)):
        if tuple(sshape) != tuple(tmpl.shape):
            raise ValueError(
                f"checkpoint leaf {i} shape mismatch: saved "
                f"{tuple(sshape)} vs template {tuple(tmpl.shape)}")


def _check_structure(saved: str, template: str) -> None:
    if saved != template:
        raise ValueError(
            f"checkpoint tree structure mismatch:\n  saved: {saved}\n  "
            f"template: {template}")


def save_pytree(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    """Save a tree of tensors to ``path`` (.npz).

    The structure string and the leaf order are recorded; ``meta`` is an
    optional JSON-serializable dict (e.g. a tick counter, an options
    fingerprint).  The archive is written to ``path + ".tmp"`` through a
    file handle (so numpy adds no suffix) and moved over ``path``
    atomically.
    """
    flat, struct = _flatten(tree)
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(flat)}
    arrays["__treedef__"] = _bytes(struct)
    arrays["__meta__"] = _bytes(json.dumps(meta or {}))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic on POSIX


def load_pytree(path: str, like: Any) -> Tuple[Any, Dict]:
    """Load a tree saved by :func:`save_pytree`: ``(tree, meta)``.

    ``like`` supplies the structure (a template tree, e.g. a cold-start
    ``WarmStart``); the leaves are restored in flatten order with their
    saved dtype on the package's default device.  A stored structure or
    leaf shape that differs from ``like``'s raises ``ValueError`` instead
    of reassigning leaves by flatten order.
    """
    dev = resolve_device()
    flat_like, struct = _flatten(like)
    with np.load(path) as data:
        _check_structure(bytes(data["__treedef__"]).decode(), struct)
        arrays = [data[f"leaf_{i}"] for i in range(len(flat_like))]
        meta = json.loads(bytes(data["__meta__"]).decode())
    _check_shapes([a.shape for a in arrays], flat_like)
    leaves = [torch.from_numpy(a).to(dev) for a in arrays]
    return _unflatten(like, leaves), meta


def save_warm_start(path: str, warm, tick: int = 0, **meta) -> None:
    """Persist a (possibly batched) warm state for restart-resume."""
    save_pytree(path, warm, {"tick": tick, **meta})


def load_warm_start(path: str, like) -> Tuple[Any, int]:
    warm, meta = load_pytree(path, like)
    return warm, int(meta.get("tick", 0))


# what DCP says when no process group is initialised (one process)
_SINGLE_PROCESS = "torch.distributed is disabled, unavailable or uninit"


def save_pytree_dcp(path: str, tree: Any) -> None:
    """Save a tree of tensors with ``torch.distributed.checkpoint`` into the
    directory ``path``: the leaves as the state dict ``{"leaf_i": tensor}``
    beside the structure string and the leaf shapes.  With a process group
    initialised every rank takes part (sharded state is DCP's to place);
    without one the save is a single process's."""
    flat, struct = _flatten(tree)
    state = {f"leaf_{i}": leaf for i, leaf in enumerate(flat)}
    state["__treedef__"] = struct
    state["__shapes__"] = json.dumps([list(t.shape) for t in
                                      list(state.values())[:len(flat)]])
    import torch.distributed.checkpoint as dcp

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_SINGLE_PROCESS)
        dcp.save(state, checkpoint_id=path)


def load_pytree_dcp(path: str, like: Any) -> Any:
    """Restore a tree saved by :func:`save_pytree_dcp`.  ``like`` supplies
    the structure and each leaf's shape, dtype and device (DCP loads into
    tensors of them); a stored structure or shape that differs raises
    ``ValueError``."""
    import torch.distributed.checkpoint as dcp

    flat_like, struct = _flatten(like)
    head = {"__treedef__": "", "__shapes__": ""}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_SINGLE_PROCESS)
        dcp.load(head, checkpoint_id=path)
        _check_structure(head["__treedef__"], struct)
        _check_shapes(json.loads(head["__shapes__"]), flat_like)
        state = {f"leaf_{i}": torch.empty_like(leaf)
                 for i, leaf in enumerate(flat_like)}
        dcp.load(state, checkpoint_id=path)
    return _unflatten(like, [state[f"leaf_{i}"]
                             for i in range(len(flat_like))])
