"""Where a derivative cannot pass: the kernel launches and host round trips.

The plain routes of the package are PyTorch operations, so
``torch.autograd`` and ``torch.func`` differentiate them as ``jax.grad``
and ``jax.jacfwd`` differentiate the reference's XLA code.  A hand-written
kernel is a ctypes call into fresh output tensors, and a host round trip
through numpy keeps only values: both would hand back results whose
derivative silently leaves out their share.  The reference refuses there
(a Pallas call has no derivative rule; a tracer cannot become a numpy
array; a ``pure_callback`` refuses a derivative), so the port refuses too,
naming the plain route that gives the gradient.

A gradient is asked of a tensor when grad mode is on and the tensor
requires grad, or when it carries a forward-mode tangent.  Inside a
``torch.func`` transform (``grad``, ``jacrev``, ``vjp``, ``jacfwd``,
``jvp``) the tensors the transform tracks show one of the two at its
level.  Under ``torch.no_grad()``, or on detached tensors, nothing is
asked.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from .._graph import tree_map

Tensor = torch.Tensor


def _asks(t: Tensor) -> bool:
    if t.requires_grad and torch.is_grad_enabled():
        return True
    return ((t.is_floating_point() or t.is_complex())
            and fwAD.unpack_dual(t).tangent is not None)


def asks_gradient(*trees) -> bool:
    """Whether a gradient is asked of any tensor in ``trees`` (tensors,
    tuples, lists, dataclasses; other leaves are ignored)."""
    found = []

    def visit(t: Tensor) -> Tensor:
        if not found and _asks(t):
            found.append(t)
        return t

    for tree in trees:
        if isinstance(tree, Tensor):
            if _asks(tree):
                return True
        elif tree is not None:
            tree_map(visit, tree)
            if found:
                return True
    return False


def refuse_gradient(entry: str, plain_route: str, *trees) -> None:
    """Raise ``RuntimeError`` when a gradient is asked of ``trees``:
    ``entry`` (a kernel launch or a host round trip) has no derivative,
    and ``plain_route`` is the call that gives one."""
    if asks_gradient(*trees):
        raise RuntimeError(
            f"{entry} has no derivative, and a gradient is asked of its "
            f"input (requires_grad, a torch.func transform or a "
            f"forward-mode tangent).  Differentiate through {plain_route}, "
            f"or call it under torch.no_grad() or on detached tensors.")
