"""A chain of serving ticks captured once as a CUDA graph and replayed.

The multistep facades (:func:`~copra_tpu_torch.plan.make_plan_multistep`,
:func:`~copra_tpu_torch.qp.riccati.make_stagewise_multistep`) run T ticks
per call.  Issued eagerly, each tick costs the host more time than the card
spends on it; captured, the T ticks are one ``cudaGraphLaunch``.  A chain
is captured once per shape after one run on a side stream, which warms the
allocator and the kernels' libraries, then replayed with new values copied
into its input tensors.  A chain that cannot be captured (a host sync in
it) raises: there is no eager fallback on the card.

The kernel wrappers count their launches on the host, where a capture
would count launches that never ran and a replay none of those that ran.
So the capture's counts (of every wrapper in
:data:`~copra_tpu_torch.ops.counts.COUNTED`) are taken back and kept per
chain, and every replay adds them again: the counts say what the card
ran.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

Tensor = torch.Tensor


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a tree of tuples, lists and dataclasses
    (``None`` and other leaves are kept)."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return tree


def copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at the same place of
    ``dst`` (same structure, shapes and dtypes): how a captured chain takes
    new data without a new capture."""
    if isinstance(dst, Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst) and not isinstance(dst, type):
        for f in dataclasses.fields(dst):
            copy_into(getattr(dst, f.name), getattr(src, f.name))
    elif isinstance(dst, (tuple, list)):
        if len(dst) != len(src):
            raise ValueError(f"cannot copy {len(src)} items into {len(dst)}")
        for a, b in zip(dst, src):
            copy_into(a, b)
    elif dst != src:
        raise ValueError(f"cannot copy {src!r} into {dst!r}")


class CapturedChain:
    """``fn(*inputs)`` captured as one CUDA graph.

    ``inputs`` are tensors on one CUDA device; the chain keeps its own
    copies of them (the graph reads those addresses), runs ``fn`` once on
    a side stream, then captures it.  Calling the chain with new values of
    the same shapes copies them in, replays the graph and returns
    ``fn``'s outputs: tensors of the graph's memory, which the next call
    overwrites (callers that hand them out clone them).
    """

    def __init__(self, fn: Callable, inputs: Sequence[Tensor], name: str):
        from .ops.counts import COUNTED

        dev = inputs[0].device
        self.inputs = tuple(t.detach().clone() for t in inputs)
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(*self.inputs)                 # real launches, counted
            torch.cuda.current_stream(dev).wait_stream(side)
            before = {w: w.launches for w in COUNTED}
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    outputs = fn(*self.inputs)
            except RuntimeError as e:
                raise RuntimeError(
                    f"{name}: the chain could not be captured as a CUDA "
                    f"graph ({e}); every piece of a tick must run on the "
                    f"device without a host sync") from e
            finally:
                # the capture ran nothing: its counts become the replay's
                launches = []
                for w in COUNTED:
                    b = before.get(w, 0)
                    if w.launches != b:
                        launches.append((w, w.launches - b))
                    w.launches = b
        self.launches = tuple(launches)
        self.graph = graph
        self.outputs = outputs

    def __call__(self, *values: Tensor):
        for dst, v in zip(self.inputs, values):
            dst.copy_(v)
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n
        return self.outputs
