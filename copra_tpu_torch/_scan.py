"""Log-depth associative scan over a stage axis.

The port's counterpart of ``lax.associative_scan``, shared by the
log-depth condensing (:func:`~copra_tpu_torch.systems.condense_lti_assoc`,
:func:`~copra_tpu_torch.systems.condense_ltv_assoc`), the log-depth Riccati
solve (:func:`~copra_tpu_torch.qp.riccati.lqr_solve_assoc`) and the
parallel dual residual of the stagewise status pass, with the one
combine all of them scan with: :func:`affine_combine`.

It is the Hillis-Steele scan: level ``j`` combines every element with the
one ``2^j`` stages before it (after it, reversed), so ``ceil(log2 N)``
levels of one batched call of ``fn`` each.  JAX's odd/even recursion does
O(N) combines but takes ``2 ceil(log2 N) - 1`` levels, each with strided
slices and an interleave; here the batched products are a few ``[..., x,
x]`` matrices per stage, which the card does in the time of their launch,
so fewer levels beat fewer combines.  No Python loop over stages and no
host sync: the scan can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

Tensor = torch.Tensor


def associative_scan(fn: Callable, elems: Sequence[Tensor], dim: int,
                     reverse: bool = False) -> Tuple[Tensor, ...]:
    """Inclusive scan of ``elems`` (a tuple of tensors sharing the stage
    axis ``dim``, counted from the front, after any leading lane axes)
    under the associative ``fn(a, b)``, with ``lax.associative_scan``'s
    semantics: ``a`` is the combination of the stages before ``b`` in scan
    order, which with ``reverse=True`` runs from the last stage to the
    first.  Returns a tuple like ``elems``."""
    elems = tuple(elems)
    if dim < 0:
        raise ValueError(f"dim counts from the front (>= 0), got {dim}")
    n = elems[0].shape[dim]
    if any(t.shape[dim] != n for t in elems):
        raise ValueError(f"every element needs {n} stages along dim {dim}, "
                         f"got {[tuple(t.shape) for t in elems]}")
    cur = elems
    step = 1
    while step < n:
        m = n - step
        if reverse:
            a = tuple(t.narrow(dim, step, m) for t in cur)
            b = tuple(t.narrow(dim, 0, m) for t in cur)
            c = fn(a, b)
            cur = tuple(torch.cat([ci, t.narrow(dim, m, step)], dim=dim)
                        for ci, t in zip(c, cur))
        else:
            a = tuple(t.narrow(dim, 0, m) for t in cur)
            b = tuple(t.narrow(dim, step, m) for t in cur)
            c = fn(a, b)
            cur = tuple(torch.cat([t.narrow(dim, 0, step), ci], dim=dim)
                        for ci, t in zip(c, cur))
        step *= 2
    return tuple(cur)


# The combine's products of maps at most SMALL_X wide are written as an
# elementwise product and a sum: a batched GEMM or GEMV of blocks this small
# costs the card ~0.1 ms a call whatever its size (measured on the H100 in
# config 5's status pass, x = 3), the elementwise pass a few us.  That
# form's [..., x, x, x] intermediate grows as x^3 against the product's
# x^2, so wider maps, and blocks of right-hand sides, go through ``@``.
SMALL_X = 8


def affine_combine(first, then):
    """Composition of the affine maps ``m -> M m + c``, ``first`` applied
    first: ``(M2 M1, M2 c1 + c2)``.  ``c`` is a vector ``[..., x]`` or a
    block ``[..., x, k]`` of ``k`` right-hand sides."""
    M1, c1 = first
    M2, c2 = then
    small = M1.shape[-1] <= SMALL_X
    if small:
        M = (M2.unsqueeze(-1) * M1.unsqueeze(-3)).sum(-2)
    else:
        M = M2 @ M1
    if c1.dim() == M1.dim():
        c = M2 @ c1
    elif small:
        c = (M2 * c1.unsqueeze(-2)).sum(-1)
    else:
        c = (M2 @ c1.unsqueeze(-1)).squeeze(-1)
    return M, c + c2
