"""Launch counts of the kernel wrappers.

Every wrapper that launches a hand-written kernel is decorated with
:func:`counted`: it gets a ``launches`` count, which it raises by one where
it launches its kernel and nowhere else, and it is listed in
:data:`COUNTED`.  What reads or resets the counts (a captured chain, a
smoke run) goes through that list, so a new wrapper is reached without
being named there.
"""

from __future__ import annotations

from typing import Callable, List

COUNTED: List[Callable] = []


def counted(fn: Callable) -> Callable:
    """Register ``fn`` as a counted kernel wrapper, its count at 0."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def reset() -> None:
    """Set every counted wrapper's count to 0."""
    for fn in COUNTED:
        fn.launches = 0
