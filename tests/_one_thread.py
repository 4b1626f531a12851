"""A module-scoped fixture that runs PyTorch's CPU work on one intra-op
thread from the first test of the module that uses it.

The CPU suite runs in several worker processes on a shared machine.  Under
that load a plain-route solve of a few hundred variables (thousands of
small operations, each a parallel region across every core) waits on
descheduled threads at every operation, and runs many times slower than
on one thread.  The count is not restored afterwards, so the worker's
later modules run on one thread too: with this CPU build of PyTorch,
``torch.set_num_threads`` to any count above one after start-up leaves
MKL's LU factorisation returning wrong pivots (``torch.linalg.inv``
then raises or returns garbage), while one thread is safe.  A module
imports the fixture by name:

    from _one_thread import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    torch.set_num_threads(1)
