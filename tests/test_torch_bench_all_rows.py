"""``bench_all_torch.py``'s configs 2 (the full constraint set) and 6 (the
quadruped's friction rows) on the CPU at small sizes, as
``tests/test_torch_bench_all.py`` runs configs 1 and 5 (the two files split
the work so each stays near 40 s of one worker)."""

import pytest
from _one_thread import one_torch_thread  # noqa: F401
from test_torch_bench_all import run_and_check


@pytest.mark.parametrize("config", [2, 6])
def test_config_lines_and_gates(config):
    run_and_check(config)
