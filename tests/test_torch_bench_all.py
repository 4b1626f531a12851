"""``bench_all_torch.py``'s configs 1 and 5 on the CPU at small sizes
(configs 2 and 6: ``tests/test_torch_bench_all_rows.py``; 3 and 8:
``tests/test_torch_bench.py``; each file near 40 s of one worker).

Each config prints as many lines as the reference's ``BENCHALL.json`` has
for it, each with the reference line's fields (less those only the card
measures), and each gate inside its contract: 1e-5 against the native
oracle on the condensed lines, 1e-4 relative on configs 5 and 6 (and the
ZMP inside its polygon within 1e-6).  The sizes are cut for the CPU, where
the kernels' plain versions run (their stagewise twin costs ~3 ms an
iteration at N = 10): B = 8 lanes and one timed tick; the fused line's
policies probe one candidate each, the reference's choice at full size
(rho 0.03 and 300 iterations for config 1, 0.1 and 200 for config 2), its
cold tick 300 iterations; config 5 at N = 12 with 2 robots and 60 cold
iterations, config 6 at N = 6 with 1 robot, their policies over two
candidates.
"""

import json
import os
import sys

import pytest
import torch
from _one_thread import one_torch_thread  # noqa: F401

import copra_tpu_torch as tt

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import bench_all_torch as ba  # noqa: E402
from test_torch_bench import CARD_KEYS, TOL, check_lines  # noqa: E402

tt.set_default_device("cpu")
CPU = torch.device("cpu")
REL_TOL = 1e-4

SIZES = {
    1: dict(batch=8, steps=1, sw_candidates=(300,), rho_candidates=(0.03,),
            sw_cold_iters=300),
    2: dict(batch=8, steps=1, sw_candidates=(200,), rho_candidates=(0.1,),
            sw_cold_iters=300),
    5: dict(horizon=12, iters=60, steps=1, robots=2, chain=2, fill_iters=30,
            warm_candidates=(10, 20), rho_candidates=(0.1, 1.0)),
    6: dict(horizon=6, iters=60, steps=1, robots=1, warm_candidates=(20, 50),
            rho_candidates=(0.1, 1.0))}


def run_and_check(config: int) -> None:
    """Config ``config`` at ``SIZES[config]``: its lines, fields and
    gates."""
    lines = ba.Lines(CPU)
    ba.CONFIGS[config](CPU, lines, **SIZES[config])
    check_lines(config, lines.lines)
    for line in lines.lines:
        assert line["device_kind"] == "cpu" and line["launches"] == {}
        assert not set(line) & CARD_KEYS
    gated = [line for line in lines.lines if "max_err_vs_exact" in line]
    if config in (1, 2):
        assert all(line["max_err_vs_exact"] <= TOL for line in gated)
    else:
        assert all(line["max_err_rel"] <= REL_TOL for line in gated)
    if config == 5:
        assert all(line["polygon_violation"] <= 1e-6 for line in gated
                   if "polygon_violation" in line)
        floor = lines.lines[10]
        assert floor["tunnel_roundtrip_floor_ms"] > 0
        replan = lines.lines[11]
        assert replan["converged_frac"] == 1.0
    json.dumps(lines.lines)


@pytest.mark.parametrize("config", [1, 5])
def test_config_lines_and_gates(config):
    run_and_check(config)
