"""A whole run of each cell on the CPU at a tiny size, past the look for a
chip, with the timed path broken underneath: ``correct`` has to come out
false for each fault a cell can have, and true without one.

The faults, each planted in the served call's output: a step that returns
its state unchanged (every call hands back the first call's controls);
half of the batch left out (the second half of the lanes' controls
zeroed); an answer altered where it is produced (every lane's first
control moved by 1% of the call's largest).  No cell runs across chips,
so none can leave out an exchange between chips.

    python -m pytest benchmark/test_benchmark_faults.py -n 0
"""

import json
import os
import time

import pytest
import torch

import copra_tpu_torch as tt
from benchmark import harness

tt.set_default_device("cpu")
torch.set_num_threads(1)

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
ZMP_SMALL = {"robots": 2, "horizon": 10,
             "footsteps": {"count": 4, "length": 0.2, "width": 0.1,
                           "duration": 0.02, "margin": 0.05}}
SMALL = {
    "pointmass4096.chained": {
        "config": {"lanes": 12, "horizon": 100},
        "traffic": {"ticks_per_call": 4, "pool_ticks": 40,
                    "sample": {"count": 3, "lanes": 3}}},
    "zmp512.served": {
        "config": ZMP_SMALL,
        "traffic": {"period_ms": 100.0, "pool_ticks": 40,
                    "sample": {"count": 4, "lanes": 3}}},
    "zmp512.pushed": {
        "config": ZMP_SMALL,
        "traffic": {"period_ms": 100.0, "pool_ticks": 40,
                    "pushes": {"per_robot_second": 1.0, "group": 2,
                               "velocity": 0.1},
                    "sample": {"count": 4, "lanes": 3}}},
}


def stale(call):
    first = []

    def broken(x0):
        U = call(x0)
        if not first:
            first.append(U.clone())
        return first[0].clone()
    return broken


def half(call):
    def broken(x0):
        U = call(x0).clone()
        lanes = U.shape[-2]
        U[..., lanes // 2:, :] = 0.0
        return U
    return broken


def altered(call):
    def broken(x0):
        U = call(x0).clone()
        U[..., 0] += 0.01 * U.abs().max()
        return U
    return broken


FAULTS = {"none": None, "stale": stale, "half": half, "altered": altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_makes_the_run_incorrect(cell, fault):
    assert cell in {w["name"] for w in BENCH["workloads"]}
    spec = harness.cell_spec(BENCH, cell)
    r = harness.run_cell(spec, 2 ** 31 + 17, 1.0, False,
                         torch.device("cpu"), time.time(),
                         fault=FAULTS[fault], sizes=SMALL[cell])
    assert r["checks"]["samples"]["value"] == \
        SMALL[cell]["traffic"]["sample"]["count"]
    assert r["correct"] is (fault == "none"), r["checks"]
