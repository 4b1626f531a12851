"""The readers of the program's own counters
(``benchmark/program_counters.py``, ``metrics/topup_share.tick.py``,
``metrics/topup_useful_share.tick.py``): exact values from counters that
move after the reader is loaded, nothing from a program that keeps no
counters, and a traced run of the pushed cell on the CPU at a tiny size
that reports both.

    python -m pytest benchmark/test_benchmark_counters.py -n 0
"""

import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

import copra_tpu_torch as tt
from benchmark import harness
from benchmark.test_benchmark_faults import SMALL
from copra_tpu_torch import profiling

tt.set_default_device("cpu")

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
CTX = SimpleNamespace(cfg={"robots": 2})


@pytest.fixture
def fake_counters(monkeypatch):
    """The program's counters as a dict the test moves."""
    counts = {"stagewise.ticks": 7, "stagewise.topups": 3,
              "stagewise.topup_lanes": 5, "chain.captures": 1}
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    return counts


@pytest.mark.parametrize("name,moved,want", [
    ("topup_share.tick", (4, 1, 3), 0.25),
    ("topup_share.tick", (5, 0, 0), 0.0),
    ("topup_share.tick", (0, 0, 0), None),
    ("topup_useful_share.tick", (4, 2, 3), 3 / (4 * 2)),
    ("topup_useful_share.tick", (5, 0, 0), None),
])
def test_counter_readers_read_the_change_since_their_load(
        fake_counters, name, moved, want):
    """What the counters held at load is left out: (ticks, top-ups, lanes
    missed) moved by ``moved`` give the share of ticks topped up and the
    lanes missed over the lanes (4) the top-ups ran."""
    read = harness.load_module("metrics", name).read
    for key, d in zip(("stagewise.ticks", "stagewise.topups",
                       "stagewise.topup_lanes"), moved):
        fake_counters[key] += d
    got = read(CTX)
    assert got == (None if want is None else pytest.approx(want, rel=1e-15))


@pytest.mark.parametrize("name", ["topup_share.tick",
                                  "topup_useful_share.tick"])
def test_counter_readers_read_nothing_from_a_program_without_counters(
        monkeypatch, name):
    monkeypatch.delattr(profiling, "counters")
    assert harness.load_module("metrics", name).read(CTX) is None


def test_traced_pushed_run_reports_the_counter_metrics():
    """A traced run of the pushed cell at a tiny size on the CPU: the
    fused tick's counters move in its windows, so both metrics are in its
    line, each a share."""
    spec = harness.cell_spec(BENCH, "zmp512.pushed")
    r = harness.run_cell(spec, 2 ** 31 + 29, 0.5, True, torch.device("cpu"),
                         time.time(), sizes=SMALL["zmp512.pushed"])
    assert r["correct"], r["checks"]
    share = r["metrics"]["topup_share.tick"]["value"]
    useful = r["metrics"].get("topup_useful_share.tick", {}).get("value")
    assert 0.0 <= share <= 1.0
    assert (useful is None) == (share == 0.0)
    if useful is not None:
        assert 0.0 < useful <= 1.0
