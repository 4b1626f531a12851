"""CPU checks of the trotting quadruped cell (``quadruped128.served``):
its plain reference against the native active-set oracle, the control
(the reference in float32, the precision below the configuration's)
against the cell's limit, whole runs at a tiny size with the timed path
broken underneath, as ``test_benchmark_faults.py`` runs the other cells,
and the one fault the cell's traffic cannot show: dynamics linearised at
a stale yaw.

    python -m pytest benchmark/test_benchmark_quadruped.py -n 0
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import copra_tpu_torch as tt
from benchmark import harness
from benchmark.reference import srb_quadruped_trot as ref
from benchmark.test_benchmark_faults import FAULTS

tt.set_default_device("cpu")
torch.set_num_threads(1)

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
CELL = "quadruped128.served"
SMALL = {"config": {"robots": 4, "horizon": 8},
         "traffic": {"period_ms": 100.0, "pool_ticks": 40,
                     "sample": {"count": 4, "lanes": 3}}}


def _cfg(**over):
    cfg = harness.load_json(os.path.join(harness.BENCH_DIR, "configs",
                                         "srb_quadruped_trot.json"))
    return dict(cfg, **over)


def _states(lanes, seed):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.zeros((lanes, 12), dtype=torch.float64)
    x0[:, 5] = 0.3
    x0 += 0.02 * torch.randn((lanes, 12), generator=g, dtype=torch.float64)
    x0[:, 2] = torch.randn(lanes, generator=g, dtype=torch.float64)
    return x0


def test_reference_against_the_native_oracle():
    """Each lane's forces are the native active-set solution of the same
    condensed QP within 1e-7 of the largest force, the reference's own
    residual is at rounding, and some friction or f_z row binds."""
    cfg = _cfg(horizon=8)
    x0 = _states(3, 1)
    x0[:, 9] = 0.5          # walking at 0.5 m/s: the feet brake at the cone
    raw = {"phase": torch.tensor([0, 7, 15])}
    U, res = ref.controls(cfg, raw, x0, [0, 1, 2])
    scale = float(U.abs().max())
    assert float(res.max()) <= 1e-12 * scale
    contact = ref.stance(cfg, raw["phase"], 8)
    H, g, G, h, pick = ref.condensed(cfg, x0, contact)
    active = 0
    for lane in range(3):
        n = H.shape[-1]
        qp = tt.DenseQP(Q=H[lane], c=g[lane], Aeq=torch.zeros(
            (0, n), dtype=torch.float64), beq=torch.zeros(
            0, dtype=torch.float64), Aineq=G[lane], bineq=h[lane],
            lb=torch.full((n,), -np.inf, dtype=torch.float64),
            ub=torch.full((n,), np.inf, dtype=torch.float64))
        want = tt.solve_qp_native(qp).x
        assert float((U[lane, pick[lane]] - want).abs().max()) <= 1e-7 * scale
        active += int(((h[lane] - G[lane] @ want).abs() < 1e-7).sum())
    assert active > 0


def test_control_misses_the_limit():
    """The reference in float32 misses ``u_gap``'s limit at the
    configuration's horizon by more than 3x."""
    cfg = _cfg()
    x0 = _states(6, 2)
    raw = {"phase": torch.arange(6) * 3 % 20}
    U, _ = ref.controls(cfg, raw, x0, range(6))
    U32, _ = ref.controls(cfg, raw, x0, range(6), "float32")
    gap = float((U32.double() - U).abs().max() / U.abs().max())
    limits = harness.load_json(os.path.join(harness.BENCH_DIR, "checks",
                                            f"{CELL}.json"))
    assert gap > 3 * limits["u_gap"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(fault):
    spec = harness.cell_spec(BENCH, CELL)
    r = harness.run_cell(spec, 2 ** 31 + 23, 0.5, False,
                         torch.device("cpu"), time.time(),
                         fault=FAULTS[fault], sizes=SMALL)
    assert r["checks"]["samples"]["value"] == \
        SMALL["traffic"]["sample"]["count"]
    assert r["correct"] is (fault == "none"), r["checks"]


def test_traced_run_reports_the_rebuild_share():
    """A traced run at a tiny size on the CPU: every served tick rebuilt
    its problem, so ``rebuild_share.tick`` reads 1.0 (the device-trace
    metrics need the card and are left out)."""
    spec = harness.cell_spec(BENCH, CELL)
    r = harness.run_cell(spec, 2 ** 31 + 31, 0.5, True, torch.device("cpu"),
                         time.time(), sizes=SMALL)
    assert r["correct"], r["checks"]
    assert r["metrics"]["rebuild_share.tick"]["value"] == 1.0


def stale_yaw(call):
    """A rebuild that keeps the dynamics of its first warm tick: ``A`` and
    ``B``, which carry the yaw, are never rewritten after it; ``d`` and
    the linear costs follow each tick's states."""
    step = call.__self__.step
    fresh, first = step._problem, []

    def problem(x0):
        data = fresh(x0)
        if not first:
            first.append((data.A.clone(), data.B.clone()))
        return data._replace(A=first[0][0], B=first[0][1])

    step._problem = problem
    return call


def test_stale_yaw_passes_the_cell():
    """The cell's blind spot: its noise enters the two horizontal
    velocities along one 45-degree direction, and the plant maps onto
    itself under a half turn about z, so no robot's yaw moves from its
    seeded heading and a rebuild whose ``A`` and ``B`` stay those of the
    first tick gives the same controls.  The run reads correct; a traffic
    that turns the robots would make this test fail."""
    spec = harness.cell_spec(BENCH, CELL)
    r = harness.run_cell(spec, 2 ** 31 + 37, 0.5, False, torch.device("cpu"),
                         time.time(), fault=stale_yaw, sizes=SMALL)
    assert r["correct"] is True, r["checks"]


def test_stale_yaw_misses_the_limit_once_the_robots_turn():
    """What the check sees once the yaw moves: after half a radian of turn
    the honest rebuild's controls stay within ``u_gap``'s limit of the
    reference's at the turned states, and the stale yaw's miss it."""
    cfg = _cfg(robots=4, horizon=8)
    serving = harness.load_module("serving", cfg["serving"])
    raw = serving.make_inputs(cfg, 2 ** 31 + 41, torch.device("cpu"))
    center = _states(4, 5).float()
    turned = center.clone()
    turned[:, 2] += 0.5
    want, _ = ref.controls(cfg, raw, turned.double(), range(4))
    limit = harness.load_json(os.path.join(
        harness.BENCH_DIR, "checks", f"{CELL}.json"))["u_gap"]
    gaps = {}
    for name, fault in (("honest", None), ("stale", stale_yaw)):
        served = serving.Served(cfg, raw, center)
        call = served.call if fault is None else fault(served.call)
        call(center)
        for _ in range(8):
            U = call(turned)
        gaps[name] = float((U.double() - want).abs().max()
                           / want.abs().max())
    assert gaps["honest"] <= limit < gaps["stale"], gaps
