"""The controls on the card: the reference in the precision below each
configuration's (float32 for the point-mass fleet's float64 controls;
TF32 products for the ZMP fleet's float32) misses each cell's ``u_gap``
limit, at the cells' widths, on states like the cells' traffic (a sample
of lanes).  Needs a CUDA device; skips elsewhere.

    python -m pytest benchmark/test_benchmark_control.py -m cuda -n 0
"""

import json
import os

import pytest
import torch

from benchmark import harness
from benchmark.reference import pointmass_ltv_fleet as pm
from benchmark.reference import zmp_preview_biped as zmp
from benchmark.serving import plan_chain, stagewise_tick

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32 products exist only there)")
    return torch.device("cuda", 0)


def _limit(cell):
    return harness.load_json(os.path.join(harness.BENCH_DIR, "checks",
                                          f"{cell}.json"))["u_gap"]


def _gap(U, Uref):
    return float((U.double() - Uref).abs().max() / Uref.abs().max())


@pytest.mark.cuda
def test_pointmass_float32_control(cuda):
    cfg = harness.load_json(os.path.join(harness.BENCH_DIR, "configs",
                                         "pointmass_ltv_fleet.json"))
    raw = plan_chain.make_inputs(cfg, 11, cuda)
    lanes = list(range(0, cfg["lanes"], cfg["lanes"] // 32))
    x0 = torch.tensor([0.0, -1.5], dtype=torch.float64, device=cuda).repeat(
        len(lanes), 1)
    x0[:, 1] += torch.linspace(-0.2, 0.2, len(lanes), dtype=torch.float64,
                               device=cuda)
    U, _ = pm.controls(cfg, raw, x0, lanes)
    U32, _ = pm.controls(cfg, raw, x0, lanes, "float32")
    assert _gap(U32, U) > _limit("pointmass4096.chained")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["zmp512.served", "zmp512.pushed"])
def test_zmp_tf32_control(cuda, cell):
    """On states of the cell's own traffic (the lanes pushed at the pool's
    first pushed ticks, or the first ticks' lanes)."""
    from benchmark.traffic import Traffic

    cfg = harness.load_json(os.path.join(harness.BENCH_DIR, "configs",
                                         "zmp_preview_biped.json"))
    spec = harness.load_json(os.path.join(
        harness.BENCH_DIR, "traffic",
        harness.cell_spec(BENCH, cell)["cell"]["traffic"] + ".json"))
    raw = stagewise_tick.make_inputs(cfg, 0, cuda)
    t = Traffic(spec, cfg, stagewise_tick.lanes(cfg), 3, cuda,
                stagewise_tick.plant(cfg))
    ticks = (t.push_ticks[:16] if t.push_ticks.size else
             range(0, 64, 4))
    picks = [(int(k), lane) for k in ticks for lane in t.sample_lanes(int(k))]
    x0 = t.pool[torch.as_tensor([k for k, _ in picks], device=cuda),
                torch.as_tensor([ln for _, ln in picks], device=cuda)]
    lanes = [ln for _, ln in picks]
    U, _ = zmp.controls(cfg, raw, x0, lanes)
    Ut, _ = zmp.controls(cfg, raw, x0, lanes, "tf32")
    assert _gap(Ut, U) > _limit(cell)
