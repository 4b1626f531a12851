"""CPU checks of the plain references against independent solves, at
small sizes, and of the control: the reference in the precision below
the configuration's misses the configuration's limit.

    python -m pytest benchmark/test_benchmark_reference.py -n 0
"""

import os

import numpy as np
import pytest
import torch

import copra_tpu_torch as tt
from benchmark import harness
from benchmark.reference import pointmass_ltv_fleet as pm
from benchmark.reference import zmp_preview_biped as zmp
from benchmark.reference.qp import natural_residual, solve_box_qp
from benchmark.serving import plan_chain, stagewise_tick

tt.set_default_device("cpu")


def _cfg(name):
    return harness.load_json(os.path.join(harness.BENCH_DIR, "configs",
                                          f"{name}.json"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_qp_against_bounded_least_squares(seed):
    from scipy.optimize import lsq_linear

    g = torch.Generator().manual_seed(seed)
    L, n = 5, 30
    R = torch.randn((L, n + 4, n), generator=g, dtype=torch.float64)
    b = 3 * torch.randn((L, n + 4), generator=g, dtype=torch.float64)
    lo = torch.full((L, n), -1.0, dtype=torch.float64)
    hi = torch.full((L, n), 1.0, dtype=torch.float64)
    lo[0] = -torch.inf
    hi[1, :7] = torch.inf
    H = R.mT @ R
    z, res = solve_box_qp(H, -(R.mT @ b[..., None])[..., 0], lo, hi)
    assert float(res.max()) < 1e-12
    for lane in range(L):
        want = lsq_linear(R[lane].numpy(), b[lane].numpy(),
                          bounds=(lo[lane].numpy(), hi[lane].numpy()),
                          method="bvls", tol=1e-15).x
        assert np.abs(z[lane].numpy() - want).max() < 1e-10


def _pointmass(lanes=3, horizon=20, seed=5, dtype=torch.float64):
    cfg = dict(_cfg("pointmass_ltv_fleet"), lanes=lanes, horizon=horizon)
    raw = plan_chain.make_inputs(cfg, seed, "cpu")
    raw = {k: v.to(dtype) for k, v in raw.items()}
    x0 = torch.tensor([[0.0, -1.5], [0.01, -1.4], [-0.02, -1.6]],
                      dtype=torch.float64)[:lanes]
    return cfg, raw, x0


def test_pointmass_qp_is_the_ports_plan_qp():
    """The reference's condensed QP from the raw float64 arrays equals the
    port's plan QP of the same system, costs and bound."""
    cfg, raw, x0 = _pointmass()
    t, c = cfg["target"], cfg["control_cost"]
    system = tt.LTVSystem(raw["A"], raw["B"], raw["d"], x0)
    plan = tt.make_control_plan(
        system, (tt.TargetCost.create(np.asarray(t["M"]), t["p"],
                                      weights=t["weights"]),
                 tt.ControlCost.create(np.asarray(c["N"]), c["p"],
                                       weights=c["weights"])),
        (tt.ControlBoundConstraint.create([-60.0], [60.0]),))
    qp = tt.plan_qp(plan, x0)
    H, g, lo, hi = pm.box_qp(cfg, raw, x0, [0, 1, 2], torch.float64)
    assert float((qp.Q - H).abs().max()) <= 1e-12 * float(H.abs().max())
    assert float((qp.c - g).abs().max()) <= 1e-12 * float(g.abs().max())
    assert torch.equal(qp.lb.expand_as(lo), lo)


def test_pointmass_controls_against_the_native_oracle():
    cfg, raw, x0 = _pointmass()
    U, res = pm.controls(cfg, raw, x0, [0, 1, 2])
    H, g, lo, hi = pm.box_qp(cfg, raw, x0, [0, 1, 2], torch.float64)
    assert float(natural_residual(H, g, lo, hi, U).max()) < 1e-12
    for lane in range(3):
        qp = tt.DenseQP(Q=H[lane], c=g[lane], Aeq=torch.zeros((0, 20),
                        dtype=torch.float64), beq=torch.zeros(0,
                        dtype=torch.float64), Aineq=torch.zeros(
                        (0, 20), dtype=torch.float64),
                        bineq=torch.zeros(0, dtype=torch.float64),
                        lb=lo[lane], ub=hi[lane])
        want = tt.solve_qp_native(qp).x
        assert float((U[lane] - want).abs().max()) < 1e-8


def _zmp_u_space(cfg, raw, x0, axis):
    """The ZMP problem in the jerks, condensed here in numpy: Q, c and the
    rows lo <= Z U + zoff <= hi of stages 1..N."""
    A, B, zr = (raw[k].double().numpy() for k in ("A", "B", "zmp_row"))
    N = raw["ref"].shape[-1] - 1
    Phi, Psi = np.eye(3), np.zeros((3, N))
    Zphi, Zpsi = [zr @ Phi], [zr @ Psi]
    for k in range(1, N + 1):
        Phi, Psi = A @ Phi, A @ Psi
        Psi[:, k - 1] += B[:, 0]
        Zphi.append(zr @ Phi)
        Zpsi.append(zr @ Psi)
    Zphi, Zpsi = np.array(Zphi), np.array(Zpsi)
    zoff = Zphi @ x0
    ref, lo, hi = (raw[k][axis].double().numpy() for k in ("ref", "lo", "hi"))
    eps = cfg["jerk_weight"] + cfg["hessian_ridge"]
    Q = Zpsi.T @ Zpsi + eps * np.eye(N)
    c = Zpsi.T @ (zoff - ref)
    return Q, c, Zpsi[1:], lo[1:] - zoff[1:], hi[1:] - zoff[1:]


def test_zmp_controls_against_the_native_oracle():
    cfg = dict(_cfg("zmp_preview_biped"), horizon=60,
               footsteps=dict(_cfg("zmp_preview_biped")["footsteps"],
                              duration=0.1))
    raw = stagewise_tick.make_inputs(cfg, 0, "cpu")
    x0 = torch.tensor([[0.01, 0.0, 0.0], [0.0, 0.2, 0.0], [-0.01, -0.15, 0.1],
                       [0.0, 0.0, 0.0]], dtype=torch.float64)
    U, res = zmp.controls(cfg, raw, x0, [0, 1, 2, 3])
    assert float(res.max()) < 1e-12
    active = 0
    for lane in range(4):
        Q, c, Z, lo, hi = _zmp_u_space(cfg, raw, x0[lane].numpy(), lane % 2)
        n = Q.shape[0]
        qp = tt.DenseQP(Q=Q, c=c, Aeq=np.zeros((0, n)), beq=np.zeros(0),
                        Aineq=np.concatenate([Z, -Z]),
                        bineq=np.concatenate([hi, -lo]),
                        lb=np.full(n, -np.inf), ub=np.full(n, np.inf))
        want = tt.solve_qp_native(qp).x.numpy()
        scale = np.abs(want).max()
        assert np.abs(U[lane].numpy() - want).max() <= 1e-7 * scale
        z = Z @ want
        active += int(np.sum(np.isclose(z, lo, atol=1e-9)
                             | np.isclose(z, hi, atol=1e-9)))
    assert active > 0, "the draw should bind some ZMP bound"


def test_pointmass_control_misses_the_limit():
    """The reference in float32 (the precision below the configuration's
    float64 controls) misses ``u_gap``'s limit at a test size."""
    cfg = dict(_cfg("pointmass_ltv_fleet"), lanes=8)
    raw = plan_chain.make_inputs(cfg, 3, "cpu")
    x0 = torch.tensor([[0.0, -1.5]], dtype=torch.float64).repeat(8, 1)
    x0[:, 1] += torch.linspace(-0.2, 0.2, 8, dtype=torch.float64)
    lanes = list(range(8))
    U, _ = pm.controls(cfg, raw, x0, lanes)
    U32, _ = pm.controls(cfg, raw, x0, lanes, "float32")
    gap = float((U32.double() - U).abs().max() / U.abs().max())
    limits = harness.load_json(os.path.join(
        harness.BENCH_DIR, "checks", "pointmass4096.chained.json"))
    assert gap > 3 * limits["u_gap"]
