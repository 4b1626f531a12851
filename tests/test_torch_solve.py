"""The port's no-knobs entry points against the JAX reference, on the CPU:
``solve`` on every engine and route, and ``make_stagewise_server`` on a
small ZMP fleet (analogs of ``tests/test_solve_noknobs.py``).

Inputs are the reference's golden fixtures and numpy-built systems, fed to
both packages.  Tolerances: the golden control contract (2e-4) and the
replay bound (1e-8) for every engine; 1e-9 between the two packages where
both run the same exact computation (the direct LQR sweep, the native
engine); 1e-6 relative against the native oracle for the direct LQR route,
as the reference holds it.  The N = 400 automatic stagewise route and the
N = 40 server run on the card (``tests/test_torch_noknobs_cuda.py``); here
the N = 400 routing decision is checked without the solve.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
import fixtures as fx
from copra_tpu_torch.qp.riccati import StagewiseQP, from_mpc
from copra_tpu_torch.solve import _route

tt.set_default_device("cpu")

GOLDEN_TOL = 2e-4


def _small(pkg, dtype=np.float64):
    """The reference's SmallSystem (N = 10) with its costs and bounds,
    every array in ``dtype``."""
    a = lambda v: np.asarray(v, dtype)
    system = pkg.LTISystem.create(a(fx.A), a(fx.B), a(fx.D),
                                  a(fx.SMALL_X0), fx.SMALL_N)
    costs = (pkg.TargetCost.create(a(fx.M), a(fx.XD), weights=a(fx.WX)),
             pkg.ControlCost.create(a(fx.N_MAT), a(fx.UD),
                                    weights=a(fx.WU)))
    cons = (pkg.TrajectoryBoundConstraint.create(a(fx.X_LOWER),
                                                 a(fx.X_UPPER)),
            pkg.ControlBoundConstraint.create(a(fx.U_LOWER), a(fx.U_UPPER)))
    return system, costs, cons


@pytest.mark.parametrize("engine", ["auto", "condensed", "stagewise"])
def test_solve_meets_golden_contract_no_options(engine):
    """Every engine, no options: solved, the golden controls within 2e-4,
    the trajectory replays within 1e-8, and the reference's answer on the
    same engine within 2e-4."""
    system, costs, cons = _small(tt)
    res = tt.solve(system, costs, cons, engine=engine)
    assert int(res.solution.status) == tt.STATUS_SOLVED
    u = res.control.numpy().ravel()
    assert np.abs(u - fx.GOLDEN_CONTROL).max() < GOLDEN_TOL
    assert float(tt.replay_dynamics(system, res.trajectory,
                                    res.control)) <= 1e-8
    want = ct.solve(*_small(ct), engine=engine)
    assert np.abs(u - np.asarray(want.control)).max() < GOLDEN_TOL


def test_solve_native_engine_matches_reference():
    """``engine='native'``: the exact engine, as the reference's (1e-9)."""
    system, costs, cons = _small(tt)
    res = tt.solve(system, costs, cons, engine="native")
    u = res.control.numpy().ravel()
    assert np.abs(u - fx.GOLDEN_CONTROL).max() < GOLDEN_TOL
    want = ct.solve(*_small(ct), engine="native")
    np.testing.assert_allclose(u, np.asarray(want.control), rtol=0,
                               atol=1e-9)


def test_solve_reports_infeasible_honestly():
    """Crossed bounds: never a silent 'solved'; the status class is the
    reference's."""
    system, costs, _ = _small(tt)
    res = tt.solve(system, costs,
                   (tt.ControlBoundConstraint.create([2.0], [-2.0]),))
    status = int(res.solution.status)
    assert status in (tt.STATUS_PRIMAL_INFEASIBLE, tt.STATUS_MAX_ITER,
                      tt.STATUS_DUAL_INFEASIBLE)
    jsys, jcosts, _ = _small(ct)
    want = ct.solve(jsys, jcosts,
                    (ct.ControlBoundConstraint.create([2.0], [-2.0]),))
    assert status == int(np.asarray(want.solution.status))


def test_solve_rejects_unknown_engine():
    system, costs, cons = _small(tt)
    with pytest.raises(ValueError, match="unknown engine"):
        tt.solve(system, costs, cons, engine="quantum")


def test_solve_unconstrained_is_direct_lqr():
    """Cost-only problems take the one-sweep LQ solve: ``iterations ==
    1``, the reference's controls within 1e-9, the native oracle within
    1e-6 relative."""
    system, costs, _ = _small(tt)
    res = tt.solve(system, costs, ())
    assert int(res.solution.status) == tt.STATUS_SOLVED
    assert int(res.solution.iterations) == 1
    jsys, jcosts, _ = _small(ct)
    want = ct.solve(jsys, jcosts, ())
    np.testing.assert_allclose(res.control.numpy(),
                               np.asarray(want.control), rtol=0, atol=1e-9)
    qp = tt.build_qp(tt.condense(system), system.x0, costs, ())
    exact = tt.solve_qp_native(qp).x
    scale = max(1.0, float(exact.abs().max()))
    assert float((res.control - exact).abs().max()) / scale <= 1e-6


def test_solve_float32_below_its_floor_routes_to_native():
    """float32 data under a 1e-5 contract (its floor 50 eps ~ 6e-6 is
    above a tenth of it): the exact float64 engine on the float32-assembled
    QP, its answer in float32, as the reference routes it (1e-4 relative
    to the reference's answer: the two packages assemble the QP in float32
    in other summation orders, and its 1e4 curvature amplifies that); a
    1e-2 contract stays iterative."""
    system, costs, cons = _small(tt, np.float32)
    assert _route(system, costs, cons, "auto", 1e-5)[1]
    assert not _route(system, costs, cons, "auto", 1e-2)[1]
    res = tt.solve(system, costs, cons)
    assert res.control.dtype == torch.float32
    qp = tt.build_qp(tt.condense(system), system.x0, costs, cons)
    assert qp.Q.dtype == torch.float32
    exact = tt.solve_qp_native(qp).x
    assert torch.equal(res.control, exact.float())
    assert torch.equal(res.solution.x, exact)
    want = np.asarray(ct.solve(*_small(ct, np.float32)).control)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(res.control.numpy() - want).max() / scale <= 1e-4


def test_solve_routes_long_horizons_to_stagewise():
    """The N = 400 case of the reference's test (400 variables > 300)
    routes to the stagewise engine; N = 100 stays condensed; both decided
    as the reference decides them (its ``_STAGEWISE_NVAR``)."""
    import sys

    jsolve = sys.modules["copra_tpu.solve"]
    T = 0.02
    A = np.array([[1.0, T], [0.0, 1.0]])
    B = np.array([[T * T / 2], [T]])
    costs = (tt.SimpleTrajectoryCost.create(np.zeros(2),
                                            weights=np.array([5.0, 0.5])),
             tt.SimpleControlCost.create(np.zeros(1),
                                         weights=np.array([1e-3])))
    cons = (tt.ControlBoundConstraint.create([-1.0], [1.0]),)
    for N, stagewise in ((400, True), (100, False)):
        system = tt.LTISystem.create(A, B, np.zeros(2), np.array([1.0, 0.0]),
                                     N)
        got = _route(system, costs, cons, "auto", 1e-5)
        assert got[0] is stagewise and not got[1]
        assert (N * 1 > jsolve._STAGEWISE_NVAR) is stagewise


def _zmp_fleet(pkg, N, lanes=2, T=0.02, h=0.8):
    """The reference test's small ZMP fleet at horizon ``N``, float32."""
    A = np.array([[1.0, T, T * T / 2], [0, 1.0, T], [0, 0, 1.0]])
    B = np.array([[T ** 3 / 6], [T * T / 2], [T]])
    Z = np.kron(np.eye(N + 1), np.array([[1.0, 0.0, -h / 9.81]]))
    ref = np.array([0.1 * min(k // 14, 2) for k in range(N + 1)])
    arr = ((lambda a: torch.tensor(np.asarray(a, np.float32)))
           if pkg is tt else (lambda a: jnp.asarray(a, jnp.float32)))
    system = pkg.LTISystem.create(arr(A), arr(B), arr(np.zeros(3)),
                                  arr(np.zeros(3)), N)
    costs = (pkg.TrajectoryCost(M=arr(Z), p=arr(ref),
                                weights=arr(np.ones(N + 1))),
             pkg.SimpleControlCost(p=arr(np.zeros(N)),
                                   weights=arr(np.full(N, 1e-6))))
    cons = (pkg.TrajectoryConstraint(E=arr(Z), f=arr(ref + 0.05)),
            pkg.TrajectoryConstraint(E=arr(-Z), f=arr(-(ref - 0.05))))
    return system, costs, cons


def test_stagewise_server_no_knobs_fleet():
    """``make_stagewise_server`` at N = 10 on the CPU (the reference test's
    fleet cut from N = 40): a measured policy (equilibrated, as the
    reference decides for this spread; rho among the candidates; a top-up
    of 4 times the warm budget), converged ticks, and the applied control
    of lane 0 within 1e-4 of the native oracle, relative.  The probes'
    values against the reference's are held in
    ``tests/test_torch_policies.py``: here, at the float32 floor, the
    candidates tie within float32 noise."""
    from copra_tpu_torch.qp.riccati import _curvature_spread

    N = 10
    system, costs, cons = _zmp_fleet(tt, N)
    sqp = from_mpc(system, costs, cons)
    fleet = StagewiseQP(**{
        f.name: None if getattr(sqp, f.name) is None
        else getattr(sqp, f.name).expand(
            (2,) + getattr(sqp, f.name).shape).contiguous()
        for f in dataclasses.fields(sqp)})
    tick, policy = tt.make_stagewise_server(fleet, return_policy=True)
    assert policy["scaled"] is (_curvature_spread(fleet) > 1e4)
    assert policy["rho"] in (0.03, 0.1, 0.3, 1.0, 3.0)
    assert policy["warm_iters"] in (10, 20, 30, 50, 80, 120, 200)
    assert policy["options"].topup_iters == 4 * policy["warm_iters"]
    assert policy["options"].eps_abs == 1e-5
    X, U, info, warm = tick(torch.zeros((2, 3)))
    assert bool((info.status == tt.STATUS_SOLVED).all()), info.inform()
    x1 = X[:, 1]
    X, U, info, warm = tick(x1, warm)
    assert bool((info.status == tt.STATUS_SOLVED).all()), info.inform()
    plan = tt.make_control_plan(system, costs, cons)
    exact = tt.solve_qp_native(tt.plan_qp(plan, x1[0].double())).x
    scale = max(1.0, float(exact.abs().max()))
    assert abs(float(U[0, 0, 0]) - float(exact[0])) / scale <= 1e-4
