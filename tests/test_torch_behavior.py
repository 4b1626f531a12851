"""The reference's end-to-end behaviour suite (``tests/test_behavior.py``)
on the PyTorch port, against the JAX reference on the CPU.

Each case runs the same fixture through ``copra_tpu.solve_mpc`` and
``copra_tpu_torch.solve_mpc`` (float64, the plain route), asserts the
reference's own oracles on the port's result (status solved, dynamics
replay <= 1e-10, terminal velocity within 1e-3 of the target, every
constraint held to 1e-6) and holds the port's trajectory and controls
against the reference's, both at the golden tolerances (trajectory 1e-4,
control 2e-4) and, since both run float64 to the same vertex, at 1e-7.
The N = 300 canary runs here too (the port's plain route takes about a
second for it); ``chip_smoke.py`` phase 34 runs it on the card.
"""

import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from fixtures import (A, B, D, EQ_E, EQ_P, EQ_X0, INEQ_E, INEQ_G, INEQ_H,
                      INEQ_P, M, MIXED_E, MIXED_G, MIXED_P, N_MAT, UD,
                      U_LOWER, U_UPPER, WU, WX, XD, X_LOWER, X_UPPER)
from _one_thread import one_torch_thread  # noqa: F401

tt.set_default_device("cpu")

N_STEP = 100
X0 = np.array([0.0, -5.0])
TRAJ_TOL, CONTROL_TOL, REPLAY_TOL, CONS_TOL = 1e-4, 2e-4, 1e-10, 1e-6
SAME_TOL = 1e-7
COST_KINDS = ["target", "trajectory", "mixed"]


def _opts(pkg, max_iter=4000):
    return pkg.SolverOptions(max_iter=max_iter, eps_abs=1e-7, eps_rel=0.0)


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def x_cost_of(pkg, kind, xd=XD):
    if kind == "target":
        return pkg.TargetCost.create(M, xd, weights=WX)
    if kind == "trajectory":
        return pkg.TrajectoryCost.create(M, xd, weights=WX)
    return pkg.MixedCost.create(M, np.zeros((2, 1)), xd, weights=WX)


def u_cost_of(pkg, kind):
    if kind == "mixed":
        return pkg.MixedCost.create(np.zeros((1, 2)), N_MAT, UD, weights=WU)
    return pkg.ControlCost.create(N_MAT, UD, weights=WU)


def _constraints(pkg, flavour):
    if flavour == "bounded":
        return [pkg.TrajectoryBoundConstraint.create(X_LOWER, X_UPPER),
                pkg.ControlBoundConstraint.create(U_LOWER, U_UPPER)]
    if flavour == "ineq":
        return [pkg.TrajectoryConstraint.create(INEQ_E, INEQ_P),
                pkg.ControlConstraint.create(INEQ_G, INEQ_H)]
    if flavour == "mixed":
        return [pkg.MixedConstraint.create(MIXED_E, MIXED_G, MIXED_P)]
    return [pkg.TrajectoryConstraint.create(EQ_E, EQ_P, is_inequality=False)]


def solve_both(flavour, cost_kind, horizon=N_STEP, max_iter=4000):
    """The reference's ``solve`` on both packages: status, replay, and the
    port against the reference.  Returns the port's result."""
    x0, xd = (EQ_X0, np.zeros(2)) if flavour == "eq" else (X0, XD)
    out = []
    for pkg in (ct, tt):
        system = pkg.LTISystem.create(A, B, D, x0, horizon)
        costs = [x_cost_of(pkg, cost_kind, xd), u_cost_of(pkg, cost_kind)]
        res = pkg.solve_mpc(system, costs, _constraints(pkg, flavour),
                            _opts(pkg, max_iter))
        assert int(_np(res.solution.status).max()) == pkg.STATUS_SOLVED
        assert float(pkg.replay_dynamics(system, res.trajectory,
                                         res.control)) <= REPLAY_TOL
        out.append(res)
    ref, got = out
    X, U = _np(got.trajectory), _np(got.control)
    assert X.dtype == U.dtype == np.float64
    assert np.abs(X - _np(ref.trajectory)).max() <= min(TRAJ_TOL, SAME_TOL)
    assert np.abs(U - _np(ref.control)).max() <= min(CONTROL_TOL, SAME_TOL)
    return got


def check_physics(res, cost_kind, x0=X0, xd=XD):
    X = _np(res.trajectory)
    pos, vel = X[0::2], X[1::2]
    v_term = vel[-2] if cost_kind == "mixed" else vel[-1]
    assert abs(xd[1] - v_term) <= 1e-3
    assert pos.max() <= x0[0] + CONS_TOL
    return pos, vel, _np(res.control)


@pytest.mark.parametrize("cost_kind", COST_KINDS)
def test_bounded_system(cost_kind):
    res = solve_both("bounded", cost_kind)
    _, vel, control = check_physics(res, cost_kind)
    assert vel.max() <= X_UPPER[1] + CONS_TOL
    assert control.max() <= U_UPPER[0] + CONS_TOL


@pytest.mark.parametrize("cost_kind", COST_KINDS)
def test_ineq_system(cost_kind):
    res = solve_both("ineq", cost_kind)
    _, vel, control = check_physics(res, cost_kind)
    assert vel.max() <= INEQ_P[0] + CONS_TOL
    assert control.max() <= INEQ_H[0] + CONS_TOL


@pytest.mark.parametrize("cost_kind", COST_KINDS)
def test_mixed_system(cost_kind):
    res = solve_both("mixed", cost_kind)
    _, vel, control = check_physics(res, cost_kind)
    assert (vel[:-1] + control).max() <= MIXED_P[0] + CONS_TOL


@pytest.mark.parametrize("cost_kind", COST_KINDS)
def test_eq_system(cost_kind):
    res = solve_both("eq", cost_kind)
    X = _np(res.trajectory)
    pos, vel = X[0::2], X[1::2]
    assert abs(vel[-2 if cost_kind == "mixed" else -1]) <= 1e-3
    assert pos.max() <= EQ_X0[0] + CONS_TOL
    assert np.abs(pos).max() <= CONS_TOL


def test_bounded_system_n300_canary():
    res = solve_both("bounded", "target", horizon=300, max_iter=8000)
    _, vel, control = check_physics(res, "target")
    assert vel.max() <= X_UPPER[1] + CONS_TOL
    assert control.max() <= U_UPPER[0] + CONS_TOL


def _equivalent(pkg, x_costs, u_costs, horizon=30):
    """``solve_mpc`` of each (x cost, u cost) pair under the control bound:
    the controls and trajectories."""
    system = pkg.LTISystem.create(A, B, D, X0, horizon)
    bounds = [pkg.ControlBoundConstraint.create(U_LOWER, U_UPPER)]
    out = []
    for xc, uc in zip(x_costs, u_costs):
        res = pkg.solve_mpc(system, [xc, uc], bounds,
                            pkg.SolverOptions(max_iter=3000))
        out.append((_np(res.control), _np(res.trajectory)))
    return out


@pytest.mark.parametrize("which", ["trajectory", "control"])
def test_simple_cost_equivalence(which):
    """SimpleTrajectoryCost == TrajectoryCost with M = I, SimpleControlCost
    == ControlCost with N = I, per step and full horizon; the port's
    solves against the reference's at 1e-8."""
    n = 31 if which == "trajectory" else 30
    rows = 2 * n if which == "trajectory" else n
    got = {}
    for pkg in (ct, tt):
        span_m = lambda m: _np(pkg.span_matrix(m, rows))
        span_v = lambda v: _np(pkg.span_vector(v, rows))
        if which == "trajectory":
            u = pkg.ControlCost.create(N_MAT, UD, weights=WU)
            xs = [pkg.TrajectoryCost.create(M, XD, weights=WX),
                  pkg.SimpleTrajectoryCost.create(XD, weights=WX),
                  pkg.TrajectoryCost.create(span_m(M), span_v(XD),
                                            weights=span_v(WX)),
                  pkg.SimpleTrajectoryCost.create(span_v(XD),
                                                  weights=span_v(WX))]
            us = [u] * 4
        else:
            x = pkg.TargetCost.create(M, XD, weights=WX)
            us = [pkg.ControlCost.create(N_MAT, UD, weights=WU),
                  pkg.SimpleControlCost.create(UD, weights=WU),
                  pkg.ControlCost.create(span_m(N_MAT), span_v(UD),
                                         weights=span_v(WU)),
                  pkg.SimpleControlCost.create(span_v(UD),
                                               weights=span_v(WU))]
            xs = [x] * 4
        got[pkg] = _equivalent(pkg, xs, us)
    for sols in got.values():
        for (u_full, x_full), (u_simple, x_simple) in (sols[0:2], sols[2:4]):
            np.testing.assert_allclose(u_simple, u_full, atol=1e-8)
            np.testing.assert_allclose(x_simple, x_full, atol=1e-8)
    for (ut, xt), (uj, xj) in zip(got[tt], got[ct]):
        np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8)
        np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-8)
