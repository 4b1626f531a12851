"""The reference's multi-dimensional suite (``tests/test_dims.py``: every
cost and constraint kind at x = 3, u = 2) on the PyTorch port, against the
JAX reference on the CPU.

Each case builds the same problem from one numpy draw on both sides,
asserts the reference's oracles on the port (``solve_mpc`` within 5e-6 of
the native active-set solution of the identically assembled QP, dynamics
replay <= 1e-9) and holds the port's controls against the reference's in
float64: 1e-8 for the condensed solves (both polish to one vertex), the
reference's own 5e-5 and 1e-5 for the stagewise engine and the plan step
against the condensed solve.
"""

import numpy as np
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.plan import make_control_plan as jax_make_plan
from copra_tpu.plan import make_plan_step as jax_make_step
from copra_tpu.qp.native import solve_qp_native as jax_native
from copra_tpu.qp.riccati import solve_mpc_stagewise as jax_stagewise
from copra_tpu_torch.qp.riccati import solve_mpc_stagewise
from _one_thread import one_torch_thread  # noqa: F401

tt.set_default_device("cpu")

X, U, N = 3, 2, 12
SAME_TOL = 1e-8
rng = np.random.default_rng(0)
A3 = 0.9 * np.eye(X) + 0.05 * rng.normal(size=(X, X))
B3 = rng.normal(size=(X, U))
D3 = 0.01 * rng.normal(size=X)
X0 = rng.normal(size=X)


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def solve_both(make_costs, make_constraints, max_iter=8000):
    """The reference's ``solve_both`` on each package, then the port against
    the reference.  ``make_*`` take the package.  Returns the port's
    result."""
    out = []
    for pkg, native in ((ct, jax_native), (tt, tt.solve_qp_native)):
        costs, constraints = make_costs(pkg), make_constraints(pkg)
        system = pkg.LTISystem.create(A3, B3, D3, X0, N)
        res = pkg.solve_mpc(system, costs, constraints,
                            pkg.SolverOptions(max_iter=max_iter))
        qp = pkg.build_qp(pkg.condense(system), system.x0, tuple(costs),
                          tuple(constraints))
        exact = native(qp)
        assert int(_np(exact.status)) == pkg.STATUS_SOLVED
        np.testing.assert_allclose(_np(res.control), _np(exact.x),
                                   atol=5e-6)
        assert float(pkg.replay_dynamics(system, res.trajectory,
                                         res.control)) <= 1e-9
        out.append(res)
    ref, got = out
    np.testing.assert_allclose(_np(got.control), _np(ref.control), rtol=0,
                               atol=SAME_TOL)
    np.testing.assert_allclose(_np(got.trajectory), _np(ref.trajectory),
                               rtol=0, atol=SAME_TOL)
    return got


def test_multidim_trajectory_and_control_costs():
    draw = np.random.default_rng(1)
    Mm, p = draw.normal(size=(2, X)), draw.normal(size=2)
    Nn, q = draw.normal(size=(3, U)), draw.normal(size=3)
    solve_both(lambda pkg: [
        pkg.TrajectoryCost.create(Mm, p, weights=[2.0, 1.0]),
        pkg.ControlCost.create(Nn, q, weights=[0.1, 0.2, 0.3])],
        lambda pkg: [pkg.ControlBoundConstraint.create([-5.0] * U,
                                                       [5.0] * U)])


def test_multidim_target_and_mixed_costs():
    draw = np.random.default_rng(2)
    xd = draw.normal(size=X)
    Me, Ne, pe = (draw.normal(size=(2, X)), draw.normal(size=(2, U)),
                  draw.normal(size=2))
    solve_both(lambda pkg: [
        pkg.TargetCost.create(np.eye(X), xd, weights=[5.0] * X),
        pkg.MixedCost.create(Me, Ne, pe, weights=[0.5, 0.5]),
        pkg.SimpleControlCost.create(np.zeros(U), weights=[1e-2] * U)],
        lambda pkg: [pkg.ControlBoundConstraint.create([-8.0] * U,
                                                       [8.0] * U)])


def test_multidim_all_constraint_kinds():
    draw = np.random.default_rng(3)
    E, G = draw.normal(size=(1, X)), draw.normal(size=(1, U))
    Em, Gm = draw.normal(size=(1, X)), draw.normal(size=(1, U))
    solve_both(lambda pkg: [
        pkg.TargetCost.create(np.eye(X), np.zeros(X), weights=[10.0] * X),
        pkg.SimpleControlCost.create(np.zeros(U), weights=[0.1] * U)],
        lambda pkg: [
            pkg.TrajectoryConstraint.create(E, np.array([4.0])),
            pkg.ControlConstraint.create(G, np.array([3.0])),
            pkg.MixedConstraint.create(Em, Gm, np.array([6.0])),
            pkg.TrajectoryBoundConstraint.create(
                [-np.inf, -10.0, -np.inf], [10.0, np.inf, 12.0]),
            pkg.ControlBoundConstraint.create([-6.0] * U, [6.0] * U)])


def test_multidim_equality_rows():
    E = np.random.default_rng(4).normal(size=(1, X))
    f = (E @ X0).reshape(1)
    res = solve_both(lambda pkg: [
        pkg.SimpleTrajectoryCost.create(np.zeros(X), weights=[1.0] * X),
        pkg.SimpleControlCost.create(np.zeros(U), weights=[1e-3] * U)],
        lambda pkg: [pkg.TrajectoryConstraint.create(E, f,
                                                     is_inequality=False)])
    Xb = _np(res.trajectory).reshape(N + 1, X)
    np.testing.assert_allclose(Xb @ E[0], f[0], atol=1e-5)


def _box_terms(pkg, simple_u=False):
    x_cost = pkg.TargetCost.create(np.eye(X), np.zeros(X),
                                   weights=[5.0] * X)
    u_cost = (pkg.SimpleControlCost.create(np.zeros(U), weights=[0.1] * U)
              if simple_u else pkg.ControlCost.create(
                  np.eye(U), np.zeros(U), weights=[0.1] * U))
    return ((x_cost, u_cost),
            (pkg.ControlBoundConstraint.create([-2.0] * U, [2.0] * U),))


def test_multidim_stagewise_matches_condensed():
    got = {}
    for pkg, stagewise in ((ct, jax_stagewise), (tt, solve_mpc_stagewise)):
        costs, cons = _box_terms(pkg)
        system = pkg.LTISystem.create(A3, B3, D3, X0, N)
        ref = pkg.solve_mpc(system, costs, cons, pkg.SolverOptions(
            max_iter=8000, eps_abs=1e-7, eps_rel=0.0))
        _, Us, _ = stagewise(system, costs, cons, pkg.SolverOptions(
            max_iter=2000, early_exit=False))
        np.testing.assert_allclose(_np(Us).reshape(-1), _np(ref.control),
                                   atol=5e-5)
        got[pkg] = _np(Us)
    np.testing.assert_allclose(got[tt], got[ct], rtol=0, atol=1e-9)


def test_multidim_plan_paths():
    got = {}
    for pkg, make_plan, make_step in (
            (ct, jax_make_plan, jax_make_step),
            (tt, tt.make_control_plan, tt.make_plan_step)):
        costs, cons = _box_terms(pkg, simple_u=True)
        system = pkg.LTISystem.create(A3, B3, D3, X0, N)
        plan = make_plan(system, costs, cons)
        step = make_step(plan, pkg.SolverOptions(max_iter=2000))
        Uv, _, _ = step(X0, None)
        ref = pkg.solve_mpc(system, costs, cons,
                            pkg.SolverOptions(max_iter=8000))
        np.testing.assert_allclose(_np(Uv), _np(ref.control), atol=1e-5)
        got[pkg] = _np(Uv)
    np.testing.assert_allclose(got[tt], got[ct], rtol=0, atol=1e-9)
