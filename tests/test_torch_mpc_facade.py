"""``solve_mpc``, the ``LMPC`` facade and ``solve_mpc_batch`` of the PyTorch
port against the JAX reference and the reference's golden vectors
(``tests/fixtures.py``), on the CPU in f64.

Tolerances: the golden contract of ``tests/test_mpc_golden.py`` (trajectory
1e-4, control 2e-4 in the 2-norm, dynamics replay 1e-10); 1e-8 between the
two implementations (both polish to the same vertex); 1e-5 against the
native oracle (the library's accuracy contract).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.parallel import solve_mpc_batch as jax_solve_mpc_batch
from copra_tpu_torch import parallel as tpar
from fixtures import (A, B, D, GOLDEN_CONTROL, GOLDEN_LTV_CONTROL,
                      GOLDEN_LTV_TRAJECTORY, GOLDEN_TRAJECTORY, INEQ_E,
                      INEQ_G, INEQ_H, INEQ_P, M, N_MAT, SMALL_N, SMALL_X0,
                      U_LOWER, U_UPPER, UD, WU, WX, XD, X_LOWER, X_UPPER,
                      ltv_matrices)

tt.set_default_device("cpu")


def _terms(mod, general=False):
    costs = [mod.TargetCost.create(M, XD, weights=WX),
             mod.ControlCost.create(N_MAT, UD, weights=WU)]
    constraints = [mod.TrajectoryBoundConstraint.create(X_LOWER, X_UPPER),
                   mod.ControlBoundConstraint.create(U_LOWER, U_UPPER)]
    if general:
        constraints = [mod.TrajectoryConstraint.create(INEQ_E, INEQ_P),
                       mod.ControlConstraint.create(INEQ_G, INEQ_H)
                       ] + constraints
    return costs, constraints


def _controller(mod, system, general=False, **kw):
    controller = mod.LMPC(system, **kw)
    costs, constraints = _terms(mod, general)
    for c in costs:
        controller.add_cost(c)
    for c in constraints:
        controller.add_constraint(c)
    return controller


def _check_contract(system, X, U, golden_traj, golden_u):
    assert np.linalg.norm(X.numpy() - golden_traj) <= 1e-4
    assert np.linalg.norm(U.numpy() - golden_u) <= 2e-4
    assert float(tt.replay_dynamics(system, X, U)) <= 1e-10
    assert U.numpy().max() <= U_UPPER[0] + 1e-6
    assert X.numpy()[1::2].max() <= X_UPPER[1] + 1e-6


def test_small_system_golden_lmpc_facade():
    system = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    controller = _controller(tt, system)
    assert controller.solve()
    _check_contract(system, controller.trajectory(), controller.control(),
                    GOLDEN_TRAJECTORY, GOLDEN_CONTROL)
    assert controller.solve_time() > 0
    assert controller.solve_and_build_time() >= controller.solve_time()
    assert controller.inform().startswith("solved")
    assert controller.results().control is controller.control()
    assert controller.deadline_info() is None
    # the SmallSystem drive: control()[0] ~ 99.09
    assert abs(float(controller.control()[0]) - 99.09) < 5e-3


def test_small_time_variant_golden_functional():
    system = tt.LTVSystem.create(*ltv_matrices(), SMALL_X0)
    costs, constraints = _terms(tt)
    res = tt.solve_mpc(system, costs, constraints)
    assert isinstance(res, tt.MPCResult)
    _check_contract(system, res.trajectory, res.control,
                    GOLDEN_LTV_TRAJECTORY, GOLDEN_LTV_CONTROL)


@pytest.mark.parametrize("general", [False, True])
def test_lmpc_matches_reference_with_warm_starts(general):
    """The same receding-horizon drive through both facades: a cold solve,
    then ``set_initial_state`` + ``solve(warm_start=True)`` twice; controls
    within 1e-8, statuses and iteration counts equal."""
    jc = _controller(ct, ct.LTISystem.create(A, B, D, SMALL_X0, SMALL_N),
                     general)
    tc = _controller(tt, tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N),
                     general)
    for t in range(3):
        warm = t > 0
        if warm:
            x0 = SMALL_X0 + np.array([0.002, 0.03]) * t
            jc.set_initial_state(jnp.asarray(x0))
            tc.set_initial_state(x0)
        assert jc.solve(warm_start=warm) == tc.solve(warm_start=warm)
        np.testing.assert_allclose(tc.control().numpy(),
                                   np.asarray(jc.control()), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(tc.trajectory().numpy(),
                                   np.asarray(jc.trajectory()), rtol=0,
                                   atol=1e-8)
        js, ts = jc.results().solution, tc.results().solution
        assert int(ts.status) == int(js.status)
        assert int(ts.iterations) == int(js.iterations)


def test_active_set_solver_through_the_facade():
    """``solver="active_set"`` (the native oracle) and the default ADMM
    agree to 1e-5; ``select_qp_solver`` and ``use_solver`` swap the
    backend of a live controller."""
    system = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    exact = _controller(tt, system, general=True, solver="active_set")
    assert exact.solve()
    admm = _controller(tt, system, general=True)
    assert admm.solve()
    assert float((admm.control() - exact.control()).abs().max()) <= 1e-5
    admm.select_qp_solver("active_set")
    assert admm.solve()
    assert torch.equal(admm.control(), exact.control())
    calls = []

    def custom(qp, options, warm):
        calls.append(qp.nr_vars)
        return tt.solve_qp(qp, options.replace(polish=False), warm)

    admm.use_solver(custom)
    admm.solve()
    assert calls == [SMALL_N]


def test_facade_errors_and_registry_edits():
    system = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    with pytest.raises(tt.SolverError, match="unknown QP solver"):
        tt.LMPC(system, solver="qpoases")
    controller = tt.LMPC(system)
    for call in (controller.control, controller.trajectory,
                 controller.results, controller.inform):
        with pytest.raises(tt.InitializationError, match="solve"):
            call()
    bound = tt.ControlBoundConstraint.create(U_LOWER, U_UPPER)
    controller.add_constraint(bound)
    with pytest.raises(tt.InitializationError, match="already registered"):
        controller.add_constraint(bound)
    with pytest.raises(tt.DimensionError):
        controller.add_cost(tt.TargetCost.create(np.eye(3), np.zeros(3)))
    # no costs: the ridge-only QP solves (U = 0 inside the bounds)
    assert controller.solve()
    assert float(controller.control().abs().max()) < 1e-6
    cost = controller.add_cost(tt.TargetCost.create(M, XD, weights=WX))
    assert controller.costs == (cost,)
    assert controller.constraints == (bound,)
    controller.remove_cost(cost)
    controller.remove_constraint(bound)
    assert controller.costs == () and controller.constraints == ()
    controller.add_cost(cost)
    controller.reset_costs()
    controller.reset_constraints()
    assert controller.costs == ()
    other = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N + 2)
    controller.initialize_controller(other)
    assert controller.system is other
    controller.options = tt.SolverOptions(max_iter=7)
    assert controller.options.max_iter == 7


def test_deadline_budget_and_print_level(caplog):
    """``max_wall_time_ms`` clamps ``max_iter`` to the measured fit (the
    analog of ``tests/test_deadline_verbosity.py``): a 0.1 microsecond
    budget leaves one iteration, a generous one keeps the cap, and a
    registry change drops the calibration.  On the CPU the basis is the
    wall.  ``print_level`` 3 logs the status table."""
    system = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    tiny = _controller(tt, system, options=tt.SolverOptions(
        max_iter=5000, early_exit=False, max_wall_time_ms=1e-4))
    assert tiny.deadline_info() is None
    tiny.solve()
    info = tiny.deadline_info()
    assert info["budget_iters"] == 1 and not info["budget_feasible"]
    assert info["marginal_ms_per_iter"] > 0
    assert info["calibration_basis"] == "wall"
    assert info["probe_device_ms"] is None
    assert set(info["probe_wall_ms"]) == {16, 116}
    assert int(tiny.results().solution.iterations) == 1

    roomy = _controller(tt, system, options=tt.SolverOptions(
        max_iter=60, early_exit=False, max_wall_time_ms=60_000.0,
        print_level=3))
    with caplog.at_level(logging.INFO, logger="copra_tpu_torch.lmpc"):
        roomy.solve()
    assert roomy.deadline_info()["budget_iters"] == 60
    assert int(roomy.results().solution.iterations) == 60
    assert any("solve (" in r.message for r in caplog.records)
    assert any("status" in r.message for r in caplog.records)
    roomy.add_cost(tt.ControlCost.create(N_MAT, UD, weights=WU))
    assert roomy.deadline_info() is None


def test_as_plan_and_as_stagewise_step():
    """The registry frozen into a plan step and into a stagewise tick: both
    deliver the facade's own controls (1e-5, the serving contract)."""
    system = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    controller = tt.LMPC(system)
    costs, _ = _terms(tt)
    for c in costs:
        controller.add_cost(c)
    controller.add_constraint(tt.ControlBoundConstraint.create(U_LOWER,
                                                               U_UPPER))
    assert controller.solve()
    want = controller.control()
    plan, step = controller.as_plan(tt.SolverOptions(max_iter=4000))
    assert isinstance(plan, tt.ControlPlan)
    u, sol, _ = step(SMALL_X0, None)
    assert int(sol.status) == tt.STATUS_SOLVED
    assert float((u - want).abs().max()) <= 1e-5
    tick = controller.as_stagewise_step(
        tt.SolverOptions(max_iter=100, early_exit=False, polish=False,
                         eps_abs=1e-9, eps_rel=1e-9), backend="xla")
    _, U, _, _ = tick(torch.tensor(SMALL_X0))
    assert float((U.reshape(-1) - want).abs().max()) <= 1e-5


def test_solve_mpc_batch_matches_reference():
    """A batch of initial states on shared dynamics, and a fully stacked
    batch, against the reference's vmap: lane 0 meets the golden vectors,
    every lane the reference (1e-8), with equal statuses."""
    rng = np.random.default_rng(3)
    x0s = SMALL_X0[None] + np.concatenate(
        [np.zeros((1, 2)), rng.normal(scale=[0.01, 0.1], size=(4, 2))])
    jcosts, jcons = _terms(ct)
    tcosts, tcons = _terms(tt)
    jsys = ct.LTISystem.create(A, B, D, SMALL_X0, SMALL_N).with_x0(
        jnp.asarray(x0s))
    tsys = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N).with_x0(x0s)
    want = jax.jit(lambda s: jax_solve_mpc_batch(s, jcosts, jcons))(jsys)
    got = tt.solve_mpc_batch(tsys, tcosts, tcons)
    assert tuple(got.control.shape) == (5, SMALL_N)
    np.testing.assert_allclose(got.control.numpy(), np.asarray(want.control),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.trajectory.numpy(),
                               np.asarray(want.trajectory), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.solution.status.numpy(),
                                  np.asarray(want.solution.status))
    assert np.linalg.norm(got.control[0].numpy() - GOLDEN_CONTROL) <= 2e-4
    # warm: batched warm leaves
    warm = tt.WarmStart(x=got.solution.x, y=got.solution.y, z=got.solution.z)
    again = tt.solve_mpc_batch(tsys, tcosts, tcons, warm_start=warm)
    assert float((again.control - got.control).abs().max()) <= 1e-8
    assert int(again.solution.iterations.max()) <= int(
        got.solution.iterations.max())

    # the axes helpers and stack_systems
    axes = tpar.batch_axes(tsys)
    assert (axes.A, axes.B, axes.d, axes.x0) == (None, None, None, 0)
    assert tpar.batch_size(tsys) == 5
    assert tpar.warm_start_axes(warm) == tt.WarmStart(0, 0, 0)
    with pytest.raises(ValueError, match="no batched leaf"):
        tpar.batch_size(tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N))
    with pytest.raises(ValueError, match="no batched leaf"):
        tt.solve_mpc_batch(tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N))
    stacked = tpar.stack_systems([
        tt.LTVSystem.create(*ltv_matrices(), x0) for x0 in x0s[:2]])
    assert tuple(stacked.A.shape) == (2, SMALL_N, 2, 2)
    assert tpar.batch_size(stacked) == 2
    res = tt.solve_mpc_batch(stacked, tcosts, tcons)
    assert np.linalg.norm(res.control[0].numpy() - GOLDEN_LTV_CONTROL) <= 2e-4
