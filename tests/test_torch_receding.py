"""The port's receding-horizon loop against the JAX reference, on the CPU in
float64 (analog of ``tests/test_receding.py``).

The same numpy inputs (the reference's SmallSystem fixture, N = 10, with
its target and control costs and the v <= 0, u <= 200 bounds) go through
``copra_tpu.receding`` and ``copra_tpu_torch.receding``.  Tolerances: the
golden contract of ``tests/fixtures.py`` (trajectory 1e-4, control 2e-4);
each test's docstring states the distance measured when it was written.
Shapes of the warm-start helpers are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.receding import closed_loop as jax_closed_loop
from copra_tpu_torch.parallel.batch import stack_systems
from copra_tpu_torch.receding import (closed_loop, cold_start,
                                      make_receding_step, shift_warm_start)
from fixtures import (A, B, D, M, N_MAT, SMALL_N, SMALL_X0, UD, U_LOWER,
                      U_UPPER, WU, WX, XD, X_LOWER, X_UPPER)

tt.set_default_device("cpu")

TRAJ_TOL, CONTROL_TOL = 1e-4, 2e-4


def _setup(pkg, x0=SMALL_X0, bounds=True):
    system = pkg.LTISystem.create(A, B, D, x0, SMALL_N)
    costs = (pkg.TargetCost.create(M, XD, weights=WX),
             pkg.ControlCost.create(N_MAT, UD, weights=WU))
    constraints = (pkg.ControlBoundConstraint.create(U_LOWER, U_UPPER),)
    if bounds:
        constraints = (pkg.TrajectoryBoundConstraint.create(X_LOWER,
                                                            X_UPPER),
                       ) + constraints
    return system, costs, constraints


def _batch_x0(batch=8, seed=3):
    rng = np.random.default_rng(seed)
    x0s = SMALL_X0[None] + rng.normal(scale=[0.02, 0.2], size=(batch, 2))
    x0s[:, 1] = np.minimum(x0s[:, 1], -0.2)
    return x0s


def _held(got, want):
    """Max state and control distance of two ``ClosedLoopResult``s."""
    ds = float(np.abs(got.states.numpy() - np.asarray(want.states)).max())
    du = float(np.abs(got.controls.numpy()
                      - np.asarray(want.controls)).max())
    return ds, du


def test_shift_warm_start_and_cold_start_shapes():
    w = tt.WarmStart(x=torch.arange(6.0), y=torch.zeros(3),
                     z=torch.zeros(3))
    s = shift_warm_start(w, udim=2)
    assert s.x.tolist() == [2, 3, 4, 5, 4, 5]
    assert s.y is w.y and s.z is w.z
    lanes = tt.WarmStart(x=torch.arange(12.0).reshape(2, 6),
                         y=torch.zeros(2, 3), z=torch.zeros(2, 3))
    assert shift_warm_start(lanes, 2).x.tolist() == [
        [2, 3, 4, 5, 4, 5], [8, 9, 10, 11, 10, 11]]
    system, costs, constraints = _setup(tt)
    preview = tt.condense(system)
    qp = tt.build_qp(preview, system.x0, costs, constraints)
    w = cold_start(preview, qp.nr_eq, qp.nr_ineq, torch.float64)
    jsys, jcosts, jcons = _setup(ct)
    jpre = ct.condense(jsys)
    jqp = ct.build_qp(jpre, jsys.x0, jcosts, jcons)
    from copra_tpu.receding import cold_start as jax_cold_start
    jw = jax_cold_start(jpre, jqp.nr_eq, jqp.nr_ineq)
    for f in ("x", "y", "z"):
        assert tuple(getattr(w, f).shape) == getattr(jw, f).shape
        assert not getattr(w, f).any()
    assert w.x.shape == (preview.full_udim,)
    assert w.y.shape == (qp.nr_eq + qp.nr_ineq + preview.full_udim,)


def test_receding_step_warm_matches_cold_and_reference():
    """The step from no warm start and re-solved from its own warm state:
    the same U (1e-6, the reference's test), and U against the
    reference's step at the golden tolerance (measured 1.9e-11, the
    warm state's primal too)."""
    system, costs, constraints = _setup(tt)
    opts = tt.SolverOptions(max_iter=3000)
    step, _ = make_receding_step(system, costs, constraints, opts)
    u0, U, sol, warm = step(system.x0, None)
    u0_w, U_w, sol_w, _ = step(system.x0, warm)
    assert float((U - U_w).abs().max()) <= 1e-6
    assert int(sol_w.iterations) <= int(sol.iterations)
    assert torch.equal(u0, U[:1])
    from copra_tpu.receding import make_receding_step as jax_step
    jsys, jcosts, jcons = _setup(ct)
    jstep, _ = jax_step(jsys, jcosts, jcons,
                        ct.SolverOptions(max_iter=3000))
    _, jU, _, jwarm = jstep(jsys.x0, None)
    assert float(np.abs(U.numpy() - np.asarray(jU)).max()) <= CONTROL_TOL
    assert float(np.abs(warm.x.numpy() - np.asarray(jwarm.x)).max()) \
        <= CONTROL_TOL


def test_closed_loop_rebuild_matches_reference():
    """60 ticks of the rebuild route: states and controls against the
    reference's ``closed_loop`` (measured 3.0e-14 and 1.8e-11), the
    regulation of the reference's test, and every tick's status."""
    opts = dict(max_iter=1500)
    system, costs, constraints = _setup(tt)
    res = closed_loop(system, costs, constraints, 60,
                      tt.SolverOptions(**opts))
    jsys, jcosts, jcons = _setup(ct)
    ref = jax.jit(lambda s: jax_closed_loop(
        s, jcosts, jcons, 60, ct.SolverOptions(**opts)))(jsys)
    assert tuple(res.states.shape) == (61, 2)
    assert tuple(res.controls.shape) == (60, 1)
    assert tuple(res.solutions.x.shape) == (60, SMALL_N)
    assert tuple(res.solutions.status.shape) == (60,)
    ds, du = _held(res, ref)
    assert ds <= TRAJ_TOL and du <= CONTROL_TOL, (ds, du)
    vel = res.states.numpy()[:, 1]
    assert vel.max() <= 1e-6
    assert abs(vel[-1] - XD[1]) < abs(vel[0] - XD[1])
    assert res.controls.numpy().max() <= U_UPPER[0] + 1e-6
    assert int(res.solutions.status.max()) == tt.STATUS_SOLVED
    np.testing.assert_array_equal(res.solutions.status.numpy(),
                                  np.asarray(ref.solutions.status))


def test_closed_loop_plan_route_matches_reference_and_rebuild():
    """20 ticks of ``use_plan=True``: against the reference's plan route at
    the golden tolerance (measured 1.2e-14 and 1.7e-11) and against the
    rebuild route at the reference's own tolerances (2e-4 states, 2e-3
    controls)."""
    opts = dict(max_iter=1500)
    system, costs, constraints = _setup(tt)
    plan = closed_loop(system, costs, constraints, 20,
                       tt.SolverOptions(**opts), use_plan=True)
    rebuild = closed_loop(system, costs, constraints, 20,
                          tt.SolverOptions(**opts))
    jsys, jcosts, jcons = _setup(ct)
    ref = jax_closed_loop(jsys, jcosts, jcons, 20, ct.SolverOptions(**opts),
                          use_plan=True)
    ds, du = _held(plan, ref)
    assert ds <= TRAJ_TOL and du <= CONTROL_TOL, (ds, du)
    assert float((plan.states - rebuild.states).abs().max()) <= 2e-4
    assert float((plan.controls - rebuild.controls).abs().max()) <= 2e-3
    assert tuple(plan.solutions.status.shape) == (20,)
    with pytest.raises(ValueError, match="lane dimensions"):
        closed_loop(system.with_x0(torch.tensor(_batch_x0())), costs,
                    constraints, 2, use_plan=True)


def test_closed_loop_batched_matches_vmap():
    """Eight scenarios as one batch (lanes on ``x0``) against
    ``jax.vmap(closed_loop)`` over ``system.with_x0``: the vmap's layout
    and its values (measured 6.5e-14 and 3.6e-11), v <= 0 on every lane."""
    x0s = _batch_x0()
    opts = dict(max_iter=1000)
    system, costs, constraints = _setup(tt)
    res = closed_loop(system.with_x0(torch.tensor(x0s)), costs, constraints,
                      20, tt.SolverOptions(**opts))
    jsys, jcosts, jcons = _setup(ct)
    ref = jax.jit(jax.vmap(lambda x0: jax_closed_loop(
        jsys.with_x0(x0), jcosts, jcons, 20, ct.SolverOptions(**opts))))(
        jnp.asarray(x0s))
    assert tuple(res.states.shape) == (8, 21, 2) == ref.states.shape
    assert tuple(res.controls.shape) == (8, 20, 1) == ref.controls.shape
    for f in ("x", "y", "status", "iterations", "primal_residual"):
        assert tuple(getattr(res.solutions, f).shape) == \
            getattr(ref.solutions, f).shape, f
    ds, du = _held(res, ref)
    assert ds <= TRAJ_TOL and du <= CONTROL_TOL, (ds, du)
    assert res.states.numpy()[:, :, 1].max() <= 1e-6


def test_closed_loop_batched_ltv_lanes_use_their_stage_zero():
    """Per-lane LTV dynamics stacked with ``stack_systems`` (A, B, d, x0
    all carry the lane): the default plant steps each lane with its own
    stage 0 (``A[:, 0]``), and the batch equals ``jax.vmap(closed_loop)``
    over the stacked systems (measured 5.8e-14 and 3.2e-11)."""
    rng = np.random.default_rng(5)
    x0s = _batch_x0(4, seed=7)
    As = np.repeat(np.repeat(A[None], SMALL_N, 0)[None], 4, 0)
    As = As + rng.normal(scale=1e-3, size=As.shape)
    Bs = np.repeat(np.repeat(B[None], SMALL_N, 0)[None], 4, 0)
    Ds = np.repeat(np.repeat(D[None], SMALL_N, 0)[None], 4, 0)
    opts = dict(max_iter=1000)
    _, costs, constraints = _setup(tt)
    system = stack_systems([tt.LTVSystem.create(As[i], Bs[i], Ds[i], x0s[i])
                            for i in range(4)])
    res = closed_loop(system, costs, constraints, 6,
                      tt.SolverOptions(**opts))
    _, jcosts, jcons = _setup(ct)

    def run(a, b, d, x0):
        return jax_closed_loop(ct.LTVSystem(A=a, B=b, d=d, x0=x0), jcosts,
                               jcons, 6, ct.SolverOptions(**opts))

    ref = jax.jit(jax.vmap(run))(*(jnp.asarray(v) for v in (As, Bs, Ds,
                                                             x0s)))
    assert tuple(res.states.shape) == (4, 7, 2)
    ds, du = _held(res, ref)
    assert ds <= TRAJ_TOL and du <= CONTROL_TOL, (ds, du)
    # the plant identity, lane by lane, with each lane's own stage 0
    X, U = res.states.numpy(), res.controls.numpy()
    for i in range(4):
        want = As[i, 0] @ X[i, 0] + Bs[i, 0] @ U[i, 0] + Ds[i, 0]
        np.testing.assert_allclose(X[i, 1], want, rtol=0, atol=1e-14)
