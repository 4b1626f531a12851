"""The reference's honest-status suite (``tests/test_honest_status.py``)
on the PyTorch port, against the JAX reference on the CPU.

Fixed-count serving paths must still report non-convergence, real dual
residuals and infeasibility certificates.  Each case runs the same numpy
data through both packages, asserts the reference's own assertion on the
port's result and holds the port's status (equal) and numbers against the
reference's: 1e-8 in float64; in float32 2e-4 on U
(``tests/test_torch_plan_shared.py``'s tolerance) and 10% on the starved
tick's dual residual, which in this fixture is float32 rounding (~3e-4).

The reference's fused serving tick (``use_fused=True``, a Pallas kernel)
is held here by the port's plain route (``use_fused=True`` on CPU tensors
runs the kernel's plain version) against the reference's XLA route
(``use_fused=False``); the kernel itself is held against the plain version
on the card (``tests/test_torch_kernel_cuda.py``).  The mismatched
checkpoint template (``test_checkpoint_mismatched_template_raises``) is
held by ``tests/test_torch_checkpoint.py::test_mismatched_template_raises``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.plan import make_control_plan as jax_make_plan
from copra_tpu.plan import make_plan_step as jax_make_step
from copra_tpu.qp.riccati import solve_mpc_stagewise as jax_stagewise
from copra_tpu_torch.convert import plan_from_numpy
from copra_tpu_torch.qp.riccati import solve_mpc_stagewise
from fixtures import (A, B, D, M, N_MAT, SMALL_N, SMALL_X0, UD, U_LOWER,
                      U_UPPER, WU, WX, XD)
from _one_thread import one_torch_thread  # noqa: F401

tt.set_default_device("cpu")

SAME_TOL = 1e-8
F32_TOL = 2e-4


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def box_setup(pkg, dtype=np.float64):
    system = pkg.LTISystem.create(A.astype(dtype), B.astype(dtype),
                                  D.astype(dtype), SMALL_X0.astype(dtype),
                                  SMALL_N)
    costs = (pkg.TargetCost.create(M.astype(dtype), XD.astype(dtype),
                                   weights=WX.astype(dtype)),
             pkg.ControlCost.create(N_MAT.astype(dtype), UD.astype(dtype),
                                    weights=WU.astype(dtype)))
    constraints = (pkg.ControlBoundConstraint.create(
        U_LOWER.astype(dtype), U_UPPER.astype(dtype)),)
    return system, costs, constraints


def _same(got, want, tol=SAME_TOL, fields=("x", "primal_residual",
                                            "dual_residual")):
    np.testing.assert_array_equal(_np(got.status), _np(want.status))
    for name in fields:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   _np(getattr(want, name)), rtol=0,
                                   atol=tol, err_msg=name)


def _infeasible_qp(pkg):
    n = 4
    return pkg.DenseQP.create(
        np.eye(n), np.zeros(n), Aeq=np.array([[1.0, 0, 0, 0]]),
        beq=np.array([10.0]), lb=np.zeros(n), ub=np.ones(n))


def _feasible_qp(pkg):
    rng = np.random.default_rng(7)
    Q0 = rng.normal(size=(6, 6))
    return pkg.DenseQP.create(Q0 @ Q0.T + np.eye(6), rng.normal(size=6),
                              lb=-np.ones(6), ub=np.ones(6))


@pytest.mark.parametrize("case,want", [
    ("infeasible", ct.STATUS_PRIMAL_INFEASIBLE),
    ("feasible", ct.STATUS_SOLVED)])
def test_fixed_iteration_mode_status(case, want):
    """Serving runs ``early_exit=False``: an infeasible QP still gets the
    certificate there, a feasible one stays solved."""
    sols = []
    for pkg in (ct, tt):
        if case == "infeasible":
            opts = pkg.SolverOptions(max_iter=2000, early_exit=False,
                                     polish=False)
            qp = _infeasible_qp(pkg)
        else:
            opts = pkg.SolverOptions(max_iter=500, early_exit=False)
            qp = _feasible_qp(pkg)
        sol = pkg.solve_qp(qp, opts)
        assert int(_np(sol.status)) == want
        sols.append(sol)
    _same(sols[1], sols[0],
          fields=("x",) if case == "infeasible" else ("x", "primal_residual",
                                                      "dual_residual"))


def test_plan_step_single_reports_unconverged():
    """One iteration cannot converge a bound-active tick: status not
    solved, a real dual residual; a generous budget converges."""
    out = []
    for pkg, make_plan, make_step in (
            (ct, jax_make_plan, jax_make_step),
            (tt, tt.make_control_plan, tt.make_plan_step)):
        system, costs, constraints = box_setup(pkg)
        plan = make_plan(system, costs, constraints)
        step = make_step(plan, pkg.SolverOptions(max_iter=1, eps_abs=1e-9,
                                                 eps_rel=0.0))
        _, sol, _ = step(np.array([0.0, -8.0]), None)
        assert int(_np(sol.status)) != pkg.STATUS_SOLVED
        assert float(_np(sol.dual_residual)) > 0.0
        step_ok = make_step(plan, pkg.SolverOptions(max_iter=4000))
        _, sol_ok, _ = step_ok(SMALL_X0, None)
        assert int(_np(sol_ok.status)) == pkg.STATUS_SOLVED
        out.append((sol, sol_ok))
    for got, want in zip(out[1], out[0]):
        _same(got, want)


def _fused_lanes():
    rng = np.random.default_rng(3)
    return np.stack([np.array([0.0, -8.0]), SMALL_X0,
                     SMALL_X0 + rng.normal(scale=0.05, size=2),
                     np.array([0.2, -6.0])]).astype(np.float32)


def test_plan_step_fused_reports_unconverged():
    """Per-lane f32 plans, one iteration: some lane not solved, a real
    per-lane dual residual; 800 iterations at eps_abs 5e-3: every lane
    solved.  The port's fused route (plain version) against the
    reference's XLA route."""
    x0s = _fused_lanes()
    system, costs, constraints = box_setup(ct, np.float32)
    jplan = jax.jit(jax.vmap(lambda x0: jax_make_plan(
        system.with_x0(x0), costs, constraints)))(jnp.asarray(x0s))
    tplan = plan_from_numpy({f.name: getattr(jplan, f.name)
                             if f.name in ("xdim", "udim", "horizon")
                             else np.asarray(getattr(jplan, f.name))
                             for f in dataclasses.fields(jplan)})
    assert tplan.Q.dtype == torch.float32 and tplan.Q.dim() == 3
    for opts, all_solved in (
            (dict(max_iter=1, eps_abs=1e-9, eps_rel=0.0), False),
            (dict(max_iter=800, eps_abs=5e-3), True)):
        jstep = jax_make_step(jplan, ct.SolverOptions(**opts), batched=True,
                              use_fused=False)
        tstep = tt.make_plan_step(tplan, tt.SolverOptions(**opts),
                                  batched=True, use_fused=True)
        uj, sj, _ = jstep(jplan, jnp.asarray(x0s), None)
        ut, st, _ = tstep(tplan, torch.tensor(x0s), None)
        status = _np(st.status)
        assert _np(st.dual_residual).shape == (len(x0s),)
        if all_solved:
            assert (status == tt.STATUS_SOLVED).all()
        else:
            assert (status != tt.STATUS_SOLVED).any()
            assert _np(st.dual_residual).max() > 0.0
        np.testing.assert_array_equal(status, _np(sj.status))
        np.testing.assert_allclose(_np(ut), _np(uj), rtol=F32_TOL,
                                   atol=F32_TOL)
        if not all_solved:
            # float32 rounding of the saturating lanes' gradients (~3e-4):
            # two summation orders part by ~6%; converged lanes' residuals
            # (1e-6 to 3e-5) are rounding alone and are held by the status
            np.testing.assert_allclose(_np(st.dual_residual),
                                       _np(sj.dual_residual), rtol=0.1,
                                       atol=1e-5)


def test_stagewise_dual_residual_is_real():
    """A converged stagewise solve reports a small real stationarity
    residual; a one-iteration zero-seed solve does not claim success."""
    out = []
    for pkg, solve in ((ct, jax_stagewise), (tt, solve_mpc_stagewise)):
        system, costs, constraints = box_setup(pkg)
        _, U, info = solve(system, costs, constraints,
                           pkg.SolverOptions(max_iter=600))
        assert float(_np(info.dual_residual)) >= 0.0
        assert float(_np(info.dual_residual)) <= 1e-3 * 1e4
        assert int(_np(info.status)) == pkg.STATUS_SOLVED
        _, _, bad = solve(system, costs, constraints, pkg.SolverOptions(
            max_iter=1, seed="zero", eps_abs=1e-9))
        assert int(_np(bad.status)) != pkg.STATUS_SOLVED
        out.append((U, info, bad))
    np.testing.assert_allclose(_np(out[1][0]), _np(out[0][0]), rtol=0,
                               atol=1e-9)
    for got, want in zip(out[1][1:], out[0][1:]):
        _same(got, want, tol=1e-9)


def test_inform_single_and_batched():
    rng = np.random.default_rng(11)
    Q0 = rng.normal(size=(5, 5))
    args = (Q0 @ Q0.T + np.eye(5), rng.normal(size=5))
    sols = []
    for pkg, stack in ((ct, lambda qp: jax.tree_util.tree_map(
            lambda leaf: jnp.stack([leaf, leaf]), qp)),
            (tt, lambda qp: tt.DenseQP(*(
                None if leaf is None else torch.stack([leaf, leaf])
                for leaf in dataclasses.astuple(qp))))):
        qp = pkg.DenseQP.create(*args, lb=-np.ones(5), ub=np.ones(5))
        sol = pkg.solve_qp(qp, pkg.SolverOptions())
        msg = sol.inform()
        assert "solved" in msg and "residual" in msg
        solb = pkg.solve_qp_batched(stack(qp), pkg.SolverOptions())
        msgb = solb.inform()
        assert "2/2 solved" in msgb and "worst primal residual" in msgb
        sols.append((sol, solb))
    for got, want in zip(sols[1], sols[0]):
        _same(got, want)


def test_double_init_guard_applies_to_subclasses():
    """The move-semantics guard is by ``isinstance``, not by class name."""
    for pkg in (ct, tt):
        class MyControlBound(pkg.ControlBoundConstraint):
            pass

        system, _, _ = box_setup(pkg)
        ctl = pkg.LMPC(system)
        sub = MyControlBound.create(U_LOWER, U_UPPER)
        ctl.add_constraint(sub)
        with pytest.raises(pkg.InitializationError):
            ctl.add_constraint(sub)
