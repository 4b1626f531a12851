"""The reference's raw-solver conformance suite
(``tests/test_solvers_cross.py``) on the PyTorch port, against the JAX
reference on the CPU.

Every backend solves the Scilab-qld fixture QP, and the ADMM engine is
cross-validated against the exact native active-set oracle
(``native/activeset.cpp``, bound by each package on its own) on the qld
fixture, on random strictly convex QPs and on the golden MPC QP.  Each case
runs the same numpy data through both packages, asserts the reference's
own assertion on the port and holds the port's solution against the
reference's: 1e-10 between the two bindings of the one native solver (on
solutions of ~100: the MPC QPs are assembled by two condensing routines,
which part by rounding), 1e-8 between the ADMM solves (float64, both
polished to the vertex).
"""

import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.qp.native import native_available
from copra_tpu.qp.native import solve_qp_native as jax_native
from fixtures import (A, B, D, GOLDEN_CONTROL, M, N_MAT, QLD_AEQ, QLD_AINEQ,
                      QLD_BEQ, QLD_BINEQ, QLD_C, QLD_Q, QLD_XL, QLD_XU,
                      SMALL_N, SMALL_X0, UD, U_LOWER, U_UPPER, WU, WX, XD,
                      X_LOWER, X_UPPER)
from _one_thread import one_torch_thread  # noqa: F401

tt.set_default_device("cpu")

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native solver did not build")

NATIVE_TOL, SAME_TOL = 1e-10, 1e-8
NATIVES = ((ct, jax_native), (tt, tt.solve_qp_native))


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def qld_qp(pkg):
    return pkg.DenseQP.create(QLD_Q, QLD_C, QLD_AEQ, QLD_BEQ, QLD_AINEQ,
                              QLD_BINEQ, QLD_XL, QLD_XU)


def _cross(make_qp, opts, atol):
    """The native oracle and ``solve_qp`` on each package; the ADMM
    solution within ``atol`` of its package's oracle, the port's oracle
    and solve against the reference's.  Returns the port's pair."""
    out = []
    for pkg, native in NATIVES:
        qp = make_qp(pkg)
        ref = native(qp)
        assert int(_np(ref.status)) == pkg.STATUS_SOLVED
        sol = pkg.solve_qp(qp, pkg.SolverOptions(**opts))
        np.testing.assert_allclose(_np(sol.x), _np(ref.x), atol=atol)
        out.append((ref, sol))
    (jref, jsol), (tref, tsol) = out
    np.testing.assert_allclose(_np(tref.x), _np(jref.x), rtol=0,
                               atol=NATIVE_TOL)
    np.testing.assert_allclose(_np(tsol.x), _np(jsol.x), rtol=0,
                               atol=SAME_TOL)
    return tref, tsol


def test_native_solves_qld_fixture():
    out = []
    for pkg, native in NATIVES:
        sol = native(qld_qp(pkg))
        assert int(_np(sol.status)) == pkg.STATUS_SOLVED
        assert float(_np(sol.primal_residual)) <= 1e-9
        x = _np(sol.x)
        grad = QLD_Q @ x + QLD_C
        assert np.linalg.norm(x) > 0 and np.all(np.isfinite(grad))
        out.append(x)
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=NATIVE_TOL)


def test_admm_matches_native_on_qld():
    _, sol = _cross(qld_qp, dict(max_iter=4000), 1e-7)
    assert int(_np(sol.status)) == tt.STATUS_SOLVED


def _random_qp(seed):
    rng = np.random.default_rng(seed)
    n, me, mi = 12, 3, 6
    Mm = rng.normal(size=(n, n))
    Q = Mm @ Mm.T + n * np.eye(n)
    c = rng.normal(size=n)
    Aeq = rng.normal(size=(me, n))
    beq = rng.normal(size=me)
    Aineq = rng.normal(size=(mi, n))
    x_feas = np.linalg.lstsq(Aeq, beq, rcond=None)[0]
    bineq = Aineq @ x_feas + rng.uniform(0.1, 1.0, size=mi)
    lb = x_feas - rng.uniform(0.5, 3.0, size=n)
    ub = x_feas + rng.uniform(0.5, 3.0, size=n)
    return lambda pkg: pkg.DenseQP.create(Q, c, Aeq, beq, Aineq, bineq, lb,
                                          ub)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_admm_matches_native_on_random_qps(seed):
    _cross(_random_qp(seed), dict(max_iter=8000), 1e-6)


def _golden_terms(pkg):
    costs = (pkg.TargetCost.create(M, XD, weights=WX),
             pkg.ControlCost.create(N_MAT, UD, weights=WU))
    constraints = (pkg.TrajectoryBoundConstraint.create(X_LOWER, X_UPPER),
                   pkg.ControlBoundConstraint.create(U_LOWER, U_UPPER))
    return costs, constraints


def test_mpc_pipeline_with_native_backend():
    """``LMPC(solver="active_set")`` reproduces the golden control."""
    out = []
    for pkg in (ct, tt):
        system = pkg.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
        controller = pkg.LMPC(system, solver="active_set")
        costs, constraints = _golden_terms(pkg)
        for c in costs:
            controller.add_cost(c)
        for c in constraints:
            controller.add_constraint(c)
        assert controller.solve()
        U = _np(controller.control())
        np.testing.assert_allclose(U, GOLDEN_CONTROL, atol=2e-4)
        out.append(U)
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=NATIVE_TOL)


def _golden_qp(pkg):
    system = pkg.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    costs, constraints = _golden_terms(pkg)
    return pkg.build_qp(pkg.condense(system), system.x0, costs, constraints)


def test_admm_matches_native_on_golden_mpc_qp():
    """The full MPC QP (bounds and the masked trajectory rows) between the
    two backends."""
    _cross(_golden_qp, dict(max_iter=4000), 1e-6)


def test_available_solvers_lists_all():
    names = set(tt.available_solvers())
    assert {"admm", "default", "active_set"} <= names
    assert names == set(ct.available_solvers())
