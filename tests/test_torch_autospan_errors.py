"""The reference's auto-span and error-handling suite
(``tests/test_autospan_errors.py``) on the PyTorch port, against the JAX
reference on the CPU.

Every per-step / full-horizon combination is accepted after
``auto_span()``; wrong dimensions raise ``DimensionError``; registering a
move-semantics constraint twice raises ``InitializationError``; removal
then solve works; an unknown solver raises ``SolverError``.  Each case
runs on both packages with the same numpy data and asserts the
reference's assertion on each; where a case computes (the spanned terms'
lowering, the solve after removal, the multi-input ``MixedCost``) the
port's numbers are held against the reference's at 1e-12 (the same
float64 formulas) and 1e-8 (a polished solve).
"""

import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from fixtures import (A, B, D, INEQ_E, INEQ_G, INEQ_H, INEQ_P, M, MIXED_E,
                      MIXED_G, MIXED_P, N_MAT, UD, U_LOWER, U_UPPER, WU, WX,
                      XD)
from _one_thread import one_torch_thread  # noqa: F401

tt.set_default_device("cpu")

N_STEP = 8
X0 = np.array([0.0, -5.0])
PKGS = [ct, tt]
EXACT_TOL, SAME_TOL = 1e-12, 1e-8


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def controller(pkg):
    return pkg.LMPC(pkg.LTISystem.create(A, B, D, X0, N_STEP))


def spanM(mat, n, add_cols=0):
    return np.asarray(ct.span_matrix(mat, mat.shape[0] * n, add_cols))


def spanV(vec, n):
    return np.asarray(ct.span_vector(vec, vec.shape[0] * n))


def _lowered(pkg, terms):
    """Each spanned cost's or constraint's lowering on the controller's
    preview (the numbers a solve would use)."""
    system = pkg.LTISystem.create(A, B, D, X0, N_STEP)
    preview = pkg.condense(system)
    out = []
    for term in terms:
        term.validate(preview)
        out.append([_np(a) for a in term.lower(preview, system.x0)
                    if a is not None])
    return out


def _same_lowering(make_terms):
    got, want = (_lowered(pkg, make_terms(pkg)) for pkg in (tt, ct))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=0, atol=EXACT_TOL)


def test_span_helpers_match_reference():
    for mat, n, cols in ((INEQ_E, 9, 0), (MIXED_E, 8, 1), (N_MAT, 8, 0)):
        np.testing.assert_array_equal(
            _np(tt.span_matrix(mat, mat.shape[0] * n, cols)),
            spanM(mat, n, cols))
    np.testing.assert_array_equal(_np(tt.span_vector(XD, 18)),
                                  spanV(XD, 9))


# ---- autospan combinatorics (reference :842-971) ----


def _traj_ctrl_constraints(pkg):
    n_x = N_STEP + 1
    fullE, fullp = spanM(INEQ_E, n_x), spanV(INEQ_P, n_x)
    fullG, fullh = spanM(INEQ_G, N_STEP), spanV(INEQ_H, N_STEP)
    return ([pkg.TrajectoryConstraint.create(E, p).auto_span()
             for E, p in [(INEQ_E, INEQ_P), (fullE, INEQ_P), (INEQ_E, fullp),
                          (fullE, fullp)]]
            + [pkg.ControlConstraint.create(G, h).auto_span()
               for G, h in [(INEQ_G, INEQ_H), (fullG, INEQ_H),
                            (INEQ_G, fullh), (fullG, fullh)]])


def _mixed_constraints(pkg):
    fullE = spanM(MIXED_E, N_STEP, add_cols=1)
    fullG = spanM(MIXED_G, N_STEP)
    fullf = spanV(MIXED_P, N_STEP)
    return [pkg.MixedConstraint.create(E, G, f).auto_span()
            for E in (MIXED_E, fullE) for G in (MIXED_G, fullG)
            for f in (MIXED_P, fullf)]


def _trajectory_costs(pkg):
    n_x = N_STEP + 1
    fullM, fullxd = spanM(M, n_x), spanV(XD, n_x)
    return [pkg.TrajectoryCost.create(Mm, p, weights=WX).auto_span()
            for Mm, p in [(M, XD), (M, fullxd), (fullM, XD),
                          (fullM, fullxd)]]


def _control_costs(pkg):
    fullN, fullud = spanM(N_MAT, N_STEP), spanV(UD, N_STEP)
    return [pkg.ControlCost.create(Nm, p, weights=WU).auto_span()
            for Nm, p in [(N_MAT, UD), (N_MAT, fullud), (fullN, UD),
                          (fullN, fullud)]]


def _mixed_costs(pkg):
    ones21 = np.ones((2, 1))
    return [pkg.MixedCost.create(Mm, Nm, p, weights=WX).auto_span()
            for Mm in (M, spanM(M, N_STEP, add_cols=1))
            for Nm in (ones21, spanM(ones21, N_STEP))
            for p in (XD, spanV(XD, N_STEP))]


@pytest.mark.parametrize("make_terms,kind", [
    (_traj_ctrl_constraints, "constraint"),
    (_mixed_constraints, "constraint"),
    (_trajectory_costs, "cost"),
    (_control_costs, "cost"),
    (_mixed_costs, "cost")],
    ids=["trajectory_and_control_constraint", "mixed_constraint",
         "trajectory_cost", "control_cost", "mixed_cost"])
def test_autospan(make_terms, kind):
    """Every combination registers after ``auto_span()`` and lowers to the
    reference's numbers."""
    for pkg in PKGS:
        ctl = controller(pkg)
        for term in make_terms(pkg):
            getattr(ctl, f"add_{kind}")(term)
    _same_lowering(make_terms)


# ---- error handling (reference :977-1104) ----


@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_error_system(pkg):
    for args in ((np.ones((5, 2)), B, D, X0, N_STEP),
                 (np.ones((2, 5)), B, D, X0, N_STEP),
                 (A, np.ones((5, 1)), D, X0, N_STEP),
                 (A, B, np.ones(5), X0, N_STEP),
                 (A, B, D, X0, -1)):
        with pytest.raises(pkg.DimensionError):
            pkg.LTISystem.create(*args)
    with pytest.raises(pkg.DimensionError):
        pkg.LTVSystem.create(np.ones((4, 5, 2)), np.ones((4, 2, 1)),
                             np.ones((4, 2)), X0)


@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_error_weights(pkg):
    cost = pkg.TrajectoryCost.create(M, XD)
    cost.with_weight(2.0)
    with pytest.raises(pkg.DimensionError):
        cost.with_weights(np.ones(5))
    controller(pkg).add_cost(cost.with_weights(WX))


BAD_COSTS = [
    lambda pkg: pkg.TrajectoryCost.create(np.eye(5), np.ones(2)),
    lambda pkg: pkg.TrajectoryCost.create(np.eye(5), np.ones(5)),
    lambda pkg: pkg.TargetCost.create(np.eye(5), np.ones(2)),
    lambda pkg: pkg.TargetCost.create(np.eye(5), np.ones(5)),
    lambda pkg: pkg.ControlCost.create(np.eye(5), np.ones(2)),
    lambda pkg: pkg.ControlCost.create(np.eye(5), np.ones(5)),
    lambda pkg: pkg.MixedCost.create(np.eye(5), np.ones((2, 1)), np.ones(2)),
    lambda pkg: pkg.MixedCost.create(np.ones((2, 1)), np.eye(5), np.ones(2)),
    lambda pkg: pkg.MixedCost.create(np.eye(5), np.eye(5), np.ones(5)),
]


@pytest.mark.parametrize("bad", BAD_COSTS)
def test_error_costs(bad):
    for pkg in PKGS:
        with pytest.raises(pkg.DimensionError):
            controller(pkg).add_cost(bad(pkg))


BAD_CONSTRAINTS = [
    lambda pkg: pkg.TrajectoryConstraint.create(np.eye(5), np.ones(2)),
    lambda pkg: pkg.TrajectoryConstraint.create(np.eye(5), np.ones(5)),
    lambda pkg: pkg.ControlConstraint.create(np.eye(5), np.ones(2)),
    lambda pkg: pkg.ControlConstraint.create(np.eye(5), np.ones(5)),
    lambda pkg: pkg.MixedConstraint.create(np.eye(5), np.ones((2, 1)),
                                           np.ones(2)),
    lambda pkg: pkg.MixedConstraint.create(np.ones((2, 1)), np.eye(5),
                                           np.ones(2)),
    lambda pkg: pkg.MixedConstraint.create(np.eye(5), np.eye(5), np.ones(5)),
    lambda pkg: pkg.TrajectoryBoundConstraint.create(np.ones(3), np.ones(2)),
    lambda pkg: pkg.TrajectoryBoundConstraint.create(np.ones(3), np.ones(3)),
    lambda pkg: pkg.ControlBoundConstraint.create(np.ones(3), np.ones(2)),
    lambda pkg: pkg.ControlBoundConstraint.create(np.ones(3), np.ones(3)),
]


@pytest.mark.parametrize("bad", BAD_CONSTRAINTS)
def test_error_constraints(bad):
    for pkg in PKGS:
        with pytest.raises(pkg.DimensionError):
            controller(pkg).add_constraint(bad(pkg))


@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_double_registration_control_constraint(pkg):
    ctl = controller(pkg)
    good = pkg.ControlConstraint.create(INEQ_G, INEQ_H)
    ctl.add_constraint(good)
    with pytest.raises(pkg.InitializationError):
        ctl.add_constraint(good)
    bound = pkg.ControlBoundConstraint.create(U_LOWER, U_UPPER)
    ctl.add_constraint(bound)
    with pytest.raises(pkg.InitializationError):
        ctl.add_constraint(bound)


def test_remove_cost_and_constraint():
    """Add, remove, then solve: the ridge-only QP, the same on both."""
    out = []
    for pkg in PKGS:
        ctl = controller(pkg)
        x_cost = ctl.add_cost(pkg.TargetCost.create(M, XD, weights=WX))
        u_cost = ctl.add_cost(pkg.ControlCost.create(N_MAT, UD, weights=WU))
        traj = ctl.add_constraint(pkg.TrajectoryConstraint.create(INEQ_E,
                                                                  INEQ_P))
        ctrl = ctl.add_constraint(pkg.ControlConstraint.create(INEQ_G,
                                                               INEQ_H))
        ctl.remove_cost(x_cost)
        ctl.remove_cost(u_cost)
        ctl.remove_constraint(traj)
        ctl.remove_constraint(ctrl)
        assert ctl.solve()
        assert ctl.costs == () and ctl.constraints == ()
        out.append(_np(ctl.control()))
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=SAME_TOL)


@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_unknown_solver(pkg):
    with pytest.raises(pkg.SolverError):
        pkg.get_solver("nonexistent")


def test_mixed_cost_multi_input_per_step_equals_full_size():
    """u >= 2: ``MixedCost``'s per-step lowering equals the spanned
    full-size entry (M spanned with one more column: x_N is not
    penalised), on each package, and the port's equals the
    reference's."""
    rng = np.random.default_rng(11)
    N, x, u, r = 6, 3, 2, 2
    As, Bs = 0.6 * rng.normal(size=(x, x)), rng.normal(size=(x, u))
    ds, x0 = rng.normal(size=x), rng.normal(size=x)
    Mm, Nm = rng.normal(size=(r, x)), rng.normal(size=(r, u))
    p, w = rng.normal(size=r), rng.uniform(0.1, 1.0, r)
    out = []
    for pkg in PKGS:
        system = pkg.LTISystem.create(As, Bs, ds, x0, N)
        prev = pkg.condense(system)
        per_step = pkg.MixedCost.create(Mm, Nm, p, weights=w)
        full = pkg.MixedCost.create(
            spanM(Mm, N, add_cols=1), spanM(Nm, N), spanV(p, N),
            weights=spanV(w, N))
        per_step.validate(prev)
        full.validate(prev)
        Q1, c1 = (_np(a) for a in per_step.lower(prev, system.x0))
        Q2, c2 = (_np(a) for a in full.lower(prev, system.x0))
        np.testing.assert_allclose(Q1, Q2, atol=EXACT_TOL)
        np.testing.assert_allclose(c1, c2, atol=EXACT_TOL)
        out.append((Q1, c1))
    for g, w_ in zip(out[1], out[0]):
        np.testing.assert_allclose(g, w_, rtol=0, atol=EXACT_TOL)
