"""Cost and constraint lowering and QP assembly in the PyTorch port against
the JAX reference: every (Q, c), (A, b) and bound pair, per-step and
full-horizon modes, and ``build_qp``, agree to 1e-12 in f64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu_torch.errors import DimensionError

tt.set_default_device("cpu")

TOL = dict(rtol=1e-12, atol=1e-12)
X, U, N = 3, 2, 5
FX, FU = X * (N + 1), U * N


def _lti(seed=0):
    rng = np.random.default_rng(seed)
    A = np.eye(X) + 0.1 * rng.normal(size=(X, X))
    B = rng.normal(size=(X, U))
    d = rng.normal(size=X)
    x0 = rng.normal(size=X)
    return A, B, d, x0


def _previews():
    A, B, d, x0 = _lti()
    return (tt.condense(tt.LTISystem.create(A, B, d, x0, N)),
            ct.condense(ct.LTISystem.create(A, B, d, x0, N)), x0)


def _w(rng, r):
    return rng.uniform(0.5, 2.0, size=r)


# name -> (class name, argument maker); the makers draw from a seeded rng
COSTS = {
    "trajectory_step": ("TrajectoryCost", lambda r: (
        r.normal(size=(2, X)), r.normal(size=2), _w(r, 2))),
    "trajectory_full": ("TrajectoryCost", lambda r: (
        r.normal(size=(4, FX)), r.normal(size=4), _w(r, 4))),
    "simple_trajectory_step": ("SimpleTrajectoryCost", lambda r: (
        r.normal(size=X), _w(r, X))),
    "simple_trajectory_full": ("SimpleTrajectoryCost", lambda r: (
        r.normal(size=FX), _w(r, FX))),
    "target": ("TargetCost", lambda r: (
        r.normal(size=(2, X)), r.normal(size=2), _w(r, 2))),
    "control_step": ("ControlCost", lambda r: (
        r.normal(size=(3, U)), r.normal(size=3), _w(r, 3))),
    "control_full": ("ControlCost", lambda r: (
        r.normal(size=(4, FU)), r.normal(size=4), _w(r, 4))),
    "simple_control_step": ("SimpleControlCost", lambda r: (
        r.normal(size=U), _w(r, U))),
    "simple_control_full": ("SimpleControlCost", lambda r: (
        r.normal(size=FU), _w(r, FU))),
    "mixed_step": ("MixedCost", lambda r: (
        r.normal(size=(2, X)), r.normal(size=(2, U)), r.normal(size=2),
        _w(r, 2))),
    "mixed_full": ("MixedCost", lambda r: (
        r.normal(size=(3, FX)), r.normal(size=(3, FU)), r.normal(size=3),
        _w(r, 3))),
}

_inf = np.inf
CONSTRAINTS = {
    "trajectory_step": ("TrajectoryConstraint", lambda r: (
        r.normal(size=(2, X)), r.normal(size=2))),
    "trajectory_full_eq": ("TrajectoryConstraint", lambda r: (
        r.normal(size=(3, FX)), r.normal(size=3), False)),
    "control_step": ("ControlConstraint", lambda r: (
        r.normal(size=(2, U)), r.normal(size=2))),
    "control_full": ("ControlConstraint", lambda r: (
        r.normal(size=(3, FU)), r.normal(size=3))),
    "mixed_step": ("MixedConstraint", lambda r: (
        r.normal(size=(2, X)), r.normal(size=(2, U)), r.normal(size=2))),
    "mixed_full": ("MixedConstraint", lambda r: (
        r.normal(size=(2, FX)), r.normal(size=(2, FU)), r.normal(size=2))),
    "trajectory_bound_step": ("TrajectoryBoundConstraint", lambda r: (
        np.array([-1.0, -_inf, -2.0]), np.array([_inf, 0.5, 3.0]))),
    "trajectory_bound_full": ("TrajectoryBoundConstraint", lambda r: (
        np.where(r.uniform(size=FX) < 0.3, -_inf, -r.uniform(1, 2, FX)),
        np.where(r.uniform(size=FX) < 0.3, _inf, r.uniform(1, 2, FX)))),
    "control_bound_step": ("ControlBoundConstraint", lambda r: (
        -r.uniform(1, 2, U), r.uniform(1, 2, U))),
    "control_bound_full": ("ControlBoundConstraint", lambda r: (
        -r.uniform(1, 2, FU), r.uniform(1, 2, FU))),
}


def _pair(table, name):
    cls, make = table[name]
    args = make(np.random.default_rng(sorted(table).index(name)))
    return (getattr(tt, cls).create(*args), getattr(ct, cls).create(*args))


def _close(t, j, what):
    assert tuple(t.shape) == tuple(np.shape(j)), what
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(COSTS))
def test_cost_lowering_matches_reference(name):
    tp, jp, x0 = _previews()
    tcost, jcost = _pair(COSTS, name)
    tcost.validate(tp)
    tQ, tc = tcost.lower(tp, torch.tensor(x0))
    jQ, jc = jcost.lower(jp, jnp.asarray(x0))
    _close(tQ, jQ, "Q")
    _close(tc, jc, "c")


@pytest.mark.parametrize("name", sorted(CONSTRAINTS))
def test_constraint_lowering_matches_reference(name):
    tp, jp, x0 = _previews()
    tcon, jcon = _pair(CONSTRAINTS, name)
    tcon.validate(tp)
    assert tcon.kind().value == jcon.kind().value
    assert tcon.nr_constr(tp) == jcon.nr_constr(jp)
    tA, tb = tcon.lower(tp, torch.tensor(x0))
    jA, jb = jcon.lower(jp, jnp.asarray(x0))
    _close(tA, jA, "first")
    _close(tb, jb, "second")


def _all_terms():
    costs = [_pair(COSTS, n) for n in ("trajectory_step", "target",
                                       "control_step", "mixed_full")]
    cons = [_pair(CONSTRAINTS, n) for n in (
        "trajectory_step", "trajectory_full_eq", "mixed_step",
        "trajectory_bound_step", "control_bound_full")]
    return ([t for t, _ in costs], [j for _, j in costs],
            [t for t, _ in cons], [j for _, j in cons])


def _same_qp(tq, jq):
    for name in ("Q", "c", "Aeq", "beq", "Aineq", "bineq", "lb", "ub"):
        _close(getattr(tq, name), getattr(jq, name), name)


def test_build_qp_matches_reference():
    tp, jp, x0 = _previews()
    tcs, jcs, tks, jks = _all_terms()
    tq = tt.build_qp(tp, torch.tensor(x0), tcs, tks)
    jq = ct.build_qp(jp, jnp.asarray(x0), jcs, jks)
    _same_qp(tq, jq)
    np.testing.assert_array_equal(tq.Q.numpy(), tq.Q.numpy().T)


def test_build_qp_without_costs_is_the_ridge():
    tp, jp, x0 = _previews()
    tq = tt.build_qp(tp, torch.tensor(x0), (), ())
    jq = ct.build_qp(jp, jnp.asarray(x0), (), ())
    _same_qp(tq, jq)


def test_batched_build_qp_matches_vmapped_reference():
    """A batched preview and per-lane x0 in one call equal the reference's
    vmap over lanes."""
    rng = np.random.default_rng(21)
    Bn = 3
    As = np.eye(X) + 0.1 * rng.normal(size=(Bn, N, X, X))
    Bs = rng.normal(size=(Bn, N, X, U))
    ds = rng.normal(size=(Bn, N, X))
    x0s = rng.normal(size=(Bn, X))
    tcs, jcs, tks, jks = _all_terms()
    tq = tt.build_qp(tt.condense_ltv(As, Bs, ds), torch.tensor(x0s), tcs,
                     tks)
    jq = jax.vmap(lambda a, b, d, x0: ct.build_qp(
        ct.condense_ltv(a, b, d), x0, jcs, jks))(As, Bs, ds, x0s)
    for name in ("Q", "c", "Aeq", "beq", "Aineq", "bineq"):
        _close(getattr(tq, name), getattr(jq, name), name)


@pytest.mark.parametrize("cls,args,new_dim", [
    ("MixedCost", ((np.ones((1, X)), np.ones((1, U)), [1.0])), 4),
    ("TrajectoryCost", ((np.ones((2, X)), [1.0, 2.0])), 6),
    ("TrajectoryBoundConstraint", (([-1.0, -np.inf, 0.0],
                                    [np.inf, 1.0, 2.0])), None),
])
def test_auto_span_matches_reference(cls, args, new_dim):
    t = getattr(tt, cls).create(*args).auto_span()
    j = getattr(ct, cls).create(*args).auto_span()
    for f in ("M", "N", "p", "weights", "lower_bound", "upper_bound"):
        if hasattr(j, f):
            _close(getattr(t, f), getattr(j, f), f)
    np.testing.assert_allclose(
        tt.span_matrix(np.eye(2), 6, add_cols=1).numpy(),
        np.asarray(ct.span_matrix(np.eye(2), 6, add_cols=1)))


def test_weights_setters_and_dimension_errors():
    tcost, jcost = _pair(COSTS, "trajectory_step")
    _close(tcost.with_weights([3.0]).weights,
           jcost.with_weights([3.0]).weights, "with_weights")
    _close(tcost.with_weight(0.5).weights, jcost.with_weight(0.5).weights,
           "with_weight")
    tp, _, _ = _previews()
    with pytest.raises(DimensionError):
        tt.TrajectoryCost.create(np.ones((2, X + 1)), [0.0, 0.0]).validate(tp)
    with pytest.raises(DimensionError):
        tt.ControlBoundConstraint.create([0.0], [1.0, 2.0]).validate(tp)
    with pytest.raises(DimensionError):
        tt.span_vector([1.0, 2.0], 5)
