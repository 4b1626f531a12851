"""Condensing in the PyTorch port against the JAX reference: Phi, Psi and
xi for LTI, LTV and batched systems agree to 1e-12 in f64 (the two differ
only in summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu_torch.errors import DimensionError
from fixtures import A, B, D, SMALL_N, SMALL_X0, ltv_matrices

tt.set_default_device("cpu")

TOL = dict(rtol=1e-12, atol=1e-12)


def _same_preview(tp, jp):
    assert (tp.xdim, tp.udim, tp.horizon) == (jp.xdim, jp.udim, jp.horizon)
    for name in ("Phi", "Psi", "xi"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)), **TOL,
                                   err_msg=name)


def _random_ltv(rng, batch, N, x, u):
    lead = () if batch is None else (batch,)
    As = np.eye(x) + 0.1 * rng.normal(size=lead + (N, x, x))
    Bs = rng.normal(size=lead + (N, x, u))
    ds = rng.normal(size=lead + (N, x))
    return As, Bs, ds


def test_condense_lti_matches_reference():
    _same_preview(tt.condense_lti(A, B, D, SMALL_N),
                  ct.condense_lti(A, B, D, SMALL_N))


def test_condense_ltv_matches_reference():
    As, Bs, Ds = ltv_matrices()
    _same_preview(tt.condense_ltv(As, Bs, Ds), ct.condense_ltv(As, Bs, Ds))


@pytest.mark.parametrize("u", [1, 2, 3])
def test_condense_ltv_multi_input_matches_reference(u):
    As, Bs, ds = _random_ltv(np.random.default_rng(u), None, 6, 3, u)
    _same_preview(tt.condense_ltv(As, Bs, ds), ct.condense_ltv(As, Bs, ds))


def test_condense_batched_ltv_matches_vmapped_reference():
    As, Bs, ds = _random_ltv(np.random.default_rng(11), 4, 7, 3, 2)
    jp = jax.vmap(ct.condense_ltv)(As, Bs, ds)
    _same_preview(tt.condense_ltv(As, Bs, ds), jp)


def test_condense_batched_lti_matches_vmapped_reference():
    rng = np.random.default_rng(12)
    As = np.eye(2) + 0.05 * rng.normal(size=(3, 2, 2))
    Bs = rng.normal(size=(3, 2, 2))
    ds = rng.normal(size=(3, 2))
    jp = jax.vmap(lambda a, b, d: ct.condense_lti(a, b, d, 5))(As, Bs, ds)
    _same_preview(tt.condense_lti(As, Bs, ds, 5), jp)


def test_condense_dispatch_and_lti_as_ltv():
    tsys = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    jsys = ct.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    _same_preview(tt.condense(tsys), ct.condense(jsys))
    _same_preview(tt.condense(tt.lti_as_ltv(tsys)),
                  ct.condense(ct.lti_as_ltv(jsys)))


def test_trajectory_and_replay_match_reference():
    As, Bs, Ds = ltv_matrices()
    tsys = tt.LTVSystem.create(As, Bs, Ds, SMALL_X0)
    jsys = ct.LTVSystem.create(As, Bs, Ds, SMALL_X0)
    U = np.random.default_rng(3).normal(size=SMALL_N)
    X_t = tt.condense(tsys).trajectory(SMALL_X0, U)
    X_j = ct.condense(jsys).trajectory(jnp.asarray(SMALL_X0), jnp.asarray(U))
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), **TOL)
    assert float(tt.replay_dynamics(tsys, X_t, U)) < 1e-10
    lti = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    X_l = tt.condense(lti).trajectory(SMALL_X0, U)
    assert float(tt.replay_dynamics(lti, X_l, U)) < 1e-10


def test_system_dimension_errors():
    with pytest.raises(DimensionError):
        tt.LTISystem.create(np.ones((2, 3)), B, D, SMALL_X0, 3)
    with pytest.raises(DimensionError):
        tt.LTISystem.create(A, np.ones((3, 1)), D, SMALL_X0, 3)
    with pytest.raises(DimensionError):
        tt.LTISystem.create(A, B, D, SMALL_X0, 0)
    with pytest.raises(DimensionError):
        tt.LTVSystem.create(np.ones((3, 2, 2)), np.ones((2, 2, 1)),
                            np.ones((3, 2)), SMALL_X0)


def test_from_step_fns_matches_stacked():
    As, Bs, Ds = ltv_matrices()
    sys_f = tt.LTVSystem.from_step_fns(lambda k: As[k], lambda k: Bs[k],
                                       lambda k: Ds[k], SMALL_X0, SMALL_N)
    np.testing.assert_array_equal(sys_f.A.numpy(), As)
    assert sys_f.horizon == SMALL_N and sys_f.udim == 1
    assert torch.equal(sys_f.x0, torch.tensor(SMALL_X0))
