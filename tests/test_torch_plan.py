"""Control plans and the accurate serving tick of the PyTorch port against
the JAX reference and the native f64 oracle, on a small config-4 fleet
(the bench's LTV point-mass fleet cut to B = 8 lanes, N = 20 steps)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.plan import (auto_rho as jax_auto_rho,
                            make_control_plan as jax_make_plan,
                            make_plan_step as jax_make_step,
                            make_seed_map as jax_seed_map)
from copra_tpu_torch.convert import plan_from_numpy, system_from_numpy
from copra_tpu_torch.plan import _slice_plan
from fixtures import (QLD_AEQ, QLD_AINEQ, QLD_BEQ, QLD_BINEQ, QLD_C, QLD_Q,
                      QLD_XL, QLD_XU)

tt.set_default_device("cpu")

LANES, HORIZON = 8, 20
TICKS = 3
STATIC = ("xdim", "udim", "horizon")


def _fleet(dtype=np.float32):
    """bench.py's fleet: point mass under gravity, A perturbed per lane."""
    T, mass = 0.005, 5.0
    A = np.array([[1.0, T], [0.0, 1.0]])
    B = np.array([[0.5 * T * T / mass], [T / mass]])
    d = np.array([-9.81 / 2.0 * T * T, -9.81 * T])
    rng = np.random.default_rng(0)
    As = np.repeat(np.repeat(A[None], HORIZON, 0)[None], LANES, 0)
    As = As + rng.normal(scale=1e-4, size=As.shape)
    Bs = np.repeat(np.repeat(B[None], HORIZON, 0)[None], LANES, 0)
    ds = np.repeat(np.repeat(d[None], HORIZON, 0)[None], LANES, 0)
    x0s = np.array([0.0, -1.5])[None] + rng.normal(scale=[0.02, 0.1],
                                                   size=(LANES, 2))
    drift = np.zeros((TICKS, LANES, 2))
    drift[:, :, 1] = np.cumsum(rng.normal(scale=0.02, size=(TICKS, LANES)),
                               axis=0)
    x0_seq = (x0s[None] + drift).astype(np.float32)
    return [a.astype(dtype) for a in (As, Bs, ds, x0s)], x0s, x0_seq


def _terms(mod, bound):
    costs = (mod.TargetCost.create(np.eye(2), [0.0, -1.0],
                                   weights=[10.0, 1e4]),
             mod.ControlCost.create([[1.0]], [2.0], weights=[1e-4]))
    return costs, (mod.ControlBoundConstraint.create([-bound], [bound]),)


@functools.lru_cache(maxsize=None)
def _jax_plan(bound, dtype=np.float32):
    arrays, _, _ = _fleet(dtype)
    costs, cons = _terms(ct, bound)
    return jax.jit(jax.vmap(lambda a, b, d, x0: jax_make_plan(
        ct.LTVSystem(A=a, B=b, d=d, x0=x0), costs, cons)))(
        *map(jnp.asarray, arrays))


def _fields(plan):
    return {f.name: getattr(plan, f.name) if f.name in STATIC
            else np.asarray(getattr(plan, f.name))
            for f in dataclasses.fields(plan)}


def _port_plan(bound):
    return plan_from_numpy(_fields(_jax_plan(bound)))


OPTS = dict(max_iter=30, early_exit=False, polish=False, rho=1.0,
            kkt_refine=0)


def _exact(plan, lane, x0):
    """Exact f64 solution of one lane's QP (port binding of the oracle)."""
    qp = tt.plan_qp(_slice_plan(plan, lane), np.asarray(x0, np.float64))
    return tt.solve_qp_native(qp).x.numpy()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_make_control_plan_matches_reference(dtype):
    """Same fleet through both builds: 1e-12 in f64; in f32 the condensing
    products round differently (a few f32 ulps of Phi), so 1e-5 relative."""
    arrays, _, _ = _fleet(dtype)
    costs, cons = _terms(tt, 60.0)
    plan = tt.make_control_plan(
        system_from_numpy(dict(zip(("A", "B", "d", "x0"), arrays))),
        costs, cons)
    ref = _fields(_jax_plan(60.0, dtype))
    tol = 1e-12 if dtype == np.float64 else 1e-5
    for name, want in ref.items():
        got = getattr(plan, name)
        if name in STATIC:
            assert got == want
            continue
        assert tuple(got.shape) == want.shape, name
        assert got.numpy().dtype == want.dtype, name
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol,
                                   err_msg=name)


def test_plan_from_numpy_round_trips():
    ref = _fields(_jax_plan(60.0))
    plan = plan_from_numpy(ref)
    for name, want in ref.items():
        got = getattr(plan, name)
        if name in STATIC:
            assert got == want
        else:
            np.testing.assert_array_equal(got.numpy(), want)
            assert got.numpy().dtype == want.dtype


def test_make_seed_map_matches_reference():
    _, x0s, _ = _fleet()
    jplan = _jax_plan(60.0)
    want = jax_seed_map(jplan, center=x0s, keep_f64=True)
    got = tt.make_seed_map(_port_plan(60.0), center=x0s, keep_f64=True)
    for name in ("u0", "Umap", "x0c"):
        g = getattr(got, name)
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    x0 = x0s[0] + 0.01
    np.testing.assert_allclose(got.seed(torch.tensor(x0))[0].numpy(),
                               np.asarray(want.u0[0] + (x0 - x0s[0])
                                          @ want.Umap[0]), rtol=1e-12)


def test_accurate_ticks_match_reference_unsaturated():
    """Three warm-started ticks at the non-binding +-300 bound: every lane
    is unsaturated, the correction is exactly zero, and both deliver the
    f64 seed (1e-9)."""
    _, x0s, x0_seq = _fleet()
    jplan, tplan = _jax_plan(300.0), _port_plan(300.0)
    rho = tt.suggest_rho(tplan)
    jstep = jax_make_step(jplan, ct.SolverOptions(**OPTS).replace(rho=rho),
                          batched=True, seed_center=x0s, accurate=True,
                          accurate_rounds=1, use_fused=False)
    tstep = tt.make_plan_step(tplan, tt.SolverOptions(**OPTS).replace(
        rho=rho), batched=True, seed_center=x0s, accurate=True,
        accurate_rounds=1)
    jw = tw = None
    for t in range(TICKS):
        uj, sj, jw = jstep(jplan, jnp.asarray(x0_seq[t]), jw)
        ut, st, tw = tstep(tplan, torch.tensor(x0_seq[t]), tw)
        assert ut.dtype == torch.float64
        assert (np.abs(np.asarray(uj)) < 300.0 - 1e-6).all()
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                                   atol=1e-9)
        np.testing.assert_array_equal(st.status.numpy(),
                                      np.asarray(sj.status))
    for lane in range(LANES):
        assert np.abs(ut[lane].numpy()
                      - _exact(tplan, lane, x0_seq[-1][lane])).max() < 1e-9


def test_accurate_ticks_meet_native_oracle_binding():
    """The binding +-60 bound, rho from auto_rho: within 1e-5 of the exact
    f64 solution (the library's accuracy contract).  At N = 20 the free
    controls span ~66..86 (41..73 at the bench's N = 100), so +-60 pins
    every coordinate here."""
    _, x0s, x0_seq = _fleet()
    tplan = _port_plan(60.0)
    opts = tt.SolverOptions(**OPTS)
    opts = opts.replace(rho=tt.auto_rho(tplan, x0s, opts, seed_center=x0s,
                                        accurate=True, accurate_rounds=1))
    step = tt.make_plan_step(tplan, opts, batched=True, seed_center=x0s,
                             accurate=True, accurate_rounds=1)
    warm = None
    for t in range(TICKS):
        u, sol, warm = step(tplan, torch.tensor(x0_seq[t]), warm)
    for lane in range(LANES):
        ex = _exact(tplan, lane, x0_seq[-1][lane])
        assert (np.abs(ex) >= 60.0 - 1e-9).any()
        assert np.abs(u[lane].numpy() - ex).max() <= 1e-5
    assert (sol.status.numpy() == 0).all()
    assert tuple(warm.y.shape) == (LANES, HORIZON)


@pytest.mark.parametrize("rounds", [1, 2])
def test_accurate_ticks_match_reference_partial_binding(rounds):
    """+-78 binds about a quarter of the coordinates at N = 20 (as +-60
    does at N = 100), so the f32 correction ADMM does real work: both
    implementations give the same statuses and agree to 1e-5 (the f32
    correction floor; the kernel sums in another order), including lanes
    that 30 iterations leave unconverged."""
    _, x0s, x0_seq = _fleet()
    jplan, tplan = _jax_plan(78.0), _port_plan(78.0)
    rho = tt.auto_rho(tplan, x0s, tt.SolverOptions(**OPTS), seed_center=x0s,
                      accurate=True, accurate_rounds=rounds)
    jstep = jax_make_step(jplan, ct.SolverOptions(**OPTS).replace(rho=rho),
                          batched=True, seed_center=x0s, accurate=True,
                          accurate_rounds=rounds, use_fused=False)
    tstep = tt.make_plan_step(tplan, tt.SolverOptions(**OPTS).replace(
        rho=rho), batched=True, seed_center=x0s, accurate=True,
        accurate_rounds=rounds)
    jw = tw = None
    for t in range(TICKS):
        uj, sj, jw = jstep(jplan, jnp.asarray(x0_seq[t]), jw)
        ut, st, tw = tstep(tplan, torch.tensor(x0_seq[t]), tw)
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(st.status.numpy(),
                                      np.asarray(sj.status))
    assert (np.abs(ut.numpy()) >= 78.0 - 1e-9).mean() > 0.1


def test_auto_rho_agrees_with_reference():
    """Same candidate, or one whose probe error is within 10% of the error
    of the reference's pick (near-ties can fall either way under f32
    rounding)."""
    _, x0s, _ = _fleet()
    opts = dict(OPTS)
    jrho, jprobe = jax_auto_rho(
        _jax_plan(78.0), x0s, ct.SolverOptions(**opts), seed_center=x0s,
        accurate=True, accurate_rounds=1, use_fused=False, return_probe=True)
    trho, tprobe = tt.auto_rho(
        _port_plan(78.0), x0s, tt.SolverOptions(**opts), seed_center=x0s,
        accurate=True, accurate_rounds=1, return_probe=True)
    assert set(tprobe) == set(jprobe)
    jbest = min(jprobe, key=jprobe.get)
    tbest = min(tprobe, key=tprobe.get)
    assert tbest == jbest or jprobe[tbest] <= 1.1 * jprobe[jbest]
    assert trho == pytest.approx(jrho * tbest / jbest, rel=1e-12)


def test_plan_qp_and_trajectory_match_reference():
    _, _, x0_seq = _fleet()
    jplan, tplan = _jax_plan(60.0), _port_plan(60.0)
    x0 = x0_seq[0].astype(np.float64)
    jqp = jax.vmap(ct.plan_qp)(jplan, jnp.asarray(x0))
    tqp = tt.plan_qp(tplan, x0)
    for name in ("c", "beq", "bineq"):
        np.testing.assert_allclose(getattr(tqp, name).numpy(),
                                   np.asarray(getattr(jqp, name)),
                                   rtol=1e-12, atol=1e-12)
    U = np.random.default_rng(1).normal(size=(LANES, HORIZON))
    np.testing.assert_allclose(
        tt.plan_trajectory(tplan, x0, U).numpy(),
        np.asarray(jax.vmap(ct.plan_trajectory)(jplan, jnp.asarray(x0),
                                                jnp.asarray(U))),
        rtol=1e-6, atol=1e-9)


def test_unported_plan_steps_raise():
    """The accurate tick takes batched box-only plans and raises otherwise.
    The general path's polish, which used to raise for want of ``_polish``,
    runs: a per-lane plan with one inactive inequality row per lane gives
    the box plan's exact solution (1e-5 against the native oracle)."""
    plan = _port_plan(78.0)
    with pytest.raises(ValueError, match="batched box-only"):
        tt.make_plan_step(plan, tt.SolverOptions(), accurate=True)
    dt = plan.Q.dtype
    rows = dataclasses.replace(
        plan, Aineq=torch.zeros(LANES, 1, HORIZON, dtype=dt),
        bineq0=torch.ones(LANES, 1, dtype=dt),
        Bineqmap=torch.zeros(LANES, 2, 1, dtype=dt))
    _, x0s, x0_seq = _fleet()
    errs = {}
    for polish in (True, False):
        step = tt.make_plan_step(rows, tt.SolverOptions(
            max_iter=100, rho=tt.suggest_rho(plan), polish=polish),
            batched=True, seed_center=x0s)
        u, sol, _ = step(rows, torch.tensor(x0_seq[0]), None)
        assert tuple(u.shape) == (LANES, HORIZON)
        errs[polish] = max(
            np.abs(u[lane].numpy().astype(np.float64)
                   - _exact(plan, lane, x0_seq[0][lane])).max()
            for lane in (0, LANES - 1))
    assert errs[True] <= 1e-5 and errs[False] <= 1e-5


def test_native_binding_solves_qld_fixture():
    """The port's ctypes binding against scipy's SLSQP on the Scilab qld
    6-variable QP (equality, inequality and bound rows)."""
    from scipy.optimize import minimize

    qp = tt.DenseQP.create(QLD_Q, QLD_C, QLD_AEQ, QLD_BEQ, QLD_AINEQ,
                           QLD_BINEQ, QLD_XL, QLD_XU)
    sol = tt.solve_qp_native(qp)
    assert int(sol.status) == tt.STATUS_SOLVED
    ref = minimize(
        lambda x: 0.5 * x @ QLD_Q @ x + QLD_C @ x, np.zeros(6),
        jac=lambda x: QLD_Q @ x + QLD_C, method="SLSQP",
        bounds=list(zip(QLD_XL, QLD_XU)),
        constraints=[{"type": "eq", "fun": lambda x: QLD_AEQ @ x - QLD_BEQ},
                     {"type": "ineq",
                      "fun": lambda x: QLD_BINEQ - QLD_AINEQ @ x}],
        options=dict(ftol=1e-14, maxiter=500))
    np.testing.assert_allclose(sol.x.numpy(), ref.x, atol=1e-6)
    assert float(sol.primal_residual) < 1e-9
    assert "solved" in sol.inform()
