"""The reference's stagewise-scaling suite
(``tests/test_stagewise_scaling.py``) on the PyTorch port, against the JAX
reference on the CPU.

The diagonal equilibration of the Riccati engine (``stagewise_scales``,
``scale_stagewise``) is an exact reparametrisation, fixes the stall of an
ill-conditioned robot problem (forces of O(100 N) against states of
O(0.1)), and the serving facades take and return original units under
``scaling="auto"``.  Each case runs the same float64 numpy data through
both packages, asserts the reference's own assertions on the port and
holds the port's states and controls against the reference's at 1e-9
(both float64; the reference's fused-against-XLA tolerance).  The fused
backend runs the port's kernel's plain version on CPU tensors against the
reference's ``backend="xla"``; the quadruped's scaled solve on the card's
kernel (K5, early exit) is ``chip_smoke.py`` phase 34.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.qp import riccati as jr
from copra_tpu_torch.convert import stagewise_from_numpy
from copra_tpu_torch.qp import riccati as tr
from _one_thread import one_torch_thread  # noqa: F401

tt.set_default_device("cpu")

SAME_TOL = 1e-9


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def _ill_scaled(N=12):
    """The reference's ``_ill_scaled_sqp`` fields as float64 numpy: a point
    mass with forces, control in newtons, state in metres."""
    dt, m = 0.02, 20.0
    A1 = np.eye(4)
    A1[0, 2] = A1[1, 3] = dt
    B1 = np.zeros((4, 2))
    B1[2, 0] = B1[3, 1] = dt / m
    w = np.array([100.0, 100.0, 5.0, 5.0])
    return dict(
        A=np.repeat(A1[None], N, 0), B=np.repeat(B1[None], N, 0),
        d=np.zeros((N, 4)), Qx=np.repeat(np.diag(w)[None], N + 1, 0),
        qx=np.repeat((-w * np.array([0.1, -0.05, 0.0, 0.0]))[None],
                     N + 1, 0),
        Ru=np.repeat((1e-5 * np.eye(2))[None], N, 0), ru=np.zeros((N, 2)),
        x0=np.array([0.0, 0.0, 0.2, -0.1]),
        xlb=np.full((N + 1, 4), -0.5), xub=np.full((N + 1, 4), 0.5),
        ulb=np.full((N, 2), -120.0), uub=np.full((N, 2), 120.0))


def _both(f):
    """``(reference StagewiseQP, port StagewiseQP)`` of numpy fields."""
    return (jr.StagewiseQP(**{k: jnp.asarray(v) for k, v in f.items()}),
            stagewise_from_numpy(f))


def _close(got, want, tol=SAME_TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol,
                               err_msg=what)


def test_scale_roundtrip_exact():
    """Solving the scaled problem and mapping back equals the raw solve."""
    jsqp, tsqp = _both(_ill_scaled())
    out = {}
    for riccati, sqp in ((jr, jsqp), (tr, tsqp)):
        Dx, Du = riccati.stagewise_scales(sqp)
        assert float(_np(Du).max()) > 10.0       # force coordinates found
        opts = ct.SolverOptions(max_iter=60000, early_exit=True,
                                eps_abs=1e-11, eps_rel=0.0)
        X0, U0, _ = riccati.solve_stagewise(sqp, opts)
        X1, U1, _ = riccati.solve_stagewise(
            riccati.scale_stagewise(sqp, Dx, Du), opts)
        _close(_np(U1) * _np(Du), U0, 2e-5)
        _close(_np(X1) * _np(Dx), X0, 2e-5)
        out[riccati] = (Dx, Du, U0, U1)
    for g, w in zip(out[tr], out[jr]):
        _close(g, w)


def test_scaling_fixes_ill_conditioned_convergence():
    """The config-6 quadruped (x = u = r = 12) at N = 16 in float64, 800
    iterations with early exit: the scaled problem converges in fewer
    iterations, the raw one does not converge."""
    f = {k: np.asarray(v, np.float64)
         for k, v in chip_smoke.srb_quadruped(N=16).items()}
    jsqp, tsqp = _both(f)
    opts = ct.SolverOptions(max_iter=800, early_exit=True, eps_abs=1e-8,
                            eps_rel=0.0)
    out = {}
    for riccati, sqp in ((jr, jsqp), (tr, tsqp)):
        Dx, Du = riccati.stagewise_scales(sqp)
        assert float(_np(Du).max()) > 10.0
        _, U_raw, i_raw = riccati.solve_stagewise(sqp, opts)
        _, U_s, i_s = riccati.solve_stagewise(
            riccati.scale_stagewise(sqp, Dx, Du), opts)
        assert int(_np(i_s.status)) == 0
        assert int(_np(i_s.iterations)) < int(_np(i_raw.iterations))
        assert int(_np(i_raw.status)) != 0
        out[riccati] = (i_raw, i_s, U_s)
    for g, w in zip(out[tr][:2], out[jr][:2]):
        assert int(_np(g.iterations)) == int(_np(w.iterations))
        assert int(_np(g.status)) == int(_np(w.status))
    _close(out[tr][2], out[jr][2])


def _lanes(f):
    fb = {k: np.stack([v, v]) for k, v in f.items()}
    fb["x0"] = fb["x0"] + np.array([[0.0] * 4, [0.01] * 4])
    return fb


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_step_facade_scaling_original_units(backend):
    """``make_stagewise_step(scaling="auto")`` takes and returns original
    units: forces of O(10-100), states below 1, ``info.x`` the controls,
    the dynamics replayed, a warm tick from the carried scaled-space
    tuple within 1e-3 of the float64 exact solution of lane 0."""
    f = _ill_scaled()
    fb = _lanes(f)
    jsqp, tsqp = _both(fb)
    opts = ct.SolverOptions(max_iter=60, early_exit=False)
    kw = dict(cold_options=opts.replace(max_iter=600), scaling="auto")
    tick_j = jr.make_stagewise_step(jsqp, opts, backend="xla", **kw)
    tick_t = tr.make_stagewise_step(tsqp, opts, backend=backend, **kw)
    assert tick_t.backend == backend
    X, U, info, warm = tick_t(tsqp.x0)
    jX, jU, jinfo, jwarm = tick_j(jsqp.x0)
    assert float(U.abs().max()) > 5.0
    assert float(X.abs().max()) < 1.0
    assert tuple(info.x.shape) == (2, 12 * 2)
    assert torch.equal(info.x, U.reshape(2, -1))
    for k in range(3):
        err = (_np(X[0, k + 1]) - f["A"][0] @ _np(X[0, k])
               - f["B"][0] @ _np(U[0, k]))
        assert np.abs(err).max() < 1e-5
    _close(X, jX, what="X")
    _close(U, jU, what="U")
    np.testing.assert_array_equal(_np(info.status), _np(jinfo.status))
    X2, U2, _, _ = tick_t(tsqp.x0 + 0.005, warm)
    _, jU2, _, _ = tick_j(jsqp.x0 + 0.005, jwarm)
    assert U2.shape == U.shape
    _close(U2, jU2, what="warm U")
    s64 = stagewise_from_numpy(dict(f, x0=fb["x0"][0] + 0.005))
    Dx, Du = tr.stagewise_scales(s64)
    oo = tt.SolverOptions(max_iter=40000, early_exit=True, eps_abs=1e-11,
                          eps_rel=0.0)
    _, Ue, _ = tr.solve_stagewise(tr.scale_stagewise(s64, Dx, Du), oo)
    assert float((U2[0] - Ue * Du).abs().max()) < 1e-3


def test_multistep_facade_scaling_consistent_rollout():
    """``make_stagewise_multistep(scaling="auto")``: the rollout is
    consistent in original units (states[k+1] == plant(states[k],
    U0s[k])) and the chain converges."""
    f = _ill_scaled()
    fb = {k: np.stack([v, v]) for k, v in f.items()}
    jsqp, tsqp = _both(fb)
    opts = ct.SolverOptions(max_iter=60, early_exit=False)
    kw = dict(cold_options=opts.replace(max_iter=600), backend="xla",
              scaling="auto")
    out = []
    for riccati, sqp in ((jr, jsqp), (tr, tsqp)):
        step_many = riccati.make_stagewise_multistep(sqp, opts, **kw)
        states, u0s, statuses, _, _ = step_many(sqp.x0, 3)
        S, Us = _np(states), _np(u0s)
        assert S.shape[0] == Us.shape[0] + 1
        for k in range(Us.shape[0]):
            pred = S[k] @ f["A"][0].T + Us[k] @ f["B"][0].T
            np.testing.assert_allclose(S[k + 1], pred, atol=1e-5)
        assert np.all(_np(statuses)[-1] == 0)
        out.append((S, Us, _np(statuses)))
    (S_j, U_j, st_j), (S_t, U_t, st_t) = out
    _close(S_t, S_j, what="states")
    _close(U_t, U_j, what="controls")
    np.testing.assert_array_equal(st_t, st_j)
