"""The port's example scripts (``examples/torch_*.py``) against the
reference's (``examples/*.py``), on the CPU.

The model arrays each script builds equal the reference script's exactly.
The bipedal preview (N = 60 at T = 0.02 s, float64: the reference ZMP
crosses a footstep and the polygon rows are active) holds against the
reference's at the golden tolerances (trajectory 1e-4, control 2e-4;
measured 2.0e-14 and 8.5e-14); the fleet-serving loop (16 robots, 5
ticks a chain, rho 1.0 on both sides, float32) at the serving contract,
1e-4 x max(1, max |x|) (measured 1.7e-5 absolute); the quadruped
fleet (2 robots, N = 16, rho and the warm budget given, float32) at the
stagewise serving contract, 1e-4 x max(1, max |U|) (measured 7.2e-6
relative); the
getting-started controller (N = 40, float64) at the golden tolerances
against the reference's ``LMPC`` (measured 1.6e-10).  The entry points run
on the package's default device and raise where it is a GPU that is not
there.
"""

import os
import sys

import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))

import bipedal_walking as jax_bipedal  # noqa: E402
import quadruped_srb as jax_quadruped  # noqa: E402
import torch_bipedal_walking as bipedal  # noqa: E402
import torch_fleet_serving as fleet  # noqa: E402
import torch_getting_started as getting_started  # noqa: E402
import torch_quadruped_srb as quadruped  # noqa: E402

tt.set_default_device("cpu")

TRAJ_TOL, CONTROL_TOL, SERVE_RTOL = 1e-4, 2e-4, 1e-4


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def test_model_arrays_equal_the_reference_scripts():
    for got, want in zip(bipedal.lipm_system(0.005, 0.8),
                         jax_bipedal.lipm_system(0.005, 0.8)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(bipedal.footstep_plan(4, 300, 0.005),
                         jax_bipedal.footstep_plan(4, 300, 0.005)):
        np.testing.assert_array_equal(got, want)
    system, costs, cons, x_ref = quadruped.build_problem(N=8)
    jsystem, jcosts, jcons, jx_ref = jax_quadruped.build_problem(N=8)
    np.testing.assert_array_equal(x_ref, jx_ref)
    for f in ("A", "B", "d", "x0"):
        np.testing.assert_array_equal(_np(getattr(system, f)),
                                      _np(getattr(jsystem, f)))
        assert getattr(system, f).dtype == torch.float32
    for got, want in zip(costs + cons, jcosts + jcons):
        assert type(got).__name__ == type(want).__name__
        for f in ("M", "p", "weights", "G", "f", "lower_bound",
                  "upper_bound"):
            if hasattr(want, f):
                np.testing.assert_array_equal(_np(getattr(got, f)),
                                              _np(getattr(want, f)))
    # the getting-started constants are the reference script's (which
    # solves on import, so its constants are restated here)
    T, mass = 0.005, 5.0
    np.testing.assert_array_equal(getting_started.A,
                                  [[1.0, T], [0.0, 1.0]])
    np.testing.assert_array_equal(getting_started.B,
                                  [[0.5 * T * T / mass], [T / mass]])
    np.testing.assert_array_equal(getting_started.d,
                                  [-9.81 / 2 * T * T, -9.81 * T])
    np.testing.assert_array_equal(getting_started.x0, [0.0, -5.0])


def test_bipedal_preview_matches_reference():
    opts = dict(max_iter=2000)
    X, U, zmp, (ref, lo, hi), sol = bipedal.solve_preview(
        horizon=60, T=0.02, options=tt.SolverOptions(**opts))
    jX, jU, jzmp, _, jsol = jax_bipedal.solve_preview(
        horizon=60, T=0.02, options=ct.SolverOptions(**opts))
    assert tuple(X.shape) == (2, 61 * 3) and tuple(U.shape) == (2, 60)
    assert zmp.shape == (2, 61) and zmp.dtype == np.float64
    # not a trivial case: the reference steps to a new footstep inside the
    # horizon, and the ZMP rides the polygon's edge
    assert len(np.unique(ref[0])) > 1
    assert float(np.abs(zmp - ref).max()) >= 0.05 - 1e-5
    assert float(np.abs(_np(X) - _np(jX)).max()) <= TRAJ_TOL
    assert float(np.abs(_np(U) - _np(jU)).max()) <= CONTROL_TOL
    np.testing.assert_array_equal(_np(sol.status), _np(jsol.status))
    np.testing.assert_array_equal(_np(sol.iterations),
                                  _np(jsol.iterations))
    assert (zmp <= hi + 1e-5).all() and (zmp >= lo - 1e-5).all()


def test_fleet_serving_matches_reference_at_a_fixed_rho(monkeypatch):
    """``torch_fleet_serving.main`` against ``fleet_serving.main`` with
    rho fixed on both sides (the reference's probes patched out, its first
    chain recorded): the states at the serving contract, the statuses
    equal on all but at most 2 of the 96 lane-ticks (measured 1: the cold
    tick of lane 4, whose f32 primal residual sits on the tolerance in
    rounding steps of 3.8e-6).  Rho is fixed because the example's
    float32 probes pick different candidates on the two sides by rounding
    alone: ``tests/test_torch_policy_parity.py`` holds the same probe in
    float64, where both sides pick one rho."""
    import fleet_serving as jax_fleet

    rho, ticks, chains = 1.0, 5, []
    make = jax_fleet.make_stagewise_multistep

    def recording(*args, **kw):
        many = make(*args, **kw)

        def call(*a, **k):
            chains.append(many(*a, **k))
            return chains[-1]

        return call

    monkeypatch.setattr(jax_fleet, "make_stagewise_multistep", recording)
    monkeypatch.setattr(jax_fleet, "auto_rho_stagewise",
                        lambda *a, **k: (rho, {}))
    jax_fleet.main()
    record = {}
    statuses, states, share = fleet.main(device="cpu", rho=rho,
                                         ticks=ticks, record=record)
    jstates = _np(chains[0][0])[:ticks + 2]
    jstatuses = _np(chains[0][2])[:ticks + 1]
    assert tuple(states.shape) == jstates.shape == (ticks + 2, 16, 2)
    scale = max(1.0, float(np.abs(jstates).max()))
    assert float(np.abs(_np(states) - jstates).max()) <= SERVE_RTOL * scale
    assert int((_np(statuses) != jstatuses).sum()) <= 2
    assert share == float((_np(statuses) == tt.STATUS_SOLVED).mean())
    assert len(record["chain_s"]) == 2 and record["tick"] is not None
    assert torch.equal(record["x0"], states[-1])


def test_quadruped_serve_matches_reference():
    record = {}
    X, U, info, _ = quadruped.serve(robots=2, N=16, ticks=3, rho=0.1,
                                    warm_iters=60, verbose=False,
                                    record=record)
    jX, jU, jinfo, _ = jax_quadruped.serve(robots=2, N=16, ticks=3, rho=0.1,
                                           warm_iters=60, verbose=False)
    assert tuple(X.shape) == (2, 17, 12) and tuple(U.shape) == (2, 16, 12)
    scale = max(1.0, float(np.abs(_np(jU)).max()))
    assert float(np.abs(_np(U) - _np(jU)).max()) <= SERVE_RTOL * scale
    assert float(np.abs(_np(X) - _np(jX)).max()) <= SERVE_RTOL * scale
    assert (_np(info.status) == tt.STATUS_SOLVED).all()
    np.testing.assert_array_equal(_np(info.status), _np(jinfo.status))
    # what a caller reads back: each tick's seconds (the cold tick and 3
    # warm ones) and the next tick's inputs
    assert len(record["tick_s"]) == 4 and min(record["tick_s"]) > 0.0
    assert torch.equal(record["x0"], X[:, 1]) and len(record["warm"]) == 6
    # the reference test's physics: friction cones and the height corridor
    f = _np(U)[:, 0].astype(np.float64).reshape(2, 4, 3)
    assert (f[..., 2] >= -1e-4).all()
    assert (np.abs(f[..., 0]) <= 0.6 * f[..., 2] + 1e-3).all()
    assert (_np(X)[:, :, 5] >= 0.2 - 1e-5).all()


def _reference_getting_started(horizon):
    from torch_getting_started import A, B, d, x0
    system = ct.LTISystem.create(A, B, d, x0, horizon=horizon)
    controller = ct.LMPC(system, options=ct.SolverOptions(
        max_iter=8000, eps_abs=1e-7, eps_rel=0.0))
    controller.add_cost(ct.TargetCost.create(np.eye(2), [0.0, -1.0],
                                             weights=[10.0, 1e4]))
    controller.add_cost(ct.ControlCost.create([[1.0]], [2.0],
                                              weights=[1e-4]))
    controller.add_constraint(ct.TrajectoryBoundConstraint.create(
        [-np.inf, -np.inf], [np.inf, 0.0]))
    controller.add_constraint(ct.ControlBoundConstraint.create(
        [-np.inf], [200.0]))
    assert controller.solve()
    return np.asarray(controller.trajectory()), np.asarray(
        controller.control())


def test_getting_started_matches_reference_and_needs_its_device():
    X, U, controller = getting_started.main(horizon=40, device="cpu")
    jX, jU = _reference_getting_started(40)
    assert float(np.abs(X - jX).max()) <= TRAJ_TOL
    assert float(np.abs(U - jU).max()) <= CONTROL_TOL
    assert X[1::2].max() <= 1e-6 and U.max() <= 200.0 + 1e-6
    if torch.cuda.is_available():
        return
    # the default device, set to a GPU this host lacks: it raises, it
    # does not fall back to the CPU
    tt.set_default_device("cuda")
    try:
        with pytest.raises((RuntimeError, AssertionError)):
            getting_started.main(horizon=5)
    finally:
        tt.set_default_device("cpu")
