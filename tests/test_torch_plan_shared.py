"""Shared-plan fleets and the general-row plan step of the PyTorch port
against the JAX reference and the native f64 oracle, on the CPU.

Plans come from the reference's own build (``make_control_plan`` on the
SmallSystem fixtures of ``test_plan.py``, N = 10) and reach the port through
``plan_from_numpy``, so each test holds one step against the other on the
same data.  The reference runs its XLA routes (``use_fused=False``); the
Pallas interpreter serves two tiny cases only.  Tolerances: 1e-9 in f64
for the plain steps (same updates, other summation order); in f32 those of
``test_plan.py`` (2e-4 on U, 1e-2 relative on the dual residual, equal
statuses after two warm ticks); 2e-4 for a kernel's plain version after 30
f32 iterations (the reference's kernel tolerance); 1e-5 against the
oracle (the library's accuracy contract).  On the CPU a wrapper runs its
kernel's plain version, so ``use_fused=True`` drives the kernel paths'
control flow here; the kernels themselves are held against the plain
versions on the card (``test_torch_shared_cuda.py``).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.autospan import span_matrix
from copra_tpu.ops.admm_kernel import (fused_admm_box_shared as jax_box_shared,
                                       fused_admm_general_shared as
                                       jax_general_shared, xla_admm_box)
from copra_tpu.plan import (make_control_plan as jax_make_plan,
                            make_plan_step as jax_make_step)
from copra_tpu_torch.convert import plan_from_numpy
from copra_tpu_torch.ops import admm_kernel as ak
from copra_tpu_torch.plan import _general_fast_state
from fixtures import (A, B, D, INEQ_E, INEQ_G, INEQ_H, INEQ_P, M, N_MAT,
                      SMALL_N, SMALL_X0, U_LOWER, U_UPPER, UD, WU, WX, XD,
                      X_LOWER, X_UPPER)

tt.set_default_device("cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATIC = ("xdim", "udim", "horizon")
ITERS = 30
SC = dict(sigma=1e-6, alpha=1.6, rho=0.2)
LANES = 5


def _costs():
    return (ct.TargetCost.create(M, XD, weights=WX),
            ct.ControlCost.create(N_MAT, UD, weights=WU))


def _constraints(general: bool):
    box = (ct.ControlBoundConstraint.create(U_LOWER, U_UPPER),)
    if not general:
        return box
    return (ct.TrajectoryConstraint.create(INEQ_E, INEQ_P),
            ct.ControlConstraint.create(INEQ_G, INEQ_H),
            ct.TrajectoryBoundConstraint.create(X_LOWER, X_UPPER)) + box


def _x0s(seed=4):
    rng = np.random.default_rng(seed)
    return SMALL_X0[None] + rng.normal(scale=[0.02, 0.1], size=(LANES, 2))


@functools.lru_cache(maxsize=None)
def _jax_plan(general: bool, per_lane: bool, f32: bool):
    """The reference plan: one shared plan, or one per lane of ``_x0s``."""
    system = ct.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    costs, constraints = _costs(), _constraints(general)
    build = lambda x0: jax_make_plan(system.with_x0(x0), costs, constraints)
    plan = (jax.jit(jax.vmap(build))(jnp.asarray(_x0s())) if per_lane
            else build(jnp.asarray(SMALL_X0)))
    if f32:
        plan = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), plan)
    return plan


def _port(jplan):
    return plan_from_numpy({f.name: getattr(jplan, f.name) if f.name in STATIC
                            else np.asarray(getattr(jplan, f.name))
                            for f in dataclasses.fields(jplan)})


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t)


def _box_problem(B=12, n=11, dtype=np.float32, seed=0):
    """Shared well-conditioned operators and distinct non-zero x0, y0, z0
    (the reference's kernel test, with warm starts it does not use)."""
    rng = np.random.default_rng(seed)
    Mx = rng.normal(size=(n, n))
    Q = Mx @ Mx.T + 0.5 * np.eye(n)
    K = Q + (SC["sigma"] + SC["rho"]) * np.eye(n)
    Kinv = np.linalg.inv(K)
    l = np.full((B, n), -0.5)
    u = np.full((B, n), 0.5)
    vecs = (rng.normal(size=(B, n)), l, u, 0.3 * rng.normal(size=(B, n)),
            0.2 * rng.normal(size=(B, n)),
            np.clip(0.3 * rng.normal(size=(B, n)), l, u))
    return [a.astype(dtype) for a in (Kinv, K, *vecs)]


# --------------------------------------------------------------------------
# K3 and K6: the plain versions and the CPU wrappers


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("refine", [0, 1])
def test_shared_box_plain_matches_xla_twin(dtype, refine):
    """``admm_box_plain`` on rank-2 operators against ``xla_admm_box``; the
    twin's shared product returns f32 whatever the inputs, so both dtypes
    are held at the f32 tolerance.  The CPU wrapper is the plain version."""
    args = _box_problem(dtype=dtype, seed=refine)
    want = xla_admm_box(*map(jnp.asarray, args), n_iter=ITERS, refine=refine,
                        **SC)
    ts = [torch.tensor(a) for a in args]
    got = ak.admm_box_plain(*ts, n_iter=ITERS, refine=refine, **SC)
    for name, g, w in zip("xyzg", got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=2e-4,
                                   err_msg=name)
    before = ak.fused_admm_box_shared.launches
    wrapped = ak.fused_admm_box_shared(*ts, n_iter=ITERS, refine=refine, **SC)
    assert ak.fused_admm_box_shared.launches == before
    for g, w in zip(wrapped, got):
        assert torch.equal(g, w)


def test_shared_box_plain_matches_pallas_kernel_padded():
    """Against the Pallas shared kernel in interpret mode at B = 20, which
    the reference pads to 32 with copies of lane 0; the port masks."""
    args = _box_problem(B=20, n=8, seed=5)
    want = jax_box_shared(*map(jnp.asarray, args), n_iter=ITERS, refine=1,
                          interpret=True, **SC)
    got = ak.fused_admm_box_shared(*(torch.tensor(a) for a in args),
                                   n_iter=ITERS, refine=1, **SC)
    for name, g, w in zip("xyzg", got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=2e-4,
                                   err_msg=name)


def _general_problem(B=20, n=4, m=10, seed=0):
    """Shared general operators: C = [random rows; I] normalised, rho per
    row (equality rows 10x), l = -inf on three inequality rows."""
    rng = np.random.default_rng(seed)
    C = np.concatenate([rng.normal(size=(m - n, n)), np.eye(n)])
    C /= np.linalg.norm(C, axis=1, keepdims=True)
    rho = np.full(m, 0.3)
    rho[:2] *= 10.0
    Mx = rng.normal(size=(n, n))
    K = Mx @ Mx.T + np.eye(n) + 1e-6 * np.eye(n) + (C.T * rho) @ C
    Kinv = np.linalg.inv(K)
    l = -0.4 + 0.1 * rng.normal(size=(B, m))
    u = l + 0.8
    l[:, 2:5] = -np.inf
    u[:, :2] = l[:, :2]                               # two equality rows
    e0 = 0.2 * rng.normal(size=(B, n))
    y0 = 0.1 * rng.normal(size=(B, m))
    z0 = np.clip(0.2 * rng.normal(size=(B, m)), l, u)
    return [a.astype(np.float32) for a in (Kinv, K, C, rho, l, u, e0, y0, z0)]


def test_general_shared_plain_matches_pallas_kernel():
    """``admm_general_shared_plain`` against the Pallas shared general
    kernel in interpret mode at B = 20 (padded there), n = 4, m = 10, with
    -inf lower bounds and distinct non-zero warm starts, refine 0 and 1."""
    args = _general_problem()
    for refine in (0, 1):
        want = jax_general_shared(*map(jnp.asarray, args), n_iter=12,
                                  refine=refine, interpret=True,
                                  sigma=1e-6, alpha=1.6)
        before = ak.fused_admm_general_shared.launches
        got = ak.fused_admm_general_shared(*(torch.tensor(a) for a in args),
                                           n_iter=12, refine=refine,
                                           sigma=1e-6, alpha=1.6)
        assert ak.fused_admm_general_shared.launches == before
        for name, g, w in zip("eyz", got, want):
            assert g.shape == w.shape
            assert bool(torch.isfinite(g).all())
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                       atol=2e-4, err_msg=f"{name} {refine}")


# --------------------------------------------------------------------------
# the plain steps (f64)


def _jax_state(jstep):
    """The precomputed state a reference step closes over."""
    return dict(zip(jstep.__code__.co_freevars,
                    (c.cell_contents for c in jstep.__closure__)))


@pytest.mark.parametrize("per_lane", [False, True])
def test_general_fast_state_matches_reference(per_lane):
    jplan = _jax_plan(True, per_lane, False)
    opts = ct.SolverOptions(max_iter=5, polish=False)
    want = _jax_state(jax_make_step(jplan, opts, batched=per_lane))
    got = _general_fast_state(_port(jplan), tt.SolverOptions(max_iter=5,
                                                             polish=False))
    for name, g in zip(("C_pre", "E_pre", "rho_pre", "K_pre", "Kinv_pre"),
                       got):
        w = np.asarray(want[name])
        np.testing.assert_allclose(np.broadcast_to(_np(g), w.shape), w,
                                   rtol=1e-12, atol=1e-12, err_msg=name)


def _ticks(jstep, tstep, jplan, tplan, batched, ticks=2):
    """Warm ticks through both steps at drifting states; the last results."""
    x0s = _x0s(7) if batched else SMALL_X0
    jw = tw = None
    for t in range(ticks):
        x0 = (x0s + 0.01 * t).astype(np.asarray(jplan.Q).dtype)
        if batched:
            uj, sj, jw = jstep(jplan, jnp.asarray(x0), jw)
            ut, st, tw = tstep(tplan, torch.tensor(x0), tw)
        else:
            uj, sj, jw = jstep(jnp.asarray(x0), jw)
            ut, st, tw = tstep(torch.tensor(x0), tw)
    return (uj, sj, jw), (ut, st, tw)


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("layout", ["unbatched", "shared", "per_lane"])
def test_plain_steps_match_reference_f64(general, layout):
    """The box and general ``single`` steps, unbatched and batched (shared
    and per-lane plans), against the reference's XLA steps at 1e-9 in f64,
    solution, duals, residuals and statuses, over two warm ticks."""
    jplan = _jax_plan(general, layout == "per_lane", False)
    tplan = _port(jplan)
    batched = layout != "unbatched"
    kw = dict(max_iter=200, polish=False)
    jstep = jax_make_step(jplan, ct.SolverOptions(**kw), batched=batched,
                          use_fused=False, seed_center=SMALL_X0)
    tstep = tt.make_plan_step(tplan, tt.SolverOptions(**kw), batched=batched,
                              seed_center=SMALL_X0)
    (uj, sj, wj), (ut, st, wt) = _ticks(jstep, tstep, jplan, tplan, batched)
    assert ut.dtype == torch.float64 and tuple(ut.shape) == uj.shape
    for name, g, w in (("U", ut, uj), ("y", st.y, sj.y), ("z", st.z, sj.z),
                       ("warm y", wt.y, wj.y),
                       ("prim", st.primal_residual, sj.primal_residual),
                       ("dual", st.dual_residual, sj.dual_residual)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-9,
                                   atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(_np(st.status), np.asarray(sj.status))
    np.testing.assert_array_equal(_np(st.iterations),
                                  np.asarray(sj.iterations))


def test_general_polish_raises():
    """The general path's polish used to raise for want of ``_polish``; it
    now runs (default options polish), unbatched and batched, and meets
    the native oracle (1e-5, the library's accuracy contract)."""
    tplan = _port(_jax_plan(True, False, False))
    x0 = torch.tensor(_x0s(7))
    u, sol, warm = tt.make_plan_step(tplan, tt.SolverOptions(max_iter=100),
                                     batched=True)(tplan, x0, None)
    u1, sol1, _ = tt.make_plan_step(tplan, tt.SolverOptions(max_iter=100),
                                    use_fused=True)(x0[0], None)
    np.testing.assert_allclose(_np(u1), _np(u[0]), rtol=0, atol=1e-9)
    assert int(sol1.status) == 0 and (_np(sol.status) == 0).all()
    for lane in range(LANES):
        exact = tt.solve_qp_native(tt.plan_qp(tplan, _np(x0[lane]))).x.numpy()
        assert np.abs(_np(u[lane]) - exact).max() <= 1e-5
    assert tuple(warm.y.shape) == (LANES, sol.y.shape[-1])


@pytest.mark.parametrize("layout", ["unbatched", "shared", "per_lane"])
def test_polished_general_step_matches_reference(layout):
    """The polished general step against the reference's
    ``make_plan_step(..., polish=True)`` over two warm ticks in f64:
    solution, duals and residuals to 1e-8 (both polish to the same vertex;
    LAPACK's LU and XLA's pivot alike but sum in another order), equal
    statuses."""
    jplan = _jax_plan(True, layout == "per_lane", False)
    tplan = _port(jplan)
    batched = layout != "unbatched"
    kw = dict(max_iter=100, polish=True)
    jstep = jax_make_step(jplan, ct.SolverOptions(**kw), batched=batched,
                          use_fused=False, seed_center=SMALL_X0)
    tstep = tt.make_plan_step(tplan, tt.SolverOptions(**kw), batched=batched,
                              seed_center=SMALL_X0)
    (uj, sj, wj), (ut, st, wt) = _ticks(jstep, tstep, jplan, tplan, batched)
    for name, g, w in (("U", ut, uj), ("y", st.y, sj.y), ("z", st.z, sj.z),
                       ("warm y", wt.y, wj.y),
                       ("prim", st.primal_residual, sj.primal_residual),
                       ("dual", st.dual_residual, sj.dual_residual)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    np.testing.assert_array_equal(_np(st.status), np.asarray(sj.status))
    assert (_np(st.status) == 0).all()


# --------------------------------------------------------------------------
# the f32 kernel paths (plain versions on the CPU)


@pytest.mark.parametrize("general,per_lane", [(False, False), (False, True),
                                              (True, False)])
def test_fused_f32_ticks_match_reference(general, per_lane):
    """The f32 fused tick on shared (K3) and per-lane (K2) plans, and the
    general tick with ``use_fused=True`` (K6), against the reference's
    ``use_fused=False`` steps, as ``test_plan.py`` holds the reference's
    own fused steps."""
    jplan = _jax_plan(general, per_lane, True)
    tplan = _port(jplan)
    kw = dict(max_iter=300, polish=False)
    jstep = jax_make_step(jplan, ct.SolverOptions(**kw), batched=True,
                          use_fused=False, seed_center=_x0s().mean(0))
    tstep = tt.make_plan_step(tplan, tt.SolverOptions(**kw), batched=True,
                              use_fused=True, seed_center=_x0s().mean(0))
    (uj, sj, _), (ut, st, _) = _ticks(jstep, tstep, jplan, tplan, True)
    assert ut.dtype == torch.float32
    np.testing.assert_allclose(_np(ut), np.asarray(uj), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(st.dual_residual),
                               np.asarray(sj.dual_residual), rtol=1e-2,
                               atol=1e-5)
    np.testing.assert_array_equal(_np(st.status), np.asarray(sj.status))


def test_fused_steps_route_to_their_kernels(monkeypatch):
    """Which wrapper each f32 step calls: shared box plans K3, per-lane box
    plans K2, the explicit general tick K6, the accurate shared tick K3;
    ``use_fused=False`` calls none of them."""
    seen = []
    for name in ("fused_admm_box_shared", "fused_admm_box",
                 "fused_admm_box_lanes", "fused_admm_general_shared"):
        fn = getattr(ak, name)
        monkeypatch.setattr(
            "copra_tpu_torch.plan." + name,
            lambda *a, _fn=fn, _name=name, **k: (seen.append(_name),
                                                 _fn(*a, **k))[1])
    x0 = torch.tensor(_x0s().astype(np.float32))
    opts = tt.SolverOptions(max_iter=3, polish=False)
    cases = [((False, False), dict(use_fused=True), "fused_admm_box_shared"),
             ((False, True), dict(use_fused=True), "fused_admm_box"),
             ((True, False), dict(use_fused=True),
              "fused_admm_general_shared"),
             ((False, False), dict(accurate=True), "fused_admm_box_shared"),
             ((False, True), dict(accurate=True), "fused_admm_box_lanes")]
    for (general, per_lane), kw, want in cases:
        tplan = _port(_jax_plan(general, per_lane, True))
        seen.clear()
        tt.make_plan_step(tplan, opts, batched=True, **kw)(tplan, x0, None)
        assert seen and set(seen) == {want}, (general, per_lane, kw, seen)
    for general in (False, True):
        tplan = _port(_jax_plan(general, False, True))
        seen.clear()
        tt.make_plan_step(tplan, opts, batched=True, use_fused=False)(
            tplan, x0, None)
        tt.make_plan_step(tplan, opts, batched=True)(tplan, x0, None)
        assert not seen


# --------------------------------------------------------------------------
# the accurate tick on a shared plan


@functools.lru_cache(maxsize=None)
def _config1(lanes=8, N=10):
    """``bench_all.py``'s config 1 cut to 8 lanes: the LTI double
    integrator, a full-size position cost, +-2 control bounds."""
    T = 0.1
    Ad = np.array([[1.0, T], [0.0, 1.0]])
    Bd = np.array([[0.5 * T * T], [T]])
    rng = np.random.default_rng(1)
    x0s = np.array([1.0, 0.0])[None] + rng.normal(scale=[0.3, 0.2],
                                                  size=(lanes, 2))
    f32 = jnp.float32
    system = ct.LTISystem.create(Ad.astype(np.float32), Bd.astype(np.float32),
                                 np.zeros(2, np.float32),
                                 x0s[0].astype(np.float32), N)
    pos_row = np.asarray(span_matrix(np.array([[1.0, 0.0]]), N + 1))
    costs = (ct.TrajectoryCost(M=jnp.asarray(pos_row, f32),
                               p=jnp.zeros(N + 1, f32),
                               weights=jnp.full(N + 1, 10.0, f32)),
             ct.SimpleControlCost(p=jnp.zeros(N, f32),
                                  weights=jnp.full(N, 1e-3, f32)))
    plan = jax_make_plan(system, costs,
                         (ct.ControlBoundConstraint.create([-2.0], [2.0]),))
    drift = rng.normal(scale=0.02, size=(3, lanes, 2)).cumsum(0)
    return plan, x0s, (x0s[None] + drift).astype(np.float32)


def test_accurate_shared_tick_matches_reference_and_oracle():
    """Config 1's accurate tick (3 rounds) on its shared plan: within 1e-5
    of the native oracle on every lane, and within 2e-5 of the reference's
    XLA route (each carries its f32 corrections' floor, ~1e-5 on the lanes
    whose bounds bind partly, summed in another order)."""
    jplan, x0s, x0_seq = _config1()
    tplan = _port(jplan)
    opts = dict(max_iter=300, early_exit=False, polish=False)
    rho = tt.auto_rho(tplan, x0s, tt.SolverOptions(**opts),
                      seed_center=x0s.mean(0), accurate=True,
                      accurate_rounds=3)
    jstep = jax_make_step(jplan, ct.SolverOptions(**opts).replace(rho=rho),
                          batched=True, seed_center=x0s.mean(0),
                          accurate=True, accurate_rounds=3, use_fused=False)
    tstep = tt.make_plan_step(tplan, tt.SolverOptions(**opts).replace(
        rho=rho), batched=True, seed_center=x0s.mean(0), accurate=True,
        accurate_rounds=3)
    jw = tw = None
    for x0 in x0_seq:
        uj, sj, jw = jstep(jplan, jnp.asarray(x0), jw)
        ut, st, tw = tstep(tplan, torch.tensor(x0), tw)
    assert ut.dtype == torch.float64
    np.testing.assert_allclose(_np(ut), np.asarray(uj), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(_np(st.status), np.asarray(sj.status))
    assert (np.abs(_np(ut)) >= 2.0 - 1e-9).mean() > 0.1   # bounds bind
    for lane in range(len(x0s)):
        qp = tt.plan_qp(tplan, np.asarray(x0_seq[-1][lane], np.float64))
        exact = tt.solve_qp_native(qp).x.numpy()
        assert np.abs(_np(ut[lane]) - exact).max() <= 1e-5


def test_auto_rho_probes_the_fused_general_step():
    """``auto_rho(use_fused=True)`` on a general shared plan builds the step
    the server runs and returns one of its candidates."""
    tplan = _port(_jax_plan(True, False, True))
    opts = tt.SolverOptions(max_iter=50, polish=False)
    rho, probe = tt.auto_rho(tplan, _x0s(), opts, seed_center=SMALL_X0,
                             use_fused=True, return_probe=True)
    gm = tt.suggest_rho(tplan) / 0.1
    assert set(probe) == {0.01, 0.1, 0.33, 1.0, 3.3}
    assert rho == pytest.approx(gm * min(probe, key=probe.get), rel=1e-12)
    assert all(np.isfinite(v) for v in probe.values())


# --------------------------------------------------------------------------
# the default device

_DEVICE_CHECK = """
import numpy as np
import copra_tpu_torch as tt
args = (np.eye(2), np.ones((2, 1)), np.zeros(2), np.zeros(2), 5)
try:
    tt.LTISystem.create(*args)
except RuntimeError as exc:
    print("raised:", exc)
else:
    raise SystemExit("built a system without a CUDA device")
tt.set_default_device("cpu")
s = tt.LTISystem.create(*args)
print("device:", s.A.device.type, tt.default_device())
"""


def test_entry_points_default_to_the_card():
    """With no CUDA device visible, building a system from numpy raises an
    error that names CUDA (no silent CPU fallback); after
    ``set_default_device("cpu")`` the system lies on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", _DEVICE_CHECK], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "raised:" in proc.stdout and "CUDA" in proc.stdout
    assert "set_default_device" in proc.stdout
    assert "device: cpu cpu" in proc.stdout
