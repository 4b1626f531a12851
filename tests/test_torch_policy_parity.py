"""Two f32 serving ticks whose float32 results part from the reference's,
held against it where the arithmetic is the same: the port against the
JAX reference on the CPU.

**The measured stagewise rho on the fleet example.**

``examples/fleet_serving.py`` (16 robots, N = 12, target weights 1e4
against a control weight of 1e-4, condition number about 1e8) picks its
penalty with ``auto_rho_stagewise``.  In float32 the two packages pick
different candidates, because each candidate's float32 ticks miss the
oracle by rounding of the same size (up to ~1e-2 on controls of ~100,
either way).  In float64 the same probe is exact arithmetic of one
algorithm on both sides, and this file holds it so:

* the reference's ``make_stagewise_step(backend="xla")`` ticks over the
  probe's ``x0`` sequence against the port's ``_probe_ticks``, at every
  candidate rho: 1e-9 absolute;
* the two ``_probe_exact`` oracles: 1e-9 absolute;
* at ``max_iter = 10`` both ``auto_rho_stagewise`` calls pick one rho.

This is why ``tests/test_torch_examples.py`` holds the float32 example at
a fixed rho.

**The roofline fleet's f32 fused tick** (``chip_smoke.py``'s
``build_roofline`` fleet, N = 256, at B = 8; the f32 plan; the rho
``auto_rho`` measures; 30 iterations, one round, no seed correction).  The
card's run misses the native oracle by ~8e-2 on every lane.  The
reference's XLA twin (``make_plan_step(..., use_fused=False)``; no Pallas
interpreter) misses it by as much on the same plan and states: both pick
one rho; in float64 the two ticks agree to 1e-7 (measured 2e-9 on controls
of ~63) and still miss the oracle by ~5e-2, so 30 one-round iterations do
not converge at n = 256 in exact arithmetic either (the served roofline
tick is the two-round accurate one); in float32 each side lands ~0.3 from
its own float64 tick, rounding amplified by the plan's conditioning, and
the port no farther than twice the reference.
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
from copra_tpu.plan import auto_rho as jax_auto_rho
from copra_tpu.plan import make_control_plan as jax_make_plan
from copra_tpu.plan import make_plan_step as jax_make_step
from copra_tpu.qp import riccati as jr
from copra_tpu_torch.qp import riccati as tr
from _one_thread import one_torch_thread  # noqa: F401

tt.set_default_device("cpu")

TOL = 1e-9
CANDIDATES = (0.03, 0.1, 0.3, 1.0, 3.0)
ROBOTS, PROBE_LANES, PROBE_STEPS, DRIFT = 16, 4, 3, 0.002


def _fleet_arrays():
    """The example's model, costs and fleet states as float64 numpy (the
    states drawn and rounded to float32 as the example draws them)."""
    T, mass, g = 0.005, 5.0, 9.81
    A = np.array([[1.0, T], [0.0, 1.0]], np.float32)
    B = np.array([[0.5 * T * T / mass], [T / mass]], np.float32)
    d = np.array([-g / 2.0 * T * T, -g * T], np.float32)
    rng = np.random.default_rng(0)
    x0s = (rng.normal(scale=[0.05, 0.5], size=(ROBOTS, 2))
           .astype(np.float32) + np.float32([0.0, -1.5]))
    return [np.asarray(a, np.float64) for a in (A, B, d, x0s)]


def _fleet(pkg, riccati, array):
    A, B, d, x0s = _fleet_arrays()
    system = pkg.LTISystem.create(array(A), array(B), array(d),
                                  array(np.zeros(2)), 12)
    costs = (pkg.TargetCost.create(array(np.eye(2)), array([0.0, -1.0]),
                                   weights=array([10.0, 1e4])),
             pkg.ControlCost.create(array([[1.0]]), array([2.0]),
                                    weights=array([1e-4])))
    cons = (pkg.ControlBoundConstraint.create(array([-150.0]),
                                              array([150.0])),)
    return riccati.from_mpc(system, costs, cons), array(x0s)


@pytest.fixture(scope="module")
def fleets():
    sqp_j, x0_j = _fleet(ct, jr, lambda a: jnp.asarray(a, jnp.float64))
    fleet_j = dataclasses.replace(jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (ROBOTS,) + a.shape), sqp_j), x0=x0_j)
    sqp_t, x0_t = _fleet(tt, tr, lambda a: torch.tensor(
        np.asarray(a, np.float64)))
    fleet_t = dataclasses.replace(tr.stack_stagewise([sqp_t],
                                                     repeats=ROBOTS), x0=x0_t)
    assert fleet_t.A.dtype == torch.float64
    return fleet_j, fleet_t


@pytest.fixture(scope="module")
def probes(fleets):
    fleet_j, fleet_t = fleets
    return (jr._probe_setup(fleet_j, PROBE_LANES, PROBE_STEPS, DRIFT),
            tr._probe_setup(fleet_t, PROBE_LANES, PROBE_STEPS, DRIFT))


def _reference_ticks(sqp_p, x0_seq, options):
    """The reference policy's candidate loop: cold then warm ticks of the
    XLA tick over the probe states; the last tick's U."""
    tick = jr.make_stagewise_step(sqp_p, options, backend="xla")
    warm = U = None
    for x0 in x0_seq:
        _, U, _, warm = tick(x0, warm)
    return np.asarray(U, np.float64)


@pytest.mark.parametrize("rho", CANDIDATES)
def test_probe_ticks_match_reference_in_float64(probes, rho):
    (jp, nl, _, _, jseq), (tp, tnl, _, _, tseq) = probes
    assert nl == tnl == PROBE_LANES
    opts = ct.SolverOptions(max_iter=120, early_exit=False, rho=rho)
    want = _reference_ticks(jp, jseq, opts)
    got = tr._probe_ticks(tp, tseq, opts, None, False)
    assert got.shape == want.shape == (PROBE_LANES, 12, 1)
    assert float(np.abs(got - want).max()) <= TOL


def test_probe_oracles_match_reference_in_float64(probes):
    (jp, nl, jx0, jdrift, _), (tp, _, tx0, tdrift, _) = probes
    np.testing.assert_array_equal(tx0, jx0)
    np.testing.assert_array_equal(tdrift, jdrift)
    opts = ct.SolverOptions(max_iter=120, early_exit=False)
    want = jr._probe_exact(jp, nl, jx0, jdrift, opts, False)
    got = tr._probe_exact(tp, nl, tx0, tdrift, opts, False)
    for g, w in zip(got, want):
        assert float(np.abs(g - np.asarray(w)).max()) <= TOL


def test_auto_rho_stagewise_picks_the_reference_rho_in_float64(fleets):
    fleet_j, fleet_t = fleets
    opts = ct.SolverOptions(max_iter=10, early_exit=False)
    kw = dict(probe_lanes=PROBE_LANES, return_probe=True)
    rho, probe = tr.auto_rho_stagewise(fleet_t, opts, **kw)
    jrho, jprobe = jr.auto_rho_stagewise(fleet_j, opts, **kw)
    assert rho == jrho
    assert set(probe) == set(jprobe) == set(CANDIDATES)
    for c in CANDIDATES:
        assert abs(probe[c] - jprobe[c]) <= TOL, (c, probe[c], jprobe[c])


# --------------------------------------------------------------------------
# the roofline fleet's f32 fused tick

ROOF_LANES = 8
ROOF_F64_TOL = 1e-7
NOT_CONVERGED = 1e-2


@pytest.fixture(scope="module")
def roofline():
    """``chip_smoke.build_roofline`` at B = 8 on the CPU, its f32 plan, the
    reference's plan built from the same arrays (equal in every field),
    and ``chip_smoke.fast_step``'s tick and rho on the f32 plan."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        roof = chip_smoke.build_roofline(tt, torch.device("cpu"),
                                         batch=ROOF_LANES)
    plan = chip_smoke.f32_plan(roof["plan"])
    T, mass = 0.005, 5.0
    A = np.array([[1.0, T], [0.0, 1.0]], np.float32)
    B = np.array([[0.5 * T * T / mass], [T / mass]], np.float32)
    d = np.array([-9.81 / 2.0 * T * T, -9.81 * T], np.float32)
    system = ct.LTISystem.create(A, B, d, roof["x0s"][0].astype(np.float32),
                                 chip_smoke.ROOF_N)
    costs = (ct.TargetCost.create(np.eye(2), [0.0, -1.0],
                                  weights=[10.0, 1e4]),
             ct.ControlCost.create([[1.0]], [2.0], weights=[1e-4]))
    bnd = roof["bound"]
    jplan = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        jax_make_plan(system, costs,
                      (ct.ControlBoundConstraint.create([-bnd], [bnd]),)))
    for name in ("Q", "c0", "Cmap", "lb", "ub", "Phi", "Psi"):
        np.testing.assert_array_equal(getattr(plan, name).numpy(),
                                      np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    tstep, rho = chip_smoke.fast_step(tt, plan, roof["opts"], roof["x0s"],
                                      roof["x0s"].mean(0))
    return roof, plan, jplan, tstep, rho


def _to64(jplan):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jplan)


def _oracle_err(plan, x0s, u):
    """Max |u - exact| over the lanes, exact from the native oracle."""
    return max(float(np.abs(np.asarray(u[k], np.float64) - tt.solve_qp_native(
        tt.plan_qp(plan, np.asarray(x0s[k], np.float64))).x.numpy()).max())
        for k in range(len(x0s)))


def test_roofline_f32_tick_rho_matches_reference(roofline):
    """``chip_smoke.fast_step`` measures the rho the reference's
    ``auto_rho`` measures on the same f32 plan."""
    roof, _, jplan, _, rho = roofline
    x0s, center = roof["x0s"], roof["x0s"].mean(0)
    opts = ct.SolverOptions(max_iter=chip_smoke.ROOF_ITERS,
                            early_exit=False, polish=False)
    assert rho == jax_auto_rho(jplan, x0s, opts, seed_center=center)


def test_roofline_f32_tick_does_not_converge_on_either_side(roofline):
    """Seven ticks (``serve_plan``'s 2 + 5) at the port's rho on both
    sides, in f32 and in f64; the gates of the module docstring."""
    roof, plan, jplan, tstep, rho = roofline
    center = roof["x0s"].mean(0)
    opts = ct.SolverOptions(max_iter=chip_smoke.ROOF_ITERS,
                            early_exit=False, polish=False, rho=rho)
    plan64 = dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name).double()
        for f in dataclasses.fields(plan)
        if isinstance(getattr(plan, f.name), torch.Tensor)})
    jplan64 = _to64(jplan)
    steps = {
        "port32": (tstep, plan, torch.tensor),
        "port64": (tt.make_plan_step(plan64, opts, batched=True,
                                     seed_center=center), plan64,
                   lambda x: torch.tensor(x, dtype=torch.float64)),
        "ref32": (jax_make_step(jplan, opts, batched=True,
                                seed_center=center, use_fused=False), jplan,
                  jnp.asarray),
        "ref64": (jax_make_step(jplan64, opts, batched=True,
                                seed_center=center, use_fused=False),
                  jplan64, lambda x: jnp.asarray(x, jnp.float64))}
    seq = [x.numpy() for x in roof["x0_seq"][:7]]
    u = {}
    for name, (step, p, arr) in steps.items():
        warm = None
        for x in seq:
            out, _, warm = step(p, arr(x), warm)
        u[name] = np.asarray(out.numpy() if isinstance(out, torch.Tensor)
                             else out, np.float64)
    assert float(np.abs(u["port64"] - u["ref64"]).max()) <= ROOF_F64_TOL
    err = {k: _oracle_err(plan, seq[-1], v) for k, v in u.items()}
    assert err["ref64"] >= NOT_CONVERGED
    assert err["ref32"] >= NOT_CONVERGED
    assert err["port32"] <= 2.0 * err["ref32"]
    assert (float(np.abs(u["port32"] - u["port64"]).max())
            <= 2.0 * float(np.abs(u["ref32"] - u["ref64"]).max()))
