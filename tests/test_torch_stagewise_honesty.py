"""The reference's stagewise-honesty suite
(``tests/test_stagewise_honesty.py``) on the PyTorch port, against the JAX
reference on the CPU.

Crossed bounds and conflicting rows report ``STATUS_PRIMAL_INFEASIBLE``;
trajectory rows on the fixed ``x_0`` are checked at build time; a weakly
coupled full-horizon matrix is refused; early exit stops at convergence
and owns up to an exhausted budget; the fused kernel's envelope raises
with guidance; per-lane forensics name the worst lanes.  Each case runs
the same numpy data through both packages, asserts the reference's own
assertion on the port and holds the port's status (equal) and controls
(1e-9 in float64) against the reference's.  Fixed-count budgets of 4000
and 20000 iterations are cut to 300, 600, 800 and 2000 on both sides,
past the point where each certificate fires or each solve converges (the
port's plain loop takes ~1.5 ms an iteration here).

Where the reference runs its fused backend (a Pallas kernel in interpret
mode) the port's ``solve_stagewise_fused`` runs on CPU tensors, i.e. the
kernel's plain version, against the reference's ``solve_stagewise``; the
kernel itself is held on the card (``tests/test_torch_stagewise_cuda.py``,
``chip_smoke.py`` phase 34).  The TPU-only cases get the port's analogs:
``test_x0_check_skipped_under_tracer`` (a ``jax.jit`` build) is the
build under ``torch.func`` transforms, and
``test_fused_envelope_vmem_budget_raises`` (a horizon too long for the
TPU's VMEM) is the port's envelope: the CUDA kernel streams the stages
through a ring, so no horizon is too long, and ``x + u + r <= 128`` is its
limit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.ops import stagewise_kernel as jk
from copra_tpu.qp import riccati as jr
from copra_tpu_torch.ops import stagewise_kernel as sk
from copra_tpu_torch.qp import riccati as tr
from fixtures import (A, B, D, M, N_MAT, SMALL_N, SMALL_X0, UD, U_LOWER,
                      U_UPPER, WU, WX, XD)
from _one_thread import one_torch_thread  # noqa: F401

tt.set_default_device("cpu")

SAME_TOL = 1e-9


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def box_system(pkg, x0=SMALL_X0):
    system = pkg.LTISystem.create(A, B, D, x0, SMALL_N)
    costs = (pkg.TargetCost.create(M, XD, weights=WX),
             pkg.ControlCost.create(N_MAT, UD, weights=WU))
    return system, costs


def _riccati(pkg):
    return jr if pkg is ct else tr


def solve_both(make_cons, x0=SMALL_X0, **opts):
    """``solve_mpc_stagewise`` on both packages; the port's info after
    holding its status, iterations and controls against the
    reference's."""
    out = []
    for pkg in (ct, tt):
        system, costs = box_system(pkg, x0)
        out.append(_riccati(pkg).solve_mpc_stagewise(
            system, costs, make_cons(pkg), pkg.SolverOptions(**opts)))
    (_, Uj, ij), (_, Ut, it) = out
    assert int(_np(it.status)) == int(_np(ij.status))
    assert int(_np(it.iterations)) == int(_np(ij.iterations))
    np.testing.assert_allclose(_np(Ut), _np(Uj), rtol=0, atol=SAME_TOL)
    return it


# ---------------------------------------------------------------------------
# crossed bounds / infeasibility certificates


@pytest.mark.parametrize("early_exit", [False, True])
def test_crossed_control_bounds_report_infeasible(early_exit):
    info = solve_both(
        lambda pkg: (pkg.ControlBoundConstraint.create([5.0], [-5.0]),),
        max_iter=200, early_exit=early_exit)
    assert int(info.status) == tt.STATUS_PRIMAL_INFEASIBLE
    assert "infeasib" in info.inform()


def test_crossed_state_bounds_report_infeasible():
    info = solve_both(
        lambda pkg: (pkg.TrajectoryBoundConstraint.create([1.0, -10.0],
                                                          [-1.0, 10.0]),),
        max_iter=200, early_exit=False)
    assert int(info.status) == tt.STATUS_PRIMAL_INFEASIBLE


def test_crossed_bounds_fused_reports_infeasible():
    """The fused solve on float32 data: the port's plain version of the
    kernel against the reference's XLA solve of the same problem."""
    out = []
    for pkg in (ct, tt):
        system, costs = box_system(pkg)
        cons = (pkg.ControlBoundConstraint.create([5.0], [-5.0]),)
        sqp = _riccati(pkg).from_mpc(system, costs, cons)
        opts = pkg.SolverOptions(max_iter=20, early_exit=False)
        if pkg is ct:
            sqp32 = jax.tree_util.tree_map(
                lambda a: a.astype(jnp.float32) if a is not None else a, sqp)
            out.append(jr.solve_stagewise(sqp32, opts))
        else:
            sqp32 = tr.StagewiseQP(**{
                f.name: None if getattr(sqp, f.name) is None
                else getattr(sqp, f.name).float()
                for f in dataclasses.fields(tr.StagewiseQP)})
            out.append(sk.solve_stagewise_fused(sqp32, opts))
    (_, Uj, ij), (_, Ut, it) = out
    assert int(_np(it.status)) == tt.STATUS_PRIMAL_INFEASIBLE
    assert int(_np(ij.status)) == ct.STATUS_PRIMAL_INFEASIBLE
    scale = max(1.0, float(np.abs(_np(Uj)).max()))
    assert float(np.abs(_np(Ut) - _np(Uj)).max()) <= 2e-4 * scale


@pytest.mark.parametrize("early_exit", [False, True])
def test_row_vs_box_conflict_certificate(early_exit):
    """A control row u <= -5 against the box u >= 0: only the dual-delta
    Farkas certificate sees it (early exit: at 40 iterations)."""
    info = solve_both(
        lambda pkg: (pkg.ControlConstraint.create(np.array([[1.0]]),
                                                  np.array([-5.0])),
                     pkg.ControlBoundConstraint.create(np.array([0.0]),
                                                       np.array([200.0]))),
        max_iter=4000 if early_exit else 300, early_exit=early_exit)
    assert int(info.status) == tt.STATUS_PRIMAL_INFEASIBLE
    if early_exit:
        assert int(info.iterations) < 500


@pytest.mark.parametrize("early_exit", [False, True])
def test_state_row_vs_box_conflict_certificate(early_exit):
    """Velocity row <= -5 against the velocity box >= 0 at rho = 100 (the
    certificate fires at 240 iterations), x_0 inside the row."""
    info = solve_both(
        lambda pkg: (pkg.TrajectoryConstraint.create(np.array([[0.0, 1.0]]),
                                                     np.array([-5.0])),
                     pkg.TrajectoryBoundConstraint.create(
                         np.array([-np.inf, 0.0]),
                         np.array([np.inf, np.inf]))),
        x0=np.array([0.0, -6.0]), max_iter=4000 if early_exit else 600,
        rho=100.0, early_exit=early_exit)
    assert int(info.status) == tt.STATUS_PRIMAL_INFEASIBLE


def test_feasible_rows_no_false_certificate():
    info = solve_both(
        lambda pkg: (pkg.TrajectoryConstraint.create(np.array([[1.0, 0.0]]),
                                                     np.array([50.0])),
                     pkg.ControlBoundConstraint.create(U_LOWER, U_UPPER)),
        max_iter=4000, early_exit=True)
    assert int(info.status) == tt.STATUS_SOLVED


# ---------------------------------------------------------------------------
# build-time x_0 row validation


@pytest.mark.parametrize("f,is_ineq", [(-1.0, True), (2.0, False)])
def test_x0_violated_row_raises_at_build(f, is_ineq):
    """x_0's position 0 breaks x_pos <= -1, and x_pos = 2."""
    for pkg in (ct, tt):
        system, costs = box_system(pkg)
        cons = (pkg.TrajectoryConstraint.create(
            np.array([[1.0, 0.0]]), np.array([f]), is_inequality=is_ineq),)
        with pytest.raises(pkg.InfeasibleProblemError,
                           match="initial state"):
            _riccati(pkg).from_mpc(system, costs, cons)


def _satisfied(pkg):
    system, costs = box_system(pkg)
    return system, costs, (pkg.TrajectoryConstraint.create(
        np.array([[1.0, 0.0]]), np.array([10.0])),)


def test_x0_satisfied_row_builds_fine():
    want = jr.from_mpc(*_satisfied(ct))
    got = tr.from_mpc(*_satisfied(tt))
    assert got.nr_rows == want.nr_rows == 1
    for f in dataclasses.fields(tr.StagewiseQP):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert (g is None) == (w is None), f.name
        if g is not None:
            np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-12,
                                       err_msg=f.name)


@pytest.mark.parametrize("transform", ["vmap", "jacrev", "jacfwd"])
def test_x0_check_skipped_under_transform(transform):
    """The reference builds under ``jax.jit`` (a tracer: no concrete x_0,
    the check is skipped); the port builds under a ``torch.func``
    transform, whose tensors have no values to read either."""
    system, costs, cons = _satisfied(tt)
    build = lambda x0: tr.from_mpc(dataclasses.replace(system, x0=x0),
                                   costs, cons)
    jsystem, jcosts, jcons = _satisfied(ct)
    want = jax.jit(lambda x0: jr.from_mpc(
        dataclasses.replace(jsystem, x0=x0), jcosts, jcons))(
            jnp.asarray(SMALL_X0))
    assert want.nr_rows == 1
    x0 = torch.tensor(SMALL_X0)
    if transform == "vmap":
        got = torch.func.vmap(lambda x: build(x).chi)(torch.stack([x0, x0]))
        for lane in got:
            np.testing.assert_allclose(_np(lane), _np(want.chi), rtol=0,
                                       atol=1e-12)
    else:
        jac = getattr(torch.func, transform)(lambda x: build(x).x0)(x0)
        np.testing.assert_array_equal(_np(jac), np.eye(2))


# ---------------------------------------------------------------------------
# block-diagonal classification (absolute off-diagonal mass)


def test_weak_coupling_not_silently_blockdiag():
    n_blocks, coldim, r = 6, 2, 1
    Mfull = np.zeros((n_blocks * r, n_blocks * coldim))
    for k in range(n_blocks):
        Mfull[k, 2 * k] = 1000.0
    Mfull[0, 2] = 1e-3
    assert jr._blockdiag_blocks(jnp.asarray(Mfull), n_blocks, coldim) is None
    assert tr._blockdiag_blocks(torch.tensor(Mfull), n_blocks,
                                coldim) is None
    Mclean = np.array(Mfull)
    Mclean[0, 2] = 0.0
    want = jr._blockdiag_blocks(jnp.asarray(Mclean), n_blocks, coldim)
    got = tr._blockdiag_blocks(torch.tensor(Mclean), n_blocks, coldim)
    assert got is not None and tuple(got.shape) == (n_blocks, r, coldim)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_coupled_full_horizon_cost_raises():
    Nfull = SMALL_N + 1
    Mfull = np.zeros((Nfull, Nfull * 2))
    for k in range(Nfull):
        Mfull[k, 2 * k] = 1.0
    Mfull[0, 4] = 1e-4
    for pkg in (ct, tt):
        system, costs = box_system(pkg)
        arr = jnp.asarray if pkg is ct else torch.tensor
        bad = (pkg.TrajectoryCost(M=arr(Mfull), p=arr(np.zeros(Nfull)),
                                  weights=arr(np.ones(Nfull))),) + costs[1:]
        with pytest.raises(pkg.DimensionError, match="couples stages"):
            _riccati(pkg).from_mpc(system, bad, ())


# ---------------------------------------------------------------------------
# early exit


def _bounds(pkg):
    return (pkg.ControlBoundConstraint.create(U_LOWER, U_UPPER),)


def test_early_exit_stops_and_matches_fixed_count():
    info = solve_both(_bounds, max_iter=20000, eps_abs=1e-8, eps_rel=0.0)
    assert int(info.status) == tt.STATUS_SOLVED
    assert int(info.iterations) < 5000
    system, costs = box_system(tt)
    _, U1, _ = tr.solve_mpc_stagewise(system, costs, _bounds(tt),
                                      tt.SolverOptions(max_iter=20000,
                                                       eps_abs=1e-8,
                                                       eps_rel=0.0))
    fixed = solve_both(_bounds, max_iter=2000, eps_abs=1e-8, eps_rel=0.0,
                       early_exit=False)
    assert int(fixed.status) == tt.STATUS_SOLVED
    np.testing.assert_allclose(_np(U1).ravel(), _np(fixed.x), atol=1e-6)


def test_early_exit_budget_exhaustion_is_honest():
    info = solve_both(_bounds, max_iter=3, seed="zero", eps_abs=1e-12,
                      eps_rel=0.0)
    assert int(info.status) != tt.STATUS_SOLVED
    assert int(info.iterations) == 3


# ---------------------------------------------------------------------------
# fused kernel envelope / contradictory args


def _wide_state(pkg, N=20, x=16, u=2):
    rng = np.random.default_rng(0)
    eye = np.eye(x, dtype=np.float32)
    f = dict(A=np.repeat((0.95 * eye)[None], N, 0),
             B=rng.normal(size=(N, x, u)).astype(np.float32),
             d=np.zeros((N, x), np.float32),
             Qx=np.repeat(eye[None], N + 1, 0),
             qx=np.zeros((N + 1, x), np.float32),
             Ru=np.repeat(np.eye(u, dtype=np.float32)[None], N, 0),
             ru=np.zeros((N, u), np.float32), x0=np.zeros(x, np.float32),
             xlb=np.full((N + 1, x), -1.0, np.float32),
             xub=np.full((N + 1, x), 1.0, np.float32),
             ulb=np.full((N, u), -1.0, np.float32),
             uub=np.full((N, u), 1.0, np.float32))
    arr = jnp.asarray if pkg is ct else torch.tensor
    return _riccati(pkg).StagewiseQP(**{k: arr(v) for k, v in f.items()})


def test_fused_envelope_large_state_now_streams():
    """x = 16 takes the streamed entry point on both sides; a width past
    the limit raises naming the envelope."""
    want = jk.build_fused_plan(_wide_state(ct), ct.SolverOptions(max_iter=10))
    assert want.plan_fwd is not None
    got = sk.build_fused_plan(_wide_state(tt), tt.SolverOptions(max_iter=10))
    assert got.mode == "streamed"
    with pytest.raises(ValueError, match="envelope"):
        jk.check_fused_envelope(50, 64, 64, 64, jnp.float32)
    with pytest.raises(ValueError, match="envelope"):
        sk.check_fused_envelope(50, 64, 64, 64, torch.float32)


def test_fused_envelope_budget_raises():
    """The reference's VMEM budget trips on a 200,000-stage horizon; the
    port's kernel streams stages through a ring, so that horizon is inside
    its envelope, and its limit is the width: x + u + r <= 128."""
    with pytest.raises(ValueError, match="VMEM"):
        jk.check_fused_envelope(200_000, 3, 1, 2, jnp.float32)
    sk.check_fused_envelope(200_000, 3, 1, 2, torch.float32)
    sk.check_fused_envelope(200_000, 3, 1, 124, torch.float32)
    with pytest.raises(ValueError, match="x\\+u\\+r <= 128"):
        sk.check_fused_envelope(200_000, 3, 1, 125, torch.float32)


def test_fused_plus_parallel_scan_is_an_error():
    for pkg in (ct, tt):
        system, costs = box_system(pkg)
        sqp = _riccati(pkg).from_mpc(system, costs, ())
        sqp_b = (jax.tree_util.tree_map(lambda a: a[None], sqp) if pkg is ct
                 else tr.stack_stagewise([sqp]))
        with pytest.raises(ValueError, match="contradictory"):
            _riccati(pkg).make_stagewise_step(
                sqp_b, pkg.SolverOptions(max_iter=10), backend="fused",
                parallel_scan=True)


# ---------------------------------------------------------------------------
# per-lane forensics


def _three_lanes(pkg):
    system, costs = box_system(pkg)
    sqp = _riccati(pkg).from_mpc(system, costs, _bounds(pkg))
    x0b = np.stack([SMALL_X0, [0.0, -50.0], SMALL_X0])
    if pkg is ct:
        sqp_b = jax.tree_util.tree_map(lambda a: jnp.stack([a, a, a]), sqp)
        return dataclasses.replace(sqp_b, x0=jnp.asarray(x0b))
    return dataclasses.replace(tr.stack_stagewise([sqp], repeats=3),
                               x0=torch.tensor(x0b))


def test_failed_lanes_and_inform_name_worst_lane():
    """Lane 1 starts far away; 5 zero-seed iterations leave it (at least)
    unconverged: ``failed_lanes`` names it first and ``inform`` says
    "worst lanes"; a fully solved batch names none."""
    out = []
    for opts in (dict(max_iter=5, seed="zero", eps_abs=1e-10, eps_rel=0.0,
                      early_exit=False),
                 dict(max_iter=800, early_exit=False)):
        jopts, topts = ct.SolverOptions(**opts), tt.SolverOptions(**opts)
        _, Uj, ij = jax.vmap(lambda s: jr.solve_stagewise(s, jopts))(
            _three_lanes(ct))
        _, Ut, it = tr.solve_stagewise(_three_lanes(tt), topts)
        np.testing.assert_array_equal(_np(it.status), _np(ij.status))
        np.testing.assert_allclose(_np(Ut), _np(Uj), rtol=0, atol=SAME_TOL)
        out.append((it, ij))
    (bad, jbad), (ok, jok) = out
    lanes = bad.failed_lanes(2)
    assert lanes == jbad.failed_lanes(2)
    assert lanes and all(int(_np(bad.status)[i]) != 0 for i in lanes)
    msg = bad.inform()
    assert "worst lanes" in msg and f"lane {lanes[0]}" in msg
    assert (_np(ok.status) == 0).all()
    assert ok.failed_lanes() == [] == jok.failed_lanes()
    assert "worst lanes" not in ok.inform()
