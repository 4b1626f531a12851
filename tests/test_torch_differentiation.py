"""Gradients through the port's solves against the JAX reference, on the
CPU in float64 (analog of ``tests/test_differentiation.py``).

The plain routes are PyTorch operations, so ``torch.autograd`` and
``torch.func`` differentiate them where ``jax.grad`` and ``jax.jacfwd``
differentiate the reference.  The same inputs (the reference's
SmallSystem fixture, N = 10) go through both packages; each JAX side is
one jitted function.  Tolerances:

* the reference's four tests: the weight gradient within 1e-6 relative
  of ``jax.grad`` and within the reference's rtol 1e-3 of central
  differences; du/dx0 by ``jacfwd`` and ``jacrev`` within 1e-6 x max |J|
  of ``jax.jacfwd`` and x0-independent to 1e-4; the tuning loop's first
  gradient within 1e-6 relative of JAX's and a lower loss after three
  steps; the stagewise ``first_control`` gradient within 1e-6 relative
  of ``jax.grad`` and rtol 1e-3 of central differences;
* the early-exit ``solve_stagewise``, ``make_plan_step(batched=True)``
  (plain routes), ``lqr_solve_assoc`` and ``condense``: Jacobians within
  1e-8 x max |J| of ``jax.jacfwd`` (the same float64 arithmetic; the
  distances measured when this was written are in each docstring).

The kernel launches, the captured chains and the host round trips have no
derivative, and refuse one as the reference refuses it: each raises a
``RuntimeError`` naming the plain route when a gradient is asked by
``requires_grad``, by a ``torch.func`` transform or by a forward-mode
tangent, and runs on (to its CPU failure: no kernel here) under
``torch.no_grad()`` or on detached tensors.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.qp.riccati import (from_mpc as jax_from_mpc,
                                  lqr_solve_assoc as jax_lqr_solve_assoc,
                                  solve_stagewise as jax_solve_stagewise)
from copra_tpu_torch._graph import CapturedChain
from copra_tpu_torch.ops import admm_kernel, cholesky_kernel
from copra_tpu_torch.ops import stagewise_kernel
from copra_tpu_torch.qp.riccati import from_mpc, solve_stagewise
from fixtures import (A, B, D, M, N_MAT, SMALL_N, SMALL_X0, UD, U_LOWER,
                      U_UPPER, WU, WX, XD)

tt.set_default_device("cpu")

REL = 1e-6          # port against JAX: gradients, the du/dx0 Jacobian
JAC_REL = 1e-8      # port against JAX: the Jacobians of the new cases


def _t(v):
    return torch.tensor(np.asarray(v, np.float64))


def _problem(pkg, wx_vel, x0, u_upper=U_UPPER):
    """The reference test's problem: SmallSystem with the velocity weight
    ``wx_vel`` and the initial state ``x0`` as the differentiated
    inputs."""
    arr, stack = ((jnp.asarray, jnp.stack) if pkg is ct
                  else (_t, torch.stack))
    system = pkg.LTISystem.create(A, B, D, x0, SMALL_N)
    costs = (pkg.TargetCost(M=arr(M), p=arr(XD),
                            weights=stack([arr(WX[0]), wx_vel])),
             pkg.ControlCost.create(N_MAT, UD, weights=WU))
    constraints = (pkg.ControlBoundConstraint.create(U_LOWER, u_upper),)
    return system, costs, constraints


def _solve(pkg, wx_vel, x0):
    opts = pkg.SolverOptions(max_iter=300, early_exit=False, polish=False)
    return pkg.solve_mpc(*_problem(pkg, wx_vel, x0), opts)


def _vel_loss(pkg, wx_vel, x0):
    res = _solve(pkg, wx_vel, x0)
    return ((res.trajectory[1::2] - XD[1]) ** 2).sum()


def _tuning_loss(pkg, log_w):
    exp = jnp.exp if pkg is ct else torch.exp
    x0 = jnp.asarray(SMALL_X0) if pkg is ct else _t(SMALL_X0)
    res = _solve(pkg, exp(log_w), x0)
    return (((res.trajectory[1::2] - XD[1]) ** 2).sum()
            + 1e-7 * (res.control ** 2).sum())


def _close_rel(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bound = rel * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, \
        f"{np.abs(got - want).max():.3e} > {bound:.3e}"


@functools.lru_cache(maxsize=None)
def _jax_control_jacobian():
    return np.asarray(jax.jit(jax.jacfwd(
        lambda x0: _solve(ct, jnp.asarray(WX[1]), x0).control))(
            jnp.asarray(SMALL_X0)))


# ---------------------------------------------------------------------------
# The reference's four tests, each against its JAX twin
# ---------------------------------------------------------------------------


def test_grad_through_solve_wrt_cost_weight():
    """d(loss)/d(weight) by ``backward()`` through ``solve_mpc``: JAX's
    ``jax.grad`` within 1e-6 relative (5e-11 apart when written), and
    central differences within the reference's rtol 1e-3."""
    w = _t(WX[1]).requires_grad_()
    _vel_loss(tt, w, _t(SMALL_X0)).backward()
    g = float(w.grad)
    want = float(jax.jit(jax.grad(
        lambda v: _vel_loss(ct, v, jnp.asarray(SMALL_X0))))(
            jnp.asarray(WX[1])))
    assert np.isfinite(g)
    assert abs(g - want) <= REL * abs(want), (g, want)
    eps = 1e-3 * WX[1]
    with torch.no_grad():
        fd = float(_vel_loss(tt, _t(WX[1] + eps), _t(SMALL_X0))
                   - _vel_loss(tt, _t(WX[1] - eps), _t(SMALL_X0))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-3, atol=1e-12)


@pytest.mark.parametrize("mode", ["jacfwd", "jacrev"])
def test_jacobian_of_control_wrt_initial_state(mode):
    """du/dx0 by ``torch.func.jacfwd`` and ``jacrev``: ``jax.jacfwd``
    within 1e-6 x max |J| (1.5e-11 apart, max |J| 99.95, when written);
    bounds inactive at both points, so the same affine gain (1e-4)."""
    jac = getattr(torch.func, mode)

    def u_of_x0(x0):
        return _solve(tt, _t(WX[1]), x0).control

    J1 = jac(u_of_x0)(_t(SMALL_X0))
    J2 = jac(u_of_x0)(_t(SMALL_X0) + _t([0.0, 0.1]))
    assert tuple(J1.shape) == (SMALL_N, 2)
    assert torch.isfinite(J1).all()
    _close_rel(J1.numpy(), _jax_control_jacobian(), REL)
    np.testing.assert_allclose(J1.numpy(), J2.numpy(), atol=1e-4)


def test_gradient_descent_tunes_tracking_weight():
    """Three sign-clipped steps on the log weight lower the loss; the
    first gradient is JAX's within 1e-6 relative."""
    want = float(jax.jit(jax.grad(lambda lw: _tuning_loss(ct, lw)))(
        jnp.log(10.0)))

    def value_and_grad(lw):
        lw = lw.detach().requires_grad_()
        val = _tuning_loss(tt, lw)
        (g,) = torch.autograd.grad(val, lw)
        return float(val.detach()), g

    lw = torch.log(_t(10.0))        # start far from the golden weight
    l0, g0 = value_and_grad(lw)
    assert abs(float(g0) - want) <= REL * abs(want), (float(g0), want)
    for _ in range(3):
        _, g = value_and_grad(lw)
        lw = lw - 0.5 * torch.sign(g) * torch.clamp(g.abs(), max=1.0)
    l1, _ = value_and_grad(lw)
    assert l1 < l0


def _stagewise(pkg):
    system = pkg.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    costs = (pkg.TargetCost.create(M, XD, weights=WX),
             pkg.ControlCost.create(N_MAT, UD, weights=WU))
    constraints = (pkg.ControlBoundConstraint.create(U_LOWER, U_UPPER),)
    return (jax_from_mpc if pkg is ct else from_mpc)(system, costs,
                                                     constraints)


def test_grad_through_stagewise_solve():
    """d U[0, 0] / d x0 by ``torch.autograd.grad`` through the
    fixed-count stagewise solve: JAX's ``jax.grad`` within 1e-6 relative,
    central differences within rtol 1e-3 (the reference's gates)."""
    sqp, sqp_j = _stagewise(tt), _stagewise(ct)
    opts = tt.SolverOptions(max_iter=150, early_exit=False)
    opts_j = ct.SolverOptions(max_iter=150, early_exit=False)

    def first_control(x0):
        return solve_stagewise(dataclasses.replace(sqp, x0=x0), opts)[1][0, 0]

    x0 = _t(SMALL_X0).requires_grad_()
    (g,) = torch.autograd.grad(first_control(x0), x0)
    want = np.asarray(jax.jit(jax.grad(lambda x0: jax_solve_stagewise(
        dataclasses.replace(sqp_j, x0=x0), opts_j)[1][0, 0]))(
            jnp.asarray(SMALL_X0)))
    assert tuple(g.shape) == (2,)
    assert torch.isfinite(g).all()
    _close_rel(g.numpy(), want, REL)
    eps = 1e-5
    e0 = _t([eps, 0.0])
    with torch.no_grad():
        fd = float(first_control(_t(SMALL_X0) + e0)
                   - first_control(_t(SMALL_X0) - e0)) / (2 * eps)
    np.testing.assert_allclose(float(g[0]), fd, rtol=1e-3, atol=1e-6)


# ---------------------------------------------------------------------------
# New cases: the early-exit loop, the plan step, the log-depth forms
# ---------------------------------------------------------------------------


def test_early_exit_stagewise_jacobian_matches_while_loop():
    """dU/dx0 of the early-exit ``solve_stagewise`` (the plain loop, the
    one route of the reference's ``while_loop``) by ``torch.func.jacfwd``:
    ``jax.jacfwd`` within 1e-8 x max |J| (4e-14 apart when written)."""
    sqp, sqp_j = _stagewise(tt), _stagewise(ct)
    opts = tt.SolverOptions(max_iter=2000, early_exit=True)
    opts_j = ct.SolverOptions(max_iter=2000, early_exit=True)
    J = torch.func.jacfwd(lambda x0: solve_stagewise(
        dataclasses.replace(sqp, x0=x0), opts)[1][0])(_t(SMALL_X0))
    want = jax.jit(jax.jacfwd(lambda x0: jax_solve_stagewise(
        dataclasses.replace(sqp_j, x0=x0), opts_j)[1][0]))(
            jnp.asarray(SMALL_X0))
    assert torch.isfinite(J).all()
    _close_rel(J.numpy(), want, JAC_REL)


@pytest.mark.parametrize("accurate", [False, True])
def test_plan_step_jacobian_matches_reference(accurate):
    """dU/dx0 of a batched ``make_plan_step(use_fused=False)`` tick over 4
    lanes by ``torch.func.jacfwd``, on a bound that binds some
    coordinates: ``jax.jacfwd`` of the reference's ``use_fused=False``
    step within 1e-8 x max |J|."""
    x0s = SMALL_X0[None] + np.random.default_rng(0).normal(
        scale=[0.01, 0.05], size=(4, 2))
    u_upper = np.array([99.0])
    opts = dict(max_iter=30, early_exit=False, polish=False, rho=1.0,
                kkt_refine=0)

    def build(pkg):
        w = jnp.asarray(WX[1]) if pkg is ct else _t(WX[1])
        system, costs, cons = _problem(pkg, w, SMALL_X0, u_upper)
        build_plan = (jax.jit(ct.make_control_plan) if pkg is ct
                      else tt.make_control_plan)
        plan = build_plan(system, costs, cons)
        step = pkg.make_plan_step(plan, pkg.SolverOptions(**opts),
                                  batched=True, use_fused=False,
                                  accurate=accurate)
        return plan, step

    plan, step = build(tt)
    J = torch.func.jacfwd(lambda x: step(plan, x, None)[0])(_t(x0s))
    jplan, jstep = build(ct)
    want = jax.jit(jax.jacfwd(lambda x: jstep(jplan, x, None)[0]))(
        jnp.asarray(x0s))
    assert tuple(J.shape) == (4, SMALL_N, 4, 2)
    assert (J.numpy() == 0.0).any()          # snapped coordinates
    _close_rel(J.numpy(), want, JAC_REL)


def test_lqr_solve_assoc_jacobian_matches_reference():
    """d(X, U)/d(x0, qx) of the log-depth LQ solve by
    ``torch.func.jacfwd``: ``jax.jacfwd`` within 1e-8 x max |J|."""
    sqp, sqp_j = _stagewise(tt), _stagewise(ct)

    def port(x0, qx):
        return tt.lqr_solve_assoc(sqp.A, sqp.B, sqp.d, sqp.Qx, qx, sqp.Ru,
                                  sqp.ru, x0)

    def ref(x0, qx):
        return jax_lqr_solve_assoc(sqp_j.A, sqp_j.B, sqp_j.d, sqp_j.Qx, qx,
                                   sqp_j.Ru, sqp_j.ru, x0)

    got = torch.func.jacfwd(port, argnums=(0, 1))(sqp.x0, sqp.qx)
    want = jax.jit(jax.jacfwd(ref, argnums=(0, 1)))(sqp_j.x0, sqp_j.qx)
    for g_out, w_out in zip(got, want):
        for g, w in zip(g_out, w_out):
            _close_rel(g.numpy(), w, JAC_REL)


def test_condense_jacobian_matches_reference():
    """d(Phi, Psi, xi)/dA of the LTV condensing by ``torch.func.jacfwd``:
    ``jax.jacfwd`` within 1e-8 x max |J|."""
    rng = np.random.default_rng(1)
    As = A[None] + 0.01 * rng.normal(size=(SMALL_N, 2, 2))
    Bs = np.repeat(B[None], SMALL_N, 0)
    ds = np.repeat(D[None], SMALL_N, 0)

    def port(a):
        p = tt.condense(tt.LTVSystem.create(a, _t(Bs), _t(ds),
                                            _t(SMALL_X0)))
        return p.Phi, p.Psi, p.xi

    def ref(a):
        p = ct.condense(ct.LTVSystem.create(a, Bs, ds, SMALL_X0))
        return p.Phi, p.Psi, p.xi

    got = torch.func.jacfwd(port)(_t(As))
    want = jax.jit(jax.jacfwd(ref))(jnp.asarray(As))
    for g, w in zip(got, want):
        _close_rel(g.numpy(), w, JAC_REL)


# ---------------------------------------------------------------------------
# The guard: kernel launches, captured chains and host round trips refuse
# ---------------------------------------------------------------------------


def _f32(*shape, seed=0):
    """Deterministic float32 data in [0.5, 1.5) (no random operation: the
    launches are also called inside ``torch.func`` transforms)."""
    n = int(np.prod(shape))
    return (0.5 + (0.37 * torch.arange(n, dtype=torch.float32) + 0.1 * seed)
            % 1.0).reshape(shape)


def _box_lanes(t):
    Kinv, K = _f32(2, 3, 3), _f32(2, 3, 3, seed=1)
    v = _f32(2, 3, seed=2)
    return admm_kernel._launch(Kinv, K, t, v, v, v, v, v, n_iter=2,
                               sigma=1e-6, alpha=1.6, rho=0.1, refine=0,
                               assume_x0_zero=False)[0]


def _box_shared(t):
    Kinv, K = _f32(3, 3), _f32(3, 3, seed=1)
    v = _f32(2, 3, seed=2)
    return admm_kernel._launch_box_shared(Kinv, K, t, v, v, v, v, v,
                                          n_iter=2, sigma=1e-6, alpha=1.6,
                                          rho=0.1, refine=0)[0]


def _general_shared(t):
    Kinv, K, C = _f32(3, 3), _f32(3, 3, seed=1), _f32(4, 3, seed=2)
    rows = _f32(2, 4, seed=3)
    return admm_kernel._launch_general_shared(
        Kinv, K, C, _f32(4, seed=4), rows, rows, t, rows, rows, n_iter=2,
        sigma=1e-6, alpha=1.6, refine=0)[0]


def _general(t):
    Kinv, C = _f32(2, 3, 3), _f32(2, 4, 3, seed=1)
    rows = _f32(2, 4, seed=2)
    return admm_kernel._launch_general(Kinv, C, t, rows, rows, rows, t, rows,
                                       rows, n_iter=2, sigma=1e-6,
                                       alpha=1.6)[0]


def _chol(t):
    return cholesky_kernel._launch_chol(t.reshape(2, 3, 3).contiguous())


def _stagewise_tick(t):
    N, x, u, r, nb = 3, 2, 1, 0, 3
    lo = stagewise_kernel._Layout(x, u, r)
    plan = torch.zeros((N + 1, lo.C, nb))
    warm = torch.zeros((N + 1, lo.W, nb))
    return stagewise_kernel._launch(plan, t.reshape(x, nb), warm, n_iter=1,
                                    N=N, x=x, u=u, r=r, sigma=1e-6,
                                    alpha=1.6)[0]


def _chain(t):
    chain = CapturedChain(lambda v: 2.0 * v, (t,), "a test chain",
                          "the eager call")
    return chain.outputs


# each launch: (call on the differentiated input, its shape, what the
# refusal must name)
LAUNCHES = {
    "admm_box": (_box_lanes, (2, 3), "use_fused=False"),
    "admm_box_shared": (_box_shared, (2, 3), "use_fused=False"),
    "admm_general_shared": (_general_shared, (2, 3), "use_fused=False"),
    "admm_general": (_general, (2, 3), "solve_qp_batched"),
    "chol_batched": (_chol, (18,), "torch.linalg.cholesky"),
    "stagewise_tick": (_stagewise_tick, (6,), "backend='xla'"),
    "captured_chain": (_chain, (2, 3), "the eager call"),
}


def _ask(way, fn, t):
    """Call ``fn`` on ``t`` with a gradient asked in the way ``way``."""
    first = lambda v: fn(v)
    if way == "requires_grad":
        return fn(t.clone().requires_grad_())
    if way == "forward_ad":
        with fwAD.dual_level():
            return fn(fwAD.make_dual(t, torch.ones_like(t)))
    if way == "jvp":
        return torch.func.jvp(first, (t,), (torch.ones_like(t),))
    if way == "vjp":
        return torch.func.vjp(first, t)
    if way == "grad":
        return torch.func.grad(lambda v: fn(v).sum())(t)
    return getattr(torch.func, way)(first)(t)


@pytest.mark.parametrize("way", ["requires_grad", "grad", "jacrev", "vjp",
                                 "jacfwd", "jvp", "forward_ad"])
@pytest.mark.parametrize("launch", sorted(LAUNCHES))
def test_kernel_launch_refuses_a_gradient(launch, way):
    fn, shape, route = LAUNCHES[launch]
    with pytest.raises(RuntimeError, match="has no derivative") as e:
        _ask(way, fn, _f32(*shape, seed=9))
    assert route in str(e.value)


@pytest.mark.parametrize("mode", ["no_grad", "detached"])
@pytest.mark.parametrize("launch", sorted(LAUNCHES))
def test_kernel_launch_without_gradient_goes_on(launch, mode):
    """No gradient asked: the guard lets the call through, and the CPU
    call fails later, where it needs the card (the build, a CUDA
    device)."""
    fn, shape, _ = LAUNCHES[launch]
    t = _f32(*shape, seed=9).requires_grad_()
    with pytest.raises(Exception) as e:
        if mode == "no_grad":
            with torch.no_grad():
                fn(t)
        else:
            fn(t.detach())
    assert "has no derivative" not in str(e.value)


def _golden(x0):
    system, costs, cons = _problem(tt, _t(WX[1]), x0)
    qp = tt.build_qp(tt.condense(system), system.x0, costs, cons)
    return system, costs, cons, qp


@pytest.mark.parametrize("way", ["requires_grad", "forward_ad"])
def test_native_engine_refuses_a_gradient(way):
    """``solve_qp_native`` and every ``solve`` route to it raise naming
    the plain engine; the same calls under ``no_grad`` solve."""
    x0 = _t(SMALL_X0)
    ctx = fwAD.dual_level() if way == "forward_ad" else torch.enable_grad()
    with ctx:
        x0 = (fwAD.make_dual(x0, torch.ones_like(x0)) if way == "forward_ad"
              else x0.requires_grad_())
        system, costs, cons, qp = _golden(x0)
        with pytest.raises(RuntimeError, match="engine='condensed'"):
            tt.solve_qp_native(qp)
        with pytest.raises(RuntimeError, match="engine='condensed'"):
            tt.solve(system, costs, cons, engine="native")
    with torch.no_grad():
        system, costs, cons, qp = _golden(_t(SMALL_X0).requires_grad_())
        u = tt.solve(system, costs, cons, engine="native").control
        np.testing.assert_allclose(u.numpy(),
                                   tt.solve_qp_native(qp).x.numpy(),
                                   rtol=0, atol=1e-12)


def test_seed_map_refuses_a_gradient_in_the_plan():
    """The seed map is built in numpy: a plan that asks a gradient raises
    naming the condensed solve; detached, it builds."""
    w = _t(WX[1]).requires_grad_()
    plan = tt.make_control_plan(*_problem(tt, w, SMALL_X0))
    with pytest.raises(RuntimeError, match="solve_mpc"):
        tt.make_seed_map(plan)
    with pytest.raises(RuntimeError, match="make_seed_map"):
        tt.make_plan_step(plan, batched=True, use_fused=False)
    with torch.no_grad():
        assert torch.isfinite(tt.make_seed_map(plan).Umap).all()
