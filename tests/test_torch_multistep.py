"""The port's multistep serving chains and the device-side top-up, on the
CPU against the port's per-tick loops and the JAX reference.

``make_plan_multistep`` and ``make_stagewise_multistep`` run their ticks
eagerly on CPU tensors; on a CUDA device the same ticks are one CUDA graph
(``tests/test_torch_multistep_cuda.py``).  A chain must equal the
per-tick loop tick for tick (1e-12: the same operations in the same
order) and the reference's chain (1e-9 in f64; 1e-5 for the f32 accurate
plan tick, its f32 correction floor, as in ``tests/test_torch_plan.py``).
The JAX chains run ``backend="xla"`` / ``use_fused=False``: no Pallas
interpreter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.plan import make_plan_multistep as jax_plan_multistep
from copra_tpu.qp import riccati as jr
from copra_tpu_torch.ops import stagewise_kernel as sk
from copra_tpu_torch.qp import riccati as tr
from fixtures import (A, B, D, M, N_MAT, SMALL_N, SMALL_X0, UD, U_LOWER,
                      U_UPPER, WU, WX, XD)
from test_torch_plan import OPTS, _fleet, _jax_plan, _port_plan
from test_torch_stagewise import _fields, _jax, _port

tt.set_default_device("cpu")

SAME = dict(rtol=0, atol=1e-12)
SOLVE = dict(rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# the top-up decided on the device
# ---------------------------------------------------------------------------


def test_plain_tick_skip_flag_returns_the_state_it_was_given():
    """``skip`` set: ``(warm, work)`` back bit for bit; clear: the tick as
    without the flag, bit for bit."""
    f = _fields(70, N=5, lanes=2, rows=True)
    opts = ct.SolverOptions(max_iter=4, early_exit=False)
    fp = sk.build_fused_plan(_port(f), opts)
    lo = sk._Layout(3, 2, 2)
    rng = np.random.default_rng(71)
    warm = torch.tensor(rng.normal(size=(6, lo.W, 2)))
    work = torch.tensor(rng.normal(size=(6, lo.Kw, 2)))
    x0 = torch.tensor(f["x0"]).mT.contiguous()
    kw = dict(n_iter=3, N=5, x=3, u=2, r=2, sigma=1e-6, alpha=1.6)
    one = torch.ones((), dtype=torch.int32)
    for entry in (sk.stagewise_tick_plain, sk.fused_stagewise_tick,
                  sk.fused_stagewise_tick_streamed):
        got = entry(fp.plan, x0, warm, work=work, skip=one, **kw)
        assert torch.equal(got[0], warm) and torch.equal(got[1], work)
        ran = entry(fp.plan, x0, warm, work=work, skip=0 * one, **kw)
        want = entry(fp.plan, x0, warm, **kw)
        assert all(torch.equal(g, w) for g, w in zip(ran, want))
    with pytest.raises(ValueError, match="work"):
        sk.stagewise_tick_plain(fp.plan, x0, warm, skip=one, **kw)


@pytest.mark.parametrize("fires", [False, True], ids=["skipped", "fires"])
def test_device_topup_matches_host_check_topup(fires):
    """The fused path's top-up (flag on the device, in place) against the
    plain path's host-checked one, cold and warm, 1e-9 and statuses equal.
    A starved fixed count fires it; an ample one skips it, and then the
    delivered values are those of the same solve without a top-up, bit for
    bit."""
    f = _fields(60, N=10, lanes=3, rows=True)
    base = ct.SolverOptions(max_iter=6 if fires else 100,
                            eps_abs=1e-6 if fires else 1e-4, eps_rel=0.0,
                            early_exit=False, rho=0.1)
    opts = base.replace(topup_iters=200)
    fused = tr.make_stagewise_step(_port(f), opts, backend="fused",
                                   cold_options=opts)
    plain = tr.make_stagewise_step(_port(f), opts, backend="xla",
                                   cold_options=opts)
    bare = tr.make_stagewise_step(_port(f), base, backend="fused",
                                  cold_options=base)
    wf = wp = wb = None
    for x0 in (f["x0"], f["x0"] + 0.1):
        of = fused(torch.tensor(x0), wf)
        op = plain(torch.tensor(x0), wp)
        ob = bare(torch.tensor(x0), wb)
        np.testing.assert_allclose(of[1].numpy(), op[1].numpy(), **SOLVE)
        np.testing.assert_array_equal(of[2].status.numpy(),
                                      op[2].status.numpy())
        solved = int((ob[2].status == tt.STATUS_SOLVED).sum())
        if fires:
            assert solved < 3, "the fixed count alone should miss"
            assert (of[2].status == tt.STATUS_SOLVED).sum() > solved
        else:
            assert solved == 3
            for g, w in zip(of[3] + of[:2], ob[3] + ob[:2]):
                assert torch.equal(g, w)
        wf, wp, wb = of[3], op[3], ob[3]


# ---------------------------------------------------------------------------
# make_plan_multistep
# ---------------------------------------------------------------------------


def _plan_chain_and_loop(plan, opts, x0s, x0_seq, rounds, warm=None):
    step_many = tt.make_plan_multistep(plan, opts, seed_center=x0s,
                                       accurate_rounds=rounds)
    chain = step_many(torch.tensor(x0_seq), warm)
    step = tt.make_plan_step(plan, opts, batched=True, seed_center=x0s,
                             accurate=True, accurate_rounds=rounds)
    w, loop = warm, []
    for t in range(x0_seq.shape[0]):
        u, sol, w = step(plan, torch.tensor(x0_seq[t]), w)
        loop.append((u, sol))
    return chain, loop, w


def test_plan_multistep_matches_per_tick_loop_and_reference():
    """Per-lane plans (the config-4 fleet, N = 20): T = 3 chained ticks
    equal the port's per-tick accurate loop (1e-12, statuses and warm
    duals) and the reference's chain (1e-5), from ``warm=None``; a second
    call from the chain's own warm state equals the loop."""
    _, x0s, x0_seq = _fleet()
    jplan, tplan = _jax_plan(78.0), _port_plan(78.0)
    opts = tt.SolverOptions(**OPTS).replace(rho=tt.suggest_rho(tplan))
    (us, statuses, rds, warm), loop, wl = _plan_chain_and_loop(
        tplan, opts, x0s, x0_seq, 2)
    assert tuple(us.shape) == x0_seq.shape[:2] + (20,)
    assert tuple(statuses.shape) == tuple(rds.shape) == x0_seq.shape[:2]
    for t, (u, sol) in enumerate(loop):
        np.testing.assert_allclose(us[t].numpy(), u.numpy(), **SAME)
        np.testing.assert_array_equal(statuses[t].numpy(),
                                      sol.status.numpy())
        np.testing.assert_allclose(rds[t].numpy(),
                                   sol.dual_residual.numpy(), **SAME)
    np.testing.assert_allclose(warm.y.numpy(), wl.y.numpy(), **SAME)
    jmany = jax_plan_multistep(jplan, ct.SolverOptions(**OPTS).replace(
        rho=opts.rho), seed_center=x0s, accurate_rounds=2, use_fused=False)
    jus, jst, _, _ = jmany(jnp.asarray(x0_seq))
    np.testing.assert_allclose(us.numpy(), np.asarray(jus), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(statuses.numpy(), np.asarray(jst))
    # a second call carries the first's warm state down the same drift
    x0_next = (x0_seq[-1] + (x0_seq - x0_seq[0])).astype(np.float32)
    (us2, _, _, _), loop2, _ = _plan_chain_and_loop(
        tplan, opts, x0s, x0_next, 2, warm)
    for t, (u, _) in enumerate(loop2):
        np.testing.assert_allclose(us2[t].numpy(), u.numpy(), **SAME)


def test_plan_multistep_on_a_shared_plan_matches_per_tick_loop():
    """A shared LTI plan (the accurate tick's shared-operator path): the
    chain equals the per-tick loop, 1e-12."""
    system = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    costs = (tt.TargetCost.create(M, XD, weights=WX),
             tt.ControlCost.create(N_MAT, UD, weights=WU))
    cons = (tt.ControlBoundConstraint.create(U_LOWER, U_UPPER),)
    plan = tt.make_control_plan(system, costs, cons)
    assert plan.Q.dim() == 2
    rng = np.random.default_rng(5)
    x0s = SMALL_X0[None] + rng.normal(scale=[0.02, 0.1], size=(4, 2))
    x0_seq = x0s[None] + rng.normal(scale=0.01, size=(3, 4, 2)).cumsum(0)
    opts = tt.SolverOptions(max_iter=40, early_exit=False)
    (us, statuses, _, _), loop, _ = _plan_chain_and_loop(
        plan, opts, x0s.mean(0), x0_seq, 1)
    for t, (u, sol) in enumerate(loop):
        np.testing.assert_allclose(us[t].numpy(), u.numpy(), **SAME)
        np.testing.assert_array_equal(statuses[t].numpy(),
                                      sol.status.numpy())


def test_plan_multistep_takes_only_the_accurate_path():
    plan = _port_plan(78.0)
    with pytest.raises(ValueError, match="ACCURATE"):
        tt.make_plan_multistep(plan, tt.SolverOptions(**OPTS),
                               accurate=False)
    step_many = tt.make_plan_multistep(plan, tt.SolverOptions(**OPTS))
    with pytest.raises(ValueError, match=r"\[T, B, x\]"):
        step_many(torch.zeros(8, 2))


# ---------------------------------------------------------------------------
# make_stagewise_multistep (the cases of tests/test_stagewise_multistep.py)
# ---------------------------------------------------------------------------


def _fleet_sqp(mod, batch=3):
    """The SmallSystem fixture as a stagewise fleet of ``batch`` lanes
    (the reference test's ``fleet``), in either package."""
    from copra_tpu_torch.convert import stagewise_from_numpy
    system = ct.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    costs = (ct.TargetCost.create(M, XD, weights=WX),
             ct.ControlCost.create(N_MAT, UD, weights=WU))
    cons = (ct.ControlBoundConstraint.create(U_LOWER, U_UPPER),)
    sqp = jr.from_mpc(system, costs, cons)
    rng = np.random.default_rng(0)
    x0s = SMALL_X0[None] + rng.normal(scale=[0.05, 0.1], size=(batch, 2))
    fields = {f.name: None if getattr(sqp, f.name) is None else
              np.broadcast_to(np.asarray(getattr(sqp, f.name)),
                              (batch,) + getattr(sqp, f.name).shape).copy()
              for f in dataclasses.fields(sqp)}
    fields["x0"] = x0s
    if mod is ct:
        return jr.StagewiseQP(**{k: None if v is None else jnp.asarray(v)
                                 for k, v in fields.items()}), x0s
    return stagewise_from_numpy(fields), x0s


def _stage0_plant(sqp):
    A0, B0, d0 = sqp.A[:, 0], sqp.B[:, 0], sqp.d[:, 0]
    return lambda xk, U: (torch.einsum("bxy,by->bx", A0, xk)
                          + torch.einsum("bxu,bu->bx", B0, U[:, 0]) + d0)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_stagewise_multistep_plant_mode_matches_loop_and_reference(backend):
    """Closed loop with the default stage-0 plant: the chain equals the
    per-tick loop through ``make_stagewise_step`` (1e-12), cold tick
    included (the rollout pairing), and the reference's chain (1e-9)."""
    sqp, x0s = _fleet_sqp(tt)
    opts = ct.SolverOptions(max_iter=40, rho=0.1)
    copts = opts.replace(max_iter=400)
    T = 4
    step_many = tt.make_stagewise_multistep(sqp, opts, cold_options=copts,
                                            backend=backend)
    assert step_many.backend == backend
    states, u0s, statuses, info, warm = step_many(torch.tensor(x0s), T)
    assert tuple(states.shape) == (T + 2, 3, 2)
    assert tuple(u0s.shape) == (T + 1, 3, 1)
    assert tuple(statuses.shape) == (T + 1, 3)
    tick = tr.make_stagewise_step(sqp, opts, cold_options=copts,
                                  backend=backend)
    plant = _stage0_plant(sqp)
    xk = torch.tensor(x0s)
    _, Ur, infor, wr = tick(xk)
    np.testing.assert_allclose(u0s[0].numpy(), Ur[:, 0].numpy(), **SAME)
    np.testing.assert_array_equal(statuses[0].numpy(), infor.status.numpy())
    for t in range(T):
        xk = plant(xk, Ur)
        np.testing.assert_allclose(states[t + 1].numpy(), xk.numpy(),
                                   **SAME)
        _, Ur, infor, wr = tick(xk, wr)
        np.testing.assert_allclose(u0s[t + 1].numpy(), Ur[:, 0].numpy(),
                                   **SAME)
        np.testing.assert_array_equal(statuses[t + 1].numpy(),
                                      infor.status.numpy())
    np.testing.assert_allclose(states[-1].numpy(), plant(xk, Ur).numpy(),
                               **SAME)
    np.testing.assert_allclose(info.x.numpy(), infor.x.numpy(), **SAME)
    for a, b in zip(warm, wr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SAME)
    jsqp, _ = _fleet_sqp(ct)
    want = jr.make_stagewise_multistep(jsqp, opts, cold_options=copts,
                                       backend="xla")(jnp.asarray(x0s), T)
    for g, w in zip((states, u0s), want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SOLVE)
    np.testing.assert_array_equal(statuses.numpy(), np.asarray(want[2]))


def test_stagewise_multistep_exogenous_stream_matches_loop_and_reference():
    """``x0_seq`` mode: tick k solves at ``x0_seq[k]``; a stream of the
    wrong length raises."""
    sqp, x0s = _fleet_sqp(tt)
    opts = ct.SolverOptions(max_iter=30, rho=0.1)
    T = 3
    rng = np.random.default_rng(1)
    x0_seq = x0s[None] + rng.normal(scale=0.01, size=(T, 3, 2)).cumsum(0)
    step_many = tt.make_stagewise_multistep(sqp, opts, backend="fused")
    states, u0s, statuses, info, _ = step_many(None, T,
                                               x0_seq=torch.tensor(x0_seq))
    assert tuple(states.shape) == (T + 1, 3, 2)
    assert tuple(u0s.shape) == (T, 3, 1)
    tick = tr.make_stagewise_step(sqp, opts, backend="fused")
    _, _, _, wr = tick(torch.tensor(x0_seq[0]))
    for t in range(T):
        _, Ur, infor, wr = tick(torch.tensor(x0_seq[t]), wr)
        np.testing.assert_allclose(u0s[t].numpy(), Ur[:, 0].numpy(), **SAME)
    np.testing.assert_allclose(info.x.numpy(), infor.x.numpy(), **SAME)
    jsqp, _ = _fleet_sqp(ct)
    want = jr.make_stagewise_multistep(jsqp, opts, backend="xla")(
        jnp.asarray(x0s), T, x0_seq=jnp.asarray(x0_seq))
    np.testing.assert_allclose(u0s.numpy(), np.asarray(want[1]), **SOLVE)
    with pytest.raises(ValueError, match="x0_seq"):
        step_many(None, T + 1, x0_seq=torch.tensor(x0_seq))


def test_stagewise_multistep_unbatched_facade():
    """An unbatched problem: unbatched outputs, the cold tick included in
    plant mode, plain ``[T]`` shapes on a warm continuation."""
    sqp, _ = _fleet_sqp(tt, batch=1)
    sqp = tr.StagewiseQP(**{f.name: None if getattr(sqp, f.name) is None
                            else getattr(sqp, f.name)[0]
                            for f in dataclasses.fields(sqp)})
    step_many = tt.make_stagewise_multistep(
        sqp, ct.SolverOptions(max_iter=30, rho=0.1), backend="xla")
    T = 3
    states, u0s, statuses, info, warm = step_many(sqp.x0, T)
    assert tuple(states.shape) == (T + 2, 2)
    assert tuple(u0s.shape) == (T + 1, 1)
    assert tuple(statuses.shape) == (T + 1,)
    assert tuple(info.x.shape) == (SMALL_N,)
    states2, u0s2, _, _, _ = step_many(states[-1], T, warm=warm)
    assert tuple(states2.shape) == (T + 1, 2)
    assert tuple(u0s2.shape) == (T, 1)


def test_stagewise_multistep_fused_plus_parallel_scan_is_an_error():
    sqp, _ = _fleet_sqp(tt, batch=2)
    with pytest.raises(ValueError, match="contradictory"):
        tt.make_stagewise_multistep(sqp, ct.SolverOptions(max_iter=5),
                                    backend="fused", parallel_scan=True)


def test_stagewise_multistep_parallel_scan_matches_reference():
    """``backend='xla', parallel_scan=True`` against the reference's, and a
    custom plant (a damped stage-0 model) in place of the default."""
    sqp, x0s = _fleet_sqp(tt, batch=2)
    jsqp, _ = _fleet_sqp(ct, batch=2)
    opts = ct.SolverOptions(max_iter=30, rho=0.1)
    tplant = lambda xk, U: 0.99 * _stage0_plant(sqp)(xk, U)
    A0, B0, d0 = jsqp.A[:, 0], jsqp.B[:, 0], jsqp.d[:, 0]
    jplant = lambda xk, U: 0.99 * (jnp.einsum("bxy,by->bx", A0, xk)
                                   + jnp.einsum("bxu,bu->bx", B0, U[:, 0])
                                   + d0)
    got = tt.make_stagewise_multistep(sqp, opts, backend="xla",
                                      parallel_scan=True, plant=tplant)(
        torch.tensor(x0s), 2)
    want = jr.make_stagewise_multistep(jsqp, opts, backend="xla",
                                       parallel_scan=True, plant=jplant)(
        jnp.asarray(x0s), 2)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SOLVE)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_stagewise_multistep_replan_swaps_model(backend):
    """``replan``: post-swap chain ticks solve the new model (equal to a
    fresh facade on it from the same warm state, 1e-12); a new shape
    raises."""
    sqp, _ = _fleet_sqp(tt)
    opts = ct.SolverOptions(max_iter=40, early_exit=False, rho=1.0)
    copts = opts.replace(max_iter=2000)
    step_many = tt.make_stagewise_multistep(sqp, opts, cold_options=copts,
                                            backend=backend)
    x0 = torch.zeros((3, sqp.xdim), dtype=sqp.A.dtype)
    states, u0s, statuses, _, warm = step_many(x0, 2)
    assert (statuses == tt.STATUS_SOLVED).all()
    sqp2 = dataclasses.replace(sqp, qx=sqp.qx + 0.5)
    step_many.replan(sqp2)
    states2, u0s2, statuses2, _, _ = step_many(states[-1], 2, warm=warm)
    assert (statuses2 == tt.STATUS_SOLVED).all()
    assert (u0s2[-1] - u0s[-1]).abs().max() > 1e-4
    fresh = tt.make_stagewise_multistep(sqp2, opts, cold_options=copts,
                                        backend=backend)
    want = fresh(states[-1], 2, warm=warm)
    np.testing.assert_allclose(u0s2.numpy(), want[1].numpy(), **SAME)
    np.testing.assert_allclose(states2.numpy(), want[0].numpy(), **SAME)
    bad = tr.stack_stagewise([sqp, sqp])
    with pytest.raises(tt.DimensionError, match="replan"):
        step_many.replan(bad)
