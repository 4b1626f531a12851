"""The reference's model-swap suite (``tests/test_model_swap.py``) on the
PyTorch port, against the JAX reference on the CPU.

A model swap (a footstep replan, a gait switch) costs one plan rebuild:
the facade is rebuilt (or replanned) with the same options and the warm
tuple carried through, and the first post-swap tick still converges.  The
ZMP fleet is the reference's at a horizon of 12 (the reference runs 50,
20 and 30) with budgets cut to what these shapes need on both sides (the
port's plain loop takes ~25 ms an iteration here); every case runs the
same float32 numpy data through both packages, asserts the reference's
own assertions on the port, and holds the port's controls against the
reference's within 2e-4 x max(1, max |U|).

Cases the reference runs on its fused backend (``backend="fused"``, a
Pallas kernel in interpret mode) run the port's ``backend="fused"`` on CPU
tensors, which is the kernel's plain version, against the reference's
``backend="xla"``.  The reference's no-re-trace contract
(``test_replan_reuses_compiled_tick_no_retrace``) has no trace to count in
the port: its analog here is that ``StagewiseTick.replan`` at equal shapes
keeps the facade's plans and problem tensors (the same objects and
buffers, refilled in place) and ticks as a fresh facade of the new
problem does.  On the card, a captured chain (``_graph.CapturedChain``)
takes replanned data with no new capture and a changed shape raises
``DimensionError``: ``chip_smoke.py`` phase 34.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.autospan import span_matrix
from copra_tpu.qp.native import solve_qp_native as jax_native
from copra_tpu.qp.riccati import from_mpc as jax_from_mpc
from copra_tpu.qp.riccati import make_stagewise_step as jax_make_step
from copra_tpu_torch.qp import riccati as tr
from _one_thread import one_torch_thread  # noqa: F401

tt.set_default_device("cpu")

N_ZMP, LANES = 12, 2
SERVE_RTOL = 2e-4


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def _zmp_data(ref_shift=0.0, N=N_ZMP, T=0.02, h=0.8):
    """The reference's ``_zmp_fleet`` data as float32 numpy."""
    A = np.array([[1.0, T, T * T / 2], [0.0, 1.0, T], [0.0, 0.0, 1.0]])
    B = np.array([[T ** 3 / 6], [T * T / 2], [T]])
    Z = np.asarray(span_matrix(np.array([[1.0, 0.0, -h / 9.81]]), N + 1))
    per = max(N // 3, 1)
    ref = np.array([0.15 * min(k // per, 2) + ref_shift
                    for k in range(N + 1)])
    return {k: np.asarray(v, np.float32) for k, v in dict(
        A=A, B=B, Z=Z, ref=ref).items()}, N


def _zmp_fleet(pkg, ref_shift=0.0, N=N_ZMP):
    """``(batched StagewiseQP, (system, costs, constraints))`` of one
    package from :func:`_zmp_data`."""
    f, N = _zmp_data(ref_shift, N)
    arr = jnp.asarray if pkg is ct else torch.tensor
    system = pkg.LTISystem.create(f["A"], f["B"], np.zeros(3, np.float32),
                                  np.zeros(3, np.float32), N)
    ones, ref, Z = (np.ones(N + 1, np.float32), f["ref"], f["Z"])
    costs = (pkg.TrajectoryCost(M=arr(Z), p=arr(ref), weights=arr(ones)),
             pkg.SimpleControlCost(p=arr(np.zeros(N, np.float32)),
                                   weights=arr(np.full(N, 1e-6,
                                                       np.float32))))
    cons = (pkg.TrajectoryConstraint(E=arr(Z), f=arr(ref + 0.06)),
            pkg.TrajectoryConstraint(E=arr(-Z), f=arr(-(ref - 0.06))))
    if pkg is ct:
        sqp = jax_from_mpc(system, costs, cons)
        sqp_b = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (LANES,) + a.shape), sqp)
    else:
        sqp_b = tr.stack_stagewise([tr.from_mpc(system, costs, cons)],
                                   repeats=LANES)
    return sqp_b, (system, costs, cons)


def _make(pkg, sqp, opts, **kw):
    if pkg is ct:
        return jax_make_step(sqp, opts, backend="xla", **kw)
    return tr.make_stagewise_step(sqp, opts, **kw)


def _zeros(pkg):
    return (jnp.zeros((LANES, 3), jnp.float32) if pkg is ct
            else torch.zeros(LANES, 3))


def _served(got, want):
    scale = max(1.0, float(np.abs(_np(want)).max()))
    assert float(np.abs(_np(got) - _np(want)).max()) <= SERVE_RTOL * scale


def _oracle_err(system, costs, cons, x_used, U):
    """The reference test's gate: lane 0's controls against the native
    oracle of the new model at the carried state, relative."""
    sysd = dataclasses.replace(system, x0=jnp.asarray(x_used[0],
                                                      jnp.float32))
    plan = ct.make_control_plan(sysd, costs, cons)
    exact = jax_native(ct.plan_qp(plan, x_used[0]))
    assert int(exact.status) == ct.STATUS_SOLVED
    scale = max(1.0, np.abs(np.asarray(exact.x)).max())
    return np.abs(_np(U).astype(np.float64)[0].ravel()
                  - np.asarray(exact.x)).max() / scale


def test_stagewise_warm_survives_footstep_replan():
    """Swap the footstep plan after two ticks; the first post-swap tick
    carries the old warm tuple, converges and matches the new model's
    exact oracle within 1e-5."""
    out = {}
    for pkg in (ct, tt):
        opts = pkg.SolverOptions(max_iter=60, eps_abs=1e-9, eps_rel=0.0,
                                 early_exit=False, rho=1.0)
        tick_a = _make(pkg, _zmp_fleet(pkg, 0.0)[0], opts)
        X, U, info, warm = tick_a(_zeros(pkg))
        X, U, info, warm = tick_a(X[:, 1], warm)
        assert (_np(info.status) == pkg.STATUS_SOLVED).all()
        sqp_b, (system_b, costs_b, cons_b) = _zmp_fleet(pkg, 0.02)
        x_swap = X[:, 1]
        _, Ub, info_b, _ = _make(pkg, sqp_b, opts)(x_swap, warm)
        assert (_np(info_b.status) == pkg.STATUS_SOLVED).all()
        out[pkg] = (_np(x_swap).astype(np.float64), Ub)
    x_used, Ub = out[tt]
    np.testing.assert_allclose(x_used, out[ct][0], rtol=0, atol=1e-6)
    _served(Ub, out[ct][1])
    _, (system_b, costs_b, cons_b) = _zmp_fleet(ct, 0.02)
    assert _oracle_err(system_b, costs_b, cons_b, x_used, Ub) <= 1e-5


def test_stagewise_swap_matches_cold_rebuild():
    """The warm-carried post-swap solution equals a cold solve of the new
    model within 3e-5 of the controls' scale."""
    out = {}
    for pkg in (ct, tt):
        opts = pkg.SolverOptions(max_iter=60, eps_abs=1e-9, eps_rel=0.0,
                                 early_exit=False, rho=1.0)
        X, U, info, warm = _make(pkg, _zmp_fleet(pkg, 0.0)[0],
                                 opts)(_zeros(pkg))
        tick_b = _make(pkg, _zmp_fleet(pkg, 0.03)[0], opts)
        _, U_warm, _, _ = tick_b(X[:, 1], warm)
        _, U_cold, _, _ = tick_b(X[:, 1])
        scale = max(1.0, float(np.abs(_np(U_cold)).max()))
        diff = np.abs(_np(U_warm).astype(np.float64)
                      - _np(U_cold).astype(np.float64)).max() / scale
        assert diff <= 3e-5, f"warm-carried vs cold rebuild: {diff:.2e}"
        out[pkg] = (U_warm, U_cold)
    for got, want in zip(out[tt], out[ct]):
        _served(got, want)


def _buffers(tick):
    """The facade's problem and plans: ``{path: data_ptr}`` of every tensor
    and ``{path: id}`` of every dataclass holding them."""
    out = {}

    def walk(obj, path):
        if isinstance(obj, torch.Tensor):
            out[path] = obj.data_ptr()
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            out[path] = id(obj)
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name), f"{path}.{f.name}")
        elif isinstance(obj, (tuple, list)):
            for k, item in enumerate(obj):
                walk(item, f"{path}[{k}]")

    walk(tick._sqp, "sqp")
    for key, plan in tick._plans.items():
        walk(plan, f"plan{key}")
    return out


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_replan_keeps_the_facade_and_its_buffers(backend):
    """The port's analog of the no-re-trace contract: after the cold, warm
    and swap-budget ticks have each run once, two more same-shape replans
    keep every problem and plan tensor (same holder objects, same
    buffers), and the tick after each equals the reference's and a fresh
    port facade's of the new problem, bit for bit."""
    opts = tt.SolverOptions(max_iter=20, eps_abs=1e-9, eps_rel=0.0,
                            early_exit=False, rho=1.0)
    copts = opts.replace(max_iter=40)
    tick = tr.make_stagewise_step(_zmp_fleet(tt, 0.0)[0], opts,
                                  cold_options=copts, backend=backend)
    jtick = jax_make_step(_zmp_fleet(ct, 0.0)[0], opts, cold_options=copts,
                          backend="xla")
    X, U, info, warm = tick(_zeros(tt))
    jX, jU, jinfo, jwarm = jtick(_zeros(ct))
    X, U, info, warm = tick(X[:, 1], warm)
    jX, jU, jinfo, jwarm = jtick(jX[:, 1], jwarm)
    tick.replan(_zmp_fleet(tt, 0.01)[0])
    jtick.replan(_zmp_fleet(ct, 0.01)[0])
    X, U, info, warm = tick(X[:, 1], warm)
    jX, jU, jinfo, jwarm = jtick(jX[:, 1], jwarm)
    before = _buffers(tick)
    for shift in (0.02, 0.005):
        new = _zmp_fleet(tt, shift)[0]
        # a fresh facade serving at the swap budget, which the replanned
        # facade's first tick runs
        fresh = tr.make_stagewise_step(new, copts, cold_options=copts,
                                       backend=backend)
        tick.replan(new)
        jtick.replan(_zmp_fleet(ct, shift)[0])
        assert _buffers(tick) == before
        want = fresh(X[:, 1], warm)
        X, U, info, warm = tick(X[:, 1], warm)
        jX, jU, jinfo, jwarm = jtick(jX[:, 1], jwarm)
        for g, w in zip((X, U, info.status), want[:2] + (want[2].status,)):
            assert torch.equal(g, w)
        _served(U, jU)
        np.testing.assert_array_equal(_np(info.status), _np(jinfo.status))


def test_replan_swap_budget_converges_fused():
    """The fused facade: the first post-replan tick runs the swap budget
    (``cold_options``) with the carried warm tuple, so the fleet converges;
    the swap moves the solution."""
    out = {}
    for pkg in (ct, tt):
        opts = pkg.SolverOptions(max_iter=30, eps_abs=1e-6, eps_rel=0.0,
                                 early_exit=False, rho=1.0)
        kw = dict(cold_options=opts.replace(max_iter=100))
        if pkg is tt:
            kw["backend"] = "fused"
        tick = _make(pkg, _zmp_fleet(pkg, 0.0, N=8)[0], opts, **kw)
        if pkg is tt:
            assert tick.backend == "fused"
        X, U, info, warm = tick(_zeros(pkg))
        assert (_np(info.status) == pkg.STATUS_SOLVED).all()
        X, U, info, warm = tick(X[:, 1], warm)
        tick.replan(_zmp_fleet(pkg, 0.005, N=8)[0])
        X, U, info, warm = tick(X[:, 1], warm)
        assert (_np(info.status) == pkg.STATUS_SOLVED).all()
        tick.replan(_zmp_fleet(pkg, 0.02, N=8)[0])
        _, Ub, info_b, _ = tick(X[:, 1], warm)
        assert (_np(info_b.status) == pkg.STATUS_SOLVED).all()
        assert np.abs(_np(Ub) - _np(U)).max() > 1e-4
        out[pkg] = (U, Ub)
    for got, want in zip(out[tt], out[ct]):
        _served(got, want)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_replan_shape_mismatch_raises(backend):
    opts = tt.SolverOptions(max_iter=50, early_exit=False, rho=1.0)
    tick = tr.make_stagewise_step(_zmp_fleet(tt, 0.0, N=8)[0], opts,
                                  backend=backend)
    jtick = jax_make_step(_zmp_fleet(ct, 0.0, N=8)[0], opts, backend="xla")
    with pytest.raises(ct.DimensionError):
        jtick.replan(_zmp_fleet(ct, 0.0, N=12)[0])
    with pytest.raises(tt.DimensionError, match="replan"):
        tick.replan(_zmp_fleet(tt, 0.0, N=12)[0])


def test_plan_step_swap_on_condensed_path():
    """Rebuild the control plan after a target swap and keep ticking: each
    fresh plan's step matches the exact oracle at the carried state, and
    the two models differ."""
    N = 8
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.005], [0.1]])
    pos = np.asarray(span_matrix(np.array([[1.0, 0.0]]), N + 1))
    x0 = np.array([1.0, 0.0])
    out = {}
    for pkg, native in ((ct, jax_native), (tt, tt.solve_qp_native)):
        arr = jnp.asarray if pkg is ct else torch.tensor

        def build(target):
            system = pkg.LTISystem.create(A, B, np.zeros(2), x0, N)
            costs = (pkg.TrajectoryCost(M=arr(pos),
                                        p=arr(np.full(N + 1, target)),
                                        weights=arr(np.full(N + 1, 10.0))),
                     pkg.SimpleControlCost(p=arr(np.zeros(N)),
                                           weights=arr(np.full(N, 1e-2))))
            cons = (pkg.ControlBoundConstraint.create([-3.0], [3.0]),)
            return pkg.make_control_plan(system, costs, cons)

        opts = pkg.SolverOptions(max_iter=20000, eps_abs=1e-9, eps_rel=0.0)
        U, sol, _ = pkg.make_plan_step(build(0.0), opts)(x0, None)
        assert int(_np(sol.status)) == pkg.STATUS_SOLVED
        plan2 = build(0.5)
        U2, sol2, _ = pkg.make_plan_step(plan2, opts)(x0, None)
        assert int(_np(sol2.status)) == pkg.STATUS_SOLVED
        exact = _np(native(pkg.plan_qp(plan2, x0)).x)
        scale = max(1.0, np.abs(exact).max())
        assert np.abs(_np(U2) - exact).max() / scale <= 1e-5
        assert np.abs(_np(U2) - _np(U)).max() > 1e-3
        out[pkg] = (U, U2)
    for got, want in zip(out[tt], out[ct]):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-8)
