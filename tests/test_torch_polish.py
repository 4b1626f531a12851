"""The port's f64 polish (``copra_tpu_torch/ops/polish.py``) against the JAX
reference's compensated-f32 polish (``copra_tpu/ops/df32_polish.py``), on
the CPU.

The polish here is the stagewise tick in float64 (on CPU tensors its plain
version); the reference emulates float64 with float32 pairs.  Both polish
the same delivered float32 state.  Tolerances: the polished U within 1e-6
x max(1, |U|) of the reference's (two float64-class computations of the
same iteration, each rounded to float32 at the end; on the row problem,
where the reference's df32 fixed point stops 1.5e-6 short of the float64
optimum, the port is held to the optimum instead); against the float64
oracle of the same float32-data problem (the reference test's
``_oracle64``, 20000 iterations) the reference test's own bounds: the
float32 floor above 5e-6 cut by 2.5x and under 1e-5, residuals halved,
rows and drifting dynamics improved.  The reference's tests of its df32
arithmetic (``two_sum``, ``two_prod``, ``df_mul_presplit``, ``df_clip``)
have no counterpart: the port carries no df32 arithmetic.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.ops import df32_polish as jdp
from copra_tpu.ops import stagewise_kernel as jk
from copra_tpu_torch.convert import stagewise_from_numpy
from copra_tpu_torch.ops import stagewise_kernel as sk
from copra_tpu_torch.ops.polish import check_polish_envelope, polish
from test_df32_polish import _box_problem, _oracle64, _zmp_problem

tt.set_default_device("cpu")

PARITY_RTOL = 1e-6


def _port(sj):
    return stagewise_from_numpy({
        f.name: None if getattr(sj, f.name) is None
        else np.asarray(getattr(sj, f.name))
        for f in dataclasses.fields(sj)})


def _polished(fp, opts, out, n_iter):
    """The delivered float32 solve ``out = (X, U, info, warm)`` polished
    as ``solve_stagewise_fused`` polishes it (one float64 tick from the
    kernel state, the proximal centre carried): the 8 delivered tensors
    ``(X, U, zX, zU, yX, yU, zS, yS)``."""
    sqp = fp.sqp
    nb, N, x, u, r = (sqp.A.shape[0], sqp.horizon, sqp.xdim, sqp.udim,
                      sqp.nr_rows)
    X, U, _, warm = out
    empty = X.new_zeros((nb, N, 0))
    warm6 = tuple(warm) if r else tuple(warm) + (empty, empty)
    w, k = polish(fp.polish, sk.fused_stagewise_tick,
                  sqp.x0.mT.contiguous(), sk._pack_warm(fp, *warm6),
                  sk._pack_work(fp, X, U), n_iter=n_iter, N=N, x=x, u=u,
                  r=r, options=opts)
    return sk._unpack(w, k, N, x, u, r)


def _case(sj, opts, n_polish):
    """One workload: the float32 solve, its polish in both packages from
    the same delivered state, and the float64 oracle."""
    sqp = _port(sj)
    fp = sk.build_fused_plan(sqp, opts.replace(polish_iters=n_polish))
    out = sk.solve_stagewise_fused(sqp, opts, return_warm=True, plan=fp)
    vals = _polished(fp, opts, out, n_polish)
    fpj = jk.build_fused_plan(sj, opts)
    pp = jdp.build_df32_polish_plan(sj, opts, Es=fpj.Es, rho_s=fpj.rho_s)
    nb, N = sqp.A.shape[0], sqp.horizon
    warm = tuple(jnp.asarray(w.numpy()) for w in out[3])
    if sqp.nr_rows == 0:
        warm = warm + (jnp.zeros((nb, N, 0), jnp.float32),) * 2
    _, Uj, _ = jdp.df32_polish(pp, sj.x0, jnp.asarray(out[0].numpy()),
                               jnp.asarray(out[1].numpy()), warm, n_polish,
                               opts)
    res = [sk._lane_residuals(fp.sqp, opts, fp.rho_x, fp.rho_u, fp.rows, *v)
           for v in ((out[0], out[1]) + tuple(out[3])
                     + ((out[0].new_zeros((nb, N, 0)),) * 2
                        if sqp.nr_rows == 0 else ()), vals)]
    return dict(U0=out[1].double().numpy(), U1=vals[1].double().numpy(),
                Uj=np.asarray(Uj, np.float64), U64=_oracle64(sj, opts),
                res=res)


@pytest.fixture(scope="module")
def box():
    """The config-1-class workload (saturated control box, curvature 1e4),
    8 lanes, 3000 float32 iterations, 100 polish iterations."""
    opts = ct.SolverOptions(max_iter=3000, early_exit=False, rho=0.1,
                            polish=False)
    return _case(_box_problem(batch=8), opts, 100)


@pytest.fixture(scope="module")
def drift():
    """The same workload with drifting dynamics ``d = (0.02, -0.04)``
    (where a transposed ``avd = (A'V) d`` shows), 4 lanes, 1000
    iterations, 80 polish iterations."""
    sj = _box_problem(batch=4)
    d = jnp.broadcast_to(jnp.asarray([0.02, -0.04], jnp.float32),
                         sj.d.shape)
    opts = ct.SolverOptions(max_iter=1000, early_exit=False, rho=0.1,
                            polish=False)
    return _case(dataclasses.replace(sj, d=d), opts, 80)


@pytest.fixture(scope="module")
def rows():
    """A ZMP-like polygon (general rows), N = 12, 2 lanes, 600 iterations,
    60 polish iterations."""
    opts = ct.SolverOptions(max_iter=600, early_exit=False, rho=1.0,
                            polish=False)
    return _case(_zmp_problem(batch=2, N=12), opts, 60)


def _rel(got, want) -> float:
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


@pytest.mark.parametrize("name", ["box", "drift"])
def test_polish_matches_df32_polish(name, request):
    case = request.getfixturevalue(name)
    assert _rel(case["U1"], case["Uj"]) <= PARITY_RTOL


def test_polish_rows_reaches_the_f64_optimum(rows):
    """On the row problem the port's polish lands within 1e-6 x max(1,
    |U|) of the float64 optimum (3.7e-8 measured: the float32 rounding of
    the result), closer than the reference's df32 polish, whose fixed
    point stops 1.5e-6 from it (measured; more polish iterations do not
    move it).  So the parity with the reference holds at 2e-6 here."""
    port, ref = _rel(rows["U1"], rows["U64"]), _rel(rows["Uj"], rows["U64"])
    assert port <= PARITY_RTOL
    assert port < ref
    assert _rel(rows["U1"], rows["Uj"]) <= 2e-6


def test_polish_retires_the_f32_floor_box(box):
    err0 = np.abs(box["U0"] - box["U64"]).max()
    err1 = np.abs(box["U1"] - box["U64"]).max()
    assert err0 > 5e-6, f"f32 floor unexpectedly low: {err0:.2e}"
    assert err1 <= err0 / 2.5, f"polish too weak: {err0:.2e}->{err1:.2e}"
    assert err1 <= 1e-5
    assert bool(box["res"][1][2].all())


def test_polish_residuals_strictly_improve(box):
    (p0, d0, _), (p1, d1, _) = box["res"]
    assert float(p1.max()) < 0.5 * float(p0.max())
    assert float(d1.max()) < 0.5 * float(d0.max())


def test_polish_improves_row_problem(rows):
    err0 = np.abs(rows["U0"] - rows["U64"]).max()
    err1 = np.abs(rows["U1"] - rows["U64"]).max()
    assert err1 < err0, f"row polish regressed: {err0:.2e}->{err1:.2e}"
    assert err1 <= max(err0 / 2, 2e-6), f"{err0:.2e}->{err1:.2e}"


def test_polish_improves_drifting_system(drift):
    err0 = np.abs(drift["U0"] - drift["U64"]).max()
    err1 = np.abs(drift["U1"] - drift["U64"]).max()
    assert err1 < err0, f"{err0:.2e}->{err1:.2e}"
    assert err1 <= 1e-5


def test_polish_plan_keeps_the_f32_phase_penalties_and_bounds():
    """The float64 plan takes the float32 phase's penalties and row
    scaling as data (cast up) and maps float32 bounds at or beyond
    ``f32max / 8`` to ``+-f64max / 4``."""
    sqp = _port(_zmp_problem(batch=2, N=6))
    big = float(np.finfo(np.float32).max) / 4
    sqp = dataclasses.replace(sqp, uub=torch.full_like(sqp.uub, big),
                              ulb=torch.full_like(sqp.ulb, -3.0))
    opts = ct.SolverOptions(rho=0.3, polish_iters=5)
    fp = sk.build_fused_plan(sqp, opts)
    plan = fp.polish.plan
    assert plan.dtype == torch.float64 and plan.shape == fp.plan.shape
    lo = sk._Layout(3, 1, sqp.nr_rows)
    f64max = torch.finfo(torch.float64).max
    N = sqp.horizon
    assert bool((plan[:N, lo.uub] == f64max / 4).all())
    assert bool((plan[:N, lo.ulb] == -3.0).all())
    assert torch.equal(plan[:, lo.rhox:lo.rhox + 3],
                       fp.plan[:, lo.rhox:lo.rhox + 3].double())
    assert torch.equal(plan[:N, lo.rhos:lo.rhos + sqp.nr_rows],
                       fp.plan[:N, lo.rhos:lo.rhos + sqp.nr_rows].double())
    Es = fp.rows.Es.double()
    assert torch.equal(plan[:N, lo.Cu:lo.Cu + sqp.nr_rows],
                       (sqp.Cu.double() * Es[..., None]).permute(1, 2, 3, 0)
                       .reshape(N, sqp.nr_rows, 2))


def test_polish_noop_for_f64():
    """On float64 data the polish is a no-op: the plan has none and the
    solve equals the unpolished one bit for bit."""
    sqp = _port(_box_problem(batch=2))
    sqp = dataclasses.replace(sqp, **{
        f.name: getattr(sqp, f.name).double()
        for f in dataclasses.fields(sqp) if getattr(sqp, f.name) is not None})
    opts = ct.SolverOptions(max_iter=100, early_exit=False, polish_iters=10)
    assert sk.build_fused_plan(sqp, opts).polish is None
    got = sk.solve_stagewise_fused(sqp, opts)
    want = sk.solve_stagewise_fused(sqp, opts.replace(polish_iters=0))
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fires", [False, True], ids=["skipped", "fires"])
def test_polished_tick_with_top_up(fires):
    """The order of the reference: the polish, the residuals of the
    polished iterates, the top-up decision, the top-up from the first
    run's state and its re-polish.  Skipped, the values are the polished
    first run's bit for bit; fired, those of the top-up polished."""
    sqp = _port(_box_problem(batch=3))
    base = ct.SolverOptions(max_iter=4 if fires else 400,
                            eps_abs=1e-7 if fires else 1e-3, eps_rel=0.0,
                            early_exit=False, rho=0.1, polish_iters=20)
    fp = sk.build_fused_plan(sqp, base)
    got = sk.solve_stagewise_fused(sqp, base.replace(topup_iters=50),
                                   return_warm=True, plan=fp)
    first = sk.solve_stagewise_fused(sqp, base.replace(polish_iters=0),
                                     return_warm=True, plan=fp)
    pol = _polished(fp, base, first, 20)
    assert bool(sk._lane_residuals(fp.sqp, base, fp.rho_x, fp.rho_u, None,
                                   *pol)[2].all()) is not fires
    if fires:
        empty = first[0].new_zeros((3, 10, 0))
        w2, k2 = sk.fused_stagewise_tick(
            fp.plan, fp.sqp.x0.mT.contiguous(),
            sk._pack_warm(fp, *first[3], empty, empty), n_iter=50, N=10,
            x=2, u=1, r=0, sigma=base.sigma, alpha=base.alpha)
        top = sk._unpack(w2, k2, 10, 2, 1, 0)
        want = _polished(fp, base, (top[0], top[1], None, top[2:6]), 20)
    else:
        want = pol
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_polish_through_serving_facade():
    """``make_stagewise_step(backend='fused')`` polishes every tick (on
    CPU tensors the kernel's plain version); a plain-path facade with a
    polish warns that only the fused backend polishes."""
    sqp = _port(_box_problem(batch=4))
    opts = ct.SolverOptions(max_iter=100, early_exit=False, rho=0.1,
                            polish=False, polish_iters=20)
    tick = tt.make_stagewise_step(sqp, opts, cold_options=opts,
                                  backend="fused")
    bare = tt.make_stagewise_step(sqp, opts.replace(polish_iters=0),
                                  cold_options=opts.replace(polish_iters=0),
                                  backend="fused")
    X, U, info, warm = tick(sqp.x0)
    X, U, info, warm = tick(sqp.x0 + 0.01, warm)
    assert bool(torch.isfinite(U).all())
    Ub = bare(sqp.x0 + 0.01, bare(sqp.x0)[3])[1]
    assert not torch.equal(U, Ub)
    with pytest.warns(UserWarning, match="FUSED backend only"):
        tt.make_stagewise_step(sqp, opts, backend="xla")


def test_polish_envelope_names_the_plain_path():
    check_polish_envelope(40, 12, 12, 12)
    with pytest.raises(ValueError, match="backend='xla'"):
        check_polish_envelope(8, 60, 60, 9)
