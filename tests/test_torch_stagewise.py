"""The port's stagewise engine against the JAX reference, on the CPU.

Inputs are made from numpy seeds and fed to both packages in float64.  The
reference's oracle for the fused tick kernels is ``solve_stagewise``, so the
port's fused path (its plain PyTorch version on CPU tensors) is held
against it; no Pallas interpreter runs here.  Tolerances: 1e-12 for the
builders and the fixed-gain algebra (same formulas, other summation
order), 1e-9 for solves (the reference's fused-vs-XLA tolerance,
``tests/test_stagewise_kernel.py``).  The CUDA kernel against the plain
version is in ``test_torch_stagewise_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_all
import chip_smoke
import copra_tpu as ct
from copra_tpu.ops import stagewise_kernel as jk
from copra_tpu.qp import riccati as jr
from examples import bipedal_walking

import copra_tpu_torch as tt
from copra_tpu_torch.convert import stagewise_from_numpy
from copra_tpu_torch.ops import stagewise_kernel as sk
from copra_tpu_torch.qp import riccati as tr

tt.set_default_device("cpu")

FIELDS = [f.name for f in dataclasses.fields(jr.StagewiseQP)]
SOLVE_TOL = 1e-9
EXACT_TOL = 1e-12


def _fields(seed, N=12, x=3, u=2, r=2, rows=True, lanes=None, inf_frac=0.3):
    """Random well-posed stagewise problem (the reference test's
    ``_random_sqp`` recipe) as numpy float64 fields."""
    rng = np.random.default_rng(seed)
    lead = () if lanes is None else (lanes,)
    A = 0.95 * np.eye(x) + 0.08 * rng.normal(size=lead + (N, x, x)) \
        / np.sqrt(x / 3)
    Qm = 0.3 * rng.normal(size=lead + (N + 1, x, x))
    Rm = 0.3 * rng.normal(size=lead + (N, u, u))
    xlb = np.full(lead + (N + 1, x), -0.8)
    mask = rng.uniform(size=lead + (N + 1, x)) < inf_frac
    f = dict(
        A=A, B=0.5 * rng.normal(size=lead + (N, x, u)),
        d=0.01 * rng.normal(size=lead + (N, x)),
        Qx=np.einsum("...kij,...kil->...kjl", Qm, Qm) + 0.1 * np.eye(x),
        qx=0.2 * rng.normal(size=lead + (N + 1, x)),
        Ru=np.einsum("...kij,...kil->...kjl", Rm, Rm) + 0.5 * np.eye(u),
        ru=0.2 * rng.normal(size=lead + (N, u)),
        x0=0.3 * rng.normal(size=lead + (x,)),
        xlb=np.where(mask, -np.inf, xlb), xub=np.where(mask, np.inf, -xlb),
        ulb=np.full(lead + (N, u), -1.5), uub=np.full(lead + (N, u), 1.5))
    if rows:
        mid = 0.1 * rng.normal(size=lead + (N, r))
        f.update(Cx=rng.normal(size=lead + (N, r, x)),
                 Cu=rng.normal(size=lead + (N, r, u)),
                 clo=mid - 0.7, chi=mid + 0.7)
    return f


def _jax(f):
    return jr.StagewiseQP(**{k: jnp.asarray(v) for k, v in f.items()})


def _port(f):
    return stagewise_from_numpy(f)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


def _same_qp(got, want, tol=EXACT_TOL):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == torch.float64, name
            _close(g.numpy(), w, tol, name)


def _same_solution(got, want, tol=SOLVE_TOL, iterations=True):
    """(X, U, info[, warm]) of the port against the reference.  The fused
    path reports ``max_iter`` iterations whether or not its top-up ran,
    the reference's XLA path the top-up's count, as in the reference."""
    _close(got[0].numpy(), want[0], tol, "X")
    _close(got[1].numpy(), want[1], tol, "U")
    gi, wi = got[2], want[2]
    for name in ("x", "y", "z", "primal_residual", "dual_residual"):
        _close(getattr(gi, name).numpy(), getattr(wi, name), tol, name)
    np.testing.assert_array_equal(gi.status.numpy(), np.asarray(wi.status))
    if iterations:
        np.testing.assert_array_equal(gi.iterations.numpy(),
                                      np.asarray(wi.iterations))
    if len(got) > 3:
        assert len(got[3]) == len(want[3])
        for g, w in zip(got[3], want[3]):
            _close(g.numpy(), w, tol, "warm")


@pytest.mark.parametrize("batched", [False, True])
def test_fixed_gain_sweeps_match_reference_with_cross_term(batched):
    """precompute_lqr_gains, lqr_solve_fixed and lqr_solve with an S cross
    term, single and batched, at 1e-12."""
    f = _fields(0, N=9, rows=False, lanes=2 if batched else None)
    rng = np.random.default_rng(1)
    S = 0.05 * rng.normal(size=f["B"].shape)
    args = [f[k] for k in ("A", "B", "d", "Qx", "Ru")]
    tgains = sk.precompute_lqr_gains(*map(torch.tensor, args),
                                     torch.tensor(S))
    lin = [f[k] for k in ("qx", "ru", "x0")]
    t_fixed = sk.lqr_solve_fixed(tgains, *(torch.tensor(f[k]) for k in
                                           ("A", "B", "d")),
                                 *map(torch.tensor, lin))
    t_full = tr.lqr_solve(*(torch.tensor(f[k]) for k in
                            ("A", "B", "d", "Qx", "qx", "Ru", "ru", "x0")),
                          S=torch.tensor(S))
    one = lambda fn, *a: jax.jit(jax.vmap(fn) if batched else fn)(*a)
    jgains = one(jk.precompute_lqr_gains, *map(jnp.asarray, args),
                 jnp.asarray(S))
    j_fixed = one(jk.lqr_solve_fixed, jgains,
                  *(jnp.asarray(f[k]) for k in ("A", "B", "d")),
                  *map(jnp.asarray, lin))
    j_full = one(lambda *a: jr.lqr_solve(*a[:-1], S=a[-1]),
                 *(jnp.asarray(f[k]) for k in
                   ("A", "B", "d", "Qx", "qx", "Ru", "ru", "x0")),
                 jnp.asarray(S))
    for name in ("K", "nF", "G", "bvd", "avd"):
        _close(getattr(tgains, name).numpy(), getattr(jgains, name),
               EXACT_TOL, name)
    for g, w in zip(t_fixed + t_full, j_fixed + j_full):
        _close(g.numpy(), w, EXACT_TOL)
    # the fixed-gain sweep is the full Riccati sweep
    for g, w in zip(t_fixed, t_full):
        _close(g.numpy(), w.numpy(), 1e-10)


def _zmp_case(ct_mod, N=12, T=0.1):
    """A ZMP-class problem (examples/bipedal_walking.py data at N = 12,
    T = 0.1 so footsteps change inside the horizon) for ``ct_mod``."""
    A, B, d, zmp_row = bipedal_walking.lipm_system(T, 0.8)
    ref, lo, hi = bipedal_walking.footstep_plan(4, N, T)
    Zfull = np.kron(np.eye(N + 1), zmp_row)
    system = ct_mod.LTISystem.create(A, B, d, np.zeros(3), N)
    costs = (ct_mod.TrajectoryCost.create(Zfull, ref[1], np.ones(N + 1)),
             ct_mod.SimpleControlCost.create(np.zeros(N),
                                             np.full(N, 1e-6)))
    cons = (ct_mod.TrajectoryConstraint.create(Zfull, hi[1]),
            ct_mod.TrajectoryConstraint.create(-Zfull, -lo[1]))
    return system, costs, cons


def _mixed_case(ct_mod, x0_row_f=1.0, N=7):
    """Every per-stage cost and constraint kind from_mpc takes, with a
    trajectory row on x_0 whose bound is ``x0_row_f``."""
    rng = np.random.default_rng(3)
    x, u = 3, 2
    A = 0.9 * np.eye(x) + 0.05 * rng.normal(size=(N, x, x))
    B = rng.normal(size=(N, x, u))
    d = 0.01 * rng.normal(size=(N, x))
    x0 = np.array([0.2, -0.1, 0.05])
    system = ct_mod.LTVSystem.create(A, B, d, x0)
    M = rng.normal(size=(2, x))
    costs = (ct_mod.TargetCost.create(M, [0.3, -0.2], [2.0, 1.0]),
             ct_mod.TrajectoryCost.create(np.eye(x), [0.1, 0.0, -0.1],
                                          [1.0, 0.5, 0.2]),
             ct_mod.SimpleTrajectoryCost.create(
                 rng.normal(size=(N + 1) * x),
                 rng.uniform(0.1, 1.0, size=(N + 1) * x)),
             ct_mod.ControlCost.create(rng.normal(size=(2, u)), [0.1, 0.2],
                                       [1.0, 3.0]),
             ct_mod.SimpleControlCost.create([0.0, 0.1], [0.5, 0.5]))
    cons = (ct_mod.TrajectoryBoundConstraint.create(
                [-1.0, -np.inf, -2.0], [1.0, np.inf, 2.0]),
            ct_mod.ControlBoundConstraint.create(
                np.full(N * u, -3.0), np.full(N * u, 3.0)),
            ct_mod.TrajectoryConstraint.create([[1.0, 1.0, 0.0]],
                                               [x0_row_f]),
            ct_mod.ControlConstraint.create([[1.0, -1.0]], [0.5],
                                            is_inequality=False),
            ct_mod.MixedConstraint.create(rng.normal(size=(2, x)),
                                          rng.normal(size=(2, u)),
                                          [0.4, 0.6]))
    return system, costs, cons


@pytest.mark.parametrize("case", [_zmp_case, _mixed_case])
def test_from_mpc_matches_reference(case):
    """Every leaf within 1e-12 (f64), rows re-expressed through the
    dynamics, block-diagonal full-horizon entries accepted."""
    want = jr.from_mpc(*case(ct))
    got = tr.from_mpc(*case(tt))
    _same_qp(got, want)


def test_from_mpc_rejects_violated_x0_row_and_coupling():
    with pytest.raises(tt.InfeasibleProblemError, match="initial state"):
        tr.from_mpc(*_mixed_case(tt, x0_row_f=0.0))
    with pytest.raises(ct.InfeasibleProblemError, match="initial state"):
        jr.from_mpc(*_mixed_case(ct, x0_row_f=0.0))
    system, costs, cons = _zmp_case(tt)
    coupled = tt.TrajectoryCost.create(np.ones((1, 3 * 13)), [0.0],
                                       [1.0])
    with pytest.raises(tt.DimensionError, match="couples stages"):
        tr.from_mpc(system, costs + (coupled,), cons)


def test_scales_and_scaling_match_reference_on_the_quadruped():
    """stagewise_scales (host f64, sampled lanes) and scale_stagewise on
    the config-6 quadruped at N = 6, as a 3-lane batch: 1e-12."""
    one = {k: np.asarray(v, np.float64) for k, v in
           chip_smoke.srb_quadruped(N=6).items()}
    rng = np.random.default_rng(4)
    batch = {k: np.repeat(v[None], 3, 0) for k, v in one.items()}
    batch["x0"] = batch["x0"] + 0.01 * rng.normal(size=(3, 12))
    jscale = jr.stagewise_scales(_jax(batch))
    tscale = tr.stagewise_scales(_port(batch))
    for g, w in zip(tscale, jscale):
        _close(g.numpy(), w, EXACT_TOL, "scales")
    _same_qp(tr.scale_stagewise(_port(batch), *tscale),
             jr.scale_stagewise(_jax(batch), *jscale))
    _same_qp(tr.scale_stagewise(_port(one), *tscale),
             jr.scale_stagewise(_jax(one), *jscale))


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("rows", [False, True])
def test_solve_stagewise_matches_reference(early_exit, rows):
    """Both loop modes, with and without rows: X, U, duals, residuals,
    statuses and iteration counts; then a warm-started second solve."""
    f = _fields(10 + rows, rows=rows)
    opts = ct.SolverOptions(max_iter=60, early_exit=early_exit,
                            check_interval=7, eps_abs=1e-6, eps_rel=0.0)
    want = jax.jit(lambda s: jr.solve_stagewise(
        s, opts, return_warm=True))(_jax(f))
    got = tr.solve_stagewise(_port(f), opts, return_warm=True)
    _same_solution(got, want)
    g = dict(f, x0=f["x0"] + 0.03)
    want2 = jax.jit(lambda s, w: jr.solve_stagewise(
        s, opts, warm_start=w))(_jax(g), want[3])
    got2 = tr.solve_stagewise(_port(g), opts, warm_start=got[3])
    _same_solution(got2, want2)


def test_batched_early_exit_stops_each_lane_as_vmap_does():
    """A batch of lanes that converge at different chunks, plus one with
    crossed bounds (primal infeasible), against jax.vmap."""
    f = _fields(20, N=10, lanes=3, rows=True)
    f["x0"][1] *= 3.0
    f["ulb"][2, 4, 0], f["uub"][2, 4, 0] = 1.0, -1.0
    opts = ct.SolverOptions(max_iter=200, early_exit=True, check_interval=5,
                            eps_abs=1e-7, eps_rel=0.0)
    want = jax.jit(jax.vmap(lambda s: jr.solve_stagewise(s, opts)))(
        _jax(f))
    got = tr.solve_stagewise(_port(f), opts)
    _same_solution(got, want)
    assert got[2].status[2] == tt.STATUS_PRIMAL_INFEASIBLE
    assert len(set(got[2].iterations.tolist())) > 1


def test_dual_residual_and_stack_match_reference():
    f = _fields(30, N=11, rows=True)
    rng = np.random.default_rng(31)
    N, x, u, r = 11, 3, 2, 2
    vals = [rng.normal(size=s) for s in
            ((N + 1, x), (N, u), (N + 1, x), (N, u), (N, r))]
    for yS in (vals[4], None):
        want = jr.stagewise_dual_residual(_jax(f), *map(jnp.asarray,
                                                          vals[:4]),
                                          None if yS is None
                                          else jnp.asarray(yS))
        for parallel in (False, True):
            got = tr.stagewise_dual_residual(
                _port(f), *map(torch.tensor, vals[:4]),
                None if yS is None else torch.tensor(yS), parallel=parallel)
            _close(got.numpy(), want, EXACT_TOL)
    g = _fields(32, N=11, rows=True)
    _same_qp(tr.stack_stagewise([_port(f), _port(g)], repeats=3),
             jr.stack_stagewise([_jax(f), _jax(g)], repeats=3))


def _warm(rng, fields, lanes, rows):
    """Distinct non-zero warm tuples (zX, zU, yX, yU[, zS, yS])."""
    N, x = fields["A"].shape[-3], fields["A"].shape[-1]
    u = fields["B"].shape[-1]
    shapes = [(N + 1, x), (N, u), (N + 1, x), (N, u)]
    if rows:
        r = fields["Cx"].shape[-2]
        shapes += [(N, r), (N, r)]
    return tuple(0.1 * (i + 1) * rng.normal(size=(lanes,) + s)
                 for i, s in enumerate(shapes))


@pytest.mark.parametrize("shape", [dict(N=12, x=3, u=2, r=2),
                                   dict(N=6, x=12, u=12, r=12)],
                         ids=["resident", "streamed"])
def test_fused_solve_matches_reference_cold_and_warm(shape):
    """solve_stagewise_fused on CPU tensors (the plain version of the
    kernel) against the batched reference solve_stagewise: cold, then
    warm from distinct non-zero warm tuples; 1e-9, statuses equal."""
    lanes = 3
    f = _fields(40 + shape["x"], lanes=lanes, rows=True, **shape)
    opts = ct.SolverOptions(max_iter=25, early_exit=False, rho=0.3)
    fp = sk.build_fused_plan(_port(f), opts)
    assert fp.mode == sk.fused_mode(shape["N"], shape["x"], shape["u"],
                                    shape["r"], torch.float64)
    want = jax.jit(jax.vmap(lambda s: jr.solve_stagewise(
        s, opts, return_warm=True)))(_jax(f))
    got = sk.solve_stagewise_fused(_port(f), opts, return_warm=True,
                                   plan=fp)
    _same_solution(got, want)
    warm = _warm(np.random.default_rng(41), f, lanes, rows=True)
    for w in (warm, warm[:4]):     # full carried state, and duals only
        want = jax.jit(jax.vmap(lambda s, ww: jr.solve_stagewise(
            s, opts, warm_start=ww)))(_jax(f), tuple(map(jnp.asarray, w)))
        got = sk.solve_stagewise_fused(_port(f), opts,
                                       warm_start=tuple(map(torch.tensor,
                                                            w)))
        _same_solution(got, want)


def test_fused_solve_box_only_reseeds_like_reference():
    """Without rows a warm start keeps the duals and reseeds z through the
    unridged gains (one extra sweep), as the reference does."""
    lanes = 2
    f = _fields(50, lanes=lanes, rows=False)
    opts = ct.SolverOptions(max_iter=15, early_exit=False)
    warm = _warm(np.random.default_rng(51), f, lanes, rows=False)
    want = jax.jit(jax.vmap(lambda s, w: jr.solve_stagewise(
        s, opts, warm_start=w, return_warm=True)))(
            _jax(f), tuple(map(jnp.asarray, warm)))
    got = sk.solve_stagewise_fused(_port(f), opts,
                                   warm_start=tuple(map(torch.tensor, warm)),
                                   return_warm=True)
    _same_solution(got, want)


def test_serving_facade_matches_reference_with_scaling_topup_replan():
    """make_stagewise_step(backend='fused') on CPU tensors against the
    reference's backend='xla': an explicit scaling pair, a cold tick, a
    warm tick whose x0 jump starves the fixed count so the top-up fires,
    a third tick, then a replan and its swap-budget tick; 1e-9."""
    lanes = 3
    f = _fields(60, N=10, lanes=lanes, rows=True)
    base = ct.SolverOptions(max_iter=6, eps_abs=1e-6, eps_rel=0.0,
                            early_exit=False, rho=0.1)
    opts, cold = base.replace(topup_iters=200), base.replace(max_iter=300)
    Dx, Du = (t.numpy() for t in tr.stagewise_scales(_port(f)))
    tick_j = jr.make_stagewise_step(_jax(f), opts, cold_options=cold,
                                    backend="xla",
                                    scaling=(jnp.asarray(Dx),
                                             jnp.asarray(Du)))
    kw = dict(cold_options=cold, scaling=(torch.tensor(Dx),
                                          torch.tensor(Du)))
    tick_t = tr.make_stagewise_step(_port(f), opts, backend="fused", **kw)
    starved = tr.make_stagewise_step(_port(f), base, backend="fused", **kw)
    assert tick_t.backend == "fused"
    x0s = [f["x0"], f["x0"] + 0.1, f["x0"] + 0.11]
    wj = wt = None
    for k, x0 in enumerate(x0s):
        out_j = tick_j(jnp.asarray(x0), wj)
        out_t = tick_t(torch.tensor(x0), wt)
        _same_solution(out_t, out_j, iterations=False)
        if k == 1:   # the fixed count alone leaves lanes unconverged
            out_s = starved(torch.tensor(x0), wt)
            solved = lambda o: int((o[2].status == tt.STATUS_SOLVED).sum())
            assert solved(out_s) < solved(out_t), "the top-up did not fire"
        wj, wt = out_j[3], out_t[3]
    g = dict(f, qx=f["qx"] + 0.05, xlb=f["xlb"] - 0.1)
    tick_j.replan(_jax(g))
    tick_t.replan(_port(g))
    _same_solution(tick_t(torch.tensor(x0s[-1]), wt),
                   tick_j(jnp.asarray(x0s[-1]), wj), iterations=False)
    with pytest.raises(tt.DimensionError, match="replan"):
        tick_t.replan(_port(_fields(60, N=9, lanes=lanes)))


def test_wrappers_on_cpu_take_the_plain_version_and_options_raise():
    f = _fields(70, N=5, lanes=2, rows=True)
    opts = ct.SolverOptions(max_iter=4, early_exit=False)
    fp = sk.build_fused_plan(_port(f), opts)
    lo = sk._Layout(3, 2, 2)
    warm = torch.tensor(np.random.default_rng(71).normal(
        size=(6, lo.W, 2)))
    x0 = torch.tensor(f["x0"]).mT.contiguous()
    kw = dict(n_iter=3, N=5, x=3, u=2, r=2, sigma=1e-6, alpha=1.6)
    before = (sk.fused_stagewise_tick.launches,
              sk.fused_stagewise_tick_streamed.launches)
    want = sk.stagewise_tick_plain(fp.plan, x0, warm, **kw)
    for entry in (sk.fused_stagewise_tick, sk.fused_stagewise_tick_streamed):
        got = entry(fp.plan, x0, warm, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (sk.fused_stagewise_tick.launches,
            sk.fused_stagewise_tick_streamed.launches) == before
    assert sk.fused_mode(300, 3, 1, 2, torch.float32) == "resident"
    assert sk.fused_mode(40, 12, 12, 12, torch.float32) == "streamed"
    sk.check_fused_envelope(300, 3, 1, 2, torch.float32)
    sk.check_fused_envelope(10, 4, 1, 2, torch.float32)   # any (x, u, r)
    with pytest.raises(ValueError, match="envelope"):
        sk.check_fused_envelope(10, 100, 20, 9, torch.float32)
    with pytest.raises(NotImplementedError, match="item 8"):
        sk.build_fused_plan(_port(f), opts.replace(polish_iters=2))
    with pytest.raises(NotImplementedError, match="item 11"):
        tr.solve_stagewise(_port(f), opts, parallel_scan=True)
    with pytest.raises(ValueError, match="contradictory"):
        tr.make_stagewise_step(_port(f), opts, backend="fused",
                               parallel_scan=True)
    # CPU tensors: 'auto' takes the plain batched path
    assert tr.make_stagewise_step(_port(f), opts).backend == "xla"


def test_chip_smoke_data_builders_match_the_reference_builders():
    """The numpy builders and oracles chip_smoke.py carries (the card's
    host has no JAX) equal examples/bipedal_walking.py's and
    bench_all.py's at a small N."""
    for got, want in zip(chip_smoke.lipm_system(0.005, 0.8),
                         bipedal_walking.lipm_system(0.005, 0.8)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(chip_smoke.footstep_plan(4, 20, 0.1),
                         bipedal_walking.footstep_plan(4, 20, 0.1)):
        np.testing.assert_array_equal(got, want)
    got = chip_smoke.srb_quadruped(N=6)
    want = bench_all._srb_quadruped(N=6)
    for name in FIELDS:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(
        chip_smoke.stagewise_exact(tt, got),
        bench_all._stagewise_exact_native(want), rtol=0, atol=1e-10)
    A, B, d, zrow = chip_smoke.lipm_system(0.1, 0.8)
    ref, lo, hi = chip_smoke.footstep_plan(4, 12, 0.1)
    x0 = np.array([0.01, 0.0, 0.0])
    np.testing.assert_allclose(
        chip_smoke.zmp_exact(tt, A, B, d, zrow, ref[1], lo[1], hi[1], x0),
        bench_all._zmp_exact(A, B, d, zrow, ref[1], lo[1], hi[1], x0)[0],
        rtol=0, atol=1e-10)
