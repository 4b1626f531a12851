"""The no-knobs layer of ``copra_tpu_torch`` on the card: the tick kernel's
``carry`` flag, the early-exit solve on the kernel against the plain loop,
the f64 polish launch against its plain version and inside a captured
chain, ``make_stagewise_server`` on a ZMP fleet at N = 40 and ``solve``'s
automatic stagewise route at N = 400.  Skips without a CUDA device.
Imports no JAX, so on a GPU host without JAX it runs with
``--noconftest``:

    python -m pytest tests/test_torch_noknobs_cuda.py -m cuda \
        --noconftest -o addopts="" -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

import copra_tpu_torch as tt
from copra_tpu_torch.ops import stagewise_kernel as sk
from copra_tpu_torch.ops.polish import polish
from copra_tpu_torch.qp.riccati import (StagewiseQP, from_mpc,
                                        solve_stagewise)
from test_torch_stagewise_cuda import _fields, _problem

F64_REL = 1e-9     # kernel against its plain version in float64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")


def _rel(got, want) -> float:
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    return max(float((g.cpu() - w.cpu()).abs().max())
               for g, w in zip(got, want)) / scale


def _sqp(f, device, dtype=torch.float64):
    return StagewiseQP(**{k: torch.tensor(v, device=device, dtype=dtype)
                          for k, v in f.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(300, 3, 1, 2, 5), (40, 12, 12, 12, 3)],
                         ids=["resident", "streamed"])
def test_cuda_carry_matches_plain_version(cuda, shape, dtype, tol):
    """``carry``: the run starts from the given work rows' proximal centre;
    both entry points within ``tol`` x max(1, max |plain|) of the plain
    version after 7 iterations from distinct non-zero warm and work
    tensors, and 0 iterations return both as given, bit for bit."""
    N, x, u, r, lanes = shape
    fp, x0, warm = _problem(N, x, u, r, lanes, seed=N + r)
    lo = sk._Layout(x, u, r)
    rng = np.random.default_rng(3)
    work = torch.tensor(0.2 * rng.normal(size=(N + 1, lo.Kw, lanes)),
                        device="cuda")
    args = (fp.plan.to(dtype), x0.to(dtype), warm.to(dtype))
    kw = dict(N=N, x=x, u=u, r=r, sigma=1e-6, alpha=1.6,
              work=work.to(dtype), carry=True)
    want = sk.stagewise_tick_plain(*args, n_iter=7, **kw)
    for entry in (sk.fused_stagewise_tick, sk.fused_stagewise_tick_streamed):
        got = entry(*args, n_iter=7, **kw)
        torch.cuda.synchronize()
        assert _rel(got, want) <= tol, entry.__name__
        w0, k0 = entry(*args, n_iter=0, **kw)
        assert torch.equal(w0, args[2]) and torch.equal(k0, kw["work"])
    # without carry the centre restarts at (zX, zU): another result
    plain = sk.stagewise_tick_plain(*args, n_iter=7,
                                    **dict(kw, carry=False))
    assert _rel(plain, want) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 3, 2, 2, 4), (6, 12, 12, 12, 3),
                                   (17, 3, 2, 0, 3)],
                         ids=["rows", "streamed", "box_only"])
def test_cuda_early_exit_solve_matches_plain_loop(cuda, shape):
    """``solve_stagewise(early_exit=True)`` on the card runs on the kernel
    (launches counted) and reports the plain loop's per-lane iterations
    and statuses, with X and U within 1e-9 relative in float64; a single
    problem too; an infeasible lane is certified on both."""
    N, x, u, r, lanes = shape
    f = _fields(N, x, u, r, lanes, seed=30 + N)
    if r:
        f["clo"][1], f["chi"][1] = f["clo"][1] + 40.0, f["chi"][1] + 41.0
    opts = tt.SolverOptions(max_iter=400, eps_abs=1e-8, eps_rel=0.0,
                            rho=0.3, check_interval=7)
    entry = (sk.fused_stagewise_tick
             if sk.fused_mode(N, x, u, r, torch.float64) == "resident"
             else sk.fused_stagewise_tick_streamed)
    before = entry.launches
    got = solve_stagewise(_sqp(f, "cuda"), opts, return_warm=True)
    torch.cuda.synchronize()
    assert entry.launches > before
    want = solve_stagewise(_sqp(f, "cpu"), opts, return_warm=True)
    assert torch.equal(got[2].iterations.cpu(), want[2].iterations)
    assert torch.equal(got[2].status.cpu(), want[2].status)
    assert _rel(got[:2], want[:2]) <= F64_REL
    assert _rel(got[3], want[3]) <= F64_REL
    one = {k: v[0] for k, v in f.items()}
    got1 = solve_stagewise(_sqp(one, "cuda"), opts)
    assert int(got1[2].iterations) == int(want[2].iterations[0])
    assert _rel(got1[:2], tuple(t[0] for t in want[:2])) <= F64_REL


@pytest.mark.cuda
def test_cuda_early_exit_outside_envelope_raises_naming_plain_path(cuda):
    f = _fields(4, 60, 60, 9, 2, seed=1)
    with pytest.raises(ValueError, match="parallel_scan"):
        solve_stagewise(_sqp(f, "cuda"), tt.SolverOptions(max_iter=5))


def _box_fleet(batch=16, N=10, device="cuda"):
    """``tests/test_df32_polish.py``'s config-1-class workload: a saturated
    +-2 control box, curvature 1e4, float32."""
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.005], [0.1]])
    rng = np.random.default_rng(1)
    x0s = np.array([1.0, 0.0])[None] + rng.normal(scale=[0.3, 0.2],
                                                  size=(batch, 2))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    system = tt.LTISystem.create(f32(A), f32(B), f32(np.zeros(2)),
                                 f32(x0s[0]), N)
    pos_row = np.kron(np.eye(N + 1), np.array([[1.0, 0.0]]))
    costs = (tt.TrajectoryCost(M=f32(pos_row), p=f32(np.zeros(N + 1)),
                               weights=f32(np.full(N + 1, 10.0))),
             tt.SimpleControlCost(p=f32(np.zeros(N)),
                                  weights=f32(np.full(N, 1e-3))))
    cons = (tt.ControlBoundConstraint.create([-2.0], [2.0]),)
    sqp = from_mpc(system, costs, cons)
    fleet = StagewiseQP(**{
        fl.name: None if getattr(sqp, fl.name) is None
        else getattr(sqp, fl.name).expand(
            (batch,) + getattr(sqp, fl.name).shape).contiguous()
        for fl in dataclasses.fields(sqp)})
    return dataclasses.replace(fleet, x0=f32(x0s))


@pytest.mark.cuda
def test_cuda_polish_launch_matches_plain_version(cuda):
    """The f64 polish is one float64 launch of the tick kernel on the
    polish plan, from the delivered float32 state with the proximal centre
    carried: within 1e-9 relative of the plain version on the same
    inputs, counted on the f32 phase's entry point."""
    fleet = _box_fleet()
    opts = tt.SolverOptions(max_iter=300, early_exit=False, rho=0.1,
                            polish=False, polish_iters=60)
    fp = sk.build_fused_plan(fleet, opts)
    assert fp.polish is not None and fp.polish.plan.dtype == torch.float64
    N, x, u, r = 10, 2, 1, 0
    kw = dict(N=N, x=x, u=u, r=r, sigma=opts.sigma, alpha=opts.alpha)
    x0 = fleet.x0.mT.contiguous()
    w4 = sk.solve_stagewise_fused(fleet, opts.replace(polish_iters=0),
                                  return_warm=True)[3]
    empty = fleet.x0.new_zeros((16, N, 0))
    warm = sk._pack_warm(fp, *w4, empty, empty)
    work = sk.fused_stagewise_tick(fp.plan, x0, warm, n_iter=5,
                                   **kw)[1]
    before = sk.fused_stagewise_tick.launches
    got = polish(fp.polish, sk.fused_stagewise_tick, x0, warm, work,
                 n_iter=60, options=opts, **{k: kw[k] for k in "Nxur"})
    assert sk.fused_stagewise_tick.launches == before + 1
    f64 = torch.float64
    args = (fp.polish.plan, x0.to(f64), warm.to(f64))
    pkw = dict(kw, sigma=float(np.float32(opts.sigma)),
               alpha=float(np.float32(opts.alpha)))
    kern = sk.fused_stagewise_tick(*args, n_iter=60, **pkw,
                                   work=work.to(f64), carry=True)
    plain = sk.stagewise_tick_plain(*args, n_iter=60, **pkw,
                                    work=work.to(f64), carry=True)
    torch.cuda.synchronize()
    assert _rel(kern, plain) <= F64_REL
    assert all(torch.equal(g, k.float()) for g, k in zip(got, kern))


@pytest.mark.cuda
def test_cuda_polished_tick_is_captured_in_the_chain(cuda):
    """A polished tick with a top-up needs no host sync, so
    ``make_stagewise_multistep`` captures it; the chain's controls are the
    eager per-tick loop's (1e-6 x max(1, max |U|): the same launches on
    the same inputs)."""
    fleet = _box_fleet()
    opts = tt.SolverOptions(max_iter=40, early_exit=False, rho=0.1,
                            polish=False, polish_iters=20, topup_iters=40)
    cold = opts.replace(max_iter=400)
    many = tt.make_stagewise_multistep(fleet, opts, cold_options=cold,
                                       backend="fused")
    seq = torch.stack([fleet.x0 + 0.01 * t for t in range(4)])
    _, _, _, _, warm = many(None, 4, x0_seq=seq)
    _, u0s, statuses, info, _ = many(None, 4, warm=warm, x0_seq=seq)
    assert len(many.chains) == 1
    tick = tt.make_stagewise_step(fleet, opts, cold_options=cold,
                                  backend="fused")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tick(seq[0], warm)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    w = warm
    for t in range(4):
        _, U, inf_t, w = tick(seq[t], w)
        scale = max(1.0, float(U.abs().max()))
        assert float((U[:, 0] - u0s[t]).abs().max()) <= 1e-6 * scale
    assert torch.equal(inf_t.status, info.status)


def _zmp_fleet(device, N=40, T=0.02, h=0.8, lanes=2):
    """``tests/test_solve_noknobs.py``'s small ZMP fleet, float32."""
    A = np.array([[1.0, T, T * T / 2], [0, 1.0, T], [0, 0, 1.0]])
    B = np.array([[T ** 3 / 6], [T * T / 2], [T]])
    zrow = np.array([[1.0, 0.0, -h / 9.81]])
    Z = np.kron(np.eye(N + 1), zrow)
    ref = np.array([0.1 * min(k // 14, 2) for k in range(N + 1)])
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    system = tt.LTISystem.create(f32(A), f32(B), f32(np.zeros(3)),
                                 f32(np.zeros(3)), N)
    costs = (tt.TrajectoryCost(M=f32(Z), p=f32(ref),
                               weights=f32(np.ones(N + 1))),
             tt.SimpleControlCost(p=f32(np.zeros(N)),
                                  weights=f32(np.full(N, 1e-6))))
    cons = (tt.TrajectoryConstraint(E=f32(Z), f=f32(ref + 0.05)),
            tt.TrajectoryConstraint(E=f32(-Z), f=f32(-(ref - 0.05))))
    sqp = from_mpc(system, costs, cons)
    fleet = StagewiseQP(**{
        fl.name: None if getattr(sqp, fl.name) is None
        else getattr(sqp, fl.name).expand(
            (lanes,) + getattr(sqp, fl.name).shape).contiguous()
        for fl in dataclasses.fields(sqp)})
    return system, costs, cons, fleet


@pytest.mark.cuda
def test_cuda_stagewise_server_no_knobs_fleet(cuda):
    """``make_stagewise_server`` on the card (probes on the kernel, oracle
    on its float64 early-exit route): converged ticks, and the applied
    control of lane 0 within 1e-4 of the native oracle, relative."""
    system, costs, cons, fleet = _zmp_fleet("cuda")
    tick, policy = tt.make_stagewise_server(fleet, return_policy=True)
    assert tick.backend == "fused"
    assert policy["warm_iters"] >= 1 and policy["rho"] > 0
    X, U, info, warm = tick(torch.zeros((2, 3), device="cuda"))
    assert bool((info.status == tt.STATUS_SOLVED).all()), info.inform()
    x1 = X[:, 1]
    X, U, info, warm = tick(x1, warm)
    assert bool((info.status == tt.STATUS_SOLVED).all()), info.inform()
    plan = tt.make_control_plan(system, costs, cons)
    exact = tt.solve_qp_native(tt.plan_qp(plan, x1[0].double())).x
    scale = max(1.0, float(exact.abs().max()))
    assert abs(float(U[0, 0, 0]) - float(exact[0])) / scale <= 1e-4


@pytest.mark.cuda
def test_cuda_solve_picks_stagewise_for_long_horizons(cuda):
    """N = 400 (400 variables > 300) routes to the stagewise engine, whose
    early-exit solves run on the kernel, and meets 1e-4 relative against
    the native oracle (``tests/test_solve_noknobs.py``'s case)."""
    N, T = 400, 0.02
    A = np.array([[1.0, T], [0.0, 1.0]])
    B = np.array([[T * T / 2], [T]])
    dev = lambda a: torch.tensor(np.asarray(a, np.float64), device="cuda")
    system = tt.LTISystem.create(dev(A), dev(B), dev(np.zeros(2)),
                                 dev([1.0, 0.0]), N)
    costs = (tt.SimpleTrajectoryCost.create(np.zeros(2),
                                            weights=np.array([5.0, 0.5])),
             tt.SimpleControlCost.create(np.zeros(1),
                                         weights=np.array([1e-3])))
    cons = (tt.ControlBoundConstraint.create([-1.0], [1.0]),)
    before = sk.fused_stagewise_tick.launches
    res = tt.solve(system, costs, cons)
    assert sk.fused_stagewise_tick.launches > before
    assert int(res.solution.status) == tt.STATUS_SOLVED
    qp = tt.build_qp(tt.condense(system), system.x0, costs, cons)
    exact = tt.solve_qp_native(qp).x
    scale = max(1.0, float(exact.abs().max()))
    err = float((res.control.cpu() - exact).abs().max()) / scale
    assert err <= 1e-4, err
