"""The multistep chains of ``copra_tpu_torch`` as CUDA graphs, on the card:
each chain against the eager per-tick loop, a replan after the capture
against a fresh facade, ticks and replays free of host syncs, the tick
kernel's top-up flag, and the returned tensors kept from the next call.
Skips without a CUDA device.  Imports no JAX, so on a GPU host without JAX
it runs with ``--noconftest``:

    python -m pytest tests/test_torch_multistep_cuda.py -m cuda \
        --noconftest -o addopts="" -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

import copra_tpu_torch as tt
from chip_smoke import build_fleet
from copra_tpu_torch.ops import admm_kernel as ak
from copra_tpu_torch.ops import stagewise_kernel as sk
from copra_tpu_torch.qp.riccati import StagewiseQP, make_stagewise_step
from test_torch_stagewise_cuda import _fields, _problem

SAME = 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")


def _plan(batch=64, horizon=20):
    """Config 4's fleet cut to ``batch`` lanes and ``horizon`` steps, its
    accurate step's options and a drifting state stream [T, B, 2]."""
    arrays, x0s, x0_seq = build_fleet(batch, horizon)
    system = tt.LTVSystem(*(torch.tensor(a, device="cuda") for a in arrays))
    costs = (tt.TargetCost.create(np.eye(2), [0.0, -1.0],
                                  weights=[10.0, 1e4]),
             tt.ControlCost.create([[1.0]], [2.0], weights=[1e-4]))
    cons = (tt.ControlBoundConstraint.create([-70.0], [70.0]),)
    plan = tt.make_control_plan(system, costs, cons)
    opts = tt.SolverOptions(max_iter=30, early_exit=False, polish=False,
                            rho=tt.suggest_rho(plan), kkt_refine=0)
    return plan, opts, x0s, torch.tensor(x0_seq, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [1, 2])
def test_plan_chain_equals_per_tick_loop(cuda, rounds):
    """T = 6 ticks a graph, from ``warm=None`` and then from the chain's
    warm state, against the eager per-tick accurate step (1e-12); each
    replay adds the capture's launches to the kernel's count."""
    plan, opts, x0s, seq = _plan()
    many = tt.make_plan_multistep(plan, opts, seed_center=x0s,
                                  accurate_rounds=rounds)
    step = tt.make_plan_step(plan, opts, batched=True, seed_center=x0s,
                             accurate=True, accurate_rounds=rounds)
    T = 6
    w_chain, w_loop = None, None
    for part in (seq[:T], seq[T:2 * T]):
        before = ak.fused_admm_box_lanes.launches
        us, statuses, rds, w_chain = many(part, w_chain)
        for t in range(T):
            u, sol, w_loop = step(plan, part[t], w_loop)
            assert float((us[t] - u).abs().max()) <= SAME
            assert torch.equal(statuses[t], sol.status)
            assert float((rds[t] - sol.dual_residual).abs().max()) <= SAME
        assert float((w_chain.y - w_loop.y).abs().max()) <= SAME
        assert ak.fused_admm_box_lanes.launches > before
    (chain,) = many.chains.values()
    per_replay = dict(chain.launches)[ak.fused_admm_box_lanes]
    assert per_replay == (rounds + 1) * T   # x0 = 0 body a round, Q x pass
    before = ak.fused_admm_box_lanes.launches
    many(seq[:T], w_chain)
    assert ak.fused_admm_box_lanes.launches == before + per_replay


@pytest.mark.cuda
def test_plan_chain_outputs_are_not_overwritten(cuda):
    plan, opts, x0s, seq = _plan(batch=32)
    many = tt.make_plan_multistep(plan, opts, seed_center=x0s)
    first = many(seq[:4])
    kept = [t.clone() for t in first[:3]]
    many(seq[4:8], first[3])
    for a, b in zip(first[:3], kept):
        assert torch.equal(a, b)


def _sqp(N, x, u, r, lanes, seed):
    return StagewiseQP(**{k: torch.tensor(v, device="cuda") for k, v in
                          _fields(N, x, u, r, lanes, seed).items()})


def _tick_loop(tick, seq, warm, plant=None, x0=None):
    """The per-tick loop of a chain: ``(U0s, last U, last info, warm)``."""
    u0s = []
    xk = x0
    for t in range(seq.shape[0] if seq is not None else plant[1]):
        xk = seq[t] if seq is not None else xk
        X, U, info, warm = tick(xk, warm)
        u0s.append(U[:, 0])
        if seq is None:
            xk = plant[0](xk, U)
    return torch.stack(u0s), U, info, warm


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 3, 2, 2, 33), (6, 12, 12, 12, 9)],
                         ids=["resident", "streamed"])
def test_stagewise_chain_equals_per_tick_loop(cuda, shape):
    """Both modes of ``make_stagewise_multistep(backend='fused')`` (one
    graph each) against the eager ticks of ``make_stagewise_step``, in
    float64 with a firing top-up (1e-12 of max(1, |U|)); the rollout
    pairing shapes; the replays' launches counted."""
    N, x, u, r, lanes = shape
    sqp = _sqp(N, x, u, r, lanes, seed=N + x)
    opts = tt.SolverOptions(max_iter=8, early_exit=False, rho=0.3,
                            eps_abs=1e-8, topup_iters=20)
    cold = opts.replace(max_iter=100)
    many = tt.make_stagewise_multistep(sqp, opts, cold_options=cold,
                                       backend="fused")
    tick = make_stagewise_step(sqp, opts, cold_options=cold,
                               backend="fused")
    entry = (sk.fused_stagewise_tick
             if sk.fused_mode(N, x, u, r, sqp.A.dtype) == "resident"
             else sk.fused_stagewise_tick_streamed)
    T = 4
    rng = np.random.default_rng(3)
    seq = sqp.x0 + torch.tensor(rng.normal(scale=0.02, size=(T, lanes, x))
                                .cumsum(0), device="cuda")
    _, _, _, warm = tick(seq[0])
    states, u0s, statuses, info, w = many(None, T, warm=warm, x0_seq=seq)
    assert tuple(states.shape) == (T + 1, lanes, x)
    assert tuple(u0s.shape) == (T, lanes, u)
    want = _tick_loop(tick, seq, warm)
    scale = max(1.0, float(want[1].abs().max()))
    assert float((u0s - want[0]).abs().max()) <= SAME * scale
    assert float((info.x - want[2].x).abs().max()) <= SAME * scale
    assert torch.equal(statuses[-1], want[2].status)
    for a, b in zip(w, want[3]):
        assert float((a - b).abs().max()) <= SAME * max(1.0, float(
            b.abs().max()))
    # plant mode from a cold start: the cold tick's control included
    before = entry.launches
    states, u0s, statuses, info, w = many(sqp.x0, T)
    assert tuple(states.shape) == (T + 2, lanes, x)
    assert tuple(u0s.shape) == (T + 1, lanes, u)
    A0, B0, d0 = (t[:, 0] for t in (sqp.A, sqp.B, sqp.d))
    plant = lambda xk, U: (torch.einsum("bxy,by->bx", A0, xk)
                           + torch.einsum("bxu,bu->bx", B0, U[:, 0]) + d0)
    _, Uc, _, wc = tick(sqp.x0)
    assert float((u0s[0] - Uc[:, 0]).abs().max()) <= SAME * scale
    want = _tick_loop(tick, None, wc, plant=(plant, T),
                      x0=plant(sqp.x0, Uc))
    assert float((u0s[1:] - want[0]).abs().max()) <= SAME * scale
    assert entry.launches > before
    assert set(many.chains) == {(T, True), (T, False)}
    per_replay = dict(many.chains[(T, False)].launches)[entry]
    assert per_replay == 2 * T        # the tick and its top-up launch


def _drifted(sqp: StagewiseQP, seed: int) -> StagewiseQP:
    """The same problem after a model update: the dynamics (A, B), the
    costs (Qx, Ru, qx) and a state bound moved."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dA = 0.01 * torch.randn(sqp.A.shape, generator=g, device="cuda",
                            dtype=sqp.A.dtype)
    return dataclasses.replace(sqp, A=sqp.A + dA, B=sqp.B * 1.05,
                               Qx=sqp.Qx * 1.1, Ru=sqp.Ru * 1.2,
                               qx=sqp.qx * 1.1, xub=sqp.xub + 0.05)


def _same(got, want):
    """``(states, U0s, statuses, info, warm)`` of two calls, bit for bit."""
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    for f in dataclasses.fields(got[3]):
        assert torch.equal(getattr(got[3], f.name), getattr(want[3], f.name))
    for a, b in zip(got[4], want[4]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_stagewise_replan_after_capture_equals_fresh_facade(cuda):
    """``replan`` copies the new data into the captured tensors (the fused
    plan, its lane-first copy and gains, the default plant's stage-0
    dynamics, the cold tick's plan): after it, both chains (``x0_seq`` and
    plant mode, the latter from a cold start and from a carried warm
    state) equal a fresh facade on the new data bit for bit, with no new
    capture; on the resident and the streamed kernel."""
    for N, x, u, r, lanes in ((12, 3, 2, 2, 17), (6, 12, 12, 12, 9)):
        sqp = _sqp(N, x, u, r, lanes, seed=9 + x)
        opts = tt.SolverOptions(max_iter=10, early_exit=False, rho=0.3,
                                topup_iters=10)
        many = tt.make_stagewise_multistep(sqp, opts, backend="fused",
                                           scaling="auto")
        T = 3
        seq = sqp.x0 + 0.01 * torch.arange(T, device="cuda",
                                           dtype=sqp.A.dtype)[:, None, None]
        _, _, _, _, warm = many(None, T, x0_seq=seq)
        many(sqp.x0, T)
        chains = dict(many.chains)
        assert set(chains) == {(T, True), (T, False)}
        before = (many(None, T, warm=warm, x0_seq=seq),
                  many(sqp.x0, T, warm=warm))
        new = _drifted(sqp, seed=x)
        many.replan(new)
        got = (many(None, T, warm=warm, x0_seq=seq), many(sqp.x0, T),
               many(sqp.x0, T, warm=warm))
        assert many.chains == chains
        fresh = tt.make_stagewise_multistep(new, opts, backend="fused",
                                            scaling=many._scale)
        want = (fresh(None, T, warm=warm, x0_seq=seq), fresh(sqp.x0, T),
                fresh(sqp.x0, T, warm=warm))
        for g, w in zip(got, want):
            _same(g, w)
        for g, b in zip((got[0], got[2]), before):
            assert float((g[1] - b[1]).abs().max()) > 1e-6
    with pytest.raises(tt.DimensionError):
        many.replan(_sqp(5, 12, 12, 12, 9, seed=9))


@pytest.mark.cuda
def test_ticks_and_replays_make_no_host_sync(cuda):
    """An eager accurate plan tick, an eager fused stagewise warm tick
    (the top-up decided on the device) and a replay of each chain, under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    plan, opts, x0s, seq = _plan(batch=32)
    step = tt.make_plan_step(plan, opts, batched=True, seed_center=x0s,
                             accurate=True, accurate_rounds=2)
    many = tt.make_plan_multistep(plan, opts, seed_center=x0s,
                                  accurate_rounds=2)
    _, _, w = step(plan, seq[0], None)
    many(seq[:3], w)
    sqp = _sqp(12, 3, 2, 2, 17, seed=4)
    sopts = tt.SolverOptions(max_iter=5, early_exit=False, topup_iters=10)
    tick = make_stagewise_step(sqp, sopts, backend="fused")
    smany = tt.make_stagewise_multistep(sqp, sopts, backend="fused")
    _, _, _, sw = tick(sqp.x0)
    smany(None, 2, warm=sw, x0_seq=sqp.x0.expand(2, -1, -1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(plan, seq[1], w)
        many(seq[:3], w)
        tick(sqp.x0 + 0.01, sw)
        smany(None, 2, warm=sw, x0_seq=sqp.x0.expand(2, -1, -1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_with_the_top_up_flag_keeps_its_state(cuda, dtype):
    """K4/K5 with the flag set: the input state comes back unchanged, bit
    for bit, and the launch counts; with it clear: the tick as without the
    flag, bit for bit."""
    N, x, u, r, lanes = 12, 3, 2, 2, 33
    fp, x0, warm = _problem(N, x, u, r, lanes, seed=7)
    args = (fp.plan.to(dtype), x0.to(dtype), warm.to(dtype))
    kw = dict(n_iter=5, N=N, x=x, u=u, r=r, sigma=1e-6, alpha=1.6)
    one = torch.ones((), dtype=torch.int32, device="cuda")
    for entry in (sk.fused_stagewise_tick, sk.fused_stagewise_tick_streamed):
        warm1, work1 = entry(*args, **kw)
        before = entry.launches
        kept = entry(*args, **kw, work=work1, skip=one)
        assert entry.launches == before + 1
        assert torch.equal(kept[0], args[2]) and torch.equal(kept[1], work1)
        ran = entry(*args, **kw, work=work1, skip=0 * one)
        assert torch.equal(ran[0], warm1) and torch.equal(ran[1], work1)
    with pytest.raises(ValueError, match="work"):
        sk.fused_stagewise_tick(*args, **kw, skip=one)
    with pytest.raises(ValueError, match="int32"):
        sk.fused_stagewise_tick(*args, **kw, work=work1, skip=one.float())


@pytest.mark.cuda
def test_plant_that_cannot_be_captured_raises_naming_it(cuda):
    sqp = _sqp(12, 3, 2, 0, 5, seed=6)
    opts = tt.SolverOptions(max_iter=5, early_exit=False)

    def host_plant(xk, U):
        return xk + float(U.abs().max()) * 0.0      # a host sync

    many = tt.make_stagewise_multistep(sqp, opts, backend="fused",
                                       plant=host_plant)
    with pytest.raises(RuntimeError, match="host_plant"):
        many(sqp.x0, 2)


@pytest.mark.cuda
def test_replay_kernels_carry_their_graph_launch_correlation(cuda):
    """Under a CUDA-only ``torch.profiler``, every device op of one replay
    of a captured stagewise chain carries the correlation id of its
    ``cudaGraphLaunch``; a call of the chain issues that launch inside the
    program's ``copra.chain.replay`` span, on the profiler's clock; the
    tick's top-up counters move on the device with no capture counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from copra_tpu_torch import profiling

    sqp = _sqp(12, 3, 2, 2, 33, seed=15)
    opts = tt.SolverOptions(max_iter=8, early_exit=False, rho=0.3,
                            eps_abs=1e-8, topup_iters=20)
    many = tt.make_stagewise_multistep(sqp, opts, backend="fused")
    seq = sqp.x0[None].expand(2, -1, -1).contiguous()
    warm = many(None, 2, x0_seq=seq)[-1]
    torch.cuda.synchronize()
    chain = many.chains[(2, True)]

    def events(prof):
        evs = prof.profiler.kineto_results.events()
        ops = [e for e in evs if e.device_type() == DeviceType.CUDA]
        launches = [e for e in evs if e.device_type() != DeviceType.CUDA
                    and "cudaGraphLaunch" in e.name()]
        return ops, launches

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chain.graph.replay()
        torch.cuda.synchronize()
    ops, launches = events(prof)
    assert len(launches) == 1 and ops
    assert {e.correlation_id() for e in ops} == {
        launches[0].correlation_id()}
    assert any("stagewise_tick_kernel" in e.name() for e in ops)

    profiling.take_spans()
    before = profiling.counters()
    profiling.record(True)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            many(None, 2, warm=warm, x0_seq=seq)
            torch.cuda.synchronize()
    finally:
        profiling.record(False)
    spans = profiling.take_spans()
    after = profiling.counters()
    _, launches = events(prof)
    replay = [s for s in spans if s[0] == "copra.chain.replay"]
    assert len(launches) == 1 and len(replay) == 1
    assert replay[0][1] <= launches[0].start_ns() <= replay[0][2]
    assert after["chain.captures"] == before["chain.captures"]
    assert after["stagewise.ticks"] - before.get("stagewise.ticks", 0) == 2
    ran = after["stagewise.topups"] - before.get("stagewise.topups", 0)
    assert 0 <= ran <= 2
    assert 0 <= after["stagewise.topup_lanes"] - before.get(
        "stagewise.topup_lanes", 0) <= 33 * ran
