"""The port's span recorder and counters (``copra_tpu_torch.profiling``),
on the CPU: nothing recorded or entered while recording is off; names,
parents, call ids and nesting on ``time.time_ns()`` while it is on; the
set-up and serving spans of both multistep engines on their plain twins;
and the top-up counters of the fused stagewise tick against a recount
from the warm budget's statuses.  No JAX: the recount is the port's own
``solve_stagewise``.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import copra_tpu_torch as tt
from copra_tpu_torch import profiling
from copra_tpu_torch.ops import stagewise_kernel as sk
from copra_tpu_torch.qp import riccati as tr
from fixtures import A, B, D, M, N_MAT, SMALL_N, SMALL_X0, UD, WU, WX, XD

tt.set_default_device("cpu")


@pytest.fixture
def recording():
    profiling.take_spans()
    profiling.record(True)
    try:
        yield
    finally:
        profiling.record(False)
        profiling.take_spans()


def test_recorder_off_records_nothing_and_enters_nothing(monkeypatch):
    """Off, and with no torch profiler running, a span is one shared no-op
    context: no profiler region, no NVTX range, no record."""
    entered = []
    for mod, name in ((torch.profiler, "record_function"),
                      (torch._C._profiler, "_RecordFunctionFast"),
                      (torch.cuda.nvtx, "range_push")):
        monkeypatch.setattr(mod, name, lambda n: entered.append(n),
                            raising=False)
    profiling.record(False)
    profiling.take_spans()
    assert profiling.trace_span("a") is profiling.trace_span("b")
    with profiling.trace_span("copra.off"):
        with profiling.trace_span("copra.off.inner"):
            pass
    profiling.traced("copra.off.fn")(lambda: None)()
    assert entered == []
    assert profiling.take_spans() == []


def test_recorder_nests_spans_and_shares_call_ids(recording):
    """On: each span in the order it began, its parent's index, one call
    id per outermost span, times on ``time.time_ns()`` and nested inside
    their parents; a take empties the record."""
    @profiling.traced("copra.fn")
    def fn(k):
        with profiling.trace_span("copra.fn.inner"):
            return k + 1

    t0 = time.time_ns()
    with profiling.trace_span("copra.a"):
        with profiling.trace_span("copra.b"):
            pass
        assert fn(1) == 2
    fn(2)
    t1 = time.time_ns()
    spans = profiling.take_spans()
    assert profiling.take_spans() == []
    assert [s[0] for s in spans] == ["copra.a", "copra.b", "copra.fn",
                                     "copra.fn.inner", "copra.fn",
                                     "copra.fn.inner"]
    assert [s[3] for s in spans] == [-1, 0, 0, 2, -1, 4]
    calls = [s[4] for s in spans]
    assert calls[:4] == [calls[0]] * 4 and calls[4:] == [calls[4]] * 2
    assert calls[0] != calls[4]
    assert [s[1] for s in spans] == sorted(s[1] for s in spans)
    for name, start, end, parent, _ in spans:
        assert t0 <= start <= end <= t1, name
        if parent >= 0:
            assert spans[parent][1] <= start <= end <= spans[parent][2]


def _stagewise_fleet(lanes=3, bound=200.0):
    """The SmallSystem fixture as a stagewise fleet of ``lanes`` lanes,
    its control within ``+-bound``."""
    system = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    costs = (tt.TargetCost.create(M, XD, weights=WX),
             tt.ControlCost.create(N_MAT, UD, weights=WU))
    cons = (tt.ControlBoundConstraint.create([-bound], [bound]),)
    return tr.stack_stagewise([tr.from_mpc(system, costs, cons)],
                              repeats=lanes)


def _stagewise_case():
    sqp = _stagewise_fleet()
    opts = tt.SolverOptions(max_iter=20, early_exit=False, rho=0.1,
                            topup_iters=10)
    step_many = tt.make_stagewise_multistep(
        sqp, opts, cold_options=opts.replace(max_iter=200), backend="fused")
    seq = sqp.x0[None] + 0.01 * torch.arange(2.0)[:, None, None]

    def calls():
        warm = None
        for _ in range(2):
            warm = step_many(None, 2, warm=warm, x0_seq=seq)[-1]

    return calls, {"copra.make_stagewise_multistep"}, \
        "copra.stagewise_multistep"


def _plan_case():
    lanes, N = 3, 8
    rng = np.random.default_rng(5)
    As = np.broadcast_to(A, (lanes, N, 2, 2)) \
        + 1e-4 * rng.normal(size=(lanes, N, 2, 2))
    Bs = np.broadcast_to(B, (lanes, N, 2, 1)).copy()
    ds = np.broadcast_to(D, (lanes, N, 2)).copy()
    x0s = SMALL_X0 + rng.normal(scale=[0.02, 0.1], size=(lanes, 2))
    system = tt.LTVSystem(*(torch.tensor(a) for a in (As, Bs, ds, x0s)))
    costs = (tt.TargetCost.create(M, XD, weights=WX),
             tt.ControlCost.create(N_MAT, UD, weights=WU))
    cons = (tt.ControlBoundConstraint.create([-60.0], [60.0]),)
    plan = tt.make_control_plan(system, costs, cons)
    opts = tt.SolverOptions(max_iter=10, early_exit=False, polish=False,
                            rho=1.0, kkt_refine=0)
    rho = tt.auto_rho(plan, x0s, opts, seed_center=x0s, accurate=True)
    step_many = tt.make_plan_multistep(plan, opts.replace(rho=rho),
                                       seed_center=x0s)
    seq = torch.tensor(x0s)[None].expand(2, lanes, 2)

    def calls():
        warm = None
        for _ in range(2):
            warm = step_many(seq, warm)[-1]

    return calls, {"copra.make_control_plan", "copra.auto_rho",
                   "copra.make_plan_multistep"}, "copra.plan_multistep"


@pytest.mark.parametrize("case", [_stagewise_case, _plan_case],
                         ids=["stagewise_fused", "plan"])
def test_set_up_and_serving_spans_of_the_multistep_engines(recording,
                                                           case):
    """The set-up spans of an engine's build, then one ``copra.*`` entry
    span per serving call, outermost, with a call id of its own that every
    span inside it shares; the fused stagewise chain's first call holds
    the cold tick and each its copies out (no capture on the CPU)."""
    calls, setup_names, entry = case()
    setup = profiling.take_spans()
    outer = {s[0] for s in setup if s[3] == -1}
    assert setup_names <= outer
    if entry == "copra.stagewise_multistep":
        assert "copra.build_fused_plan" in {s[0] for s in setup}
    calls()
    spans = profiling.take_spans()
    tops = [i for i, s in enumerate(spans) if s[3] == -1]
    assert [spans[i][0] for i in tops] == [entry, entry]
    assert len({spans[i][4] for i in tops}) == 2
    for name, start, end, parent, call in spans:
        assert name.startswith("copra.") and end is not None
        top = parent
        while top >= 0 and spans[top][3] >= 0:
            top = spans[top][3]
        if parent >= 0:
            assert spans[top][4] == call
            assert spans[parent][1] <= start <= end <= spans[parent][2]
    children = [[s[0] for s in spans if s[3] == i] for i in tops]
    if entry == "copra.stagewise_multistep":
        assert children == [["copra.stagewise_tick", "copra.chain.copy_out"],
                            ["copra.chain.copy_out"]]
    assert not any(s[0] in ("copra.chain.capture", "copra.chain.replay")
                   for s in spans)


def _delta(before):
    after = profiling.counters()
    return tuple(after.get(k, 0) - before.get(k, 0)
                 for k in sk.TOPUP_COUNTERS)


def test_topup_counters_equal_the_warm_budget_recount():
    """Each fused tick adds (1, 1, lanes missed) where some lane misses
    the tolerance after the warm budget, and (1, 0, 0) where every lane
    converges; the lanes missed are recounted from the statuses of the
    port's ``solve_stagewise`` on the same warm start and budget."""
    # a binding bound and a short warm budget: the pushed lane misses by
    # ~800x the tolerance, the others are ~400x inside it
    sqp = _stagewise_fleet(4, bound=30.0)
    warm_opts = tt.SolverOptions(max_iter=6, early_exit=False, rho=0.1,
                                 eps_abs=1e-6)
    cold = warm_opts.replace(max_iter=400)
    tick = tr.make_stagewise_step(sqp, warm_opts.replace(topup_iters=30),
                                  cold_options=cold, backend="fused")
    x0 = sqp.x0.clone()
    _, _, _, warm = tick(x0)
    pushed = x0.clone()
    pushed[2, 1] += 0.5
    seen = []
    for state in (x0, pushed, x0):
        out = tr.solve_stagewise(dataclasses.replace(sqp, x0=state),
                                 warm_opts, warm_start=warm,
                                 return_warm=True)
        missed = int((out[2].status != tt.STATUS_SOLVED).sum())
        before = profiling.counters()
        _, _, _, warm = tick(state, warm)
        seen.append((_delta(before), missed))
    assert seen[0] == ((1, 0, 0), 0)
    assert seen[1][1] >= 1, "the pushed lane should miss the warm budget"
    for (ticks, topups, lanes_missed), missed in seen:
        assert ticks == 1 and topups == int(missed > 0)
        assert lanes_missed == missed
