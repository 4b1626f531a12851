#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``copra_tpu_torch``) on one GPU.

Drives the port's main paths through their public APIs at full width.
Phases, one line or more each:

1. the device, and ``nvidia-smi``'s name and power limit;
2. the build of every ``copra_tpu_torch/csrc/*.cu`` with nvcc, one process
   each, all started together;
3. the per-lane box-ADMM kernel against its plain PyTorch version on the
   card, in all three modes, on the real config-4 operators (2e-4 absolute
   after 30 f32 iterations, the reference's own kernel tolerance): per
   case the body that serves it with its registers and spills, the kernel
   by CUDA-graph replay and by eager calls, the plain version, the case's
   own bound and share of it and the cycles per iteration; the x0 = 0 and
   general cases again with each body forced;
4. BASELINE config 4, the fleet of ``bench.py`` (B = 4096 randomized LTV
   point-mass lanes, N = 100, a binding +-60 control bound, 30 ADMM
   iterations, 1 round, 20 timed ticks of drifting x0 after 2 warm-up
   ticks): the plan build, ``auto_rho`` and the serving ticks: solves/s,
   device ms per tick, kernel launches, converged share, and the served
   controls of lanes 0, 1, 17 and 4095 against the native f64 oracle
   (<= 1e-5, the library's accuracy contract);
5. the stagewise tick kernel against its plain version on the card, both
   entry points, on the config-5 and config-6 serving plans from a warm
   tuple of the serving path: float64 within 1e-9 (the reference's
   fused-vs-XLA tolerance), float32 within 1e-4 x max(1, max |plain|),
   with both times (the plain version timed once), the bound, the chain of
   2 N n_iter dependent stage steps and the cycles per step at the SM's
   maximum clock; the top-up flag in both dtypes (set: the launch returns
   the state it was given, bit for bit, as the plain version does; clear:
   the tick as without it) and the time of a launch with it set; then the
   same kernel on (3, 2, 0), (6, 2, 4) and (32, 32, 32) with small N and
   lane counts that are not multiples of 32;
6. config 6 (``bench_all.py``'s SRB quadruped: x = u = r = 12, N = 40,
   128 robots, equilibrated by ``stagewise_scales``, eps_abs 1e-4, rho
   0.1, 300 cold and 50 warm iterations with a 200-iteration top-up)
   served through ``make_stagewise_step(backend="fused")``: 2 warm-up and
   7 timed ticks of drifting x0, host and device ms per tick, launches,
   converged share, the status pass's time, and max_err_rel of lanes 0
   and 127 against the native f64 oracle (<= 1e-4);
7. config 5 (the bipedal ZMP preview of ``bench_all.py``: x = 3, u = 1,
   two ZMP rows per stage, N = 300, 256 robots = 512 lanes, eps_abs 1e-6,
   rho 1.0, 300 cold and 20 warm iterations with an 80-iteration top-up),
   the same fields, gated on lanes 0 and 1;
8. the shared box-ADMM kernel against its plain version on config 1's
   operators (n = 10) and the roofline fleet's (n = 256), B = 4096, with
   distinct non-zero c, x0, y0, z0: refine = 0 at the serving rho and
   refine = 1 at rho = 1.0 (at the serving rho f32 refinement parts two
   summation orders by cond(K) eps, see phase 3), within 2e-4 x max(1, max
   |plain|); kernel (a CUDA-graph replay, so no host dispatch; the eager
   calls' time beside it), plain and bound times, the body each case ran
   and its cycles per iteration at the SM's maximum clock; a yardstick at
   n = 256 (the same 31 products through ``torch.mm``, TF32 off: no single
   call computes the kernel's function, so it is not ``library_ms``); the
   two bodies timed against each other (graph replays) at n = 10, 16, 24
   and 32 (300 iterations, B = 4096: the crossover); the wide envelope
   held at n = 600 and 1024 (B = 64);
9. the shared general-ADMM kernel against its plain version on config 2's
   operators (B = 4096, 400 iterations, refine = 1) at the serving rho
   and at rho = 1.0, with distinct non-zero e0, y0, z0, the same
   tolerance and fields, each one's distance from the f64 iteration, and
   its f64-pipe bound beside the f32 bound; both bodies (group, wide)
   forced on the serving call and timed; the wide envelope held at
   (n, m) = (100, 400) and (256, 1024) (B = 64);
10. ``bench_all.py``'s config 1 (LTI double integrator, N = 10, B = 4096,
    +-2 control bounds, accurate tick, 300 iterations x 3 rounds, rho from
    ``auto_rho``) served on its shared plan: 2 warm-up and 5 timed ticks,
    lanes 0, 1, 17, 4095 and the worst 3 unconverged lanes gated against
    the native oracle (<= 1e-5);
11. ``bench.py``'s shared-plan roofline fleet (LTI point mass, N = 256, B =
    4096, the 75th-percentile bound, 2 rounds x 30 iterations): 2 + 20
    accurate ticks gated on lanes 0, 1, 17, 4095 (<= 1e-5); then the same
    fleet in f32 through the f32 fused tick (default ``use_fused``, the
    kernel's refine = 1 body, rho from ``auto_rho`` of that step), 2 + 5
    ticks: finite outputs, statuses 0 or 1 and kernel launches required,
    its oracle error and converged share printed ungated;
12. ``bench_all.py``'s config 2 (LTI N = 10, trajectory, control, mixed and
    bound constraints, B = 4096, 400 iterations) served through
    ``make_plan_step(use_fused=True)`` after ``auto_rho(use_fused=True)``:
    2 + 5 ticks gated like config 1; the same ticks through
    ``use_fused=False`` (the plain general step on the card) printed
    beside them, ungated;
13. config 4 in f32 through the f32 fused tick (default ``use_fused``: the
    per-lane kernel's general body; rho from ``auto_rho`` of that step, as
    ``bench.py``'s plan mode): the kernel against its plain version at the
    serving rho and refine 0, and at refine 1 on rho = 1.0 operators, timed
    as in phase 3; then 2 + 5 ticks: finite outputs, statuses 0 or 1 and
    launches required, its oracle error printed;
14. the batched Cholesky kernel against its plain version and the
    library: float32 at (B = 4096, n = 10) on config 1's ``K = Q + (sigma
    + rho) I`` (one penalty per lane, spread over [rho, 2 rho]) and at (B =
    4096, n = 100) on config 4's per-lane ``K``; float64 at (B = 16, n =
    24) on a spectrum spread 1e-6..1e4; the envelope's edge, n = 128 at B =
    1024 in float32 and float64: ``max |L - L_plain| <= 2e-5 max |L|`` in
    float32 and 1e-9 in float64, ``max |L L' - K| / max |K|`` <= 1e-5 and
    1e-12, and each ``K`` with garbage in its strict upper triangle giving
    the same ``L``; kernel times by CUDA-graph replay and eager, plain,
    ``torch.linalg.cholesky`` and ``cholesky_ex`` times, the bound (lower
    triangle read, L written), the kernel's registers, spills and blocks
    an SM, and its cycles a column on the first 1, 2, ... blocks an SM of
    matrices;
15. the per-lane general ADMM kernel against its plain version at full
    width: config 2's costs and constraints on per-lane LTV dynamics (A and
    B perturbed by 1e-3 per lane, so every lane has its own ``C``), B =
    4096, n = 10, m = 85, 400 iterations, distinct non-zero x0, y0, z0,
    within 2e-4 x max(1, max |plain|); then the kernels served: ``K`` per
    lane factorized by ``chol_batched``, ``Kinv`` from the factor, and 2 +
    5 warm-started ticks of ``fused_admm_general`` on drifting states, the
    first (cold) tick held against the port's ``solve_qp_batched`` at the
    fixed-count settings on the card (1e-3 x max(1, max |x|)), the last
    tick's error against the native oracle printed.  The kernel is timed
    by CUDA-graph replay and eagerly, with its body, cycles an iteration
    (also on the first 1, 2, ... blocks an SM of lanes), share of its
    bound, registers, spills and blocks an SM, and the wide body forced at
    the same shape; then its wide envelope, per-lane
    problems at (B, n, m) = (64, 100, 400) and (16, 256, 1024), 30
    iterations, against the plain version;
16. the general solver served: the same per-lane fleet through
    ``solve_mpc_batch`` with default ``SolverOptions`` (early exit,
    adaptive rho, polish) in float64, lanes 0, 1, 17, 4095 gated against
    the native oracle (<= 1e-5), converged share, host and device ms per
    solve; then in float32, error printed, not gated;
17. ``bench.py``'s ``fused`` mode on the config-4 fleet: per tick
    ``condense`` -> ``build_qp`` -> ``solve_qp_batched_fused`` with warm
    starts (B = 4096, N = 100, 30 iterations), 2 + 5 ticks: solves/s, host
    and device ms per tick, ``fused_admm_box`` launches required, oracle
    error printed (not gated).  Then two polished calls at B = 256: on the
    config-4 lanes, printed ungated (a float32 LU of the 1e8-conditioned
    Hessian cannot place the free coordinates to 1e-4), and on
    well-conditioned random box QPs of the same width (n = 100, the class
    of the reference's own polished-fused test), gated <= 1e-4;
18. the facade: ``bench_all.py`` config 8's controller (``LMPC``, LTI N =
    100, target and control costs, a +-60 bound) in float64: ``solve()``,
    then 5 ``set_initial_state`` + ``solve(warm_start=True)``, and the same
    drive through ``LMPC(system, solver="active_set")``: max |control -
    control_exact| <= 1e-5.  Then float32 budgets of 2, 5, 20 and 50 ms
    through ``max_wall_time_ms``: ``deadline_info()`` and the measured
    median wall per solve, printed;
19. config 4's fleet at horizon N = 300 (B = 512 per-lane plans of width
    300, the per-lane kernel's streamed body; 2 rounds): plan, ``auto_rho``
    and 2 + 5 accurate ticks, lanes 0, 1, 17, 511 gated against the native
    oracle (<= 1e-5); phase 3's cases at this width (2e-4 x max(1, max
    |plain|)), and ``fused_admm_box`` at refine 1 on the plan's rho = 1.0
    operators against its plain version;
20. config 4 chained: phase 4's fleet, step and drifting states through
    ``make_plan_multistep``, 20 ticks a CUDA graph from the warm state of
    phase 4's warm-up ticks: one eager tick and one replay under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), the
    chained controls against the eager per-tick loop (<= 1e-12), the last
    tick against the native oracle on lanes 0, 1, 17, 4095 (<= 1e-5);
    host and device ms per tick over 5 replays, the capture's seconds,
    the launches a replay and a profile of one replay (kernel time by
    name, the kernels' busy time against the span: the idle share);
21. configs 6 and 5 chained through ``make_stagewise_multistep``
    (``backend="fused"``, the served options and scales), 9 ticks a CUDA
    graph: the ``x0_seq`` chain of phases 6/7's states, held against the
    eager per-tick ticks (<= 1e-4 x max(1, max |U|)) and gated at the last
    state against the native oracle (max_err_rel <= 1e-4), with one eager
    warm tick and one replay under the sync check; the plant mode from a
    cold start, gated at the last state it solved (<= 1e-4); a replan (a
    5% drift of the linear state costs) held against a fresh facade on the
    new data with no new capture; host and device ms per tick, the
    capture's seconds, launches a replay, a profile of one replay, the
    status pass's ms (eager and by graph replay) and the ticks whose
    top-up ran;
22. the log-depth forms on the card against their serial forms in float64
    (relative 1e-9), each timed beside it: ``condense_ltv_assoc`` at
    config 4's width, ``lqr_solve_assoc`` with the rows' cross term at
    config 5's (512 lanes, N = 300) and the parallel dual residual there;
23. the early-exit solve on the kernels: ``solve_stagewise`` with
    ``early_exit=True`` on the card (chunks of 10 iterations, one launch
    each, the proximal centre carried; K4 at config 5's shape, K5 at
    config 6's, equilibrated; 2 lanes, 150 iterations at most) in float64
    and float32 against the plain early-exit loop on CPU copies: the same
    per-lane iterations and statuses, X and U within 1e-9 relative
    (float64) and 1e-4 (float32); launches and ms;
24. the f64 polish: one float64 K4 launch of 60 iterations from config
    1's delivered float32 state (B = 4096, N = 10) against its plain
    version (1e-9 relative), its time by graph replay and its f64 bound;
    then config 1's fused stagewise line (``bench_all.py:
    _stagewise_line``): ``auto_rho_stagewise`` (8 probe lanes, 0.003 to
    3.0, 200 iterations) and ``auto_iters_stagewise`` (50 to 800, both
    targets 3e-5) with their probes and seconds, then ticks with the 60
    polish iterations and a top-up of twice the warm budget, per tick and
    chained through ``make_stagewise_multistep`` with the polish captured,
    both gated on lanes 0, 1, 17, 4095 and the worst 3 against the native
    oracle (<= 1e-5);
25. the measured policies at configs 5 and 6 (``bench_all.py``'s calls)
    beside the hand constants of phases 6, 7 and 21, with their Pareto and
    seconds; then ``make_stagewise_server`` on config 6's fleet (128
    robots): set-up seconds, 2 + 7 ticks, ms per tick, gated on lanes 0
    and 127 (max_err_rel <= 1e-4);
26. ``solve`` with no options on four routes, each gated against the
    native oracle at 1e-5 relative: config 8's problem on the condensed
    route (N = 100, float64), the automatic stagewise route at N = 400
    (K4's early-exit solves), the direct LQR route (``iterations == 1``)
    and float32 data routed to the native engine; ms per solve.

Every served path runs with the launch counts set to 0 just before it and
read just after, and fails if its kernel was never launched.  A chain's
kernel launches are counted as the card runs them: the run before its
capture, then the capture's launches once a replay.  The line
before the last is the kernels' JSON record: per kernel its source, the
TPU kernel it replaces, launches on its served paths, its distance from
its plain version, its time, the plain version's, and its bound (the
larger of its operations over the 67 TFLOP/s f32 peak and its bytes, each
input read once and each output written once, over 3.35 TB/s); the last
line is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero, as
does a run without a CUDA device or outside the repository.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

BATCH, HORIZON, ITERS, ROUNDS, TICKS, BOUND = 4096, 100, 30, 1, 20, 60.0
KERNEL_TOL = 2e-4
ORACLE_TOL = 1e-5
KERNEL_SOURCE = "copra_tpu_torch/csrc/admm_box.cu"
REPLACES = "copra_tpu/ops/admm_kernel.py:601"

# the stagewise serving paths (phases 5-7)
STAGEWISE_SOURCE = "copra_tpu_torch/csrc/stagewise_tick.cu"
STAGEWISE_REPLACES = {"fused_stagewise_tick":
                      "copra_tpu/ops/stagewise_kernel.py:418",
                      "fused_stagewise_tick_streamed":
                      "copra_tpu/ops/stagewise_kernel.py:791"}
F64_TOL = 1e-9        # kernel vs plain, float64
F32_RTOL = 1e-4       # kernel vs plain, float32, times max(1, max |plain|)
REL_TOL = 1e-4        # served controls vs the native oracle, relative
WARMUP_TICKS, TIMED_TICKS = 2, 7
QUAD_ROBOTS, QUAD_N = 128, 40
# the tick kernel on more of its envelope, (N, x, u, r, lanes): the
# reference's box-only test shape, a resident-class shape, and a wide shape
# whose float64 ring is near the shared-memory limit
ENVELOPE_SHAPES = ((17, 3, 2, 0, 37), (12, 6, 2, 4, 45), (8, 32, 32, 32, 9))
ZMP_ROBOTS, ZMP_N, ZMP_T = 256, 300, 0.005

# the shared-plan paths (phases 8-13)
SHARED_SOURCE = "copra_tpu_torch/csrc/admm_box_shared.cu"
GENERAL_SOURCE = "copra_tpu_torch/csrc/admm_general_shared.cu"
REPLACES_K2 = "copra_tpu/ops/admm_kernel.py:225"
REPLACES_K3 = "copra_tpu/ops/admm_kernel.py:776"
REPLACES_K6 = "copra_tpu/ops/admm_kernel.py:889"
FLEET = 4096
C1_N, C1_ITERS, C1_ROUNDS = 10, 300, 3
ROOF_N, ROOF_ITERS, ROOF_ROUNDS, ROOF_TICKS = 256, 30, 2, 20
C2_N, C2_ITERS = 10, 400
SHORT_TICKS = 5
# the shared kernels beyond the served shapes: the box kernel's two bodies
# timed against each other (B = 4096, 300 iterations), and the wide
# envelope of both kernels at B = 64
CROSSOVER_N, CROSSOVER_ITERS = (10, 16, 24, 32), 300
WIDE_B, BOX_WIDE_N, GENERAL_WIDE = 64, (600, 1024), ((100, 400), (256, 1024))
# one H100 SXM (NVIDIA's data sheet): f32 and f64 outside the tensor cores,
# HBM3
F32_PEAK, F64_PEAK, HBM_RATE = 67e12, 34e12, 3.35e12

# the general solver and the facade (phases 14-18)
ADMM_GENERAL_SOURCE = "copra_tpu_torch/csrc/admm_general.cu"
CHOL_SOURCE = "copra_tpu_torch/csrc/chol_batched.cu"
REPLACES_K7 = "copra_tpu/ops/admm_kernel.py:999"
REPLACES_K8 = "copra_tpu/ops/cholesky_kernel.py:77"
# the per-lane general kernel beyond the served shape, (B, n, m)
LANES_GENERAL_WIDE = ((64, 100, 400), (16, 256, 1024))
CHOL_F32_RTOL, CHOL_F32_REC = 2e-5, 1e-5
CHOL_EDGE_B, CHOL_EDGE_N = 1024, 128
CHOL_F64_TOL, CHOL_F64_REC = 1e-9, 1e-12
SOLVER_TOL = 1e-3     # K7 vs solve_qp_batched, times max(1, max |x|)
POLISHED_TOL = 1e-4   # polished fused solve vs the native oracle
POLISH_LANES = 256
FACADE_N, FACADE_TICKS = 100, 5
BUDGETS_MS = (2.0, 5.0, 20.0, 50.0)

# the per-lane accurate tick at a width the register body does not take
# (phase 19): config 4's fleet at horizon 300, 2 rounds (one leaves the
# f32 correction floor above the 1e-5 contract at this horizon)
WIDE_LANES, WIDE_HORIZON, WIDE_ROUNDS = 512, 300, 2

# the no-knobs layer (phases 23-26): the early-exit route's iteration cap
# against the plain loop, and config 1's polish (bench_all.py's 60)
EE_ITERS, POLISH_ITERS = 150, 60


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def build_fleet(batch: int, horizon: int):
    """``bench.py``'s config-4 fleet (``_build_workload`` and its drift):
    returns the f32 system arrays, x0s and the tick states x0_seq."""
    T, mass = 0.005, 5.0
    A = np.array([[1.0, T], [0.0, 1.0]])
    B = np.array([[0.5 * T * T / mass], [T / mass]])
    d = np.array([-9.81 / 2.0 * T * T, -9.81 * T])
    rng = np.random.default_rng(0)
    As = np.repeat(np.repeat(A[None], horizon, 0)[None], batch, 0)
    As += rng.normal(scale=1e-4, size=As.shape)
    Bs = np.repeat(np.repeat(B[None], horizon, 0)[None], batch, 0)
    ds = np.repeat(np.repeat(d[None], horizon, 0)[None], batch, 0)
    x0s = np.array([0.0, -1.5])[None] + rng.normal(
        scale=[0.02, 0.1], size=(batch, 2))
    drift = np.zeros((TICKS + 2, batch, 2))
    drift[:, :, 1] = np.cumsum(
        rng.normal(scale=0.02, size=(TICKS + 2, batch)), axis=0)
    x0_seq = (x0s[None] + drift).astype(np.float32)
    arrays = [a.astype(np.float32) for a in (As, Bs, ds, x0s)]
    return arrays, x0s, x0_seq


def build_serving(tt, device, batch: int, horizon: int, iters: int,
                  rounds: int = ROUNDS):
    """Plan, measured rho and accurate step, as ``bench.py`` builds them."""
    import torch

    arrays, x0s, x0_seq = build_fleet(batch, horizon)
    t0 = time.perf_counter()
    system = tt.LTVSystem(*(torch.tensor(a, device=device) for a in arrays))
    costs = (tt.TargetCost.create(np.eye(2), [0.0, -1.0],
                                  weights=[10.0, 1e4]),
             tt.ControlCost.create([[1.0]], [2.0], weights=[1e-4]))
    constraints = (tt.ControlBoundConstraint.create([-BOUND], [BOUND]),)
    plan = tt.make_control_plan(system, costs, constraints)
    opts = tt.SolverOptions(max_iter=iters, early_exit=False, polish=False,
                            rho=1.0, kkt_refine=0)
    opts = opts.replace(rho=tt.auto_rho(plan, x0s, opts, seed_center=x0s,
                                        accurate=True,
                                        accurate_rounds=rounds))
    step = tt.make_plan_step(plan, opts, batched=True, seed_center=x0s,
                             accurate=True, accurate_rounds=rounds)
    if device.type == "cuda":
        torch.cuda.synchronize()
    x0_dev = [torch.tensor(x, device=device) for x in x0_seq]
    return plan, opts, step, x0_dev, time.perf_counter() - t0


def gate_vs_oracle(tt, plan, u, x0_last, lanes):
    """Max |u - exact| over ``lanes``, exact from the native f64 oracle of
    each lane's QP (f64 linear term from the f32 plan data)."""
    from copra_tpu_torch.plan import _slice_plan

    errs = []
    for lane in lanes:
        qp = tt.plan_qp(_slice_plan(plan, lane),
                        np.asarray(x0_last[lane], np.float64))
        exact = tt.solve_qp_native(qp).x.numpy()
        errs.append(float(np.abs(u[lane].cpu().numpy() - exact).max()))
    return max(errs)


def run_ticks(step, plan, x0_dev, ticks: int):
    """2 warm-up ticks then ``ticks`` timed ones; returns the last
    controls, the converged share, host and device ms per tick, and the
    host's ms per tick to issue them (before the closing synchronize: where
    it is near the device's, the host sets the pace)."""
    import torch

    cuda = x0_dev[0].is_cuda
    warm = None
    converged = torch.zeros((), dtype=torch.int64, device=x0_dev[0].device)
    for t in range(2):
        u, sol, warm = step(plan, x0_dev[t], warm)
        # the warm-up runs every op the timed loop runs: the first use of a
        # CUDA kernel loads its module (measured ~45 ms on an H100 host)
        converged += (sol.status == 0).sum()
    converged.zero_()
    if cuda:
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    t0 = time.perf_counter()
    for t in range(ticks):
        u, sol, warm = step(plan, x0_dev[2 + t], warm)
        converged += (sol.status == 0).sum()
    issue_ms = (time.perf_counter() - t0) * 1e3 / ticks
    if cuda:
        ev1.record()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / ticks
    dev_ms = ev0.elapsed_time(ev1) / ticks if cuda else float("nan")
    share = float(converged) / (ticks * u.shape[0])
    return u, sol, share, host_ms, dev_ms, issue_ms


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device ms of one ``fn()`` without its host dispatch: ``reps`` calls
    captured in one CUDA graph, the replay timed by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / reps
    del graph
    return ms


def _max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def kernel_vs_plain(ak, step, plan, opts, x0_first):
    """Each kernel mode against the plain version on the same card.

    The x0 = 0 body and the Q x pass run on the serving operators.  The
    general body's refinement step computes ``rhs - K x`` in f32, whose
    rounding ``Kinv`` amplifies by cond(K) (~5e3 at the serving rho ~1e-4),
    so two f32 implementations that sum in different orders part by ~1e-2
    there whatever their quality.  It is held to the tolerance on the same
    plan's Hessians at rho = 1.0 (``SolverOptions``' value before
    ``auto_rho``, cond(K) ~2), as the reference's own kernel test holds it
    on well-conditioned operators; at the serving rho its distance from the
    f64 iteration is printed beside the plain version's, untested.

    Each case is timed eagerly and by CUDA-graph replay (no host
    dispatch); the x0 = 0 and general cases also with each body that takes
    the width forced (graph replay).  Returns ``({case: (err, ms, graph_ms,
    plain_ms, kernel_vs_f64, plain_vs_f64, body, max |plain|)}, {(case,
    body): (err, graph_ms, max |plain|)})``.
    """
    import torch

    from copra_tpu_torch.plan import _box_fast_state

    Kinv, K, seed = step.state
    f32, f64 = torch.float32, torch.float64
    n = Kinv.shape[-1]
    xs64 = seed.u0 + ((x0_first.to(f64) - seed.x0c).unsqueeze(-2)
                      @ seed.Umap).squeeze(-2)
    l = (plan.lb.to(f64) - xs64).to(f32)
    u = (plan.ub.to(f64) - xs64).to(f32)
    zero = torch.zeros_like(l)
    wz = torch.clamp(zero, l, u)
    sc = dict(sigma=opts.sigma, alpha=opts.alpha, rho=opts.rho)
    first = ak.admm_box_plain(Kinv, K, zero, l, u, zero, zero, wz,
                              n_iter=ITERS, assume_x0_zero=True, **sc)
    e, y, z = first[0], first[1], first[2]
    sc1 = dict(sc, rho=1.0)
    Kinv1, K1 = (t.to(f32).contiguous() for t in
                 _box_fast_state(plan, opts.replace(rho=1.0)))
    general = ((zero, l, u, e, y, z), dict(n_iter=ITERS, refine=1))
    cases = {
        # the first tick's K-free iteration (cold duals)
        "x0_zero": (Kinv, K, (zero, l, u, zero, zero, wz),
                    dict(n_iter=ITERS, assume_x0_zero=True), sc),
        # the status pass: g = Q s for a correction-sized s
        "qx": (Kinv, K, (zero, l, u, e, zero, zero), dict(n_iter=0), sc),
        # the general body restarted from distinct non-zero (x, y, z)
        "general": (Kinv1, K1, *general, sc1),
        "general_at_serving_rho": (Kinv, K, *general, sc),
    }
    out, bodies = {}, {}
    for name, (Ki, Ko, vecs, kw, s) in cases.items():
        run = lambda: ak.fused_admm_box_lanes(Ki, Ko, *vecs, **kw, **s)
        got = run()
        want = ak.admm_box_plain(Ki, Ko, *vecs, **kw, **s)
        exact = ak.admm_box_plain(Ki.to(f64), Ko.to(f64),
                                  *(v.to(f64) for v in vecs), **kw, **s)
        torch.cuda.synchronize()
        for g in got:
            if tuple(g.shape) != (Ki.shape[0], n) or \
                    not bool(torch.isfinite(g).all()):
                fail(f"kernel mode {name}: bad output")
        mode = ak.kernel_mode(kw["n_iter"], kw.get("refine", 0),
                              kw.get("assume_x0_zero", False))
        body = _LANES_BODY[ak.box_lanes_config(n, mode,
                                               kw.get("refine", 0))[0]]
        plain_ms = _cuda_ms(lambda: ak.admm_box_plain(Ki, Ko, *vecs, **kw,
                                                      **s), 5)
        scale = max(float(w.abs().max()) for w in want)
        out[name] = (_max_diff(got, want), _cuda_ms(run, 20),
                     _graph_ms(run, 20), plain_ms, _max_diff(got, exact),
                     _max_diff(want, exact), body, scale)
        if name in ("x0_zero", "general"):
            full = {"refine": 0, "assume_x0_zero": False, **kw}
            for body in ("register", "streamed"):
                if body == "register" and n > ak.BOX_REGISTER_MAX_N:
                    continue
                forced = lambda: ak._launch(Ki, Ko, *vecs, body=body, **full,
                                            **s)
                err = _max_diff(forced(), want)
                bodies[(name, body)] = (err, _graph_ms(forced, 20), scale)
    return out, bodies


_LANES_BODY = {1: "register", 2: "streamed", 3: "qx"}
# box_work's body of each phase-3 case, and its (n_iter, refine)
_CASE_WORK = {"x0_zero": ("x0_zero", ITERS, 0), "qx": ("qx", 0, 0),
              "general": ("general", ITERS, 1),
              "general_at_serving_rho": ("general", ITERS, 1)}


def report_box_lanes(ak, label, modes, bodies, B, n, sm_hz, relative=False):
    """Prints phase 3's cases (or the same cases at another width): per
    case the body, its registers and spills, the error against the plain
    version, eager and graph-replay ms, the plain version's ms, the case's
    own bound, the share of the bound and the cycles per iteration; fails
    on a held case that disagrees (by KERNEL_TOL, times max(1, max
    |plain|) where ``relative``).  Returns the held cases' largest
    error."""
    worst = 0.0
    tol_of = lambda scale: KERNEL_TOL * (max(1.0, scale) if relative
                                         else 1.0)
    for name, (err, ms, graph_ms, plain_ms, k64, p64, body,
               scale) in modes.items():
        work, n_iter, refine = _CASE_WORK[name]
        bnd = bound(*box_work(B, n, n_iter, refine, work, per_lane=True))
        mode = ak.kernel_mode(n_iter, refine, work == "x0_zero")
        regs, spill, _, per_sm = ak._box_lanes_attributes(n, mode, refine)
        held = name != "general_at_serving_rho"
        per = (f"{graph_ms * 1e-3 * sm_hz / n_iter:.0f} cycles per "
               f"iteration" if n_iter else "one pass")
        tol = tol_of(scale)
        print(f"kernel {name} ({label}, B = {B}, n = {n}, {body} body, "
              f"{regs} registers, {spill} bytes of spills, {per_sm} blocks "
              f"an SM): max_abs_err "
              f"{err:.3e} ({f'tol {tol:.3e}' if held else 'not held'}); "
              f"kernel {graph_ms:.4f} ms (CUDA-graph replay; eager calls "
              f"{ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), {bnd[0] / graph_ms:.1%} of the bound, {per} at "
              f"{sm_hz / 1e6:.0f} MHz; distance from the f64 iteration: "
              f"kernel {k64:.3e}, plain {p64:.3e}")
        if held:
            worst = max(worst, err)
            if not err <= tol:
                fail(f"kernel mode {name} ({label}) disagrees with the plain "
                     f"version")
    for (name, body), (err, graph_ms, scale) in bodies.items():
        work, n_iter, refine = _CASE_WORK[name]
        print(f"kernel {name} ({label}), {body} body forced: {graph_ms:.4f} "
              f"ms (CUDA-graph replay), {graph_ms * 1e-3 * sm_hz / n_iter:.0f}"
              f" cycles per iteration, max_abs_err {err:.3e}")
        worst = max(worst, err)
        if not err <= tol_of(scale):
            fail(f"kernel {name} ({label}, {body} body) disagrees with the "
                 f"plain version")
    return worst


# ---------------------------------------------------------------------------
# The stagewise paths: data builders (numpy copies of the reference's
# examples/bipedal_walking.py and bench_all.py builders; the card's host has
# no JAX), the exact oracles, and phases 5-7.
# ---------------------------------------------------------------------------

GRAVITY = 9.81


def lipm_system(T: float, com_height: float):
    """Triple-integrator per-axis dynamics + ZMP output row
    (``examples/bipedal_walking.py:lipm_system``)."""
    A = np.array([[1.0, T, T * T / 2.0],
                  [0.0, 1.0, T],
                  [0.0, 0.0, 1.0]])
    B = np.array([[T ** 3 / 6.0], [T * T / 2.0], [T]])
    d = np.zeros(3)
    zmp_row = np.array([[1.0, 0.0, -com_height / GRAVITY]])
    return A, B, d, zmp_row


def footstep_plan(n_steps: int, horizon: int, T: float,
                  step_length: float = 0.2, step_width: float = 0.1,
                  step_duration: float = 0.8, margin: float = 0.05):
    """Reference ZMP and support-polygon bounds for axes (x, y), each
    ``[2, horizon + 1]`` (``examples/bipedal_walking.py:footstep_plan``)."""
    ticks = horizon + 1
    per_step = int(round(step_duration / T))
    ref = np.zeros((2, ticks))
    for k in range(ticks):
        idx = min(k // per_step, n_steps - 1)
        ref[0, k] = idx * step_length
        ref[1, k] = (step_width if idx % 2 else -step_width) \
            if idx > 0 else 0.0
    return ref, ref - margin, ref + margin


def srb_quadruped(N: int = QUAD_N, dt: float = 0.025):
    """Single-rigid-body quadruped MPC (``bench_all.py:_srb_quadruped``):
    x = 12, u = 12 ground-reaction forces, r = 12 friction rows per stage,
    LTV over the gait.  Returns the f32 fields of one robot's problem."""
    m, g, mu, h = 25.0, 9.81, 0.6, 0.3
    Ibinv = np.linalg.inv(np.diag([0.35, 1.2, 1.3]))
    Ac = np.zeros((12, 12))
    Ac[0:3, 6:9] = np.eye(3)
    Ac[3:6, 9:12] = np.eye(3)
    Ad = np.eye(12) + Ac * dt
    feet0 = np.array([[0.22, 0.15, -h], [0.22, -0.15, -h],
                      [-0.22, 0.15, -h], [-0.22, -0.15, -h]])
    As, Bs = [], []
    for k in range(N):
        phase = 2 * np.pi * k / N
        Bk = np.zeros((12, 12))
        for leg in range(4):
            r_i = feet0[leg] + np.array(
                [0.04 * np.sin(phase + leg * np.pi / 2), 0.0, 0.0])
            rx = np.array([[0, -r_i[2], r_i[1]],
                           [r_i[2], 0, -r_i[0]],
                           [-r_i[1], r_i[0], 0]])
            Bk[6:9, 3 * leg:3 * leg + 3] = Ibinv @ rx * dt
            Bk[9:12, 3 * leg:3 * leg + 3] = np.eye(3) / m * dt
        As.append(Ad)
        Bs.append(Bk)
    dk = np.zeros(12)
    dk[11] = -g * dt
    x_ref = np.zeros(12)
    x_ref[5] = h
    x_ref[9] = 0.4
    w = np.array([50.0, 50, 10, 10, 10, 100, 1, 1, 1, 5, 5, 5])
    Qx = np.repeat(np.diag(w)[None], N + 1, 0)
    Qx[-1] *= 10.0
    qx = np.repeat((-w * x_ref)[None], N + 1, 0)
    qx[-1] *= 10.0
    xlb = np.full((N + 1, 12), -np.inf)
    xub = np.full((N + 1, 12), np.inf)
    xlb[:, 0:3], xub[:, 0:3] = -0.4, 0.4
    xlb[:, 5], xub[:, 5] = 0.2, 0.4
    Cu1 = np.zeros((12, 12))
    for leg in range(4):
        c0 = 3 * leg
        Cu1[c0 + 0, c0 + 0], Cu1[c0 + 0, c0 + 2] = 1.0, -mu
        Cu1[c0 + 1, c0 + 0], Cu1[c0 + 1, c0 + 2] = -1.0, -mu
        Cu1[c0 + 2, c0 + 1], Cu1[c0 + 2, c0 + 2] = 1.0, -mu
    x0 = x_ref.copy()
    x0[9] = 0.0
    fields = dict(
        A=np.asarray(As), B=np.asarray(Bs), d=np.repeat(dk[None], N, 0),
        Qx=Qx, qx=qx, Ru=np.repeat((1e-5 * np.eye(12))[None], N, 0),
        ru=np.zeros((N, 12)), x0=x0, xlb=xlb, xub=xub,
        ulb=np.tile(np.array([-150.0, -150.0, 0.0]), (N, 4)),
        uub=np.tile(np.array([150.0, 150.0, 250.0]), (N, 4)),
        Cx=np.zeros((N, 12, 12)), Cu=np.repeat(Cu1[None], N, 0),
        clo=np.full((N, 12), -np.inf), chi=np.zeros((N, 12)))
    return {k: v.astype(np.float32) for k, v in fields.items()}


def stagewise_exact(tt, f):
    """Exact f64 solution ``U [N, u]`` of one stagewise problem (numpy
    fields ``f``): condensed in f64 and solved by the native active-set
    oracle (``bench_all.py:_stagewise_exact_native``)."""
    g = {k: (None if v is None else np.asarray(v, np.float64))
         for k, v in f.items()}
    A, B, d, x0 = g["A"], g["B"], g["d"], g["x0"]
    N, x, u = A.shape[0], A.shape[1], B.shape[2]
    nU = N * u
    Psi = np.zeros((N + 1, x, nU))
    xi = np.zeros((N + 1, x))
    Phi = np.zeros((N + 1, x, x))
    Phi[0] = np.eye(x)
    for k in range(N):
        Phi[k + 1] = A[k] @ Phi[k]
        Psi[k + 1] = A[k] @ Psi[k]
        Psi[k + 1][:, k * u:(k + 1) * u] += B[k]
        xi[k + 1] = A[k] @ xi[k] + d[k]
    xoff = Phi @ x0 + xi
    Q = np.zeros((nU, nU))
    c = np.zeros(nU)
    for k in range(N + 1):
        Q += Psi[k].T @ g["Qx"][k] @ Psi[k]
        c += Psi[k].T @ (g["Qx"][k] @ xoff[k] + g["qx"][k])
    for k in range(N):
        sl = slice(k * u, (k + 1) * u)
        Q[sl, sl] += g["Ru"][k]
        c[sl] += g["ru"][k]
    rows, lo_, hi_ = [], [], []
    for k in range(1, N + 1):
        for i in range(x):
            if np.isfinite(g["xub"][k, i]) or np.isfinite(g["xlb"][k, i]):
                rows.append(Psi[k][i])
                lo_.append(g["xlb"][k, i] - xoff[k, i])
                hi_.append(g["xub"][k, i] - xoff[k, i])
    if g.get("Cx") is not None:
        for k in range(N):
            Crow = g["Cx"][k] @ Psi[k]
            Crow[:, k * u:(k + 1) * u] += g["Cu"][k]
            off = g["Cx"][k] @ xoff[k]
            for j in range(g["Cx"].shape[1]):
                rows.append(Crow[j])
                lo_.append(g["clo"][k, j] - off[j])
                hi_.append(g["chi"][k, j] - off[j])
    Arows = np.asarray(rows) if rows else np.zeros((0, nU))
    lo_, hi_ = np.asarray(lo_), np.asarray(hi_)
    fin_lo, fin_hi = np.isfinite(lo_), np.isfinite(hi_)
    qp = tt.DenseQP(Q=Q, c=c, Aeq=np.zeros((0, nU)), beq=np.zeros(0),
                    Aineq=np.concatenate([Arows[fin_hi], -Arows[fin_lo]]),
                    bineq=np.concatenate([hi_[fin_hi], -lo_[fin_lo]]),
                    lb=g["ulb"].ravel(), ub=g["uub"].ravel())
    return tt.solve_qp_native(qp).x.numpy().reshape(N, u)


def zmp_exact(tt, A, B, d, zmp_row, ref_ax, lo_ax, hi_ax, x0,
              zmp_w=1.0, jerk_w=1e-6, ridge=1e-6):
    """Exact f64 controls ``U [N]`` of one ZMP axis: condensed in f64, ZMP
    rows as inequality pairs, native active-set solve
    (``bench_all.py:_zmp_exact``)."""
    N = len(ref_ax) - 1
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)[:, 0]
    d = np.asarray(d, np.float64)
    x = A.shape[0]
    Phi = np.zeros((N + 1, x, x))
    Psi = np.zeros((N + 1, x, N))
    xi = np.zeros((N + 1, x))
    Phi[0] = np.eye(x)
    for k in range(1, N + 1):
        Phi[k] = A @ Phi[k - 1]
        Psi[k] = A @ Psi[k - 1]
        Psi[k][:, k - 1] += B
        xi[k] = A @ xi[k - 1] + d
    z_row = np.asarray(zmp_row, np.float64).ravel()
    Zphi = np.einsum("x,kxy->ky", z_row, Phi)
    Zpsi = np.einsum("x,kxu->ku", z_row, Psi)
    zoff = Zphi @ np.asarray(x0, np.float64) + xi @ z_row
    Q = zmp_w * (Zpsi.T @ Zpsi) + (jerk_w + ridge) * np.eye(N)
    c = zmp_w * (Zpsi.T @ (zoff - np.asarray(ref_ax, np.float64)))
    qp = tt.DenseQP(
        Q=Q, c=c, Aeq=np.zeros((0, N)), beq=np.zeros(0),
        Aineq=np.concatenate([Zpsi, -Zpsi], axis=0),
        bineq=np.concatenate([np.asarray(hi_ax, np.float64) - zoff,
                              zoff - np.asarray(lo_ax, np.float64)]),
        lb=np.full(N, -np.inf), ub=np.full(N, np.inf))
    return tt.solve_qp_native(qp).x.numpy()


def build_config6(tt, device):
    """The config-6 fleet, its scales, options and drifting x0 sequence
    (``bench_all.py:config6`` with rho and the warm budget passed as the
    reference's measured policies chose them)."""
    import torch
    from copra_tpu_torch.qp.riccati import (StagewiseQP, make_stagewise_step,
                                            stagewise_scales)

    one = srb_quadruped()
    rng = np.random.default_rng(11)
    pert = rng.normal(scale=np.repeat([0.03, 0.01, 0.03, 0.05], 3),
                      size=(QUAD_ROBOTS, 12))
    x0s = (one["x0"].astype(np.float64)[None] + pert).astype(np.float32)
    drift = np.cumsum(rng.normal(
        scale=0.002, size=(WARMUP_TICKS + TIMED_TICKS + 10, QUAD_ROBOTS,
                           12)), axis=0)
    x0_seq = [(x0s.astype(np.float64) + drift[t]).astype(np.float32)
              for t in range(WARMUP_TICKS + TIMED_TICKS)]
    t0 = time.perf_counter()
    ten = lambda a: torch.tensor(a, device=device)
    sq1 = StagewiseQP(**{k: ten(v) for k, v in one.items()})
    scales = stagewise_scales(sq1)
    fleet = StagewiseQP(**{k: ten(np.repeat(v[None], QUAD_ROBOTS, 0))
                           for k, v in one.items() if k != "x0"},
                        x0=ten(x0s))
    opts = tt.SolverOptions(max_iter=300, early_exit=False, polish=False,
                            eps_abs=1e-4, rho=0.1)
    wopts = opts.replace(max_iter=50, topup_iters=200)
    tick = make_stagewise_step(fleet, wopts, cold_options=opts,
                               backend="fused", scaling=scales)
    torch.cuda.synchronize()
    oracle = lambda lane, x0: stagewise_exact(
        tt, dict(one, x0=x0.astype(np.float64)))
    return dict(name="config 6", tick=tick, opts=wopts, scale=scales,
                fleet=fleet, cold_opts=opts,
                x0_seq=[ten(a) for a in x0_seq], x0_np=x0_seq,
                lanes=(0, QUAD_ROBOTS - 1), oracle=oracle,
                setup_s=time.perf_counter() - t0)


def build_config5(tt, device):
    """The config-5 fleet: both ZMP axes per robot through the port's
    ``from_mpc`` (``bench_all.py:_bipedal_workload``/``axis_sqp``), its
    options and drifting x0 sequence (``bench_all.py:config5``, fused
    lines)."""
    import torch
    from copra_tpu_torch.qp.riccati import (from_mpc, make_stagewise_step,
                                            stack_stagewise)

    A, B, d, zmp_row = lipm_system(ZMP_T, 0.8)
    ref, lo, hi = footstep_plan(4, ZMP_N, ZMP_T)
    lanes = 2 * ZMP_ROBOTS
    rng = np.random.default_rng(7)
    x0_seq = [np.cumsum(rng.normal(scale=0.002, size=(t + 1, lanes, 3)),
                        axis=0)[-1].astype(np.float32)
              for t in range(WARMUP_TICKS + TIMED_TICKS)]
    t0 = time.perf_counter()
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    Zfull = f32(np.kron(np.eye(ZMP_N + 1), zmp_row))
    system = tt.LTISystem.create(f32(A), f32(B), f32(d), f32(np.zeros(3)),
                                 ZMP_N)

    def axis_sqp(ax):
        costs = (tt.TrajectoryCost(M=Zfull, p=f32(ref[ax]),
                                   weights=f32(np.ones(ZMP_N + 1))),
                 tt.SimpleControlCost(p=f32(np.zeros(ZMP_N)),
                                      weights=f32(np.full(ZMP_N, 1e-6))))
        constraints = (tt.TrajectoryConstraint(E=Zfull, f=f32(hi[ax])),
                       tt.TrajectoryConstraint(E=-Zfull, f=f32(-lo[ax])))
        return from_mpc(system, costs, constraints)

    fleet = stack_stagewise([axis_sqp(0), axis_sqp(1)], repeats=ZMP_ROBOTS)
    opts = tt.SolverOptions(max_iter=300, early_exit=False, polish=False,
                            eps_abs=1e-6, rho=1.0)
    wopts = opts.replace(max_iter=20, topup_iters=80)
    tick = make_stagewise_step(fleet, wopts, cold_options=opts,
                               backend="fused")
    torch.cuda.synchronize()
    A32, B32, d32 = (np.asarray(a, np.float32) for a in (A, B, d))
    oracle = lambda lane, x0: zmp_exact(
        tt, A32, B32, d32, zmp_row, ref[lane % 2], lo[lane % 2],
        hi[lane % 2], x0)[:, None]
    return dict(name="config 5", tick=tick, opts=wopts, scale=None,
                fleet=fleet, cold_opts=opts,
                x0_seq=[f32(a) for a in x0_seq], x0_np=x0_seq,
                lanes=(0, 1), oracle=oracle,
                setup_s=time.perf_counter() - t0)


def _stagewise_held(sk, args, kw, entry, reps: int = 5, served=False):
    """``entry`` against the plain version on ``args`` (one dtype):
    ``((err, kernel ms), max(1, max |plain|), plain ms, bytes of the
    inputs and outputs)``.  ``served``: the kernel runs on the lane-first
    plan made once, as the serving path holds it; otherwise each call
    makes it anew."""
    import torch

    ekw = dict(kw, plan_lf=sk.lane_first_plan(args[0])) if served else kw
    got = entry(*args, **ekw)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    want = sk.stagewise_tick_plain(*args, **kw)
    ev[1].record()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"{entry.__name__} {args[0].dtype}: bad output")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    return ((err, _cuda_ms(lambda: entry(*args, **ekw), reps)), scale,
            ev[0].elapsed_time(ev[1]), _nbytes(*args, *want))


def stagewise_vs_plain(sk, cfg):
    """The tick kernel against its plain version on the served plan of
    ``cfg``, from the warm tuple a cold serving tick delivers, with the
    serving iteration count, on the lane-first plan made once as the
    serving path holds it.  Returns ``(entry, f32 err, f32 tolerance, f64
    err, f32 kernel ms, f32 plain ms, f64 kernel ms, f32 (bound_ms,
    bound_by), chain steps, f32 ms of making the lane-first plan)``."""
    import torch

    tick, opts = cfg["tick"], cfg["opts"]
    fp = tick._plans[tick._plan_key(opts)]
    sqp = fp.sqp
    N, x, u, r = sqp.horizon, sqp.xdim, sqp.udim, sqp.nr_rows
    x0 = cfg["x0_seq"][1]
    if cfg["scale"] is not None:
        x0 = x0 / cfg["scale"][0]
    _, _, _, warm = tick(cfg["x0_seq"][0])
    warm_t = sk._pack_warm(fp, *warm)
    entry = (sk.fused_stagewise_tick if fp.mode == "resident"
             else sk.fused_stagewise_tick_streamed)
    kw = dict(n_iter=opts.max_iter, N=N, x=x, u=u, r=r,
              sigma=opts.sigma, alpha=opts.alpha)
    out = {}
    for dt in (torch.float64, torch.float32):
        args = (fp.plan.to(dt), x0.mT.contiguous().to(dt), warm_t.to(dt))
        out[dt] = _stagewise_held(sk, args, kw, entry, served=True)
    (err32, ms), scale32, plain_ms, nbytes = out[torch.float32]
    plan32 = fp.plan.to(torch.float32)
    repack_ms = _cuda_ms(lambda: sk.lane_first_plan(plan32), 5)
    bnd = bound(stagewise_flops(N, x, u, r, opts.max_iter, x0.shape[0]),
                nbytes)
    # the top-up flag, both dtypes: set, the launch leaves (warm, work) as
    # given (kernel and plain version, bit for bit); clear, the tick runs
    # as without the flag (bit for bit)
    one = torch.ones((), dtype=torch.int32, device=x0.device)
    for dt in (torch.float64, torch.float32):
        args = (fp.plan.to(dt), x0.mT.contiguous().to(dt), warm_t.to(dt))
        ekw = dict(kw, plan_lf=sk.lane_first_plan(args[0]))
        warm1, work1 = entry(*args, **ekw)
        for flag in (one, 0 * one):
            held_ = (args[2], work1) if bool(flag) else (warm1, work1)
            for got in (entry(*args, **ekw, work=work1, skip=flag),
                        sk.stagewise_tick_plain(*args, **kw, work=work1,
                                                skip=flag)
                        if bool(flag) else held_):
                if not all(torch.equal(g, h) for g, h in zip(got, held_)):
                    fail(f"{entry.__name__} {dt}: the top-up flag "
                         f"{int(flag)} did not keep its state")
    skip_ms = _cuda_ms(lambda: entry(*args, **ekw, work=work1, skip=one), 20)
    return (entry.__name__, err32, F32_RTOL * scale32,
            out[torch.float64][0][0], ms, plain_ms, out[torch.float64][0][1],
            bnd, 2 * N * opts.max_iter, repack_ms, skip_ms)


def random_stagewise(tt, device, N: int, x: int, u: int, r: int,
                     lanes: int, seed: int):
    """A random well-posed batch of stagewise problems (the recipe of the
    reference's stagewise kernel tests: rows when ``r`` > 0, 30% of the
    state bounds infinite), its fused plan at rho 0.3, x0 [x, B] and a
    distinct non-zero warm tensor, all float64 on ``device``."""
    import torch
    from copra_tpu_torch.ops import stagewise_kernel as sk
    from copra_tpu_torch.qp.riccati import StagewiseQP

    rng = np.random.default_rng(seed)
    lead = (lanes,)
    Qm = 0.3 * rng.normal(size=lead + (N + 1, x, x))
    Rm = 0.3 * rng.normal(size=lead + (N, u, u))
    xlb = np.full(lead + (N + 1, x), -0.8)
    mask = rng.uniform(size=xlb.shape) < 0.3
    f = dict(
        A=0.95 * np.eye(x) + 0.08 * rng.normal(size=lead + (N, x, x))
        / np.sqrt(x / 3),
        B=0.5 * rng.normal(size=lead + (N, x, u)),
        d=0.01 * rng.normal(size=lead + (N, x)),
        Qx=np.einsum("...kij,...kil->...kjl", Qm, Qm) + 0.1 * np.eye(x),
        qx=0.2 * rng.normal(size=lead + (N + 1, x)),
        Ru=np.einsum("...kij,...kil->...kjl", Rm, Rm) + 0.5 * np.eye(u),
        ru=0.2 * rng.normal(size=lead + (N, u)),
        x0=0.3 * rng.normal(size=lead + (x,)),
        xlb=np.where(mask, -np.inf, xlb), xub=np.where(mask, np.inf, -xlb),
        ulb=np.full(lead + (N, u), -1.5), uub=np.full(lead + (N, u), 1.5))
    if r:
        mid = 0.1 * rng.normal(size=lead + (N, r))
        f.update(Cx=rng.normal(size=lead + (N, r, x)),
                 Cu=rng.normal(size=lead + (N, r, u)), clo=mid - 0.7,
                 chi=mid + 0.7)
    sqp = StagewiseQP(**{k: torch.tensor(v, device=device)
                         for k, v in f.items()})
    fp = sk.build_fused_plan(sqp, tt.SolverOptions(rho=0.3))
    warm = torch.tensor(0.2 * rng.normal(
        size=(N + 1, sk._Layout(x, u, r).W, lanes)), device=device)
    return fp.plan, sqp.x0.mT.contiguous(), warm


def shapes_vs_plain(tt, sk, device):
    """The tick kernel (through the entry point of each shape's mode)
    against the plain version on ``ENVELOPE_SHAPES``, 20 iterations,
    float64 within F64_TOL and float32 within F32_RTOL x max(1, max
    |plain|); fails on a disagreement."""
    import torch

    kw = dict(n_iter=20, sigma=1e-6, alpha=1.6)
    for N, x, u, r, lanes in ENVELOPE_SHAPES:
        plan, x0, warm = random_stagewise(tt, device, N, x, u, r, lanes,
                                          seed=N + x + r)
        entry = (sk.fused_stagewise_tick
                 if sk.fused_mode(N, x, u, r, plan.dtype) == "resident"
                 else sk.fused_stagewise_tick_streamed)
        line = []
        for dt, tol in ((torch.float64, None), (torch.float32, F32_RTOL)):
            args = (plan.to(dt), x0.to(dt), warm.to(dt))
            (err, ms), scale, plain_ms, _ = _stagewise_held(
                sk, args, dict(kw, N=N, x=x, u=u, r=r), entry, reps=3)
            bound_ = F64_TOL if tol is None else tol * scale
            line.append(f"{str(dt)[6:]} max_abs_err {err:.3e} (tol "
                        f"{bound_:.3e}), kernel {ms:.4f} ms, plain "
                        f"{plain_ms:.1f} ms")
            if not err <= bound_:
                fail(f"tick kernel at {(N, x, u, r, lanes)} {dt}: "
                     f"{err:.3e} > {bound_:.3e}")
        cfg = sk.ring_config(N, x, u, r, 8)
        print(f"kernel {entry.__name__} (N, x, u, r, lanes) = "
              f"{(N, x, u, r, lanes)}, f64 ring of {cfg[4]} x {cfg[8]} "
              f"stage tiles of {(sum(cfg[:3]) * 8) / 1e3:.1f} KB: "
              + "; ".join(line))


def serve_stagewise(sk, cfg):
    """The served path: a cold tick, a warm one, then the timed ticks.
    Returns the last controls, the converged share of the timed ticks,
    host and device ms per tick, and the status pass's host and device
    ms."""
    import torch

    tick, seq = cfg["tick"], cfg["x0_seq"]
    X, U, info, warm = tick(seq[0])
    for t in range(1, WARMUP_TICKS):
        X, U, info, warm = tick(seq[t], warm)
    converged = torch.zeros((), dtype=torch.int64, device=U.device)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    t0 = time.perf_counter()
    for t in range(WARMUP_TICKS, WARMUP_TICKS + TIMED_TICKS):
        X, U, info, warm = tick(seq[t], warm)
        converged += (info.status == 0).sum()
    ev[1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TIMED_TICKS
    dev_ms = ev[0].elapsed_time(ev[1]) / TIMED_TICKS
    share = float(converged) / (TIMED_TICKS * U.shape[0])

    # the per-tick status pass (_lane_residuals) on its own
    fp = tick._plans[tick._plan_key(cfg["opts"])]
    Xs, Us = X, U
    if cfg["scale"] is not None:
        Xs, Us = X / cfg["scale"][0], U / cfg["scale"][1]
    status = lambda: sk._lane_residuals(fp.sqp, cfg["opts"], fp.rho_x,
                                        fp.rho_u, fp.rows, Xs, Us, *warm)
    status()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev[0].record()
    for _ in range(5):
        status()
    ev[1].record()
    torch.cuda.synchronize()
    status_host = (time.perf_counter() - t1) * 1e3 / 5
    return U, share, host_ms, dev_ms, status_host, ev[0].elapsed_time(ev[1]) / 5


def gate_stagewise(cfg, U, x0_last=None):
    """max |U - U_exact| / max |U_exact| over the gated lanes at the last
    tick's x0 (``x0_last``, by default the config's last state)."""
    if x0_last is None:
        x0_last = cfg["x0_np"][-1]
    err = scale = 0.0
    for lane in cfg["lanes"]:
        exact = cfg["oracle"](lane, x0_last[lane])
        got = U[lane].double().cpu().numpy().reshape(exact.shape)
        err = max(err, float(np.abs(got - exact).max()))
        scale = max(scale, float(np.abs(exact).max()))
    return err / scale, err


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a kernel's work.
# ---------------------------------------------------------------------------


def bound(flops: float, nbytes: float, peak: float = F32_PEAK):
    """``(bound_ms, bound_by)``: the larger of operations over the peak
    rate of their type (f32 unless given) and bytes over the memory
    rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def box_work(B: int, n: int, n_iter: int, refine: int, body: str,
             per_lane: bool):
    """Operations and bytes of one box-ADMM call: ``body`` "x0_zero" (the
    K-free iteration, Kinv only), "qx" (g = Q x0, K only) or "general"
    (Kinv and K, refine steps, g from K).  ~12 operations per coordinate
    per iteration outside the products; inputs read once (the vectors the
    body reads), four [B, n] outputs written once."""
    products = {"x0_zero": n_iter, "qx": 1,
                "general": n_iter * (1 + 2 * refine) + 1}[body]
    flops = products * 2.0 * B * n * n + n_iter * 12.0 * B * n
    ops = {"x0_zero": 1, "qx": 1, "general": 2}[body] * (B if per_lane
                                                           else 1)
    vecs_in = {"x0_zero": 5, "qx": 3, "general": 6}[body]
    return flops, 4.0 * (ops * n * n + (vecs_in + 4) * B * n)


def general_work(B: int, n: int, m: int, n_iter: int, refine: int):
    """Operations and bytes of one shared general-ADMM call: per lane and
    iteration w C and e_t C' (2mn each), (1 + 2 refine) products with an
    [n, n] operator, ~14 operations per row and 5 per column; inputs C,
    Kinv, K, rho, l, u, e0, y0, z0 read once, e, y, z written once."""
    flops = n_iter * B * (4.0 * m * n + 2.0 * n * n * (1 + 2 * refine)
                          + 14.0 * m + 5.0 * n)
    nbytes = 4.0 * (2 * m * n + 2 * n * n + m + B * (4 * m + n)
                    + B * (2 * m + n))
    return flops, nbytes


def general_f64_bound(B: int, n: int, m: int, n_iter: int, refine: int):
    """The f64-pipe bound of the same call: the products' multiply-adds
    (the kernel sums them in f64) over the f64 peak, the rest over the
    f32 peak; ms."""
    products = n_iter * B * (4.0 * m * n + 2.0 * n * n * (1 + 2 * refine))
    rest = n_iter * B * (14.0 * m + 5.0 * n)
    return (products / F64_PEAK + rest / F32_PEAK) * 1e3


def lane_general_work(B: int, n: int, m: int, n_iter: int):
    """Operations and bytes of one per-lane general-ADMM call: per lane and
    iteration w C and C x_t (2mn each), one product with Kinv (2n^2), ~14
    operations per row and 6 per column; inputs Kinv, C, c, l, u, rho, x0,
    y0, z0 read once, x, y, z written once."""
    flops = n_iter * B * (4.0 * m * n + 2.0 * n * n + 14.0 * m + 6.0 * n)
    nbytes = 4.0 * B * (n * n + m * n + 3 * n + 7 * m)
    return flops, nbytes


def chol_work(B: int, n: int, itemsize: int):
    """Operations and bytes of one batched Cholesky: per matrix n^3 / 3 for
    the rank-1 downdates of the lower triangle, n^2 / 2 for the column
    scalings and 2n for the pivots; the lower triangle of K read once (the
    factor depends on nothing else), L written once."""
    return (B * (n ** 3 / 3.0 + n * n / 2.0 + 2.0 * n),
            (n * (n + 1) / 2.0 + n * n) * B * itemsize)


def stagewise_flops(N: int, x: int, u: int, r: int, n_iter: int,
                    lanes: int) -> float:
    """Operations of the stagewise tick kernel: per lane, iteration and
    stage, the backward step (shifted costs, rows, B'v, nF h, A'v + K'h)
    and the forward step (K x, projections, rows, A x + B u), as
    ``csrc/stagewise_tick.cu`` computes them."""
    per_stage = (4 * x * x + 8 * x * u + 2 * u * u + 4 * r * (x + u)
                 + 11 * x + 11 * u + 10 * r)
    return float(per_stage) * N * n_iter * lanes


def _nbytes(*ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


# ---------------------------------------------------------------------------
# The shared-plan paths: fleets (copies of bench_all.py's config 1 and 2
# and of bench.py's roofline point), the kernels against their
# plain versions, and phases 8-13.
# ---------------------------------------------------------------------------


def double_integrator(T: float = 0.1):
    """``bench_all.py:_double_integrator``."""
    return (np.array([[1.0, T], [0.0, 1.0]]), np.array([[0.5 * T * T], [T]]),
            np.zeros(2))


def f32_plan(plan):
    """The plan with every tensor field in float32."""
    import dataclasses

    import torch

    return dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name).float()
        for f in dataclasses.fields(plan)
        if isinstance(getattr(plan, f.name), torch.Tensor)})


def _drifting(x0s, rng, ticks: int, device):
    import torch

    drift = rng.normal(scale=0.02, size=(ticks + 2,) + x0s.shape).cumsum(0)
    x0_seq = (x0s[None] + drift).astype(np.float32)
    return [torch.tensor(x, device=device) for x in x0_seq]


def build_config1(tt, device, batch: int = 0):
    """``bench_all.py:config1``: LTI double integrator N = 10, a full-size
    position TrajectoryCost, a small control cost, +-2 control bounds,
    the accurate tick at 300 iterations x 3 rounds, rho from ``auto_rho``
    (seed centre at the fleet mean)."""
    import torch

    N, batch = C1_N, batch or FLEET
    A, B, d = double_integrator()
    rng = np.random.default_rng(1)
    x0s = np.array([1.0, 0.0])[None] + rng.normal(scale=[0.3, 0.2],
                                                  size=(batch, 2))
    t0 = time.perf_counter()
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    system = tt.LTISystem.create(f32(A), f32(B), f32(d), f32(x0s[0]), N)
    pos_row = tt.span_matrix(f32([[1.0, 0.0]]), N + 1)
    costs = (tt.TrajectoryCost(M=pos_row, p=f32(np.zeros(N + 1)),
                               weights=f32(np.full(N + 1, 10.0))),
             tt.SimpleControlCost(p=f32(np.zeros(N)),
                                  weights=f32(np.full(N, 1e-3))))
    plan = tt.make_control_plan(
        system, costs, (tt.ControlBoundConstraint.create([-2.0], [2.0]),))
    opts = tt.SolverOptions(max_iter=C1_ITERS, early_exit=False,
                            polish=False)
    center = x0s.mean(0)
    opts = opts.replace(rho=tt.auto_rho(plan, x0s, opts, seed_center=center,
                                        accurate=True,
                                        accurate_rounds=C1_ROUNDS))
    step = tt.make_plan_step(plan, opts, batched=True, seed_center=center,
                             accurate=True, accurate_rounds=C1_ROUNDS)
    torch.cuda.synchronize()
    return dict(name="config 1", plan=plan, opts=opts, step=step,
                x0s=x0s, x0_seq=_drifting(x0s, rng, SHORT_TICKS, device),
                ticks=SHORT_TICKS, setup_s=time.perf_counter() - t0)


def build_roofline(tt, device, batch: int = 0, horizon: int = 0):
    """``bench.py:run_roofline``: one LTI point-mass plan (N = 256) for a
    fleet of states, the 75th percentile of the fleet's unconstrained |u|
    as a binding bound, the accurate tick at 2 rounds x 30 iterations."""
    import torch

    batch, horizon = batch or FLEET, horizon or ROOF_N
    T, mass = 0.005, 5.0
    A = np.array([[1.0, T], [0.0, 1.0]])
    Bm = np.array([[0.5 * T * T / mass], [T / mass]])
    d = np.array([-9.81 / 2.0 * T * T, -9.81 * T])
    rng = np.random.default_rng(42)
    x0s = np.array([0.0, -1.5])[None] + rng.normal(scale=[0.02, 0.1],
                                                   size=(batch, 2))
    t0 = time.perf_counter()
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    system = tt.LTISystem.create(f32(A), f32(Bm), f32(d), f32(x0s[0]),
                                 horizon)
    costs = (tt.TargetCost.create(np.eye(2), [0.0, -1.0],
                                  weights=[10.0, 1e4]),
             tt.ControlCost.create([[1.0]], [2.0], weights=[1e-4]))
    sm = tt.make_seed_map(tt.make_control_plan(system, costs, ()),
                          keep_f64=True)
    useed = sm.u0.cpu().numpy()[None] + x0s @ sm.Umap.cpu().numpy()
    bnd = float(np.quantile(np.abs(useed), 0.75))
    plan = tt.make_control_plan(
        system, costs, (tt.ControlBoundConstraint.create([-bnd], [bnd]),))
    opts = tt.SolverOptions(max_iter=ROOF_ITERS, early_exit=False,
                            polish=False)
    center = x0s.mean(0)
    opts = opts.replace(rho=tt.auto_rho(plan, x0s, opts, seed_center=center,
                                        accurate=True,
                                        accurate_rounds=ROOF_ROUNDS))
    step = tt.make_plan_step(plan, opts, batched=True, seed_center=center,
                             accurate=True, accurate_rounds=ROOF_ROUNDS)
    torch.cuda.synchronize()
    drift = np.zeros((ROOF_TICKS + 2, batch, 2))
    drift[:, :, 1] = np.cumsum(
        rng.normal(scale=0.02, size=(ROOF_TICKS + 2, batch)), axis=0)
    x0_seq = [torch.tensor((x0s + drift[t]).astype(np.float32),
                           device=device) for t in range(ROOF_TICKS + 2)]
    return dict(name="roofline fleet", plan=plan, opts=opts, step=step,
                x0s=x0s, x0_seq=x0_seq, ticks=ROOF_TICKS, bound=bnd,
                setup_s=time.perf_counter() - t0)


def config2_terms(tt, dtype):
    """Config 2's costs and constraints (``bench_all.py:config2``): a
    trajectory, a control, a mixed and two bound constraints (fresh
    instances: a control constraint registers with one controller only)."""
    f = lambda a: np.asarray(a, dtype)
    costs = (tt.TargetCost.create(f(np.eye(2)), f([0.0, 0.0]),
                                  weights=f([10.0, 1.0])),
             tt.ControlCost.create(f([[1.0]]), f([0.0]), weights=f([1e-3])))
    constraints = (
        tt.TrajectoryConstraint.create(f([[0.0, 1.0]]), f([1.5])),
        tt.ControlConstraint.create(f([[1.0]]), f([1.9])),
        tt.MixedConstraint.create(f([[1.0, 0.0]]), f([[0.1]]), f([3.0])),
        tt.TrajectoryBoundConstraint.create(f([-5.0, -2.0]), f([5.0, 2.0])),
        tt.ControlBoundConstraint.create(f([-2.0]), f([2.0])))
    return costs, constraints


def build_config2(tt, device, batch: int = 0):
    """``bench_all.py:config2``: LTI double integrator N = 10 with a
    trajectory, a control, a mixed and two bound constraints, all f32,
    400 iterations; the general tick through the shared general kernel
    (``use_fused=True``) with rho from ``auto_rho(use_fused=True)``."""
    import torch

    N, batch = C2_N, batch or FLEET
    A, B, d = double_integrator()
    rng = np.random.default_rng(2)
    x0s = np.array([1.0, 0.0])[None] + rng.normal(scale=[0.3, 0.2],
                                                  size=(batch, 2))
    t0 = time.perf_counter()
    f32 = lambda a: np.asarray(a, np.float32)
    system = tt.LTISystem.create(f32(A), f32(B), f32(d), f32(x0s[0]), N)
    costs, constraints = config2_terms(tt, np.float32)
    plan = tt.make_control_plan(system, costs, constraints)
    opts = tt.SolverOptions(max_iter=C2_ITERS, early_exit=False,
                            polish=False)
    center = x0s.mean(0)
    opts = opts.replace(rho=tt.auto_rho(plan, x0s, opts, seed_center=center,
                                        use_fused=True))
    step = tt.make_plan_step(plan, opts, batched=True, seed_center=center,
                             use_fused=True)
    torch.cuda.synchronize()
    return dict(name="config 2", plan=plan, opts=opts, step=step, x0s=x0s,
                center=center, x0_seq=_drifting(x0s, rng, SHORT_TICKS,
                                                device),
                ticks=SHORT_TICKS, setup_s=time.perf_counter() - t0)


def held(got, want):
    """``(max |got - want|, tolerance 2e-4 x max(1, max |want|))``, with a
    shape and finiteness check."""
    for g, w in zip(got, want):
        if g.shape != w.shape or not bool(g.isfinite().all()):
            fail("kernel output of the wrong shape or not finite")
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    return _max_diff(got, want), KERNEL_TOL * scale


def shared_box_vs_plain(ak, cfg):
    """The shared box kernel against its plain version on ``cfg``'s
    operators at the serving iteration count, from the first tick's
    correction bounds and distinct non-zero c, x0, y0, z0: refine = 0 at
    the serving rho, refine = 1 at rho = 1.0.  Returns ``{case: (err,
    tol, ms, eager_ms, plain_ms, (bound_ms, bound_by))}``: ``ms`` from a
    CUDA-graph replay (the kernel alone), ``eager_ms`` from eager calls
    (the wrapper's host dispatch included); the body under "body" and, at
    n = 256, the yardstick's ms under "yardstick_ms"."""
    import torch

    from copra_tpu_torch.plan import _box_fast_state

    f32, f64 = torch.float32, torch.float64
    plan, opts = cfg["plan"], cfg["opts"]
    Kinv, K, seed = cfg["step"].state
    x0 = cfg["x0_seq"][0]
    B, n = x0.shape[0], Kinv.shape[-1]
    xs = seed.seed(x0.to(f64))
    l = (plan.lb.to(f64) - xs).to(f32)
    u = (plan.ub.to(f64) - xs).to(f32)
    rng = np.random.default_rng(n)
    vec = lambda s: torch.tensor(s * rng.normal(size=(B, n)), dtype=f32,
                                 device=x0.device)
    c, x0v, y0 = vec(0.01), vec(0.1), vec(0.1)
    z0 = torch.clamp(vec(0.1), l, u)
    Kinv1, K1 = (t.to(f32).contiguous() for t in
                 _box_fast_state(plan, opts.replace(rho=1.0)))
    sc = dict(sigma=opts.sigma, alpha=opts.alpha, n_iter=opts.max_iter)
    out = {"body": _BODY[ak.box_shared_config(n)[0]]}
    if n == ROOF_N:
        # the same 31 [B, n] x [n, n] f32 products through torch.mm, TF32
        # off: a yardstick for the kernel's products, never called by it
        from copra_tpu_torch._precision import full_f32

        def products():
            with full_f32():
                v = c
                for _ in range(opts.max_iter + 1):
                    v = torch.mm(v, Kinv)
            return v

        out["yardstick_ms"] = _cuda_ms(products, 10)
    for case, (Ki, Ko, rho, refine) in {
            "refine 0, serving rho": (Kinv, K, opts.rho, 0),
            "refine 1, rho 1.0": (Kinv1, K1, 1.0, 1)}.items():
        args = (Ki, Ko, c, l, u, x0v, y0, z0)
        kw = dict(sc, rho=rho, refine=refine)
        got = ak.fused_admm_box_shared(*args, **kw)
        want = ak.admm_box_plain(*args, **kw)
        torch.cuda.synchronize()
        err, tol = held(got, want)
        run = lambda: ak.fused_admm_box_shared(*args, **kw)
        ms, eager_ms = _graph_ms(run, 20), _cuda_ms(run, 10)
        plain_ms = _cuda_ms(lambda: ak.admm_box_plain(*args, **kw), 3)
        out[case] = (err, tol, ms, eager_ms, plain_ms, bound(*box_work(
            B, n, opts.max_iter, refine, "general", per_lane=False)))
    return out


def general_vs_plain(ak, cfg):
    """The shared general kernel against its plain version on config 2's
    operators (400 iterations, the serving refine = 1), from the first
    tick's correction bounds and distinct non-zero e0, y0, z0, at the
    serving rho and at rho = 1.0; the distance of each from the f64
    iteration beside it.  Returns ``{case: (err, tol, ms, plain_ms,
    bound, kernel_vs_f64, plain_vs_f64)}``."""
    import torch

    from copra_tpu_torch._tensors import matvec
    from copra_tpu_torch.plan import _general_bounds, _general_fast_state

    f32, f64 = torch.float32, torch.float64
    plan, opts = cfg["plan"], cfg["opts"]
    x0 = cfg["x0_seq"][0]
    rng = np.random.default_rng(5)
    out = {}
    for case, o in (("serving rho", opts),
                    ("rho 1.0", opts.replace(rho=1.0))):
        C, E, rho_vec, K, Kinv = (t.contiguous() for t in
                                  _general_fast_state(plan, o))
        seed = cfg["step"].state[-1]
        l, u = _general_bounds(plan, E, x0)
        Cxs = matvec(C, seed.seed(x0))
        l_e, u_e = (l - Cxs).contiguous(), (u - Cxs).contiguous()
        B, m, n = l.shape[0], C.shape[0], C.shape[1]
        vec = lambda k: torch.tensor(0.1 * rng.normal(size=(B, k)),
                                     dtype=f32, device=x0.device)
        e0, y0 = vec(n), vec(m)
        z0 = torch.clamp(vec(m), l_e, u_e)
        args = (Kinv, K, C, rho_vec, l_e, u_e, e0, y0, z0)
        kw = dict(n_iter=o.max_iter, sigma=o.sigma, alpha=o.alpha, refine=1)
        got = ak.fused_admm_general_shared(*args, **kw)
        want = ak.admm_general_shared_plain(*args, **kw)
        exact = ak.admm_general_shared_plain(*(a.to(f64) for a in args), **kw)
        torch.cuda.synchronize()
        err, tol = held(got, want)
        ms = _cuda_ms(lambda: ak.fused_admm_general_shared(*args, **kw), 10)
        plain_ms = _cuda_ms(lambda: ak.admm_general_shared_plain(*args, **kw),
                            2)
        out[case] = (err, tol, ms, plain_ms,
                     bound(*general_work(B, n, m, o.max_iter, 1)),
                     _max_diff(got, exact), _max_diff(want, exact))
        if case == "serving rho":
            # every body that takes the shape, forced, on the same call
            for body in ak.GENERAL_BODIES:
                try:
                    ak.general_shared_config(n, m, body)
                except ValueError:
                    continue
                run = lambda: ak._launch_general_shared(*args, body=body,
                                                        **kw)
                b_err = _max_diff(run(), want)
                out[f"{body} body"] = (b_err, _cuda_ms(run, 10))
    return out


def random_box(B: int, n: int, seed: int, device):
    """A shared box problem off the served paths: SPD operators (Q = M M'
    / n + 0.5 I), sigma + rho = 0.2, +-0.5 bounds and distinct non-zero
    c, x0, y0, z0 (f32 on ``device``)."""
    import torch

    rng = np.random.default_rng(seed)
    Mx = rng.normal(size=(n, n))
    K = Mx @ Mx.T / n + (0.5 + 0.2 + 1e-6) * np.eye(n)
    l, u = np.full((B, n), -0.5), np.full((B, n), 0.5)
    arrays = (np.linalg.inv(K), K, 0.3 * rng.normal(size=(B, n)), l, u,
              0.3 * rng.normal(size=(B, n)), 0.2 * rng.normal(size=(B, n)),
              np.clip(0.3 * rng.normal(size=(B, n)), l, u))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


def random_general(B: int, n: int, m: int, seed: int, device):
    """A shared general problem off the served paths: C = [random rows; I]
    normalised, rho per row (two rows 10x, their bounds equal), -inf lower
    bounds on some rows, distinct non-zero e0, y0, z0."""
    import torch

    rng = np.random.default_rng(seed)
    C = np.concatenate([rng.normal(size=(m - n, n)), np.eye(n)])
    C /= np.linalg.norm(C, axis=1, keepdims=True)
    rho = np.full(m, 0.3)
    rho[:2] *= 10.0
    Mx = rng.normal(size=(n, n))
    K = Mx @ Mx.T / n + (1.0 + 1e-6) * np.eye(n) + (C.T * rho) @ C
    l = -0.4 + 0.1 * rng.normal(size=(B, m))
    u = l + 0.8
    l[:, 2:(m - n) // 2] = -np.inf
    u[:, :2] = l[:, :2]
    arrays = (np.linalg.inv(K), K, C, rho, l, u,
              0.2 * rng.normal(size=(B, n)), 0.1 * rng.normal(size=(B, m)),
              np.clip(0.2 * rng.normal(size=(B, m)), l, u))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


BOX_SC = dict(sigma=1e-6, alpha=1.6, rho=0.2)


def box_crossover(ak, device, sm_hz):
    """Both bodies of the shared box kernel at the widths either takes
    (B = 4096, 300 iterations, refine 0), each held against the plain
    version: ``{n: {body: (err, tol, ms, cycles per iteration)}}``, ms
    from a CUDA-graph replay."""
    import torch

    out = {}
    for n in CROSSOVER_N:
        args = random_box(FLEET, n, n, device)
        kw = dict(BOX_SC, n_iter=CROSSOVER_ITERS, refine=0)
        want = ak.admm_box_plain(*args, **kw)
        out[n] = {}
        for body in ("small", "tile"):
            run = lambda: ak._launch_box_shared(*args, body=body, **kw)
            got = run()
            torch.cuda.synchronize()
            err, tol = held(got, want)
            ms = _graph_ms(run, 20)
            out[n][body] = (err, tol, ms, ms * 1e-3 * sm_hz / CROSSOVER_ITERS)
    return out


def box_envelope(ak, device):
    """The shared box kernel at the wide end of its envelope (n = 600 and
    1024, B = 64, 30 iterations, refine 0 and 1) against the plain
    version: ``{(n, refine): (err, tol, ms, body)}``."""
    import torch

    out = {}
    for n in BOX_WIDE_N:
        args = random_box(WIDE_B, n, n, device)
        for refine in (0, 1):
            kw = dict(BOX_SC, n_iter=ITERS, refine=refine)
            got = ak.fused_admm_box_shared(*args, **kw)
            want = ak.admm_box_plain(*args, **kw)
            torch.cuda.synchronize()
            err, tol = held(got, want)
            ms = _cuda_ms(lambda: ak.fused_admm_box_shared(*args, **kw), 3)
            body = _BODY[ak.box_shared_config(n)[0]]
            out[(n, refine)] = (err, tol, ms, body)
    return out


def general_envelope(ak, device):
    """The shared general kernel at the wide end of its envelope ((n, m) =
    (100, 400) and (256, 1024), B = 64, 30 iterations, refine 1) against
    the plain version: ``{(n, m): (err, tol, ms, body)}``."""
    import torch

    out = {}
    for n, m in GENERAL_WIDE:
        args = random_general(WIDE_B, n, m, m, device)
        kw = dict(n_iter=ITERS, sigma=1e-6, alpha=1.6, refine=1)
        got = ak.fused_admm_general_shared(*args, **kw)
        want = ak.admm_general_shared_plain(*args, **kw)
        torch.cuda.synchronize()
        err, tol = held(got, want)
        ms = _cuda_ms(lambda: ak.fused_admm_general_shared(*args, **kw), 3)
        body = ("group", "wide")[ak.general_shared_config(n, m)[0] - 1]
        out[(n, m)] = (err, tol, ms, body)
    return out


_BODY = {1: "small", 2: "tile"}


def serve_plan(tt, cfg, step=None, plan=None):
    """Serve ``cfg``'s fleet (2 warm-up and ``cfg["ticks"]`` timed ticks)
    through ``step`` (default: the configuration's own) and gate lanes 0,
    1, 17, B-1 and the worst 3 unconverged lanes against the native
    oracle.  Returns ``(u, sol, share, host_ms, dev_ms, err, lanes)``."""
    step = step or cfg["step"]
    plan = plan or cfg["plan"]
    u, sol, share, host_ms, dev_ms, _ = run_ticks(step, plan, cfg["x0_seq"],
                                               cfg["ticks"])
    B = u.shape[0]
    if not bool(u.isfinite().all()):
        fail(f"{cfg['name']}: non-finite controls")
    status = sol.status.cpu().numpy()
    if not np.isin(status, (0, 1)).all():
        fail(f"{cfg['name']}: statuses outside 0/1")
    lanes = tuple(sorted({0, 1, 17, B - 1, *sol.failed_lanes(3)}))
    x0_last = cfg["x0_seq"][cfg["ticks"] + 1].cpu().numpy()
    err = gate_vs_oracle(tt, plan, u, x0_last, lanes)
    return u, sol, share, host_ms, dev_ms, err, lanes


def k2_vs_plain(ak, step, plan, opts, x0_first, sm_hz):
    """The per-lane entry point (``fused_admm_box``, the f32 fused tick on
    per-lane plans) against the plain version on config 4's serving
    operators in f32, with distinct non-zero x0, y0, z0: at the serving
    rho with the tick's refine, and at refine 1 (``bench.py``'s fused
    mode) on the same plan's operators at rho = 1.0 (at the serving rho
    f32 refinement parts two summation orders by cond(K) eps, see phase
    3).  Prints each case (graph replay and eager ms, the plain version's,
    the bound, its share and the cycles per iteration) and fails on a
    disagreement.  Returns ``{case: (err, graph_ms, plain_ms, bound)}``."""
    import torch

    from copra_tpu_torch.plan import _box_fast_state

    f32 = torch.float32
    Kinv, K, seed = step.state
    B, n = x0_first.shape[0], Kinv.shape[-1]
    xs = seed.seed(x0_first.to(seed.u0.dtype))
    l, u = (plan.lb - xs).to(f32), (plan.ub - xs).to(f32)
    rng = np.random.default_rng(4)
    vec = lambda: torch.tensor(0.1 * rng.normal(size=(B, n)), dtype=f32,
                               device=x0_first.device)
    zero = torch.zeros_like(l)
    x0v, y0 = vec(), vec()
    z0 = torch.clamp(vec(), l, u)
    refine = max(opts.kkt_refine, 0)
    Kinv1, K1 = (t.to(f32).contiguous() for t in
                 _box_fast_state(plan, opts.replace(rho=1.0)))
    sc = dict(n_iter=opts.max_iter, sigma=opts.sigma, alpha=opts.alpha)
    cases = {f"serving rho, refine {refine}": (Kinv, K, dict(
                 sc, rho=opts.rho, refine=refine)),
             "rho 1.0, refine 1": (Kinv1, K1, dict(sc, rho=1.0, refine=1))}
    out = {}
    for case, (Ki, Ko, kw) in cases.items():
        args = (Ki, Ko, zero, l, u, x0v, y0, z0)
        run = lambda: ak.fused_admm_box(*args, **kw)
        got = run()
        want = ak.admm_box_plain(*args, **kw)
        torch.cuda.synchronize()
        err, tol = held(got, want)
        ms, graph_ms = _cuda_ms(run, 20), _graph_ms(run, 20)
        plain_ms = _cuda_ms(lambda: ak.admm_box_plain(*args, **kw), 5)
        bnd = bound(*box_work(B, n, kw["n_iter"], kw["refine"], "general",
                              per_lane=True))
        cfg = ak.box_lanes_config(n, ak.MODE_GENERAL, kw["refine"])
        regs, spill, _, per_sm = ak._box_lanes_attributes(
            n, ak.MODE_GENERAL, kw["refine"])
        print(f"kernel fused_admm_box (config 4 operators in f32, {case}, "
              f"{_LANES_BODY[cfg[0]]} body, {regs} registers, {spill} bytes "
              f"of spills, {per_sm} blocks an SM): max_abs_err {err:.3e} "
              f"(tol {tol:.3e}); kernel "
              f"{graph_ms:.4f} ms (CUDA-graph replay; eager calls {ms:.4f} "
              f"ms), plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), {bnd[0] / graph_ms:.1%} of the bound, "
              f"{graph_ms * 1e-3 * sm_hz / kw['n_iter']:.0f} cycles per "
              f"iteration at {sm_hz / 1e6:.0f} MHz")
        if not err <= tol:
            fail(f"fused_admm_box ({case}) disagrees with the plain version")
        out[case] = (err, graph_ms, plain_ms, bnd)
    return out


def fast_step(tt, plan, opts, x0s, center):
    """The f32 fused tick of ``plan`` (default ``use_fused``) at the rho
    ``auto_rho`` measures for that step, as ``bench.py``'s plan mode
    builds it.  Returns ``(step, rho)``."""
    rho = tt.auto_rho(plan, x0s, opts, seed_center=center)
    return tt.make_plan_step(plan, opts.replace(rho=rho), batched=True,
                             seed_center=center), rho


def kernel_record(name, source, replaces, launches, err, ms, plain_ms,
                  bnd, library_ms=None):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library_ms}


def shared_plan_phases(tt, ak, dev, plan4, opts4, x0_dev4, reset_counts,
                       sm_hz):
    """Phases 8-13; returns the kernel records of K2, K3 and K6, and the
    configurations by name."""
    import torch

    cfgs = {}
    for build_cfg in (build_config1, build_roofline, build_config2):
        cfg = build_cfg(tt, dev)
        cfgs[cfg["name"]] = cfg
        print(f"setup: {cfg['name']}, {cfg['x0_seq'][0].shape[0]} lanes, n = "
              f"{cfg['plan'].Q.shape[-1]}, plan + auto_rho + step in "
              f"{cfg['setup_s']:.2f} s, rho={cfg['opts'].rho:.6g}, "
              f"{cfg['opts'].max_iter} iterations")
    c1, roof, c2 = cfgs["config 1"], cfgs["roofline fleet"], cfgs["config 2"]

    # phase 8: the shared box kernel against its plain version
    k3 = {}
    for cfg in (c1, roof):
        cases = shared_box_vs_plain(ak, cfg)
        body, yard = cases.pop("body"), cases.pop("yardstick_ms", None)
        n_iter = cfg["opts"].max_iter
        for case, (err, tol, ms, eager_ms, plain_ms, bnd) in cases.items():
            k3[(cfg["name"], case)] = (err, ms, plain_ms, bnd)
            print(f"kernel fused_admm_box_shared ({cfg['name']} operators, "
                  f"n = {cfg['plan'].Q.shape[-1]}, B = {FLEET}, "
                  f"{n_iter} iterations, {case}): max_abs_err "
                  f"{err:.3e} (tol {tol:.3e}); kernel {ms:.4f} ms (CUDA-graph "
                  f"replay; eager calls {eager_ms:.4f} ms), plain "
                  f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); "
                  f"{body} body, {ms * 1e-3 * sm_hz / n_iter:.0f} cycles per "
                  f"iteration at {sm_hz / 1e6:.0f} MHz")
            if not err <= tol:
                fail(f"fused_admm_box_shared ({cfg['name']}, {case}) "
                     f"disagrees with the plain version")
        if yard is not None:
            print(f"yardstick (not library_ms: no single call computes the "
                  f"kernel): {n_iter + 1} torch.mm [{FLEET}, {ROOF_N}] x "
                  f"[{ROOF_N}, {ROOF_N}] f32, TF32 off, {yard:.4f} ms")
    for n, bodies in box_crossover(ak, dev, sm_hz).items():
        for body, (err, tol, ms, cyc) in bodies.items():
            print(f"crossover fused_admm_box_shared n = {n}, B = {FLEET}, "
                  f"{CROSSOVER_ITERS} iterations, {body} body: {ms:.4f} ms "
                  f"(CUDA-graph replay), "
                  f"{cyc:.0f} cycles per iteration; max_abs_err {err:.3e} "
                  f"(tol {tol:.3e})")
            if not err <= tol:
                fail(f"fused_admm_box_shared ({body} body, n = {n}) "
                     f"disagrees with the plain version")
    for (n, refine), (err, tol, ms, body) in box_envelope(ak, dev).items():
        print(f"envelope fused_admm_box_shared n = {n}, B = {WIDE_B}, "
              f"{ITERS} iterations, refine {refine}, {body} body: max_abs_err "
              f"{err:.3e} (tol {tol:.3e}); kernel {ms:.4f} ms")
        if not err <= tol:
            fail(f"fused_admm_box_shared (n = {n}, refine {refine}) "
                 f"disagrees with the plain version")

    # phase 9: the shared general kernel against its plain version
    k6 = general_vs_plain(ak, c2)
    n2, m2 = c2["plan"].Q.shape[-1], c2["step"].state[0].shape[0]
    for body in ak.GENERAL_BODIES:
        if f"{body} body" in k6:
            b_err, b_ms = k6.pop(f"{body} body")
            print(f"kernel fused_admm_general_shared (config 2 operators, "
                  f"serving rho), {body} body forced: {b_ms:.4f} ms, "
                  f"max_abs_err {b_err:.3e} against the plain version")
            if not b_err <= k6["serving rho"][1]:
                fail(f"fused_admm_general_shared ({body} body) disagrees "
                     f"with the plain version")
    for case, (err, tol, ms, plain_ms, bnd, k64, p64) in k6.items():
        print(f"kernel fused_admm_general_shared (config 2 operators, n = "
              f"{n2}, m = {m2}, B = {FLEET}, {C2_ITERS} iterations, refine 1, "
              f"{case}): max_abs_err {err:.3e} (tol {tol:.3e}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}, f32), f64-pipe bound "
              f"{general_f64_bound(FLEET, n2, m2, C2_ITERS, 1):.4f} ms; "
              f"distance from the f64 iteration: kernel {k64:.3e}, plain "
              f"{p64:.3e}")
        if not err <= tol:
            fail(f"fused_admm_general_shared ({case}) disagrees with the "
                 f"plain version")
    for (n, m), (err, tol, ms, body) in general_envelope(ak, dev).items():
        print(f"envelope fused_admm_general_shared (n, m) = ({n}, {m}), B = "
              f"{WIDE_B}, {ITERS} iterations, refine 1, {body} body: "
              f"max_abs_err {err:.3e} (tol {tol:.3e}); kernel {ms:.4f} ms")
        if not err <= tol:
            fail(f"fused_admm_general_shared ((n, m) = ({n}, {m})) "
                 f"disagrees with the plain version")

    def report(cfg, label, kernel, n, out):
        u, sol, share, host_ms, dev_ms, err, lanes = out
        print(f"main path {cfg['name']}{label}: {FLEET * 1e3 / host_ms:.1f} "
              f"solves/s, {host_ms:.4f} host ms/tick, {dev_ms:.4f} device "
              f"ms/tick (CUDA events), {n} {kernel} launches over "
              f"{cfg['ticks'] + 2} ticks, converged share {share:.6f}, "
              f"max_err_vs_exact {err:.3e} on lanes {list(lanes)}")
        return err

    # phases 10 and 11: config 1 and the roofline fleet, accurate ticks
    k3_launches = 0
    for cfg in (c1, roof):
        reset_counts()
        out = serve_plan(tt, cfg)
        n = ak.fused_admm_box_shared.launches
        k3_launches += n
        err = report(cfg, "", "fused_admm_box_shared", n, out)
        if n == 0:
            fail(f"{cfg['name']}: the served path never launched "
                 f"fused_admm_box_shared")
        if not err <= ORACLE_TOL:
            fail(f"{cfg['name']}: max_err_vs_exact {err:.3e} > {ORACLE_TOL}")

    # phase 11, second part: the roofline fleet through the f32 fused tick
    fast = dict(roof, name="roofline fleet, f32 fused tick",
                plan=f32_plan(roof["plan"]),
                ticks=min(SHORT_TICKS, ROOF_TICKS))
    fast["step"], rho = fast_step(tt, fast["plan"], roof["opts"],
                                  roof["x0s"], roof["x0s"].mean(0))
    print(f"setup: {fast['name']}, rho={rho:.6g} from auto_rho of this "
          f"step")
    reset_counts()
    out = serve_plan(tt, fast)
    n = ak.fused_admm_box_shared.launches
    k3_launches += n
    report(fast, " (not gated)", "fused_admm_box_shared", n, out)
    if n == 0:
        fail("the f32 fused tick never launched fused_admm_box_shared")

    # phase 12: config 2 through the shared general kernel, then plain
    reset_counts()
    out = serve_plan(tt, c2)
    k6_launches = ak.fused_admm_general_shared.launches
    err = report(c2, "", "fused_admm_general_shared", k6_launches, out)
    if k6_launches == 0:
        fail("config 2: the served path never launched "
             "fused_admm_general_shared")
    if not err <= ORACLE_TOL:
        fail(f"config 2: max_err_vs_exact {err:.3e} > {ORACLE_TOL}")
    plain_step = tt.make_plan_step(c2["plan"], c2["opts"], batched=True,
                                   seed_center=c2["center"], use_fused=False)
    reset_counts()
    out = serve_plan(tt, c2, step=plain_step)
    report(c2, " through use_fused=False (not gated)", "kernel",
           ak.fused_admm_general_shared.launches, out)

    # phase 13: config 4 in f32 through the f32 fused tick (per-lane K2)
    c4 = dict(name="config 4, f32 fused tick", plan=f32_plan(plan4),
              x0_seq=x0_dev4, ticks=SHORT_TICKS)
    x0s4 = x0_dev4[0].cpu().numpy().astype(np.float64)
    c4["step"], rho = fast_step(tt, c4["plan"], opts4, x0s4, x0s4)
    opts4 = opts4.replace(rho=rho)
    print(f"setup: {c4['name']}, rho={rho:.6g} from auto_rho of this step")
    k2 = k2_vs_plain(ak, c4["step"], c4["plan"], opts4, x0_dev4[0], sm_hz)
    reset_counts()
    out = serve_plan(tt, c4)
    k2_launches = ak.fused_admm_box.launches
    report(c4, " (not gated)", "fused_admm_box", k2_launches, out)
    if k2_launches == 0:
        fail("the f32 fused tick never launched fused_admm_box")

    # K3's record: the roofline fleet's serving call (refine 0)
    r_err, r_ms, r_plain, r_bnd = k3[("roofline fleet",
                                      "refine 0, serving rho")]
    serving6 = k6["serving rho"]
    return cfgs, {
        "fused_admm_box": kernel_record(
            "fused_admm_box", KERNEL_SOURCE, REPLACES_K2, k2_launches,
            max(v[0] for v in k2.values()),
            *k2[f"serving rho, refine {max(opts4.kkt_refine, 0)}"][1:]),
        "fused_admm_box_shared": kernel_record(
            "fused_admm_box_shared", SHARED_SOURCE, REPLACES_K3, k3_launches,
            max(v[0] for v in k3.values()), r_ms, r_plain, r_bnd),
        "fused_admm_general_shared": kernel_record(
            "fused_admm_general_shared", GENERAL_SOURCE, REPLACES_K6,
            k6_launches, max(v[0] for v in k6.values()), serving6[2],
            serving6[3], serving6[4]),
    }


# ---------------------------------------------------------------------------
# The general solver and the facade: the Cholesky and per-lane general
# kernels against their plain versions, and phases 14-18.
# ---------------------------------------------------------------------------


def chol_vs_plain(ck, K, label: str, sm_hz: float = 0.0):
    """The Cholesky kernel on ``K [B, n, n]`` against its plain version and
    the library: its factor held to the plain one and as a factor of K,
    the same factor from K with garbage in its strict upper triangle (the
    kernel reads only the lower one); timed by CUDA-graph replay and
    eagerly beside the plain version, ``torch.linalg.cholesky`` and
    ``torch.linalg.cholesky_ex``, with its bound, registers, spills and
    blocks an SM; given the SM clock ``sm_hz``, also cycles a column on the
    first 1, 2, ... blocks an SM of matrices.  Returns ``(err, graph_ms,
    plain_ms, library_ms, bound)`` and fails the run on a disagreement."""
    import torch

    f64 = K.dtype == torch.float64
    B, n = K.shape[0], K.shape[-1]
    L = ck.chol_batched(K)
    want = ck.chol_plain(K)
    G = K.clone()
    iu = torch.triu_indices(n, n, 1, device=K.device)
    G[:, iu[0], iu[1]] = 1e3 * torch.randn(
        B, iu.shape[1], dtype=K.dtype, device=K.device,
        generator=torch.Generator(K.device).manual_seed(n))
    Lg = ck.chol_batched(G)
    torch.cuda.synchronize()
    if L.shape != K.shape or not bool(L.isfinite().all()):
        fail(f"chol_batched ({label}): bad output")
    if float(torch.triu(L, 1).abs().max()) != 0.0:
        fail(f"chol_batched ({label}): the upper triangle is not zero")
    if not torch.equal(L, Lg):
        fail(f"chol_batched ({label}): the strict upper triangle of K "
             f"changed the factor")
    err = float((L - want).abs().max())
    tol = CHOL_F64_TOL if f64 else CHOL_F32_RTOL * float(want.abs().max())
    rec = float((L @ L.mT - K).abs().max() / K.abs().max())
    rec_tol = CHOL_F64_REC if f64 else CHOL_F32_REC
    line = (f"kernel chol_batched ({label}, B = {B}, n = {n}, "
            f"{'float64' if f64 else 'float32'}): max |L - L_plain| "
            f"{err:.3e} (tol {tol:.3e}), max |L L' - K| / max |K| {rec:.3e} "
            f"(tol {rec_tol:.0e}), garbage above the diagonal: the same L")
    if not (err <= tol and rec <= rec_tol):
        print(line)
        fail(f"chol_batched ({label}) disagrees with the plain version")
    ms = _graph_ms(lambda: ck.chol_batched(K), 20)
    eager_ms = _cuda_ms(lambda: ck.chol_batched(K), 20)
    plain_ms = _cuda_ms(lambda: ck.chol_plain(K), 2)
    lib_ms = {name: _cuda_ms(lambda: getattr(torch.linalg, name)(K), 10)
              for name in ("cholesky", "cholesky_ex")}
    bnd = bound(*chol_work(B, n, K.element_size()),
                peak=F64_PEAK if f64 else F32_PEAK)
    body = ("small", "block")[ck.chol_config(n, K.dtype)[0] - 1]
    regs, spill, _, per_sm, smem = ck._chol_attributes(n, K.dtype)
    print(f"{line}; {body} body, kernel {ms:.4f} ms by graph replay "
          f"({eager_ms:.4f} eager), plain {plain_ms:.4f} ms, "
          f"torch.linalg.cholesky {lib_ms['cholesky']:.4f} ms, "
          f"torch.linalg.cholesky_ex {lib_ms['cholesky_ex']:.4f} ms, bound "
          f"{bnd[0]:.5f} ms ({bnd[1]}: lower triangle read, L written; "
          f"{100 * bnd[0] / ms:.1f}% of it); {regs} registers, {spill} "
          f"spill bytes, {per_sm} blocks an SM, {smem} shared bytes a block")
    if sm_hz:
        # cycles a column on the first k blocks an SM of matrices: flat in
        # k when one matrix's chain of columns sets the pace, growing with
        # k when instruction issue does
        per_wave = ck.chol_config(n, K.dtype)[3] * \
            torch.cuda.get_device_properties(K.device).multi_processor_count
        sweep = []
        for k in range(1, per_sm + 1):
            if (k - 1) * per_wave >= B:
                break
            part = K[:min(B, k * per_wave)]
            k_ms = _graph_ms(lambda: ck.chol_batched(part), 20)
            sweep.append(f"{part.shape[0]} matrices "
                         f"{k_ms * 1e-3 * sm_hz / n:.0f}")
        print(f"kernel chol_batched ({label}), cycles a column by matrices "
              f"(1..{per_sm} blocks an SM): {', '.join(sweep)}; whole batch "
              f"{ms * 1e-3 * sm_hz / n:.0f}")
    return err, ms, plain_ms, min(lib_ms.values()), bnd


def build_config2_ltv(tt, device, dtype, batch: int = 0):
    """Config 2's costs and constraints on per-lane LTV dynamics: A and B
    perturbed by 1e-3 per lane (``bench_all.py:config3``'s fleet), so every
    lane has its own condensed rows.  Returns the batched system, the
    terms and a drifting x0 sequence (numpy, float64)."""
    import torch

    N, batch = C2_N, batch or FLEET
    A, B, d = double_integrator()
    rng = np.random.default_rng(3)
    As = np.repeat(np.repeat(A[None], N, 0)[None], batch, 0)
    As += rng.normal(scale=1e-3, size=As.shape)
    Bs = np.repeat(np.repeat(B[None], N, 0)[None], batch, 0)
    Bs += rng.normal(scale=1e-3, size=Bs.shape)
    ds = np.repeat(np.repeat(d[None], N, 0)[None], batch, 0)
    x0s = np.array([1.0, 0.0])[None] + rng.normal(scale=[0.3, 0.2],
                                                  size=(batch, 2))
    drift = rng.normal(scale=0.02, size=(SHORT_TICKS + 2, batch, 2)).cumsum(0)
    ten = lambda a: torch.tensor(np.asarray(a, dtype), device=device)
    system = tt.LTVSystem(A=ten(As), B=ten(Bs), d=ten(ds), x0=ten(x0s))
    costs, constraints = config2_terms(tt, dtype)
    return system, costs, constraints, x0s[None] + drift


def lane_oracle_error(tt, system, costs, constraints, u, x0, lanes):
    """Max |u - exact| over ``lanes``: each lane's QP built by the port in
    float64 from the lane's own dynamics and solved by the native oracle."""
    import torch

    errs = []
    for lane in lanes:
        one = tt.LTVSystem(A=system.A[lane].double(),
                           B=system.B[lane].double(),
                           d=system.d[lane].double(),
                           x0=torch.tensor(np.asarray(x0[lane], np.float64),
                                           device=system.A.device))
        qp = tt.build_qp(tt.condense(one), one.x0, costs, constraints)
        exact = tt.solve_qp_native(qp).x.numpy()
        errs.append(float(np.abs(u[lane].double().cpu().numpy()
                                 - exact).max()))
    return max(errs)


def _timed(fn, reps: int):
    """``(last result, host ms, device ms, host ms to issue)`` per call of
    ``fn`` over ``reps`` calls, ended by a synchronize."""
    import torch

    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    t0 = time.perf_counter()
    for i in range(reps):
        out = fn(i)
    issue_ms = (time.perf_counter() - t0) * 1e3 / reps
    ev[1].record()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3 / reps,
            ev[0].elapsed_time(ev[1]) / reps, issue_ms)


def random_lanes_general(B: int, n: int, m: int, seed: int, device):
    """A per-lane general problem off the served paths: per lane C = [random
    rows; I] normalised, rho per lane and row (two rows 10x, their bounds
    equal), -inf lower bounds on some rows, +-inf on the last, a linear
    term and distinct non-zero x0, y0, z0 (f32 on ``device``)."""
    import torch

    rng = np.random.default_rng(seed)
    C = np.concatenate([rng.normal(size=(B, m - n, n)),
                        np.repeat(np.eye(n)[None], B, 0)], axis=1)
    C /= np.linalg.norm(C, axis=2, keepdims=True)
    rho = np.full((B, m), 0.3) * rng.uniform(0.5, 2.0, size=(B, 1))
    rho[:, :2] *= 10.0
    Mx = rng.normal(size=(B, n, n))
    K = (Mx @ Mx.transpose(0, 2, 1) / n + (1.0 + 1e-6) * np.eye(n)
         + (C.transpose(0, 2, 1) * rho[:, None, :]) @ C)
    l = -0.4 + 0.1 * rng.normal(size=(B, m))
    u = l + 0.8
    l[:, 2:(m - n) // 2] = -np.inf
    u[:, :2] = l[:, :2]
    l[:, -1], u[:, -1] = -np.inf, np.inf
    arrays = (np.linalg.inv(K), C, 0.3 * rng.normal(size=(B, n)), l, u, rho,
              0.2 * rng.normal(size=(B, n)), 0.1 * rng.normal(size=(B, m)),
              np.clip(0.2 * rng.normal(size=(B, m)), l, u))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


def lanes_general_envelope(ak, device):
    """The per-lane general kernel at the wide end of its envelope
    (``LANES_GENERAL_WIDE``, 30 iterations) against the plain version,
    printed; returns the largest distance."""
    import torch

    worst = 0.0
    for B, n, m in LANES_GENERAL_WIDE:
        args = random_lanes_general(B, n, m, m, device)
        kw = dict(n_iter=ITERS, sigma=1e-6, alpha=1.6)
        got = ak.fused_admm_general(*args, **kw)
        want = ak.admm_general_plain(*args, **kw)
        torch.cuda.synchronize()
        err, tol = held(got, want)
        ms = _cuda_ms(lambda: ak.fused_admm_general(*args, **kw), 3)
        body = _LANES_GENERAL_BODY[ak.general_lanes_config(n, m)[0]]
        print(f"envelope fused_admm_general (B, n, m) = ({B}, {n}, {m}), "
              f"{ITERS} iterations, {body} body: max_abs_err {err:.3e} "
              f"(tol {tol:.3e}); {ms:.4f} ms")
        if not err <= tol:
            fail(f"fused_admm_general at (n, m) = ({n}, {m}) disagrees with "
                 f"the plain version")
        worst = max(worst, err)
    return worst


_LANES_GENERAL_BODY = {1: "register", 2: "wide"}


def general_lanes_phase(tt, ak, ck, dev, reset_counts, sm_hz):
    """Phase 15; returns K7's record fields and the launches of K7 and K8
    on the served path."""
    import torch

    from copra_tpu_torch._tensors import matvec
    from copra_tpu_torch.qp.admm import stack_constraints

    f32 = torch.float32
    system, costs, constraints, x0_seq = build_config2_ltv(tt, dev,
                                                           np.float32)
    opts = tt.SolverOptions(
        max_iter=C2_ITERS, early_exit=False, scaling=0, row_normalize=False,
        kkt_solve="inverse", kkt_refine=0, polish=False,
        infeasibility_detection=False, seed="zero")
    preview = tt.condense(system)

    def lane_qp(x0):
        return tt.build_qp(preview, torch.tensor(x0.astype(np.float32),
                                                 device=dev),
                           costs, constraints)

    qp = lane_qp(x0_seq[0])
    C, l, u, rho = (t.contiguous() for t in stack_constraints(qp, opts))
    B, m, n = C.shape
    eye = torch.eye(n, dtype=f32, device=dev)
    K = (qp.Q + opts.sigma * eye + (C.mT * rho[:, None, :]) @ C).contiguous()
    sc = dict(n_iter=opts.max_iter, sigma=opts.sigma, alpha=opts.alpha)

    # the kernel against its plain version, from non-zero warm starts
    rng = np.random.default_rng(15)
    vec = lambda k: torch.tensor(0.1 * rng.normal(size=(B, k)), dtype=f32,
                                 device=dev)
    Kinv = torch.linalg.inv(K).contiguous()
    x0v, y0v = vec(n), vec(m)
    z0v = torch.clamp(vec(m), l, u)
    args = (Kinv, C, qp.c.contiguous(), l, u, rho, x0v, y0v, z0v)
    got = ak.fused_admm_general(*args, **sc)
    want = ak.admm_general_plain(*args, **sc)
    exact = ak.admm_general_plain(*(a.double() for a in args), **sc)
    torch.cuda.synchronize()
    err, tol = held(got, want)
    eager_ms = _cuda_ms(lambda: ak.fused_admm_general(*args, **sc), 10)
    ms = _graph_ms(lambda: ak.fused_admm_general(*args, **sc), 10)
    plain_ms = _cuda_ms(lambda: ak.admm_general_plain(*args, **sc), 2)
    bnd = bound(*lane_general_work(B, n, m, opts.max_iter))
    body = _LANES_GENERAL_BODY[ak.general_lanes_config(n, m)[0]]
    regs, spill, _, per_sm = ak._general_lanes_attributes(n, m)
    print(f"kernel fused_admm_general (config 2 on per-lane LTV dynamics, "
          f"B = {B}, n = {n}, m = {m}, {opts.max_iter} iterations, {body} "
          f"body): max_abs_err {err:.3e} (tol {tol:.3e}); kernel {ms:.4f} ms "
          f"by graph replay ({eager_ms:.4f} eager), "
          f"{ms * 1e-3 * sm_hz / opts.max_iter:.0f} cycles an iteration at "
          f"{sm_hz / 1e6:.0f} MHz, {bnd[0] / ms:.1%} of the bound; {regs} "
          f"registers, {spill} B spilled, {per_sm} blocks an SM; plain "
          f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); distance "
          f"from the f64 iteration: kernel {_max_diff(got, exact):.3e}, "
          f"plain {_max_diff(want, exact):.3e}")
    if not err <= tol:
        fail("fused_admm_general disagrees with the plain version")
    if body != "wide":
        # cycles an iteration on the first k blocks an SM of lanes: flat
        # in k when one lane's dependent chain sets the pace, growing with
        # k when instruction issue does
        lanes_sm = ak.general_lanes_config(n, m)[3] * \
            torch.cuda.get_device_properties(dev).multi_processor_count
        sweep = []
        for k in range(1, per_sm + 1):
            part = [a[:min(B, k * lanes_sm)] for a in args]
            k_ms = _graph_ms(lambda: ak.fused_admm_general(*part, **sc), 10)
            sweep.append(f"{part[0].shape[0]} lanes "
                         f"{k_ms * 1e-3 * sm_hz / opts.max_iter:.0f}")
        wide = lambda: ak._launch_general(*args, body="wide", **sc)
        w_err, _ = held(wide(), want)
        w_ms = _graph_ms(wide, 3)
        print(f"kernel fused_admm_general, cycles an iteration by lanes "
              f"(1..{per_sm} blocks an SM): {', '.join(sweep)}; wide body "
              f"forced at the same shape: max_abs_err {w_err:.3e} (tol "
              f"{tol:.3e}); {w_ms:.4f} ms by graph replay")
        if not w_err <= tol:
            fail("fused_admm_general's wide body disagrees with the plain "
                 "version")
    err = max(err, lanes_general_envelope(ak, dev))

    # the kernels served: K per lane factorized by chol_batched, Kinv from
    # the factor, warm-started fixed-count ticks of fused_admm_general
    reset_counts()
    S = 1.0 / torch.sqrt(torch.diagonal(K, dim1=-2, dim2=-1))
    Ls = ck.chol_batched((K * S[:, :, None] * S[:, None, :]).contiguous())
    Lsi = torch.linalg.solve_triangular(Ls, eye.expand_as(Ls), upper=False)
    Kinv = ((Lsi.mT @ Lsi) * S[:, :, None] * S[:, None, :]).contiguous()
    zeros = lambda k: torch.zeros((B, k), dtype=f32, device=dev)
    state = {"warm": (zeros(n), zeros(m), zeros(m))}

    def tick(t):
        q = lane_qp(x0_seq[t])
        _, lt, ut, _ = stack_constraints(q, opts)
        x, y, z = ak.fused_admm_general(
            Kinv, C, q.c.contiguous(), lt.contiguous(), ut.contiguous(), rho,
            *state["warm"], **sc)
        state["warm"] = (x, y, z)
        return x

    x_cold = tick(0)
    sol = tt.solve_qp_batched(qp, opts)
    torch.cuda.synchronize()
    diff = float((x_cold - sol.x).abs().max())
    stol = SOLVER_TOL * max(1.0, float(sol.x.abs().max()))
    tick(1)
    x, host_ms, dev_ms, issue_ms = _timed(lambda i: tick(2 + i),
                                          SHORT_TICKS)
    k7, k8 = ak.fused_admm_general.launches, ck.chol_batched.launches
    res = matvec(C, x)
    _, lt, ut, _ = stack_constraints(lane_qp(x0_seq[-1]), opts)
    viol = float(torch.clamp(torch.maximum(res - ut, lt - res), min=0).max())
    oerr = lane_oracle_error(tt, system, costs, constraints, x, x0_seq[-1],
                             (0, 1, 17, B - 1))
    print(f"main path per-lane general ADMM (chol_batched -> Kinv -> "
          f"fused_admm_general, {opts.max_iter} iterations per tick): "
          f"{B * 1e3 / host_ms:.1f} solves/s, {host_ms:.4f} host ms/tick, "
          f"{dev_ms:.4f} device ms/tick (CUDA events), {issue_ms:.4f} host "
          f"ms/tick to issue, {k7} "
          f"fused_admm_general and {k8} chol_batched launches over "
          f"{SHORT_TICKS + 2} ticks; cold tick vs solve_qp_batched at the "
          f"fixed-count settings: max |x - x_solver| {diff:.3e} (tol "
          f"{stol:.3e}); last tick: max row violation {viol:.3e}, "
          f"max_err_vs_exact {oerr:.3e} (f32, fixed rho {opts.rho:g}, not "
          f"gated)")
    if not bool(x.isfinite().all()):
        fail("per-lane general ADMM: non-finite solution")
    if k7 == 0 or k8 == 0:
        fail("the per-lane general path never launched its kernels")
    if not diff <= stol:
        fail("fused_admm_general disagrees with solve_qp_batched at the "
             "fixed-count settings")
    return (err, ms, plain_ms, bnd), k7, k8


def served_general_solver(tt, dev):
    """Phase 16: the per-lane config-2 fleet through ``solve_mpc_batch``
    with default options, float64 gated, float32 printed."""
    import torch

    lanes = (0, 1, 17, FLEET - 1)
    for dtype, gated in ((np.float64, True), (np.float32, False)):
        system, costs, constraints, x0_seq = build_config2_ltv(tt, dev, dtype)
        name = np.dtype(dtype).name

        def solve(i):
            x0 = torch.tensor(x0_seq[i].astype(dtype), device=dev)
            return tt.solve_mpc_batch(system.with_x0(x0), costs, constraints)

        solve(0)
        res, host_ms, dev_ms, _ = _timed(lambda i: solve(1 + i), 2)
        sol = res.solution
        if tuple(res.control.shape) != (FLEET, C2_N) or \
                not bool(res.control.isfinite().all()):
            fail(f"solve_mpc_batch ({name}): bad controls")
        share = float((sol.status == 0).float().mean())
        err = lane_oracle_error(tt, system, costs, constraints, res.control,
                                x0_seq[2], lanes)
        print(f"main path solve_mpc_batch (config 2 on per-lane LTV "
              f"dynamics, B = {FLEET}, default options, {name}): "
              f"{FLEET * 1e3 / host_ms:.1f} solves/s, {host_ms:.3f} host "
              f"ms/solve, {dev_ms:.3f} device ms/solve (CUDA events), "
              f"iterations {int(sol.iterations.min())}.."
              f"{int(sol.iterations.max())}, converged share {share:.6f}, "
              f"max_err_vs_exact {err:.3e} on lanes {list(lanes)}"
              f"{'' if gated else ' (not gated)'}")
        if gated and not err <= ORACLE_TOL:
            fail(f"solve_mpc_batch ({name}): max_err_vs_exact {err:.3e} > "
                 f"{ORACLE_TOL}")


def served_fused_mode(tt, ak, dev, plan4, opts4, x0_dev4, reset_counts):
    """Phase 17: ``bench.py``'s fused mode on the config-4 fleet, and the
    polished calls at B = 256.  Returns the ``fused_admm_box`` launches of
    the served ticks."""
    import torch

    arrays, _, _ = build_fleet(BATCH, HORIZON)
    system = tt.LTVSystem(*(torch.tensor(a, device=dev) for a in arrays))
    costs = (tt.TargetCost.create(np.eye(2), [0.0, -1.0],
                                  weights=[10.0, 1e4]),
             tt.ControlCost.create([[1.0]], [2.0], weights=[1e-4]))
    constraints = (tt.ControlBoundConstraint.create([-BOUND], [BOUND]),)
    opts = tt.SolverOptions(max_iter=ITERS, early_exit=False, polish=False,
                            rho=1.0, kkt_refine=0)
    state = {"warm": None}

    def tick(t, sys_=system, o=opts, warm=True):
        sys_t = sys_.with_x0(x0_dev4[t][:sys_.A.shape[0]])
        qp = tt.build_qp(tt.condense(sys_t), sys_t.x0, costs, constraints)
        sol = ak.solve_qp_batched_fused(qp, o,
                                        state["warm"] if warm else None)
        if warm:
            state["warm"] = tt.WarmStart(x=sol.x, y=sol.y, z=sol.z)
        return sol

    reset_counts()
    tick(0)
    tick(1)
    sol, host_ms, dev_ms, _ = _timed(lambda i: tick(2 + i), SHORT_TICKS)
    launches = ak.fused_admm_box.launches
    if tuple(sol.x.shape) != (BATCH, HORIZON) or \
            not bool(sol.x.isfinite().all()):
        fail("solve_qp_batched_fused: bad controls")
    lanes = (0, 1, 17, BATCH - 1)
    x0_last = x0_dev4[SHORT_TICKS + 1].cpu().numpy()
    err = gate_vs_oracle(tt, plan4, sol.x, x0_last, lanes)
    print(f"main path bench.py fused mode (config 4, condense -> build_qp "
          f"-> solve_qp_batched_fused, {ITERS} iterations, rho 1.0): "
          f"{BATCH * 1e3 / host_ms:.1f} solves/s, {host_ms:.4f} host "
          f"ms/tick, {dev_ms:.4f} device ms/tick (CUDA events), {launches} "
          f"fused_admm_box launches over {SHORT_TICKS + 2} ticks, converged "
          f"share {float((sol.status == 0).float().mean()):.6f}, "
          f"max_err_vs_exact {err:.3e} on lanes {list(lanes)} (not gated)")
    if launches == 0:
        fail("the fused mode never launched fused_admm_box")

    # polished, B = 256: the config-4 lanes (printed), then well-conditioned
    # random box QPs of the same width (gated)
    P = min(POLISH_LANES, BATCH)
    sub = tt.LTVSystem(*(torch.tensor(a[:P], device=dev) for a in arrays))
    pol = tick(0, sys_=sub, o=opts.replace(max_iter=500, polish=True,
                                           rho=opts4.rho), warm=False)
    lanes = tuple(sorted({0, 1, min(17, P - 1), P - 1}))
    err = gate_vs_oracle(tt, plan4, pol.x, x0_dev4[0].cpu().numpy(), lanes)
    print(f"solve_qp_batched_fused(polish=True) on {P} config-4 lanes (500 "
          f"iterations, rho {opts4.rho:.4g}): converged share "
          f"{float((pol.status == 0).float().mean()):.6f}, max_err_vs_exact "
          f"{err:.3e} on lanes {list(lanes)} (not gated: a float32 LU of "
          f"the ~1e8-conditioned Hessian)")
    rng = np.random.default_rng(6)
    n = HORIZON
    Ms = rng.normal(size=(P, n, n))
    f32 = lambda a: a.astype(np.float32)
    fields = dict(Q=f32(Ms @ Ms.transpose(0, 2, 1) + n * np.eye(n)),
                  c=f32(200.0 * rng.normal(size=(P, n))),
                  lb=f32(rng.uniform(-2.0, -0.5, size=(P, n))),
                  ub=f32(rng.uniform(0.5, 2.0, size=(P, n))))
    qp = tt.DenseQP.create(**{k: torch.tensor(v, device=dev)
                              for k, v in fields.items()})
    pol = ak.solve_qp_batched_fused(qp, tt.SolverOptions(
        max_iter=ITERS, early_exit=False, polish=True, rho=100.0))
    errs = []
    for lane in lanes:
        exact = tt.solve_qp_native(tt.DenseQP.create(
            **{k: v[lane].astype(np.float64) for k, v in fields.items()}))
        errs.append(float(np.abs(pol.x[lane].double().cpu().numpy()
                                 - exact.x.numpy()).max()))
    active = float(((pol.x <= qp.lb) | (pol.x >= qp.ub)).float().mean())
    print(f"solve_qp_batched_fused(polish=True) on {P} random box QPs (n = "
          f"{n}, Q = M M' + n I, {ITERS} iterations, rho 100): converged "
          f"share {float((pol.status == 0).float().mean()):.6f}, active "
          f"share {active:.3f}, max_err_vs_exact {max(errs):.3e} on lanes "
          f"{list(lanes)} (tol {POLISHED_TOL})")
    if not max(errs) <= POLISHED_TOL:
        fail(f"polished fused solve: max_err_vs_exact {max(errs):.3e} > "
             f"{POLISHED_TOL}")
    return launches


def facade_phase(tt, dev):
    """Phase 18: config 8's controller through ``LMPC`` against the
    active-set solver, then the ``max_wall_time_ms`` budgets."""
    import torch

    A, B, d = double_integrator(T=0.005)

    def controller(dtype, **kw):
        f = lambda a: torch.tensor(np.asarray(a, dtype), device=dev)
        system = tt.LTISystem.create(f(A), f(B), f(d), f([0.0, -1.5]),
                                     FACADE_N)
        ctrl = tt.LMPC(system, **kw)
        ctrl.add_cost(tt.TargetCost.create(f(np.eye(2)), f([0.0, -1.0]),
                                           weights=f([10.0, 1e4])))
        ctrl.add_cost(tt.ControlCost.create(f([[1.0]]), f([2.0]),
                                            weights=f([1e-4])))
        ctrl.add_constraint(tt.ControlBoundConstraint.create(f([-BOUND]),
                                                             f([BOUND])))
        return ctrl, f

    rng = np.random.default_rng(8)
    states = np.array([0.0, -1.5]) + rng.normal(scale=0.02,
                                                size=(FACADE_TICKS, 2))
    admm, f = controller(np.float64)
    exact, _ = controller(np.float64, solver="active_set")
    ok = admm.solve()
    exact.solve()
    errs = [float((admm.control() - exact.control()).abs().max())]
    walls = []
    for x0 in states:
        admm.set_initial_state(f(x0))
        exact.set_initial_state(f(x0))
        ok = admm.solve(warm_start=True) and ok
        exact.solve()
        walls.append(admm.solve_time() * 1e3)
        errs.append(float((admm.control() - exact.control()).abs().max()))
    u = admm.control()
    if tuple(u.shape) != (FACADE_N,) or not bool(u.isfinite().all()):
        fail("LMPC: bad controls")
    sat = float((u.abs() >= BOUND - 1e-9).float().mean())
    print(f"main path LMPC facade (config 8's controller, LTI N = "
          f"{FACADE_N}, float64, default options): solve() + "
          f"{FACADE_TICKS} warm solves, all solved {ok}, "
          f"{int(admm.results().solution.iterations)} iterations in the "
          f"last, median solve_time {float(np.median(walls)):.3f} ms, "
          f"saturated share {sat:.3f}; max |control - control_exact| "
          f"{max(errs):.3e} against LMPC(solver='active_set') (tol "
          f"{ORACLE_TOL})")
    if not (ok and max(errs) <= ORACLE_TOL):
        fail(f"LMPC: max |control - control_exact| {max(errs):.3e} > "
             f"{ORACLE_TOL} or a solve failed")

    for budget in BUDGETS_MS:
        ctrl, f = controller(np.float32)
        ctrl.options = tt.SolverOptions(max_iter=4000, early_exit=False,
                                        polish=False,
                                        max_wall_time_ms=budget)
        ctrl.solve()
        info = ctrl.deadline_info()
        walls = []
        for x0 in states:
            ctrl.set_initial_state(f(x0))
            t0 = time.perf_counter()
            ctrl.solve(warm_start=True)
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"LMPC max_wall_time_ms = {budget:g} ms (float32): "
              f"budget_iters {info['budget_iters']}, marginal "
              f"{info['marginal_ms_per_iter']:.5f} ms/iteration "
              f"({info['calibration_basis']}), overhead "
              f"{info['overhead_ms']:.3f} ms, feasible "
              f"{info['budget_feasible']}; measured median wall "
              f"{float(np.median(walls)):.3f} ms per solve (not gated)")


def wide_lanes_phase(tt, ak, dev, reset_counts, sm_hz):
    """Phase 19: config 4's fleet at horizon 300 (B = 512 per-lane plans of
    width 300, ~370 MB of f32 operators) served by the accurate tick
    through ``fused_admm_box_lanes`` (the streamed body), gated against the
    native oracle; then phase 3's cases at this width and
    ``fused_admm_box`` at refine 1 (rho 1.0 operators) against the plain
    version (2e-4 x max(1, max |plain|)).  Returns the served launches,
    the largest held error of ``fused_admm_box_lanes`` and that of
    ``fused_admm_box``."""
    import torch

    from copra_tpu_torch.plan import _box_fast_state

    B, N = WIDE_LANES, WIDE_HORIZON
    plan, opts, step, x0_dev, setup_s = build_serving(
        tt, dev, B, N, ITERS, rounds=WIDE_ROUNDS)
    print(f"setup: config 4 at N = {N}, B = {B}, {WIDE_ROUNDS} rounds: plan "
          f"+ auto_rho + step in {setup_s:.2f} s, rho={opts.rho:.6g}")
    reset_counts()
    u, sol, share, host_ms, dev_ms, issue_ms = run_ticks(step, plan, x0_dev,
                                                         SHORT_TICKS)
    launches = ak.fused_admm_box_lanes.launches
    if tuple(u.shape) != (B, N) or not bool(torch.isfinite(u).all()):
        fail(f"N = {N} tick: controls of shape {tuple(u.shape)}")
    if launches == 0:
        fail(f"the N = {N} tick never launched fused_admm_box_lanes")
    lanes = (0, 1, 17, B - 1)
    err = gate_vs_oracle(tt, plan, u, x0_dev[SHORT_TICKS + 1].cpu().numpy(),
                         lanes)
    print(f"main path config 4 at N = {N} (per-lane plans, accurate, "
          f"{WIDE_ROUNDS} rounds): {B * 1e3 / host_ms:.1f} solves/s, "
          f"{host_ms:.4f} host ms/tick, {dev_ms:.4f} device ms/tick (CUDA "
          f"events), {issue_ms:.4f} host ms/tick to issue, {launches} "
          f"fused_admm_box_lanes launches over "
          f"{SHORT_TICKS + 2} ticks, converged share {share:.6f}, "
          f"max_err_vs_exact {err:.3e} on lanes {list(lanes)}")
    if not err <= ORACLE_TOL:
        fail(f"N = {N} tick: max_err_vs_exact {err:.3e} > {ORACLE_TOL}")

    modes, bodies = kernel_vs_plain(ak, step, plan, opts, x0_dev[0])
    worst = report_box_lanes(ak, f"config 4 operators at N = {N}", modes,
                             bodies, B, N, sm_hz, relative=True)
    f32 = torch.float32
    Kinv1, K1 = (t.to(f32).contiguous() for t in
                 _box_fast_state(plan, opts.replace(rho=1.0)))
    rng = np.random.default_rng(19)
    vec = lambda: torch.tensor(0.1 * rng.normal(size=(B, N)), dtype=f32,
                               device=dev)
    l = torch.full((B, N), -0.2, dtype=f32, device=dev)
    args = (Kinv1, K1, vec(), l, -l, vec(), vec(), torch.clamp(vec(), l, -l))
    kw = dict(n_iter=ITERS, sigma=opts.sigma, alpha=opts.alpha, rho=1.0,
              refine=1)
    run = lambda: ak.fused_admm_box(*args, **kw)
    got = run()
    want = ak.admm_box_plain(*args, **kw)
    torch.cuda.synchronize()
    k2_err, tol = held(got, want)
    graph_ms = _graph_ms(run, 5)
    plain_ms = _cuda_ms(lambda: ak.admm_box_plain(*args, **kw), 2)
    bnd = bound(*box_work(B, N, ITERS, 1, "general", per_lane=True))
    print(f"kernel fused_admm_box (config 4 operators at N = {N}, rho 1.0, "
          f"refine 1, streamed body): max_abs_err {k2_err:.3e} (tol "
          f"{tol:.3e}); kernel {graph_ms:.4f} ms (CUDA-graph replay), plain "
          f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
          f"{bnd[0] / graph_ms:.1%} of the bound")
    if not k2_err <= tol:
        fail(f"fused_admm_box at N = {N} disagrees with the plain version")
    return launches, worst, k2_err


def general_solver_phases(tt, ak, ck, dev, plan4, opts4, x0_dev4, c1,
                          reset_counts, sm_hz):
    """Phases 14-18; returns the ``fused_admm_box`` launches of phase 17 and
    the kernel records of K7 and K8."""
    import torch

    f32 = torch.float32
    # phase 14: the Cholesky kernel against its plain version and the library
    p1, o1 = c1["plan"], c1["opts"]
    n1 = p1.Q.shape[-1]
    pen = o1.sigma + o1.rho * (1.0 + torch.arange(FLEET, device=dev) / FLEET)
    K1 = (p1.Q.to(f32) + pen.to(f32)[:, None, None]
          * torch.eye(n1, dtype=f32, device=dev)).contiguous()
    c1k = chol_vs_plain(ck, K1, "config 1's K, one penalty per lane", sm_hz)
    K4 = (plan4.Q.to(f32) + (opts4.sigma + opts4.rho) * torch.eye(
        plan4.Q.shape[-1], dtype=f32, device=dev)).contiguous()
    c4 = chol_vs_plain(ck, K4, "config 4's per-lane K", sm_hz)
    rng = np.random.default_rng(0)
    V = np.linalg.qr(rng.normal(size=(16, 24, 24)))[0]
    K64 = torch.tensor((V * np.logspace(-6, 4, 24)) @ V.transpose(0, 2, 1)
                       + (1e-6 + 0.1) * np.eye(24), device=dev)
    c64 = chol_vs_plain(ck, K64, "spectrum 1e-6..1e4 + ridge")
    # the envelope's edge (the reference sends n > 88 to jnp.linalg.cholesky)
    f64 = torch.float64
    Mx = torch.randn(CHOL_EDGE_B, CHOL_EDGE_N, CHOL_EDGE_N, dtype=f64,
                     device=dev, generator=torch.Generator(dev).manual_seed(0))
    K128 = Mx @ Mx.mT / CHOL_EDGE_N + 0.1 * torch.eye(CHOL_EDGE_N, dtype=f64,
                                                      device=dev)
    edge = [chol_vs_plain(ck, K128.to(dt).contiguous(),
                          "envelope edge, random SPD", sm_hz)
            for dt in (f32, f64)]
    chol_err = max(c[0] for c in (c1k, c4, c64, *edge))

    k7, k7_launches, k8_launches = general_lanes_phase(tt, ak, ck, dev,
                                                       reset_counts, sm_hz)
    served_general_solver(tt, dev)
    k2_launches = served_fused_mode(tt, ak, dev, plan4, opts4, x0_dev4,
                                    reset_counts)
    facade_phase(tt, dev)
    return k2_launches, {
        "fused_admm_general": kernel_record(
            "fused_admm_general", ADMM_GENERAL_SOURCE, REPLACES_K7,
            k7_launches, *k7),
        "chol_batched": kernel_record(
            "chol_batched", CHOL_SOURCE, REPLACES_K8, k8_launches,
            chol_err, c4[1], c4[2], c4[4], library_ms=c4[3]),
    }


# ---------------------------------------------------------------------------
# The multistep chains (phases 20-21) and the log-depth forms (phase 22).
# ---------------------------------------------------------------------------


def _no_sync(what: str, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: fails
    if it makes the host wait for the device."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    except RuntimeError as e:
        fail(f"{what} synced the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


def _profile(fn):
    """Device time by kernel of one ``fn()`` (``torch.profiler``): rows
    ``(ms, count, name)``, longest first; empty when the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    return sorted(rows, reverse=True)


def _report_profile(label: str, rows, span_ms: float, own=None,
                    top: int = 6) -> None:
    """The profile ``rows`` of one call beside ``span_ms``, that call's
    CUDA-event span: the kernels' busy time and the device's idle share.
    ``own = (name fragment, ms)`` is what the kernels so named take in one
    call by their own CUDA-event timing; where the profiler's records of
    them differ from it by more than 15%, the profile is not trusted and
    the idle share is not measured.  Busy time above the span by more than
    3% is a miscount and fails."""
    if not rows:
        print(f"profile {label}: the profiler saw no device time; idle "
              f"share not measured")
        return
    busy = sum(r[0] for r in rows)
    tops = "; ".join(f"{k[:60]} {ms:.4f} ms x{n}" for ms, n, k in rows[:top])
    head = f"profile {label}: kernels busy {busy:.4f} ms of a " \
        f"{span_ms:.4f} ms span"
    if own is not None:
        seen = sum(ms for ms, _, k in rows if own[0] in k)
        if abs(seen - own[1]) > 0.15 * own[1]:
            print(f"{head}; idle share not measured (the profiler saw "
                  f"{seen:.4f} ms of {own[0]}, its own timing gives "
                  f"{own[1]:.4f} ms); top: {tops}")
            return
    if busy > 1.03 * span_ms:
        fail(f"profile {label}: kernels busy {busy:.4f} ms exceed the "
             f"{span_ms:.4f} ms span")
    print(f"{head} (idle share {1.0 - busy / span_ms:.3f}); top: {tops}")


def _chain_launches(chains) -> str:
    return ", ".join(f"{w.__name__} {n}" for c in chains
                     for w, n in c.launches)


def chained_plan_phase(tt, ak, plan, opts, step, x0_dev, reset_counts,
                       k1_ms):
    """Phase 20: config 4's ticks through ``make_plan_multistep``, TICKS of
    them a call, from the warm state of phase 4's two warm-up ticks
    (``k1_ms``: K1's time a tick by graph replay, its ROUNDS x0 = 0
    bodies and the Q x pass).  Returns the kernel's launches (the warm-up
    run and the replays)."""
    import torch

    seq = torch.stack(x0_dev[2:2 + TICKS])
    warm = None
    for t in range(2):
        _, _, warm = step(plan, x0_dev[t], warm)
    _no_sync("an eager accurate tick (phase 4's step)",
             lambda: step(plan, x0_dev[2], warm))
    w, loop = warm, []
    for t in range(TICKS):
        u, _, w = step(plan, x0_dev[2 + t], w)
        loop.append(u)
    x0s = build_fleet(BATCH, HORIZON)[1]
    reset_counts()
    many = tt.make_plan_multistep(plan, opts, seed_center=x0s,
                                  accurate_rounds=ROUNDS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    us, statuses, _, _ = many(seq, warm)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    if len(many.chains) != 1:
        fail(f"make_plan_multistep captured {len(many.chains)} chains")
    same = max(float((us[t] - loop[t]).abs().max()) for t in range(TICKS))
    (us, statuses, _, _), host_ms, dev_ms, issue_ms = _timed(
        lambda i: many(seq, warm), 5)
    host_ms, dev_ms, issue_ms = (v / TICKS for v in (host_ms, dev_ms,
                                                    issue_ms))
    _no_sync("a make_plan_multistep replay", lambda: many(seq, warm))
    _report_profile(f"config 4 chained, one replay of {TICKS} ticks",
                    _profile(lambda: many(seq, warm)), dev_ms * TICKS,
                    own=("box_", k1_ms * TICKS))
    launches = ak.fused_admm_box_lanes.launches
    if launches == 0:
        fail("the chained main path never launched fused_admm_box_lanes")
    err = gate_vs_oracle(tt, plan, us[-1], x0_dev[TICKS + 1].cpu().numpy(),
                         (0, 1, 17, BATCH - 1))
    share = float((statuses == 0).double().mean())
    print(f"main path chained (config 4, {TICKS} ticks a CUDA graph): "
          f"{BATCH * 1e3 / host_ms:.1f} solves/s, {host_ms:.4f} host "
          f"ms/tick, {dev_ms:.4f} device ms/tick (CUDA events), "
          f"{issue_ms:.4f} host ms/tick to issue; capture (warm-up run, "
          f"capture, first replay) {capture_s:.3f} s; launches a replay: "
          f"{_chain_launches(many.chains.values())}; {launches} "
          f"fused_admm_box_lanes launches in all; converged share "
          f"{share:.6f}; max |U - per-tick loop| {same:.3e}; "
          f"max_err_vs_exact {err:.3e} on lanes {[0, 1, 17, BATCH - 1]}")
    if not same <= 1e-12:
        fail(f"chained ticks differ from the per-tick loop by {same:.3e}")
    if not err <= ORACLE_TOL:
        fail(f"chained max_err_vs_exact {err:.3e} > {ORACLE_TOL}")
    return launches


def _stack(seq):
    import torch

    return torch.stack(list(seq))


def _drifted(sqp):
    """A model update of a served problem, for a replan: the couplings of
    the dynamics 2% stronger (the off-diagonal of A, which keeps a
    triangular A's eigenvalues), B 2% stronger, the costs Qx, Ru and qx 5%
    higher."""
    import dataclasses

    import torch

    diag = torch.diag_embed(torch.diagonal(sqp.A, dim1=-2, dim2=-1))
    return dataclasses.replace(sqp, A=sqp.A + 0.02 * (sqp.A - diag),
                               B=sqp.B * 1.02, Qx=sqp.Qx * 1.05,
                               Ru=sqp.Ru * 1.05, qx=sqp.qx * 1.05)


def _bit_equal(got, want) -> bool:
    """Two calls' ``(states, U0s, statuses, info, warm)``, bit for bit."""
    import dataclasses

    import torch

    pairs = list(zip(got[:3], want[:3])) + list(zip(got[4], want[4]))
    pairs += [(getattr(got[3], f.name), getattr(want[3], f.name))
              for f in dataclasses.fields(got[3])]
    return all(torch.equal(a, b) for a, b in pairs)


def chained_stagewise_phase(tt, sk, cfg, reset_counts, kernel_ms):
    """Phase 21 for one stagewise config: ``make_stagewise_multistep``
    with the served options (backend ``"fused"``): an ``x0_seq`` chain of
    the config's drifting states, gated against the native oracle at the
    last state; the plant mode, gated at the last state it solved; a
    replan that moves the dynamics and the costs, after which both chains
    run with no new capture.  The tick kernel's launches are read right
    after these calls of the chain and returned.  Then, counted apart: the
    chain held against the eager per-tick loop, the replanned chains
    against a fresh facade on the new data (bit for bit), the ticks whose
    top-up ran, the status pass timed and a replay profiled
    (``kernel_ms``: the tick kernel's ms at the warm iteration count, from
    phase 5)."""
    import torch
    from copra_tpu_torch.qp.riccati import make_stagewise_step

    seq = _stack(cfg["x0_seq"])
    T, B = seq.shape[:2]
    kw = dict(cold_options=cfg["cold_opts"], backend="fused",
              scaling="none" if cfg["scale"] is None else cfg["scale"])
    # the chained main path alone: the leading cold tick, the captures,
    # the replays, a replan and the replays after it
    reset_counts()
    many = tt.make_stagewise_multistep(cfg["fleet"], cfg["opts"], **kw)
    entry = (sk.fused_stagewise_tick if many._data[3].mode == "resident"
             else sk.fused_stagewise_tick_streamed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, _, _, warm = many(None, T, x0_seq=seq)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    out, host_ms, dev_ms, issue_ms = _timed(
        lambda i: many(None, T, warm=warm, x0_seq=seq), 3)
    host_ms, dev_ms, issue_ms = (v / T for v in (host_ms, dev_ms, issue_ms))
    _, u0s, statuses, info, _ = out
    _no_sync(f"a {cfg['name']} chain replay",
             lambda: many(None, T, warm=warm, x0_seq=seq))
    # plant mode: the leading cold tick, then T chained ticks
    states, _, _, pinfo, _ = many(seq[0], T)
    chains = dict(many.chains)
    new = _drifted(cfg["fleet"])
    many.replan(new)
    got = (many(None, T, warm=warm, x0_seq=seq), many(seq[0], T))
    torch.cuda.synchronize()
    launches = entry.launches
    if launches == 0:
        fail(f"{cfg['name']}: the chain never launched {entry.__name__}")
    if set(chains) != {(T, True), (T, False)} or many.chains != chains:
        fail(f"{cfg['name']}: the replan captured a chain again "
             f"({sorted(chains)} -> {sorted(many.chains)})")
    per_replay = _chain_launches(chains.values())
    U_last = info.x.reshape(B, -1, u0s.shape[-1])
    rel, err = gate_stagewise(cfg, U_last)
    prel, perr = gate_stagewise(cfg, pinfo.x.reshape(B, -1, u0s.shape[-1]),
                                states[-2].cpu().numpy())
    # not counted from here: the eager twins and the fresh facade
    fresh = tt.make_stagewise_multistep(new, cfg["opts"], **kw)
    want = (fresh(None, T, warm=warm, x0_seq=seq), fresh(seq[0], T))
    replan_same = all(_bit_equal(g, w) for g, w in zip(got, want))
    moved = float((got[0][3].x - info.x).abs().max())
    tick = make_stagewise_step(cfg["fleet"], cfg["opts"], **kw)
    _no_sync(f"an eager {cfg['name']} warm tick (device top-up)",
             lambda: tick(seq[0], warm))
    w, loop = warm, []
    for t in range(T):
        w_in = w
        X_t, U_t, info_t, w = tick(seq[t], w)
        loop.append(U_t[:, 0])
    scale = max(1.0, float(U_last.abs().max()))
    same = max(float((u0s[t] - loop[t]).abs().max()) for t in range(T))
    same = max(same, float((info.x - info_t.x).abs().max())) / scale
    share = float((statuses == 0).double().mean())
    # the ticks whose top-up ran: the first run of each eager tick, from
    # the same warm state, with no top-up
    first = make_stagewise_step(cfg["fleet"], cfg["opts"].replace(
        topup_iters=0), **kw)
    w, fired = warm, 0
    for t in range(T):
        fired += int(not bool((first(seq[t], w)[2].status == 0).all()))
        w = tick(seq[t], w)[3]
    # the status pass (the log-depth dual residual) on the last eager
    # tick's iterates, in the solver's (scaled) space
    fp = tick._plans[tick._plan_key(cfg["opts"])]
    Xs, Us = X_t, U_t
    if cfg["scale"] is not None:
        Xs, Us = X_t / cfg["scale"][0], U_t / cfg["scale"][1]
    status = lambda: sk._lane_residuals(fp.sqp, cfg["opts"], fp.rho_x,
                                        fp.rho_u, fp.rows, Xs, Us, *w_in)
    status_ms = _cuda_ms(status, 5)
    status_graph_ms = _graph_ms(status, 5)
    # one replay on the config's own data again, profiled, beside the tick
    # kernel's own total: T warm runs and the top-ups that ran
    opts = cfg["opts"]
    own = kernel_ms * (T + fired * opts.topup_iters / opts.max_iter)
    many.replan(cfg["fleet"])
    _report_profile(f"{cfg['name']} chained, one replay of {T} ticks",
                    _profile(lambda: many(None, T, warm=warm, x0_seq=seq)),
                    dev_ms * T, own=("stagewise_tick_kernel", own))
    _report_profile(f"{cfg['name']} status pass, eager", _profile(status),
                    status_ms)
    print(f"main path chained {cfg['name']} ({T} ticks a CUDA graph, "
          f"x0_seq): {host_ms:.4f} host ms/tick, {dev_ms:.4f} device "
          f"ms/tick (CUDA events), {issue_ms:.4f} host ms/tick to issue; "
          f"capture (cold tick, warm-up run, capture, first replay) "
          f"{capture_s:.3f} s; launches a replay: {per_replay}; "
          f"{launches} {entry.__name__} launches on the chained path "
          f"(cold ticks, warm-up runs, replays); converged share "
          f"{share:.6f}; status pass {status_ms:.4f} device ms eager, "
          f"{status_graph_ms:.4f} by graph replay; top-up ran on {fired} of "
          f"{T} ticks; max |chain - per-tick loop| / scale {same:.3e}; "
          f"max_err_vs_exact {err:.3e}, max_err_rel {rel:.3e}; plant mode "
          f"max_err_rel {prel:.3e} ({perr:.3e}); after a replan of A, B, "
          f"Qx, Ru and qx (controls moved {moved:.3e}, no new capture) "
          f"both chains equal a fresh facade bit for bit: {replan_same}")
    if not same <= F32_RTOL:
        fail(f"{cfg['name']}: the chain differs from the per-tick loop by "
             f"{same:.3e}")
    if not (rel <= REL_TOL and prel <= REL_TOL):
        fail(f"{cfg['name']} chained: max_err_rel {rel:.3e} / plant "
             f"{prel:.3e} > {REL_TOL}")
    if not (replan_same and moved > 0.0):
        fail(f"{cfg['name']}: the replanned chains differ from a fresh "
             f"facade (moved {moved:.3e})")
    return launches


def assoc_phase(tt, dev, plan_arrays, cfg5):
    """Phase 22: the log-depth forms on the card against their serial
    forms, in float64 (relative 1e-9): ``condense_ltv_assoc`` at config
    4's width (B = 4096, N = 100), ``lqr_solve_assoc`` at config 5's (512
    lanes, N = 300, x = 3, u = 1, with the rows' cross term), the
    parallel dual residual on config 5's served data and at the fused
    envelope's widest state (128 lanes, N = 300, x = 64, u = r = 32,
    with its work memory); each timed beside its serial form."""
    import dataclasses

    import torch
    from copra_tpu_torch.qp import riccati as tr

    f64 = lambda a: torch.as_tensor(a, device=dev).double()
    As, Bs, ds = (f64(a) for a in plan_arrays[:3])
    lines, worst = [], 0.0

    def held(name, fast, slow, reps=3):
        nonlocal worst
        got, want = fast(), slow()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        scale = max(1.0, max(float(w.abs().max()) for w in want))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        worst = max(worst, err / scale)
        lines.append(f"{name} rel err {err / scale:.3e}, "
                     f"{_cuda_ms(fast, reps):.4f} ms (serial "
                     f"{_cuda_ms(slow, reps):.4f} ms)")

    held("condense_ltv_assoc (4096, 100, 2, 1)",
         lambda: tuple(getattr(tt.condense_ltv_assoc(As, Bs, ds), k)
                       for k in ("Phi", "Psi", "xi")),
         lambda: tuple(getattr(tt.condense_ltv(As, Bs, ds), k)
                       for k in ("Phi", "Psi", "xi")))
    sqp = tr.StagewiseQP(**{
        f.name: None if getattr(cfg5["fleet"], f.name) is None
        else getattr(cfg5["fleet"], f.name).double()
        for f in dataclasses.fields(cfg5["fleet"])})
    opts = cfg5["opts"]
    rho_x = tr._box_penalties(sqp.xlb, sqp.xub, float(opts.rho))
    rho_u = tr._box_penalties(sqp.ulb, sqp.uub, float(opts.rho))
    Qx_r, Ru_r, S, rows = tr._penalized(sqp, opts, rho_x, rho_u)
    # an ADMM iteration's linear terms: the costs shifted by random
    # penalty terms, from the config's last drifting state
    rng = torch.Generator(device=dev).manual_seed(22)
    noise = lambda t: 0.1 * torch.randn(t.shape, generator=rng, device=dev,
                                        dtype=torch.float64)
    lq = (sqp.A, sqp.B, sqp.d, Qx_r, sqp.qx + noise(sqp.qx), Ru_r,
          sqp.ru + noise(sqp.ru), cfg5["x0_seq"][-1].double())
    held("lqr_solve_assoc (512, 300, 3, 1), cross term",
         lambda: tr.lqr_solve_assoc(*lq, S=S),
         lambda: tr.lqr_solve(*lq, S=S))
    X, U = tr.lqr_solve(*lq, S=S)
    yX = 0.1 * torch.randn(X.shape, generator=rng, device=dev,
                           dtype=torch.float64)
    yU = 0.1 * torch.randn(U.shape, generator=rng, device=dev,
                           dtype=torch.float64)
    yS = 0.1 * torch.randn(sqp.clo.shape, generator=rng, device=dev,
                           dtype=torch.float64)
    held("stagewise_dual_residual parallel (512, 300, 3, 1, 2)",
         lambda: tr.stagewise_dual_residual(sqp, X, U, yX, yU, yS,
                                            parallel=True),
         lambda: tr.stagewise_dual_residual(sqp, X, U, yX, yU, yS))
    # the fused envelope's widest state (x + u + r = 128), where the scan's
    # combine takes its matrix-product form; random stable dynamics
    Bw, Nw, xw, uw, rw = 128, 300, 64, 32, 32
    rn = lambda *shape: torch.randn(shape, generator=rng, device=dev,
                                    dtype=torch.float64)
    eye = torch.eye(xw, device=dev, dtype=torch.float64)
    wide = tr.StagewiseQP(
        A=0.9 * eye + 0.05 * rn(Bw, Nw, xw, xw) / xw ** 0.5,
        B=rn(Bw, Nw, xw, uw), d=rn(Bw, Nw, xw), Qx=rn(Bw, Nw + 1, xw, xw),
        qx=rn(Bw, Nw + 1, xw), Ru=rn(Bw, Nw, uw, uw), ru=rn(Bw, Nw, uw),
        x0=rn(Bw, xw), xlb=rn(Bw, Nw + 1, xw), xub=rn(Bw, Nw + 1, xw),
        ulb=rn(Bw, Nw, uw), uub=rn(Bw, Nw, uw), Cx=rn(Bw, Nw, rw, xw),
        Cu=rn(Bw, Nw, rw, uw), clo=rn(Bw, Nw, rw), chi=rn(Bw, Nw, rw))
    wv = (rn(Bw, Nw + 1, xw), rn(Bw, Nw, uw), rn(Bw, Nw + 1, xw),
          rn(Bw, Nw, uw), rn(Bw, Nw, rw))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tr.stagewise_dual_residual(wide, *wv, parallel=True)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    data_gb = _nbytes(*(getattr(wide, f.name) for f in
                        dataclasses.fields(wide)), *wv) / 1e9
    held(f"stagewise_dual_residual parallel ({Bw}, {Nw}, {xw}, {uw}, "
         f"{rw})",
         lambda: tr.stagewise_dual_residual(wide, *wv, parallel=True),
         lambda: tr.stagewise_dual_residual(wide, *wv))
    lines[-1] += (f", {peak_gb:.3f} GB of work memory beside {data_gb:.3f} "
                  f"GB of data")
    print("log-depth forms: " + "; ".join(lines))
    if not worst <= 1e-9:
        fail(f"a log-depth form differs from its serial form by {worst:.3e}")


# ---------------------------------------------------------------------------
# The no-knobs layer (phases 23-26): the early-exit solve on K4/K5, the f64
# polish, the measured serving policies and make_stagewise_server, and
# solve.
# ---------------------------------------------------------------------------


def _on(sqp, device, dtype=None, lanes=None):
    """``sqp`` (a StagewiseQP) on ``device`` in ``dtype``, cut to
    ``lanes``."""
    import dataclasses

    return dataclasses.replace(sqp, **{
        f.name: None if getattr(sqp, f.name) is None
        else (getattr(sqp, f.name) if lanes is None
              else getattr(sqp, f.name)[lanes]).to(device=device, dtype=dtype)
        for f in dataclasses.fields(sqp)})


def _entry(sk, sqp):
    return (sk.fused_stagewise_tick
            if sk.fused_mode(sqp.horizon, sqp.xdim, sqp.udim, sqp.nr_rows,
                             sqp.A.dtype) == "resident"
            else sk.fused_stagewise_tick_streamed)


def early_exit_phase(tt, sk, cfgs, reset_counts):
    """Phase 23: ``solve_stagewise(early_exit=True)`` on the card (the
    chunked route on K4 at config 5's shape, on K5 at config 6's,
    equilibrated) against the plain early-exit loop on CPU copies, 2
    lanes, float64 and float32.  Returns the launches by entry point."""
    import torch
    from copra_tpu_torch.qp.riccati import scale_stagewise

    launches = {}
    for cfg in cfgs:
        sqp = cfg["fleet"]
        if cfg["scale"] is not None:
            sqp = scale_stagewise(sqp, *cfg["scale"])
        opts = cfg["cold_opts"].replace(max_iter=EE_ITERS, early_exit=True,
                                        eps_rel=0.0, check_interval=10)
        line = []
        for dt in (torch.float64, torch.float32):
            card = _on(sqp, sqp.A.device, dt, slice(0, 2))
            entry = _entry(sk, card)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = tt.solve_stagewise(card, opts)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            n = entry.launches
            launches[entry.__name__] = launches.get(entry.__name__, 0) + n
            want = tt.solve_stagewise(_on(card, "cpu"), opts)
            it_g, it_w = got[2].iterations.cpu(), want[2].iterations
            st_g, st_w = got[2].status.cpu(), want[2].status
            scale = max(1.0, max(float(w.abs().max()) for w in want[:2]))
            rel = max(float((g.cpu() - w).abs().max())
                      for g, w in zip(got[:2], want[:2])) / scale
            tol = F64_TOL if dt == torch.float64 else F32_RTOL
            line.append(f"{str(dt)[6:]}: iterations {it_g.tolist()} (plain "
                        f"{it_w.tolist()}), statuses {st_g.tolist()} (plain "
                        f"{st_w.tolist()}), X/U rel {rel:.3e} (tol {tol}); "
                        f"{n} {entry.__name__} launches, {ms:.1f} ms")
            if n == 0:
                fail(f"{cfg['name']} early exit: no {entry.__name__} launch")
            if not (torch.equal(it_g, it_w) and torch.equal(st_g, st_w)
                    and rel <= tol):
                fail(f"{cfg['name']} early exit {dt}: the kernel route "
                     f"differs from the plain loop: " + line[-1])
        print(f"early-exit route, {cfg['name']}'s shape (2 lanes, "
              f"{EE_ITERS} iterations at most, eps_abs {opts.eps_abs:g}, "
              f"rho {opts.rho:g}, a check every 10): " + "; ".join(line))
    return launches


def build_config1_stagewise(tt, device):
    """Config 1's problem (``bench_all.py:config1``) in stagewise form
    over the fleet, its native-oracle plan and the drifting states of
    ``bench_all.py:_stagewise_line``."""
    import dataclasses

    import torch
    from copra_tpu_torch.qp.riccati import from_mpc

    N, batch = C1_N, FLEET
    A, B, d = double_integrator()
    rng = np.random.default_rng(1)
    x0s = np.array([1.0, 0.0])[None] + rng.normal(scale=[0.3, 0.2],
                                                  size=(batch, 2))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    system = tt.LTISystem.create(f32(A), f32(B), f32(d), f32(x0s[0]), N)
    costs = (tt.TrajectoryCost(M=tt.span_matrix(f32([[1.0, 0.0]]), N + 1),
                               p=f32(np.zeros(N + 1)),
                               weights=f32(np.full(N + 1, 10.0))),
             tt.SimpleControlCost(p=f32(np.zeros(N)),
                                  weights=f32(np.full(N, 1e-3))))
    cons = (tt.ControlBoundConstraint.create([-2.0], [2.0]),)
    plan = tt.make_control_plan(system, costs, cons)
    one = from_mpc(system, costs, cons)
    sqp = dataclasses.replace(one, **{
        f.name: getattr(one, f.name).expand(
            (batch,) + getattr(one, f.name).shape).contiguous()
        for f in dataclasses.fields(one) if getattr(one, f.name) is not None
    })
    sqp = dataclasses.replace(sqp, x0=f32(x0s))
    drift = rng.normal(scale=0.02, size=(SHORT_TICKS + 2, batch, 2)).cumsum(0)
    x0_seq = [f32(x0s + drift[min(t, SHORT_TICKS + 1)] + 0.001 * t)
              for t in range(SHORT_TICKS + 9)]
    return sqp, plan, x0_seq


def polish_phase(tt, sk, dev, reset_counts):
    """Phase 24: the f64 polish launch on K4 against its plain version,
    then config 1's fused stagewise line end to end (``bench_all.py:
    _stagewise_line``): the measured policies, 60 polish iterations, a
    top-up of twice the warm budget; per-tick ticks gated on lanes 0, 1,
    17, B-1 and the worst 3 against the native oracle, then the same ticks
    chained with the polish captured.  Returns the K4 launches of the
    served paths."""
    import torch
    from copra_tpu_torch.ops.polish import polish

    sqp, plan, x0_seq = build_config1_stagewise(tt, dev)
    B, N, x, u, r = FLEET, C1_N, 2, 1, 0
    # the polish launch against its plain version, from a delivered state
    opts = tt.SolverOptions(max_iter=300, early_exit=False, rho=0.1,
                            polish=False, polish_iters=POLISH_ITERS)
    fp = sk.build_fused_plan(sqp, opts)
    x0 = sqp.x0.mT.contiguous()
    X0, U0, _, warm = sk.solve_stagewise_fused(
        sqp, opts.replace(polish_iters=0), return_warm=True, plan=fp)
    empty = X0.new_zeros((B, N, 0))
    w32, k32 = sk._pack_warm(fp, *warm, empty, empty), sk._pack_work(fp, X0,
                                                                     U0)
    f64 = torch.float64
    args = (fp.polish.plan, x0.to(f64), w32.to(f64))
    kw = dict(n_iter=POLISH_ITERS, N=N, x=x, u=u, r=r,
              sigma=float(np.float32(opts.sigma)),
              alpha=float(np.float32(opts.alpha)), work=k32.to(f64),
              carry=True)
    got = sk.fused_stagewise_tick(*args, **kw, plan_lf=fp.polish.plan_lf)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    want = sk.stagewise_tick_plain(*args, **kw)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    rel = _max_diff(got, want) / scale
    run = lambda: polish(fp.polish, sk.fused_stagewise_tick, x0, w32, k32,
                         n_iter=POLISH_ITERS, N=N, x=x, u=u, r=r,
                         options=opts)
    pol_ms = _graph_ms(run, 10)
    bnd = bound(stagewise_flops(N, x, u, r, POLISH_ITERS, B),
                _nbytes(*args, kw["work"], *want), peak=F64_PEAK)
    print(f"kernel fused_stagewise_tick, f64 polish of config 1's fleet "
          f"(B = {B}, N = {N}, {POLISH_ITERS} iterations from the "
          f"delivered f32 state, centre carried): rel err {rel:.3e} (tol "
          f"{F64_TOL}) against its plain version; the polish (casts and "
          f"launch) {pol_ms:.4f} ms by graph replay, plain {plain_ms:.1f} "
          f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}, f64 peak)")
    if not rel <= F64_TOL:
        fail(f"the f64 polish launch differs from its plain version by "
             f"{rel:.3e}")

    # config 1's fused stagewise line: the measured policies
    t0 = time.perf_counter()
    rho, rho_probe = tt.auto_rho_stagewise(
        sqp, tt.SolverOptions(max_iter=200, early_exit=False),
        probe_lanes=8, drift_scale=0.02,
        candidates=(0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0),
        return_probe=True)
    rho_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    switers, pareto = tt.auto_iters_stagewise(
        sqp, tt.SolverOptions(early_exit=False, rho=rho), probe_lanes=8,
        drift_scale=0.02, candidates=(50, 100, 200, 300, 400, 600, 800),
        target_applied_err=3e-5, target_tail_err=3e-5, return_probe=True)
    iters_s = time.perf_counter() - t0
    print(f"config 1 measured policy: rho {rho:g} (probe "
          f"{ {k: float(f'{v:.3g}') for k, v in rho_probe.items()} }, "
          f"{rho_s:.2f} s), warm iterations {switers} (Pareto "
          f"{ {k: {kk: float(f'{vv:.3g}') for kk, vv in v.items()} for k, v in pareto.items()} }"
          f", {iters_s:.2f} s)")
    # the f32 run of a warm tick alone, at the measured budget
    k4_ms = _graph_ms(lambda: sk.fused_stagewise_tick(
        fp.plan, x0, w32, n_iter=switers, N=N, x=x, u=u, r=r,
        sigma=opts.sigma, alpha=opts.alpha, plan_lf=fp.plan_lf), 3)
    sopts = tt.SolverOptions(max_iter=switers, early_exit=False, rho=rho,
                             polish_iters=POLISH_ITERS,
                             topup_iters=2 * switers)
    cold = sopts.replace(max_iter=2000)
    reset_counts()
    tick = tt.make_stagewise_step(sqp, sopts, cold_options=cold,
                                  backend="fused")
    X, U, info, warm1 = tick(x0_seq[0])
    X, U, info, warm1 = tick(x0_seq[1], warm1)
    w = warm1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(SHORT_TICKS):
        X, U, info, w = tick(x0_seq[2 + t], w)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / SHORT_TICKS
    for t in range(6):
        X, U, info, w = tick(x0_seq[2 + SHORT_TICKS + t - 1], w)
    torch.cuda.synchronize()
    launches = sk.fused_stagewise_tick.launches
    share = float((info.status == 0).double().mean())
    lanes = tuple(sorted({0, 1, 17, B - 1, *info.failed_lanes(3)}))
    x_last = x0_seq[SHORT_TICKS + 6].cpu().numpy()
    err = gate_vs_oracle(tt, plan, U.reshape(B, -1), x_last, lanes)
    # chained, the polish captured: the same warm state and states
    reset_counts()
    many = tt.make_stagewise_multistep(sqp, sopts, cold_options=cold,
                                       backend="fused")
    seq = torch.stack(x0_seq[2:SHORT_TICKS + 7])
    many(None, seq.shape[0], warm=warm1, x0_seq=seq)
    out, chost_ms, cdev_ms, _ = _timed(
        lambda i: many(None, seq.shape[0], warm=warm1, x0_seq=seq), 3)
    torch.cuda.synchronize()
    launches += sk.fused_stagewise_tick.launches
    T = seq.shape[0]
    cerr = gate_vs_oracle(tt, plan, out[3].x.reshape(B, -1), x_last, lanes)
    _no_sync("a make_stagewise_multistep replay with the polish",
             lambda: many(None, T, warm=warm1, x0_seq=seq))
    # not counted from here: the ticks whose top-up ran (the polished first
    # run of each, from the same warm state, with no top-up)
    first = tt.make_stagewise_step(sqp, sopts.replace(topup_iters=0),
                                   cold_options=cold, backend="fused")
    w, fired = warm1, 0
    for t in range(T):
        fired += int(not bool((first(seq[t], w)[2].status == 0).all()))
        w = tick(seq[t], w)[3]
    print(f"main path config 1 fused stagewise line (B = {B}, N = {N}, rho "
          f"{rho:g}, {switers} warm iterations + {POLISH_ITERS} f64 polish, "
          f"top-up {2 * switers}): per tick {host_ms:.4f} host ms, "
          f"{B * 1e3 / host_ms:.1f} solves/s; chained ({T} ticks a CUDA "
          f"graph, the polish captured) {chost_ms / T:.4f} host ms/tick, "
          f"{cdev_ms / T:.4f} device ms/tick, {B * T * 1e3 / cdev_ms:.1f} "
          f"solves/s (K4's f32 run of {switers} iterations alone "
          f"{k4_ms:.4f} ms, the polish {pol_ms:.4f} ms); top-up ran on {fired} of {T} chained ticks; converged "
          f"share {share:.6f}; {launches} "
          f"fused_stagewise_tick launches; max_err_vs_exact {err:.3e} "
          f"per tick, {cerr:.3e} chained, on lanes {list(lanes)}")
    if launches == 0:
        fail("config 1's stagewise line never launched fused_stagewise_tick")
    if not (err <= ORACLE_TOL and cerr <= ORACLE_TOL):
        fail(f"config 1 polished: max_err_vs_exact {err:.3e} / chained "
             f"{cerr:.3e} > {ORACLE_TOL}")
    return launches


def policies_phase(tt, sk, cfg6, cfg5, reset_counts):
    """Phase 25: ``auto_rho_stagewise`` and ``auto_iters_stagewise`` at
    configs 5 and 6 as ``bench_all.py`` calls them (config 5 on the two
    per-axis lanes, config 6 on 4 equilibrated robots with the physical
    drift mapped into scaled space), beside the hand constants of phases
    6, 7 and 21; then ``make_stagewise_server`` on config 6's fleet,
    served and gated against the native oracle.  Returns the launches by
    entry point."""
    import dataclasses

    import torch
    from copra_tpu_torch.qp.riccati import scale_stagewise

    launches = {}

    def count():
        for e in (sk.fused_stagewise_tick, sk.fused_stagewise_tick_streamed):
            launches[e.__name__] = launches.get(e.__name__, 0) + e.launches

    # config 5: the two per-axis problems (bench_all.py:636-668)
    reset_counts()
    opts5 = tt.SolverOptions(max_iter=300, early_exit=False, polish=False,
                             eps_abs=1e-6)
    sq5 = _on(cfg5["fleet"], cfg5["fleet"].A.device, None, slice(0, 2))
    t0 = time.perf_counter()
    rho5 = tt.auto_rho_stagewise(sq5, opts5.replace(max_iter=30),
                                 cold_options=opts5)
    opts5 = opts5.replace(rho=rho5)
    it5, p5 = tt.auto_iters_stagewise(sq5, opts5, cold_options=opts5,
                                      candidates=(10, 20, 30, 50, 80),
                                      target_applied_err=1e-5,
                                      return_probe=True)
    torch.cuda.synchronize()
    s5 = time.perf_counter() - t0
    count()
    # config 6: 4 robots of its fleet, equilibrated (bench_all.py:1390-1418)
    reset_counts()
    opts6 = tt.SolverOptions(max_iter=300, early_exit=False, polish=False,
                             eps_abs=1e-4)
    Dx = cfg6["scale"][0].double().cpu().numpy()
    rng = np.random.default_rng(3)
    pert = rng.normal(scale=np.repeat([0.03, 0.01, 0.03, 0.05], 3),
                      size=(4, 12))
    x0s = srb_quadruped()["x0"].astype(np.float64)[None] + pert
    sq6 = _on(cfg6["fleet"], cfg6["fleet"].A.device, None, slice(0, 4))
    sq6 = scale_stagewise(dataclasses.replace(
        sq6, x0=torch.tensor(x0s.astype(np.float32), device=sq6.A.device)),
        *cfg6["scale"])
    t0 = time.perf_counter()
    rho6 = tt.auto_rho_stagewise(sq6, opts6.replace(max_iter=30),
                                 cold_options=opts6, drift_scale=0.002 / Dx)
    opts6 = opts6.replace(rho=rho6)
    it6, p6 = tt.auto_iters_stagewise(sq6, opts6, cold_options=opts6,
                                      candidates=(10, 20, 30, 50, 80, 120),
                                      target_applied_err=1e-5,
                                      drift_scale=0.002 / Dx,
                                      return_probe=True)
    torch.cuda.synchronize()
    s6 = time.perf_counter() - t0
    count()
    fmt = lambda p: {k: {kk: float(f"{vv:.3g}") for kk, vv in v.items()}
                     for k, v in p.items()}
    print(f"measured policies: config 5 rho {rho5:g}, {it5} warm iterations"
          f" (hand constants of phases 7 and 21: rho "
          f"{cfg5['opts'].rho:g}, {cfg5['opts'].max_iter}), Pareto "
          f"{fmt(p5)}, {s5:.2f} s; config 6 rho {rho6:g}, {it6} warm "
          f"iterations (hand constants of phases 6 and 21: rho "
          f"{cfg6['opts'].rho:g}, {cfg6['opts'].max_iter}), Pareto "
          f"{fmt(p6)}, {s6:.2f} s")

    # make_stagewise_server on config 6's fleet
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick, policy = tt.make_stagewise_server(cfg6["fleet"],
                                            return_policy=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    seq = cfg6["x0_seq"]
    X, U, info, warm = tick(seq[0])
    for t in range(1, WARMUP_TICKS):
        X, U, info, warm = tick(seq[t], warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(WARMUP_TICKS, WARMUP_TICKS + TIMED_TICKS):
        X, U, info, warm = tick(seq[t], warm)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_TICKS
    count()
    rel, err = gate_stagewise(cfg6, U)
    n = launches.get("fused_stagewise_tick_streamed", 0)
    print(f"main path make_stagewise_server on config 6's fleet "
          f"({U.shape[0]} robots): rho {policy['rho']:g}, "
          f"{policy['warm_iters']} warm iterations (+"
          f"{policy['options'].topup_iters} top-up), scaled "
          f"{policy['scaled']}; set-up {setup_s:.2f} s; {ms:.4f} host "
          f"ms/tick over {TIMED_TICKS} ticks; converged share "
          f"{float((info.status == 0).double().mean()):.6f}; "
          f"max_err_vs_exact {err:.3e}, max_err_rel {rel:.3e} on lanes "
          f"{list(cfg6['lanes'])}; K5 launches in the phase {n}")
    if tick.backend != "fused" or n == 0:
        fail("make_stagewise_server did not serve through the kernel")
    if not rel <= REL_TOL:
        fail(f"make_stagewise_server: max_err_rel {rel:.3e} > {REL_TOL}")
    return launches


def solve_phase(tt, sk, dev, reset_counts):
    """Phase 26: ``solve`` on four routes, each gated against the native
    oracle at the library's contract (1e-5 relative): the condensed route
    on config 8's controller problem (N = 100, float64), the automatic
    stagewise route at N = 400 (early-exit solves on K4), the direct LQR
    route (``iterations == 1``) and the float32 route to the native
    engine.  Returns K4's launches."""
    import torch

    f64 = lambda a: torch.tensor(np.asarray(a, np.float64), device=dev)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    A8, B8, d8 = double_integrator(T=0.005)

    def config8(f):
        system = tt.LTISystem.create(f(A8), f(B8), f(d8), f([0.0, -1.5]),
                                     FACADE_N)
        costs = (tt.TargetCost.create(f(np.eye(2)), f([0.0, -1.0]),
                                      weights=f([10.0, 1e4])),
                 tt.ControlCost.create(f([[1.0]]), f([2.0]),
                                       weights=f([1e-4])))
        return system, costs, (tt.ControlBoundConstraint.create(
            f([-BOUND]), f([BOUND])),)

    T = 0.02
    A4, B4 = np.array([[1.0, T], [0.0, 1.0]]), np.array([[T * T / 2], [T]])
    long = (tt.LTISystem.create(f64(A4), f64(B4), f64(np.zeros(2)),
                                f64([1.0, 0.0]), 400),
            (tt.SimpleTrajectoryCost.create(f64(np.zeros(2)),
                                            weights=f64([5.0, 0.5])),
             tt.SimpleControlCost.create(f64(np.zeros(1)),
                                         weights=f64([1e-3]))),
            (tt.ControlBoundConstraint.create(f64([-1.0]), f64([1.0])),))
    c8 = config8(f64)
    routes = (("condensed, config 8 (N = 100, f64)", c8, "condensed"),
              ("stagewise, N = 400 (f64)", long, "stagewise"),
              ("direct LQR, config 8 costs only (f64)", c8[:2] + ((),),
               "lqr"),
              ("float32 floor, config 8 (f32)", config8(f32), "native"))
    reset_counts()
    line, k4 = [], 0
    for name, (system, costs, cons), route in routes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tt.solve(system, costs, cons)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        qp = tt.build_qp(tt.condense(system), system.x0, costs, cons)
        exact = tt.solve_qp_native(qp).x
        scale = max(1.0, float(exact.abs().max()))
        rel = float((res.control.double().cpu() - exact).abs().max()) / scale
        status, iters = int(res.solution.status), \
            int(res.solution.iterations)
        n = sk.fused_stagewise_tick.launches - k4
        k4 += n
        line.append(f"{name}: {ms:.1f} ms, status {status}, {iters} "
                    f"iterations, {n} K4 launches, rel err {rel:.3e}")
        ok = status == tt.STATUS_SOLVED and rel <= ORACLE_TOL
        ok = ok and (route != "lqr" or iters == 1)
        ok = ok and (route != "stagewise" or n > 0)
        ok = ok and (route != "native" or res.control.dtype == torch.float32)
        if not ok:
            fail(f"solve, {line[-1]}")
    print("main path solve (no options): " + "; ".join(line))
    return k4


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    import copra_tpu_torch as tt
    from copra_tpu_torch.ops import admm_kernel as ak
    from copra_tpu_torch.ops import build
    from copra_tpu_torch.ops import cholesky_kernel as ck
    from copra_tpu_torch.ops import stagewise_kernel as sk
    from copra_tpu_torch.ops.counts import reset as reset_counts

    # phase 1: device
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible")
    print(smi[0] if smi else "nvidia-smi: no output")
    # the SM clock the cycles-per-step figures of phases 5 and 8 are counted at
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    sm_hz = float(clk[0]) * 1e6 if clk and clk[0].strip().isdigit() \
        else 1.98e9

    # phase 2: build every kernel from the checkout, in parallel
    t0 = time.perf_counter()
    for src, (path, secs) in build.build_all().items():
        print(f"build: copra_tpu_torch/csrc/{src}.cu -> {path} in "
              f"{secs:.2f} s")
    print(f"build: all kernels in {time.perf_counter() - t0:.2f} s")

    # plan and step (auto_rho runs the kernel on 8 probe lanes)
    plan, opts, step, x0_dev, setup_s = build_serving(tt, dev, BATCH,
                                                      HORIZON, ITERS)
    print(f"setup: plan + auto_rho + step for B={BATCH}, N={HORIZON} in "
          f"{setup_s:.2f} s, rho={opts.rho:.6g}")

    # phase 3: kernel vs plain, all three modes and both bodies
    modes, bodies = kernel_vs_plain(ak, step, plan, opts, x0_dev[0])
    k1_err = report_box_lanes(ak, "config 4 operators", modes, bodies, BATCH,
                              HORIZON, sm_hz)
    # the one PyTorch call that computes the Q x pass: g = x K - spr x
    Kinv4, K4, _ = step.state
    s4 = torch.full_like(x0_dev[0][:, :1].expand(-1, K4.shape[-1]), 0.01)
    spr = opts.sigma + opts.rho
    qx_lib_ms = _cuda_ms(lambda: torch.baddbmm(s4.unsqueeze(1), s4.unsqueeze(1),
                                               K4, beta=-spr), 20)
    print(f"library qx: torch.baddbmm {qx_lib_ms:.4f} ms")

    # phase 4: the config-4 main path
    reset_counts()
    u, sol, share, host_ms, dev_ms, issue_ms = run_ticks(step, plan, x0_dev,
                                                         TICKS)
    launches = ak.fused_admm_box_lanes.launches
    if tuple(u.shape) != (BATCH, HORIZON) or u.dtype != torch.float64 \
            or not bool(torch.isfinite(u).all()):
        fail(f"served controls: shape {tuple(u.shape)}, {u.dtype}")
    if launches == 0:
        fail("the main path never launched the kernel")
    x0_last = x0_dev[TICKS + 1].cpu().numpy()
    lanes = (0, 1, 17, BATCH - 1)
    err = gate_vs_oracle(tt, plan, u, x0_last, lanes)
    print(f"main path: {BATCH * 1e3 / host_ms:.1f} solves/s, "
          f"{host_ms:.4f} host ms/tick, {dev_ms:.4f} device ms/tick "
          f"(CUDA events), {issue_ms:.4f} host ms/tick to issue, "
          f"{launches} kernel launches over {TICKS + 2} "
          f"ticks, converged share {share:.6f}, max_err_vs_exact {err:.3e} "
          f"on lanes {list(lanes)}")
    if not err <= ORACLE_TOL:
        fail(f"max_err_vs_exact {err:.3e} > {ORACLE_TOL}")
    # per tick the main path runs the x0 = 0 body and the Q x pass: the
    # record's times are their sum (graph replays), its bound the sum of
    # their bounds
    work = [box_work(BATCH, HORIZON, n_it, 0, body, per_lane=True)
            for body, n_it in (("x0_zero", ITERS), ("qx", 0))]
    kernels = {"fused_admm_box_lanes": kernel_record(
        "fused_admm_box_lanes", KERNEL_SOURCE, REPLACES, launches, k1_err,
        modes["x0_zero"][2] + modes["qx"][2],
        modes["x0_zero"][3] + modes["qx"][3],
        bound(sum(w[0] for w in work), sum(w[1] for w in work)))}

    # the stagewise serving facades (plans, gains and scales)
    configs = []
    for build_cfg in (build_config6, build_config5):
        cfg = build_cfg(tt, dev)
        print(f"setup: {cfg['name']}, {cfg['x0_seq'][0].shape[0]} lanes, "
              f"plan in {cfg['setup_s']:.2f} s, rho={cfg['opts'].rho:g}, "
              f"{cfg['opts'].max_iter} warm iterations (+"
              f"{cfg['opts'].topup_iters} top-up)")
        configs.append(cfg)

    # phase 5: the stagewise kernel against its plain version
    probe = {}
    for cfg in configs:
        (entry, e32, b32, e64, ms, plain_ms, ms64, bnd, chain,
         repack_ms, skip_ms) = stagewise_vs_plain(sk, cfg)
        probe[entry] = (e32, ms, plain_ms, bnd)
        print(f"kernel {entry} ({cfg['name']} plan, {cfg['opts'].max_iter} "
              f"iterations): float64 max_abs_err {e64:.3e} (tol {F64_TOL}),"
              f" float32 max_abs_err {e32:.3e} (tol {b32:.3e}); kernel "
              f"{ms:.4f} ms (float64 {ms64:.4f} ms), plain {plain_ms:.1f} ms,"
              f" bound {bnd[0]:.4f} ms ({bnd[1]}); chain {chain} dependent "
              f"stage steps, {ms * 1e-3 * sm_hz / chain:.0f} cycles per "
              f"step at {sm_hz / 1e6:.0f} MHz; the lane-first plan, made "
              f"once per plan, {repack_ms:.4f} ms; a launch with the top-up "
              f"flag set (state kept bit for bit, both dtypes) "
              f"{skip_ms:.4f} ms")
        if not (e64 <= F64_TOL and e32 <= b32):
            fail(f"{entry} disagrees with the plain version")
    shapes_vs_plain(tt, sk, dev)

    # phases 6 and 7: the served stagewise paths
    for cfg in configs:
        fp = cfg["tick"]._plans[cfg["tick"]._plan_key(cfg["opts"])]
        entry = (sk.fused_stagewise_tick if fp.mode == "resident"
                 else sk.fused_stagewise_tick_streamed)
        reset_counts()
        U, share, host_ms, dev_ms, st_host, st_dev = serve_stagewise(sk, cfg)
        n = entry.launches
        ticks = WARMUP_TICKS + TIMED_TICKS
        if not bool(torch.isfinite(U).all()):
            fail(f"{cfg['name']}: non-finite controls")
        if n == 0:
            fail(f"{cfg['name']}: the served path never launched "
                 f"{entry.__name__}")
        rel, err = gate_stagewise(cfg, U)
        print(f"main path {cfg['name']}: {host_ms:.4f} host ms/tick, "
              f"{dev_ms:.4f} device ms/tick (CUDA events), {n} "
              f"{entry.__name__} launches over {ticks} ticks, converged "
              f"share {share:.6f}; status pass {st_host:.3f} host ms, "
              f"{st_dev:.3f} device ms per call; max_err_vs_exact "
              f"{err:.3e}, max_err_rel {rel:.3e} on lanes "
              f"{list(cfg['lanes'])}")
        if not rel <= REL_TOL:
            fail(f"{cfg['name']}: max_err_rel {rel:.3e} > {REL_TOL}")
        e32, ms, plain_ms, bnd = probe[entry.__name__]
        kernels[entry.__name__] = kernel_record(
            entry.__name__, STAGEWISE_SOURCE,
            STAGEWISE_REPLACES[entry.__name__], n, e32, ms, plain_ms, bnd)

    cfgs, records = shared_plan_phases(tt, ak, dev, plan, opts, x0_dev,
                                       reset_counts, sm_hz)
    kernels.update(records)
    k2_launches, records = general_solver_phases(
        tt, ak, ck, dev, plan, opts, x0_dev, cfgs["config 1"], reset_counts,
        sm_hz)
    kernels.update(records)
    kernels["fused_admm_box"]["launches"] += k2_launches

    # phase 19: the per-lane accurate tick at N = 300 (the streamed body)
    wide_launches, k1_wide, k2_wide = wide_lanes_phase(tt, ak, dev,
                                                       reset_counts, sm_hz)
    k1, k2 = kernels["fused_admm_box_lanes"], kernels["fused_admm_box"]
    k1["launches"] += wide_launches

    # phase 20: config 4 chained, TICKS ticks a CUDA graph
    k1["launches"] += chained_plan_phase(
        tt, ak, plan, opts, step, x0_dev, reset_counts,
        modes["x0_zero"][2] * ROUNDS + modes["qx"][2])
    # phase 21: configs 6 and 5 chained, in x0_seq and plant modes
    for cfg in configs:
        fp = cfg["tick"]._plans[cfg["tick"]._plan_key(cfg["opts"])]
        entry = ("fused_stagewise_tick" if fp.mode == "resident"
                 else "fused_stagewise_tick_streamed")
        kernels[entry]["launches"] += chained_stagewise_phase(
            tt, sk, cfg, reset_counts, probe[entry][1])
    # phase 22: the log-depth forms against their serial forms
    assoc_phase(tt, dev, build_fleet(BATCH, HORIZON)[0], configs[1])
    # phases 23-26: the no-knobs layer on K4/K5
    for entry, n in early_exit_phase(tt, sk, configs, reset_counts).items():
        kernels[entry]["launches"] += n
    kernels["fused_stagewise_tick"]["launches"] += polish_phase(
        tt, sk, dev, reset_counts)
    for entry, n in policies_phase(tt, sk, configs[0], configs[1],
                                   reset_counts).items():
        kernels[entry]["launches"] += n
    kernels["fused_stagewise_tick"]["launches"] += solve_phase(
        tt, sk, dev, reset_counts)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_wide)
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_wide)
    order = ("fused_admm_box_lanes", "fused_admm_box",
             "fused_admm_box_shared", "fused_stagewise_tick",
             "fused_stagewise_tick_streamed", "fused_admm_general_shared",
             "fused_admm_general", "chol_batched")
    print(f"whole run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernels[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
