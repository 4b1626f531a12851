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
    the launches a replay and a profile of one replay inside a
    ``profiling.trace_span`` (a ``torch.profiler`` Chrome trace, kept under
    ``smoke_out/traces``, read by ``profiling.trace_device_time``: kernel
    time by name, the kernels' busy time as the interval union per stream
    against the span, <= 1.03 x it: the idle share, beside the sum of
    durations; K1's kernels among the top 8 ops and the span's name in the
    trace);
21. configs 6 and 5 chained through ``make_stagewise_multistep``
    (``backend="fused"``, the served options and scales), 9 ticks a CUDA
    graph: the ``x0_seq`` chain of phases 6/7's states, held against the
    eager per-tick ticks (<= 1e-4 x max(1, max |U|)) and gated at the last
    state against the native oracle (max_err_rel <= 1e-4), with one eager
    warm tick and one replay under the sync check; the plant mode from a
    cold start, gated at the last state it solved (<= 1e-4); a replan (a
    5% drift of the linear state costs) held against a fresh facade on the
    new data with no new capture; host and device ms per tick, the
    capture's seconds, launches a replay, a profile of one replay (as in
    phase 20, the tick kernel among the top 8 ops), the status pass's ms
    (eager and by graph replay) and the ticks whose top-up ran;
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
    and float32 data routed to the native engine; ms per solve;
27. the closed loop: config 4's fleet in float64 through
    ``receding.closed_loop``'s rebuild route (default options, 5 ticks,
    the 4096 lanes as one batch, each lane's plant its own stage 0): the
    controls of lanes 0, 1, 17 and 4095 at every tick, and their whole
    plans, against the native oracle on that lane's QP at the realized
    state (<= 1e-5), the plant identity, host ms a tick; lane 0 through
    ``use_plan=True`` for 20 ticks against the rebuild route (states
    2e-4, controls 2e-3, the reference's test);
28. resume from a checkpoint: phase 27's loop again through
    ``make_receding_step``, the warm state at tick 2 saved as npz and
    through ``torch.distributed.checkpoint``, loaded onto the card, 3
    ticks resumed from each equal to the unbroken run bit for bit; the
    same for config 5's stagewise warm tuple (K4); file sizes, save and
    load ms;
29. ``solve_metrics`` of phase 27's last tick against a numpy
    recomputation (the traces of phases 20 and 21 are where
    ``trace_span`` and ``trace_device_time`` are gated);
30. the port's examples (``examples/torch_*.py``) at their default sizes
    with their own checks as gates: getting started (v <= 0, force <= 200
    N), the bipedal preview (the ZMP inside the polygon) and fleet (every
    lane converged; K4), the quadruped fleet (every lane converged, the
    friction cones and height corridor; K5) and fleet serving (converged
    share >= 0.85; K4); the servers' ticks timed (each example records
    them); the tick kernel against its plain version on one served tick's
    plan and inputs of the fleet-serving chain (K4, x = 2, u = 1, N = 12,
    16 lanes) and of the quadruped server (K5, 16 friction rows and the
    state corridor), at phases 5-7's tolerances;
31. the parallel layer (``copra_tpu_torch.parallel``) on
    ``torch.distributed`` with NCCL in a world of one process (one card
    cannot host two NCCL ranks; the tests hold the collectives between
    processes with gloo on the CPU): ``examples/torch_batched_serving.py``
    at its defaults (1024 lanes, N = 50, 60 iterations), its cold sharded
    step equal bit for bit to the unsharded fixed-count solve and its
    all-reduced totals; ``sharded_solve_mpc`` on the SmallSystem's 16-lane
    fleet (f64, default options) against the golden control (2e-4) and the
    native oracle (control 2e-4, trajectory 1e-4); the model-parallel
    solve in f64 against ``solve_qp`` at the same lockstep options on the
    golden QP and on config 4's lane at N = 300 with trajectory and control
    bounds (1e-8 relative; ms an iteration and the all-reduces a solve),
    and DP x TP over 64 such lanes; the horizon-sharded LQ solves at phase
    22's config-5 width (512 lanes, N = 300, no cross term) against
    ``lqr_solve`` and ``lqr_solve_assoc`` (1e-9 relative); a ``Shard(0)``
    DTensor warm start through DCP, one step resumed bit for bit.  Times
    are CUDA events; each line carries the card's name and power limit;
32. gradients on the card, float64: (a) ``torch.func.jacfwd`` of config
    4's served controls (B = 4096, N = 100) in x0 through the plain
    accurate tick (``use_fused=False``), against central differences on
    every lane smooth on the stencil (rtol 1e-3; lanes 0, 1, 17, 4095
    printed) and against the CPU port on those four lanes (1e-6 x max
    |J|), the kernel tick refusing and, under ``no_grad``, launching K1;
    (b) learned tuning at config 4's width: ``backward()`` through
    ``solve_mpc_batch`` (100 fixed iterations, no polish) of a
    velocity-tracking loss in the log of the target weights, against
    central differences (rtol 1e-3), forward + backward ms and peak
    memory; (c) ``jacfwd`` of config 5's U (512 lanes, N = 300) through
    the early-exit ``solve_stagewise``: the plain loop on the card with no
    K4 launch, the same call under ``no_grad`` on K4, against central
    differences and the CPU port on lane 0; (d) every kernel route (K1,
    K2, K3, K4 and K5 ticks, K6, K7, K8, both chains at the capture and at
    a replay, the f64 polish) and ``solve(engine="native")`` refuse a
    gradient asked by ``requires_grad``, ``torch.func.vjp`` and a
    forward-mode tangent, naming the plain route, and launch (solve)
    under ``no_grad``; peak device memory of each case;
33. the fuzz suites on the card (``tests/_fuzz_draw.py``, the reference's
    seeds and gates): the 14 front-end draws through ``solve`` (1e-5
    relative to the native oracle, replay 1e-8) and ``engine=
    "stagewise"`` (1e-4); the plan step's receding ticks (oracle 1e-5,
    a fresh ``solve`` 2e-5); the stagewise step's warm ticks on K4
    (1e-4); ``make_stagewise_step(backend="fused")`` against
    ``backend="xla"`` on float32 draws, 3 ticks (5e-5); each draw's
    (x, u, N, r), its error and the launches;
34. the reference's last behaviour suites on the kernel routes (their
    plain routes are held against the reference by the CPU tests
    ``tests/test_torch_{stagewise_honesty,model_swap,stagewise_scaling,
    behavior}.py``): (a) the early-exit route on K4 out of a 3-iteration
    budget, every lane unsolved at 3 iterations; (b) K4's fixed count on
    3 lanes, one starved: ``failed_lanes(2)`` and ``inform()`` name it, a
    solved batch names none; (c) crossed bounds on K4, primal infeasible
    at fixed count and with early exit; each held against the plain route
    on the CPU; (d) config 5's captured chain replanned twice at equal
    shapes (the footstep plan moved 2 mm, then back) with no new capture,
    the first tick after each swap converged on every lane, a served tick
    captured as a CUDA graph equal to a fresh facade's after a replan (bit
    for bit), and a changed shape raising ``DimensionError``; (e) the
    quadruped at N = 16 in float64 on K5 with early exit: the scaled
    problem converges within 800 iterations in fewer than the raw one,
    which does not; (f) the N = 300 canary through ``solve_mpc`` on the
    card: solved, replay <= 1e-10, bounds held to 1e-6, within 1e-7 of
    the CPU port; (g) K7 on config 2's per-lane fleet with rows normalised
    (``row_normalize=True``) at rho 0.01, 0.1, 1 and 10 against its plain
    version in float64 (2e-4 x max(1, max |plain|)), timed by graph
    replay;
35. the benchmark entry points as child processes: ``bench_torch.py``
    (config 4's accurate ticks on K1, its chained point, the roofline point
    on K3 and the f32 fast point on K2 from its own child) and
    ``bench_all_torch.py`` (configs 1, 2, 3, 5, 6 and 8, 3, 3, 2, 12, 4 and
    4 lines, artifact under ``smoke_out/``): every line's gate held to its
    contract (1e-5 absolute on the condensed lines, the chained and the
    roofline points; 1e-4 relative on configs 5 and 6 and on config 3's
    f32 direct LQR tick) and the kernel its route launches required (no
    launch on a route with no kernel) by each line's own launch counts;
    each script's seconds;
36. the weak-scaling harness as child processes: ``bench_scaling_torch.py``
    on the visible cards at the reference's sizes (512 lanes a device,
    N = 50, f32, 60 iterations, ``BENCH_STEPS`` 3; NCCL groups of 1, 2,
    4, ... processes, one card each) without its controls, as the
    reference runs on an accelerator, and with ``--device cpu`` at 1 and
    2 gloo processes, ``BENCH_STEPS`` 1, with the controls and the
    K-process cluster summary (the script's sizes 4 and 8 and its 3 steps
    a window cut for time): every mesh line's rate above 0 and its
    controls equal bit for bit to the unsharded ``solve_mpc_batch`` of its
    lanes, the weak-scaling summary at 1.0 on one device, on the CPU the
    control and cluster lines and their summaries, the card's name and
    power limit on the card's lines, and no kernel launched (the step runs
    eager ``solve_qp`` and four all-reduces); each run's seconds.

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
import os
import shutil
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


def _sync(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU, where the benchmark scripts' tests build these fleets)."""
    from copra_tpu_torch.profiling import synchronize

    synchronize(device)


def build_fleet(batch: int, horizon: int, ticks: int = TICKS):
    """``bench.py``'s config-4 fleet (``_build_workload`` and its drift over
    ``ticks`` timed ticks): returns the f32 system arrays, x0s and the
    ``ticks + 2`` tick states x0_seq."""
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
    drift = np.zeros((ticks + 2, batch, 2))
    drift[:, :, 1] = np.cumsum(
        rng.normal(scale=0.02, size=(ticks + 2, batch)), axis=0)
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
              zmp_w=1.0, jerk_w=1e-6, ridge=1e-6, return_maps=False):
    """Exact f64 controls ``U [N]`` of one ZMP axis: condensed in f64, ZMP
    rows as inequality pairs, native active-set solve
    (``bench_all.py:_zmp_exact``); with ``return_maps`` also the ZMP's
    maps ``(Zphi, Zpsi, Zxi)``, the ZMP at stage k being ``Zphi[k] x0 +
    Zpsi[k] U + Zxi[k]``."""
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
    Zxi = xi @ z_row
    zoff = Zphi @ np.asarray(x0, np.float64) + Zxi
    Q = zmp_w * (Zpsi.T @ Zpsi) + (jerk_w + ridge) * np.eye(N)
    c = zmp_w * (Zpsi.T @ (zoff - np.asarray(ref_ax, np.float64)))
    qp = tt.DenseQP(
        Q=Q, c=c, Aeq=np.zeros((0, N)), beq=np.zeros(0),
        Aineq=np.concatenate([Zpsi, -Zpsi], axis=0),
        bineq=np.concatenate([np.asarray(hi_ax, np.float64) - zoff,
                              zoff - np.asarray(lo_ax, np.float64)]),
        lb=np.full(N, -np.inf), ub=np.full(N, np.inf))
    U = tt.solve_qp_native(qp).x.numpy()
    return (U, (Zphi, Zpsi, Zxi)) if return_maps else U


def build_config6(tt, device, robots: int = QUAD_ROBOTS,
                  horizon: int = QUAD_N, rho: float = 0.1,
                  warm_iters: int = 50, cold_iters: int = 300,
                  backend: str = "fused",
                  n_states: int = WARMUP_TICKS + TIMED_TICKS):
    """The config-6 fleet, its scales, options and ``n_states`` drifting x0
    states (``bench_all.py:config6``'s ``fleet(robots, rng)`` and drift;
    by default rho and the warm budget as the reference's measured
    policies chose them), served through ``make_stagewise_step(backend=
    backend)``."""
    import torch
    from copra_tpu_torch.qp.riccati import (StagewiseQP, make_stagewise_step,
                                            stagewise_scales)

    one = srb_quadruped(horizon)
    rng = np.random.default_rng(11)
    pert = rng.normal(scale=np.repeat([0.03, 0.01, 0.03, 0.05], 3),
                      size=(robots, 12))
    x0s = (one["x0"].astype(np.float64)[None] + pert).astype(np.float32)
    # the draws of a longer sequence start with those of a shorter one
    drift = np.cumsum(rng.normal(
        scale=0.002, size=(max(n_states, WARMUP_TICKS + TIMED_TICKS + 10),
                           robots, 12)), axis=0)
    x0_seq = [(x0s.astype(np.float64) + drift[t]).astype(np.float32)
              for t in range(n_states)]
    t0 = time.perf_counter()
    ten = lambda a: torch.tensor(a, device=device)
    sq1 = StagewiseQP(**{k: ten(v) for k, v in one.items()})
    scales = stagewise_scales(sq1)
    fleet = StagewiseQP(**{k: ten(np.repeat(v[None], robots, 0))
                           for k, v in one.items() if k != "x0"},
                        x0=ten(x0s))
    opts = tt.SolverOptions(max_iter=cold_iters, early_exit=False,
                            polish=False, eps_abs=1e-4, rho=rho)
    wopts = opts.replace(max_iter=warm_iters, topup_iters=4 * warm_iters)
    tick = make_stagewise_step(fleet, wopts, cold_options=opts,
                               backend=backend, scaling=scales)
    _sync(device)
    oracle = lambda lane, x0: stagewise_exact(
        tt, dict(one, x0=x0.astype(np.float64)))
    return dict(name="config 6", tick=tick, opts=wopts, scale=scales,
                fleet=fleet, cold_opts=opts,
                x0_seq=[ten(a) for a in x0_seq], x0_np=x0_seq,
                lanes=(0, robots - 1), oracle=oracle,
                setup_s=time.perf_counter() - t0)


def config5_fleet(tt, device, shift: float = 0.0, horizon: int = ZMP_N,
                  robots: int = ZMP_ROBOTS):
    """The config-5 fleet: both ZMP axes per robot through the port's
    ``from_mpc`` (``bench_all.py:_bipedal_workload``/``axis_sqp``), the
    footstep plan moved by ``shift`` metres on both axes (a footstep
    replan's data; 0 is config 5's own)."""
    import torch
    from copra_tpu_torch.qp.riccati import from_mpc, stack_stagewise

    A, B, d, zmp_row = lipm_system(ZMP_T, 0.8)
    ref, lo, hi = (a + shift for a in footstep_plan(4, horizon, ZMP_T))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    Zfull = f32(np.kron(np.eye(horizon + 1), zmp_row))
    system = tt.LTISystem.create(f32(A), f32(B), f32(d), f32(np.zeros(3)),
                                 horizon)

    def axis_sqp(ax):
        costs = (tt.TrajectoryCost(M=Zfull, p=f32(ref[ax]),
                                   weights=f32(np.ones(horizon + 1))),
                 tt.SimpleControlCost(p=f32(np.zeros(horizon)),
                                      weights=f32(np.full(horizon, 1e-6))))
        constraints = (tt.TrajectoryConstraint(E=Zfull, f=f32(hi[ax])),
                       tt.TrajectoryConstraint(E=-Zfull, f=f32(-lo[ax])))
        return from_mpc(system, costs, constraints)

    return stack_stagewise([axis_sqp(0), axis_sqp(1)], repeats=robots)


def config5_oracle(tt, horizon: int = ZMP_N, shift: float = 0.0):
    """``oracle(lane, x0, return_maps=False)``: the exact f64 controls of
    lane ``lane`` of config 5's fleet (axis ``lane % 2``) at ``x0``, from
    the f32 model data, through :func:`zmp_exact`."""
    A, B, d, zmp_row = lipm_system(ZMP_T, 0.8)
    ref, lo, hi = (a + shift for a in footstep_plan(4, horizon, ZMP_T))
    A32, B32, d32 = (np.asarray(a, np.float32) for a in (A, B, d))
    return lambda lane, x0, return_maps=False: zmp_exact(
        tt, A32, B32, d32, zmp_row, ref[lane % 2], lo[lane % 2],
        hi[lane % 2], x0, return_maps=return_maps)


def build_config5(tt, device, robots: int = ZMP_ROBOTS,
                  horizon: int = ZMP_N, rho: float = 1.0,
                  warm_iters: int = 20, cold_iters: int = 300,
                  n_states: int = WARMUP_TICKS + TIMED_TICKS):
    """The config-5 fleet: both ZMP axes per robot through the port's
    ``from_mpc`` (``bench_all.py:_bipedal_workload``/``axis_sqp``), its
    options (by default rho and the warm budget as the reference's
    measured policies chose them) and ``n_states`` drifting x0 states
    (``bench_all.py:config5``, fused lines)."""
    import torch
    from copra_tpu_torch.qp.riccati import make_stagewise_step

    lanes = 2 * robots
    rng = np.random.default_rng(7)
    x0_seq = [np.cumsum(rng.normal(scale=0.002, size=(t + 1, lanes, 3)),
                        axis=0)[-1].astype(np.float32)
              for t in range(n_states)]
    t0 = time.perf_counter()
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    fleet = config5_fleet(tt, device, horizon=horizon, robots=robots)
    opts = tt.SolverOptions(max_iter=cold_iters, early_exit=False,
                            polish=False, eps_abs=1e-6, rho=rho)
    wopts = opts.replace(max_iter=warm_iters, topup_iters=4 * warm_iters)
    tick = make_stagewise_step(fleet, wopts, cold_options=opts,
                               backend="fused")
    _sync(device)
    exact = config5_oracle(tt, horizon)
    oracle = lambda lane, x0: exact(lane, x0)[:, None]
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


def served_vs_plain(sk, fp, opts, x0, warm):
    """The tick kernel against its plain version on the served plan
    ``fp`` (from options ``opts``) at the scaled state ``x0 [B, x]`` from
    the served warm tuple ``warm``, with the serving iteration count, on
    the lane-first plan made once as the serving path holds it, in
    float64 and float32: ``(entry, kw, warm tensor, {dtype:
    _stagewise_held's result})``.  The warm tensor is what the served
    tick packs: the carried tuple, with a box-only problem's z reseeded
    at the new state's clipped unconstrained optimum."""
    import dataclasses

    import torch
    from copra_tpu_torch.qp.riccati import _initial_state

    sqp = dataclasses.replace(fp.sqp, x0=x0)
    warm_t = sk._pack_warm(fp, *_initial_state(
        sqp, opts, warm, fp.rows, lambda: sk.lqr_solve_fixed(
            fp.gains_raw, sqp.A, sqp.B, sqp.d, sqp.qx, sqp.ru, sqp.x0)))
    entry = (sk.fused_stagewise_tick if fp.mode == "resident"
             else sk.fused_stagewise_tick_streamed)
    kw = dict(n_iter=opts.max_iter, N=sqp.horizon, x=sqp.xdim, u=sqp.udim,
              r=sqp.nr_rows, sigma=opts.sigma, alpha=opts.alpha)
    out = {}
    for dt in (torch.float64, torch.float32):
        args = (fp.plan.to(dt), x0.mT.contiguous().to(dt), warm_t.to(dt))
        out[dt] = _stagewise_held(sk, args, kw, entry, served=True)
    return entry, kw, warm_t, out


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
    N = fp.sqp.horizon
    x0 = cfg["x0_seq"][1]
    if cfg["scale"] is not None:
        x0 = x0 / cfg["scale"][0]
    _, _, _, warm = tick(cfg["x0_seq"][0])
    entry, kw, warm_t, out = served_vs_plain(sk, fp, opts, x0, warm)
    x, u, r = kw["x"], kw["u"], kw["r"]
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
              f"{(N, x, u, r, lanes)}, {('block', 'warp')[cfg[9]]} body, "
              f"f64 ring of {cfg[4]} x {cfg[8]} "
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


def _drift(x0s, rng, ticks: int):
    """The ``ticks + 2`` cumulated drifts of ``bench_all.py``'s configs 1-3
    (scale 0.02 a tick), ``[ticks + 2, B, x]``."""
    return rng.normal(scale=0.02, size=(ticks + 2,) + x0s.shape).cumsum(0)


def drifting(x0s, drift, device):
    """The states ``x0s + drift[t]``, f32 tensors on ``device``."""
    import torch

    x0_seq = (x0s[None] + drift).astype(np.float32)
    return [torch.tensor(x, device=device) for x in x0_seq]


def config1_costs(tt, device, N: int = C1_N):
    """``bench_all.py:config1``'s costs (also config 3's): a full-size
    position TrajectoryCost (weight 10) and a control cost (1e-3), f32."""
    import torch

    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return (tt.TrajectoryCost(M=tt.span_matrix(f32([[1.0, 0.0]]), N + 1),
                              p=f32(np.zeros(N + 1)),
                              weights=f32(np.full(N + 1, 10.0))),
            tt.SimpleControlCost(p=f32(np.zeros(N)),
                                 weights=f32(np.full(N, 1e-3))))


def build_config1(tt, device, batch: int = 0, ticks: int = SHORT_TICKS,
                  iters: int = C1_ITERS, rounds: int = C1_ROUNDS,
                  rho=None):
    """``bench_all.py:config1``: LTI double integrator N = 10, a full-size
    position TrajectoryCost, a small control cost, +-2 control bounds,
    the accurate tick at 300 iterations x 3 rounds, rho from ``auto_rho``
    (seed centre at the fleet mean) unless given; ``ticks + 2`` drifting
    states."""
    import torch

    N, batch = C1_N, batch or FLEET
    A, B, d = double_integrator()
    rng = np.random.default_rng(1)
    x0s = np.array([1.0, 0.0])[None] + rng.normal(scale=[0.3, 0.2],
                                                  size=(batch, 2))
    t0 = time.perf_counter()
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    system = tt.LTISystem.create(f32(A), f32(B), f32(d), f32(x0s[0]), N)
    costs = config1_costs(tt, device)
    constraints = (tt.ControlBoundConstraint.create([-2.0], [2.0]),)
    plan = tt.make_control_plan(system, costs, constraints)
    opts = tt.SolverOptions(max_iter=iters, early_exit=False, polish=False)
    center = x0s.mean(0)
    opts = opts.replace(rho=rho if rho is not None else tt.auto_rho(
        plan, x0s, opts, seed_center=center, accurate=True,
        accurate_rounds=rounds))
    step = tt.make_plan_step(plan, opts, batched=True, seed_center=center,
                             accurate=True, accurate_rounds=rounds)
    _sync(device)
    drift = _drift(x0s, rng, ticks)
    return dict(name="config 1", plan=plan, opts=opts, step=step,
                x0s=x0s, x0_seq=drifting(x0s, drift, device), drift=drift,
                system=system, costs=costs, constraints=constraints,
                ticks=ticks, setup_s=time.perf_counter() - t0)


def build_roofline(tt, device, batch: int = 0, horizon: int = 0,
                   iters: int = ROOF_ITERS, rounds: int = ROOF_ROUNDS,
                   ticks: int = ROOF_TICKS):
    """``bench.py:run_roofline``: one LTI point-mass plan (N = 256) for a
    fleet of states, the 75th percentile of the fleet's unconstrained |u|
    as a binding bound, the accurate tick at 2 rounds x 30 iterations;
    ``ticks + 2`` drifting states."""
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
    opts = tt.SolverOptions(max_iter=iters, early_exit=False, polish=False)
    center = x0s.mean(0)
    opts = opts.replace(rho=tt.auto_rho(plan, x0s, opts, seed_center=center,
                                        accurate=True,
                                        accurate_rounds=rounds))
    step = tt.make_plan_step(plan, opts, batched=True, seed_center=center,
                             accurate=True, accurate_rounds=rounds)
    _sync(device)
    drift = np.zeros((ticks + 2, batch, 2))
    drift[:, :, 1] = np.cumsum(
        rng.normal(scale=0.02, size=(ticks + 2, batch)), axis=0)
    x0_seq = [torch.tensor((x0s + drift[t]).astype(np.float32),
                           device=device) for t in range(ticks + 2)]
    return dict(name="roofline fleet", plan=plan, opts=opts, step=step,
                x0s=x0s, x0_seq=x0_seq, ticks=ticks, bound=bnd,
                rounds=rounds, setup_s=time.perf_counter() - t0)


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


def build_config2(tt, device, batch: int = 0, ticks: int = SHORT_TICKS,
                  iters: int = C2_ITERS, rho=None):
    """``bench_all.py:config2``: LTI double integrator N = 10 with a
    trajectory, a control, a mixed and two bound constraints, all f32,
    400 iterations; the general tick through the shared general kernel
    (``use_fused=True``) with rho from ``auto_rho(use_fused=True)`` unless
    given; ``ticks + 2`` drifting states."""
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
    opts = tt.SolverOptions(max_iter=iters, early_exit=False, polish=False)
    center = x0s.mean(0)
    opts = opts.replace(rho=rho if rho is not None else tt.auto_rho(
        plan, x0s, opts, seed_center=center, use_fused=True))
    step = tt.make_plan_step(plan, opts, batched=True, seed_center=center,
                             use_fused=True)
    _sync(device)
    drift = _drift(x0s, rng, ticks)
    return dict(name="config 2", plan=plan, opts=opts, step=step, x0s=x0s,
                center=center, x0_seq=drifting(x0s, drift, device),
                drift=drift, system=system, costs=costs,
                constraints=constraints, ticks=ticks,
                setup_s=time.perf_counter() - t0)


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


def config3_fleet(batch: int = FLEET, ticks: int = SHORT_TICKS):
    """``bench_all.py:config3``'s fleet: the double integrator at N = 10
    with A and B perturbed by 1e-3 per lane and stage, its x0s and the
    ``ticks + 2`` cumulated drifts; numpy, float64."""
    N = C2_N
    A, B, d = double_integrator()
    rng = np.random.default_rng(3)
    As = np.repeat(np.repeat(A[None], N, 0)[None], batch, 0)
    As += rng.normal(scale=1e-3, size=As.shape)
    Bs = np.repeat(np.repeat(B[None], N, 0)[None], batch, 0)
    Bs += rng.normal(scale=1e-3, size=Bs.shape)
    ds = np.repeat(np.repeat(d[None], N, 0)[None], batch, 0)
    x0s = np.array([1.0, 0.0])[None] + rng.normal(scale=[0.3, 0.2],
                                                  size=(batch, 2))
    return As, Bs, ds, x0s, _drift(x0s, rng, ticks)


def build_config2_ltv(tt, device, dtype, batch: int = 0):
    """Config 2's costs and constraints on per-lane LTV dynamics: A and B
    perturbed by 1e-3 per lane (``bench_all.py:config3``'s fleet), so every
    lane has its own condensed rows.  Returns the batched system, the
    terms and a drifting x0 sequence (numpy, float64)."""
    import torch

    As, Bs, ds, x0s, drift = config3_fleet(batch or FLEET)
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


# where the profiles' Chrome traces go (inside the checkout, git-ignored)
TRACE_DIR = os.path.join("smoke_out", "traces")


def _profile(fn, label: str):
    """One ``fn()`` under ``torch.profiler`` (host and device), inside a
    ``profiling.trace_span(label)``; its Chrome trace is exported (and
    kept) under ``TRACE_DIR`` and read by ``profiling.trace_device_time``:
    the interval union per stream.  Returns ``(busy ms or None, [(kernel,
    ms), ...] longest first, the trace's event names, the sum of the
    device events' durations in ms)``; busy is None when the trace has no
    device track."""
    import torch
    from copra_tpu_torch.profiling import (DEVICE_CATEGORIES,
                                           trace_device_time, trace_span)
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(TRACE_DIR, "".join(c if c.isalnum() else "_"
                                          for c in label))
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace_span(label):
            fn()
            torch.cuda.synchronize()
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    names = {e.get("name") for e in events}
    summed = sum(float(e.get("dur", 0.0)) for e in events
                 if e.get("ph") == "X"
                 and e.get("cat") in DEVICE_CATEGORIES) * 1e-3
    got = trace_device_time(out, top_k=1 << 20)
    if got is None:
        return None, [], names, summed
    busy, top = got
    return busy * 1e3, [(k, v * 1e3) for k, v in top], names, summed


def _report_profile(label: str, prof, span_ms: float, own=None,
                    kernels=(), top: int = 6) -> None:
    """The profile ``prof`` (:func:`_profile`) of one call beside
    ``span_ms``, that call's CUDA-event span: the kernels' busy time (the
    interval union per stream) and the device's idle share, beside what a
    sum of durations gives.  Busy time above the span by more than 3% is a
    miscount and fails.  ``own = (name fragment, ms)`` is what the kernels
    so named take in one call by their own CUDA-event timing; where the
    profiler's records of them differ from it by more than 15%, the
    profile is not trusted and the idle share is not measured.  Each
    symbol of ``kernels`` must name one of the top 8 ops, and the span
    ``label`` must be in the trace (a device track is then required)."""
    busy, ops, names, summed = prof
    if busy is None:
        if kernels:
            fail(f"profile {label}: no device track in the trace")
        print(f"profile {label}: the profiler saw no device time; idle "
              f"share not measured")
        return
    tops = "; ".join(f"{k[:60]} {ms:.4f} ms" for k, ms in ops[:top])
    ranks = {sym: next((i for i, (k, _) in enumerate(ops[:8]) if sym in k),
                       None) for sym in kernels}
    head = f"profile {label}: kernels busy {busy:.4f} ms (interval " \
        f"union per stream; durations summed {summed:.4f} ms, idle share " \
        f"{1.0 - summed / span_ms:.4f} by that sum) of a {span_ms:.4f} ms " \
        f"span; span in the trace {label in names}"
    if kernels:
        head += f"; kernel ranks among the top 8 {ranks}"
    if busy > 1.03 * span_ms:
        fail(f"profile {label}: kernels busy {busy:.4f} ms exceed 1.03 x "
             f"the {span_ms:.4f} ms span")
    if kernels and (label not in names or None in ranks.values()):
        fail(f"profile {label}: the span or a kernel is missing from the "
             f"trace ({ranks})")
    if own is not None:
        seen = sum(ms for k, ms in ops if own[0] in k)
        if abs(seen - own[1]) > 0.15 * own[1]:
            print(f"{head}; idle share not measured (the profiler saw "
                  f"{seen:.4f} ms of {own[0]}, its own timing gives "
                  f"{own[1]:.4f} ms); top: {tops}")
            return
    print(f"{head} (idle share {1.0 - busy / span_ms:.4f}); top: {tops}")


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
    label = f"config 4 chained, one replay of {TICKS} ticks"
    _report_profile(label, _profile(lambda: many(seq, warm), label),
                    dev_ms * TICKS, own=("box_", k1_ms * TICKS),
                    kernels=("box_register_kernel", "box_qx_kernel"))
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
    label = f"{cfg['name']} chained, one replay of {T} ticks"
    _report_profile(label, _profile(
        lambda: many(None, T, warm=warm, x0_seq=seq), label), dev_ms * T,
        own=("stagewise_tick_kernel", own),
        kernels=("stagewise_tick_kernel",))
    label = f"{cfg['name']} status pass, eager"
    _report_profile(label, _profile(status, label), status_ms)
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
    with its work memory); each timed beside its serial form.  Returns the
    config-5 LQ problem without the cross term (phase 31 takes it)."""
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
    return lq


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


def stagewise_fleet(tt, system, costs, constraints, x0s, drift):
    """A condensed configuration in stagewise form over its fleet
    (``bench_all.py:_stagewise_line``): the ``from_mpc`` problem of one
    lane broadcast to the lanes of ``x0s``, and the line's states (the
    ``drift`` of ``ticks + 2`` rows held at its last row, plus 0.001 a
    tick), ``ticks + 9`` of them."""
    import dataclasses

    import torch
    from copra_tpu_torch.qp.riccati import from_mpc

    batch, ticks = x0s.shape[0], drift.shape[0] - 2
    dev = system.A.device
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    one = from_mpc(system, costs, constraints)
    sqp = dataclasses.replace(one, **{
        f.name: getattr(one, f.name).expand(
            (batch,) + getattr(one, f.name).shape).contiguous()
        for f in dataclasses.fields(one) if getattr(one, f.name) is not None
    })
    sqp = dataclasses.replace(sqp, x0=f32(x0s))
    x0_seq = [f32(x0s + drift[min(t, ticks + 1)] + 0.001 * t)
              for t in range(ticks + 9)]
    return sqp, x0_seq


def build_config1_stagewise(tt, device):
    """Config 1's problem (``bench_all.py:config1``) in stagewise form
    over the fleet, its native-oracle plan and the drifting states of
    ``bench_all.py:_stagewise_line``."""
    import torch

    N, batch = C1_N, FLEET
    A, B, d = double_integrator()
    rng = np.random.default_rng(1)
    x0s = np.array([1.0, 0.0])[None] + rng.normal(scale=[0.3, 0.2],
                                                  size=(batch, 2))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    system = tt.LTISystem.create(f32(A), f32(B), f32(d), f32(x0s[0]), N)
    costs = config1_costs(tt, device)
    cons = (tt.ControlBoundConstraint.create([-2.0], [2.0]),)
    plan = tt.make_control_plan(system, costs, cons)
    sqp, x0_seq = stagewise_fleet(tt, system, costs, cons, x0s,
                                  _drift(x0s, rng, SHORT_TICKS))
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


# ---------------------------------------------------------------------------
# The closed loop, checkpoints, traces and the examples (phases 27-30).
# ---------------------------------------------------------------------------

# the closed loop at config 4's width: ticks of the rebuild route, ticks of
# the plan route on lane 0 (the reference's test: 20 ticks, max_iter 1500,
# states within 2e-4 and controls within 2e-3 of the rebuild route,
# tests/test_receding.py:96-104), and the tick a checkpoint is taken at
LOOP_TICKS, PLAN_LOOP_TICKS, PLAN_MAX_ITER, RESUME_AT = 5, 20, 1500, 2
PLAN_STATE_TOL, PLAN_CONTROL_TOL = 2e-4, 2e-3
PLANT_TOL = 1e-12
# the fleet example's converged lane-ticks (its reference run on the CPU:
# 0.8873)
FLEET_CONVERGED = 0.85


def loop_terms(tt, f):
    """Config 4's costs and control bound (``build_serving``'s), each
    array made by ``f``."""
    costs = (tt.TargetCost.create(f(np.eye(2)), f([0.0, -1.0]),
                                  weights=f([10.0, 1e4])),
             tt.ControlCost.create(f([[1.0]]), f([2.0]), weights=f([1e-4])))
    return costs, (tt.ControlBoundConstraint.create(f([-BOUND]),
                                                    f([BOUND])),)


def closed_loop_phase(tt, dev):
    """Phase 27: config 4's fleet (``build_fleet``'s arrays in float64:
    4096 LTV lanes, N = 100, +-60 bound) through ``receding.closed_loop``'s
    rebuild route for LOOP_TICKS ticks with default options, lanes as one
    batch and each lane's plant its own stage 0: the controls of lanes 0,
    1, 17 and 4095 at every tick, and their whole plans, against the
    native oracle on that lane's QP at the realized state (<= 1e-5), the
    plant identity, host ms a tick; then lane 0 through ``use_plan=True``
    for PLAN_LOOP_TICKS ticks against the rebuild route on the same lane.
    Returns what phases 28 and 29 reuse."""
    import torch
    from copra_tpu_torch.receding import closed_loop

    t_phase = time.perf_counter()
    arrays = [np.asarray(a, np.float64) for a in build_fleet(BATCH,
                                                             HORIZON)[0]]
    f64 = lambda a: torch.tensor(np.asarray(a, np.float64), device=dev)
    system = tt.LTVSystem(*(f64(a) for a in arrays))
    costs, cons = loop_terms(tt, f64)
    opts = tt.SolverOptions()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = closed_loop(system, costs, cons, LOOP_TICKS, opts)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / LOOP_TICKS
    X, U = res.states, res.controls
    if tuple(X.shape) != (BATCH, LOOP_TICKS + 1, 2) \
            or tuple(U.shape) != (BATCH, LOOP_TICKS, 1) \
            or tuple(res.solutions.status.shape) != (BATCH, LOOP_TICKS) \
            or not bool(torch.isfinite(X).all() & torch.isfinite(U).all()):
        fail(f"closed loop: states {tuple(X.shape)}, controls "
             f"{tuple(U.shape)}")
    # the plant identity: each lane stepped with its own stage 0
    A0, B0, d0 = system.A[:, 0], system.B[:, 0], system.d[:, 0]
    plant = max(float((X[:, t + 1] - torch.einsum("bij,bj->bi", A0, X[:, t])
                       - torch.einsum("bij,bj->bi", B0, U[:, t])
                       - d0).abs().max()) for t in range(LOOP_TICKS))
    cpu_terms = loop_terms(tt, lambda a: torch.tensor(np.asarray(
        a, np.float64)))
    err = plan_err = 0.0
    Xh, Uh, plans = X.cpu(), U.cpu(), res.solutions.x.cpu()
    lanes = (0, 1, 17, BATCH - 1)
    for lane in lanes:
        preview = tt.condense(tt.LTVSystem(*(torch.tensor(a[lane])
                                             for a in arrays)))
        for t in range(LOOP_TICKS):
            qp = tt.build_qp(preview, Xh[lane, t], *cpu_terms)
            exact = tt.solve_qp_native(qp).x
            err = max(err, float((Uh[lane, t] - exact[:1]).abs().max()))
            plan_err = max(plan_err, float((plans[lane, t] - exact).abs()
                                           .max()))
    share = float((res.solutions.status == 0).double().mean())
    iters = res.solutions.iterations.double().mean(0).tolist()
    # lane 0 on the plan route against the rebuild route
    lane0 = tt.LTVSystem(*(f64(a[0]) for a in arrays))
    popts = tt.SolverOptions(max_iter=PLAN_MAX_ITER)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    planned = closed_loop(lane0, costs, cons, PLAN_LOOP_TICKS, popts,
                          use_plan=True)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3 / PLAN_LOOP_TICKS
    t0 = time.perf_counter()
    rebuilt = closed_loop(lane0, costs, cons, PLAN_LOOP_TICKS, popts)
    torch.cuda.synchronize()
    lane_ms = (time.perf_counter() - t0) * 1e3 / PLAN_LOOP_TICKS
    ds = float((planned.states - rebuilt.states).abs().max())
    du = float((planned.controls - rebuilt.controls).abs().max())
    print(f"closed loop (config 4's fleet, B = {BATCH}, N = {HORIZON}, "
          f"float64, {LOOP_TICKS} ticks of the rebuild route, default "
          f"options): {loop_ms:.1f} host ms/tick (condensing once "
          f"included), mean iterations a tick {[round(i, 1) for i in iters]}"
          f", converged share {share:.6f}, max_err_vs_exact {err:.3e} "
          f"(applied control) and {plan_err:.3e} (the whole plan) on lanes "
          f"{list(lanes)} at every tick, plant identity "
          f"{plant:.3e}; lane 0, {PLAN_LOOP_TICKS} ticks at max_iter "
          f"{PLAN_MAX_ITER}: plan route {plan_ms:.2f} host ms/tick, rebuild "
          f"route {lane_ms:.2f}, states within {ds:.3e} (tol "
          f"{PLAN_STATE_TOL}), controls within {du:.3e} (tol "
          f"{PLAN_CONTROL_TOL}); phase 27 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not max(err, plan_err) <= ORACLE_TOL:
        fail(f"closed loop: max_err_vs_exact {err:.3e} / {plan_err:.3e} "
             f"> {ORACLE_TOL}")
    if not plant <= PLANT_TOL:
        fail(f"closed loop: the plant identity is off by {plant:.3e}")
    if not (ds <= PLAN_STATE_TOL and du <= PLAN_CONTROL_TOL):
        fail(f"closed loop: the plan route is {ds:.3e} / {du:.3e} from "
             f"the rebuild route")
    return dict(system=system, costs=costs, cons=cons, opts=opts, res=res,
                loop_ms=loop_ms)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _store(label: str, state, out: str, meta: dict):
    """``state`` saved as npz and through DCP under ``out``, both loaded
    back onto the card: ``(npz state, DCP state, metadata, line)``."""
    import torch
    from copra_tpu_torch._graph import tree_map
    from copra_tpu_torch.checkpoint import (load_pytree, load_pytree_dcp,
                                            save_pytree, save_pytree_dcp)

    npz, dcp = os.path.join(out, f"{label}.npz"), os.path.join(out, label)
    like = tree_map(torch.zeros_like, state)
    ms = []

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return got

    clock(lambda: save_pytree(npz, state, meta))
    clock(lambda: save_pytree_dcp(dcp, state))
    from_npz, saved_meta = clock(lambda: load_pytree(npz, like))
    from_dcp = clock(lambda: load_pytree_dcp(dcp, like))
    line = (f"npz {os.path.getsize(npz)} bytes, save {ms[0]:.1f} ms, load "
            f"{ms[2]:.1f} ms; DCP {_dir_bytes(dcp)} bytes, save "
            f"{ms[1]:.1f} ms, load {ms[3]:.1f} ms")
    return from_npz, from_dcp, saved_meta, line


def _same(a, b) -> bool:
    """Two trees of tensors, leaf for leaf: device, dtype and bits."""
    import torch
    from copra_tpu_torch.checkpoint import _flatten

    la, lb = _flatten(a)[0], _flatten(b)[0]
    return len(la) == len(lb) and all(
        x.device == y.device and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def checkpoint_phase(tt, sk, loop, cfg5, reset_counts):
    """Phase 28: resume from a checkpoint.  Config 4's fleet: phase 27's
    loop again through ``make_receding_step`` (its controls equal phase
    27's bit for bit), the warm state at tick RESUME_AT saved as npz
    (``save_warm_start``) and through ``save_pytree_dcp``, both loaded
    onto the card and LOOP_TICKS - RESUME_AT ticks resumed from each: the
    resumed U equals the unbroken run's bit for bit.  The same for config
    5's stagewise warm tuple from ``make_stagewise_step`` (K4).  Returns
    K4's launches."""
    import torch
    from copra_tpu_torch.receding import (_first_step_plant, cold_start,
                                          make_receding_step)

    t_phase = time.perf_counter()
    out = os.path.join("smoke_out", "checkpoints")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    system, costs, cons = loop["system"], loop["costs"], loop["cons"]
    step, preview = make_receding_step(system, costs, cons, loop["opts"])
    plant = _first_step_plant(system)
    qp0 = tt.build_qp(preview, system.x0, costs, cons)
    warm = cold_start(preview, qp0.nr_eq, qp0.nr_ineq, qp0.Q.dtype)
    x, Us, tick_ms = system.x0, [], []
    for t in range(LOOP_TICKS):
        if t == RESUME_AT:
            at = (x, warm)
        t0 = time.perf_counter()
        u0, U, _, warm = step(x, warm)
        x = plant(x, u0)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        Us.append(U)
    t0 = time.perf_counter()
    tt.build_qp(preview, x, costs, cons)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    same_loop = torch.equal(torch.stack([U[:, :1] for U in Us], 1),
                            loop["res"].controls)
    from_npz, from_dcp, meta, line4 = _store("config4_warm", at[1], out,
                                            {"tick": RESUME_AT})
    resumed4 = []
    for w in (from_npz, from_dcp):
        x, ok = at[0], _same(w, at[1])
        for t in range(RESUME_AT, LOOP_TICKS):
            u0, U, _, w = step(x, w)
            x = plant(x, u0)
            ok = ok and torch.equal(U, Us[t])
        resumed4.append(ok)
    # config 5's stagewise warm tuple (K4)
    tick, seq = cfg5["tick"], cfg5["x0_seq"]
    entry = _entry(sk, cfg5["fleet"])
    reset_counts()
    w, U5 = None, []
    for t in range(LOOP_TICKS):
        if t == RESUME_AT:
            at5 = w
        _, U, _, w = tick(seq[t], w)
        U5.append(U)
    s_npz, s_dcp, _, line5 = _store("config5_warm", at5, out,
                                    {"tick": RESUME_AT})
    resumed5 = []
    for w in (s_npz, s_dcp):
        ok = _same(w, at5)
        for t in range(RESUME_AT, LOOP_TICKS):
            _, U, _, w = tick(seq[t], w)
            ok = ok and torch.equal(U, U5[t])
        resumed5.append(ok)
    torch.cuda.synchronize()
    n = entry.launches
    shutil.rmtree(out)
    print(f"checkpoints: config 4's fleet (WarmStart x {tuple(at[1].x.shape)}"
          f", y, z {tuple(at[1].y.shape)}, float64) saved at tick "
          f"{RESUME_AT}: {line4}; the receding step's loop equals phase "
          f"27's bit for bit: {same_loop} (host ms a tick "
          f"{[round(m, 1) for m in tick_ms]}, of which build_qp "
          f"{build_ms:.1f}); {LOOP_TICKS - RESUME_AT} ticks "
          f"resumed bit for bit from npz / DCP: {resumed4}; config 5's "
          f"stagewise warm tuple ({len(at5)} tensors, "
          f"{sum(t.numel() for t in at5)} float32 values): {line5}; "
          f"resumed bit for bit from npz / DCP: {resumed5}; {n} "
          f"{entry.__name__} launches; phase 28 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not (same_loop and all(resumed4) and all(resumed5)
            and meta == {"tick": RESUME_AT}):
        fail("checkpoints: a resumed tick differs from the unbroken run")
    if n == 0:
        fail(f"checkpoints: config 5's ticks never launched "
             f"{entry.__name__}")
    return {entry.__name__: n}


def metrics_phase(loop):
    """Phase 29: ``solve_metrics`` of phase 27's last tick against a numpy
    recomputation (phases 20 and 21 gate ``trace_span`` and
    ``trace_device_time`` on their traces)."""
    import dataclasses

    import torch
    from copra_tpu_torch.profiling import solve_metrics

    t_phase = time.perf_counter()
    sols = loop["res"].solutions
    last = type(sols)(**{f.name: getattr(sols, f.name)[:, -1]
                         for f in dataclasses.fields(sols)})
    elapsed = loop["loop_ms"] * 1e-3
    got = solve_metrics(last, elapsed_s=elapsed)
    st, rp, rd, it = (getattr(last, f).cpu().numpy() for f in (
        "status", "primal_residual", "dual_residual", "iterations"))
    want = {"batch": int(st.size), "converged": int((st == 0).sum()),
            "convergence_rate": float((st == 0).mean()),
            "max_primal_residual": float(rp.max()),
            "max_dual_residual": float(rd.max()),
            "mean_iterations": float(it.mean()),
            "max_iterations": int(it.max()), "seconds": elapsed,
            "solves_per_s": st.size / elapsed}
    torch.cuda.synchronize()
    print(f"solve_metrics of phase 27's last tick: {got}; equal to the "
          f"numpy recomputation: {got == want}; phase 29 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    if got != want:
        fail(f"solve_metrics {got} differs from {want}")


def served_tick_vs_plain(sk, name, facade, x0, warm):
    """One served tick of an example, its plan and inputs as the example
    left them (``facade``: the ``StagewiseTick`` or ``StagewiseMultistep``
    it served with; ``x0``, ``warm``: the next tick's state in physical
    units and warm tuple): the tick kernel against its plain version at
    phases 5-7's tolerances.  Returns the line."""
    import torch

    if hasattr(facade, "_plans"):
        opts = facade._options
        fp = facade._plans[facade._plan_key(opts)]
    else:
        opts, fp = facade._options, facade._data[3]
    if facade._scale is not None:
        x0 = x0 / facade._scale[0]
    entry, kw, _, out = served_vs_plain(sk, fp, opts, x0, warm)
    (e32, ms), scale32, plain_ms, _ = out[torch.float32]
    e64 = out[torch.float64][0][0]
    line = (f"{name}'s served tick through {entry.__name__} (B = "
            f"{x0.shape[0]}, N = {kw['N']}, x = {kw['x']}, u = {kw['u']}, "
            f"r = {kw['r']}, {kw['n_iter']} iterations): float64 "
            f"max_abs_err {e64:.3e} (tol {F64_TOL}), float32 {e32:.3e} (tol "
            f"{F32_RTOL * scale32:.3e}) against its plain version, "
            f"{ms:.4f} ms against {plain_ms:.4f} ms")
    if not (e64 <= F64_TOL and e32 <= F32_RTOL * scale32):
        fail(f"example {name}: {line}")
    return line


def examples_phase(tt, sk, reset_counts):
    """Phase 30: each port example at its default size on the card, with
    its own checks as gates: ``torch_getting_started.main()`` (N = 300,
    float64; v <= 0 and force <= 200 N), ``torch_bipedal_walking``'s
    ``solve_preview()`` (N = 300, float64; the ZMP inside the polygon to
    1e-6) and ``serve_fleet()`` (4 robots; every lane of the last tick
    converged), ``torch_quadruped_srb.serve()`` (4 robots, N = 40; every
    lane converged, the friction cones and the height corridor) and
    ``torch_fleet_serving.main()`` (converged share >= FLEET_CONVERGED);
    the servers' ticks as each example records them.  K4 must launch in
    the bipedal and fleet examples, K5 in the quadruped's.  Then, counted
    apart, the tick kernel against its plain version on one served tick
    of the quadruped server (K5) and of the fleet-serving chain (K4), the
    shapes no other phase holds (the bipedal fleet's is config 5's).
    Returns the launches by entry point."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples"))
    import torch_bipedal_walking as bipedal
    import torch_fleet_serving as fleet
    import torch_getting_started as getting_started
    import torch_quadruped_srb as quadruped

    t_phase = time.perf_counter()
    k4, k5 = sk.fused_stagewise_tick, sk.fused_stagewise_tick_streamed
    launches = {k4.__name__: 0, k5.__name__: 0}
    lines = []

    def run(name, fn, need):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for w in (k4, k5):
            launches[w.__name__] += w.launches
        if need is not None and need.launches == 0:
            fail(f"example {name}: no {need.__name__} launch")
        counts = f"{k4.launches} K4, {k5.launches} K5 launches"
        return got, secs, counts

    (X, U, ctl), secs, counts = run("getting_started",
                                    getting_started.main, None)
    vmax, fmax = float(X[1::2].max()), float(U.max())
    lines.append(f"getting_started (LMPC, N = 300, f64): solve "
                 f"{ctl.solve_time() * 1e3:.1f} ms, {secs:.2f} s in all, "
                 f"max v {vmax:+.2e}, max force {fmax:.2f} N")
    if not (vmax <= 1e-6 and fmax <= 200.0 + 1e-6):
        fail(f"example getting_started: v {vmax:.3e}, force {fmax:.3f}")

    (X, U, zmp, (ref, lo, hi), sol), secs, counts = run(
        "bipedal solve_preview", bipedal.solve_preview, k4)
    inside = bool((zmp <= hi + 1e-6).all() and (zmp >= lo - 1e-6).all())
    lines.append(f"bipedal solve_preview (N = 300, f64, 2 lanes): "
                 f"{secs:.2f} s, statuses {sol.status.tolist()}, iterations "
                 f"{sol.iterations.tolist()}, ZMP in the polygon {inside}, "
                 f"{counts}")
    if not inside:
        fail("example bipedal: the ZMP leaves the support polygon")

    biped = {}
    (X, U, info), secs, counts = run(
        "bipedal serve_fleet", lambda: bipedal.serve_fleet(record=biped), k4)
    ticks = [t * 1e3 for t in biped["tick_s"]]
    conv = bool((info.status == 0).all())
    lines.append(f"bipedal serve_fleet (4 robots = 8 lanes, N = 300, f32): "
                 f"{secs:.2f} s with the server's set-up, cold tick "
                 f"{ticks[0]:.2f} ms, warm ticks "
                 f"{[round(t, 2) for t in ticks[1:]]} ms, all lanes "
                 f"converged {conv}, {counts}")
    if not conv:
        fail("example bipedal serve_fleet: a lane did not converge")

    quad = {}
    (X, U, info, wi), secs, counts = run(
        "quadruped serve",
        lambda: quadruped.serve(verbose=False, record=quad), k5)
    ticks = [t * 1e3 for t in quad["tick_s"]]
    f = U[:, 0].double().cpu().numpy().reshape(-1, 4, 3)
    h = X[:, :, 5].double().cpu().numpy()
    physical = bool((f[..., 2] >= -1e-4).all()
                    and (np.abs(f[..., :2]) <= 0.6 * f[..., 2:] + 1e-3).all()
                    and (h >= 0.2 - 1e-5).all() and (h <= 0.4 + 1e-5).all())
    conv = bool((info.status == 0).all())
    lines.append(f"quadruped serve (4 robots, N = 40, f32, measured warm "
                 f"iterations {wi}): {secs:.2f} s with the server's set-up, "
                 f"cold tick {ticks[0]:.2f} ms, warm ticks "
                 f"{[round(t, 2) for t in ticks[1:]]} ms, all lanes "
                 f"converged {conv}, cones and corridor held {physical}, "
                 f"{counts}")
    if not (conv and physical):
        fail(f"example quadruped: converged {conv}, physical {physical}")

    served = {}
    (statuses, states, share), secs, counts = run(
        "fleet_serving", lambda: fleet.main(record=served), k4)
    chains = [t * 1e3 for t in served["chain_s"]]
    lines.append(f"fleet_serving (16 robots, N = 12, f32, 2 chains of 50 "
                 f"ticks): {secs:.2f} s with rho's probes, first chain "
                 f"(capture) {chains[0]:.1f} ms, second {chains[1] / 50:.4f} "
                 f"host ms/tick, converged share {share:.4f} (gate "
                 f"{FLEET_CONVERGED}), {counts}")
    if not share >= FLEET_CONVERGED:
        fail(f"example fleet_serving: converged share {share:.4f}")
    # not counted: the served ticks' kernels against their plain versions
    for name, rec in (("quadruped", quad), ("fleet_serving", served)):
        lines.append(served_tick_vs_plain(sk, name, rec["tick"], rec["x0"],
                                          rec["warm"]))
    print("examples on the card: " + "; ".join(lines) + f"; phase 30 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# The parallel layer (phase 31) on torch.distributed, in a world of one
# process: one card cannot host two NCCL ranks, so the collectives between
# processes are held by the CPU tests (gloo, four processes) and the card
# runs NCCL's path at world 1.
# ---------------------------------------------------------------------------

# the model-parallel solve at config 4's width (lockstep iterations; the
# golden QP's 1500 are tests/test_model_parallel.py's), the DP x TP lanes
MP_GOLDEN_ITERS, MP_WIDE_ITERS, DP_TP_LANES = 1500, 200, 64
MP_TOL, LQ_TOL, GOLDEN_U_TOL, GOLDEN_X_TOL = 1e-8, 1e-9, 2e-4, 1e-4


def _once_ms(fn):
    """``fn()`` and its ms between CUDA events recorded around it."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    got = fn()
    b.record()
    torch.cuda.synchronize()
    return got, a.elapsed_time(b)


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def parallel_phase(tt, dev, card: str, lq):
    """Phase 31: the parallel layer on the card, NCCL at world 1
    (``distributed_init`` in this process, ``127.0.0.1`` on a free port):
    (a) ``examples/torch_batched_serving.main()`` at its defaults, its
    cold sharded step equal bit for bit to the unsharded fixed-count
    ``solve_mpc_batch``, the warm step timed by CUDA events; (b)
    ``sharded_solve_mpc`` on the SmallSystem's 16-lane fleet (f64, default
    options), lane 0 against the golden control and every lane against the
    native oracle; (c) ``solve_qp_model_parallel`` in f64 on the golden QP
    and on config 4's N = 300 lane with trajectory and control bounds
    against ``solve_qp`` at the same lockstep options, then
    ``solve_qp_dp_tp`` on a (1, 1) mesh over 64 such lanes; (d)
    ``lqr_solve_sharded`` and ``lqr_solve_sharded_batch`` at phase 22's
    config-5 LQ width (no cross term) against ``lqr_solve`` and
    ``lqr_solve_assoc``; (e) the cold step's warm start as ``Shard(0)``
    DTensors through ``save_pytree_dcp`` and back, one step resumed bit
    for bit.  Every line carries ``card``."""
    import collections
    import dataclasses

    import torch
    import torch.distributed as dist
    from copra_tpu_torch._graph import tree_map
    from copra_tpu_torch.checkpoint import load_pytree_dcp, save_pytree_dcp
    from copra_tpu_torch.parallel import (_collectives, batch_axes,
                                          distributed_init, make_mesh,
                                          shard_batch, sharded_solve_mpc,
                                          solve_mpc_batch,
                                          solve_qp_model_parallel)
    from copra_tpu_torch.parallel.horizon import (lqr_solve_sharded,
                                                  lqr_solve_sharded_batch)
    from copra_tpu_torch.parallel.model import solve_qp_dp_tp
    from copra_tpu_torch.qp import riccati as tr
    from copra_tpu_torch.qp.admm import _BASE_NDIM

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "examples"))
    sys.path.insert(0, os.path.join(here, "tests"))
    import fixtures as fx
    import torch_batched_serving as example

    t_phase = time.perf_counter()
    distributed_init(f"127.0.0.1:{example._free_port()}", 1, 0)
    backend = dist.get_backend()
    tag = f"({card})"
    lines = [f"process group: {backend}, world {dist.get_world_size()}"]

    # (a) the example at its defaults
    rec = {}
    got = example.main(record=rec)
    fleet, costs, cons = example.build_fleet()
    cold, stats = rec["cold"], rec["cold_stats"]
    want = solve_mpc_batch(fleet, costs, cons,
                           rec["options"].replace(early_exit=False))
    same = all(torch.equal(a.to_local(), b) for a, b in (
        (cold.control, want.control), (cold.solution.x, want.solution.x),
        (cold.solution.y, want.solution.y),
        (cold.solution.z, want.solution.z)))
    n_solved = int((want.solution.status == 0).sum())
    step, sharded = rec["step"], rec["fleet"]
    warm = tt.WarmStart(x=cold.solution.x, y=cold.solution.y,
                        z=cold.solution.z)
    step_ms = _cuda_ms(lambda: step(sharded, warm), 5)
    lines.append(
        f"(a) torch_batched_serving (B = {got['batch']}, N = "
        f"{got['horizon']}, 60 iterations): cold sharded step equal bit for "
        f"bit to the unsharded solve (control, x, y, z): {same}; total "
        f"{int(stats['total'])}, converged {int(stats['converged'])} of "
        f"{n_solved} solved lanes; warm step {step_ms:.4f} ms by CUDA "
        f"events, {got['batch'] / step_ms * 1e3:.0f} solves/s; the "
        f"example's own host clock {got['warm_step_ms']:.4f} ms, "
        f"converged {got['converged']}/{got['total']}, max primal "
        f"residual {got['max_primal_residual']:.3e} {tag}")
    if not (same and int(stats["total"]) == got["batch"]
            and int(stats["converged"]) == n_solved):
        fail(f"phase 31 (a): {lines[-1]}")

    # (b) sharded_solve_mpc on the SmallSystem's 16-lane fleet
    rng = np.random.default_rng(42)
    x0s = np.repeat(fx.SMALL_X0[None], 16, axis=0)
    x0s[1:] += rng.normal(scale=[0.02, 0.1], size=(15, 2))
    x0s[:, 1] = np.minimum(x0s[:, 1], -0.1)
    base = tt.LTISystem.create(fx.A, fx.B, fx.D, fx.SMALL_X0, fx.SMALL_N)
    small = dataclasses.replace(base, x0=torch.tensor(x0s, device=dev))
    s_costs = (tt.TargetCost.create(fx.M, fx.XD, weights=fx.WX),
               tt.ControlCost.create(fx.N_MAT, fx.UD, weights=fx.WU))
    s_cons = (tt.TrajectoryBoundConstraint.create(fx.X_LOWER, fx.X_UPPER),
              tt.ControlBoundConstraint.create(fx.U_LOWER, fx.U_UPPER))
    mesh = make_mesh()
    res, solve_ms = _once_ms(lambda: sharded_solve_mpc(
        shard_batch(small, mesh, reference=batch_axes(small)), s_costs,
        s_cons, mesh=mesh))
    U, X = res.control.to_local(), res.trajectory.to_local()
    golden = float(np.abs(U[0].cpu().numpy() - fx.GOLDEN_CONTROL).max())
    preview = tt.condense(base)
    eu = ex = 0.0
    for lane in range(16):
        qp = tt.build_qp(preview, small.x0[lane], s_costs, s_cons)
        u = tt.solve_qp_native(qp).x.to(dev)
        eu = max(eu, float((U[lane] - u).abs().max()))
        ex = max(ex, float((X[lane] - preview.trajectory(
            small.x0[lane], u)).abs().max()))
    lines.append(
        f"(b) sharded_solve_mpc (16 lanes, N = 10, f64, default options) "
        f"in {solve_ms:.1f} ms: lane 0 against the golden control "
        f"{golden:.3e} (tol {GOLDEN_U_TOL}); every lane against the native "
        f"oracle: control {eu:.3e} (tol {GOLDEN_U_TOL}), trajectory "
        f"{ex:.3e} (tol {GOLDEN_X_TOL}) {tag}")
    if not (golden <= GOLDEN_U_TOL and eu <= GOLDEN_U_TOL
            and ex <= GOLDEN_X_TOL):
        fail(f"phase 31 (b): {lines[-1]}")

    # (c) model parallel, f64: the golden QP, then config 4 at N = 300
    mmesh = make_mesh(axis_names=("model",))
    lockstep = dict(early_exit=False, polish=False, row_normalize=False,
                    scaling=0, kkt_solve="inverse")
    gqp = tt.build_qp(preview, base.x0.to(dev), s_costs, s_cons)
    opts = tt.SolverOptions(max_iter=MP_GOLDEN_ITERS, **lockstep)
    e_gold = float((solve_qp_model_parallel(gqp, opts, mesh=mmesh).x
                    - tt.solve_qp(gqp, opts).x).abs().max())
    arrays, _, _ = build_fleet(DP_TP_LANES, WIDE_HORIZON)
    f64 = lambda a: torch.tensor(np.asarray(a, np.float64), device=dev)
    lanes = tt.LTVSystem(*(f64(a) for a in arrays))
    w_costs = (tt.TargetCost.create(np.eye(2), [0.0, -1.0],
                                    weights=[10.0, 1e4]),
               tt.ControlCost.create([[1.0]], [2.0], weights=[1e-4]))
    w_cons = (tt.TrajectoryBoundConstraint.create(fx.X_LOWER, fx.X_UPPER),
              tt.ControlBoundConstraint.create([-BOUND], [BOUND]))
    qp_b = tt.build_qp(tt.condense(lanes), lanes.x0, w_costs, w_cons)
    qp = tt.DenseQP(**{f: getattr(qp_b, f)[0] if getattr(qp_b, f).dim() > nd
                       else getattr(qp_b, f) for f, nd in _BASE_NDIM.items()})
    n, m = qp.nr_vars, qp.nr_eq + qp.nr_ineq + qp.nr_vars
    opts = tt.SolverOptions(max_iter=MP_WIDE_ITERS, **lockstep)
    with _collectives.recording() as calls:
        sol = solve_qp_model_parallel(qp, opts, mesh=mmesh)
    counts = collections.Counter(op for op, _, _ in calls)
    ref = tt.solve_qp(qp, opts)
    e_wide = max(_rel(sol.x, ref.x), _rel(sol.y[:m], ref.y),
                 _rel(sol.z[:m], ref.z))
    mp_ms = _cuda_ms(lambda: solve_qp_model_parallel(qp, opts, mesh=mmesh),
                     3)
    ref_ms = _cuda_ms(lambda: tt.solve_qp(qp, opts), 3)
    reduces = counts.get("psum", 0) + counts.get("pmax", 0)
    dmesh = make_mesh((1, 1), ("batch", "model"))
    dsol = solve_qp_dp_tp(qp_b, opts, mesh=dmesh)
    dref = tt.solve_qp(qp_b, opts)
    e_dp = max(_rel(dsol.x.to_local(), dref.x),
               _rel(dsol.y.to_local()[:, :m], dref.y))
    dp_ms = _cuda_ms(lambda: solve_qp_dp_tp(qp_b, opts, mesh=dmesh), 3)
    dref_ms = _cuda_ms(lambda: tt.solve_qp(qp_b, opts), 3)
    lines.append(
        f"(c) solve_qp_model_parallel, f64: the golden QP "
        f"({MP_GOLDEN_ITERS} iterations) against solve_qp {e_gold:.3e} "
        f"(tol {MP_TOL}); config 4's lane at N = {WIDE_HORIZON} (n = {n}, "
        f"m = {m}, {MP_WIDE_ITERS} iterations) {e_wide:.3e} relative (tol "
        f"{MP_TOL}), {mp_ms / MP_WIDE_ITERS:.4f} ms an iteration (solve_qp "
        f"{ref_ms / MP_WIDE_ITERS:.4f}), {reduces} all-reduces "
        f"({MP_WIDE_ITERS} + {reduces - MP_WIDE_ITERS}) and "
        f"{counts.get('all_gather', 0)} all-gather a solve; solve_qp_dp_tp "
        f"on a (1, 1) mesh over {DP_TP_LANES} such lanes {e_dp:.3e} "
        f"relative, {dp_ms:.3f} ms a solve (solve_qp {dref_ms:.3f}) {tag}")
    if not (e_gold <= MP_TOL and e_wide <= MP_TOL and e_dp <= MP_TOL):
        fail(f"phase 31 (c): {lines[-1]}")

    # (d) horizon-sharded LQR at config 5's LQ width
    smesh = make_mesh(axis_names=("seq",))
    bmesh = make_mesh((1, 1), ("batch", "seq"))
    one = tuple(t[0] for t in lq)
    cases = (
        ("lqr_solve_sharded (lane 0)", one,
         lambda: lqr_solve_sharded(*one, mesh=smesh)),
        (f"lqr_solve_sharded_batch ({lq[0].shape[0]} lanes)", lq,
         lambda: lqr_solve_sharded_batch(*lq, mesh=bmesh)))
    worst = 0.0
    for name, args, fn in cases:
        got = tuple(t.full_tensor() for t in fn())
        serial, assoc = tr.lqr_solve(*args), tr.lqr_solve_assoc(*args)
        err = max(_rel(g, w) for ref in (serial, assoc)
                  for g, w in zip(got, ref))
        worst = max(worst, err)
        lines.append(
            f"(d) {name}, N = {args[0].shape[-3]}, x = {args[0].shape[-1]}, "
            f"u = {args[1].shape[-1]}, f64: {err:.3e} relative against "
            f"lqr_solve and lqr_solve_assoc (tol {LQ_TOL}); "
            f"{_cuda_ms(fn, 3):.4f} ms (lqr_solve "
            f"{_cuda_ms(lambda: tr.lqr_solve(*args), 3):.4f}, "
            f"lqr_solve_assoc "
            f"{_cuda_ms(lambda: tr.lqr_solve_assoc(*args), 3):.4f}) {tag}")
    if not worst <= LQ_TOL:
        fail(f"phase 31 (d): {lines[-2:]}")

    # (e) the cold step's warm start, sharded, through DCP
    out = os.path.join("smoke_out", "parallel_dcp")
    shutil.rmtree(out, ignore_errors=True)
    _, save_ms = _once_ms(lambda: save_pytree_dcp(out, warm))
    loaded, load_ms = _once_ms(lambda: load_pytree_dcp(
        out, tree_map(torch.zeros_like, warm)))
    kept = all(a.placements == b.placements and torch.equal(
        a.to_local(), b.to_local()) for a, b in (
        (loaded.x, warm.x), (loaded.y, warm.y), (loaded.z, warm.z)))
    r1, _ = step(sharded, warm)
    r2, _ = step(sharded, loaded)
    resumed = all(torch.equal(a.to_local(), b.to_local()) for a, b in (
        (r1.control, r2.control), (r1.solution.x, r2.solution.x),
        (r1.solution.y, r2.solution.y), (r1.solution.z, r2.solution.z)))
    shutil.rmtree(out)
    lines.append(
        f"(e) DCP of the Shard(0) warm start ({tuple(warm.y.shape)} "
        f"{warm.y.dtype}): save {save_ms:.1f} ms, load {load_ms:.1f} ms, "
        f"placements and bits kept {kept}, one step resumed bit for bit "
        f"{resumed} {tag}")
    if not (kept and resumed):
        fail(f"phase 31 (e): {lines[-1]}")

    dist.destroy_process_group()
    for line in lines:
        print(f"parallel layer: {line}")
    print(f"parallel layer: phase 31 in {time.perf_counter() - t_phase:.1f} "
          f"s {tag}")


# ---------------------------------------------------------------------------
# Phases 32-33: gradients on the card, and the fuzz suites
# ---------------------------------------------------------------------------

GRAD_LANES = (0, 1, 17, BATCH - 1)
GRAD_RTOL = 1e-3        # a derivative against central differences
GRAD_PORT_TOL = 1e-6    # the card's Jacobian against the CPU port's
# a kink inside the central-difference stencil (a clamp or a snap that
# changes side) whose slope jumps by j parts a lane's one-sided slopes by
# j and moves its central difference by up to j / 2: lanes whose slopes
# part by more than the gate (a share of the lane's max |J|) are no check
SMOOTH_TOL = GRAD_RTOL
PLAN_FD_EPS = 1e-3      # (a): the f32 correction's rounding needs a wide step
TUNE_ITERS, TUNE_FD_EPS = 100, 1e-5
# (c): the plain loop under jacfwd costs ~0.8 s an iteration at N = 300
# (host-bound), so the early-exit solve is capped at two chunks
EE_GRAD_ITERS, EE_FD_EPS = 20, 1e-5
FUZZ_CASES = 14
GUARD_REPS = 10000
FUZZ_RECEDING_SEEDS, FUZZ_STAGEWISE_SEEDS, FUZZ_FUSED_SEEDS = (
    (0, 2, 4, 7, 11), (1, 3, 6, 8), (0, 5, 12))


def _peak_gb(base: int) -> str:
    import torch

    peak = torch.cuda.max_memory_allocated()
    return (f"peak device memory {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f}"
            f" GB above the case's start)")


def _case_start() -> int:
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _fd_lanes(J, f, eps: float):
    """Central differences of ``f`` against its Jacobian ``J [B, ..., k]``
    at 0; ``f`` maps a displacement ``d [k]`` of every lane's state to a
    ``[B, ...]`` result (lanes independent, so ``J``'s lane ``b`` is
    ``d f_b / d x0_b``).  Returns per lane ``(smooth, rel)``: whether its
    one-sided slopes agree within ``SMOOTH_TOL`` x its max |J| (a kink in
    the stencil parts them by the slope's jump), and max |J - central| /
    max |J|.  The differences run under ``no_grad`` (the kernel routes)."""
    import torch

    k = J.shape[-1]
    E = torch.eye(k, dtype=J.dtype, device=J.device) * eps
    with torch.no_grad():
        f0 = f(torch.zeros(k, dtype=J.dtype, device=J.device))[..., None]
        fp = torch.stack([f(e) for e in E], -1)
        fm = torch.stack([f(-e) for e in E], -1)
    dims = tuple(range(1, J.dim()))
    scale = J.abs().amax(dims).clamp_min(1e-300)
    kink = ((fp - f0) - (f0 - fm)).abs().amax(dims) / eps / scale
    rel = (J - (fp - fm) / (2 * eps)).abs().amax(dims) / scale
    return kink <= SMOOTH_TOL, rel


def _fd_verdict(what: str, smooth, rel, lanes) -> str:
    """Gate the smooth lanes at ``GRAD_RTOL`` (at least half of them must
    be smooth) and describe ``lanes``."""
    import torch

    n, B = int(smooth.sum()), smooth.numel()
    worst = float(rel[smooth].max()) if n else float("nan")
    named = ", ".join(f"{lane}: {float(rel[lane]):.2e}"
                      f"{'' if bool(smooth[lane]) else ' (kink)'}"
                      for lane in lanes)
    if n * 2 < B:
        fail(f"{what}: only {n} of {B} lanes are smooth on the "
             f"central-difference stencil")
    if not worst <= GRAD_RTOL:
        fail(f"{what}: the derivative is {worst:.3e} from central "
             f"differences (rtol {GRAD_RTOL}) on lane "
             f"{int(torch.where(smooth, rel, 0.0).argmax())}; {n} of {B} "
             f"lanes smooth on the stencil")
    return (f"central differences on the {n} of {B} lanes smooth on the "
            f"stencil max rel {worst:.3e} (rtol {GRAD_RTOL}; lanes {named})")


def _refuses(what: str, call, x, route: str) -> str:
    """``call(x)`` with a gradient asked of ``x`` by ``requires_grad``, by
    ``torch.func.vjp`` and by a forward-mode tangent: each must raise the
    refusal naming ``route``."""
    import torch
    import torch.autograd.forward_ad as fwAD

    def forward_mode():
        with fwAD.dual_level():
            return call(fwAD.make_dual(x, torch.ones_like(x)))

    ways = {"requires_grad": lambda: call(x.detach().clone()
                                          .requires_grad_()),
            "torch.func.vjp": lambda: torch.func.vjp(call, x),
            "forward-mode AD": forward_mode}
    for way, run in ways.items():
        try:
            run()
        except RuntimeError as e:
            if "has no derivative" in str(e) and route in str(e):
                continue
            fail(f"{what}: a gradient asked by {way} raised another error: "
                 f"{e}")
        fail(f"{what}: a gradient asked by {way} did not raise")
    return f"refuses ({', '.join(ways)}) naming {route}"


def _launches_under_no_grad(what: str, call, x, wrappers, reset_counts):
    """``call(x)`` under ``no_grad`` on a ``requires_grad`` copy of ``x``:
    it must launch one of ``wrappers``.  Returns the launches."""
    import torch

    reset_counts()
    with torch.no_grad():
        call(x.detach().clone().requires_grad_())
    torch.cuda.synchronize()
    n = sum(w.launches for w in wrappers)
    if n == 0:
        fail(f"{what}: under no_grad no kernel was launched")
    return n


def grad_plan_case(tt, ak, plan, opts, step, x0s, x0_dev, reset_counts,
                   card):
    """Phase 32 (a): ``jacfwd`` of config 4's served controls in x0 through
    the plain accurate tick (``use_fused=False``) on the card, against
    central differences and the CPU port on lanes 0, 1, 17 and B-1; the
    kernel tick (default ``use_fused``) refuses and, under ``no_grad``,
    launches K1.  Returns the K1 launches."""
    import torch
    from copra_tpu_torch._graph import tree_map
    from copra_tpu_torch.plan import _slice_plan

    f64 = torch.float64
    plain = tt.make_plan_step(plan, opts, batched=True, seed_center=x0s,
                              accurate=True, accurate_rounds=ROUNDS,
                              use_fused=False)
    x0 = x0_dev[-1].to(f64)
    zero = torch.zeros(2, dtype=f64, device=x0.device)

    def served(d):
        return plain(plan, x0 + d, None)[0]

    base = _case_start()
    _, fwd_ms = _once_ms(lambda: served(zero))
    J, ms = _once_ms(lambda: torch.func.jacfwd(served)(zero))
    mem = _peak_gb(base)
    if tuple(J.shape) != (BATCH, HORIZON, 2) or \
            not bool(torch.isfinite(J).all()):
        fail(f"config 4 jacfwd: shape {tuple(J.shape)} or non-finite")
    fd = _fd_verdict("config 4 jacfwd", *_fd_lanes(J, served, PLAN_FD_EPS),
                     GRAD_LANES)
    idx = np.asarray(GRAD_LANES)
    cplan = _slice_plan(tree_map(lambda t: t.cpu(), plan), idx)
    cstep = tt.make_plan_step(cplan, opts, batched=True,
                              seed_center=x0s[idx], accurate=True,
                              accurate_rounds=ROUNDS, use_fused=False)
    xc = x0[idx].cpu()
    Jc = torch.func.jacfwd(lambda d: cstep(cplan, xc + d, None)[0])(
        zero.cpu())
    port = float((J[idx].cpu() - Jc).abs().max() / Jc.abs().max())
    kernel_tick = lambda x: step(plan, x, None)
    refusal = _refuses("config 4's kernel tick", kernel_tick, x0,
                       "use_fused=False")
    n = _launches_under_no_grad("config 4's kernel tick", kernel_tick, x0,
                                (ak.fused_admm_box_lanes,), reset_counts)
    print(f"gradients (a) config 4, B = {BATCH}, N = {HORIZON}, accurate "
          f"tick with use_fused=False, f64 x0: torch.func.jacfwd of U "
          f"[{BATCH}, {HORIZON}] in x0 {ms:.2f} ms (the tick alone "
          f"{fwd_ms:.2f} ms; CUDA events), max |J| {float(J.abs().max()):.4g};"
          f" {fd}; the CPU port on lanes {list(GRAD_LANES)} {port:.3e} x max"
          f" |J| (tol {GRAD_PORT_TOL}); {mem}; the kernel tick {refusal}, "
          f"under no_grad {n} K1 launches ({card})")
    if not port <= GRAD_PORT_TOL:
        fail(f"config 4 jacfwd: {port:.3e} from the CPU port")
    return n


def grad_tuning_case(tt, dev, card):
    """Phase 32 (b): learned tuning at config 4's width: the gradient of a
    velocity-tracking loss over the 4096 lanes in the log of the target
    weights, by ``backward()`` through ``solve_mpc_batch`` (f64,
    ``TUNE_ITERS`` fixed iterations, no polish), against central
    differences."""
    import torch

    f64 = torch.float64
    arrays, _, _ = build_fleet(BATCH, HORIZON)
    system = tt.LTVSystem(*(torch.tensor(a.astype(np.float64), device=dev)
                            for a in arrays))
    opts = tt.SolverOptions(max_iter=TUNE_ITERS, early_exit=False,
                            polish=False)
    eye = torch.eye(2, dtype=f64, device=dev)
    target = torch.tensor([0.0, -1.0], dtype=f64, device=dev)

    def loss(log_w):
        costs = (tt.TargetCost(M=eye, p=target, weights=torch.exp(log_w)),
                 tt.ControlCost.create([[1.0]], [2.0], weights=[1e-4]))
        constraints = (tt.ControlBoundConstraint.create([-BOUND], [BOUND]),)
        res = tt.solve_mpc_batch(system, costs, constraints, opts)
        return ((res.trajectory[..., 1::2] + 1.0) ** 2).sum()

    lw0 = torch.log(torch.tensor([10.0, 1e4], dtype=f64, device=dev))
    with torch.no_grad():
        _, fwd_ms = _once_ms(lambda: loss(lw0))
    base = _case_start()
    lw = lw0.clone().requires_grad_()
    _, ms = _once_ms(lambda: loss(lw).backward())
    mem = _peak_gb(base)
    g = lw.grad
    with torch.no_grad():
        fd = torch.stack([(loss(lw0 + e) - loss(lw0 - e)) / (2 * TUNE_FD_EPS)
                          for e in eye * TUNE_FD_EPS])
    err = float((g - fd).abs().max() / fd.abs().max())
    print(f"gradients (b) learned tuning at config 4's width: "
          f"solve_mpc_batch, B = {BATCH}, N = {HORIZON}, f64, {TUNE_ITERS} "
          f"fixed iterations, no polish: d loss / d log(target weights) = "
          f"{[float(v) for v in g]} by backward(), forward + backward "
          f"{ms:.2f} ms (the forward alone under no_grad {fwd_ms:.2f} ms; "
          f"CUDA events); central differences {[float(v) for v in fd]}, "
          f"{err:.3e} x max |fd| (rtol {GRAD_RTOL}); {mem} ({card})")
    if not (bool(torch.isfinite(g).all()) and err <= GRAD_RTOL):
        fail(f"learned tuning: the gradient is {err:.3e} from central "
             f"differences")


def grad_stagewise_case(tt, sk, cfg5, reset_counts, card):
    """Phase 32 (c): config 5's fleet in f64 through ``solve_stagewise``
    with the early exit: ``jacfwd`` of U in x0 runs the plain loop on the
    card (no K4 launch), the same call under ``no_grad`` runs K4; the
    Jacobian against central differences (taken on the K4 route) and,
    on lane 0, against the CPU port.  Returns the K4 launches."""
    import dataclasses

    import torch

    f64 = torch.float64
    sqp = _on(cfg5["fleet"], cfg5["fleet"].A.device, f64)
    opts = cfg5["cold_opts"].replace(max_iter=EE_GRAD_ITERS, early_exit=True,
                                     eps_rel=0.0, check_interval=10)
    zero = torch.zeros(3, dtype=f64, device=sqp.A.device)
    entries = (sk.fused_stagewise_tick, sk.fused_stagewise_tick_streamed)

    def solved(d, s=sqp):
        return tt.solve_stagewise(dataclasses.replace(s, x0=s.x0 + d),
                                  opts)[1]

    reset_counts()
    base = _case_start()
    J, ms = _once_ms(lambda: torch.func.jacfwd(solved)(zero))
    mem = _peak_gb(base)
    in_jac = sum(w.launches for w in entries)
    reset_counts()
    with torch.no_grad():
        U, k4_ms = _once_ms(lambda: solved(zero))
    n = sum(w.launches for w in entries)
    lanes = sqp.A.shape[0]
    if in_jac != 0 or n == 0:
        fail(f"config 5 jacfwd: {in_jac} tick-kernel launches inside the "
             f"derivative (want 0), {n} under no_grad (want > 0)")
    if not bool(torch.isfinite(J).all()):
        fail("config 5 jacfwd: non-finite Jacobian")
    fd = _fd_verdict("config 5 jacfwd", *_fd_lanes(J, solved, EE_FD_EPS),
                     (0, lanes - 1))
    cpu = _on(sqp, "cpu", f64, slice(0, 1))
    t0 = time.perf_counter()
    Jc = torch.func.jacfwd(lambda d: solved(d, cpu))(zero.cpu())
    cpu_s = time.perf_counter() - t0
    port = float((J[:1].cpu() - Jc).abs().max() / Jc.abs().max())
    print(f"gradients (c) config 5, {lanes} lanes, N = {sqp.horizon}, f64, "
          f"solve_stagewise with early exit (eps_abs {opts.eps_abs:g}, rho "
          f"{opts.rho:g}, a check every 10, {EE_GRAD_ITERS} iterations at "
          f"most): torch.func.jacfwd of U in x0 on the plain loop "
          f"{ms:.1f} ms with {in_jac} tick-kernel launches; the same call "
          f"under no_grad on K4 {k4_ms:.2f} ms with {n} launches; {fd}; the "
          f"CPU port on lane 0 {port:.3e} x max |J| (tol {GRAD_PORT_TOL}; "
          f"its jacfwd {cpu_s:.1f} s); {mem} ({card})")
    if not port <= GRAD_PORT_TOL:
        fail(f"config 5 jacfwd: {port:.3e} from the CPU port")
    return n


def grad_routes_case(tt, ak, ck, sk, plan, opts, step, x0s, x0_dev, cfgs,
                     configs, reset_counts, card):
    """Phase 32 (d): every kernel route refuses a gradient asked in each of
    three ways, naming its plain route, and launches its kernel under
    ``no_grad``: K1 (phase 4's tick), K2 (config 4's f32 fused tick), K3
    (config 1's shared plan), K4 and K5 (``make_stagewise_step(backend=
    "fused")`` on configs 5 and 6), K6 (config 2, ``use_fused=True``), K7
    and K8 (``ops``), both chains (at the capture and at a replay), the
    f64 polish, and ``solve(engine="native")`` (which solves under
    ``no_grad``).  Returns the launches by wrapper name."""
    import dataclasses

    import torch
    from copra_tpu_torch.ops.polish import polish

    launches = {}

    def route(what, call, x, wrappers, plain):
        refusal = _refuses(what, call, x, plain)
        n = _launches_under_no_grad(what, call, x, wrappers, reset_counts)
        for w in wrappers:
            launches[w.__name__] = launches.get(w.__name__, 0) + w.launches
        return f"{what}: {refusal}; under no_grad {n} launches"

    # the guard's host cost: the test a K1 launch makes of its 8 tensors
    from copra_tpu_torch.ops._derivative import asks_gradient

    x4 = x0_dev[0]
    guard_args = (*step.state[:2], *([x4] * 6))
    t0 = time.perf_counter()
    for _ in range(GUARD_REPS):
        asks_gradient(*guard_args)
    guard_us = (time.perf_counter() - t0) * 1e6 / GUARD_REPS
    lines = [f"the launch guard (asks_gradient over a K1 launch's 8 tensors) "
             f"{guard_us:.2f} us of host time a launch, mean of "
             f"{GUARD_REPS}"]
    lines.append(route("K1, config 4's accurate tick",
                       lambda x: step(plan, x, None), x4,
                       (ak.fused_admm_box_lanes,), "use_fused=False"))
    plan32 = f32_plan(plan)
    f32_tick = tt.make_plan_step(plan32, opts, batched=True,
                                 seed_center=x0s)
    lines.append(route("K2, config 4's f32 fused tick",
                       lambda x: f32_tick(plan32, x, None), x4,
                       (ak.fused_admm_box,), "use_fused=False"))
    for name, wrapper in (("config 1", ak.fused_admm_box_shared),
                          ("config 2", ak.fused_admm_general_shared)):
        cfg = cfgs[name]
        lines.append(route(
            f"{'K3' if name == 'config 1' else 'K6'}, {name}'s tick",
            lambda x, c=cfg: c["step"](c["plan"], x, None), cfg["x0_seq"][0],
            (wrapper,), "use_fused=False"))
    for cfg in configs:
        wrapper = _entry(sk, cfg["fleet"])
        lines.append(route(
            f"{'K4' if wrapper is sk.fused_stagewise_tick else 'K5'}, "
            f"{cfg['name']}'s fused tick", lambda x, c=cfg: c["tick"](x),
            cfg["x0_seq"][0], (wrapper,), "backend='xla'"))
    K7 = random_lanes_general(64, 10, 40, 3, x4.device)
    lines.append(route(
        "K7, fused_admm_general", lambda c: ak.fused_admm_general(
            *K7[:2], c, *K7[3:], n_iter=10, sigma=1e-6, alpha=1.6),
        K7[2], (ak.fused_admm_general,), "solve_qp_batched"))
    M = torch.randn(64, 24, 24, device=x4.device, dtype=torch.float64,
                    generator=torch.Generator(x4.device).manual_seed(5))
    lines.append(route(
        "K8, chol_batched", lambda a: ck.chol_batched(
            a @ a.mT + 24.0 * torch.eye(24, dtype=a.dtype, device=a.device)),
        M, (ck.chol_batched,), "torch.linalg.cholesky"))

    # the chains: refused at the capture, and at a replay of a captured one
    chain = tt.make_plan_multistep(plan, opts, seed_center=x0s,
                                   accurate_rounds=ROUNDS)
    seq = torch.stack(x0_dev[:3])
    lines.append(route("make_plan_multistep", chain, seq,
                       (ak.fused_admm_box_lanes,), "tick by tick"))
    lines.append(f"make_plan_multistep, captured: "
                 f"{_refuses('make_plan_multistep replay', chain, seq, 'tick by tick')}")
    cfg5 = configs[1]
    fleet = cfg5["fleet"]
    with torch.no_grad():
        warm = cfg5["tick"](cfg5["x0_seq"][0])[3]
    chain5 = tt.make_stagewise_multistep(fleet, cfg5["opts"],
                                         cold_options=cfg5["cold_opts"],
                                         backend="fused")
    stream = lambda x: chain5(x, 2, warm)
    lines.append(route("make_stagewise_multistep", stream,
                       cfg5["x0_seq"][1], (sk.fused_stagewise_tick,),
                       "tick by tick"))
    lines.append(f"make_stagewise_multistep, captured: "
                 f"{_refuses('make_stagewise_multistep replay', stream, cfg5['x0_seq'][1], 'tick by tick')}")

    # the f64 polish, called as a served tick calls it
    popts = cfg5["cold_opts"].replace(polish_iters=20)
    fp = sk.build_fused_plan(fleet, popts)
    with torch.no_grad():
        X0, U0, _, w = sk.solve_stagewise_fused(
            fleet, popts.replace(polish_iters=0), return_warm=True, plan=fp)
    w32, k32 = sk._pack_warm(fp, *w), sk._pack_work(fp, X0, U0)
    N, x, u, r = fleet.horizon, fleet.xdim, fleet.udim, fleet.nr_rows
    lines.append(route(
        "the f64 polish", lambda xt: polish(
            fp.polish, sk.fused_stagewise_tick, xt, w32, k32, n_iter=20,
            N=N, x=x, u=u, r=r, options=popts),
        fleet.x0.mT.contiguous(), (sk.fused_stagewise_tick,),
        "backend='xla'"))

    # the native engine on the golden SmallSystem: refused; under no_grad
    # it solves
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import fixtures as fx

    system = tt.LTISystem.create(fx.A, fx.B, fx.D, fx.SMALL_X0, fx.SMALL_N)
    costs = (tt.TargetCost.create(fx.M, fx.XD, weights=fx.WX),
             tt.ControlCost.create(fx.N_MAT, fx.UD, weights=fx.WU))
    cons = (tt.ControlBoundConstraint.create(fx.U_LOWER, fx.U_UPPER),)
    native = lambda x0: tt.solve(dataclasses.replace(system, x0=x0), costs,
                                 cons, engine="native").control
    refusal = _refuses("solve(engine='native')", native, system.x0,
                       "engine='condensed'")
    with torch.no_grad():
        u_native = native(system.x0.clone().requires_grad_())
    golden = float(np.abs(u_native.cpu().numpy()
                          - fx.GOLDEN_CONTROL).max())
    lines.append(f"solve(engine='native'): {refusal}; under no_grad it "
                 f"solves, {golden:.2e} from the golden control (2e-4)")
    if not golden <= 2e-4:
        fail(f"solve(engine='native') under no_grad: u[0] {golden:.3e} "
             f"from the golden control")
    for line in lines:
        print(f"gradients (d) {line} ({card})")
    return launches


def _fuzz_fleet(sqp, x0s):
    """``sqp`` repeated over ``len(x0s)`` lanes, lane ``b`` at ``x0s[b]``."""
    import dataclasses

    import torch
    from copra_tpu_torch._graph import tree_map

    lanes = len(x0s)
    sqp_b = tree_map(lambda a: a.expand((lanes,) + a.shape).contiguous(),
                     sqp)
    return dataclasses.replace(sqp_b, x0=torch.as_tensor(
        np.asarray(x0s)).to(sqp.x0))


def _fuzz_oracle(tt, plan, x0, U):
    """Relative distance of ``U`` from the native oracle of the plan's QP
    at ``x0``."""
    ref = tt.solve_qp_native(tt.plan_qp(plan, np.asarray(x0, np.float64)))
    if int(ref.status) != tt.STATUS_SOLVED:
        fail(f"fuzz: the oracle did not solve: {ref.inform()}")
    want = ref.x.numpy()
    got = U.detach().reshape(-1).cpu().numpy()
    scale = max(1.0, np.abs(want).max())
    return np.abs(got - want).max() / scale, scale


def _fuzz_step(system, x0, U):
    """x_1 of the closed loop: the first control applied to the dynamics
    (stage 0 of an LTV system)."""
    from _fuzz_draw import host

    A, B, d = (host(t) for t in (system.A, system.B, system.d))
    if A.ndim == 3:
        A, B, d = A[0], B[0], d[0]
    return A @ np.asarray(x0) + B @ host(U).reshape(-1)[:B.shape[1]] + d


def fuzz_phase(tt, sk, dev, reset_counts, card):
    """Phase 33: the two fuzz suites on the card, the reference's draws
    (``tests/_fuzz_draw.py``), seeds, ticks and gates: the 14 front-end
    draws through ``solve`` (and ``engine="stagewise"`` where the draw is
    per-stage expressible) against the native oracle; the plan step's
    receding ticks against the oracle and a fresh ``solve``; the stagewise
    step's warm ticks (K4) against the oracle; and on float32 draws
    ``make_stagewise_step(backend="fused")`` against ``backend="xla"``, 3
    ticks (5e-5).  Returns the tick kernels' launches by name."""
    import dataclasses

    import torch
    from copra_tpu_torch._graph import tree_map
    from copra_tpu_torch.qp.riccati import from_mpc, make_stagewise_step

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from _fuzz_draw import draw_problem

    entries = (sk.fused_stagewise_tick, sk.fused_stagewise_tick_streamed)
    launches = {}

    def count():
        for w in entries:
            launches[w.__name__] = launches.get(w.__name__, 0) + w.launches

    def dims(system, sqp):
        r = sqp.nr_rows if sqp is not None else "-"
        return f"(x, u, N, r) = ({system.xdim}, {system.udim}, " \
               f"{system.horizon}, {r})"

    t0 = time.perf_counter()
    reset_counts()
    worst = [0.0, 0.0]
    for seed in range(FUZZ_CASES):
        system, costs, cons, ok = draw_problem(tt, seed)
        qp = tt.build_qp(tt.condense(system), system.x0, costs, cons)
        ref = tt.solve_qp_native(qp)
        if int(ref.status) != tt.STATUS_SOLVED:
            fail(f"fuzz frontend seed {seed}: the oracle did not solve")
        want = ref.x.numpy()
        scale = max(1.0, np.abs(want).max())
        res = tt.solve(system, costs, cons)
        err = np.abs(res.control.cpu().numpy() - want).max() / scale
        replay = float(tt.replay_dynamics(system, res.trajectory,
                                          res.control))
        sqp = from_mpc(system, costs, cons) if ok else None
        line = (f"fuzz frontend seed {seed} {dims(system, sqp)}, m = "
                f"{qp.Aeq.shape[0] + qp.Aineq.shape[0]}: solve status "
                f"{int(res.solution.status)}, rel err {err:.2e} (gate 1e-5), "
                f"replay {replay:.1e}")
        if int(res.solution.status) != tt.STATUS_SOLVED or not err <= 1e-5 \
                or not replay <= 1e-8:
            fail(line)
        worst[0] = max(worst[0], err)
        if ok:
            res_sw = tt.solve(system, costs, cons, engine="stagewise")
            err_sw = np.abs(res_sw.control.cpu().numpy().reshape(-1)
                            - want).max() / scale
            line += f"; engine='stagewise' rel err {err_sw:.2e} (gate 1e-4)"
            if not err_sw <= 1e-4:
                fail(line)
            worst[1] = max(worst[1], err_sw)
        print(line)
    torch.cuda.synchronize()
    count()
    print(f"fuzz frontend: {FUZZ_CASES} draws on the card, worst solve "
          f"{worst[0]:.2e}, worst stagewise {worst[1]:.2e}; "
          f"{sum(launches.values())} tick-kernel launches (the stagewise "
          f"engine's early exit); {time.perf_counter() - t0:.1f} s ({card})")

    # the serving suite: plan-step receding ticks
    t0 = time.perf_counter()
    for seed in FUZZ_RECEDING_SEEDS:
        system, costs, cons, _ = draw_problem(tt, seed, eq_rows=False)
        plan = tt.make_control_plan(system, costs, cons)
        step = tt.make_plan_step(plan)
        x0, warm, errs = system.x0.cpu().numpy(), None, []
        for t in range(3):
            U, sol, warm = step(torch.tensor(x0, device=dev), warm)
            err_o, scale = _fuzz_oracle(tt, plan, x0, U)
            fresh = tt.solve(dataclasses.replace(
                system, x0=torch.tensor(x0, device=dev)), costs, cons)
            err_f = float((U - fresh.control).abs().max()) / scale
            errs.append((err_o, err_f))
            if int(sol.status) != tt.STATUS_SOLVED or not err_o <= 1e-5 \
                    or not err_f <= 2e-5:
                fail(f"fuzz receding seed {seed} tick {t}: status "
                     f"{int(sol.status)}, oracle {err_o:.2e}, fresh "
                     f"{err_f:.2e}")
            x0 = _fuzz_step(system, x0, U)
        print(f"fuzz receding seed {seed} {dims(system, None)}: 3 plan-step "
              f"ticks, worst oracle {max(e[0] for e in errs):.2e} (gate "
              f"1e-5), worst fresh solve {max(e[1] for e in errs):.2e} "
              f"(gate 2e-5)")

    # the stagewise step's warm ticks on the card (backend auto: K4)
    reset_counts()
    for seed in FUZZ_STAGEWISE_SEEDS:
        system, costs, cons, ok = draw_problem(tt, seed, eq_rows=False)
        if not ok:
            print(f"fuzz stagewise seed {seed}: stage-coupling draw, "
                  f"skipped as the reference skips it")
            continue
        rng = np.random.default_rng(100 + seed)
        xs = system.x0.cpu().numpy()[None] + 0.1 * rng.normal(
            size=(3, system.xdim))
        sqp = from_mpc(system, costs, cons)
        tick = tt.make_stagewise_step(_fuzz_fleet(sqp, xs))
        plan = tt.make_control_plan(system, costs, cons)
        warm, worst_err = None, 0.0
        for t in range(2):
            X, U, info, warm = tick(torch.tensor(xs, device=dev), warm)
            for lane in range(3):
                err, _ = _fuzz_oracle(tt, plan, xs[lane], U[lane])
                worst_err = max(worst_err, err)
            xs = np.stack([_fuzz_step(system, xs[lane], U[lane])
                           for lane in range(3)])
        print(f"fuzz stagewise seed {seed} {dims(system, sqp)}: 2 ticks of "
              f"3 lanes, backend {tick.backend}, worst oracle "
              f"{worst_err:.2e} (gate 1e-4)")
        if not worst_err <= 1e-4:
            fail(f"fuzz stagewise seed {seed}: {worst_err:.3e} from the "
                 f"oracle")
    torch.cuda.synchronize()
    stagewise_n = sum(w.launches for w in entries)
    count()
    if stagewise_n == 0:
        fail("fuzz stagewise: the ticks never launched the tick kernel")

    # the fused tick against the plain loop on float32 draws
    for seed in FUZZ_FUSED_SEEDS:
        system, costs, cons, ok = draw_problem(tt, seed, eq_rows=False)
        if not ok:
            print(f"fuzz fused seed {seed}: stage-coupling draw, skipped "
                  f"as the reference skips it")
            continue
        sqp = tree_map(lambda a: a.to(torch.float32),
                       from_mpc(system, costs, cons))
        rng = np.random.default_rng(200 + seed)
        x0s = system.x0.cpu().numpy().astype(np.float32)[None] + \
            np.float32(0.05) * rng.normal(size=(2, system.xdim)).astype(
                np.float32)
        fleet = _fuzz_fleet(sqp, x0s)
        opts = tt.SolverOptions(max_iter=25, early_exit=False)
        tick_x = make_stagewise_step(fleet, opts, backend="xla")
        tick_f = make_stagewise_step(fleet, opts, backend="fused")
        entry = _entry(sk, fleet)
        reset_counts()
        warm_x = warm_f = None
        diff = 0.0
        for k in range(3):
            x0k = torch.tensor(x0s + np.float32(0.01 * k), device=dev)
            Xx, Ux, _, warm_x = tick_x(x0k, warm_x)
            Xf, Uf, _, warm_f = tick_f(x0k, warm_f)
            diff = max(diff, float((Uf - Ux).abs().max()),
                       float((Xf - Xx).abs().max()))
        torch.cuda.synchronize()
        n = entry.launches
        count()
        print(f"fuzz fused seed {seed} {dims(system, sqp)}, f32, 2 lanes, "
              f"25 iterations: {entry.__name__} against backend='xla' over "
              f"3 ticks max |diff| {diff:.2e} (gate 5e-5), {n} launches")
        if n == 0 or not diff <= 5e-5:
            fail(f"fuzz fused seed {seed}: {n} launches, diff {diff:.3e}")
    print(f"fuzz serving: {time.perf_counter() - t0:.1f} s; tick-kernel "
          f"launches {launches} ({card})")
    return launches


# ---------------------------------------------------------------------------
# Phase 34: the reference's last behaviour suites on the kernel routes
# (tests/test_torch_stagewise_honesty.py, test_torch_model_swap.py,
# test_torch_stagewise_scaling.py, test_torch_behavior.py hold the plain
# routes against the reference on the CPU).
# ---------------------------------------------------------------------------

PARITY_RHOS = (0.01, 0.1, 1.0, 10.0)   # K7 at rows normalised, A.3
PARITY_SHIFTS = (0.002, 0.0)           # config 5's footstep replans, m
CANARY_N = 300


def _fixtures():
    """``tests/fixtures.py`` (numpy only): the reference's golden data."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import fixtures

    return fixtures


def _on_device(a, device):
    import torch

    return torch.tensor(np.asarray(a, np.float64), device=device)


def _box_terms(tt, fx, device, x0=None, horizon=None):
    """The SmallSystem (``x0``, ``horizon``: its own unless given) and its
    target and control costs, float64 on ``device``."""
    on = lambda a: _on_device(a, device)
    system = tt.LTISystem.create(
        on(fx.A), on(fx.B), on(fx.D), on(fx.SMALL_X0 if x0 is None else x0),
        fx.SMALL_N if horizon is None else horizon)
    costs = (tt.TargetCost.create(on(fx.M), on(fx.XD), weights=on(fx.WX)),
             tt.ControlCost.create(on(fx.N_MAT), on(fx.UD),
                                   weights=on(fx.WU)))
    return system, costs


def _box_lanes(tt, fx, x0s, device):
    """The SmallSystem box problem (``tests/test_stagewise_honesty.py``'s
    ``box_system`` with its control bounds) in stagewise form, one lane a
    row of ``x0s``, float64 on ``device``."""
    import dataclasses

    from copra_tpu_torch.qp.riccati import from_mpc, stack_stagewise

    system, costs = _box_terms(tt, fx, device)
    cons = (tt.ControlBoundConstraint.create(_on_device(fx.U_LOWER, device),
                                             _on_device(fx.U_UPPER, device)),)
    sqp = stack_stagewise([from_mpc(system, costs, cons)],
                          repeats=len(x0s))
    return dataclasses.replace(sqp, x0=_on_device(x0s, device))


def _against_plain(what, got, want, tol):
    """A kernel route's ``(X, U, info)`` against the plain route's on the
    CPU: equal statuses and iterations, X and U within ``tol`` x max(1,
    max |plain|).  Returns the relative distance."""
    import torch

    scale = max(1.0, max(float(w.abs().max()) for w in want[:2]))
    rel = max(float((g.cpu() - w).abs().max())
              for g, w in zip(got[:2], want[:2])) / scale
    same = (torch.equal(got[2].status.cpu(), want[2].status)
            and torch.equal(got[2].iterations.cpu(), want[2].iterations))
    if not (same and rel <= tol):
        fail(f"{what}: the kernel route differs from the plain route "
             f"(statuses {got[2].status.tolist()} / "
             f"{want[2].status.tolist()}, iterations "
             f"{got[2].iterations.tolist()} / {want[2].iterations.tolist()},"
             f" rel {rel:.3e})")
    return rel


def parity_honesty_case(tt, sk, fx, dev, reset_counts):
    """(a) early exit out of budget, (b) the worst lanes and (c) crossed
    bounds, on K4 (``tests/test_stagewise_honesty.py:243``, ``:309``,
    ``:67``).  Returns K4's launches."""
    import torch

    from copra_tpu_torch.qp.riccati import from_mpc

    x0s = np.stack([fx.SMALL_X0, [0.0, -50.0], fx.SMALL_X0])
    sqp = _box_lanes(tt, fx, x0s, dev)
    cpu = _on(sqp, "cpu")
    entry = _entry(sk, sqp)
    total = 0
    # (a) the early-exit route on K4 with a budget of 3 iterations
    opts = tt.SolverOptions(max_iter=3, seed="zero", eps_abs=1e-12,
                            eps_rel=0.0)
    reset_counts()
    got = tt.solve_stagewise(sqp, opts)
    torch.cuda.synchronize()
    n = entry.launches
    total += n
    rel = _against_plain("early exit out of budget", got,
                         tt.solve_stagewise(cpu, opts), F64_TOL)
    print(f"parity (a) K4 early exit, 3 lanes, budget 3: statuses "
          f"{got[2].status.tolist()}, iterations "
          f"{got[2].iterations.tolist()}, {n} {entry.__name__} launches; "
          f"rel to the plain loop {rel:.3e}")
    if n == 0 or bool((got[2].status == tt.STATUS_SOLVED).any()) or \
            not bool((got[2].iterations == 3).all()):
        fail("early exit out of budget: a lane claimed success, stopped "
             "short of the budget, or K4 never launched")
    # (b) fixed count on K4: lane 1 starts far away and starves
    lines = []
    for iters, starved in ((5, True), (800, False)):
        opts = tt.SolverOptions(max_iter=iters, seed="zero", eps_abs=1e-10,
                                eps_rel=0.0, early_exit=False)
        if not starved:
            opts = tt.SolverOptions(max_iter=iters, early_exit=False)
        reset_counts()
        got = sk.solve_stagewise_fused(sqp, opts)
        torch.cuda.synchronize()
        n = entry.launches
        total += n
        _against_plain(f"the fixed-count K4 solve ({iters} iterations)",
                       got, sk.solve_stagewise_fused(cpu, opts), F64_TOL)
        info = got[2]
        lanes, msg = info.failed_lanes(2), info.inform()
        lines.append(f"{iters} iterations: statuses "
                     f"{info.status.tolist()}, failed_lanes(2) {lanes}, "
                     f"{n} launches")
        if n == 0:
            fail("the worst-lanes case never launched K4")
        if starved and not (1 in lanes and "worst lanes" in msg
                            and f"lane {lanes[0]}" in msg):
            fail(f"the starved lane is not named: {lanes}, {msg!r}")
        if not starved and (lanes or "worst lanes" in msg):
            fail(f"a solved batch names failed lanes: {lanes}, {msg!r}")
    print("parity (b) K4 worst lanes: " + "; ".join(lines))
    # (c) crossed control bounds on float32 data, fixed count and early exit
    system, costs = _box_terms(tt, fx, dev)
    crossed = from_mpc(system, costs, (tt.ControlBoundConstraint.create(
        _on_device([5.0], dev), _on_device([-5.0], dev)),))
    crossed = _on(crossed, dev, torch.float32)
    lines = []
    for early_exit in (False, True):
        opts = tt.SolverOptions(max_iter=20, early_exit=early_exit)
        reset_counts()
        got = (tt.solve_stagewise(crossed, opts) if early_exit
               else sk.solve_stagewise_fused(crossed, opts))
        torch.cuda.synchronize()
        n = entry.launches
        total += n
        status = int(got[2].status)
        lines.append(f"early_exit={early_exit}: status {status}, {n} "
                     f"launches")
        if n == 0 or status != tt.STATUS_PRIMAL_INFEASIBLE:
            fail(f"crossed bounds on K4 (early_exit={early_exit}): status "
                 f"{status}, {n} launches")
    print("parity (c) K4 crossed bounds: " + "; ".join(lines))
    return total


def parity_replan_case(tt, sk, cfg5, reset_counts):
    """(d) ``replan`` under a CUDA graph (``tests/test_model_swap.py:114``,
    ``:140``): config 5's captured chain replans twice at equal shapes
    (the footstep plan moved, then back) with no new capture, the first
    tick after each swap converged on every lane; one served tick captured
    as a graph reads a replan's data (the facade refills its buffers)
    and equals a fresh facade's tick bit for bit; a changed shape raises
    ``DimensionError``.  Returns K4's launches."""
    import torch

    from copra_tpu_torch._graph import CapturedChain
    from copra_tpu_torch.qp.riccati import make_stagewise_step

    dev = cfg5["fleet"].A.device
    seq = _stack(cfg5["x0_seq"])
    T = seq.shape[0]
    kw = dict(cold_options=cfg5["cold_opts"], backend="fused")
    reset_counts()
    many = tt.make_stagewise_multistep(cfg5["fleet"], cfg5["opts"], **kw)
    entry = _entry(sk, cfg5["fleet"])
    _, _, _, _, warm = many(None, T, x0_seq=seq)
    chains = dict(many.chains)
    firsts = []
    for shift in PARITY_SHIFTS:
        many.replan(config5_fleet(tt, dev, shift))
        _, _, statuses, _, warm = many(None, T, warm=warm, x0_seq=seq)
        firsts.append(float((statuses[0] == 0).double().mean()))
    recaptured = many.chains != chains or len(chains) != 1
    # one tick as a graph, then a replan behind it
    tick = make_stagewise_step(cfg5["fleet"], cfg5["opts"], **kw)
    _, _, _, w0 = tick(seq[0])
    graph = CapturedChain(lambda x, *w: tick(x, w), (seq[1],) + tuple(w0),
                          "a config 5 tick", "backend='xla'")
    moved = config5_fleet(tt, dev, PARITY_SHIFTS[0])
    tick.replan(moved)
    got = graph(seq[1], *w0)
    torch.cuda.synchronize()
    n = entry.launches
    fresh = make_stagewise_step(moved, cfg5["opts"], **kw)
    want = fresh(seq[1], tuple(w0))
    same = all(torch.equal(g, w) for g, w in
               [(got[0], want[0]), (got[1], want[1]),
                (got[2].status, want[2].status)]
               + list(zip(got[3], want[3])))
    raised = []
    half = _on(cfg5["fleet"], dev, lanes=slice(0, seq.shape[1] // 2))
    for what, call in (("chain", lambda: many.replan(half)),
                       ("tick", lambda: tick.replan(half))):
        try:
            call()
        except tt.DimensionError:
            raised.append(what)
    print(f"parity (d) replan under a CUDA graph, config 5 ({T} ticks a "
          f"chain, {seq.shape[1]} lanes): footstep shifts "
          f"{list(PARITY_SHIFTS)} m, first tick after each swap converged "
          f"on {firsts} of the lanes, chains captured {len(chains)} -> "
          f"{len(many.chains)} (no new capture: {not recaptured}); a "
          f"captured tick after a replan equals a fresh facade bit for "
          f"bit: {same}; a changed shape raises DimensionError on "
          f"{raised}; {n} {entry.__name__} launches")
    if n == 0:
        fail("the replan case never launched K4")
    if recaptured or min(firsts) < 1.0 or not same or len(raised) != 2:
        fail("replan under a CUDA graph: see the line above")
    return n


def parity_scaling_case(tt, sk, dev, reset_counts):
    """(e) K5 with scaling (``tests/test_stagewise_scaling.py:66``): the
    quadruped at N = 16 in float64, 800 iterations, early exit, raw and
    equilibrated, each against the plain loop on the CPU.  Returns K5's
    launches."""
    import torch

    from copra_tpu_torch.convert import stagewise_from_numpy
    from copra_tpu_torch.qp.riccati import scale_stagewise, stagewise_scales

    sqp = stagewise_from_numpy({k: np.asarray(v, np.float64) for k, v in
                                srb_quadruped(N=16).items()}, device=dev)
    scaled = scale_stagewise(sqp, *stagewise_scales(sqp))
    opts = tt.SolverOptions(max_iter=800, early_exit=True, eps_abs=1e-8,
                            eps_rel=0.0)
    entry = _entry(sk, sqp)
    out, total = {}, 0
    for name, problem in (("raw", sqp), ("scaled", scaled)):
        reset_counts()
        got = tt.solve_stagewise(problem, opts)
        torch.cuda.synchronize()
        n = entry.launches
        total += n
        rel = _against_plain(f"the quadruped ({name})", got,
                             tt.solve_stagewise(_on(problem, "cpu"), opts),
                             F64_TOL)
        out[name] = (int(got[2].status), int(got[2].iterations), n, rel)
        if n == 0:
            fail(f"the quadruped ({name}) never launched {entry.__name__}")
    print(f"parity (e) {entry.__name__} with scaling, the quadruped at "
          f"N = 16, float64, 800 iterations at most: (status, iterations, "
          f"launches, rel to the plain loop) raw {out['raw']}, scaled "
          f"{out['scaled']}")
    if not (out["scaled"][0] == 0 and out["raw"][0] != 0
            and out["scaled"][1] < out["raw"][1]):
        fail("scaling does not fix the quadruped on the card")
    return total


def parity_canary_case(tt, fx, dev):
    """(f) the N = 300 canary (``tests/test_behavior.py:133``) through
    ``solve_mpc`` on the card: solved, replay <= 1e-10, the bounds held to
    1e-6, the terminal velocity on target, and the CPU port's controls
    within 1e-7."""
    import torch

    x0 = np.array([0.0, -5.0])
    opts = tt.SolverOptions(max_iter=8000, eps_abs=1e-7, eps_rel=0.0)
    out = []
    for device in (dev, torch.device("cpu")):
        on = lambda a: _on_device(a, device)
        system, costs = _box_terms(tt, fx, device, x0, CANARY_N)
        cons = [tt.TrajectoryBoundConstraint.create(on(fx.X_LOWER),
                                                    on(fx.X_UPPER)),
                tt.ControlBoundConstraint.create(on(fx.U_LOWER),
                                                 on(fx.U_UPPER))]
        t0 = time.perf_counter()
        res = tt.solve_mpc(system, costs, cons, opts)
        replay = float(tt.replay_dynamics(system, res.trajectory,
                                          res.control))
        out.append((res, replay, (time.perf_counter() - t0) * 1e3))
        if device.type == "cuda":
            torch.cuda.synchronize()
    (res, replay, ms), (cres, _, cms) = out
    X, U = res.trajectory.cpu().numpy(), res.control.cpu().numpy()
    vel = X[1::2]
    diff = float(np.abs(U - cres.control.numpy()).max())
    status = int(res.solution.status)
    print(f"parity (f) the N = {CANARY_N} canary through solve_mpc on "
          f"{res.control.device}: status {status}, "
          f"{int(res.solution.iterations)} iterations, {ms:.1f} ms (CPU "
          f"{cms:.1f} ms); replay {replay:.3e}, max velocity "
          f"{vel.max():.6f} (bound {fx.X_UPPER[1]}), max control "
          f"{U.max():.6f} (bound {fx.U_UPPER[0]}), terminal velocity "
          f"{vel[-1]:.6f} (target {fx.XD[1]}); the CPU port's controls "
          f"within {diff:.3e}")
    if not (res.control.is_cuda and status == tt.STATUS_SOLVED
            and replay <= 1e-10 and vel.max() <= fx.X_UPPER[1] + 1e-6
            and U.max() <= fx.U_UPPER[0] + 1e-6
            and abs(fx.XD[1] - vel[-1]) <= 1e-3 and X[0::2].max() <= 1e-6
            and diff <= 1e-7):
        fail("the N = 300 canary misses the reference's contract")


def k7_served_rho(tt, ak, dev, rho: float, batch: int = 0):
    """K7's inputs at a served rho: config 2 on per-lane dynamics (phase
    15's fleet) with rows normalised as ``solve_qp`` normalises them
    (``stack_constraints`` with ``row_normalize=True``), K's inverse from
    float64, and distinct non-zero warm starts.  Returns ``(kernel
    output, plain version in float64 on the same inputs, tolerance 2e-4 x
    max(1, max |plain|), the kernel call)``."""
    import torch

    from copra_tpu_torch.qp.admm import stack_constraints

    f32 = torch.float32
    system, costs, constraints, x0_seq = build_config2_ltv(
        tt, dev, np.float32, batch)
    opts = tt.SolverOptions(
        max_iter=C2_ITERS, early_exit=False, scaling=0, row_normalize=True,
        kkt_solve="inverse", kkt_refine=0, polish=False,
        infeasibility_detection=False, seed="zero", rho=rho)
    qp = tt.build_qp(tt.condense(system), torch.tensor(
        x0_seq[0].astype(np.float32), device=dev), costs, constraints)
    C, l, u, rho_r = (t.contiguous() for t in stack_constraints(qp, opts))
    B, m, n = C.shape
    K = (qp.Q.double() + opts.sigma * torch.eye(n, dtype=torch.float64,
                                                device=dev)
         + (C.mT.double() * rho_r.double()[:, None, :]) @ C.double())
    Kinv = torch.linalg.inv(K).to(f32).contiguous()
    rng = np.random.default_rng(34)
    vec = lambda k: torch.tensor(0.1 * rng.normal(size=(B, k)), dtype=f32,
                                 device=dev)
    x0v, y0v = vec(n), vec(m)
    z0v = torch.clamp(vec(m), l, u)
    args = (Kinv, C, qp.c.contiguous(), l, u, rho_r, x0v, y0v, z0v)
    sc = dict(n_iter=opts.max_iter, sigma=opts.sigma, alpha=opts.alpha)
    call = lambda: ak.fused_admm_general(*args, **sc)
    got = call()
    want = ak.admm_general_plain(*(a.double() for a in args), **sc)
    torch.cuda.synchronize()
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    return got, want, KERNEL_TOL * scale, call


def parity_k7_case(tt, ak, dev, card):
    """(g) K7 at the four rhos against its plain version in float64 on the
    same inputs.  Returns the largest distance."""
    worst, lines = 0.0, []
    for rho in PARITY_RHOS:
        got, want, tol, call = k7_served_rho(tt, ak, dev, rho)
        err = _max_diff(got, want)
        worst = max(worst, err)
        lines.append(f"rho {rho:g}: {err:.3e} (tol {tol:.3e}), "
                     f"{_graph_ms(call, 10):.4f} ms by graph replay")
        if not err <= tol:
            fail(f"fused_admm_general at rho {rho:g} (rows normalised) "
                 f"misses its float64 plain version: {err:.3e} > {tol:.3e}")
    print(f"parity (g) fused_admm_general on config 2's per-lane fleet "
          f"({FLEET} lanes, {C2_ITERS} iterations, rows normalised) "
          f"against its plain version in float64 ({card}): "
          + "; ".join(lines))
    return worst


def parity_phase(tt, ak, sk, dev, cfg5, reset_counts, card):
    """Phase 34.  Returns the launches of each entry point on its served
    route (K7's launches against its plain version are not counted) and
    K7's largest distance."""
    t0 = time.perf_counter()
    fx = _fixtures()
    k4 = parity_honesty_case(tt, sk, fx, dev, reset_counts)
    k4 += parity_replan_case(tt, sk, cfg5, reset_counts)
    k5 = parity_scaling_case(tt, sk, dev, reset_counts)
    parity_canary_case(tt, fx, dev)
    k7_err = parity_k7_case(tt, ak, dev, card)
    print(f"phase 34: {time.perf_counter() - t0:.1f} s")
    return {"fused_stagewise_tick": k4,
            "fused_stagewise_tick_streamed": k5}, k7_err


# ---------------------------------------------------------------------------
# The benchmark entry points (phase 35).
# ---------------------------------------------------------------------------

# bench_all_torch.py's lines per config (BENCHALL.json's count) and the
# kernel each gated line's route launches: None for a line with no kernel
# (none may launch), "" for a line that is not checked for launches
BENCHALL_ROUTES = {
    1: ("fused_admm_box_shared", "", "fused_stagewise_tick"),
    2: ("fused_admm_general_shared", "", "fused_stagewise_tick"),
    3: ("fused_admm_box_lanes", None),
    5: ("",) + ("fused_stagewise_tick",) * 11,
    6: ("", "fused_stagewise_tick_streamed", "fused_stagewise_tick_streamed",
        None),
    8: ("",) * 4}
BENCH_TIMEOUT_S = 900


def _bench_script(script: str) -> tuple:
    """``python3 script`` at its default sizes as a child process, its
    artifact under ``smoke_out/``: ``(its JSON lines, seconds)``; a
    non-zero exit fails."""
    env = dict(os.environ,
               BENCHALL_OUT=os.path.join("smoke_out", "BENCHALL_torch.json"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-u", script], env=env,
                          capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{script} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")], secs


def _launched(what: str, launches: dict, entry) -> None:
    """``entry`` None: no kernel of ``launches``; else ``entry`` launched."""
    if entry is None and launches:
        fail(f"{what}: a route with no kernel launched {launches}")
    if entry and not launches.get(entry, 0) > 0:
        fail(f"{what}: {entry} was never launched ({launches})")


def bench_phase(kernels: dict) -> None:
    """Phase 35: ``bench_torch.py`` (the accurate mode with its chained,
    roofline and fast points) and ``bench_all_torch.py`` (configs 1, 2, 3,
    5, 6 and 8) run as child processes, each line held to its contract
    (1e-5 absolute for the condensed lines and the chained and roofline
    points, 1e-4 relative for configs 5 and 6 and config 3's direct LQR
    tick, an f32 sweep) and to the launches its route implies (each line
    counts its own, ``ops.counts``); the launches are added to
    ``kernels``."""
    os.makedirs("smoke_out", exist_ok=True)
    lines, secs = _bench_script("bench_torch.py")
    if len(lines) != 1:
        fail(f"bench_torch.py printed {len(lines)} JSON lines, not 1")
    out, roof = lines[0], lines[0]["roofline_point"]
    errs = (out["max_err_vs_exact"], out["chained_max_err_vs_exact"],
            roof["max_err_vs_exact"])
    print(f"bench_torch.py ({out['device_kind']}, {out['power_limit']}): "
          f"{out['value']} solves/s, measured device "
          f"{out['measured_device_ms_per_tick']} ms a tick, dispatch share "
          f"{out['measured_dispatch_share']}, max_err_vs_exact {errs[0]}; "
          f"chained {out['chained_solves_per_s']} solves/s at {errs[1]}; "
          f"roofline {roof['solves_per_s']} solves/s at {errs[2]}; fast "
          f"{out['fast_solves_per_s']} solves/s at {out['fast_max_err']}; "
          f"launches {out['launches']}, chained {out['chained_launches']}, "
          f"roofline {roof['launches']}, fast {out['fast_launches']}; "
          f"{secs:.1f} s")
    if not max(errs) <= ORACLE_TOL:
        fail(f"bench_torch.py: a gate above {ORACLE_TOL}: {errs}")
    for what, got, entry in (
            ("bench_torch.py", out["launches"], "fused_admm_box_lanes"),
            ("its chained point", out["chained_launches"],
             "fused_admm_box_lanes"),
            ("its roofline point", roof["launches"], "fused_admm_box_shared"),
            ("its fast point", out["fast_launches"], "fused_admm_box")):
        _launched(what, got, entry)
    counted = [out["launches"], out["chained_launches"], roof["launches"],
               out["fast_launches"]]

    lines, secs = _bench_script("bench_all_torch.py")
    for config, routes in BENCHALL_ROUTES.items():
        got = [line for line in lines if line["config"] == config]
        if len(got) != len(routes):
            fail(f"bench_all_torch.py config {config}: {len(got)} lines, "
                 f"not {len(routes)}")
        for k, (line, entry) in enumerate(zip(got, routes)):
            what = f"bench_all_torch.py config {config} line {k + 1}"
            _launched(what, line["launches"], entry)
            counted.append(line["launches"])
            if "max_err_vs_exact" not in line:
                continue
            rel = config in (5, 6) or "max_err_rel" in line
            err = line["max_err_rel"] if rel else line["max_err_vs_exact"]
            tol = REL_TOL if rel else ORACLE_TOL
            if not err <= tol:
                fail(f"{what} ({line['metric']}): "
                     f"{'max_err_rel' if rel else 'max_err_vs_exact'} "
                     f"{err} > {tol}")
        last = got[-1]
        print(f"bench_all_torch.py config {config} "
              f"({last['device_kind']}, {last['power_limit']}), "
              f"{last['seconds']} s: " + "; ".join(
                  f"{line['metric'][:48]}... "
                  + ", ".join(f"{key} {line[key]}" for key in (
                      "value", "max_err_vs_exact", "max_err_rel",
                      "budget_feasible_in_env", "within_wall_budget",
                      "within_device_budget") if key in line)
                  for line in got))
    print(f"bench_all_torch.py: {len(lines)} lines in {secs:.1f} s")
    for launches in counted:
        for entry, n in launches.items():
            kernels[entry]["launches"] += n


# ---------------------------------------------------------------------------
# The weak-scaling harness (phase 36).
# ---------------------------------------------------------------------------

SCALING_SIZES = (1, 2, 4, 8, 16, 32)
# the CPU run's cuts (the script's defaults: 8 processes, 3 steps a window)
SCALING_CPU_PROCESSES = 2
SCALING_CPU_STEPS = 1


def _scaling_run(device: str, env_extra: dict) -> tuple:
    """``bench_scaling_torch.py`` on ``device`` as a child process, its
    record under ``smoke_out/``: ``(its JSON lines, seconds)``; a non-zero
    exit fails."""
    env = dict(os.environ, **env_extra, SCALING_OUT=os.path.join(
        "smoke_out", f"SCALING_{device}.json"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-u", "bench_scaling_torch.py"]
        + ([] if device == "cuda" else ["--device", "cpu"]), env=env,
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"bench_scaling_torch.py ({device}) exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    return [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")], secs


def scaling_phase(kernels: dict) -> None:
    """Phase 36: ``bench_scaling_torch.py`` on the visible cards without
    its controls, then on the CPU at 1 and 2 processes; each run's lines
    held (see the module's docstring) and their launches, none expected,
    added to ``kernels``."""
    import torch

    os.makedirs("smoke_out", exist_ok=True)
    runs = (("cuda", [k for k in SCALING_SIZES
                      if k <= torch.cuda.device_count()],
             dict(BENCH_SKIP_CONTENTION="1")),
            ("cpu", [k for k in SCALING_SIZES
                     if k <= SCALING_CPU_PROCESSES],
             dict(BENCH_CPU_PROCESSES=str(SCALING_CPU_PROCESSES),
                  BENCH_STEPS=str(SCALING_CPU_STEPS))))
    for device, sizes, env in runs:
        lines, secs = _scaling_run(device, env)
        what = f"bench_scaling_torch.py ({device})"

        def having(key):
            return [line for line in lines if key in line]

        mesh = having("devices")
        if [line["devices"] for line in mesh] != sizes:
            fail(f"{what}: mesh lines at {[x['devices'] for x in mesh]}, "
                 f"not {sizes}")
        for line in mesh:
            if not (line["solves_per_s"] > 0
                    and line["max_abs_vs_unsharded"] == 0):
                fail(f"{what}: {line}")
            if device == "cuda" and not (line["device_kind"]
                                         and line["power_limit"]):
                fail(f"{what}: no card name or power limit: {line}")
        weak = having("min_efficiency")
        if len(weak) != 1 or weak[0]["efficiency"]["1"] != 1.0:
            fail(f"{what}: weak-scaling summary {weak}")
        if device == "cpu":
            for key, want in (("contention_control_processes", sizes),
                              ("independent_devices_in_one_process", sizes),
                              ("multiprocess_cluster_processes", sizes[1:])):
                got = [line[key] for line in having(key)]
                if got != want:
                    fail(f"{what}: {key} lines at {got}, not {want}")
            for key in ("single_process_runtime_efficiency",
                        "min_efficiency_vs_contention_ceiling",
                        "min_efficiency_vs_lockstep_ceiling"):
                if len(having(key)) != 1:
                    fail(f"{what}: no summary with {key}")
        for line in having("launches"):
            _launched(f"{what} {line}", line["launches"], None)
            for entry, n in line["launches"].items():
                kernels[entry]["launches"] += n
        print(f"{what} ({mesh[0]['device_kind']}, {mesh[0]['power_limit']}, "
              f"{mesh[0]['threads_per_process']} torch threads a process, "
              f"{mesh[0]['backend']}): solves/s "
              + ", ".join(f"{x['devices']}: {x['solves_per_s']}"
                          for x in mesh)
              + f"; weak-scaling efficiency {weak[0]['efficiency']}; "
              f"max_abs_vs_unsharded 0; f32 max_err_vs_exact (ungated) "
              f"{max(x['max_err_vs_exact'] for x in mesh):.3e}; "
              f"{secs:.1f} s")
        for line in lines:
            if "metric" in line:
                print(f"  {json.dumps(line)}")


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

    # phase 5: the stagewise kernel against its plain version, and the
    # body the shape's rule names taking every launch
    from copra_tpu_torch import profiling
    probe = {}
    for cfg in configs:
        sqp5 = cfg["fleet"]
        shape5 = (sqp5.xdim, sqp5.udim, sqp5.nr_rows)
        before = [profiling.counters().get(n, 0) for n in sk.LAUNCH_COUNTERS]
        (entry, e32, b32, e64, ms, plain_ms, ms64, bnd, chain,
         repack_ms, skip_ms) = stagewise_vs_plain(sk, cfg)
        moved = [profiling.counters().get(n, 0) - b
                 for n, b in zip(sk.LAUNCH_COUNTERS, before)]
        named = 0 if sk.warp_body(*shape5) else 1
        print(f"kernel {entry} ({cfg['name']}, (x, u, r) = {shape5}): "
              f"launches by body {dict(zip(sk.LAUNCH_COUNTERS, moved))}, "
              f"the rule names the {('warp', 'block')[named]} body")
        if moved[named] == 0 or moved[1 - named] != 0:
            fail(f"{cfg['name']}: launches {moved} not all on the "
                 f"{('warp', 'block')[named]} body")
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
    n = chained_plan_phase(
        tt, ak, plan, opts, step, x0_dev, reset_counts,
        modes["x0_zero"][2] * ROUNDS + modes["qx"][2])
    k1["launches"] += n
    # phase 21: configs 6 and 5 chained, in x0_seq and plant modes
    for cfg in configs:
        fp = cfg["tick"]._plans[cfg["tick"]._plan_key(cfg["opts"])]
        entry = ("fused_stagewise_tick" if fp.mode == "resident"
                 else "fused_stagewise_tick_streamed")
        kernels[entry]["launches"] += chained_stagewise_phase(
            tt, sk, cfg, reset_counts, probe[entry][1])
    # phase 22: the log-depth forms against their serial forms
    lq5 = assoc_phase(tt, dev, build_fleet(BATCH, HORIZON)[0], configs[1])
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
    # phases 27-30: the closed loop, checkpoints, traces and the examples
    loop = closed_loop_phase(tt, dev)
    for entry, n in checkpoint_phase(tt, sk, loop, configs[1],
                                     reset_counts).items():
        kernels[entry]["launches"] += n
    metrics_phase(loop)
    for entry, n in examples_phase(tt, sk, reset_counts).items():
        kernels[entry]["launches"] += n
    # phase 31: the parallel layer, NCCL at world 1
    card = smi[0] if smi else name
    parallel_phase(tt, dev, card, lq5)
    # phase 32: gradients on the card; the kernel routes refuse one
    t_phase = time.perf_counter()
    x0s4 = build_fleet(BATCH, HORIZON)[1]
    k1["launches"] += grad_plan_case(tt, ak, plan, opts, step, x0s4, x0_dev,
                                     reset_counts, card)
    grad_tuning_case(tt, dev, card)
    kernels["fused_stagewise_tick"]["launches"] += grad_stagewise_case(
        tt, sk, configs[1], reset_counts, card)
    for entry, n in grad_routes_case(tt, ak, ck, sk, plan, opts, step, x0s4,
                                     x0_dev, cfgs, configs, reset_counts,
                                     card).items():
        kernels[entry]["launches"] += n
    print(f"phase 32: {time.perf_counter() - t_phase:.1f} s")
    # phase 33: the fuzz suites on the card
    t_phase = time.perf_counter()
    for entry, n in fuzz_phase(tt, sk, dev, reset_counts, card).items():
        kernels[entry]["launches"] += n
    print(f"phase 33: {time.perf_counter() - t_phase:.1f} s")
    # phase 34: the reference's last behaviour suites on the kernel routes
    launches, k7_err = parity_phase(tt, ak, sk, dev, configs[1],
                                    reset_counts, card)
    for entry, n in launches.items():
        kernels[entry]["launches"] += n
    # phase 35: the benchmark entry points, as child processes
    t_phase = time.perf_counter()
    bench_phase(kernels)
    print(f"phase 35: {time.perf_counter() - t_phase:.1f} s")
    # phase 36: the weak-scaling harness, as child processes
    t_phase = time.perf_counter()
    scaling_phase(kernels)
    print(f"phase 36: {time.perf_counter() - t_phase:.1f} s")
    k7 = kernels["fused_admm_general"]
    k7["max_abs_err"] = max(k7["max_abs_err"], k7_err)
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
