#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port (``copra_tpu_torch``) on one
GPU: batched warm-started LTV MPC solves/s.

The port's counterpart of ``bench.py``, with its command line, fleet and
JSON fields: BASELINE config 4 (B = 4096 randomized LTV point-mass lanes,
N = 100, 30 ADMM iterations, a binding +-60 control bound, 20 timed ticks
of drifting x0 after 2 warm-up ticks), one JSON line on stdout.

``BENCH_MODE`` picks the route:

- ``accurate`` (default): per-lane plans, ``auto_rho(accurate=True)`` and
  ``make_plan_step(accurate=True)`` (the f64 seed map, K1's x0 = 0 body
  and its Q x pass, the f64 combine).  Three more points ride its line:
  ``chained_*`` (the same ticks through ``make_plan_multistep``, one CUDA
  graph a call), ``roofline_point`` (``bench.py:run_roofline``'s shared
  N = 256 plan on K3) and ``fast_*`` (a child process in ``plan`` mode);
- ``plan``: the f32 fused tick (``use_fused=None``, K1's general body);
- ``plan_xla``: the plain f32 step (``use_fused=False``), no kernel;
- ``fused``: per tick ``condense`` -> ``build_qp`` ->
  ``solve_qp_batched_fused`` (K2);
- anything else: ``parallel.solve_mpc_batch``, no kernel.

Every line is gated: lanes 0, 1, 17 and B - 1 of the last timed tick
against the native f64 active-set oracle of the same QPs
(``max_err_vs_exact``).  ``mfu`` and ``hbm_util`` are against one H100's
67 TFLOP/s f32 (outside the tensor cores) and 3.35 TB/s; the
``measured_*`` fields come from a ``torch.profiler`` trace of 4 more ticks
(``copra_tpu_torch.profiling.trace_device_time``: the interval union of
the device's events), ``measured_kernel_*`` from the per-lane kernel's own
records in it.  ``device_kind`` is the card's name and ``power_limit``
its ``nvidia-smi`` power limit.  ``launches`` counts each kernel
wrapper's launches over the line's own ticks (``copra_tpu_torch.ops.
counts``).

Environment: ``BENCH_MODE``, ``BENCH_BATCH``, ``BENCH_HORIZON``,
``BENCH_ITERS``, ``BENCH_STEPS``, ``BENCH_BOUND``, ``BENCH_RHO`` (skips
``auto_rho``), ``BENCH_REFINE``, ``BENCH_ROUNDS``, ``BENCH_PROFILE=0``,
``BENCH_CHAINED=0``, ``BENCH_ROOFLINE=0``, ``BENCH_CHILD`` (no extra
points).  It runs on the GPU and exits non-zero without one; ``--device
cpu`` runs it on the CPU (the tests' switch), where no ``measured_*``
field is produced.  A failed gate computation, chained, roofline or fast
point raises, and the script exits non-zero.

    python3 bench_torch.py
    BENCH_MODE=plan python3 bench_torch.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
import copra_tpu_torch as tt
from copra_tpu_torch.ops import counts
from copra_tpu_torch.profiling import synchronize, trace_device_time

BASELINE_SOLVES_PER_S = 10_000.0
# one H100 SXM (chip_smoke.py's bound): f32 outside the tensor cores, HBM3
PEAK_TFLOPS, PEAK_GBPS = cs.F32_PEAK / 1e12, cs.HBM_RATE / 1e9
# the kernels' names as the profiler prints them: the per-lane box kernel's
# iteration bodies (K1, K2) and the shared box kernel's (K3)
LANES_BODIES = ("box_register_kernel", "box_streamed_kernel")
SHARED_BODIES = ("box_small_kernel", "box_tile_kernel")
GATE_LANES = (0, 1, 17)


def parse_device(argv):
    """The device ``argv`` asks for: ``--device cpu`` runs on the CPU, the
    default is the GPU.  Without a CUDA device and without the switch it
    raises ``SystemExit`` naming CUDA."""
    name = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{os.path.basename(argv[0] or 'bench')}: no CUDA "
                         f"device; this benchmark runs on a GPU "
                         f"(--device cpu runs it on the CPU)")
    return dev


def card(device, count: int = 1) -> dict:
    """``device_kind`` (the card's name) and ``power_limit`` (``nvidia-smi
    --query-gpu=name,power.limit``'s second field) of ``device``, or with
    ``count`` > 1 of the first ``count`` cards (each value once, joined by
    ", " where the cards differ); on the CPU ``"cpu"`` and None."""
    if device.type != "cuda":
        return {"device_kind": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    names = dict.fromkeys(torch.cuda.get_device_name(d)
                          for d in ([device] if count == 1 else range(count)))
    limits = dict.fromkeys(ln.split(",")[-1].strip() for ln in out[:count])
    return {"device_kind": ", ".join(names), "power_limit": ", ".join(limits)}


def lanes_of(batch: int, extra=()) -> tuple:
    """The gate's lanes: 0, 1, 17 and B - 1 (and ``extra``), those inside
    the fleet."""
    return tuple(sorted({lane for lane in (*GATE_LANES, batch - 1, *extra)
                         if 0 <= lane < batch}))


def launch_counts() -> dict:
    """Each counted kernel wrapper's launches since the last reset, those
    above 0."""
    return {fn.__name__: fn.launches for fn in counts.COUNTED
            if fn.launches > 0}


def profile_device(run_once, device, n: int = 4):
    """``n`` calls of ``run_once`` under ``torch.profiler``: ``(device busy
    s a call, [(op, s a call), ...] longest first)`` from the exported
    Chrome trace (``profiling.trace_device_time``, the interval union per
    stream); None on the CPU.  A trace without device time on the card
    raises."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="benchprof_") as tdir:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run_once()
            torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(tdir, "trace.json"))
        parsed = trace_device_time(tdir)
    if parsed is None:
        raise RuntimeError("the profiler's trace holds no device time")
    busy, top = parsed
    return busy / n, [(name, s / n) for name, s in top]


def flops_per_solve(n: int, iters: int, rounds: int) -> int:
    """``bench.py``'s analytic operations of one accurate solve of width
    ``n``: per round ``iters + 1`` products with an [n, n] operator and ~10
    n a iteration, a product between rounds, 8 n for the seed and
    combine."""
    return rounds * ((iters + 1) * 2 * n * n + iters * 10 * n) \
        + (rounds - 1) * 2 * n * n + 8 * n


def fleet_terms(bound: float, dtype=None):
    """``bench.py``'s costs and a +-``bound`` control bound, their arrays of
    ``dtype`` (None: Python floats, as ``chip_smoke.build_serving``'s)."""
    f = (lambda a: a) if dtype is None else (lambda a: np.asarray(a, dtype))
    costs = (tt.TargetCost.create(f(np.eye(2)), f([0.0, -1.0]),
                                  weights=f([10.0, 1e4])),
             tt.ControlCost.create(f([[1.0]]), f([2.0]), weights=f([1e-4])))
    return costs, (tt.ControlBoundConstraint.create(f([-bound]),
                                                    f([bound])),)


def run_roofline(device, batch: int = cs.FLEET,
                 horizon: int = cs.ROOF_N, iters: int = cs.ROOF_ITERS,
                 steps: int = cs.ROOF_TICKS, rounds: int = cs.ROOF_ROUNDS,
                 profile: bool = True) -> dict:
    """``bench.py:run_roofline`` on the port: one LTI N = 256 plan for B =
    4096 states (``chip_smoke.build_roofline``), the accurate tick at 2
    rounds x 30 iterations on the shared box kernel (K3's tile body), 2 +
    ``steps`` ticks, gated on lanes 0, 1, 17, B - 1."""
    cfg = cs.build_roofline(tt, device, batch, horizon, iters=iters,
                            rounds=rounds, ticks=steps)
    counts.reset()
    plan, opts, step, x0_seq = cfg["plan"], cfg["opts"], cfg["step"], \
        cfg["x0_seq"]
    u, _, warm = step(plan, x0_seq[0], None)
    u, _, warm = step(plan, x0_seq[1], warm)
    synchronize(device)
    t0 = time.perf_counter()
    for t in range(steps):
        u, _, warm = step(plan, x0_seq[2 + t], warm)
    synchronize(device)
    elapsed = time.perf_counter() - t0
    launches = launch_counts()
    sps = batch * steps / elapsed
    n = horizon
    flops = flops_per_solve(n, iters, rounds)
    res = {
        "metric": f"shared-plan fleet roofline point (B={batch}, N={n}, "
                  f"{rounds}x{iters} iters, accurate path, shared kernel)",
        "solves_per_s": round(sps, 1),
        "bound": round(cfg["bound"], 2),
        "rho": float(f"{opts.rho:.4g}"),
        "flops_per_solve": flops,
        "roofline": "H100 f32 peak outside the tensor cores (TF32 off)",
        "peak_tflops_f32_highest": PEAK_TFLOPS,
        "mfu_wall": round(sps * flops / (PEAK_TFLOPS * 1e12), 4),
    }
    if profile:
        state = {"warm": warm, "t": 0}

        def tick_more():
            # u2, not u: the gate below holds u at x0_seq[steps + 1]
            u2, _, state["warm"] = step(
                plan, x0_seq[2 + state["t"] % steps], state["warm"])
            state["t"] += 1
            return u2

        got = profile_device(tick_more, device)
        if got is not None:
            dev_s, top = got
            res["measured_device_ms_per_tick"] = round(dev_s * 1e3, 3)
            res["measured_mfu"] = round(
                batch * flops / dev_s / (PEAK_TFLOPS * 1e12), 4)
            kern_s = sum(s for name, s in top
                         if any(b in name for b in SHARED_BODIES))
            if kern_s > 0:
                kflops = rounds * (iters + 1) * 2 * batch * n * n
                res["measured_kernel_mfu"] = round(
                    kflops / kern_s / (PEAK_TFLOPS * 1e12), 4)
                res["measured_kernel_ms_per_tick"] = round(kern_s * 1e3, 3)
            res["device_top_ops_ms"] = [[name[:60], round(s * 1e3, 3)]
                                        for name, s in top]
    err = cs.gate_vs_oracle(tt, plan, u, x0_seq[steps + 1].cpu().numpy(),
                            lanes_of(batch))
    res["max_err_vs_exact"] = float(f"{err:.3g}")
    res["launches"] = launches
    return res


def build_step(mode, device, system, costs, constraints, x0s, opts,
               rho, rounds):
    """``(plan or None, opts, step(x0, warm) -> (u, warm))`` of ``mode``,
    as ``bench.py:main`` builds it."""
    if mode in ("accurate", "plan", "plan_xla"):
        plan = tt.make_control_plan(system, costs, constraints)
        kw = (dict(accurate=True, accurate_rounds=rounds)
              if mode == "accurate" else {})
        if rho is None:
            # the measured policy: probe the serving step at gm-relative
            # candidates on sampled lanes against the native oracle
            opts = opts.replace(rho=tt.auto_rho(plan, x0s, opts,
                                                seed_center=x0s, **kw))
        if mode != "accurate":
            kw = dict(use_fused=None if mode == "plan" else False)
        plan_step = tt.make_plan_step(plan, opts, batched=True,
                                      seed_center=x0s, **kw)

        def step(x0, warm):
            u, _, nxt = plan_step(plan, x0, warm)
            return u, nxt
        return plan, opts, step
    if mode == "fused":
        from copra_tpu_torch.ops.admm_kernel import solve_qp_batched_fused

        def step(x0, warm):
            sys_t = system.with_x0(x0)
            qp = tt.build_qp(tt.condense(sys_t), sys_t.x0, costs,
                             constraints)
            sol = solve_qp_batched_fused(qp, opts, warm)
            return sol.x, tt.WarmStart(x=sol.x, y=sol.y, z=sol.z)
        return None, opts, step

    def step(x0, warm):
        res = tt.solve_mpc_batch(system.with_x0(x0), costs, constraints,
                                 opts, warm_start=warm)
        sol = res.solution
        return res.control, tt.WarmStart(x=sol.x, y=sol.y, z=sol.z)
    return None, opts, step


def run(mode: str = "accurate", device=None, batch: int = 4096,
        horizon: int = 100, iters: int = 30, steps: int = 20,
        bound: float = 60.0, rho=None, refine: int = 0, rounds: int = 1,
        profile: bool = True, chained: bool = True, roofline: bool = True,
        child: bool = False, roofline_sizes=None) -> dict:
    """One ``bench.py`` line of ``mode`` on ``device``; ``rho=None`` runs
    the measured policy (``auto_rho``) in the plan modes and 1.0
    elsewhere, as ``BENCH_RHO`` unset does.  ``roofline_sizes`` are
    :func:`run_roofline`'s keyword arguments (the reference's defaults
    when None)."""
    device = torch.device(device or "cuda")
    t_start = time.perf_counter()
    arrays, x0s, x0_np = cs.build_fleet(batch, horizon, ticks=steps)
    system = tt.LTVSystem(*(torch.tensor(a, device=device) for a in arrays))
    # the accurate path builds its f64 seed map; every other mode is the
    # reference's run without x64, all in float32
    costs, constraints = fleet_terms(
        bound, None if mode == "accurate" else np.float32)
    opts = tt.SolverOptions(max_iter=iters, early_exit=False, polish=False,
                            rho=1.0 if rho is None else float(rho),
                            kkt_refine=refine)
    rounds = rounds if mode == "accurate" else 1
    plan, opts, step = build_step(mode, device, system, costs,
                                  constraints, x0s, opts, rho, rounds)
    x0_seq = [torch.tensor(x, device=device) for x in x0_np]

    counts.reset()
    u, warm = step(x0_seq[0], None)
    u, warm = step(x0_seq[1], warm)
    synchronize(device)
    t0 = time.perf_counter()
    for t in range(steps):
        u, warm = step(x0_seq[2 + t], warm)
    synchronize(device)
    elapsed = time.perf_counter() - t0
    launches = launch_counts()
    solves_per_s = batch * steps / elapsed

    # the gate: the plan's QPs (the plan data is the problem, its linear
    # term built in f64 from the f32 data) solved by the native oracle
    if plan is None:
        plan = tt.make_control_plan(system, costs, constraints)
    gate = cs.gate_vs_oracle(tt, plan, u, x0_np[steps + 1],
                             lanes_of(batch))

    n = horizon
    flops = flops_per_solve(n, iters, rounds)
    bytes_per_solve = 2 * n * n * 4 + 10 * n * 4
    gflops = solves_per_s * flops / 1e9
    out = {
        "metric": f"batched warm-started LTV MPC solves/s, {mode} path "
                  f"(B={batch}, N={horizon}, {iters} ADMM iters)",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / BASELINE_SOLVES_PER_S, 3),
        "mfu": round(gflops / (PEAK_TFLOPS * 1e3), 5),
        "hbm_util": round(solves_per_s * bytes_per_solve / 1e9 / PEAK_GBPS,
                          5),
        "gflops_per_s": round(gflops, 1),
        **card(device),
        "max_err_vs_exact": float(f"{gate:.3g}"),
        "launches": launches,
    }

    if profile:
        state = {"warm": warm, "t": 0}

        def tick_more():
            u2, state["warm"] = step(x0_seq[2 + state["t"] % steps],
                                     state["warm"])
            state["t"] += 1
            return u2

        got = profile_device(tick_more, device)
        if got is not None:
            dev_s, top = got
            wall_s = elapsed / steps
            out["measured_device_ms_per_tick"] = round(dev_s * 1e3, 3)
            out["measured_mfu"] = round(
                batch * flops / dev_s / (PEAK_TFLOPS * 1e12), 5)
            out["measured_hbm_util"] = round(
                batch * bytes_per_solve / dev_s / (PEAK_GBPS * 1e9), 5)
            out["measured_dispatch_share"] = round(
                max(0.0, 1.0 - dev_s / wall_s), 4)
            out["device_top_ops_ms"] = [[name[:60], round(s * 1e3, 3)]
                                        for name, s in top]
            # the iteration kernel's own time against its products
            kern = sorted((s for name, s in top
                           if any(b in name for b in LANES_BODIES)),
                          reverse=True)
            if kern:
                kflops = rounds * (iters + 1) * 2 * batch * n * n
                out["measured_kernel_mfu"] = round(
                    kflops / kern[0] / (PEAK_TFLOPS * 1e12), 4)
                out["measured_kernel_ms_per_tick"] = round(kern[0] * 1e3, 3)

    if mode == "accurate" and not child and chained:
        # the same stream of states through make_plan_multistep: one CUDA
        # graph a call on the card (captured on the first), gated on the
        # last chained tick
        counts.reset()
        step_many = tt.make_plan_multistep(plan, opts, seed_center=x0s,
                                           accurate_rounds=rounds)
        x0_chain = torch.stack(x0_seq[2:2 + steps])
        usc, stc, _, warmc = step_many(x0_chain)
        usc, stc, _, warmc = step_many(x0_chain, warmc)
        synchronize(device)
        t0 = time.perf_counter()
        usc, stc, _, warmc = step_many(x0_chain, warmc)
        synchronize(device)
        out["chained_solves_per_s"] = round(
            batch * steps / (time.perf_counter() - t0), 1)
        out["chained_converged_frac"] = float(
            (stc == 0).double().mean())
        err = cs.gate_vs_oracle(tt, plan, usc[-1], x0_np[steps + 1],
                                lanes_of(batch))
        out["chained_max_err_vs_exact"] = float(f"{err:.3g}")
        out["chained_launches"] = launch_counts()

    if mode == "accurate" and not child and roofline:
        out["roofline_point"] = run_roofline(device, profile=profile,
                                             **(roofline_sizes or {}))

    if mode == "accurate" and not child:
        # the pure-f32 operating point, from a child process of its own
        env = dict(os.environ, BENCH_MODE="plan", BENCH_CHILD="1",
                   BENCH_BATCH=str(batch), BENCH_HORIZON=str(horizon),
                   BENCH_ITERS=str(iters), BENCH_STEPS=str(steps),
                   BENCH_BOUND=str(bound), BENCH_REFINE=str(refine),
                   BENCH_PROFILE="1" if profile else "0")
        if rho is not None:
            env["BENCH_RHO"] = str(rho)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--device",
             device.type], env=env, capture_output=True, text=True,
            timeout=1200)
        if proc.returncode != 0:
            raise RuntimeError(f"the fast child exited {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        fast = json.loads([ln for ln in proc.stdout.splitlines()
                           if ln.startswith("{")][-1])
        out["fast_solves_per_s"] = fast["value"]
        out["fast_max_err"] = fast["max_err_vs_exact"]
        out["fast_launches"] = fast["launches"]
    out["seconds"] = round(time.perf_counter() - t_start, 1)
    return out


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    device = parse_device(argv)
    tt.set_default_device(device)
    env = os.environ
    rho = env.get("BENCH_RHO")
    out = run(mode=env.get("BENCH_MODE", "accurate"), device=device,
              batch=int(env.get("BENCH_BATCH", 4096)),
              horizon=int(env.get("BENCH_HORIZON", 100)),
              iters=int(env.get("BENCH_ITERS", 30)),
              steps=int(env.get("BENCH_STEPS", 20)),
              bound=float(env.get("BENCH_BOUND", "60.0")),
              rho=None if rho is None else float(rho),
              refine=int(env.get("BENCH_REFINE", "0")),
              rounds=int(env.get("BENCH_ROUNDS", "1")),
              profile=env.get("BENCH_PROFILE", "1") != "0",
              chained=env.get("BENCH_CHAINED", "1") != "0",
              roofline=env.get("BENCH_ROOFLINE", "1") != "0",
              child=bool(env.get("BENCH_CHILD")))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
