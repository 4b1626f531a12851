#!/usr/bin/env python3
"""Weak scaling of the port's sharded MPC step (``copra_tpu_torch.parallel``)
on ``torch.distributed``: the counterpart of ``bench_scaling.py``.

The per-device workload is the reference's: a point-mass fleet (T = 0.005,
mass 5, A perturbed 1e-4 a lane from ``np.random.default_rng(0)``, x0
around (0, -1.5)), ``TargetCost`` + ``ControlCost`` and a +-300 control
bound, ``BENCH_PER_DEVICE`` lanes (512) a device over ``BENCH_HORIZON``
stages (50), ``BENCH_ITERS`` ADMM iterations (60), all in float32 as the
reference runs without x64.  The step is ``make_sharded_mpc_step`` (early
exit off, its four statistics all-reduced each step).  Each timed point is
the median of 3 windows of 2 x ``BENCH_STEPS`` (3) warm steps, taken after
every process has printed ``READY`` and been sent ``GO`` on stdin, so that
start-up (the torch import, CUDA and process-group init) stays out of it.

torch runs one process a device, so the "mesh" of K devices is a K-process
group (NCCL on the GPU, gloo with ``--device cpu``), one device each, with
``distributed_init(address, K, rank)`` given explicitly: every rank builds
the whole fleet and solves its own rows, and its rate is the global batch
over its own wall (SPMD lockstep: the cluster's rate is the median of the
ranks').  That run is also the reference's "K-process cluster" point, so
at K >= 2 it is run once and reported under both keys.  Sizes: 1, 2, 4, ...
up to the visible GPUs (never two NCCL ranks on one card), or up to
``BENCH_CPU_PROCESSES`` (8) on the CPU, where it stands in for the
reference's ``--xla_force_host_platform_device_count=8``.

The controls (``BENCH_SKIP_CONTENTION`` skips them):

- the contention ceiling: K independent processes, each the step in a
  world of one on its own device (its own free port, so no collective
  crosses processes), released together; their rates summed;
- K per-device workloads driven from one process with no group: each lane
  ``solve_mpc_batch`` at the step's options on its own device (a CUDA
  device each on the GPU, the one CPU device on the CPU), that is the step
  without its statistics all-reduces; one window of ``BENCH_STEPS`` steps,
  as the reference times it.

On the CPU the controls share the host's cores as the mesh's processes
do; on the GPU they answer whether the host, not the collectives, holds a
multi-card step back.  Every process of the mesh and of both controls runs
with the same torch thread count, printed as ``threads_per_process``:
this process's count (``OMP_NUM_THREADS`` sets it) over the largest K, so
that K processes do not oversubscribe the cores (on an 8-core host, 8
processes of 8 threads each ran the CPU sizes 1-8 in 15 minutes, the mesh
at K = 8 at 2.4% weak-scaling efficiency).

Beyond the reference's fields each size's line carries ``device_kind`` and
``power_limit`` (``nvidia-smi --query-gpu=name,power.limit``; ``"cpu"`` and
None on the CPU), ``threads_per_process``, ``launches`` (the kernel
launches of the route, ``copra_tpu_torch.ops.counts``: none expected),
and on the mesh lines ``max_abs_vs_unsharded`` (each rank's cold and warm
controls against ``solve_mpc_batch`` of its own lanes, in the same
process, at the same options and warm start) and ``max_err_vs_exact``
(the f32 controls of lanes 0, 1, 17 and B - 1 against the native f64
oracle of their QPs; printed, not gated: this path has no accuracy
contract).

Each group's processes are started when that group runs, as the
reference's are.  A child that exits non-zero, or misses its group's
timeout (``CHILD_TIMEOUT_S``), fails the run.  ``SCALING_OUT`` writes the
reference's JSON (every key of ``SCALING_r05.json`` on the CPU; on the GPU
the keys its run has).  The script runs on the GPU and exits non-zero
without one; ``--device cpu`` runs it on the CPU.

    python3 bench_scaling_torch.py
    BENCH_CPU_PROCESSES=4 python3 bench_scaling_torch.py --device cpu
"""

from __future__ import annotations

import json
import os
import queue
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from bench_torch import card, launch_counts, parse_device

HERE = os.path.dirname(os.path.abspath(__file__))
SIZES = (1, 2, 4, 8, 16, 32)
GATE_LANES = (0, 1, 17)
CHILD_TIMEOUT_S = 900.0
# torchrun's variables: a child is given its group explicitly instead
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT", "GROUP_RANK", "LOCAL_RANK")


def settings() -> dict:
    """The reference's knobs, from the environment."""
    env = os.environ
    return dict(per_device=int(env.get("BENCH_PER_DEVICE", 512)),
                horizon=int(env.get("BENCH_HORIZON", 50)),
                iters=int(env.get("BENCH_ITERS", 60)),
                steps=int(env.get("BENCH_STEPS", 3)))


def fleet_arrays(batch: int, horizon: int) -> tuple:
    """``(A, B, d, x0)`` of ``bench_scaling.py``'s fleet, float64 numpy from
    the reference's draws (``np.random.default_rng(0)``), before the cast
    to float32."""
    T, mass = 0.005, 5.0
    A = np.array([[1.0, T], [0.0, 1.0]])
    B = np.array([[0.5 * T * T / mass], [T / mass]])
    d = np.array([-9.81 / 2.0 * T * T, -9.81 * T])
    rng = np.random.default_rng(0)
    As = np.repeat(np.repeat(A[None], horizon, 0)[None], batch, 0)
    As += rng.normal(scale=1e-4, size=As.shape)
    Bs = np.repeat(np.repeat(B[None], horizon, 0)[None], batch, 0)
    ds = np.repeat(np.repeat(d[None], horizon, 0)[None], batch, 0)
    x0s = np.array([0.0, -1.5]) + rng.normal(scale=[0.02, 0.1],
                                             size=(batch, 2))
    return As, Bs, ds, x0s


def terms(tt, dtype=np.float32) -> tuple:
    """``(costs, constraints)`` of the reference's workload, their arrays of
    ``dtype`` on the package's default device."""
    f = lambda a: np.asarray(a, dtype)
    costs = (tt.TargetCost.create(f(np.eye(2)), f([0.0, -1.0]),
                                  weights=f([10.0, 1e4])),
             tt.ControlCost.create(f([[1.0]]), f([2.0]), weights=f([1e-4])))
    return costs, (tt.ControlBoundConstraint.create(f([-300.0]),
                                                    f([300.0])),)


def _workload(horizon=None) -> tuple:
    """``(costs, constraints, fleet)``: the reference's ``_workload()`` in
    float32 on the package's default device; ``fleet(batch)`` is the
    batched ``LTVSystem``.  ``horizon`` defaults to ``BENCH_HORIZON``."""
    import copra_tpu_torch as tt

    horizon = settings()["horizon"] if horizon is None else horizon
    costs, constraints = terms(tt)

    def fleet(batch: int):
        dev = tt.default_device()
        return tt.LTVSystem(*(torch.tensor(np.asarray(a, np.float32),
                                           device=dev)
                              for a in fleet_arrays(batch, horizon)))

    return costs, constraints, fleet


def _oracle_error(tt, full, control, rows: range) -> float | None:
    """Max |u - exact| over the lanes 0, 1, 17 and B - 1 that lie in
    ``rows`` (``control``: those rows' controls): each lane's QP built in
    float64 from its float32 data and solved by the native oracle.  None
    when no such lane is in ``rows``."""
    from copra_tpu_torch._graph import tree_map

    batch = full.x0.shape[0]
    costs, constraints = tree_map(lambda t: t.double(), terms(tt))
    errs = []
    for lane in sorted({*GATE_LANES, batch - 1} & set(rows)):
        one = tt.LTVSystem(*(getattr(full, f)[lane].double()
                             for f in ("A", "B", "d", "x0")))
        qp = tt.build_qp(tt.condense(one), one.x0, costs, constraints)
        exact = tt.solve_qp_native(qp).x.numpy()
        got = control[lane - rows.start].double().cpu().numpy().reshape(-1)
        errs.append(float(np.abs(got - exact).max()))
    return max(errs) if errs else None


def _await_go() -> None:
    """``READY`` on stdout, then wait for ``GO`` on stdin."""
    print("READY", flush=True)
    line = sys.stdin.readline().strip()
    if line != "GO":
        raise SystemExit(f"expected GO on stdin, got {line!r}")


def worker_main(argv) -> int:
    """One rank of a ``world``-process group whose store listens on
    ``port`` (``--worker rank world port``), one device (``LOCAL_RANK``):
    the sharded step on the whole fleet of ``BENCH_PER_DEVICE`` x
    ``world`` lanes, this rank's rows.  A world of one is a
    contention-control process.  Protocol: ``READY`` -> ``GO`` -> one JSON
    line."""
    i = argv.index("--worker")
    rank, world, port = (int(a) for a in argv[i + 1:i + 4])
    device = parse_device(argv)
    import torch.distributed as dist

    import copra_tpu_torch as tt
    from copra_tpu_torch._graph import tree_map
    from copra_tpu_torch.ops import counts
    from copra_tpu_torch.ops import stagewise_kernel  # noqa: F401 (counted)
    from copra_tpu_torch.parallel import (batch_axes, distributed_init,
                                          make_mesh, make_sharded_mpc_step,
                                          shard_batch, solve_mpc_batch)
    from copra_tpu_torch.profiling import synchronize

    tt.set_default_device(device)
    distributed_init(f"127.0.0.1:{port}", world, rank)
    try:
        s = settings()
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device.type == "cuda" else device
        per_device, batch = s["per_device"], s["per_device"] * world
        costs, constraints, fleet = _workload()
        full, mesh = fleet(batch), make_mesh()
        system = shard_batch(full, mesh, reference=batch_axes(full))
        opts = tt.SolverOptions(max_iter=s["iters"])
        step = make_sharded_mpc_step(mesh, costs, constraints, opts)
        counts.reset()
        res1, _ = step(system, None)
        warm = tt.WarmStart(x=res1.solution.x, y=res1.solution.y,
                            z=res1.solution.z)
        res2, _ = step(system, warm)
        synchronize(dev)

        # the unsharded solves of this rank's lanes at the step's options
        rows = range(rank * per_device, (rank + 1) * per_device)
        mine = tree_map(lambda t: t[rows.start:rows.stop], full)
        fixed = opts.replace(early_exit=False)
        local = tree_map(lambda t: t.to_local(), warm)
        vs = max(float((res.control.to_local() - want.control).abs().max())
                 for res, want in (
                     (res1, solve_mpc_batch(mine, costs, constraints,
                                            fixed)),
                     (res2, solve_mpc_batch(mine, costs, constraints, fixed,
                                            local))))

        _await_go()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(2 * s["steps"]):
                res, _ = step(system, warm)
            synchronize(dev)
            rates.append(batch * 2 * s["steps"]
                         / (time.perf_counter() - t0))
        launches = launch_counts()
        err = _oracle_error(tt, full, res.control.to_local(), rows)
        print(json.dumps({"process_id": rank,
                          "device": str(res.control.to_local().device),
                          "solves_per_s": float(np.median(rates)),
                          "max_abs_vs_unsharded": vs,
                          "max_err_vs_exact": err, "launches": launches,
                          "threads": torch.get_num_threads(),
                          "backend": dist.get_backend()}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def independent_main(argv) -> int:
    """``--independent K1,K2,...``: per K, K per-device workloads driven
    from this one process with no group, each lane ``solve_mpc_batch`` at
    the step's options on its own device (``cuda:i``; the CPU for all on
    the CPU); one window of ``BENCH_STEPS`` steps.  Protocol: ``READY``
    -> ``GO`` -> one JSON line a K."""
    i = argv.index("--independent")
    sizes = [int(k) for k in argv[i + 1].split(",")]
    device = parse_device(argv)
    import copra_tpu_torch as tt
    from copra_tpu_torch.ops import counts
    from copra_tpu_torch.ops import stagewise_kernel  # noqa: F401 (counted)
    from copra_tpu_torch.parallel import solve_mpc_batch
    from copra_tpu_torch.profiling import synchronize

    _await_go()
    s = settings()
    opts = tt.SolverOptions(max_iter=s["iters"]).replace(early_exit=False)
    for nd in sizes:
        devs = [torch.device("cuda", k) if device.type == "cuda" else device
                for k in range(nd)]

        def solve(lane, warm):
            dev, system, costs, constraints = lane
            tt.set_default_device(dev)
            res = solve_mpc_batch(system, costs, constraints, opts, warm)
            return tt.WarmStart(x=res.solution.x, y=res.solution.y,
                                z=res.solution.z)

        lanes, warms = [], []
        for dev in devs:
            tt.set_default_device(dev)
            costs, constraints, fleet = _workload()
            lanes.append((dev, fleet(s["per_device"]), costs, constraints))
            warms.append(solve(lanes[-1], solve(lanes[-1], None)))
        for dev in devs:
            synchronize(dev)
        counts.reset()
        t0 = time.perf_counter()
        for _ in range(s["steps"]):
            for lane, warm in zip(lanes, warms):
                solve(lane, warm)
        for dev in devs:
            synchronize(dev)
        dt = time.perf_counter() - t0
        print(json.dumps({"independent_devices_in_one_process": nd,
                          "solves_per_s": s["per_device"] * nd * s["steps"]
                          / dt, "launches": launch_counts(),
                          "threads": torch.get_num_threads()}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# The driving process: children, their protocol and the summaries.
# ---------------------------------------------------------------------------

def _ports(n: int) -> list:
    """``n`` distinct free ports on 127.0.0.1, probed together so that none
    repeats (one taken again before its store binds fails that child)."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_STREAM)
             for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class _Child:
    """A fresh interpreter running this script with ``args``: its stdout
    read line by line on a thread, its stderr kept in a temporary file for
    the failure message."""

    def __init__(self, args, env):
        self.err = tempfile.TemporaryFile(mode="w+")
        self.args = args
        self.proc = subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), *args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.err,
            text=True, env=env, cwd=HERE)
        self.lines = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line.strip())
        self.lines.put(None)

    def send(self, text: str):
        self.proc.stdin.write(text + "\n")
        self.proc.stdin.flush()

    def failure(self, what: str) -> SystemExit:
        self.err.seek(0)
        tail = self.err.read()[-3000:]
        return SystemExit(f"bench_scaling_torch: child {self.args} {what}: "
                          f"{tail}")

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.err.close()


def _expect(children, k: int, pred, what: str, deadline: float) -> str:
    """The next line of ``children[k]`` that ``pred`` accepts (gloo and
    NCCL banners are skipped).  Any child's non-zero exit, an exit before
    the line, or the deadline fails the run."""
    child = children[k]
    while True:
        for c in children:
            rc = c.proc.poll()
            if rc not in (None, 0):
                raise c.failure(f"exited {rc}")
        if time.monotonic() > deadline:
            raise child.failure(f"sent no {what} before the timeout")
        try:
            line = child.lines.get(timeout=0.5)
        except queue.Empty:
            continue
        if line is None:
            raise child.failure(f"exited {child.proc.wait()} before {what}")
        if pred(line):
            return line


def _run(group, env, n_lines: int = 1) -> list:
    """Start one child a ``(args, extra environment)`` of ``group``, wait
    for every ``READY``, then send every ``GO`` together; read ``n_lines``
    JSON lines of each and wait for each to exit 0, all within
    ``CHILD_TIMEOUT_S``.  Returns the JSON objects, child by child."""
    children = []
    try:
        for args, extra in group:
            children.append(_Child(args, dict(env, **extra)))
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        for k in range(len(children)):
            _expect(children, k, lambda s: s == "READY", "READY", deadline)
        for c in children:                  # near-simultaneous release
            c.send("GO")
        out = [[json.loads(_expect(children, k, lambda s: s.startswith("{"),
                                   "its JSON line", deadline))
                for _ in range(n_lines)] for k in range(len(children))]
        for c in children:
            try:
                rc = c.proc.wait(timeout=max(1.0,
                                             deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise c.failure("did not exit before the timeout")
            if rc != 0:
                raise c.failure(f"exited {rc}")
        return out
    finally:
        for c in children:
            c.close()


def _one_device_each(objs) -> None:
    """Fail unless the processes of one group ran on distinct devices (on
    the GPU: one rank a card)."""
    devs = [o["device"] for o in objs]
    if devs[0] != "cpu" and len(set(devs)) != len(devs):
        raise SystemExit(f"bench_scaling_torch: processes shared a card: "
                         f"{devs}")


def _threads(objs, threads: int) -> int:
    got = {o["threads"] for o in objs}
    if got != {threads}:
        raise SystemExit(f"bench_scaling_torch: children ran {sorted(got)} "
                         f"torch threads, not {threads}")
    return threads


def _merged_launches(objs) -> dict:
    out = {}
    for o in objs:
        for name, n in o["launches"].items():
            out[name] = out.get(name, 0) + n
    return out


def mesh_point(run, nd: int, extra: dict, threads: int) -> tuple:
    """The sharded step in a group of ``nd`` processes, rank r on device r
    (``run``: ``_run`` with the children's environment): ``(rate,
    line)``, the rate the median of the ranks' global-batch rates."""
    (port,) = _ports(1)
    t0 = time.perf_counter()
    ranks = [o[0] for o in run([(["--worker", str(r), str(nd), str(port)],
                                 {"LOCAL_RANK": str(r)})
                                for r in range(nd)])]
    _one_device_each(ranks)
    thr = float(np.median([o["solves_per_s"] for o in ranks]))
    errs = [o["max_err_vs_exact"] for o in ranks
            if o["max_err_vs_exact"] is not None]
    line = {"devices": nd, "batch": settings()["per_device"] * nd,
            "solves_per_s": round(thr, 1), "per_device": round(thr / nd, 1),
            **extra, "threads_per_process": _threads(ranks, threads),
            "backend": ranks[0]["backend"],
            "max_abs_vs_unsharded": max(o["max_abs_vs_unsharded"]
                                        for o in ranks),
            "max_err_vs_exact": max(errs) if errs else None,
            "launches": _merged_launches(ranks),
            "seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps(line), flush=True)
    return thr, line


def contention_ceiling(run, sizes, extra: dict, threads: int) -> dict:
    """Aggregate rate of K start-synchronized independent processes, each
    the step in a world of one on its own device (k) and port: the pure
    contention ceiling (no collective crosses processes), per K of
    ``sizes``: ``(sum, rates)``."""
    ceilings = {}
    for nd in sizes:
        t0 = time.perf_counter()
        objs = [o[0] for o in run([(["--worker", "0", "1", str(port)],
                                    {"LOCAL_RANK": str(k)})
                                   for k, port in enumerate(_ports(nd))])]
        _one_device_each(objs)
        rates = [o["solves_per_s"] for o in objs]
        thr = float(sum(rates))
        ceilings[nd] = (thr, rates)
        print(json.dumps({"contention_control_processes": nd,
                          "aggregate_solves_per_s": round(thr, 1),
                          "per_process": round(thr / nd, 1),
                          # an SPMD lockstep program is gated by its
                          # slowest rank each step, independent processes
                          # sum: min / mean is the lockstep penalty host
                          # jitter imposes before any communication
                          "min_process": round(min(rates), 1),
                          "straggler_ratio": round(min(rates) * nd / thr, 3),
                          **extra,
                          "threads_per_process": _threads(objs, threads),
                          "launches": _merged_launches(objs),
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
    return ceilings


def independent_devices_control(run, sizes, extra: dict,
                                threads: int) -> dict:
    """K per-device solves driven from one process with no group (one
    child, every K of ``sizes`` in turn): (this / ceiling) prices the
    one-process runtime, (mesh / this) the step's increment on top of it
    (its statistics all-reduces and the group)."""
    objs = run([(["--independent", ",".join(map(str, sizes))], {})],
               n_lines=len(sizes))[0]
    out = {}
    for nd, o in zip(sizes, objs):
        out[nd] = o["solves_per_s"]
        print(json.dumps({"independent_devices_in_one_process": nd,
                          "solves_per_s": round(out[nd], 1), **extra,
                          "threads_per_process": _threads([o], threads),
                          "launches": o["launches"]}), flush=True)
    return out


def measure(run, sizes, extra: dict, threads: int, controls: bool) -> dict:
    """Run the groups in turn (the mesh at each size, then the controls;
    ``run``: ``_run`` with the children's environment), print the lines and
    summaries; returns the record that ``SCALING_OUT`` holds."""
    results, mesh_lines = {}, {}
    for nd in sizes:
        results[nd], mesh_lines[nd] = mesh_point(run, nd, extra, threads)
    base = results[sizes[0]] / sizes[0]
    eff = {nd: results[nd] / (nd * base) for nd in sizes}
    print(json.dumps({
        "metric": "weak-scaling efficiency (per-device throughput vs "
                  "1-device)",
        "efficiency": {str(k): round(v, 3) for k, v in eff.items()},
        "min_efficiency": round(min(eff.values()), 3),
    }), flush=True)
    record = {
        "raw_mesh": {str(k): v for k, v in results.items()},
        "weak_scaling_efficiency": {str(k): round(v, 3)
                                    for k, v in eff.items()},
        **extra, "threads_per_process": threads,
        "workload": dict(settings(), dtype="float32"),
        "max_abs_vs_unsharded": {str(k): line["max_abs_vs_unsharded"]
                                 for k, line in mesh_lines.items()},
        "max_err_vs_exact": {str(k): line["max_err_vs_exact"]
                             for k, line in mesh_lines.items()},
    }
    if not controls:
        return record

    ceilings_full = contention_ceiling(run, sizes, extra, threads)
    ceilings = {nd: v[0] for nd, v in ceilings_full.items()}
    eff_vs = {nd: results[nd] / ceilings[nd] for nd in sizes}
    indep = independent_devices_control(run, sizes, extra, threads)
    decomposition = {
        "single_process_runtime_efficiency":
            {str(k): round(indep[k] / ceilings[k], 3) for k in sizes},
        "mesh_vs_independent_devices":
            {str(k): round(results[k] / indep[k], 3) for k in sizes},
    }
    print(json.dumps({
        "metric": "loss decomposition: one-process runtime vs the sharded "
                  "step's increment", **decomposition}), flush=True)
    print(json.dumps({
        "metric": "efficiency vs measured contention ceiling (K "
                  "independent 1-device processes, same workload)",
        "efficiency_vs_contention_ceiling":
            {str(k): round(v, 3) for k, v in eff_vs.items()},
        "min_efficiency_vs_contention_ceiling":
            round(min(eff_vs.values()), 3),
    }), flush=True)
    record.update({
        "contention_ceiling": {str(k): round(v, 1)
                               for k, v in ceilings.items()},
        "efficiency_vs_contention_ceiling":
            {str(k): round(v, 3) for k, v in eff_vs.items()},
        "independent_devices_one_process": {str(k): round(v, 1)
                                            for k, v in indep.items()},
        **decomposition})

    # the K-process cluster: on torch the mesh run of K >= 2 is that cluster
    # already (K processes, one device each, inter-process collectives), so
    # its rates are reported again under these keys
    cluster = {nd: results[nd] for nd in sizes if 2 <= nd <= 8}
    if not cluster or os.environ.get("BENCH_SKIP_MULTIPROCESS"):
        return record
    for nd, thr in cluster.items():
        print(json.dumps({"multiprocess_cluster_processes": nd,
                          "solves_per_s": round(thr, 1)}), flush=True)
    mp_eff = {nd: cluster[nd] / ceilings[nd] for nd in cluster}
    # independent processes sum K free-running rates; a lockstep group is
    # gated by its slowest rank, so its ceiling on a shared host is K x the
    # slowest independent rate
    lockstep = {nd: len(ceilings_full[nd][1]) * min(ceilings_full[nd][1])
                for nd in cluster}
    ls_eff = {nd: cluster[nd] / lockstep[nd] for nd in cluster}
    summary = {
        "metric": f"K-process torch.distributed "
                  f"{mesh_lines[sizes[-1]]['backend']} cluster efficiency "
                  f"vs the K-independent-process contention ceiling (same "
                  f"workload, same host)",
        "cluster_solves_per_s": {str(k): round(v, 1)
                                 for k, v in cluster.items()},
        "ceiling_solves_per_s": {str(k): round(ceilings[k], 1)
                                 for k in cluster},
        "multiprocess_efficiency": {str(k): round(v, 3)
                                    for k, v in mp_eff.items()},
        "min_multiprocess_efficiency": round(min(mp_eff.values()), 3),
        "lockstep_straggler_ceiling_solves_per_s":
            {str(k): round(v, 1) for k, v in lockstep.items()},
        "efficiency_vs_lockstep_ceiling": {str(k): round(v, 3)
                                           for k, v in ls_eff.items()},
        "min_efficiency_vs_lockstep_ceiling": round(min(ls_eff.values()), 3),
    }
    print(json.dumps(summary), flush=True)
    record.update(summary)
    return record


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    device = parse_device(argv)
    if "--worker" in argv:
        return worker_main(argv)
    if "--independent" in argv:
        return independent_main(argv)

    env = os.environ
    if device.type == "cuda":
        cap = torch.cuda.device_count()
    else:
        cap = int(env.get("BENCH_CPU_PROCESSES", 8))
    sizes = [k for k in SIZES if k <= cap]
    threads = max(1, torch.get_num_threads() // sizes[-1])
    child_env = {k: v for k, v in env.items() if k not in LAUNCHER_ENV}
    child_env.update(OMP_NUM_THREADS=str(threads),
                     MKL_NUM_THREADS=str(threads))
    extra = card(device, sizes[-1])
    if not os.path.exists(os.path.join(HERE, "native",
                                       "libcopra_native.so")):
        # the oracle's library, built once here rather than by K ranks at
        # once (``copra_tpu_torch.qp.native`` builds it the same way)
        subprocess.run(["make", "-C", os.path.join(HERE, "native")],
                       check=True, capture_output=True)

    def run(group, n_lines: int = 1) -> list:
        return _run([([*args, "--device", device.type], extra_env)
                     for args, extra_env in group], child_env, n_lines)

    record = measure(run, sizes, extra, threads,
                     controls=not env.get("BENCH_SKIP_CONTENTION"))
    if env.get("SCALING_OUT"):
        with open(env["SCALING_OUT"], "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
