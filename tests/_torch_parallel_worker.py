"""Worker process for tests/test_torch_parallel.py.

One rank of a world of processes: ``distributed_init``, the port's meshes
over the world, and every case of the parallel layer (placements, the
sharded solves and serving step, the model-parallel and horizon-sharded
solves, the errors on indivisible sizes, a sharded DCP checkpoint, the
batched-serving example and the traffic of each collective).  The rank's
results go to one npz archive; the test process holds them against the
JAX package, and :func:`check_unsharded` holds them against the port's
own unsharded solves.

The inputs are built here from fixed seeds by the ``*_data`` functions,
which the test imports to build the same inputs for the reference.

Usage, a gloo world on the CPU (one process a rank, as the test starts
it):
    python _torch_parallel_worker.py <rank> <world> <port> <out_dir>
or, one process a GPU under torchrun (NCCL), with the ranks' results
checked by rank 0 against the unsharded solves on its card, then the
batched-serving example's warm step at its defaults timed and traced:
    torchrun --nproc-per-node=N tests/_torch_parallel_worker.py <out_dir>
(``<out_dir> cpu``: the same world over gloo on the CPU).
"""

import dataclasses
import os
import shutil
import sys

import numpy as np
import torch

from fixtures import (A, B, D, M, N_MAT, SMALL_N, SMALL_X0, UD, U_LOWER,
                      U_UPPER, WU, WX, XD, X_LOWER, X_UPPER)

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 16
MP_OPTS = dict(max_iter=1500, early_exit=False, polish=False,
               row_normalize=False, scaling=0)
RN_OPTS = dict(max_iter=300, early_exit=False, polish=False, scaling=0)
DP_OPTS = dict(max_iter=1200, early_exit=False, polish=False,
               row_normalize=False, scaling=0)
STEP_ITERS, COMM_ITERS, COMM_HORIZONS = 400, 5, (16, 64)
OPS = ("psum", "pmax", "all_gather")
EXAMPLE_BATCH, EXAMPLE_HORIZON = 16, 10


def fleet_x0s(batch: int = BATCH) -> np.ndarray:
    """``tests/test_parallel.py``'s scenario fleet: the SmallSystem's x0
    and perturbed copies."""
    rng = np.random.default_rng(42)
    x0s = np.repeat(SMALL_X0[None], batch, axis=0)
    x0s[1:] += rng.normal(scale=[0.02, 0.1], size=(batch - 1, 2))
    x0s[:, 1] = np.minimum(x0s[:, 1], -0.1)
    return x0s


def terms(ct, control_only: bool = False):
    """The SmallSystem's costs and bounds, built by ``ct`` (either
    package); ``control_only`` drops the trajectory bound."""
    costs = [ct.TargetCost.create(M, XD, weights=WX),
             ct.ControlCost.create(N_MAT, UD, weights=WU)]
    cons = [ct.ControlBoundConstraint.create(U_LOWER, U_UPPER)]
    if not control_only:
        cons.insert(0, ct.TrajectoryBoundConstraint.create(X_LOWER,
                                                           X_UPPER))
    return costs, cons


def golden_qp(ct, control_only: bool = False):
    system = ct.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    costs, cons = terms(ct, control_only)
    return ct.build_qp(ct.condense(system), system.x0, costs, cons)


def dp_tp_x0s() -> np.ndarray:
    """``tests/test_model_parallel.py``'s four DP x TP scenarios."""
    rng = np.random.default_rng(11)
    return SMALL_X0[None] * (1.0 + 0.1 * rng.normal(size=(4, 2)))


def lqr_data(seed: int, N: int, x: int, u: int, batch=None) -> tuple:
    """A random LQ problem (as ``tests/test_model_parallel.py`` makes it):
    ``(A, B, d, Qx, qx, Ru, ru, x0)`` as numpy arrays, with a leading
    batch dimension when ``batch`` is given."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    Bn = 1 if batch is None else batch

    def diag_stack(k, n):
        return np.stack([[np.eye(n) * w for w in rng.uniform(0.5, 2.0, k)]
                         for _ in range(Bn)]).reshape(lead + (k, n, n))

    A_ = (0.85 * np.broadcast_to(np.eye(x), lead + (N, x, x))
          + 0.05 * rng.normal(size=lead + (N, x, x)))
    B_ = rng.normal(size=lead + (N, x, u))
    d_ = 0.1 * rng.normal(size=lead + (N, x))
    Qx = diag_stack(N + 1, x)
    qx = rng.normal(size=lead + (N + 1, x))
    Ru = diag_stack(N, u)
    ru = rng.normal(size=lead + (N, u))
    x0 = rng.normal(size=lead + (x,))
    return A_, B_, d_, Qx, qx, Ru, ru, x0


def _np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.to_local()
    return t.detach().cpu().numpy()


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def run(rank: int, world: int, port, out_dir: str,
        device: str = "cpu") -> None:
    """Every case in this rank; ``port`` None joins torchrun's world."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    import copra_tpu_torch as tt
    from copra_tpu_torch._graph import tree_map
    from copra_tpu_torch.checkpoint import load_pytree_dcp, save_pytree_dcp
    from copra_tpu_torch.parallel import (_collectives, batch_axes,
                                          batch_sharding, batch_size,
                                          distributed_init, make_mesh,
                                          make_sharded_mpc_step, shard_batch,
                                          sharded_solve_mpc,
                                          solve_qp_model_parallel)
    from copra_tpu_torch.parallel.horizon import (lqr_solve_sharded,
                                                  lqr_solve_sharded_batch)
    from copra_tpu_torch.parallel.model import solve_qp_dp_tp

    tt.set_default_device(device)
    if port is None:
        distributed_init()
    else:
        distributed_init(f"127.0.0.1:{port}", world, rank)
    dev = tt.default_device()
    out = {}
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)

    # mesh and placements: a 1-D ("batch",) mesh over the world and a
    # (2, 2) ("batch", "model") mesh
    mesh = make_mesh()
    mesh2 = make_mesh((2, -1), ("batch", "model"))
    base = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    system = dataclasses.replace(base, x0=t(fleet_x0s()))
    sharded = shard_batch(system, mesh, reference=batch_axes(system))
    out.update(
        mesh_shape=np.asarray(mesh.shape), mesh2_shape=np.asarray(mesh2.shape),
        mesh2_names=np.asarray(mesh2.mesh_dim_names),
        batch_size=batch_size(sharded),
        placements=np.asarray([str(batch_sharding(mesh2, "batch")),
                               str(sharded.x0.placements),
                               str(sharded.A.placements)]),
        x0_local=_np(sharded.x0),
        x0_local_2d=_np(shard_batch(system, mesh2, "batch",
                                    batch_axes(system)).x0),
        local_lanes=_np(shard_batch(torch.arange(BATCH, device=dev), mesh)))

    costs, cons = terms(tt)
    res = sharded_solve_mpc(sharded, costs, cons, mesh=mesh)
    out.update(ss_control=_np(res.control), ss_status=_np(res.solution.status),
               ss_iterations=_np(res.solution.iterations),
               ss_control_full=_np(sharded_solve_mpc(system, costs, cons,
                                                     mesh=mesh).control))

    # the serving step: full tensors in, then DTensors (system and warm)
    step = make_sharded_mpc_step(mesh, costs, cons,
                                 tt.SolverOptions(max_iter=STEP_ITERS))
    keys = ("converged", "total", "max_primal_residual", "max_dual_residual")
    res1, stats1 = step(system, None)
    warm = tt.WarmStart(x=res1.solution.x, y=res1.solution.y,
                        z=res1.solution.z)
    res2, stats2 = step(sharded, warm)
    out.update(stats1=np.asarray([float(stats1[k]) for k in keys]),
               stats2=np.asarray([float(stats2[k]) for k in keys]),
               step_control1=_np(res1.control),
               step_control2=_np(res2.control))

    # a sharded DCP checkpoint of the warm start, loaded and resumed
    path = os.path.join(out_dir, "dcp_warm")
    save_pytree_dcp(path, warm)
    loaded = load_pytree_dcp(path, tree_map(torch.zeros_like, warm))
    same = all(
        torch.equal(a.to_local(), b.to_local()) and a.placements ==
        b.placements and a.shape == b.shape
        for a, b in zip((loaded.x, loaded.y, loaded.z),
                        (warm.x, warm.y, warm.z)))
    res3, _ = step(sharded, loaded)
    resumed = all(torch.equal(_t.to_local(), _u.to_local()) for _t, _u in (
        (res3.control, res2.control), (res3.solution.x, res2.solution.x),
        (res3.solution.y, res2.solution.y),
        (res3.solution.z, res2.solution.z)))
    out.update(dcp_same=same, dcp_resumed=resumed)

    # model parallel: one QP's rows over a ("model",) mesh of the world
    mmesh = make_mesh(axis_names=("model",))
    qp = golden_qp(tt)
    for tag, kw in (("mp", MP_OPTS), ("rn", RN_OPTS)):
        sol = solve_qp_model_parallel(qp, tt.SolverOptions(**kw),
                                      mesh=mmesh)
        for f in ("x", "y", "z", "status", "primal_residual",
                  "dual_residual", "iterations"):
            out[f"{tag}_{f}"] = _np(getattr(sol, f))
    opts = tt.SolverOptions(**dict(MP_OPTS, max_iter=4000))
    out["mp_golden_x"] = _np(solve_qp_model_parallel(qp, opts,
                                                     mesh=mmesh).x)
    opts = tt.SolverOptions(**dict(MP_OPTS, max_iter=800))
    s1 = solve_qp_model_parallel(qp, opts, mesh=mmesh)
    s2 = solve_qp_model_parallel(qp, opts, mesh=mmesh,
                                 warm_start=tt.WarmStart(s1.x, s1.y, s1.z))
    out.update(mp_s1_x=_np(s1.x), mp_s2_x=_np(s2.x))

    # DP x TP on the default mesh, the world reshaped to (2, -1)
    qps = [tt.build_qp(tt.condense(base), t(x0), costs, cons)
           for x0 in dp_tp_x0s()]
    qp_b = tt.DenseQP(**{f.name: torch.stack([getattr(q, f.name)
                                              for q in qps])
                         for f in dataclasses.fields(qps[0])})
    sol = solve_qp_dp_tp(qp_b, tt.SolverOptions(**DP_OPTS))
    for f in ("x", "y", "z", "status", "primal_residual", "dual_residual"):
        out[f"dp_{f}"] = _np(getattr(sol, f))
    out["dp_placements"] = str(sol.x.placements)

    # horizon-sharded LQR: 1-D ("seq",) of the world, and (2, 2)
    smesh = make_mesh(axis_names=("seq",))
    X, U = lqr_solve_sharded(*map(t, lqr_data(5, 32, 3, 2)), mesh=smesh)
    bmesh = make_mesh((2, -1), ("batch", "seq"))
    Xb, Ub = lqr_solve_sharded_batch(*map(t, lqr_data(7, 16, 3, 2, 4)),
                                     mesh=bmesh)
    for key, r in (("lqr_X", X), ("lqr_U", U), ("lqrb_X", Xb),
                   ("lqrb_U", Ub)):
        out.update({key: _np(r.full_tensor()), key + "_local": _np(r),
                    key + "_placements": str(r.placements)})

    # indivisible sizes
    Z = lambda *shape: torch.zeros(shape, device=dev)
    out["err_horizon"] = _error(lambda: lqr_solve_sharded(
        Z(30, 2, 2), Z(30, 2, 1), Z(30, 2), Z(31, 2, 2), Z(31, 2),
        Z(30, 1, 1), Z(30, 1), Z(2), mesh=smesh))
    out["err_lqr_batch"] = _error(lambda: lqr_solve_sharded_batch(
        *map(t, lqr_data(7, 16, 3, 2, 3)), mesh=bmesh))
    qp3 = dataclasses.replace(qp_b, **{
        f.name: getattr(qp_b, f.name)[:3] for f in dataclasses.fields(qp_b)})
    out["err_dp_batch"] = _error(lambda: solve_qp_dp_tp(
        qp3, tt.SolverOptions(**DP_OPTS), mesh=mesh2))
    out["err_shard_batch"] = _error(lambda: shard_batch(
        dataclasses.replace(system, x0=system.x0[:6]), mesh,
        reference=batch_axes(system)))

    # the traffic of each collective: (op, elements, inside the
    # iteration's body)
    def noted(calls):
        return np.asarray([(OPS.index(op), k, caller == "body")
                           for op, k, caller in calls])

    for control_only in (False, True):
        with _collectives.recording() as calls:
            solve_qp_model_parallel(
                golden_qp(tt, control_only),
                tt.SolverOptions(**dict(MP_OPTS, max_iter=COMM_ITERS)),
                mesh=mmesh)
        out[f"comm_mp{int(control_only)}"] = noted(calls)
    for N in COMM_HORIZONS:
        with _collectives.recording() as calls:
            lqr_solve_sharded(*map(t, lqr_data(3, N, 2, 1)), mesh=smesh)
        # the solve's collectives (made in its local function) and the
        # result's one gather of the states
        out[f"comm_lqr{N}"] = np.asarray(
            [(OPS.index(op), k, caller == "local")
             for op, k, caller in calls])

    # the batched-serving example in this world, at a small size
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "examples"))
    import torch_batched_serving as example

    rec = {}
    got = example.main(EXAMPLE_BATCH, EXAMPLE_HORIZON, device=device,
                       record=rec)
    out.update(ex_numbers=np.asarray([got["devices"], got["total"],
                                      got["converged"]]),
               ex_cold_control=_np(rec["cold"].control),
               ex_cold_status=_np(rec["cold"].solution.status),
               ex_cold_stats=np.asarray([float(rec["cold_stats"][k])
                                         for k in keys]))

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()


def check_unsharded(ranks, world: int):
    """The ranks' results (npz dicts in rank order) against the port's
    unsharded solves on the default device: ``[(case, error, tolerance)]``,
    a case holding when its error is within its tolerance (0: exact).
    Joins no process group."""
    import copra_tpu_torch as tt
    from copra_tpu_torch.qp.riccati import lqr_solve

    dev = tt.default_device()
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    cat = lambda key: np.concatenate([r[key] for r in ranks])
    err = lambda a, b: float(np.abs(np.asarray(a, np.float64)
                                    - np.asarray(b, np.float64)).max())
    spread = lambda key: max(err(r[key], ranks[0][key]) for r in ranks)
    flag = lambda ok: 0.0 if ok else 1.0
    rows = []

    base = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    system = dataclasses.replace(base, x0=t(fleet_x0s()))
    costs, cons = terms(tt)
    ss = tt.solve_mpc_batch(system, costs, cons)
    rows += [("sharded_solve_mpc control", err(cat("ss_control"),
                                               _np(ss.control)), 1e-8),
             ("sharded_solve_mpc iterations",
              err(cat("ss_iterations"), _np(ss.solution.iterations)), 0)]

    opts = tt.SolverOptions(max_iter=STEP_ITERS, early_exit=False)
    r1 = tt.solve_mpc_batch(system, costs, cons, opts)
    r2 = tt.solve_mpc_batch(system, costs, cons, opts, tt.WarmStart(
        r1.solution.x, r1.solution.y, r1.solution.z))
    for k, r in (("1", r1), ("2", r2)):
        sol = r.solution
        want = [int((sol.status == 0).sum()), BATCH,
                float(sol.primal_residual.max()),
                float(sol.dual_residual.max())]
        got = ranks[0]["stats" + k]
        rows += [(f"serving step {k} control",
                  err(cat("step_control" + k), _np(r.control)), 1e-8),
                 (f"serving step {k} stats on every rank",
                  spread("stats" + k), 0),
                 (f"serving step {k} converged, total",
                  err(got[:2], want[:2]), 0),
                 (f"serving step {k} max residuals", err(got[2:], want[2:]),
                  1e-8)]
    rows.append(("sharded DCP round trip and resumed step", flag(all(
        bool(r["dcp_same"]) and bool(r["dcp_resumed"]) for r in ranks)), 0))

    qp = golden_qp(tt)
    m = qp.nr_eq + qp.nr_ineq + qp.nr_vars
    for tag, kw in (("mp", MP_OPTS), ("rn", RN_OPTS)):
        ref = tt.solve_qp(qp, tt.SolverOptions(**kw))
        got = ranks[0]
        rows += [(f"model parallel ({tag}) x, y, z", max(
            err(got[f"{tag}_x"], _np(ref.x)),
            err(got[f"{tag}_y"][:m], _np(ref.y)),
            err(got[f"{tag}_z"][:m], _np(ref.z))), 1e-8),
            (f"model parallel ({tag}) on every rank",
             max(spread(f"{tag}_{f}") for f in ("x", "y", "z")), 0)]

    qps = [tt.build_qp(tt.condense(base), t(x0), costs, cons)
           for x0 in dp_tp_x0s()]
    qp_b = tt.DenseQP(**{f.name: torch.stack([getattr(q, f.name)
                                              for q in qps])
                         for f in dataclasses.fields(qps[0])})
    ref = tt.solve_qp(qp_b, tt.SolverOptions(**DP_OPTS))
    per = len(qps) // 2                     # lanes a batch shard
    dp = 0.0
    for r, got in enumerate(ranks):
        b = r // (world // 2)               # the rank's batch shard
        lanes = slice(per * b, per * (b + 1))
        dp = max(dp, err(got["dp_x"], _np(ref.x)[lanes]),
                 err(got["dp_y"][:, :m], _np(ref.y)[lanes]))
    rows.append(("DP x TP x, y", dp, 1e-8))

    for key, data in (("lqr", lqr_data(5, 32, 3, 2)),
                      ("lqrb", lqr_data(7, 16, 3, 2, 4))):
        X, U = lqr_solve(*map(t, data))
        rows.append((f"{key} X, U (every rank's global result)", max(
            max(err(r[f"{key}_X"], _np(X)), err(r[f"{key}_U"], _np(U)))
            for r in ranks), 1e-8))

    rows.append(("indivisible sizes raise", flag(all(
        str(r[k]) for r in ranks for k in (
            "err_horizon", "err_lqr_batch", "err_dp_batch",
            "err_shard_batch"))), 0))

    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "examples"))
    import torch_batched_serving as example

    fleet, e_costs, e_cons = example.build_fleet(EXAMPLE_BATCH,
                                                 EXAMPLE_HORIZON)
    want = tt.solve_mpc_batch(fleet, e_costs, e_cons, tt.SolverOptions(
        max_iter=60, early_exit=False))
    status = cat("ex_cold_status")
    rows += [("example cold step control",
              err(cat("ex_cold_control"), _np(want.control)), 1e-8),
             ("example cold step status",
              err(status, _np(want.solution.status)), 0),
             ("example devices, total, cold converged", max(
                 err(r["ex_numbers"][:2], [world, EXAMPLE_BATCH])
                 for r in ranks) + err(ranks[0]["ex_cold_stats"][:2],
                                       [(status == 0).sum(), EXAMPLE_BATCH]),
              0),
             ("example stats on every rank", spread("ex_cold_stats"), 0)]
    return rows


def time_example(out_dir: str, rank: int, steps: int = 5) -> str:
    """The batched-serving example at its defaults in this world, then
    ``steps`` warm steps under ``torch.profiler``: a line with the
    example's own warm-step ms (host clock), the profiled steps' host ms,
    the card's busy ms a step (``profiling.trace_device_time``), the idle
    share and the busiest device ops."""
    import time

    import copra_tpu_torch as tt
    from copra_tpu_torch.profiling import trace_device_time

    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "examples"))
    import torch_batched_serving as example

    rec = {}
    got = example.main(record=rec)
    step, fleet, cold = rec["step"], rec["fleet"], rec["cold"]
    warm = tt.WarmStart(cold.solution.x, cold.solution.y, cold.solution.z)
    cuda = warm.x.to_local().is_cuda
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    step(fleet, warm)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(fleet, warm)
        sync()
        span = (time.perf_counter() - t0) / steps
    trace = os.path.join(out_dir, f"trace_rank{rank}")
    os.makedirs(trace, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace, "trace.json"))
    busy, ops = trace_device_time(trace, top_k=10 ** 6) or (0.0, [])
    shutil.rmtree(trace)
    busy /= steps
    nccl = sum(s for name, s in ops if "nccl" in name.lower()) / steps
    top = ops[:4]
    return (f"rank {rank}: warm step {got['warm_step_ms']:.4f} ms (host "
            f"clock, {got['batch']} lanes over {got['devices']} ranks); "
            f"profiled {span * 1e3:.4f} ms a step, device busy "
            f"{busy * 1e3:.4f} ms, idle share {1 - busy / span:.4f}, "
            f"NCCL kernels {nccl * 1e3:.4f} ms; top: " + "; ".join(
                f"{name[:40]} {s / steps * 1e3:.4f} ms" for name, s in top))


def main_torchrun(out_dir: str, device: str = "cuda") -> int:
    """Under torchrun, one process a GPU: every case over NCCL, rank 0
    holding the ranks' results against the unsharded solves on its card,
    then the example's warm step timed and traced on every rank
    (``device`` ``"cpu"``: the same over gloo, the trace without a device
    track)."""
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    os.makedirs(out_dir, exist_ok=True)
    run(rank, world, None, out_dir, device)
    ok, backend = True, dist.get_backend()
    if rank == 0:
        ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                 for r in range(world)]
        for case, e, tol in check_unsharded(ranks, world):
            ok &= e <= tol
            print(f"{backend} world {world}: {case}: {e:.3e} (tol {tol}) "
                  f"{'ok' if e <= tol else 'FAILED'}", flush=True)
    dist.barrier()
    print(time_example(out_dir, rank), flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    if "RANK" in os.environ and len(sys.argv) <= 3:
        sys.exit(main_torchrun(*sys.argv[1:]))
    run(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    import torch.distributed as dist

    dist.destroy_process_group()
