"""The port's parallel layer (``copra_tpu_torch.parallel``: mesh, model
and horizon) against the JAX package's, on the CPU.

One gloo world of 4 processes (``tests/_torch_parallel_worker.py``) runs
every case once; the test process never joins a process group (pytest's
workers are reused across files) and holds each rank's results against
the reference on a 4-device submesh of the 8 virtual CPU devices, so that
shard counts and padding match: the reference's ``(2, 4)`` / ``(4, 2)``
meshes become a 1-D mesh of 4 and a ``(2, 2)`` mesh.  Everything is
float64.  Tolerances: lane for lane 1e-8 (``tests/test_parallel.py``,
``test_model_parallel.py``), the model-parallel iterates 1e-10 against
the reference's on the same mesh, the golden control 2e-4 (2e-3 for the
model-parallel solve).  The traffic checks are the analogs of
``tests/test_comm_volume.py``: the worker records each call of
``parallel/_collectives`` (op, elements, and whether the ADMM iteration's
body made it).
"""

import dataclasses
import fcntl
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.parallel import (batch_axes as j_batch_axes,
                                make_mesh as j_make_mesh,
                                make_sharded_mpc_step as j_make_step,
                                shard_batch as j_shard_batch,
                                sharded_solve_mpc as j_sharded_solve)
from copra_tpu.parallel.horizon import (lqr_solve_sharded as j_lqr,
                                        lqr_solve_sharded_batch as j_lqr_b)
from copra_tpu.parallel.model import (solve_qp_dp_tp as j_dp_tp,
                                      solve_qp_model_parallel as j_mp)

import _torch_parallel_worker as w
from fixtures import A, B, D, GOLDEN_CONTROL, SMALL_N, SMALL_X0

tt.set_default_device("cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(REPO, "examples"))
import torch_batched_serving as example  # noqa: E402
WORLD = 4
TIMEOUT_S = 300
LANE_TOL, MP_TOL = 1e-8, 1e-10
PSUM, PMAX, GATHER = 0, 1, 2


def _start(out):
    """The world's processes, writing their results under ``out``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, HERE] + env.get("PYTHONPATH", "").split(os.pathsep))
    port = example._free_port()
    return [subprocess.Popen(
        [sys.executable, "-u", os.path.join(HERE, "_torch_parallel_worker.py"),
         str(r), str(WORLD), str(port), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]


def _load(out):
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Starts the world; returns ``get()``, which waits for it and gives
    each rank's npz results in rank order.  A test computes the
    reference's side before it calls ``get()``, so the two overlap.

    Under pytest-xdist the module's tests may spread over several
    workers; they share one world.  The first worker to take the lock in
    the session's common temporary directory starts it and holds the lock
    until the results are written (with a ``done`` or ``failed`` marker);
    the others wait for the lock and read them."""
    shared = os.environ.get("PYTEST_XDIST_WORKER") is not None
    root = tmp_path_factory.getbasetemp()
    out = (root.parent if shared else root) / "torch_parallel"
    out.mkdir(exist_ok=True)
    lock = open(out / "lock", "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    owner = not (out / "done").exists() and not (out / "failed").exists()
    if not owner:
        fcntl.flock(lock, fcntl.LOCK_UN)
    procs = _start(out) if owner else []
    results = []

    def get():
        if results:
            return results
        if owner:
            try:
                outs = [(p,) + p.communicate(timeout=TIMEOUT_S)
                        for p in procs]
                for p, stdout, stderr in outs:
                    assert p.returncode == 0, (
                        f"worker failed (rc={p.returncode}):\n{stdout}\n"
                        f"{stderr}")
                (out / "done").touch()
            except BaseException:
                (out / "failed").touch()
                raise
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        assert (out / "done").exists(), \
            "the world started by another pytest worker failed"
        results.extend(_load(out))
        return results

    try:
        yield get
    finally:
        if owner and not results:
            # no test here read the results: finish for the other workers
            try:
                get()
            except Exception:
                pass
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        lock.close()


def _devices(shape):
    return np.asarray(jax.devices()[:WORLD]).reshape(shape)


def _system(ct_, x0s):
    """The SmallSystem with the batched ``x0s``, built by ``ct_``."""
    base = ct_.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    if ct_ is ct:
        return base.with_x0(jnp.asarray(x0s))
    return dataclasses.replace(base, x0=torch.tensor(x0s))


def _cat(ranks, key):
    """The global array from the ranks' rows, in rank order."""
    return np.concatenate([got[key] for got in ranks])


def test_sharded_solve_mpc_lane_for_lane(world):
    """Default options (early exit, adaptive rho, polish): each rank's
    lanes equal the unsharded solve's, so no decision in the loop is
    batch-global; lane 0 is the golden SmallSystem scenario."""
    x0s = w.fleet_x0s()
    jcosts, jcons = w.terms(ct)
    jres = j_sharded_solve(_system(ct, x0s), jcosts, jcons,
                           mesh=j_make_mesh(devices=jax.devices()[:WORLD]))
    costs, cons = w.terms(tt)
    want = tt.solve_mpc_batch(_system(tt, x0s), costs, cons)
    ranks = world()
    got = _cat(ranks, "ss_control")
    np.testing.assert_allclose(got, want.control.numpy(), atol=LANE_TOL)
    np.testing.assert_array_equal(_cat(ranks, "ss_iterations"),
                                  want.solution.iterations.numpy())
    np.testing.assert_array_equal(_cat(ranks, "ss_control_full"), got)
    np.testing.assert_allclose(got, np.asarray(jres.control), atol=LANE_TOL)
    np.testing.assert_array_equal(_cat(ranks, "ss_status"),
                                  np.asarray(jres.solution.status))
    np.testing.assert_allclose(got[0], GOLDEN_CONTROL, atol=2e-4)


def test_mesh_and_placements(world):
    x0s = w.fleet_x0s()
    jsys = _system(ct, x0s)
    jsh = j_shard_batch(jsys, j_make_mesh(devices=jax.devices()[:WORLD]),
                        reference=j_batch_axes(jsys))
    by_device = {s.device: np.asarray(s.data)
                 for s in jsh.x0.addressable_shards}
    assert jsh.A.sharding.is_fully_replicated
    for r, got in enumerate(world()):
        assert list(got["mesh_shape"]) == [WORLD]
        assert list(got["mesh2_shape"]) == [2, 2]
        assert list(got["mesh2_names"]) == ["batch", "model"]
        assert int(got["batch_size"]) == w.BATCH
        assert list(got["placements"]) == [
            "[Shard(dim=0), Replicate()]", "(Shard(dim=0),)",
            "(Replicate(),)"]
        np.testing.assert_array_equal(got["x0_local"], x0s[4 * r:4 * r + 4])
        np.testing.assert_array_equal(got["x0_local"],
                                      by_device[jax.devices()[r]])
        b = r // 2
        np.testing.assert_array_equal(got["x0_local_2d"],
                                      x0s[8 * b:8 * b + 8])


def test_ranks_hold_disjoint_lanes(world):
    lanes = [set(got["local_lanes"].tolist()) for got in world()]
    assert all(lanes)
    assert set().union(*lanes) == set(range(w.BATCH))
    assert sum(len(s) for s in lanes) == w.BATCH
    assert [r for r, s in enumerate(lanes) if 0 in s] == [0]


def test_sharded_step_stats_agree_across_ranks_and_with_reference(world):
    jcosts, jcons = w.terms(ct)
    step = j_make_step(j_make_mesh(devices=jax.devices()[:WORLD]), jcosts,
                       jcons, ct.SolverOptions(max_iter=w.STEP_ITERS))
    jsys = _system(ct, w.fleet_x0s())
    res1, stats1 = step(jsys, None)
    warm = ct.WarmStart(x=res1.solution.x, y=res1.solution.y,
                        z=res1.solution.z)
    res2, stats2 = step(jsys, warm)
    keys = ("converged", "total", "max_primal_residual", "max_dual_residual")
    ranks = world()
    for key, res, stats in (("1", res1, stats1), ("2", res2, stats2)):
        want = np.asarray([float(stats[k]) for k in keys])
        for got in ranks:
            np.testing.assert_array_equal(got["stats" + key],
                                          ranks[0]["stats" + key])
        got = ranks[0]["stats" + key]
        assert got[1] == w.BATCH
        assert got[0] == want[0]
        np.testing.assert_allclose(got[2:], want[2:], atol=LANE_TOL)
        np.testing.assert_allclose(_cat(ranks, "step_control" + key),
                                   np.asarray(res.control), atol=LANE_TOL)
    assert ranks[0]["stats1"][2] < 1e-3
    np.testing.assert_allclose(ranks[0]["step_control1"][0], GOLDEN_CONTROL,
                               atol=2e-3)
    # the warm-started second step converges at least as tightly
    assert ranks[0]["stats2"][2] <= ranks[0]["stats1"][2] + 1e-9


def test_sharded_dcp_checkpoint_resumes_bit_for_bit(world):
    for got in world():
        assert bool(got["dcp_same"]) and bool(got["dcp_resumed"])


def test_model_parallel_matches_reference(world):
    qp, jqp = w.golden_qp(tt), w.golden_qp(ct)
    mesh = Mesh(_devices((WORLD,)), ("model",))
    fields = ("x", "y", "z", "primal_residual", "dual_residual")
    wants = {tag: j_mp(jqp, ct.SolverOptions(**kw), mesh=mesh)
             for tag, kw in (("mp", w.MP_OPTS), ("rn", w.RN_OPTS))}
    ranks = world()
    for tag, want in wants.items():
        for got in ranks:
            for f in fields + ("status", "iterations"):
                np.testing.assert_array_equal(got[f"{tag}_{f}"],
                                              ranks[0][f"{tag}_{f}"])
            for f in fields:
                np.testing.assert_allclose(got[f"{tag}_{f}"],
                                           np.asarray(getattr(want, f)),
                                           atol=MP_TOL, rtol=0)
            assert int(got[f"{tag}_status"]) == int(want.status)
            assert int(got[f"{tag}_iterations"]) == int(want.iterations)
    # the single-device solver with the same options is the oracle
    ref = tt.solve_qp(qp, tt.SolverOptions(**w.MP_OPTS))
    np.testing.assert_allclose(ranks[0]["mp_x"], ref.x.numpy(),
                               atol=LANE_TOL)
    np.testing.assert_allclose(ranks[0]["mp_golden_x"], GOLDEN_CONTROL,
                               atol=2e-3)
    # a warm-started continuation gets closer to the optimum
    exact = tt.solve_qp_native(qp).x.numpy()
    e1 = np.abs(ranks[0]["mp_s1_x"] - exact).max()
    e2 = np.abs(ranks[0]["mp_s2_x"] - exact).max()
    assert e2 < e1


def test_dp_tp_two_axis_mesh_matches_reference(world):
    x0s = w.dp_tp_x0s()
    system = ct.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    jcosts, jcons = w.terms(ct)
    preview = ct.condense(system)
    qp_b = jax.vmap(lambda x0: ct.build_qp(preview, x0, jcosts, jcons))(
        jnp.asarray(x0s))
    want = j_dp_tp(qp_b, ct.SolverOptions(**w.DP_OPTS),
                   mesh=Mesh(_devices((2, 2)), ("batch", "model")))
    # the single-device solver over the lanes is the oracle
    oracle = tt.solve_qp(tt.DenseQP(**{
        f: torch.tensor(np.asarray(getattr(qp_b, f)))
        for f in ("Q", "c", "Aeq", "beq", "Aineq", "bineq", "lb", "ub")}),
        tt.SolverOptions(**w.DP_OPTS))
    for r, got in enumerate(world()):
        assert str(got["dp_placements"]) == "(Shard(dim=0), Replicate())"
        lanes = slice(2 * (r // 2), 2 * (r // 2) + 2)
        for f in ("x", "y", "z", "primal_residual", "dual_residual"):
            np.testing.assert_allclose(got[f"dp_{f}"],
                                       np.asarray(getattr(want, f))[lanes],
                                       atol=MP_TOL, rtol=0)
        np.testing.assert_array_equal(got["dp_status"],
                                      np.asarray(want.status)[lanes])
        np.testing.assert_allclose(got["dp_x"], oracle.x.numpy()[lanes],
                                   atol=LANE_TOL)


def test_horizon_sharded_lqr_matches_reference(world):
    """The reference's result on every rank: ``X [N + 1, x]`` whole,
    ``U [N, u]`` split over the seq axis (rank ``s`` holds its L
    stages)."""
    data = tuple(jnp.asarray(a) for a in w.lqr_data(5, 32, 3, 2))
    X1, U1 = j_lqr(*data, mesh=Mesh(_devices((WORLD,)), ("seq",)))
    X2, U2 = ct.lqr_solve(*data)
    L = 32 // WORLD
    for s, got in enumerate(world()):
        assert got["lqr_X"].shape == (33, 3) and got["lqr_U"].shape == (32, 2)
        assert str(got["lqr_X_placements"]) == "(Replicate(),)"
        assert str(got["lqr_U_placements"]) == "(Shard(dim=0),)"
        np.testing.assert_array_equal(got["lqr_X_local"], got["lqr_X"])
        np.testing.assert_array_equal(got["lqr_U_local"],
                                      got["lqr_U"][s * L:(s + 1) * L])
        for key, want, serial in (("lqr_X", X1, X2), ("lqr_U", U1, U2)):
            np.testing.assert_allclose(got[key], np.asarray(want),
                                       atol=LANE_TOL)
            np.testing.assert_allclose(got[key], np.asarray(serial),
                                       atol=LANE_TOL)


def test_batch_seq_lqr_matches_reference(world):
    """Lanes split over the batch axis; within a lane, ``U`` split over
    the seq axis and ``X`` whole."""
    data = tuple(jnp.asarray(a) for a in w.lqr_data(7, 16, 3, 2, 4))
    X1, U1 = j_lqr_b(*data, mesh=Mesh(_devices((2, 2)), ("batch", "seq")))
    L = 16 // 2
    for r, got in enumerate(world()):
        b, s = divmod(r, 2)         # ranks 2b, 2b + 1 hold lanes 2b, 2b + 1
        lanes = slice(2 * b, 2 * b + 2)
        assert str(got["lqrb_X_placements"]) == \
            "(Shard(dim=0), Replicate())"
        assert str(got["lqrb_U_placements"]) == "(Shard(dim=0), Shard(dim=1))"
        for key, want in (("lqrb_X", X1), ("lqrb_U", U1)):
            np.testing.assert_allclose(got[key], np.asarray(want),
                                       atol=LANE_TOL)
        np.testing.assert_array_equal(got["lqrb_X_local"],
                                      got["lqrb_X"][lanes])
        np.testing.assert_array_equal(got["lqrb_U_local"],
                                      got["lqrb_U"][lanes, s * L:(s + 1) * L])


def test_indivisible_sizes_raise_with_the_reference_messages(world):
    Z = jnp.zeros
    with pytest.raises(ValueError) as horizon:
        j_lqr(Z((30, 2, 2)), Z((30, 2, 1)), Z((30, 2)), Z((31, 2, 2)),
              Z((31, 2)), Z((30, 1, 1)), Z((30, 1)), Z((2,)),
              mesh=Mesh(_devices((WORLD,)), ("seq",)))
    data = tuple(jnp.asarray(a) for a in w.lqr_data(7, 16, 3, 2, 3))
    with pytest.raises(ValueError) as lqr_batch:
        j_lqr_b(*data, mesh=Mesh(_devices((2, 2)), ("batch", "seq")))
    for got in world():
        assert str(got["err_horizon"]) == str(horizon.value)
        assert str(got["err_lqr_batch"]) == str(lqr_batch.value)
        assert str(got["err_dp_batch"]) == \
            "batch 3 not divisible by 2 batch shards"
        assert "does not divide" in str(got["err_shard_batch"])


def test_model_parallel_in_loop_traffic_is_n_elements(world):
    """Every collective inside the iteration is an all-reduce of n
    elements, one an iteration, for two QPs of different row counts; the
    rest (K, the residuals, the final gather) runs once a solve."""
    qps = [w.golden_qp(tt, c) for c in (False, True)]
    n = qps[0].nr_vars
    ms = [q.nr_eq + q.nr_ineq + n for q in qps]
    assert ms[0] != ms[1]
    for got in world():
        for c, m in enumerate(ms):
            calls = got[f"comm_mp{c}"]
            inside = calls[calls[:, 2] == 1]
            assert len(inside) == w.COMM_ITERS
            assert (inside[:, 0] == PSUM).all() and (inside[:, 1] == n).all()
            outside = calls[calls[:, 2] == 0]
            m_pad = -(-m // WORLD) * WORLD
            assert sorted(map(tuple, outside[:, :2])) == sorted(
                [(PSUM, n * n), (PMAX, 1), (PSUM, n),
                 (GATHER, 2 * m_pad // WORLD)])


def test_horizon_traffic_does_not_grow_with_the_horizon(world):
    """The solve makes two all-gathers (the shard totals, then the affine
    totals), of the same size at N = 16 and N = 64: O(x^2) a shard,
    whatever N.  Then the result's one all-gather of the rank's N / D
    states, which makes ``X`` whole on every rank (the reference's
    concatenation of ``x0`` and the sharded states gathers them too)."""
    x = 2
    for got in world():
        short, long_ = (got[f"comm_lqr{N}"] for N in w.COMM_HORIZONS)
        solve = [calls[calls[:, 2] == 1] for calls in (short, long_)]
        np.testing.assert_array_equal(solve[0], solve[1])
        assert (solve[0][:, 0] == GATHER).all() and len(solve[0]) == 2
        assert sorted(solve[0][:, 1]) == sorted([3 * x * x + 2 * x,
                                                 x * x + x])
        for N, calls in zip(w.COMM_HORIZONS, (short, long_)):
            result = calls[calls[:, 2] == 0]
            assert result.tolist() == [[GATHER, N // WORLD * x, 0]]


def test_batched_serving_example(world):
    """The example in the 4-process world at 16 lanes, N = 10: every rank
    reports the world's totals, and its cold step equals the unsharded
    fixed-count solve lane for lane."""
    fleet, costs, cons = example.build_fleet(w.EXAMPLE_BATCH,
                                             w.EXAMPLE_HORIZON)
    want = tt.solve_mpc_batch(fleet, costs, cons,
                              tt.SolverOptions(max_iter=60, early_exit=False))
    ranks = world()
    for got in ranks:
        np.testing.assert_array_equal(got["ex_numbers"][:2],
                                      [WORLD, w.EXAMPLE_BATCH])
        np.testing.assert_array_equal(got["ex_cold_stats"],
                                      ranks[0]["ex_cold_stats"])
    status = _cat(ranks, "ex_cold_status")
    np.testing.assert_allclose(_cat(ranks, "ex_cold_control"),
                               want.control.numpy(), atol=LANE_TOL)
    np.testing.assert_array_equal(status, want.solution.status.numpy())
    stats = ranks[0]["ex_cold_stats"]
    assert stats[1] == w.EXAMPLE_BATCH
    assert stats[0] == (status == 0).sum()


def test_ranks_match_the_unsharded_port_solves(world):
    """``check_unsharded`` (which also holds a torchrun world of GPUs over
    NCCL) on this world's results: every case against the port's own
    unsharded solves."""
    rows = w.check_unsharded(world(), WORLD)
    assert len(rows) == 23
    failed = [row for row in rows if not row[1] <= row[2]]
    assert not failed, failed


def test_no_silent_fallback_without_a_group_or_a_card(monkeypatch):
    """In the test process, which joins no group: ``make_mesh`` raises
    naming ``distributed_init``; ``distributed_init`` raises with neither
    arguments nor torchrun's environment, and on a default device of
    ``cuda`` where there is no card (``resolve_device``'s error)."""
    import torch.distributed as dist
    from copra_tpu_torch.parallel import distributed_init, make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="distributed_init"):
        make_mesh()
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        distributed_init()
    if not torch.cuda.is_available():
        tt.set_default_device("cuda")
        try:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                distributed_init("127.0.0.1:1", 1, 0)
        finally:
            tt.set_default_device("cpu")
    assert not dist.is_initialized()
