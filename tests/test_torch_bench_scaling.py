"""The port's weak-scaling harness (``bench_scaling_torch.py``) on the CPU,
against the reference's (``bench_scaling.py``).

The workload the script builds equals the reference's ``_workload()``
fleet bit for bit, in float32 throughout.  Its fixed-count solve, cold then
warm, is what each rank of the port's sharded step runs on its rows
(``solve_mpc_batch`` at the step's options, early exit off); it is held
against the reference's ``make_sharded_mpc_step`` on a one-device CPU mesh.
The test process never joins a process group (pytest's workers are reused
across files, see ``tests/test_torch_parallel.py``): the script's own
children do, and the script is run here at a small size with gloo at 1 and
2 processes.  Tolerances: float64 on the same numpy data, 1e-8 (the same
iteration); float32, 4e-3 x max(1, max |u|).  Sixty iterations stop far
from convergence here, and that iterate amplifies rounding about 1e4-fold:
the float64 iteration on the float32-rounded data already moves 1.5e-4
relative, and at B = 8 the reference's float32 solve lies 5.6e-4 relative
from the float64 iterate, the port's 1.5e-3 (its batched ``M @ v`` sums in
another order than a lane's own product; lane by lane it lies 5.2e-4
away).  The reference runs in float32 (no x64), so its f32 side is built
from float32 costs here, where the suite runs with x64 on.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _one_thread import one_torch_thread  # noqa: F401

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.parallel import (batch_axes as j_batch_axes,
                                make_mesh as j_make_mesh,
                                make_sharded_mpc_step as j_make_step,
                                shard_batch as j_shard_batch)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import bench_scaling  # noqa: E402
import bench_scaling_torch as bs  # noqa: E402

tt.set_default_device("cpu")
HORIZON, BATCH, ITERS = 50, 8, 60
F32_RTOL = 4e-3
F64_TOL = 1e-8
# two threads over the largest size, 2: one torch thread a child process
SCRIPT_ENV = dict(BENCH_PER_DEVICE="8", BENCH_HORIZON="10", BENCH_ITERS="20",
                  BENCH_STEPS="1", BENCH_CPU_PROCESSES="2",
                  OMP_NUM_THREADS="2")


@pytest.fixture(autouse=True)
def horizon(monkeypatch):
    monkeypatch.setenv("BENCH_HORIZON", str(HORIZON))


def test_workload_equals_the_reference_bit_for_bit():
    j_costs, j_cons, j_fleet = bench_scaling._workload()
    costs, cons, fleet = bs._workload()
    want, got = j_fleet(BATCH), fleet(BATCH)
    for f in ("A", "B", "d", "x0"):
        assert getattr(got, f).dtype == torch.float32
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.A.shape == (BATCH, HORIZON, 2, 2)
    leaves = [leaf for term in (*costs, *cons)
              for leaf in vars(term).values()
              if isinstance(leaf, torch.Tensor)]
    assert leaves and all(leaf.dtype == torch.float32 for leaf in leaves)
    # the same values as the reference's terms
    for term, j_term in zip((*costs, *cons), (*j_costs, *j_cons)):
        for name, leaf in vars(term).items():
            if isinstance(leaf, torch.Tensor):
                np.testing.assert_array_equal(
                    leaf.numpy(), np.asarray(getattr(j_term, name),
                                             np.float32))


def _reference_steps(dtype):
    """The reference's sharded step on a one-device mesh, cold then warm:
    the two control arrays."""
    As, Bs, ds, x0s = bs.fleet_arrays(BATCH, HORIZON)
    system = ct.LTVSystem(*(jnp.asarray(a, dtype) for a in (As, Bs, ds, x0s)))
    f = lambda a: np.asarray(a, dtype)
    costs = (ct.TargetCost.create(f(np.eye(2)), f([0.0, -1.0]),
                                  weights=f([10.0, 1e4])),
             ct.ControlCost.create(f([[1.0]]), f([2.0]), weights=f([1e-4])))
    cons = (ct.ControlBoundConstraint.create(f([-300.0]), f([300.0])),)
    mesh = j_make_mesh(devices=jax.devices()[:1])
    system = j_shard_batch(system, mesh, reference=j_batch_axes(system))
    step = j_make_step(mesh, costs, cons, ct.SolverOptions(max_iter=ITERS))
    res1, _ = step(system, None)
    warm = ct.WarmStart(x=res1.solution.x, y=res1.solution.y,
                        z=res1.solution.z)
    res2, _ = step(system, warm)
    return [np.asarray(r.control) for r in (res1, res2)]


def _port_steps(dtype):
    """What each rank of the port's step runs on its rows: cold then warm
    ``solve_mpc_batch`` at the step's options."""
    As, Bs, ds, x0s = bs.fleet_arrays(BATCH, HORIZON)
    system = tt.LTVSystem(*(torch.tensor(np.asarray(a, dtype))
                            for a in (As, Bs, ds, x0s)))
    costs, cons = bs.terms(tt, dtype)
    opts = tt.SolverOptions(max_iter=ITERS).replace(early_exit=False)
    res1 = tt.solve_mpc_batch(system, costs, cons, opts)
    warm = tt.WarmStart(x=res1.solution.x, y=res1.solution.y,
                        z=res1.solution.z)
    res2 = tt.solve_mpc_batch(system, costs, cons, opts, warm)
    return [r.control.numpy() for r in (res1, res2)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fixed_count_solve_equals_the_reference_step(dtype):
    got, want = _port_steps(dtype), _reference_steps(dtype)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        assert g.shape == w.shape == (BATCH, HORIZON)
        tol = F64_TOL if dtype == np.float64 \
            else F32_RTOL * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= tol


def _run_script(argv, env):
    script = os.path.join(REPO, "bench_scaling_torch.py")
    return subprocess.run([sys.executable, script, *argv], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)


def test_script_on_the_cpu_prints_the_reference_lines(tmp_path):
    out = tmp_path / "scaling.json"
    env = dict(os.environ, **SCRIPT_ENV, SCALING_OUT=str(out))
    proc = _run_script(["--device", "cpu"], env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]

    def having(key):
        return [line for line in lines if key in line]

    mesh = having("devices")
    assert [line["devices"] for line in mesh] == [1, 2]
    for line in mesh:
        assert {"devices", "batch", "solves_per_s", "per_device"} <= set(line)
        assert line["batch"] == 8 * line["devices"]
        assert line["solves_per_s"] > 0
        assert line["max_abs_vs_unsharded"] == 0
        assert np.isfinite(line["max_err_vs_exact"])
        assert line["backend"] == "gloo"
        assert line["device_kind"] == "cpu" and line["power_limit"] is None
    contention = having("contention_control_processes")
    assert [line["contention_control_processes"] for line in contention] \
        == [1, 2]
    for line in contention:
        assert {"aggregate_solves_per_s", "per_process", "min_process",
                "straggler_ratio"} <= set(line)
    assert [line["independent_devices_in_one_process"]
            for line in having("independent_devices_in_one_process")] \
        == [1, 2]
    assert [line["multiprocess_cluster_processes"]
            for line in having("multiprocess_cluster_processes")] == [2]
    for line in mesh + contention:
        assert line["threads_per_process"] == 1 and line["launches"] == {}
    weak = having("min_efficiency")
    assert len(weak) == 1 and weak[0]["efficiency"]["1"] == 1.0
    assert len(having("single_process_runtime_efficiency")) == 1
    assert len(having("min_efficiency_vs_contention_ceiling")) == 1
    assert len(having("min_efficiency_vs_lockstep_ceiling")) == 1

    with open(os.path.join(REPO, "SCALING_r05.json")) as f:
        want = json.load(f)
    got = json.loads(out.read_text())
    assert set(want) <= set(got)
    for key, value in want.items():
        if isinstance(value, dict):
            assert set(got[key]) == set(value) & {"1", "2"}


def test_without_cuda_the_script_exits_naming_it():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run_script([], env)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
