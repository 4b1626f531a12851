"""The port's benchmark entry points (``bench_torch.py``,
``bench_all_torch.py``) on the CPU, against the reference's scripts
(``bench.py``, ``bench_all.py``).

The fleets the scripts build (through ``chip_smoke.py``'s builders) equal
the reference's numpy builders bit for bit.  Every ``BENCH_MODE`` of
``bench_torch.py`` runs at B = 8, N = 12 with the CPU switch and prints one
line with ``BENCH_r05.json``'s fields (less those only the card measures,
and in the other modes those only the accurate line carries); the accurate
line and its chained and roofline points hold 1e-5 against the native
oracle.  Config 3's direct LQR tick (``bench_all_torch.lqr_tick``) equals
``jax.vmap(lqr_solve_fixed)`` with ``precompute_lqr_gains`` at B = 4, N =
10.  Configs 3 and 8 of ``bench_all_torch.py`` run here at small sizes
(configs 1, 2, 5 and 6 in ``tests/test_torch_bench_all.py``).  Without a
CUDA device and without ``--device cpu`` both scripts exit non-zero,
naming CUDA.
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

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import bench_all  # noqa: E402
import bench_all_torch as ba  # noqa: E402
import bench_torch as bt  # noqa: E402
import chip_smoke as cs  # noqa: E402

tt.set_default_device("cpu")
CPU = torch.device("cpu")

# fields only a card gives (the profiler's device time), and those only
# bench.py's accurate line carries
CARD_KEYS = {"measured_device_ms_per_tick", "measured_mfu",
             "measured_hbm_util", "measured_dispatch_share",
             "device_top_ops_ms", "measured_kernel_mfu",
             "measured_kernel_ms_per_tick", "measured_dispatch_ms_per_tick",
             "measured_device_ms_per_robot", "within_budget_device"}
ACCURATE_KEYS = {"chained_solves_per_s", "chained_converged_frac",
                 "chained_max_err_vs_exact", "roofline_point",
                 "fast_solves_per_s", "fast_max_err"}
TOL = 1e-5


def reference_lines(config: int) -> list:
    with open(os.path.join(REPO, "BENCHALL.json")) as f:
        return [line for line in map(json.loads, f)
                if line["config"] == config]


def check_lines(config: int, lines: list) -> None:
    """``lines`` are as many as the reference's for ``config`` and each
    carries the keys of the reference's line at its place (less
    ``CARD_KEYS``)."""
    want = reference_lines(config)
    assert len(lines) == len(want)
    for got, ref in zip(lines, want):
        assert set(ref) - CARD_KEYS - set(got) == set(), got["metric"]


def test_fleets_equal_the_reference_builders():
    """``bench.py:_build_workload`` and its drift, ``bench_all.py``'s
    double integrator, bipedal workload and SRB quadruped, against the
    port's builders, bit for bit."""
    batch, horizon, steps = 8, 12, 3
    rng, As, Bs, ds, x0s = bench._build_workload(batch, horizon)
    drift = np.zeros((steps + 2, batch, 2))
    drift[:, :, 1] = np.cumsum(
        rng.normal(scale=0.02, size=(steps + 2, batch)), axis=0)
    arrays, x0s_p, x0_seq = cs.build_fleet(batch, horizon, ticks=steps)
    for got, want in zip(arrays, (As, Bs, ds, x0s)):
        np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(x0s_p, x0s)
    for t in range(steps + 2):
        np.testing.assert_array_equal(
            x0_seq[t], (x0s + drift[t]).astype(np.float32))

    for T in (0.1, 0.005):
        for got, want in zip(cs.double_integrator(T),
                             bench_all._double_integrator(T)):
            np.testing.assert_array_equal(got, want)

    horizon, T, A, B, d, zmp_row, Zfull, ref, lo, hi = \
        bench_all._bipedal_workload()
    for got, want in zip(cs.lipm_system(T, 0.8), (A, B, d, zmp_row)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(cs.footstep_plan(4, horizon, T), (ref, lo, hi)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.kron(np.eye(horizon + 1), zmp_row),
                                  Zfull)

    want = bench_all._srb_quadruped(N=6)
    got = cs.srb_quadruped(6)
    for name, value in got.items():
        np.testing.assert_array_equal(value, np.asarray(getattr(want, name)))


@pytest.mark.parametrize("mode", ["accurate", "plan", "plan_xla", "fused",
                                  "batch"])
def test_every_mode_prints_the_reference_fields(mode):
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        parsed = json.load(f)["parsed"]
    out = bt.run(mode=mode, device=CPU, batch=8, horizon=12, steps=3,
                 roofline_sizes=dict(batch=8, horizon=64, steps=3))
    missing = set(parsed) - CARD_KEYS - set(out)
    if mode != "accurate":
        missing -= ACCURATE_KEYS
    assert missing == set()
    assert out["device_kind"] == "cpu" and out["launches"] == {}
    assert np.isfinite(out["max_err_vs_exact"])
    if mode == "accurate":
        roof = out["roofline_point"]
        assert set(parsed["roofline_point"]) - CARD_KEYS - set(roof) == set()
        assert out["max_err_vs_exact"] <= TOL
        assert out["chained_max_err_vs_exact"] <= TOL
        assert out["chained_converged_frac"] == 1.0
        assert roof["max_err_vs_exact"] <= TOL
        # the fast point: the plan mode's line from a child process
        assert out["fast_solves_per_s"] > 0
        assert np.isfinite(out["fast_max_err"])


def _lqr_jax(As, Bs, ds, x0s, dtype):
    from copra_tpu.autospan import span_matrix
    from copra_tpu.ops.stagewise_kernel import (lqr_solve_fixed,
                                                precompute_lqr_gains)
    from copra_tpu.qp.riccati import from_mpc

    N = As.shape[1]
    f = lambda a: jnp.asarray(a, dtype)
    costs = (ct.TrajectoryCost(
        M=f(span_matrix(np.array([[1.0, 0.0]]), N + 1)),
        p=f(np.zeros(N + 1)), weights=f(np.full(N + 1, 10.0))),
        ct.SimpleControlCost(p=f(np.zeros(N)), weights=f(np.full(N, 1e-3))))
    sqp0 = from_mpc(ct.LTVSystem(A=f(As[0]), B=f(Bs[0]), d=f(ds[0]),
                                 x0=f(x0s[0])), costs, ())
    bcast = lambda a: jnp.broadcast_to(a, (As.shape[0],) + a.shape)
    gains = jax.vmap(precompute_lqr_gains)(f(As), f(Bs), f(ds),
                                           bcast(sqp0.Qx), bcast(sqp0.Ru))
    return jax.vmap(lqr_solve_fixed)(gains, f(As), f(Bs), f(ds),
                                     bcast(sqp0.qx), bcast(sqp0.ru), f(x0s))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_direct_lqr_tick_matches_jax(dtype):
    """Config 3's direct LQR tick over the lanes against the reference's
    ``jax.vmap`` of the same calls: 1e-10 in f64, 1e-5 relative in f32."""
    As, Bs, ds, x0s, _ = cs.config3_fleet(4, 1)
    ten = lambda a: torch.tensor(np.asarray(a, dtype))
    system = tt.LTVSystem(A=ten(As), B=ten(Bs), d=ten(ds), x0=ten(x0s))
    N = As.shape[1]
    costs = (tt.TrajectoryCost(
        M=tt.span_matrix(ten([[1.0, 0.0]]), N + 1), p=ten(np.zeros(N + 1)),
        weights=ten(np.full(N + 1, 10.0))),
        tt.SimpleControlCost(p=ten(np.zeros(N)), weights=ten(np.full(N,
                                                                    1e-3))))
    _, tick = ba.lqr_tick(system, costs)
    X, U = tick(system.x0)
    Xj, Uj = _lqr_jax(As, Bs, ds, x0s, getattr(jnp, dtype))
    for got, want in ((X, Xj), (U, Uj)):
        want = np.asarray(want, np.float64)
        err = float(np.abs(got.double().numpy() - want).max())
        if dtype == "float64":
            assert err <= 1e-10
        else:
            assert err <= 1e-5 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("config,sizes", [
    (3, dict(batch=8, steps=2)),
    (8, dict(horizon=20))])
def test_small_configs(config, sizes):
    """Configs 3 (the cost-only accurate tick on per-lane plans, every bound
    infinite, and the direct LQR tick) and 8 (the deadline budgets): the
    reference's lines and fields, each gate inside its contract."""
    lines = ba.Lines(CPU)
    ba.CONFIGS[config](CPU, lines, **sizes)
    check_lines(config, lines.lines)
    if config == 3:
        accurate, lqr = lines.lines
        assert accurate["max_err_vs_exact"] <= TOL
        assert accurate["converged_frac"] == 1.0
        assert lqr["max_err_rel"] <= 1e-4      # f32 sweeps
    else:
        for line in lines.lines:
            assert line["calibration_basis"] == "wall"
            assert line["budget_iters"] >= 1


def test_artifact_merges_per_config(tmp_path):
    path = str(tmp_path / "BENCHALL_torch.json")
    ba.write_artifact([{"config": 1, "v": 1}, {"config": 3, "v": 1}], {1, 3},
                      path)
    ba.write_artifact([{"config": 3, "v": 2}], {3}, path)
    with open(path) as f:
        got = [json.loads(line) for line in f]
    assert got == [{"config": 1, "v": 1}, {"config": 3, "v": 2}]


@pytest.mark.parametrize("script", ["bench_torch.py", "bench_all_torch.py"])
def test_without_cuda_the_scripts_exit_naming_it(script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, script)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
