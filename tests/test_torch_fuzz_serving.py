"""Randomized serving-path cross-validation of the port (analog of
``tests/test_fuzz_serving.py``), on the CPU.

The draws are those of the front-end fuzz (``tests/_fuzz_draw.
draw_problem``, the reference's generator with the package as an
argument), with the reference suite's seeds, ticks and
gates:

* ``make_control_plan`` + ``make_plan_step`` receding ticks (warm-started,
  default options) meet the exact float64 native oracle of the
  plan-instantiated QP at 1e-5 and a fresh no-knobs ``solve`` of the same
  problem at 2e-5, every tick;
* ``make_stagewise_step`` warm ticks over a small fleet (per-stage
  expressible draws, default options) meet the oracle at 1e-4;
* ``backend="fused"`` reproduces ``backend="xla"`` at 5e-5 over 3 ticks
  on float32 draws.  On the CPU the fused backend runs the stagewise tick
  kernel's plain version, so this holds the kernel's packing (the
  front end's re-expressed trajectory rows, mixed rows, masked bounds)
  against the plain loop; the card holds the kernel itself
  (``chip_smoke.py`` phase 33).

States evolve through the true dynamics (closed loop), so each tick sees
a new x0 and the warm caches are exercised.  The reference's own serving
paths are not re-run: its suite holds them to the same oracle.
"""

import dataclasses

import numpy as np
import pytest
import torch

import copra_tpu_torch as tt
from copra_tpu_torch._graph import tree_map
from copra_tpu_torch.qp.riccati import from_mpc, make_stagewise_step
from _fuzz_draw import draw_problem

tt.set_default_device("cpu")

pytestmark = pytest.mark.skipif(not tt.native_available(),
                                reason="native solver did not build")

TICKS = 3


def _step_state(system, x0, U):
    """x_1 of the closed loop: the first control applied to the
    dynamics."""
    u = system.udim
    A, B, d = (np.asarray(t) for t in (system.A, system.B, system.d))
    if A.ndim == 3:                       # LTV: stage-0 matrices
        A, B, d = A[0], B[0], d[0]
    return A @ np.asarray(x0) + B @ np.asarray(U)[:u] + d


def _oracle_err(plan, x0, U):
    """Relative distance of ``U`` from the exact solution of the plan's
    QP at ``x0``."""
    ref = tt.solve_qp_native(tt.plan_qp(plan, np.asarray(x0, np.float64)))
    assert int(ref.status) == tt.STATUS_SOLVED
    want = ref.x.numpy()
    scale = max(1.0, np.abs(want).max())
    return np.abs(np.asarray(U).reshape(-1) - want).max() / scale, scale


def _fleet(sqp, x0s):
    """``sqp`` repeated over ``len(x0s)`` lanes, lane ``b`` at ``x0s[b]``."""
    lanes = len(x0s)
    sqp_b = tree_map(lambda a: a.expand((lanes,) + a.shape).contiguous(),
                     sqp)
    return dataclasses.replace(sqp_b, x0=torch.as_tensor(x0s).to(sqp.x0))


@pytest.mark.parametrize("seed", [0, 2, 4, 7, 11])
def test_plan_step_receding_matches_fresh_solves(seed):
    # eq_rows=False: equality right-hand sides anchored at the initial
    # witness can become infeasible once the closed loop drifts the state.
    # No hand-set options: the serving facade's defaults carry the gates.
    system, costs, constraints, _ = draw_problem(tt, seed, eq_rows=False)
    plan = tt.make_control_plan(system, costs, constraints)
    step = tt.make_plan_step(plan)
    x0 = system.x0.numpy()
    warm = None
    for t in range(TICKS):
        U, sol, warm = step(torch.tensor(x0), warm)
        assert int(sol.status) == tt.STATUS_SOLVED, \
            f"seed {seed} tick {t}: {sol.inform()}"
        err_o, scale = _oracle_err(plan, x0, U)
        assert err_o <= 1e-5, \
            f"seed {seed} tick {t}: plan vs oracle {err_o:.2e}"
        fresh = tt.solve(dataclasses.replace(system, x0=torch.tensor(x0)),
                         costs, constraints)
        err_f = np.abs(U.numpy() - fresh.control.numpy()).max() / scale
        assert err_f <= 2e-5, \
            f"seed {seed} tick {t}: plan vs fresh {err_f:.2e}"
        x0 = _step_state(system, x0, U)


@pytest.mark.parametrize("seed", [1, 3, 6, 8])
def test_stagewise_step_receding_matches_oracle(seed):
    system, costs, constraints, stagewise_ok = draw_problem(
        tt, seed, eq_rows=False)
    if not stagewise_ok:
        pytest.skip("draw includes stage-coupling entries")
    lanes = 3                      # lanes share dynamics, distinct states
    rng = np.random.default_rng(100 + seed)
    x0s = system.x0.numpy()[None] + 0.1 * rng.normal(
        size=(lanes, system.xdim))
    sqp_b = _fleet(from_mpc(system, costs, constraints), x0s)
    # default options: the facade's budget carries the 1e-4 gate
    tick = tt.make_stagewise_step(sqp_b)
    plan = tt.make_control_plan(system, costs, constraints)
    warm = None
    xs = x0s
    for t in range(2):
        X, U, info, warm = tick(torch.tensor(xs), warm)
        for lane in range(lanes):
            err, _ = _oracle_err(plan, xs[lane], U[lane])
            assert err <= 1e-4, \
                f"seed {seed} tick {t} lane {lane}: stagewise vs oracle " \
                f"{err:.2e}"
        xs = np.stack([_step_state(system, xs[lane],
                                   U[lane].reshape(-1).numpy())
                       for lane in range(lanes)])


@pytest.mark.parametrize("seed", [0, 5, 12])
def test_fused_stagewise_matches_xla_on_random_draws(seed):
    """The fused backend (the tick kernel's plain version here) against
    the plain loop on front-end-lowered random problems, float32."""
    system, costs, constraints, stagewise_ok = draw_problem(
        tt, seed, eq_rows=False)
    if not stagewise_ok:
        pytest.skip("draw includes stage-coupling entries")
    sqp = tree_map(lambda a: a.to(torch.float32),
                   from_mpc(system, costs, constraints))
    rng = np.random.default_rng(200 + seed)
    x0s = system.x0.numpy().astype(np.float32)[None] + np.float32(0.05) * \
        rng.normal(size=(2, system.xdim)).astype(np.float32)
    sqp_b = _fleet(sqp, x0s)
    opts = tt.SolverOptions(max_iter=25, early_exit=False)
    tick_x = make_stagewise_step(sqp_b, opts, backend="xla")
    tick_f = make_stagewise_step(sqp_b, opts, backend="fused")
    warm_x = warm_f = None
    for k in range(3):
        x0k = torch.tensor(x0s + np.float32(0.01 * k))
        Xx, Ux, _, warm_x = tick_x(x0k, warm_x)
        Xf, Uf, _, warm_f = tick_f(x0k, warm_f)
        np.testing.assert_allclose(Uf.numpy(), Ux.numpy(), rtol=0,
                                   atol=5e-5)
        np.testing.assert_allclose(Xf.numpy(), Xx.numpy(), rtol=0,
                                   atol=5e-5)
