"""The port's early-exit stagewise solve and measured serving policies
against the JAX reference, on the CPU.

Inputs are made from numpy seeds (and the reference's golden fixtures) and
fed to both packages in float64.  Tolerances: the same per-lane
``iterations`` and ``status`` and U within 1e-9 for the early-exit solve
(the reference's fused-against-XLA tolerance); 1e-12 between the port's
two early-exit routes on the CPU (the same operations: the kernel's plain
version in chunks against the loop); the probe oracle within 1e-9; each
probe value within 5e-6 absolute or 1% of the reference's, and the same
chosen candidate.  No Pallas interpreter runs here; the early-exit route on
the card is held in ``tests/test_torch_noknobs_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.qp import riccati as jr
from copra_tpu_torch.ops import stagewise_kernel as sk
from copra_tpu_torch.qp import riccati as tr
from fixtures import (A, B, D, M, N_MAT, SMALL_N, SMALL_X0, UD, U_LOWER,
                      U_UPPER, WU, WX, XD)
from test_torch_stagewise import _fields, _jax, _port

tt.set_default_device("cpu")

SOLVE_TOL = 1e-9
SAME_TOL = 1e-12


def _probe_close(got, want):
    """A probe value within 5e-6 absolute or 1% of the reference's."""
    return abs(got - want) <= max(5e-6, 0.01 * abs(want))


@pytest.mark.parametrize("case", ["rows", "box_only", "single",
                                  "infeasible"])
def test_early_exit_solve_matches_reference(case):
    """Early exit, each lane stopping at its own convergence: the port's
    plain loop against the reference's vmapped while-loop (iterations and
    statuses equal, U within 1e-9), and the chunked route of
    ``solve_stagewise_fused`` (the kernel's plain version on CPU tensors)
    against the loop (equal, 1e-12)."""
    rows = case != "box_only"
    f = _fields(21, N=8, lanes=None if case == "single" else 3, rows=rows)
    if case == "infeasible":
        f["clo"][1], f["chi"][1] = f["clo"][1] + 40.0, f["chi"][1] + 41.0
    opts = ct.SolverOptions(max_iter=300, eps_abs=1e-8, eps_rel=0.0,
                            rho=0.3, check_interval=7)
    got = tr.solve_stagewise(_port(f), opts, return_warm=True)
    solve = lambda s: jr.solve_stagewise(s, opts, return_warm=True)
    want = jax.jit(solve if case == "single" else jax.vmap(solve))(_jax(f))
    np.testing.assert_array_equal(got[2].iterations.numpy(),
                                  np.asarray(want[2].iterations))
    np.testing.assert_array_equal(got[2].status.numpy(),
                                  np.asarray(want[2].status))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=SOLVE_TOL)
    if case == "infeasible":
        assert int(got[2].status[1]) == tt.STATUS_PRIMAL_INFEASIBLE
    fused = sk.solve_stagewise_fused(_port(f), opts, return_warm=True)
    assert torch.equal(fused[2].iterations, got[2].iterations)
    assert torch.equal(fused[2].status, got[2].status)
    for g, w in zip(fused[:2] + tuple(fused[3]), got[:2] + tuple(got[3])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=SAME_TOL)


def _fixture_sqps():
    """The reference's policy fixture (``tests/test_rho_policy.py``): the
    SmallSystem with target and control costs and the control bound, in
    both packages."""
    out = []
    for pkg, riccati in ((ct, jr), (tt, tr)):
        system = pkg.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
        costs = (pkg.TargetCost.create(M, XD, weights=WX),
                 pkg.ControlCost.create(N_MAT, UD, weights=WU))
        cons = (pkg.ControlBoundConstraint.create(U_LOWER, U_UPPER),)
        out.append(riccati.from_mpc(system, costs, cons))
    return out


def test_probe_setup_and_oracle_match_reference():
    """The probe lanes, the drifting states (the reference's generator and
    seed) and the float64 early-exit oracle at the last state: 1e-15 and
    1e-9.  The fleet's lanes differ in x0, so the spread samples matter."""
    f = _fields(33, N=8, lanes=5, rows=True)
    opts = ct.SolverOptions(max_iter=40, rho=0.3)
    got = tr._probe_setup(_port(f), 3, 2, 0.01)
    want = jr._probe_setup(_jax(f), 3, 2, 0.01)
    assert got[1] == want[1] == 3
    np.testing.assert_allclose(got[0].x0.numpy(), np.asarray(want[0].x0),
                               rtol=0, atol=0)
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-15)
    for g, w in zip(got[4], want[4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-15)
    exact = tr._probe_exact(*got[:4], opts, False)
    ref = jr._probe_exact(*want[:4], opts, False)
    for g, w in zip(exact, ref):
        np.testing.assert_allclose(g, w, rtol=0, atol=SOLVE_TOL)


def test_auto_rho_stagewise_matches_reference():
    """The reference's rho-policy case: the same chosen penalty, each
    probe value within 5e-6 or 1%, and the reference test's own pins (the
    chosen one is the probe minimum, below 1e-4)."""
    jsqp, tsqp = _fixture_sqps()
    opts = ct.SolverOptions(max_iter=60, early_exit=False)
    kw = dict(cold_options=opts.replace(max_iter=600),
              candidates=(0.01, 0.1, 1.0), probe_steps=2, drift_scale=0.01,
              return_probe=True)
    rho, probe = tr.auto_rho_stagewise(tsqp, opts, **kw)
    jrho, jprobe = jr.auto_rho_stagewise(jsqp, opts, **kw)
    assert rho == jrho
    assert set(probe) == set(jprobe)
    for c in probe:
        assert _probe_close(probe[c], jprobe[c]), (c, probe[c], jprobe[c])
    assert probe[rho] == min(probe.values())
    assert probe[rho] < 1e-4


def test_auto_iters_stagewise_matches_reference():
    """The reference's iteration-policy case: the same chosen budget and
    each applied and tail error within 5e-6 or 1%; then a tail target and
    one no candidate meets (the fallback to the smallest error), each as
    the reference chooses."""
    jsqp, tsqp = _fixture_sqps()
    opts = ct.SolverOptions(max_iter=60, early_exit=False, rho=0.1)
    kw = dict(cold_options=opts.replace(max_iter=600),
              candidates=(5, 40, 160), probe_steps=2, drift_scale=0.01,
              return_probe=True)
    iters, probe = tr.auto_iters_stagewise(tsqp, opts,
                                           target_applied_err=1e-5, **kw)
    jiters, jprobe = jr.auto_iters_stagewise(jsqp, opts,
                                             target_applied_err=1e-5, **kw)
    assert iters == jiters and set(probe) == {5, 40, 160} == set(jprobe)
    for c in probe:
        for key in ("applied_err", "tail_err"):
            assert _probe_close(probe[c][key], jprobe[c][key]), (c, key)
        assert probe[c]["applied_err"] <= probe[c]["tail_err"] + 1e-15
    # a tail target that no candidate meets: the fallback ranks by the
    # tail error, as the reference's does
    kw = dict(kw, return_probe=False, target_applied_err=1e-5,
              target_tail_err=1e-30)
    assert (tr.auto_iters_stagewise(tsqp, opts, **kw)
            == jr.auto_iters_stagewise(jsqp, opts, **kw)
            == min(probe, key=lambda c: probe[c]["tail_err"]))
