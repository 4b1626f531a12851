"""Randomized front-end cross-validation of the port (analog of
``tests/test_fuzz_frontend.py``), on the CPU in float64.

Every draw (random dimensions, LTI or LTV dynamics, cost combinations and
constraint combinations with guaranteed-feasible rows) is made in numpy
by ``tests/_fuzz_draw.draw_problem``, a copy of the reference suite's
generator that takes the package as an argument, so ``copra_tpu`` and
``copra_tpu_torch`` get the same problem.  For each of the reference's 14
seeds:

1. the port's ``condense`` + ``build_qp`` QP equals the reference's to
   1e-12 relative (the same float64 arithmetic on the same data);
2. the port's no-knobs ``solve`` meets the exact float64 native oracle
   (``native/activeset.cpp``) at the reference's 1e-5 relative, and its
   trajectory replays the dynamics within 1e-8;
3. ``solve(engine="stagewise")`` meets the oracle at 1e-4 where the draw
   is per-stage expressible.

The reference's own ``solve`` is not re-run: its suite holds it to the
same oracle at the same gates, so both packages meeting one exact oracle
is the parity.
"""

import jax
import numpy as np
import pytest

import copra_tpu as ct
import copra_tpu_torch as tt
from _fuzz_draw import draw_problem

tt.set_default_device("cpu")

pytestmark = pytest.mark.skipif(not tt.native_available(),
                                reason="native solver did not build")

N_CASES = 14
QP_TOL = 1e-12


def _oracle(qp, seed):
    ref = tt.solve_qp_native(qp)
    assert int(ref.status) == tt.STATUS_SOLVED, \
        f"oracle failed on seed {seed}: {ref.inform()}"
    return ref.x.numpy()


@pytest.mark.parametrize("seed", range(N_CASES))
def test_random_frontend_cross_validation(seed):
    system, costs, constraints, stagewise_ok = draw_problem(tt, seed)
    qp = tt.build_qp(tt.condense(system), system.x0, costs, constraints)

    # the same draw through the reference's front end (one jitted
    # function): the same QP
    jsys, jcosts, jcons, jok = draw_problem(ct, seed)
    jqp = jax.jit(lambda s, c, k: ct.build_qp(ct.condense(s), s.x0, c, k))(
        jsys, jcosts, jcons)
    assert jok == stagewise_ok
    for name in ("Q", "c", "Aeq", "beq", "Aineq", "bineq", "lb", "ub"):
        got, want = getattr(qp, name).numpy(), np.asarray(getattr(jqp, name))
        assert got.shape == want.shape, name
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite,
                                      err_msg=name)
        scale = max(1.0, np.abs(want[finite]).max(initial=0.0))
        np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                                   atol=QP_TOL * scale, err_msg=name)

    U_ref = _oracle(qp, seed)
    scale = max(1.0, np.abs(U_ref).max())

    # the no-knobs entry point, no hand-set options
    res = tt.solve(system, costs, constraints)
    assert int(res.solution.status) == tt.STATUS_SOLVED, \
        f"seed {seed}: solve status {res.solution.inform()}"
    err = np.abs(res.control.numpy() - U_ref).max() / scale
    assert err <= 1e-5, f"seed {seed}: solve vs oracle rel err {err:.2e}"
    assert float(tt.replay_dynamics(system, res.trajectory,
                                    res.control)) <= 1e-8

    if stagewise_ok:
        res_sw = tt.solve(system, costs, constraints, engine="stagewise")
        err_st = np.abs(res_sw.control.numpy().reshape(-1)
                        - U_ref).max() / scale
        assert err_st <= 1e-4, \
            f"seed {seed}: stagewise vs oracle rel err {err_st:.2e}"
