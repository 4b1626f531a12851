"""The general ADMM solver of the PyTorch port (``copra_tpu_torch.qp.admm``)
against the JAX reference on the CPU: the same QPs, made from a numpy seed,
go through both.

Tolerances: f64 results agree to 1e-9 on x (the two run the same updates;
LAPACK sums in another order than XLA) with equal statuses and iteration
counts; f32 to 1e-4 (the reference's own f32 class).  The reference's
``kkt_solve="auto"`` reads the JAX backend (the CPU here: Cholesky solves)
and the port's follows the tensors' device (also the CPU), so the explicit
inverse is reached only by asking for it on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.qp import admm as jadmm
from copra_tpu_torch.convert import qp_from_numpy, warm_from_numpy
from copra_tpu_torch.qp import admm as tadmm

tt.set_default_device("cpu")

MODES = {"adaptive": dict(early_exit=True, adaptive_rho=True),
         "early": dict(early_exit=True, adaptive_rho=False),
         "fixed": dict(early_exit=False, max_iter=300)}


def _qp_arrays(n=8, me=2, mi=5, seed=0, batch=(), dtype=np.float64):
    """A strictly convex QP with equality, inequality and box rows that is
    feasible by construction (a known interior point); ``me = mi = 0``
    gives the box-only problem."""
    rng = np.random.default_rng(seed)
    Mx = rng.normal(size=(*batch, n, n))
    Q = Mx @ np.swapaxes(Mx, -1, -2) + 0.5 * np.eye(n)
    xf = rng.uniform(-0.3, 0.3, size=(*batch, n))
    Aeq = rng.normal(size=(*batch, me, n))
    Aineq = rng.normal(size=(*batch, mi, n))
    arrays = dict(
        Q=Q, c=3.0 * rng.normal(size=(*batch, n)), Aeq=Aeq,
        beq=(Aeq @ xf[..., None])[..., 0], Aineq=Aineq,
        bineq=(Aineq @ xf[..., None])[..., 0] + rng.uniform(
            0.05, 0.5, size=(*batch, mi)),
        lb=np.full((*batch, n), -0.5), ub=np.full((*batch, n), 0.6))
    return {k: v.astype(dtype) for k, v in arrays.items()}


def _both(arrays):
    return (ct.DenseQP(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            qp_from_numpy(arrays))


def _opts(**kw):
    return ct.SolverOptions(**kw), tt.SolverOptions(**kw)


def _jsolve(jqp, jo, warm=None, batched=False):
    """The reference solve, jitted (one compile instead of one per
    primitive)."""
    fn = ct.solve_qp_batched if batched else ct.solve_qp
    if warm is None:
        return jax.jit(lambda q: fn(q, jo))(jqp)
    return jax.jit(lambda q, w: fn(q, jo, w))(jqp, warm)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _agree(got, want, tol, exact_iterations=True):
    for f in ("x", "y", "z", "primal_residual", "dual_residual"):
        g, w = _np(getattr(got, f)), _np(getattr(want, f))
        assert g.shape == w.shape and g.dtype == w.dtype, f
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=f)
    np.testing.assert_array_equal(_np(got.status), _np(want.status))
    assert _np(got.status).dtype == np.int32
    if exact_iterations:
        np.testing.assert_array_equal(_np(got.iterations),
                                      _np(want.iterations))


def test_stack_constraints_matches_reference():
    arrays = _qp_arrays()
    jqp, tqp = _both(arrays)
    jo, to = _opts(rho=0.3, rho_eq_scale=50.0)
    for g, w in zip(tadmm.stack_constraints(tqp, to),
                    jadmm.stack_constraints(jqp, jo)):
        np.testing.assert_array_equal(_np(g), _np(w))
    # batched leaves with shared bounds: one stack per lane
    batched = _qp_arrays(batch=(3,), seed=1)
    batched["lb"], batched["ub"] = arrays["lb"], arrays["ub"]
    jb, tb = _both(batched)
    axes = ct.DenseQP(Q=0, c=0, Aeq=0, beq=0, Aineq=0, bineq=0, lb=None,
                      ub=None)
    want = jax.vmap(lambda q: jadmm.stack_constraints(q, jo),
                    in_axes=(axes,))(jb)
    for g, w in zip(tadmm.stack_constraints(tb, to), want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("me,mi", [(2, 5), (0, 0)])
def test_ruiz_equilibrate_matches_reference(me, mi):
    """1e-12: elementwise scalings and maxima, no sums but one mean.  With
    no rows the reference's ``m == 0`` branches are taken."""
    a = _qp_arrays(me=me, mi=mi, seed=3)
    a["Q"][0, 0] = 1e4                      # spread the column norms
    C = np.concatenate([a["Aeq"], a["Aineq"]]) if me else np.zeros((0, 8))
    want = jadmm.ruiz_equilibrate(jnp.asarray(a["Q"]), jnp.asarray(a["c"]),
                                  jnp.asarray(C), 3)
    got = tadmm.ruiz_equilibrate(torch.tensor(a["Q"]), torch.tensor(a["c"]),
                                 torch.tensor(C), 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-12, atol=1e-12)
    # a leading batch dimension: lane 0 is the problem above
    stack = lambda v: torch.tensor(np.stack([v, 2.0 * v]))
    for g, w in zip(tadmm.ruiz_equilibrate(stack(a["Q"]), stack(a["c"]),
                                           stack(C), 3), want):
        np.testing.assert_allclose(_np(g)[0], _np(w), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9), (np.float32, 1e-4)])
def test_polish_matches_reference(dtype, tol):
    """From a loosely converged iterate (60 fixed iterations) both polishes
    land on the same vertex; the f64 one meets the native oracle.  delta
    follows the dtype."""
    arrays = _qp_arrays(seed=5, dtype=dtype)
    jqp, tqp = _both(arrays)
    jo, to = _opts(max_iter=60, early_exit=False, polish=False)
    rough = _jsolve(jqp, jo)
    Cj, lj, uj, _ = jadmm.stack_constraints(jqp, jo)
    want = jax.jit(lambda q, *a: jadmm._polish(q, *a, jo))(
        jqp, Cj, lj, uj, rough.x, rough.y, rough.z)
    Ct, lt, ut, _ = tadmm.stack_constraints(tqp, to)
    warm = warm_from_numpy({f: np.asarray(getattr(rough, f)) for f in "xyz"})
    got = tadmm._polish(tqp, Ct, lt, ut, warm.x, warm.y, warm.z, to)
    for g, w in zip(got, want):
        assert _np(g).dtype == dtype
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol)
    if dtype == np.float64:
        exact = tt.solve_qp_native(tqp).x.numpy()
        assert np.abs(_np(got[0]) - exact).max() < 1e-8
    # a batch of two lanes, the second lane from a worse iterate: per-lane
    # accept test
    two = lambda t: torch.stack([t, 0.5 * t])
    xb, yb = tadmm._polish(tqp, Ct, lt, ut, two(warm.x), two(warm.y),
                           two(warm.z), to)
    np.testing.assert_allclose(_np(xb[0]), _np(got[0]), rtol=tol, atol=tol)
    assert xb.shape == (2, 8) and yb.shape == (2, Ct.shape[0])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape,kkt", [("general", "chol"),
                                       ("general", "inverse"),
                                       ("box", "auto"), ("box", "inverse")])
def test_solve_qp_matches_reference_f64(mode, shape, kkt):
    """All three loop modes, both KKT routes, box-only (the diagonal
    specialisation and the unconstrained seed) and general rows (Ruiz
    scaling), cold: 1e-9 on every field, statuses and iteration counts
    equal."""
    me, mi = (2, 5) if shape == "general" else (0, 0)
    jqp, tqp = _both(_qp_arrays(me=me, mi=mi, seed=11))
    jo, to = _opts(kkt_solve=kkt, **MODES[mode])
    want = _jsolve(jqp, jo)
    got = tt.solve_qp(tqp, to)
    assert int(want.status) == ct.STATUS_SOLVED
    _agree(got, want, 1e-9)
    exact = tt.solve_qp_native(tqp).x.numpy()
    assert np.abs(_np(got.x) - exact).max() < 1e-7


@pytest.mark.parametrize("mode,kw", [
    ("adaptive", {}), ("fixed", dict(kkt_solve="inverse")),
    ("early", dict(scaling=0, kkt_solve="inverse", seed="zero"))])
def test_solve_qp_matches_reference_f32_and_warm(mode, kw):
    """f32 (refine = 1 on the inverse route, the 25 eps tolerance floor,
    row normalisation with ``scaling=0``): 1e-4 on x, equal statuses; then
    a warm start from the reference's solution through both."""
    jqp, tqp = _both(_qp_arrays(seed=13, dtype=np.float32))
    jo, to = _opts(**kw, **MODES[mode])
    want = _jsolve(jqp, jo)
    got = tt.solve_qp(tqp, to)
    assert _np(got.x).dtype == np.float32
    np.testing.assert_allclose(_np(got.x), _np(want.x), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(_np(got.status), _np(want.status))
    jwarm = ct.WarmStart(x=want.x, y=want.y, z=want.z)
    twarm = warm_from_numpy({f: np.asarray(getattr(want, f)) for f in "xyz"})
    want2 = _jsolve(jqp, jo, jwarm)
    got2 = tt.solve_qp(tqp, to, twarm)
    np.testing.assert_allclose(_np(got2.x), _np(want2.x), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(_np(got2.status), _np(want2.status))
    if mode != "fixed":
        assert int(got2.iterations) <= int(got.iterations)


@pytest.mark.parametrize("mode", ["adaptive", "early"])
def test_solve_qp_batched_mixed_leaves_matches_reference(mode):
    """Batched Q, c and rows with shared bounds (unbatched leaves
    broadcast), lanes of different difficulty: per-lane iteration counts
    and statuses equal the reference's ``vmap`` of ``while_loop``, which
    freezes finished lanes; then warm, with batched warm leaves."""
    arrays = _qp_arrays(batch=(4,), seed=17)
    arrays["c"][1] *= 30.0                  # a lane that needs more work
    arrays["lb"], arrays["ub"] = arrays["lb"][0], arrays["ub"][0]
    jqp, tqp = _both(arrays)
    jo, to = _opts(**MODES[mode])
    want = _jsolve(jqp, jo, batched=True)
    got = tt.solve_qp_batched(tqp, to)
    assert len(set(_np(want.iterations).tolist())) > 1
    _agree(got, want, 1e-9)
    jwarm = ct.WarmStart(x=want.x, y=want.y, z=want.z)
    twarm = warm_from_numpy({f: np.asarray(getattr(want, f)) for f in "xyz"})
    _agree(tt.solve_qp_batched(tqp, to, twarm),
           _jsolve(jqp, jo, jwarm, batched=True), 1e-9)
    with pytest.raises(ValueError, match="batch"):
        tt.solve_qp_batched(qp_from_numpy(_qp_arrays()), to)


def _infeasible():
    n = 4
    return dict(Q=np.eye(n), c=np.zeros(n), Aeq=np.array([[1.0, 0, 0, 0]]),
                beq=np.array([10.0]), Aineq=np.zeros((0, n)),
                bineq=np.zeros(0), lb=np.zeros(n), ub=np.ones(n))


def _unbounded():
    """A zero-curvature direction with a descending linear term and no
    bound in its way (the ridge-free QP is unbounded below)."""
    n = 3
    return dict(Q=np.diag([1.0, 1.0, 0.0]), c=np.array([0.0, 0.0, -1.0]),
                Aeq=np.zeros((0, n)), beq=np.zeros(0),
                Aineq=np.array([[1.0, 1.0, 0.0]]), bineq=np.array([1.0]),
                lb=np.full(n, -np.inf), ub=np.full(n, np.inf))


def _crossed():
    a = _qp_arrays(seed=19)
    a["lb"][2], a["ub"][2] = 0.4, 0.1
    return a


@pytest.mark.parametrize("problem,mode,code", [
    (_infeasible, "fixed", ct.STATUS_PRIMAL_INFEASIBLE),
    (_infeasible, "adaptive", ct.STATUS_PRIMAL_INFEASIBLE),
    (_infeasible, "early", ct.STATUS_PRIMAL_INFEASIBLE),
    (_unbounded, "adaptive", ct.STATUS_DUAL_INFEASIBLE),
    (_unbounded, "fixed", ct.STATUS_DUAL_INFEASIBLE),
    (_crossed, "adaptive", ct.STATUS_PRIMAL_INFEASIBLE)])
def test_status_codes_match_reference(problem, mode, code):
    """Infeasible, unbounded and crossed-bounds QPs give the reference's
    status codes (Farkas certificates confirmed on two consecutive checks;
    crossed bounds are caught at the end), and the same iteration count."""
    jqp, tqp = _both(problem())
    kw = dict(MODES[mode])
    if mode == "fixed":
        kw["max_iter"] = 2000
    jo, to = _opts(polish=False, **kw)
    want = _jsolve(jqp, jo)
    got = tt.solve_qp(tqp, to)
    assert int(want.status) == code
    assert int(got.status) == code
    assert int(got.iterations) == int(want.iterations)
    assert tt.qp.types.STATUS_MESSAGES[code] in got.inform()


def test_non_finite_data_never_reports_success():
    """NaN in Q: no exception, status 1 (as the reference), in a batch only
    on the lane that holds it."""
    arrays = _qp_arrays(batch=(2,), seed=23)
    arrays["Q"][1, 0, 0] = np.nan
    jqp, tqp = _both(arrays)
    jo, to = _opts(max_iter=50, early_exit=False)
    want = _jsolve(jqp, jo, batched=True)
    got = tt.solve_qp_batched(tqp, to)
    np.testing.assert_array_equal(_np(got.status), _np(want.status))
    assert _np(got.status).tolist() == [ct.STATUS_SOLVED, ct.STATUS_MAX_ITER]


def test_registry_matches_reference():
    assert tt.available_solvers() == ct.available_solvers()
    assert tt.get_solver(None) is tt.solve_qp
    assert tt.get_solver("default") is tt.get_solver("admm")
    assert getattr(tt.get_solver("active_set"), "host_only", False)
    with pytest.raises(tt.SolverError, match="unknown QP solver 'nope'"):
        tt.get_solver("nope")
    jqp, tqp = _both(_qp_arrays(seed=29))
    got = tt.get_solver("active_set")(tqp)
    want = ct.get_solver("active_set")(jqp)
    np.testing.assert_allclose(_np(got.x), _np(want.x), rtol=0, atol=1e-12)
    marker = dataclasses.replace(got, iterations=torch.tensor(-7))
    tt.register_solver("test_marker", lambda qp, o=None, w=None: marker)
    try:
        assert "test_marker" in tt.available_solvers()
        assert int(tt.get_solver("test_marker")(tqp).iterations) == -7
    finally:
        from copra_tpu_torch.qp import registry
        registry._REGISTRY.pop("test_marker")
