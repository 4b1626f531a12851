"""The port's log-depth forms against their serial forms and the JAX
reference, on the CPU in float64: the associative scan, the ``_assoc``
condensing and ``condense(method=...)`` (fault F9), ``lqr_solve_assoc``,
the parallel dual residual and ``solve_stagewise(parallel_scan=True)``.

Tolerances: 1e-12 where only the summation order differs (the scan, the
condensing, the dual residual, relative for the last); 1e-9 for the LQ
solves and the ADMM solve, whose interval combine inverts ``I + C J`` at
every level (the reference's own ``lqr_solve_assoc`` tolerance,
``tests/test_riccati.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.qp import riccati as jr
from copra_tpu_torch._scan import SMALL_X, affine_combine, associative_scan
from copra_tpu_torch.qp import riccati as tr
from fixtures import A, B, D, SMALL_N
from test_torch_stagewise import _fields, _jax, _port

tt.set_default_device("cpu")

EXACT = dict(rtol=0, atol=1e-12)
SOLVE = dict(rtol=0, atol=1e-9)


def _affine(fi, fj):
    """``x -> Mj (Mi x + ci) + cj``: not commutative, so a scan that
    combined in the wrong order would show."""
    (Mi, ci), (Mj, cj) = fi, fj
    return Mj @ Mi, (Mj @ ci.unsqueeze(-1)).squeeze(-1) + cj


@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reverse"])
@pytest.mark.parametrize("N", [1, 2, 7, 13, 64])
def test_scan_matches_serial_loop(N, reverse):
    """Each output is the fold of ``fn`` over the stages before it in scan
    order (after it, reversed), on 3 lanes of [4, 4] affine maps."""
    rng = np.random.default_rng(N)
    M = torch.tensor(rng.normal(size=(3, N, 4, 4)) / 3.0)
    c = torch.tensor(rng.normal(size=(3, N, 4)))
    got = associative_scan(_affine, (M, c), dim=1, reverse=reverse)
    order = range(N - 1, -1, -1) if reverse else range(N)
    acc, want = None, [None] * N
    for k in order:
        e = (M[:, k], c[:, k])
        acc = e if acc is None else _affine(acc, e)
        want[k] = acc
    for g, w in zip(got, zip(*want)):
        np.testing.assert_allclose(g.numpy(), torch.stack(w, 1).numpy(),
                                   **EXACT)


@pytest.mark.parametrize("rhs", ["vector", "block"])
@pytest.mark.parametrize("x", [1, 3, SMALL_X, SMALL_X + 1, 16])
def test_affine_combine_matches_matmul(x, rhs):
    """The shared combine, on both sides of its width switch (elementwise
    products up to ``SMALL_X``, ``@`` above) and for vector and block
    right-hand sides, against the plain matrix products; 1e-12."""
    rng = np.random.default_rng(x)
    M1, M2 = (torch.tensor(rng.normal(size=(2, 5, x, x))) for _ in "ab")
    shape = (2, 5, x) if rhs == "vector" else (2, 5, x, 4)
    c1, c2 = (torch.tensor(rng.normal(size=shape)) for _ in "ab")
    M, c = affine_combine((M1, c1), (M2, c2))
    want = (M2 @ c1.unsqueeze(-1)).squeeze(-1) if rhs == "vector" \
        else M2 @ c1
    np.testing.assert_allclose(M.numpy(), (M2 @ M1).numpy(), **EXACT)
    np.testing.assert_allclose(c.numpy(), (want + c2).numpy(), **EXACT)


def _same_preview(got, want, lane=None):
    for name in ("Phi", "Psi", "xi"):
        g = getattr(got, name).numpy()
        np.testing.assert_allclose(g if lane is None else g[lane],
                                   np.asarray(getattr(want, name)), **EXACT,
                                   err_msg=name)


def _ltv(rng, lanes, N, x=3, u=2):
    As = 0.9 * np.eye(x) + 0.1 * rng.normal(size=(lanes, N, x, x))
    return As, rng.normal(size=(lanes, N, x, u)), rng.normal(
        size=(lanes, N, x))


@pytest.mark.parametrize("N", [1, 9, SMALL_N])
def test_condense_lti_assoc_matches_reference_and_scan(N):
    got = tt.condense_lti_assoc(A, B, D, N)
    _same_preview(got, ct.condense_lti_assoc(A, B, D, N))
    _same_preview(got, ct.condense_lti(A, B, D, N))
    _same_preview(tt.condense_lti(A, B, D, N), ct.condense_lti(A, B, D, N))


@pytest.mark.parametrize("N", [1, 9, 16])
def test_condense_ltv_assoc_matches_reference_and_scan_per_lane(N):
    """Batched over 3 lanes; each lane against the reference's (vmapped)."""
    As, Bs, ds = _ltv(np.random.default_rng(10 + N), 3, N)
    got = tt.condense_ltv_assoc(As, Bs, ds)
    serial = tt.condense_ltv(As, Bs, ds)
    for name in ("Phi", "Psi", "xi"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(serial, name).numpy(), **EXACT)
    for fn in (ct.condense_ltv_assoc, ct.condense_ltv):
        want = jax.jit(jax.vmap(lambda a, b, d: [
            getattr(fn(a, b, d), k) for k in ("Phi", "Psi", "xi")]))(
                As, Bs, ds)
        for name, w in zip(("Phi", "Psi", "xi"), want):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(w), **EXACT, err_msg=name)


@pytest.mark.parametrize("kind", ["lti", "ltv"])
def test_condense_method_dispatch_matches_reference(kind):
    """F9: ``condense`` takes the reference's ``method``: ``"scan"`` is the
    serial form, bit for bit ``condense(s)``; any other value the
    ``_assoc`` form."""
    x0 = np.array([0.0, -1.5])
    if kind == "lti":
        ts = tt.LTISystem.create(A, B, D, x0, SMALL_N)
        js = ct.LTISystem.create(A, B, D, x0, SMALL_N)
    else:
        As, Bs, ds = (a[0] for a in _ltv(np.random.default_rng(3), 1,
                                         SMALL_N, x=2, u=1))
        ts = tt.LTVSystem.create(As, Bs, ds, x0)
        js = ct.LTVSystem.create(As, Bs, ds, x0)
    scan = tt.condense(ts, method="scan")
    plain = tt.condense(ts)
    for name in ("Phi", "Psi", "xi"):
        assert torch.equal(getattr(scan, name), getattr(plain, name))
    _same_preview(scan, ct.condense(js, method="scan"))
    _same_preview(tt.condense(ts, method="assoc"),
                  ct.condense(js, method="assoc"))
    _same_preview(tt.condense(ts, method="assoc"), ct.condense(js))


def _lq(seed, lanes, N=13, x=3, u=2):
    f = _fields(seed, N=N, x=x, u=u, rows=False, lanes=lanes)
    rng = np.random.default_rng(seed + 1)
    S = 0.05 * rng.normal(size=f["B"].shape)
    return [f[k] for k in ("A", "B", "d", "Qx", "qx", "Ru", "ru", "x0")], S


@pytest.mark.parametrize("cross", [False, True], ids=["no_S", "S"])
@pytest.mark.parametrize("lanes", [None, 3], ids=["single", "batched"])
def test_lqr_solve_assoc_matches_reference_and_serial(lanes, cross):
    args, S = _lq(20, lanes)
    S = S if cross else None
    tS = None if S is None else torch.tensor(S)
    got = tr.lqr_solve_assoc(*map(torch.tensor, args), S=tS)
    serial = tr.lqr_solve(*map(torch.tensor, args), S=tS)
    fn = lambda *a: jr.lqr_solve_assoc(*a[:8], S=a[8] if cross else None)
    jargs = tuple(map(jnp.asarray, args)) + ((jnp.asarray(S),) if cross
                                             else ())
    want = jax.jit(jax.vmap(fn) if lanes else fn)(*jargs)
    for g, s, w in zip(got, serial, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SOLVE)
        np.testing.assert_allclose(g.numpy(), s.numpy(), **SOLVE)


@pytest.mark.parametrize("N", [1, 2, 11, 40])
@pytest.mark.parametrize("rows", [False, True], ids=["box", "rows"])
def test_parallel_dual_residual_matches_serial_and_reference(rows, N):
    """Per lane of a batch of 2, against the serial loop and the
    reference's ``parallel=True``; rtol 1e-12."""
    f = _fields(30 + N, N=N, rows=True, lanes=2)
    rng = np.random.default_rng(31 + N)
    x, u, r = 3, 2, 2
    vals = [rng.normal(size=(2,) + s) for s in
            ((N + 1, x), (N, u), (N + 1, x), (N, u), (N, r))]
    yS = vals[4] if rows else None
    got = tr.stagewise_dual_residual(
        _port(f), *map(torch.tensor, vals[:4]),
        None if yS is None else torch.tensor(yS), parallel=True)
    serial = tr.stagewise_dual_residual(
        _port(f), *map(torch.tensor, vals[:4]),
        None if yS is None else torch.tensor(yS), parallel=False)
    np.testing.assert_allclose(got.numpy(), serial.numpy(), rtol=1e-12)
    want = jax.jit(jax.vmap(lambda s, *v: jr.stagewise_dual_residual(
        s, *v, parallel=True)))(_jax(f), *map(jnp.asarray, vals[:4]),
                                *(() if yS is None else (jnp.asarray(yS),)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("x", [SMALL_X + 1, 16])
def test_wide_state_log_depth_forms_match_serial_and_reference(x):
    """Above the combine's width switch (its ``@`` form): the parallel dual
    residual with rows (rtol 1e-12) and ``lqr_solve_assoc`` with the cross
    term (1e-9) against their serial forms and the reference's."""
    N, u, r = 9, 2, 3
    f = _fields(40 + x, N=N, x=x, u=u, r=r, rows=True, lanes=2)
    rng = np.random.default_rng(41 + x)
    vals = [rng.normal(size=(2,) + s) for s in
            ((N + 1, x), (N, u), (N + 1, x), (N, u), (N, r))]
    got = tr.stagewise_dual_residual(_port(f), *map(torch.tensor, vals),
                                     parallel=True)
    serial = tr.stagewise_dual_residual(_port(f), *map(torch.tensor, vals))
    np.testing.assert_allclose(got.numpy(), serial.numpy(), rtol=1e-12)
    want = jax.jit(jax.vmap(lambda s, *v: jr.stagewise_dual_residual(
        s, *v, parallel=True)))(_jax(f), *map(jnp.asarray, vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    args = [f[k] for k in ("A", "B", "d", "Qx", "qx", "Ru", "ru", "x0")]
    S = 0.05 * rng.normal(size=f["B"].shape)
    got = tr.lqr_solve_assoc(*map(torch.tensor, args), S=torch.tensor(S))
    serial = tr.lqr_solve(*map(torch.tensor, args), S=torch.tensor(S))
    want = jax.jit(jax.vmap(lambda *a: jr.lqr_solve_assoc(*a[:8], S=a[8])))(
        *map(jnp.asarray, args + [S]))
    for g, sr, w in zip(got, serial, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SOLVE)
        np.testing.assert_allclose(g.numpy(), sr.numpy(), **SOLVE)


@pytest.mark.parametrize("early_exit", [False, True])
def test_solve_stagewise_parallel_scan_matches_reference(early_exit):
    """General rows, 2 lanes: the port's ``parallel_scan=True`` solve
    against the reference's, and against its own serial sweeps."""
    f = _fields(80, N=10, rows=True, lanes=2)
    opts = ct.SolverOptions(max_iter=60, early_exit=early_exit, rho=0.3,
                            check_interval=20)
    got = tr.solve_stagewise(_port(f), opts, parallel_scan=True,
                             return_warm=True)
    serial = tr.solve_stagewise(_port(f), opts, return_warm=True)
    want = jax.jit(jax.vmap(lambda s: jr.solve_stagewise(
        s, opts, parallel_scan=True, return_warm=True)))(_jax(f))
    for g, s, w in zip(got[:2], serial[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SOLVE)
        np.testing.assert_allclose(g.numpy(), s.numpy(), **SOLVE)
    for name in ("y", "z", "primal_residual", "dual_residual"):
        np.testing.assert_allclose(getattr(got[2], name).numpy(),
                                   np.asarray(getattr(want[2], name)),
                                   **SOLVE, err_msg=name)
    np.testing.assert_array_equal(got[2].status.numpy(),
                                  np.asarray(want[2].status))
    np.testing.assert_array_equal(got[2].iterations.numpy(),
                                  np.asarray(want[2].iterations))
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SOLVE)


def test_serving_tick_with_parallel_scan_matches_serial_tick():
    """``make_stagewise_step(backend='xla', parallel_scan=True)``: a cold
    tick and a warm one against the serial sweeps' tick, 1e-9."""
    f = _fields(81, N=8, rows=True, lanes=2)
    opts = ct.SolverOptions(max_iter=20, early_exit=False, rho=0.3,
                            topup_iters=30)
    cold = opts.replace(max_iter=200)
    ticks = [tr.make_stagewise_step(_port(f), opts, cold_options=cold,
                                    backend="xla", parallel_scan=p)
             for p in (True, False)]
    w = [None, None]
    for x0 in (f["x0"], f["x0"] + 0.05):
        outs = [t(torch.tensor(x0), wi) for t, wi in zip(ticks, w)]
        np.testing.assert_allclose(outs[0][1].numpy(), outs[1][1].numpy(),
                                   **SOLVE)
        np.testing.assert_array_equal(outs[0][2].status.numpy(),
                                      outs[1][2].status.numpy())
        w = [o[3] for o in outs]
