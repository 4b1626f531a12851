"""The plain versions of the per-lane general ADMM kernel and of the batched
Cholesky kernel, and ``solve_qp_batched_fused``, of the PyTorch port against
the JAX reference on the CPU (the kernels themselves are held against the
plain versions on the card, ``tests/test_torch_general_cuda.py``).

The reference's Pallas kernels run in interpret mode in three small cases
only.  Tolerances: 2e-4 for a kernel's plain version after 60 f32
iterations (the reference's kernel tolerance); 1e-9 for the f64 Cholesky
(the reference's own bound against ``jnp.linalg.cholesky``); the fused
batched solve 1e-4 against the reference's and 5e-4 against the native
oracle with polish (the bounds of ``tests/test_pallas_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.ops.admm_kernel import (fused_admm_general as
                                       jax_fused_general,
                                       solve_qp_batched_fused as
                                       jax_solve_fused)
from copra_tpu.ops.cholesky_kernel import chol_batched as jax_chol_batched
from copra_tpu_torch.convert import qp_from_numpy
from copra_tpu_torch.ops import admm_kernel as ak
from copra_tpu_torch.ops import cholesky_kernel as ck
from copra_tpu_torch.qp.admm import stack_constraints

tt.set_default_device("cpu")

SC = dict(sigma=1e-6, alpha=1.6)


def _general_arrays(batch=4, n=10, mi=6, seed=1, dtype=np.float32):
    """The shapes of the reference's kernel test: per-lane Q, inequality
    rows and boxes; ``C``, ``l``, ``u``, ``rho`` and ``inv(K)`` per lane
    (a plain inverse, symmetric only to rounding), and distinct non-zero
    x0, y0, z0."""
    rng = np.random.default_rng(seed)
    Ms = rng.normal(size=(batch, n, n))
    qp = dict(Q=Ms @ Ms.transpose(0, 2, 1) + n * np.eye(n),
              c=rng.normal(size=(batch, n)),
              Aeq=np.zeros((batch, 0, n)), beq=np.zeros((batch, 0)),
              Aineq=rng.normal(size=(batch, mi, n)),
              bineq=rng.uniform(0.5, 1.5, size=(batch, mi)),
              lb=rng.uniform(-2.0, -0.5, size=(batch, n)),
              ub=rng.uniform(0.5, 2.0, size=(batch, n)))
    opts = tt.SolverOptions(max_iter=60, early_exit=False, polish=False)
    C, l, u, rho = (t.numpy() for t in
                    stack_constraints(qp_from_numpy(qp), opts))
    K = qp["Q"] + opts.sigma * np.eye(n) + (C.transpose(0, 2, 1)
                                            * rho[:, None, :]) @ C
    m = C.shape[1]
    args = (np.linalg.inv(K), C, qp["c"], l, u, rho,
            0.3 * rng.normal(size=(batch, n)),
            0.2 * rng.normal(size=(batch, m)),
            np.clip(0.3 * rng.normal(size=(batch, m)), l, u))
    return qp, opts, [a.astype(dtype) for a in args]


def test_general_plain_matches_pallas_kernel():
    """``admm_general_plain`` (and the CPU wrapper, which is the plain
    version and counts no launch) against the Pallas per-lane general
    kernel in interpret mode: -inf lower bounds on the inequality rows,
    warm starts."""
    _, opts, args = _general_arrays()
    want = jax_fused_general(*map(jnp.asarray, args), n_iter=opts.max_iter,
                             interpret=True, **SC)
    before = ak.fused_admm_general.launches
    got = ak.fused_admm_general(*(torch.tensor(a) for a in args),
                                n_iter=opts.max_iter, **SC)
    assert ak.fused_admm_general.launches == before
    for name, g, w in zip("xyz", got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4, err_msg=name)


def test_general_plain_is_the_fixed_count_iteration_of_solve_qp():
    """The kernel's update, term for term: from zero warm starts in f64 the
    plain version gives ``solve_qp_batched`` at the fixed-count settings
    (no scaling, explicit inverse, no refinement, no polish) to 1e-9."""
    qp, opts, args = _general_arrays(dtype=np.float64)
    B, m, n = args[1].shape
    args[6:] = [np.zeros((B, n)), np.zeros((B, m)), np.zeros((B, m))]
    x, y, z = ak.admm_general_plain(*(torch.tensor(a) for a in args),
                                    n_iter=opts.max_iter, **SC)
    sol = tt.solve_qp_batched(qp_from_numpy(qp), opts.replace(
        scaling=0, row_normalize=False, kkt_solve="inverse", kkt_refine=0,
        infeasibility_detection=False, seed="zero"))
    for g, w in ((x, sol.x), (y, sol.y), (z, sol.z)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-9)


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    Mx = rng.normal(size=(B, n, n))
    return Mx @ Mx.transpose(0, 2, 1) + np.eye(n) / 1e4 * n


@pytest.mark.parametrize("B,n,pallas", [(3, 4, False), (130, 10, True),
                                        (64, 33, False)])
def test_chol_plain_matches_reference(B, n, pallas):
    """The reference's shapes in f64 against ``jnp.linalg.cholesky`` (1e-9,
    its own bound) and, at one of them, against its Pallas kernel in
    interpret mode; the CPU wrapper is the plain version."""
    K = _spd(B, n, seed=n)
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(K)))
    before = ck.chol_batched.launches
    got = ck.chol_batched(torch.tensor(K))
    assert ck.chol_batched.launches == before
    assert torch.equal(got, ck.chol_plain(torch.tensor(K)))
    assert got.dtype == torch.float64 and tuple(got.shape) == (B, n, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    assert float(torch.triu(got, 1).abs().max()) == 0.0
    if pallas:
        kern = np.asarray(jax_chol_batched(jnp.asarray(K), interpret=True))
        np.testing.assert_allclose(got.numpy(), kern, rtol=1e-9, atol=1e-9)
    got32 = ck.chol_plain(torch.tensor(K, dtype=torch.float32))
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want, rtol=2e-3, atol=2e-3)


def test_chol_plain_mpc_conditioning_size_rule_and_nan():
    """Spectra spread 1e-6..1e4 with the sigma + rho ridge reconstruct to
    1e-12 relative; n = 200 takes the size rule's route
    (``torch.linalg.cholesky``) and agrees with the reference's; a matrix
    that is not positive definite gives NaN, not an error, on both
    routes."""
    B, n = 16, 24
    rng = np.random.default_rng(0)
    V = np.linalg.qr(rng.normal(size=(B, n, n)))[0]
    K = (V * np.logspace(-6, 4, n)) @ V.transpose(0, 2, 1) \
        + (1e-6 + 0.1) * np.eye(n)
    L = ck.chol_batched(torch.tensor(K))
    assert bool(torch.isfinite(L).all())
    assert float((L @ L.mT - torch.tensor(K)).abs().max()) / np.abs(K).max() \
        < 1e-12
    big = _spd(2, 200, seed=3)
    np.testing.assert_allclose(
        ck.chol_batched(torch.tensor(big)).numpy(),
        np.asarray(jax_chol_batched(jnp.asarray(big), interpret=True)),
        rtol=1e-9, atol=1e-9)
    for bad in (K.copy(), big.copy()):
        bad[1, 5, 5] = -1.0
        Lb = ck.chol_batched(torch.tensor(bad))
        assert bool(torch.isnan(Lb[1]).any())
        assert bool(torch.isfinite(Lb[0]).all())
    with pytest.raises(ValueError, match=r"\[B, n, n\]"):
        ck.chol_batched(torch.tensor(K[0]))
    with pytest.raises(TypeError):
        ck.chol_batched(torch.tensor(K).to(torch.int64))


def _box_qps(batch, n, seed):
    rng = np.random.default_rng(seed)
    Ms = rng.normal(size=(batch, n, n))
    return dict(Q=Ms @ Ms.transpose(0, 2, 1) + n * np.eye(n),
                c=rng.normal(size=(batch, n)), Aeq=np.zeros((0, n)),
                beq=np.zeros(0), Aineq=np.zeros((0, n)), bineq=np.zeros(0),
                lb=rng.uniform(-2.0, -0.5, size=(batch, n)),
                ub=rng.uniform(0.5, 2.0, size=(batch, n)))


def _f32(qp):
    return {k: v.astype(np.float32) for k, v in qp.items()}


def test_solve_qp_batched_fused_matches_reference():
    """The batched fused entry point against the reference's (its Pallas
    kernel in interpret mode), f32, 200 iterations, no polish: x within
    1e-4, equal statuses and residuals to 1e-2 relative; and against the
    port's own ``solve_qp_batched`` in f64 (the reference's 1e-3 / 1e-4
    bound)."""
    qp = _box_qps(8, 12, seed=5)
    kw = dict(max_iter=200, early_exit=False, polish=False)
    want = jax_solve_fused(
        ct.DenseQP(**{k: jnp.asarray(v) for k, v in _f32(qp).items()}),
        ct.SolverOptions(**kw))
    before = ak.fused_admm_box.launches
    got = ak.solve_qp_batched_fused(qp_from_numpy(_f32(qp)),
                                    tt.SolverOptions(**kw))
    assert ak.fused_admm_box.launches == before      # CPU: the plain version
    assert got.x.dtype == torch.float32 and tuple(got.status.shape) == (8,)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_allclose(got.dual_residual.numpy(),
                               np.asarray(want.dual_residual), rtol=1e-2,
                               atol=1e-5)
    ref = tt.solve_qp_batched(qp_from_numpy(qp), tt.SolverOptions(**kw))
    np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_solve_qp_batched_fused_with_polish_and_warm():
    """With polish the fused solve meets the native oracle (5e-4, f32), and
    a warm restart from its own solution stays there."""
    qp = _box_qps(4, 10, seed=6)
    tqp = qp_from_numpy(_f32(qp))
    opts = tt.SolverOptions(max_iter=500, early_exit=False, polish=True)
    s1 = ak.solve_qp_batched_fused(tqp, opts)
    s2 = ak.solve_qp_batched_fused(tqp, opts, tt.WarmStart(x=s1.x, y=s1.y,
                                                          z=s1.z))
    assert float((s2.x - s1.x).abs().max()) <= 1e-5
    assert (s1.status.numpy() == tt.STATUS_SOLVED).all()
    for b in range(4):
        exact = tt.solve_qp_native(tt.DenseQP.create(
            qp["Q"][b], qp["c"][b], lb=qp["lb"][b], ub=qp["ub"][b]))
        np.testing.assert_allclose(s1.x[b].numpy(), exact.x.numpy(),
                                   atol=5e-4)
    rows = dict(_f32(qp), Aineq=np.ones((1, 10), np.float32),
                bineq=np.ones(1, np.float32))
    with pytest.raises(ValueError, match="box-only"):
        ak.solve_qp_batched_fused(qp_from_numpy(rows), opts)
    one = {k: (v[0] if v.ndim == 3 or k in ("c", "lb", "ub") else v)
           for k, v in _f32(qp).items()}
    with pytest.raises(ValueError, match="rank 3"):
        ak.solve_qp_batched_fused(qp_from_numpy(one), opts)
