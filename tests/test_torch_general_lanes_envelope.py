"""The shape envelope of the port's per-lane general ADMM kernel, on the CPU.

The kernel (``csrc/admm_general.cu``) takes every n <= 256 with m <= 1024,
as the reference's Pallas ``fused_admm_general`` serves per-lane problems of
any width its VMEM budget allows.  Here: the launch plan that
``ops/admm_kernel.general_lanes_config`` mirrors from the CUDA source
(checked against the C side when the library loads on the card), its
refusals, and the plain version the wrapper runs on CPU tensors at widths
the former envelope (n <= 128, m <= 384) refused: against the Pallas kernel
in interpret mode at (n, m) = (160, 400) (2e-4 x max(1, max |ref|) after 5
f32 iterations, the reference's kernel tolerance), and in float64 against
``solve_qp_batched`` at the fixed-count settings at (150, 300) (1e-9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu_torch as tt
from copra_tpu.ops.admm_kernel import fused_admm_general as jax_fused_general
from copra_tpu_torch.convert import qp_from_numpy
from copra_tpu_torch.ops import admm_kernel as ak
from copra_tpu_torch.qp.admm import stack_constraints

tt.set_default_device("cpu")

SC = dict(sigma=1e-6, alpha=1.6)


@pytest.mark.parametrize("n,m,body", [
    (1, 1, 1), (2, 32, 1), (2, 33, 1), (10, 64, 1), (10, 65, 1), (10, 85, 1),
    (15, 96, 1), (16, 96, 1), (16, 17, 1), (17, 96, 2), (16, 97, 2),
    (1, 97, 2), (40, 90, 2), (128, 384, 2), (129, 140, 2), (100, 400, 2),
    (256, 1, 2), (256, 1024, 2)])
def test_general_lanes_plan_covers_the_envelope(n, m, body):
    """The register body for n <= 16 and m <= 96 (config 2's class: 8
    lanes of 16 threads a block, m <= 16 row slots, n rounded up to 2
    columns, no shared memory), the wide body for every other shape up to
    (256, 1024) (a warp per lane and block, 7 m + 4 n floats of shared
    memory, within the 48 KB a block takes without opting in)."""
    cfg = ak.general_lanes_config(n, m)
    assert cfg[0] == body
    assert ak.general_lanes_config(n, m, "wide")[0] == 2
    if body == 1:
        _, rs, cs, lanes, threads, smem = cfg
        assert rs in (2, 4, 6) and 16 * (rs - 2) < m <= 16 * rs
        assert cs % 2 == 0 and n <= cs < n + 2
        assert (lanes, threads, smem) == (8, 128, 0)
        assert ak.general_lanes_config(n, m, "register") == cfg
    else:
        assert cfg[1:5] == (0, 0, 1, 32)
        assert 4 * (7 * m + 4 * n) <= cfg[5] <= 48 * 1024
        assert cfg[5] % 16 == 0
        with pytest.raises(ValueError, match="register"):
            ak.general_lanes_config(n, m, "register")


@pytest.mark.parametrize("n,m", [(0, 10), (257, 300), (10, 0), (10, 1025)])
def test_general_lanes_plan_refuses_outside_the_envelope(n, m):
    with pytest.raises(ValueError, match="solve_qp_batched"):
        ak.general_lanes_config(n, m)


def _per_lane(B, n, m, seed, dtype=np.float32):
    """Per-lane C = [random rows; I] normalised, rho per lane and row (two
    equality rows 10x), -inf lower bounds on some inequality rows, +-inf on
    the last row, a linear term and distinct non-zero x0, y0, z0."""
    rng = np.random.default_rng(seed)
    C = np.concatenate([rng.normal(size=(B, m - n, n)),
                        np.repeat(np.eye(n)[None], B, 0)], axis=1)
    C /= np.linalg.norm(C, axis=2, keepdims=True)
    rho = np.full((B, m), 0.3) * rng.uniform(0.5, 2.0, size=(B, 1))
    rho[:, :2] *= 10.0
    Mx = rng.normal(size=(B, n, n))
    K = (Mx @ Mx.transpose(0, 2, 1) / n + (1.0 + 1e-6) * np.eye(n)
         + (C.transpose(0, 2, 1) * rho[:, None, :]) @ C)
    l = -0.4 + 0.1 * rng.normal(size=(B, m))
    u = l + 0.8
    l[:, 2:(m - n) // 2] = -np.inf
    u[:, :2] = l[:, :2]
    l[:, -1], u[:, -1] = -np.inf, np.inf
    arrays = (np.linalg.inv(K), C, 0.3 * rng.normal(size=(B, n)), l, u, rho,
              0.2 * rng.normal(size=(B, n)), 0.1 * rng.normal(size=(B, m)),
              np.clip(0.2 * rng.normal(size=(B, m)), l, u))
    return [a.astype(dtype) for a in arrays]


def test_general_plain_matches_pallas_kernel_past_the_former_envelope():
    """``fused_admm_general`` on CPU tensors (its plain version, no launch)
    against the Pallas per-lane general kernel in interpret mode at n =
    160, m = 400, from warm starts."""
    args = _per_lane(2, 160, 400, seed=9)
    want = jax_fused_general(*map(jnp.asarray, args), n_iter=5,
                             interpret=True, **SC)
    before = ak.fused_admm_general.launches
    got = ak.fused_admm_general(*(torch.tensor(a) for a in args), n_iter=5,
                                **SC)
    assert ak.fused_admm_general.launches == before
    tol = 2e-4 * max(1.0, max(float(np.abs(np.asarray(w)).max())
                              for w in want))
    for name, g, w in zip("xyz", got, want):
        assert tuple(g.shape) == w.shape and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol, err_msg=name)


def test_general_plain_is_solve_qp_at_n_150_m_300():
    """In float64 from zero warm starts the plain version is
    ``solve_qp_batched`` at the fixed-count settings (no scaling, explicit
    inverse, no refinement, no polish) to 1e-9, at a width the former
    envelope refused: n = 150, 150 inequality rows and 150 box rows."""
    B, n, mi = 2, 150, 150
    rng = np.random.default_rng(4)
    Ms = rng.normal(size=(B, n, n))
    qp = dict(Q=Ms @ Ms.transpose(0, 2, 1) + n * np.eye(n),
              c=rng.normal(size=(B, n)),
              Aeq=np.zeros((B, 0, n)), beq=np.zeros((B, 0)),
              Aineq=rng.normal(size=(B, mi, n)),
              bineq=rng.uniform(0.5, 1.5, size=(B, mi)),
              lb=rng.uniform(-2.0, -0.5, size=(B, n)),
              ub=rng.uniform(0.5, 2.0, size=(B, n)))
    opts = tt.SolverOptions(max_iter=60, early_exit=False, polish=False,
                            scaling=0, row_normalize=False,
                            kkt_solve="inverse", kkt_refine=0,
                            infeasibility_detection=False, seed="zero")
    C, l, u, rho = stack_constraints(qp_from_numpy(qp), opts)
    m = C.shape[1]
    assert m == 300
    K = (torch.tensor(qp["Q"]) + opts.sigma * torch.eye(n, dtype=C.dtype)
         + (C.mT * rho[:, None, :]) @ C)
    x, y, z = ak.admm_general_plain(
        torch.linalg.inv(K), C, torch.tensor(qp["c"]), l, u, rho,
        torch.zeros(B, n, dtype=C.dtype), torch.zeros(B, m, dtype=C.dtype),
        torch.zeros(B, m, dtype=C.dtype), n_iter=opts.max_iter, **SC)
    sol = tt.solve_qp_batched(qp_from_numpy(qp), opts)
    for g, w in ((x, sol.x), (y, sol.y), (z, sol.z)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-9)
