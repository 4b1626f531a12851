"""The port's box-ADMM kernel module against the JAX reference.

The plain PyTorch version is held against ``xla_admm_box`` (rank-3 and
rank-2 operators) and against the Pallas ``fused_admm_box_lanes`` in
interpret mode for the K-free x0 = 0 body and the n_iter = 0 pass.  The
general body takes distinct non-zero y0 and z0 and is held only against
``xla_admm_box``: the reference's general lanes body swaps y0 and z0
(``_lanes_box_kernel``), which zero warm starts cannot show.  Tolerances:
2e-4 absolute in f32 after 30 iterations (the reference's own kernel test,
``test_pallas_kernels.py``), 1e-10 in f64 (same updates, other summation
order).  The CUDA kernel against the plain version is in
``test_torch_kernel_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copra_tpu.ops.admm_kernel import (fused_admm_box_lanes as jax_lanes,
                                       pack_lanes_operator, xla_admm_box)
from copra_tpu_torch import set_default_device
from copra_tpu_torch.ops import admm_kernel as ak

set_default_device("cpu")

ITERS = 30
SC = dict(sigma=1e-6, alpha=1.6, rho=0.2)
TOL = {np.float32: 2e-4, np.float64: 1e-10}


def _problem(B=12, n=11, dtype=np.float32, shared=False, seed=0):
    rng = np.random.default_rng(seed)
    Ms = rng.normal(size=(1 if shared else B, n, n))
    Q = np.einsum("bij,bkj->bik", Ms, Ms) + 0.5 * np.eye(n)
    K = Q + (SC["sigma"] + SC["rho"]) * np.eye(n)
    Kinv = np.linalg.inv(K)
    if shared:
        K, Kinv = K[0], Kinv[0]
    c = rng.normal(size=(B, n))
    l = np.full((B, n), -0.5)
    u = np.full((B, n), 0.5)
    x0 = 0.3 * rng.normal(size=(B, n))
    y0 = 0.2 * rng.normal(size=(B, n))
    z0 = np.clip(0.3 * rng.normal(size=(B, n)), l, u)
    return [a.astype(dtype) for a in (Kinv, K, c, l, u, x0, y0, z0)]


def _torch(arrays):
    return [torch.tensor(a) for a in arrays]


def _close(got, want, dtype, what):
    """Each of (x, y, z, g) within the tolerance of ``dtype``."""
    for name, g, w in zip("xyzg", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL[dtype], err_msg=f"{what} {name}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("refine", [0, 1])
def test_plain_general_matches_xla_twin(dtype, shared, refine):
    args = _problem(dtype=dtype, shared=shared)
    want = xla_admm_box(*map(jnp.asarray, args), n_iter=ITERS,
                        refine=refine, **SC)
    got = ak.admm_box_plain(*_torch(args), n_iter=ITERS, refine=refine,
                            **SC)
    # the twin's shared-operator product returns f32 whatever the inputs
    # (preferred_element_type=float32), so rank 2 is f32-exact at best
    _close(got, want, np.float32 if shared else dtype, "general")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_x0_zero_matches_pallas_lanes_kernel(dtype):
    Kinv, K, c, l, u, x0, y0, z0 = _problem(dtype=dtype, seed=1)
    want = jax_lanes(pack_lanes_operator(jnp.asarray(Kinv)),
                     pack_lanes_operator(jnp.asarray(K)), c, l, u, x0, y0,
                     z0, n_iter=ITERS, assume_x0_zero=True, interpret=True,
                     **SC)
    got = ak.admm_box_plain(*_torch((Kinv, K, c, l, u, x0, y0, z0)),
                            n_iter=ITERS, assume_x0_zero=True, **SC)
    _close(got, want, dtype, "x0 = 0")
    # the same iteration from x0 = 0 in the general body (g through K)
    zero = np.zeros_like(x0)
    twin = xla_admm_box(*map(jnp.asarray, (Kinv, K, c, l, u, zero, y0, z0)),
                        n_iter=ITERS, **SC)
    _close(got, twin, dtype, "x0 = 0 vs twin")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_qx_pass_matches_pallas_lanes_kernel(dtype):
    Kinv, K, c, l, u, x0, y0, z0 = _problem(dtype=dtype, seed=2)
    want = jax_lanes(pack_lanes_operator(jnp.asarray(Kinv)),
                     pack_lanes_operator(jnp.asarray(K)), c, l, u, x0, y0,
                     z0, n_iter=0, interpret=True, **SC)
    got = ak.admm_box_plain(*_torch((Kinv, K, c, l, u, x0, y0, z0)),
                            n_iter=0, **SC)
    _close(got, want, dtype, "n_iter = 0")
    Q = K.astype(np.float64) - (SC["sigma"] + SC["rho"]) * np.eye(K.shape[-1])
    np.testing.assert_allclose(got[3].numpy(),
                               np.einsum("bij,bi->bj", Q, x0),
                               rtol=0, atol=TOL[dtype])


def test_kernel_mode_selection():
    assert ak.kernel_mode(30, 0, True) == ak.MODE_X0_ZERO
    assert ak.kernel_mode(0, 0, True) == ak.MODE_QX
    assert ak.kernel_mode(0, 1, False) == ak.MODE_QX
    assert ak.kernel_mode(30, 0, False) == ak.MODE_GENERAL
    assert ak.kernel_mode(30, 1, True) == ak.MODE_GENERAL


def test_wrappers_on_cpu_tensors_take_the_plain_version():
    args = _torch(_problem(seed=3))
    before = (ak.fused_admm_box_lanes.launches, ak.fused_admm_box.launches)
    for kw in (dict(n_iter=ITERS, assume_x0_zero=True), dict(n_iter=0),
               dict(n_iter=ITERS, refine=1)):
        got = ak.fused_admm_box_lanes(*args, **kw, **SC)
        want = ak.admm_box_plain(*args, **kw, **SC)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = ak.fused_admm_box(*args, n_iter=ITERS, **SC)
    want = ak.admm_box_plain(*args, n_iter=ITERS, refine=1, **SC)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (ak.fused_admm_box_lanes.launches,
            ak.fused_admm_box.launches) == before
