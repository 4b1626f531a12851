"""The per-lane general ADMM kernel (``csrc/admm_general.cu``) and the batched
Cholesky kernel (``csrc/chol_batched.cu``) of ``copra_tpu_torch`` against
their plain PyTorch versions, on the card.  Skips without a CUDA device.
Imports no JAX, so on a GPU host without JAX it runs with ``--noconftest``:

    python -m pytest tests/test_torch_general_cuda.py -m cuda --noconftest \
        -o addopts="" -p no:cacheprovider

Tolerances: the ADMM kernel 2e-4 x max(1, max |plain|) after 30 f32
iterations on well-conditioned operators (the reference's kernel tolerance;
the two sum each product in another order).  The Cholesky kernel against the
plain recursion: 1e-9 in f64 (the reference's own bound against its
oracle), 2e-5 x max |L| in f32 (the kernel contracts each update into one
FMA, the plain version rounds twice), and the factor reconstructs ``K``.
"""

import numpy as np
import pytest
import torch

from copra_tpu_torch.ops import admm_kernel as ak
from copra_tpu_torch.ops import cholesky_kernel as ck

ITERS = 30
GSC = dict(sigma=1e-6, alpha=1.6)


def _general(B, n, m, seed=0):
    """Per-lane normalised C = [random rows; I], rho per lane and row
    (two equality rows 10x), -inf lower bounds on some inequality rows,
    +-inf on some box rows, a linear term and distinct non-zero x0, y0,
    z0."""
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
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in arrays]


def _spd(B, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    Mx = rng.normal(size=(B, n, n))
    K = Mx @ Mx.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    return torch.tensor(K, dtype=dtype, device="cuda")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m", [(4096, 10, 85), (21, 4, 10), (50, 40, 90),
                                   (13, 128, 384), (33, 20, 140)])
def test_general_kernel_matches_plain_version(cuda, B, n, m):
    """B off the 8-lane block, both instantiations (n <= 32 and m <= 128,
    then up to the envelope n = 128, m = 384), operators staged in shared
    memory and read from global memory; one launch per call."""
    args = _general(B, n, m, seed=m)
    before = ak.fused_admm_general.launches
    got = ak.fused_admm_general(*args, n_iter=ITERS, **GSC)
    assert ak.fused_admm_general.launches == before + 1
    want = ak.admm_general_plain(*args, n_iter=ITERS, **GSC)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        tol = 2e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol
    # n_iter = 0 hands the warm start back
    for g, w in zip(ak.fused_admm_general(*args, n_iter=0, **GSC),
                    (args[6], args[7], args[8])):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n", [(4096, 10), (130, 33), (3, 4), (37, 100),
                                 (5, 128), (9, 32)])
def test_chol_kernel_matches_plain_version(cuda, dtype, B, n):
    """The warp-per-matrix (n <= 32) and block-per-matrix (n <= 128)
    kernels, B off the block size; one launch per call."""
    K = _spd(B, n, dtype, seed=n)
    before = ck.chol_batched.launches
    L = ck.chol_batched(K)
    assert ck.chol_batched.launches == before + 1
    want = ck.chol_plain(K)
    torch.cuda.synchronize()
    assert L.shape == K.shape and L.dtype == dtype
    assert bool(torch.isfinite(L).all())
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    scale = float(want.abs().max())
    tol = 1e-9 if dtype == torch.float64 else 2e-5 * scale
    assert float((L - want).abs().max()) <= tol
    rec = float((L @ L.mT - K).abs().max() / K.abs().max())
    assert rec <= (1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.cuda
def test_chol_kernel_mpc_conditioning_and_nan(cuda):
    """Spectra spread 1e-6..1e4 with the sigma + rho ridge (the reference's
    own case): the f64 factor reconstructs K to 1e-12 relative.  A matrix
    that is not positive definite gives NaN and no error, as the plain
    version does."""
    B, n = 16, 24
    rng = np.random.default_rng(0)
    V = np.linalg.qr(rng.normal(size=(B, n, n)))[0]
    eigs = np.logspace(-6, 4, n)
    K = torch.tensor((V * eigs) @ V.transpose(0, 2, 1)
                     + (1e-6 + 0.1) * np.eye(n), device="cuda")
    L = ck.chol_batched(K)
    assert bool(torch.isfinite(L).all())
    assert float((L @ L.mT - K).abs().max() / K.abs().max()) < 1e-12
    bad = K.clone()
    bad[3, 5, 5] = -1.0
    Lb = ck.chol_batched(bad)
    want = ck.chol_plain(bad)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(Lb), torch.isnan(want))
    assert bool(torch.isnan(Lb[3]).any())
    assert bool(torch.isfinite(Lb[:3]).all() and torch.isfinite(Lb[4:]).all())


@pytest.mark.cuda
def test_general_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    gen = _general(8, 6, 20)
    with pytest.raises(TypeError):
        ak.fused_admm_general(*(t.double() for t in gen), n_iter=1, **GSC)
    with pytest.raises(ValueError, match="contiguous"):
        ak.fused_admm_general(gen[0].mT, *gen[1:], n_iter=1, **GSC)
    with pytest.raises(ValueError, match="shape"):
        ak.fused_admm_general(*gen[:5], gen[5][:, :-1], *gen[6:], n_iter=1,
                              **GSC)
    with pytest.raises(ValueError, match="cpu"):
        ak.fused_admm_general(*gen[:2], gen[2].cpu(), *gen[3:], n_iter=1,
                              **GSC)
    with pytest.raises(ValueError, match="per lane"):
        ak.fused_admm_general(gen[0], gen[1][0], *gen[2:], n_iter=1, **GSC)
    with pytest.raises(ValueError, match="n <= 128"):
        ak.fused_admm_general(*_general(2, 129, 140), n_iter=1, **GSC)
    with pytest.raises(ValueError, match="m <= 384"):
        ak.fused_admm_general(*_general(2, 8, 385), n_iter=1, **GSC)
    K = _spd(4, 12, torch.float32)
    with pytest.raises(TypeError):
        ck.chol_batched(K.half())
    with pytest.raises(ValueError, match="contiguous"):
        ck.chol_batched(K.mT)
    with pytest.raises(ValueError, match=r"\[B, n, n\]"):
        ck.chol_batched(K[0])
    # the one size rule: n > 128 goes to torch.linalg.cholesky, no launch
    big = _spd(2, 200, torch.float64)
    before = ck.chol_batched.launches
    Lb = ck.chol_batched(big)
    assert ck.chol_batched.launches == before
    assert float((Lb - torch.linalg.cholesky(big)).abs().max()) == 0.0
