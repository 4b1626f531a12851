"""The shared-operator CUDA kernels of ``copra_tpu_torch`` (box ADMM,
``csrc/admm_box_shared.cu``; general ADMM, ``csrc/admm_general_shared.cu``)
against their plain PyTorch versions, on the card.  Skips without a CUDA
device.  Imports no JAX, so on a GPU host without JAX it runs with
``--noconftest``:

    python -m pytest tests/test_torch_shared_cuda.py -m cuda --noconftest \
        -o addopts="" -p no:cacheprovider

Tolerance: 2e-4 x max(1, max |plain|) after 30 f32 iterations on
well-conditioned operators (the reference's kernel tolerance); the two sum
each product in another order.
"""

import numpy as np
import pytest
import torch

from copra_tpu_torch.ops import admm_kernel as ak

ITERS = 30
SC = dict(sigma=1e-6, alpha=1.6, rho=0.2)
GSC = dict(sigma=1e-6, alpha=1.6)


def _cuda(*arrays):
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in arrays]


def _box(B, n, seed=0):
    """Shared SPD operators (Q = M M' / n + 0.5 I) and distinct non-zero
    c, x0, y0, z0."""
    rng = np.random.default_rng(seed)
    Mx = rng.normal(size=(n, n))
    Q = Mx @ Mx.T / n + 0.5 * np.eye(n)
    K = Q + (SC["sigma"] + SC["rho"]) * np.eye(n)
    l = np.full((B, n), -0.5)
    u = np.full((B, n), 0.5)
    return _cuda(np.linalg.inv(K), K, 0.3 * rng.normal(size=(B, n)), l, u,
                 0.3 * rng.normal(size=(B, n)), 0.2 * rng.normal(size=(B, n)),
                 np.clip(0.3 * rng.normal(size=(B, n)), l, u))


def _general(B, n, m, seed=0):
    """Shared normalised C = [random rows; I], rho per row, -inf lower
    bounds on some inequality rows, distinct non-zero e0, y0, z0."""
    rng = np.random.default_rng(seed)
    C = np.concatenate([rng.normal(size=(m - n, n)), np.eye(n)])
    C /= np.linalg.norm(C, axis=1, keepdims=True)
    rho = np.full(m, 0.3)
    rho[:2] *= 10.0
    Mx = rng.normal(size=(n, n))
    K = Mx @ Mx.T / n + (1.0 + 1e-6) * np.eye(n) + (C.T * rho) @ C
    l = -0.4 + 0.1 * rng.normal(size=(B, m))
    u = l + 0.8
    l[:, 2:(m - n) // 2] = -np.inf
    u[:, :2] = l[:, :2]
    return _cuda(np.linalg.inv(K), K, C, rho, l, u,
                 0.2 * rng.normal(size=(B, n)), 0.1 * rng.normal(size=(B, m)),
                 np.clip(0.2 * rng.normal(size=(B, m)), l, u))


def _agree(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        tol = 2e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(4096, 10), (77, 10), (300, 256), (45, 33),
                                 (64, 16), (40, 17)])
def test_shared_box_kernel_matches_plain_version(cuda, B, n):
    """refine 0 and 1, B off the 32-lane tile, n from the resident case
    (n <= 16) to the streamed roofline width; one launch per call."""
    args = _box(B, n, seed=n)
    for refine in (0, 1):
        before = ak.fused_admm_box_shared.launches
        got = ak.fused_admm_box_shared(*args, n_iter=ITERS, refine=refine,
                                       **SC)
        assert ak.fused_admm_box_shared.launches == before + 1
        _agree(got, ak.admm_box_plain(*args, n_iter=ITERS, refine=refine,
                                      **SC))
    # n_iter = 0: the pure g = x0 K - (sigma + rho) x0 pass
    _agree(ak.fused_admm_box_shared(*args, n_iter=0, **SC),
           ak.admm_box_plain(*args, n_iter=0, **SC))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m", [(4096, 10, 95), (21, 4, 10), (50, 40, 90),
                                   (33, 20, 140)])
def test_shared_general_kernel_matches_plain_version(cuda, B, n, m):
    """refine 0 and 1, B off the 8-lane block, both instantiations
    (n <= 32 and m <= 128, then n <= 64 and m <= 256); one launch per
    call."""
    args = _general(B, n, m, seed=m)
    for refine in (0, 1):
        before = ak.fused_admm_general_shared.launches
        got = ak.fused_admm_general_shared(*args, n_iter=ITERS,
                                           refine=refine, **GSC)
        assert ak.fused_admm_general_shared.launches == before + 1
        _agree(got, ak.admm_general_shared_plain(*args, n_iter=ITERS,
                                                 refine=refine, **GSC))


@pytest.mark.cuda
def test_shared_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    box = _box(8, 12)
    with pytest.raises(TypeError):
        ak.fused_admm_box_shared(*(t.double() for t in box), n_iter=1, **SC)
    with pytest.raises(ValueError, match="contiguous"):
        ak.fused_admm_box_shared(box[0].mT, *box[1:], n_iter=1, **SC)
    with pytest.raises(ValueError, match="shape"):
        ak.fused_admm_box_shared(box[0][:-1], *box[1:], n_iter=1, **SC)
    with pytest.raises(ValueError, match="cpu"):
        ak.fused_admm_box_shared(*box[:2], box[2].cpu(), *box[3:], n_iter=1,
                                 **SC)
    with pytest.raises(ValueError, match="n <= 256"):
        ak.fused_admm_box_shared(*_box(4, 257), n_iter=1, **SC)
    with pytest.raises(ValueError, match="shared"):
        ak.fused_admm_box_lanes(*box, n_iter=1, **SC)
    gen = _general(8, 6, 20)
    with pytest.raises(TypeError):
        ak.fused_admm_general_shared(*(t.double() for t in gen), n_iter=1,
                                     **GSC)
    with pytest.raises(ValueError, match="contiguous"):
        ak.fused_admm_general_shared(*gen[:4], gen[4].mT.contiguous().mT,
                                     *gen[5:], n_iter=1, **GSC)
    with pytest.raises(ValueError, match="shape"):
        ak.fused_admm_general_shared(*gen[:3], gen[3][:-1], *gen[4:],
                                     n_iter=1, **GSC)
    with pytest.raises(ValueError, match="n <= 64"):
        ak.fused_admm_general_shared(*_general(4, 70, 80), n_iter=1, **GSC)
