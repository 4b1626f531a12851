"""The CUDA kernel of ``copra_tpu_torch`` against its plain PyTorch version,
on the card.  Skips without a CUDA device.  Imports no JAX, so on a GPU host
without JAX it runs with ``--noconftest``:

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda --noconftest \
        -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from copra_tpu_torch.ops import admm_kernel as ak

ITERS = 30
SC = dict(sigma=1e-6, alpha=1.6, rho=0.2)


def _problem(B, n, shared=False, seed=0):
    """Well-conditioned SPD operators (Q = M M' + 0.5 I) and distinct
    non-zero x0, y0, z0, as the reference's kernel test builds them."""
    rng = np.random.default_rng(seed)
    Ms = rng.normal(size=(1 if shared else B, n, n))
    Q = np.einsum("bij,bkj->bik", Ms, Ms) + 0.5 * np.eye(n)
    K = Q + (SC["sigma"] + SC["rho"]) * np.eye(n)
    Kinv = np.linalg.inv(K)
    if shared:
        K, Kinv = K[0], Kinv[0]
    l = np.full((B, n), -0.5)
    u = np.full((B, n), 0.5)
    vecs = (rng.normal(size=(B, n)), l, u, 0.3 * rng.normal(size=(B, n)),
            0.2 * rng.normal(size=(B, n)),
            np.clip(0.3 * rng.normal(size=(B, n)), l, u))
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in (Kinv, K, *vecs)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(150, 13), (64, 100), (8, 128)])
def test_cuda_kernel_matches_plain_version(cuda, B, n):
    """Each mode within 2e-4 of the plain version after 30 f32 iterations
    (the reference's kernel tolerance); one launch counted per call."""
    args = _problem(B, n, seed=n)
    for kw in (dict(n_iter=ITERS, assume_x0_zero=True), dict(n_iter=0),
               dict(n_iter=ITERS, refine=1)):
        before = ak.fused_admm_box_lanes.launches
        got = ak.fused_admm_box_lanes(*args, **kw, **SC)
        assert ak.fused_admm_box_lanes.launches == before + 1
        want = ak.admm_box_plain(*args, **kw, **SC)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 2e-4, kw
    before = ak.fused_admm_box.launches
    got = ak.fused_admm_box(*args, n_iter=ITERS, **SC)
    assert ak.fused_admm_box.launches == before + 1
    want = ak.admm_box_plain(*args, n_iter=ITERS, refine=1, **SC)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 2e-4


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    shared = _problem(4, 10, shared=True)
    with pytest.raises(ValueError, match="fused_admm_box_shared"):
        ak.fused_admm_box(*shared, n_iter=ITERS, **SC)
    big = _problem(2, 200)
    with pytest.raises(ValueError, match="shared memory"):
        ak.fused_admm_box(*big, n_iter=1, **SC)
    args = _problem(4, 10)
    with pytest.raises(TypeError):
        ak.fused_admm_box_lanes(*(t.double() for t in args), n_iter=1, **SC)
    with pytest.raises(ValueError, match="contiguous"):
        ak.fused_admm_box_lanes(args[0].mT, *args[1:], n_iter=1, **SC)
