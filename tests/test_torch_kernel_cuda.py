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
    """Well-conditioned SPD operators (Q = M M' + 0.5 I, and M M' / n +
    0.5 I above n = 128: unscaled, cond(K) grows like n, and at n = 1024
    two f32 summation orders part by ~1e-3 whatever the kernel) and
    distinct non-zero x0, y0, z0, as the reference's kernel test builds
    them."""
    rng = np.random.default_rng(seed)
    Ms = rng.normal(size=(1 if shared else B, n, n))
    Q = (np.einsum("bij,bkj->bik", Ms, Ms) / (1.0 if n <= 128 else n)
         + 0.5 * np.eye(n))
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


def _held(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(150, 13), (64, 100), (8, 128), (8, 240),
                                 (8, 241), (4, 300), (2, 1024), (2000, 100)])
def test_cuda_kernel_matches_plain_version(cuda, B, n):
    """Each mode and each body that takes n (the register body up to n =
    128, the streamed body at every n; at B = 2000 a register-body block
    serves several lanes) within 2e-4 of the plain version
    after 30 f32 iterations (the reference's kernel tolerance), from
    distinct non-zero y0 and z0; the x0 = 0 body ignores x0; one launch
    counted per call."""
    args = _problem(B, n, seed=n)
    modes = (dict(n_iter=ITERS, assume_x0_zero=True), dict(n_iter=0),
             dict(n_iter=ITERS, refine=1), dict(n_iter=ITERS, refine=0))
    for kw in modes:
        before = ak.fused_admm_box_lanes.launches
        got = ak.fused_admm_box_lanes(*args, **kw, **SC)
        assert ak.fused_admm_box_lanes.launches == before + 1
        want = ak.admm_box_plain(*args, **kw, **SC)
        torch.cuda.synchronize()
        _held(got, want)
        if kw["n_iter"] == 0:
            continue
        for body in ("register", "streamed"):
            if body == "register" and n > ak.BOX_REGISTER_MAX_N:
                continue
            full = {"refine": 0, "assume_x0_zero": False, **kw}
            _held(ak._launch(*args, body=body, **full, **SC), want)
    # the x0 = 0 body starts from x = 0 whatever x0 holds
    zero_x0 = [*args[:5], torch.zeros_like(args[5]), *args[6:]]
    kw = dict(n_iter=ITERS, assume_x0_zero=True, **SC)
    for g, w in zip(ak.fused_admm_box_lanes(*args, **kw),
                    ak.fused_admm_box_lanes(*zero_x0, **kw)):
        assert torch.equal(g, w)
    for refine in (0, 1):
        before = ak.fused_admm_box.launches
        got = ak.fused_admm_box(*args, n_iter=ITERS, refine=refine, **SC)
        assert ak.fused_admm_box.launches == before + 1
        _held(got, ak.admm_box_plain(*args, n_iter=ITERS, refine=refine,
                                     **SC))


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    shared = _problem(4, 10, shared=True)
    with pytest.raises(ValueError, match="fused_admm_box_shared"):
        ak.fused_admm_box(*shared, n_iter=ITERS, **SC)
    big = [torch.zeros((1, 1025, 1025), device="cuda")] * 2 + \
        [torch.zeros((1, 1025), device="cuda")] * 6
    with pytest.raises(ValueError, match="use_fused=False"):
        ak.fused_admm_box(*big, n_iter=1, **SC)
    args = _problem(4, 10)
    with pytest.raises(TypeError):
        ak.fused_admm_box_lanes(*(t.double() for t in args), n_iter=1, **SC)
    with pytest.raises(ValueError, match="contiguous"):
        ak.fused_admm_box_lanes(args[0].mT, *args[1:], n_iter=1, **SC)
