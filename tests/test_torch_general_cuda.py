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


def _held(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        tol = 2e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m", [(4096, 10, 85), (21, 4, 10), (50, 40, 90),
                                   (13, 128, 384), (33, 20, 140),
                                   (8, 129, 140), (6, 16, 96), (6, 16, 128),
                                   (6, 17, 96), (6, 17, 129), (4, 256, 1024),
                                   (3, 1, 1), (9, 15, 33)])
def test_general_kernel_matches_plain_version(cuda, B, n, m):
    """B off the 8-lane block, the register body (n <= 16, m <= 96) and the
    wide body on both sides of the crossover, past the former envelope
    (n = 128, m = 384) up to the new one (n = 256, m = 1024); one launch
    per call."""
    args = _general(B, n, m, seed=m)
    before = ak.fused_admm_general.launches
    got = ak.fused_admm_general(*args, n_iter=ITERS, **GSC)
    assert ak.fused_admm_general.launches == before + 1
    want = ak.admm_general_plain(*args, n_iter=ITERS, **GSC)
    torch.cuda.synchronize()
    _held(got, want)
    # n_iter = 0 hands the warm start back
    for g, w in zip(ak.fused_admm_general(*args, n_iter=0, **GSC),
                    (args[6], args[7], args[8])):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m", [(4096, 10, 85), (21, 4, 10), (6, 16, 96),
                                   (9, 1, 1), (17, 7, 33)])
@pytest.mark.parametrize("body", ["register", "wide"])
def test_general_kernel_each_body(cuda, B, n, m, body):
    """Each body forced on shapes both take: the same iteration."""
    args = _general(B, n, m, seed=n + m)
    got = ak._launch_general(*args, n_iter=ITERS, body=body, **GSC)
    want = ak.admm_general_plain(*args, n_iter=ITERS, **GSC)
    torch.cuda.synchronize()
    _held(got, want)


@pytest.mark.cuda
def test_general_kernel_in_a_cuda_graph(cuda):
    """A launch allocates nothing and does not sync the host: captured in
    a CUDA graph and replayed on new inputs copied into the captured
    tensors, it gives what an eager call gives."""
    args = _general(64, 10, 85, seed=1)
    new = _general(64, 10, 85, seed=2)
    ak.fused_admm_general(*args, n_iter=ITERS, **GSC)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ak.fused_admm_general(*args, n_iter=ITERS, **GSC)
    for a, b in zip(args, new):
        a.copy_(b)
    graph.replay()
    want = ak.fused_admm_general(*new, n_iter=ITERS, **GSC)
    torch.cuda.synchronize()
    for g, w in zip(out, want):
        assert torch.equal(g, w)
    _held(out, ak.admm_general_plain(*new, n_iter=ITERS, **GSC))


@pytest.mark.cuda
def test_general_kernel_attributes(cuda):
    """The register body at config 2's shape keeps everything in registers
    (no spills) and several blocks an SM; the wide body at the envelope's
    edge fits the default shared memory."""
    regs, spill, threads, per_sm = ak._general_lanes_attributes(10, 85)
    assert 0 < regs <= 255 and spill == 0 and threads >= 128 and per_sm >= 1
    assert ak._general_lanes_attributes(256, 1024)[3] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n", [(4096, 10), (130, 33), (3, 4), (37, 100),
                                 (5, 128), (9, 32)])
def test_chol_kernel_matches_plain_version(cuda, dtype, B, n):
    """The small body (a group of threads per matrix, n <= 32) and the
    block body (a block per matrix, n <= 128), B off the block size; one
    launch per call."""
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


def _chol_held(L, K, want):
    """``L`` against the plain version's ``want`` and as a factor of
    ``K``: finite, an exactly zero upper triangle, the file's
    tolerances."""
    f64 = K.dtype == torch.float64
    assert L.shape == K.shape and L.dtype == K.dtype
    assert bool(torch.isfinite(L).all())
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    tol = 1e-9 if f64 else 2e-5 * float(want.abs().max())
    assert float((L - want).abs().max()) <= tol
    rec = float((L @ L.mT - K).abs().max() / K.abs().max())
    assert rec <= (1e-12 if f64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 8, 9, 16, 17, 31, 33, 64, 127])
@pytest.mark.parametrize("off", [False, True])
def test_chol_kernel_envelope(cuda, dtype, n, off):
    """Both sides of each group width (8, 16, 32) and of the body
    crossover, and partial tiles of the block body; B = 1, or B off the
    matrices a block holds (a partial warp and block)."""
    mats = ck.chol_config(n, dtype)[3]
    B = 3 * mats + mats // 2 + 1 if off else 1
    K = _spd(B, n, dtype, seed=n + B)
    before = ck.chol_batched.launches
    L = ck.chol_batched(K)
    assert ck.chol_batched.launches == before + 1
    want = ck.chol_plain(K)
    torch.cuda.synchronize()
    _chol_held(L, K, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n", [(4096, 10), (37, 1), (33, 8), (21, 16),
                                 (19, 24), (5, 32)])
@pytest.mark.parametrize("body", ["small", "block"])
def test_chol_kernel_each_body(cuda, dtype, B, n, body):
    """Each body forced on shapes both take: the same factor."""
    K = _spd(B, n, dtype, seed=2 * n)
    L = ck._launch_chol(K, body=body)
    want = ck.chol_plain(K)
    torch.cuda.synchronize()
    _chol_held(L, K, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,body", [(67, 10, "small"), (5, 24, "block"),
                                      (9, 100, "block"), (3, 128, "block")])
def test_chol_kernel_reads_only_the_lower_triangle(cuda, dtype, B, n, body):
    """Garbage in the strict upper triangle of K gives the same L as the
    clean K, bit for bit."""
    K = _spd(B, n, dtype, seed=n)
    G = K.clone()
    iu = torch.triu_indices(n, n, 1, device="cuda")
    G[:, iu[0], iu[1]] = 1e3 * torch.randn(
        B, iu.shape[1], dtype=dtype, device="cuda",
        generator=torch.Generator("cuda").manual_seed(n))
    L = ck._launch_chol(K, body=body)
    Lg = ck._launch_chol(G, body=body)
    torch.cuda.synchronize()
    assert torch.equal(L, Lg)
    _chol_held(L, K, ck.chol_plain(K))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,body", [(3, 6, "small"), (3, 6, "block"),
                                      (70, 10, "small"), (4, 40, "block"),
                                      (3, 128, "block")])
def test_chol_kernel_nan_pattern(cuda, dtype, B, n, body):
    """Fault F8: where pivot 3 fails, the kernel's NaN pattern equals the
    plain version's (the reference's ``L * tril``), above the diagonal
    included; the other matrices of the batch factor as they would
    alone."""
    K = _spd(B, n, dtype, seed=n + 1)
    bad = K.clone()
    bad[1, 3, 3] = -100.0
    L = ck._launch_chol(bad, body=body)
    want = ck.chol_plain(bad)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(L), torch.isnan(want))
    assert bool(torch.isnan(L[1][:, 3:]).all())
    assert bool(torch.isfinite(L[1][:, :3]).all())
    keep = [b for b in range(B) if b != 1]
    assert torch.equal(L[keep], ck._launch_chol(K, body=body)[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 100])
def test_chol_kernel_in_a_cuda_graph(cuda, n):
    """A launch allocates nothing and does not sync the host: captured in
    a CUDA graph and replayed on a new K copied into the captured tensor,
    it gives what an eager call gives."""
    K = _spd(256, n, torch.float32, seed=1)
    new = _spd(256, n, torch.float32, seed=2)
    ck.chol_batched(K)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ck.chol_batched(K)
    K.copy_(new)
    graph.replay()
    want = ck.chol_batched(new)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    _chol_held(out, new, ck.chol_plain(new))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_kernel_attributes(cuda, dtype):
    """Every instantiation keeps its entries in registers (no spills),
    holds at least one block an SM, and declares the shared memory its
    launch plan states."""
    for n, body in ((8, "small"), (16, "small"), (32, "small"),
                    *((16 * t, "block") for t in range(1, 9))):
        regs, spill, threads, per_sm, smem = ck._chol_attributes(n, dtype,
                                                                 body)
        cfg = ck.chol_config(n, dtype, body)
        assert 0 < regs <= 255 and spill == 0, (n, body, regs, spill)
        assert threads >= cfg[2] and per_sm >= 1
        assert smem == cfg[4]


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
    with pytest.raises(ValueError, match="n <= 256"):
        ak.fused_admm_general(*_general(2, 257, 270), n_iter=1, **GSC)
    with pytest.raises(ValueError, match="m <= 1024"):
        ak.fused_admm_general(*_general(2, 8, 1025), n_iter=1, **GSC)
    with pytest.raises(ValueError, match="body"):
        ak._launch_general(*_general(2, 17, 40), n_iter=1, body="register",
                           **GSC)
    K = _spd(4, 12, torch.float32)
    with pytest.raises(TypeError):
        ck.chol_batched(K.half())
    with pytest.raises(ValueError, match="contiguous"):
        ck.chol_batched(K.mT)
    with pytest.raises(ValueError, match=r"\[B, n, n\]"):
        ck.chol_batched(K[0])
    with pytest.raises(ValueError, match="body"):
        ck._launch_chol(_spd(4, 33, torch.float32), body="small")
    # the one size rule: n > 128 goes to torch.linalg.cholesky, no launch
    big = _spd(2, 200, torch.float64)
    before = ck.chol_batched.launches
    Lb = ck.chol_batched(big)
    assert ck.chol_batched.launches == before
    assert float((Lb - torch.linalg.cholesky(big)).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("rho", [0.01, 0.1, 1.0, 10.0])
def test_general_kernel_at_a_served_rho_with_rows_normalised(cuda, rho):
    """The kernel's float32 sums at the rhos ``auto_rho`` chooses among, on
    config 2's per-lane fleet with rows normalised as ``solve_qp``
    normalises them (``chip_smoke.k7_served_rho``, 512 lanes, 400
    iterations), against the plain version run in float64 on the same
    inputs: 2e-4 x max(1, max |plain|)."""
    import chip_smoke
    import copra_tpu_torch as tt

    got, want, tol, _ = chip_smoke.k7_served_rho(
        tt, ak, torch.device("cuda"), rho, batch=512)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
    assert max(float((g.double() - w).abs().max())
               for g, w in zip(got, want)) <= tol
