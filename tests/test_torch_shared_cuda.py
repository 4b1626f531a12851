"""The shared-operator CUDA kernels of ``copra_tpu_torch`` (box ADMM,
``csrc/admm_box_shared.cu``; general ADMM, ``csrc/admm_general_shared.cu``)
against their plain PyTorch versions, on the card.  Skips without a CUDA
device.  Imports no JAX, so on a GPU host without JAX it runs with
``--noconftest``:

    python -m pytest tests/test_torch_shared_cuda.py -m cuda --noconftest \
        -o addopts="" -p no:cacheprovider

Tolerance: 2e-4 x max(1, max |plain|) after 30 f32 iterations on
well-conditioned operators (the reference's kernel tolerance); the two sum
each product in another order.  The general kernel sums in f64 and rounds
each product once, as its plain version does, so it is also held to
1e-6 x max(1, max |plain|).  A CUDA-graph replay must equal the eager call
exactly (same kernel, same inputs, no atomics).
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
@pytest.mark.parametrize("B,n", [
    (4096, 10), (77, 10), (300, 256), (45, 33), (64, 16), (40, 17),
    (4096, 1), (13, 1), (4096, 7), (4096, 16), (4096, 31), (29, 31),
    (4096, 32), (4096, 33), (4096, 64), (97, 64), (4096, 256), (4096, 257),
    (50, 257), (4096, 600), (70, 600), (4096, 1024), (64, 1024)])
def test_shared_box_kernel_matches_plain_version(cuda, B, n):
    """refine 0 and 1, B on and off the lane tile, n across the small body
    (n <= 32), the tile body with bulk copies (n a multiple of 4) and with
    plain copies into padded rows (33, 257), up to n = 1024; one launch
    per call."""
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
@pytest.mark.parametrize("B,n", [(4096, 10), (77, 32), (4096, 33),
                                 (50, 17)])
def test_shared_box_bodies_agree_across_the_crossover(cuda, B, n):
    """Both bodies of the box kernel, forced, at widths either would take:
    the small body up to n = 32 and the tile body below its default
    range."""
    args = _box(B, n, seed=n + 1)
    bodies = ("small", "tile") if n <= ak.BOX_SMALL_MAX_N else ("tile",)
    for refine in (0, 1):
        want = ak.admm_box_plain(*args, n_iter=ITERS, refine=refine, **SC)
        for body in bodies:
            _agree(ak._launch_box_shared(*args, n_iter=ITERS, refine=refine,
                                         body=body, **SC), want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m", [(4096, 10, 95), (21, 4, 10), (50, 40, 90),
                                   (33, 20, 140), (37, 100, 400),
                                   (9, 256, 1024)])
def test_shared_general_kernel_matches_plain_version(cuda, B, n, m):
    """refine 0 and 1, B off the lane blocks, the group body (n <= 16,
    m <= 96) and the wide body above it, up to (256, 1024); one launch per
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
    with pytest.raises(ValueError, match="n <= 1024"):
        ak.fused_admm_box_shared(*_box(4, 1025), n_iter=1, **SC)
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
    with pytest.raises(ValueError, match="n <= 256"):
        ak.fused_admm_general_shared(*_general(4, 257, 300), n_iter=1,
                                     **GSC)
    with pytest.raises(ValueError, match="m <= 1024"):
        ak.fused_admm_general_shared(*_general(4, 10, 1025), n_iter=1,
                                     **GSC)


@pytest.mark.cuda
def test_shared_general_kernel_sums_as_its_plain_version(cuda):
    """Config-2-like shapes (B = 4096, n = 10, m = 85), 30 iterations,
    refine 1: f64 sums rounded once, and the f32 steps between products
    rounded as the plain version's tensor operations round them, hold the
    kernel to 1e-6 x max(1, max |plain|)."""
    args = _general(4096, 10, 85, seed=2)
    kw = dict(n_iter=ITERS, refine=1, **GSC)
    got = ak.fused_admm_general_shared(*args, **kw)
    want = ak.admm_general_shared_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        tol = 1e-6 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m", [(4096, 10, 85), (77, 16, 96),
                                   (45, 3, 7)])
def test_shared_general_bodies_agree(cuda, B, n, m):
    """Each body of the general kernel, forced, at shapes both take: f64
    sums rounded once hold each to 1e-6 x max(1, max |plain|)."""
    args = _general(B, n, m, seed=m + 1)
    kw = dict(n_iter=ITERS, refine=1, **GSC)
    want = ak.admm_general_shared_plain(*args, **kw)
    for body in ak.GENERAL_BODIES:
        got = ak._launch_general_shared(*args, body=body, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            tol = 1e-6 * max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) <= tol, body


def _replayed(fn):
    """``fn()`` eagerly, then captured in a CUDA graph and replayed: both
    results (the first call also builds and loads the kernel, outside the
    capture)."""
    eager = fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    return eager, captured


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 256])
def test_shared_box_kernel_replays_in_a_cuda_graph(cuda, n):
    """One capture of each body and one replay equal the eager call."""
    args = _box(4096, n, seed=7)
    eager, captured = _replayed(lambda: ak.fused_admm_box_shared(
        *args, n_iter=ITERS, refine=1, **SC))
    for e, c in zip(eager, captured):
        assert torch.equal(e, c)


@pytest.mark.cuda
def test_shared_general_kernel_replays_in_a_cuda_graph(cuda):
    args = _general(4096, 10, 85, seed=8)
    eager, captured = _replayed(lambda: ak.fused_admm_general_shared(
        *args, n_iter=ITERS, refine=1, **GSC))
    for e, c in zip(eager, captured):
        assert torch.equal(e, c)


@pytest.mark.cuda
def test_accurate_tick_at_n_300_runs_the_kernel(cuda):
    """A shared plan with n = 300 (beyond the former 256-wide envelope):
    its accurate tick launches the box kernel and its controls agree within
    1e-5 (the library's contract) with the same tick built with
    use_fused=False (the plain iteration)."""
    import copra_tpu_torch as tt

    N, lanes = 300, 64
    rng = np.random.default_rng(3)
    x0s = rng.uniform(-4.0, 4.0, size=(lanes, 1))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    system = tt.LTISystem.create(f32([[0.95]]), f32([[0.1]]), f32([0.0]),
                                 f32(x0s[0]), N)
    costs = (tt.TargetCost.create(np.eye(1), [3.0], weights=[1.0]),
             tt.ControlCost.create([[1.0]], [0.0], weights=[0.1]))
    plan = tt.make_control_plan(
        system, costs, (tt.ControlBoundConstraint.create([-1.0], [1.0]),))
    assert plan.Q.shape[-1] == N
    opts = tt.SolverOptions(max_iter=ITERS, early_exit=False, polish=False)
    x0 = f32(x0s)
    u = {}
    for fused in (True, False):
        step = tt.make_plan_step(plan, opts, batched=True,
                                 seed_center=x0s.mean(0), accurate=True,
                                 use_fused=fused)
        before = ak.fused_admm_box_shared.launches
        u[fused], _, _ = step(plan, x0, None)
        launched = ak.fused_admm_box_shared.launches - before
        assert (launched > 0) == fused
    torch.cuda.synchronize()
    assert bool(torch.isfinite(u[True]).all())
    assert float((u[True] - u[False]).abs().max()) <= 1e-5
