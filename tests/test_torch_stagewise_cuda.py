"""The stagewise tick kernel of ``copra_tpu_torch`` against its plain PyTorch
version, on the card.  Skips without a CUDA device.  Imports no JAX, so on
a GPU host without JAX it runs with ``--noconftest``:

    python -m pytest tests/test_torch_stagewise_cuda.py -m cuda \
        --noconftest -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from copra_tpu_torch.ops import stagewise_kernel as sk
from copra_tpu_torch.qp.riccati import StagewiseQP
from copra_tpu_torch.qp.types import SolverOptions


def _problem(N, x, u, r, lanes, seed):
    """A random well-posed batch of stagewise problems with rows and some
    unbounded coordinates, its fused plan, x0 [x, B] and a distinct
    non-zero warm tensor."""
    rng = np.random.default_rng(seed)
    lead = (lanes,)
    Qm = 0.3 * rng.normal(size=lead + (N + 1, x, x))
    Rm = 0.3 * rng.normal(size=lead + (N, u, u))
    xlb = np.full(lead + (N + 1, x), -0.8)
    mask = rng.uniform(size=xlb.shape) < 0.3
    mid = 0.1 * rng.normal(size=lead + (N, r))
    f = dict(
        A=0.95 * np.eye(x) + 0.08 * rng.normal(size=lead + (N, x, x))
        / np.sqrt(x / 3),
        B=0.5 * rng.normal(size=lead + (N, x, u)),
        d=0.01 * rng.normal(size=lead + (N, x)),
        Qx=np.einsum("...kij,...kil->...kjl", Qm, Qm) + 0.1 * np.eye(x),
        qx=0.2 * rng.normal(size=lead + (N + 1, x)),
        Ru=np.einsum("...kij,...kil->...kjl", Rm, Rm) + 0.5 * np.eye(u),
        ru=0.2 * rng.normal(size=lead + (N, u)),
        x0=0.3 * rng.normal(size=lead + (x,)),
        xlb=np.where(mask, -np.inf, xlb), xub=np.where(mask, np.inf, -xlb),
        ulb=np.full(lead + (N, u), -1.5), uub=np.full(lead + (N, u), 1.5),
        Cx=rng.normal(size=lead + (N, r, x)),
        Cu=rng.normal(size=lead + (N, r, u)), clo=mid - 0.7, chi=mid + 0.7)
    sqp = StagewiseQP(**{k: torch.tensor(v, device="cuda")
                         for k, v in f.items()})
    fp = sk.build_fused_plan(sqp, SolverOptions(rho=0.3))
    lo = sk._Layout(x, u, r)
    warm = torch.tensor(0.2 * rng.normal(size=(N + 1, lo.W, lanes)),
                        device="cuda")
    return fp, sqp.x0.mT.contiguous(), warm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(300, 3, 1, 2, 70), (12, 3, 2, 2, 33),
                                   (40, 12, 12, 12, 40)],
                         ids=["zmp", "resident", "quadruped"])
def test_cuda_tick_matches_plain_version(cuda, shape, dtype, tol):
    """Both entry points within ``tol`` x max(1, max |plain|) of the plain
    version after 20 iterations from a distinct non-zero warm tensor
    (float64 at 1e-9, the reference's fused-vs-XLA tolerance; float32 at
    1e-4); one launch counted per call."""
    N, x, u, r, lanes = shape
    fp, x0, warm = _problem(N, x, u, r, lanes, seed=N + x)
    args = (fp.plan.to(dtype), x0.to(dtype), warm.to(dtype))
    kw = dict(n_iter=20, N=N, x=x, u=u, r=r, sigma=1e-6, alpha=1.6)
    want = sk.stagewise_tick_plain(*args, **kw)
    bound = tol * max(1.0, max(float(w.abs().max()) for w in want))
    for entry in (sk.fused_stagewise_tick, sk.fused_stagewise_tick_streamed):
        before = entry.launches
        got = entry(*args, **kw)
        assert entry.launches == before + 1
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            assert float((g - w).abs().max()) <= bound, entry.__name__
    # n_iter = 0 delivers the warm state and its proximal centre as is
    w0, k0 = sk.fused_stagewise_tick(*args, **dict(kw, n_iter=0))
    p0, q0 = sk.stagewise_tick_plain(*args, **dict(kw, n_iter=0))
    assert torch.equal(w0, p0) and torch.equal(k0, q0)


@pytest.mark.cuda
def test_cuda_tick_raises_on_what_the_kernel_does_not_take(cuda):
    fp, x0, warm = _problem(12, 3, 2, 2, 8, seed=1)
    kw = dict(n_iter=2, N=12, x=3, u=2, r=2, sigma=1e-6, alpha=1.6)
    with pytest.raises(ValueError, match="not instantiated"):
        sk.fused_stagewise_tick(fp.plan, x0, warm,
                                **dict(kw, x=2, u=3))
    with pytest.raises(TypeError):
        sk.fused_stagewise_tick(fp.plan, x0.float(), warm, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        sk.fused_stagewise_tick(fp.plan, x0, warm.transpose(0, 1)
                                .contiguous().transpose(0, 1), **kw)
    with pytest.raises(ValueError, match="shape"):
        sk.fused_stagewise_tick(fp.plan, x0, warm[:-1], **kw)
