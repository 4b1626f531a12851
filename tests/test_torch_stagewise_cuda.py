"""The stagewise tick kernel of ``copra_tpu_torch`` against its plain PyTorch
version, on the card.  Skips without a CUDA device.  Imports no JAX, so on
a GPU host without JAX it runs with ``--noconftest`` (from the repository's
root: the parity cases borrow ``chip_smoke.py``'s phase-34 checks):

    python -m pytest tests/test_torch_stagewise_cuda.py -m cuda \
        --noconftest -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from copra_tpu_torch.ops import stagewise_kernel as sk
from copra_tpu_torch.qp.riccati import StagewiseQP, make_stagewise_step
from copra_tpu_torch.qp.types import SolverOptions


def _problem(N, x, u, r, lanes, seed):
    """A random well-posed batch of stagewise problems with rows (none
    when ``r`` is 0) and some unbounded coordinates, its fused plan, x0
    [x, B] and a distinct non-zero warm tensor."""
    sqp = StagewiseQP(**{k: torch.tensor(v, device="cuda") for k, v in
                         _fields(N, x, u, r, lanes, seed).items()})
    rng = np.random.default_rng(seed + 1)
    fp = sk.build_fused_plan(sqp, SolverOptions(rho=0.3))
    lo = sk._Layout(x, u, r)
    warm = torch.tensor(0.2 * rng.normal(size=(N + 1, lo.W, lanes)),
                        device="cuda")
    return fp, sqp.x0.mT.contiguous(), warm


def _fields(N, x, u, r, lanes, seed):
    rng = np.random.default_rng(seed)
    lead = (lanes,)
    Qm = 0.3 * rng.normal(size=lead + (N + 1, x, x))
    Rm = 0.3 * rng.normal(size=lead + (N, u, u))
    xlb = np.full(lead + (N + 1, x), -0.8)
    mask = rng.uniform(size=xlb.shape) < 0.3
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
        ulb=np.full(lead + (N, u), -1.5), uub=np.full(lead + (N, u), 1.5))
    if r:
        mid = 0.1 * rng.normal(size=lead + (N, r))
        f.update(Cx=rng.normal(size=lead + (N, r, x)),
                 Cu=rng.normal(size=lead + (N, r, u)), clo=mid - 0.7,
                 chi=mid + 0.7)
    return f


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(300, 3, 1, 2, 70), (12, 3, 2, 2, 33),
                                   (40, 12, 12, 12, 40), (17, 3, 2, 0, 37),
                                   (12, 6, 2, 4, 45), (8, 32, 32, 32, 9)],
                         ids=["zmp", "resident", "quadruped", "box_only",
                              "resident_class", "wide"])
def test_cuda_tick_matches_plain_version(cuda, shape, dtype, tol):
    """Both entry points within ``tol`` x max(1, max |plain|) of the plain
    version after 20 iterations from a distinct non-zero warm tensor
    (float64 at 1e-9, the reference's fused-vs-XLA tolerance; float32 at
    1e-4), lane counts that are not multiples of 32 among them, with the
    lane-first plan made by the call and made once; one launch counted per
    call."""
    N, x, u, r, lanes = shape
    fp, x0, warm = _problem(N, x, u, r, lanes, seed=N + x)
    args = (fp.plan.to(dtype), x0.to(dtype), warm.to(dtype))
    kw = dict(n_iter=20, N=N, x=x, u=u, r=r, sigma=1e-6, alpha=1.6)
    want = sk.stagewise_tick_plain(*args, **kw)
    bound = tol * max(1.0, max(float(w.abs().max()) for w in want))

    def held(got, what):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            assert float((g - w).abs().max()) <= bound, what

    for entry, lf in ((sk.fused_stagewise_tick, None),
                      (sk.fused_stagewise_tick_streamed,
                       sk.lane_first_plan(args[0]))):
        before = entry.launches
        got = entry(*args, **kw, plan_lf=lf)
        assert entry.launches == before + 1
        held(got, entry.__name__)
    # n_iter = 0 delivers the warm state and its proximal centre as is
    p0, q0 = sk.stagewise_tick_plain(*args, **dict(kw, n_iter=0))
    for entry in (sk.fused_stagewise_tick, sk.fused_stagewise_tick_streamed):
        w0, k0 = entry(*args, **dict(kw, n_iter=0))
        assert torch.equal(w0, p0) and torch.equal(k0, q0), entry.__name__


def _launch_counts():
    from copra_tpu_torch import profiling

    c = profiling.counters()
    return tuple(c.get(n, 0) for n in sk.LAUNCH_COUNTERS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(12, 12, 12, 4, 37), (12, 13, 12, 4, 37),
                                   (9, 12, 4, 12, 6), (9, 13, 4, 12, 6),
                                   (12, 16, 8, 4, 37), (12, 16, 16, 4, 5),
                                   (15, 5, 3, 0, 5), (10, 2, 1, 0, 9)],
                         ids=["warp_24_u_gt_r", "block_25_u_gt_r",
                              "warp_24_r_gt_u", "block_25_r_gt_u",
                              "warp_x16", "block_32", "warp_no_rows",
                              "warp_config1_shape"])
def test_cuda_bodies_at_the_warp_envelope_edges(cuda, shape, dtype, tol):
    """Each body at the edges of the warp envelope (x + max(u, r) = 24
    with x, u, r <= 16 takes the warp body; 25 or 32 the block body; u > r,
    r > u, r = 0; odd lane counts) against
    the plain version within ``tol`` x max(1, max |plain|): 20 iterations
    from a distinct non-zero warm tensor, ``n_iter = 0`` bit for bit, a run
    that carries the centre from a given work tensor, and the top-up flag:
    set, the state comes back bit for bit; clear, the run equals the one
    without the flag.  Each launch adds one to the counter of the body the
    shape's rule names."""
    N, x, u, r, lanes = shape
    warp = sk.warp_body(x, u, r)
    assert warp == (x + max(u, r) <= 24 and max(x, u, r) <= 16)
    assert sk.ring_config(N, x, u, r, dtype.itemsize)[9] == int(warp)
    fp, x0, warm = _problem(N, x, u, r, lanes, seed=3 * N + x + r)
    args = (fp.plan.to(dtype), x0.to(dtype), warm.to(dtype))
    kw = dict(n_iter=20, N=N, x=x, u=u, r=r, sigma=1e-6, alpha=1.6)
    entry = sk.fused_stagewise_tick
    step = (1, 0) if warp else (0, 1)

    def launched(n, **more):
        before = _launch_counts()
        out = entry(*args, **dict(kw, **more))
        torch.cuda.synchronize()
        got = _launch_counts()
        assert got == tuple(b + n * s for b, s in zip(before, step))
        return out

    def held(got, want, what):
        bound = tol * max(1.0, max(float(w.abs().max()) for w in want))
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape, what
            assert float((g - w).abs().max()) <= bound, what

    want = sk.stagewise_tick_plain(*args, **kw)
    got = launched(1)
    held(got, want, "20 iterations")
    p0 = sk.stagewise_tick_plain(*args, **dict(kw, n_iter=0))
    assert all(torch.equal(g, w) for g, w in zip(launched(1, n_iter=0), p0))
    # carry: 5 more iterations from the plain run's state, its centre kept
    args = (args[0], args[1], want[0])
    more = dict(n_iter=5, work=want[1], carry=True)
    held(launched(1, **more),
         sk.stagewise_tick_plain(*args, **dict(kw, **more)), "carry")
    one = torch.ones((), dtype=torch.int32, device="cuda")
    kept = launched(1, **more, skip=one)
    assert torch.equal(kept[0], want[0]) and torch.equal(kept[1], want[1])
    ran = launched(1, **more, skip=0 * one)
    again = launched(1, **more)
    assert all(torch.equal(g, w) for g, w in zip(ran, again))


@pytest.mark.cuda
def test_cuda_tick_streams_kk_when_it_does_not_fit(cuda):
    """A long wide horizon whose kk rows do not fit beside the ring
    (kk_resident 0: the forward sweep reads kk from the streamed tiles),
    float64 within 1e-9 of the plain version after 2 iterations."""
    N, x, u, r, lanes = 160, 50, 50, 0, 3
    assert sk.ring_config(N, x, u, r, 8)[5] == 0
    fp, x0, warm = _problem(N, x, u, r, lanes, seed=5)
    kw = dict(n_iter=2, N=N, x=x, u=u, r=r, sigma=1e-6, alpha=1.6)
    want = sk.stagewise_tick_plain(fp.plan, x0, warm, **kw)
    got = sk.fused_stagewise_tick_streamed(fp.plan, x0, warm, **kw)
    torch.cuda.synchronize()
    bound = 1e-9 * max(1.0, max(float(w.abs().max()) for w in want))
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= bound


@pytest.mark.cuda
def test_cuda_warp_body_streams_kk_when_it_does_not_fit(cuda):
    """A shape of the warp body whose kk rows do not fit beside a lane's
    ring (the forward sweep reads kk from the streamed tiles), float64
    within 1e-9 of the plain version after 2 iterations."""
    N, x, u, r, lanes = 2100, 2, 14, 0, 3
    cfg = sk.ring_config(N, x, u, r, 8)
    assert cfg[9] == 1 and cfg[5] == 0 and cfg[4] >= 2
    fp, x0, warm = _problem(N, x, u, r, lanes, seed=6)
    kw = dict(n_iter=2, N=N, x=x, u=u, r=r, sigma=1e-6, alpha=1.6)
    want = sk.stagewise_tick_plain(fp.plan, x0, warm, **kw)
    got = sk.fused_stagewise_tick(fp.plan, x0, warm, **kw)
    torch.cuda.synchronize()
    bound = 1e-9 * max(1.0, max(float(w.abs().max()) for w in want))
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= bound


@pytest.mark.cuda
def test_cuda_tick_raises_on_what_the_kernel_does_not_take(cuda):
    fp, x0, warm = _problem(12, 3, 2, 2, 8, seed=1)
    kw = dict(n_iter=2, N=12, x=3, u=2, r=2, sigma=1e-6, alpha=1.6)
    with pytest.raises(ValueError, match="envelope"):     # x + u + r > 128
        sk.fused_stagewise_tick(fp.plan, x0, warm,
                                **dict(kw, x=60, u=60, r=9))
    with pytest.raises(ValueError, match="envelope"):     # the ring
        sk.fused_stagewise_tick_streamed(fp.plan, x0, warm,
                                         **dict(kw, x=64, u=64, r=0))
    with pytest.raises(TypeError):
        sk.fused_stagewise_tick(fp.plan, x0.float(), warm, **kw)
    with pytest.raises(TypeError):
        sk.fused_stagewise_tick(fp.plan.half(), x0, warm, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        sk.fused_stagewise_tick(fp.plan, x0, warm.transpose(0, 1)
                                .contiguous().transpose(0, 1), **kw)
    with pytest.raises(ValueError, match="shape"):
        sk.fused_stagewise_tick(fp.plan, x0, warm[:-1], **kw)
    with pytest.raises(ValueError, match="lane_first_plan"):
        sk.fused_stagewise_tick(fp.plan, x0, warm, **kw,
                                plan_lf=sk.lane_first_plan(fp.plan[:-1]))
    with pytest.raises(ValueError, match="shape"):   # (2, 3, 2) is served,
        sk.fused_stagewise_tick(fp.plan, x0, warm,   # but on a plan of its
                                **dict(kw, x=2, u=3))    # own


@pytest.mark.cuda
def test_cuda_fused_step_serves_box_only_shape_like_xla(cuda):
    """make_stagewise_step(backend='fused') on a (3, 2, 0) fleet on the
    card against backend='xla' in float64: a cold and a
    warm tick within 1e-9."""
    f = _fields(12, 3, 2, 0, 5, seed=80)
    sqp = StagewiseQP(**{k: torch.tensor(v, device="cuda")
                         for k, v in f.items()})
    opts = SolverOptions(max_iter=15, early_exit=False)
    ticks = [make_stagewise_step(sqp, opts, backend=b)
             for b in ("fused", "xla")]
    assert [t.backend for t in ticks] == ["fused", "xla"]
    before = sk.fused_stagewise_tick.launches
    warm = [None, None]
    for x0 in (sqp.x0, sqp.x0 + 0.05):
        outs = [t(x0, w) for t, w in zip(ticks, warm)]
        for g, w in zip(outs[0][:2], outs[1][:2]):
            assert float((g - w).abs().max()) <= 1e-9
        warm = [o[3] for o in outs]
    assert sk.fused_stagewise_tick.launches > before


def _reset():
    from copra_tpu_torch.ops.counts import reset
    reset()


@pytest.mark.cuda
def test_cuda_parity_honesty_on_the_kernel(cuda):
    """The reference's stagewise-honesty cases on K4
    (``chip_smoke.parity_honesty_case``): early exit out of a 3-iteration
    budget on every lane, the starved lane named by ``failed_lanes`` and
    ``inform``, crossed bounds primal infeasible; each against the plain
    route on the CPU."""
    import chip_smoke
    import copra_tpu_torch as tt

    assert chip_smoke.parity_honesty_case(
        tt, sk, chip_smoke._fixtures(), torch.device("cuda"), _reset) > 0


@pytest.mark.cuda
def test_cuda_parity_scaling_on_the_kernel(cuda):
    """The quadruped at N = 16 in float64 on K5 with early exit: the
    equilibrated problem converges in fewer iterations than the raw one,
    which does not (``chip_smoke.parity_scaling_case``)."""
    import chip_smoke
    import copra_tpu_torch as tt

    assert chip_smoke.parity_scaling_case(tt, sk, torch.device("cuda"),
                                          _reset) > 0


@pytest.mark.cuda
def test_cuda_replanned_tick_in_a_cuda_graph(cuda):
    """A warm kernel tick captured as a CUDA graph reads the data of a
    later same-shape ``replan`` (the facade refills its tensors in place)
    and equals a fresh facade's tick bit for bit; a changed shape
    raises."""
    from copra_tpu_torch._graph import CapturedChain
    from copra_tpu_torch.errors import DimensionError

    f = _fields(12, 3, 2, 2, 6, seed=90)
    sqp = StagewiseQP(**{k: torch.tensor(v, device="cuda")
                         for k, v in f.items()})
    moved = StagewiseQP(**{k: torch.tensor(
        v + 0.05 if k == "qx" else v, device="cuda") for k, v in f.items()})
    opts = SolverOptions(max_iter=15, early_exit=False)
    tick = make_stagewise_step(sqp, opts, backend="fused")
    _, _, _, warm = tick(sqp.x0)
    graph = CapturedChain(lambda x, *w: tick(x, w), (sqp.x0,) + tuple(warm),
                          "a tick", "backend='xla'")
    before = graph(sqp.x0, *warm)[1].clone()
    tick.replan(moved, swap_budget=False)
    got = graph(sqp.x0, *warm)
    want = make_stagewise_step(moved, opts, backend="fused")(sqp.x0, warm)
    assert float((got[1] - before).abs().max()) > 0.0
    for g, w in [(got[0], want[0]), (got[1], want[1]),
                 (got[2].status, want[2].status)] + list(zip(got[3],
                                                             want[3])):
        assert torch.equal(g, w)
    with pytest.raises(DimensionError):
        tick.replan(StagewiseQP(**{k: torch.tensor(v[:3], device="cuda")
                                   for k, v in f.items()}))
