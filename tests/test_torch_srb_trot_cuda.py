"""The Riccati gains kernel and the rebuilt-every-tick stagewise chain of
``copra_tpu_torch`` on the card.  Skips without a CUDA device.  Imports
no JAX, so on a GPU host without JAX it runs with ``--noconftest``:

    python -m pytest tests/test_torch_srb_trot_cuda.py -m cuda \
        --noconftest -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from copra_tpu_torch import profiling, srb
from copra_tpu_torch.ops import gains_kernel as gk
from copra_tpu_torch.ops import stagewise_kernel as sk
from copra_tpu_torch.qp.riccati import (_penalized, make_stagewise_multistep,
                                        scale_stagewise, stagewise_scales)
from copra_tpu_torch.qp.types import SolverOptions

W = [50.0, 50, 10, 10, 10, 100, 1, 1, 1, 5, 5, 5]
BOX = dict(mu=0.6, fz_max=250.0, tilt=0.4, height_range=(0.2, 0.4))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")


def _random(N, x, u, r, lanes, dtype, seed):
    """Random well-posed lane-first inputs of the recursion and a lane-last
    plan of random values."""
    g = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64)
    rn = lambda *s: torch.randn(s, generator=g, **f64)
    Qm, Rm = rn(lanes, N + 1, x, x), rn(lanes, N, u, u)
    A = 0.95 * torch.eye(x, **f64) + 0.1 * rn(lanes, N, x, x) / x ** 0.5
    t = dict(A=A, B=0.5 * rn(lanes, N, x, u), d=0.1 * rn(lanes, N, x),
             Qx_r=Qm @ Qm.mT / x + 0.5 * torch.eye(x, **f64),
             Ru_r=Rm @ Rm.mT / u + 0.5 * torch.eye(u, **f64),
             S=0.05 * rn(lanes, N, x, u) if r else None,
             qx=rn(lanes, N + 1, x), ru=rn(lanes, N, u))
    t = {k: None if v is None else v.to(dtype).cuda() for k, v in t.items()}
    C = sk._Layout(x, u, r).C
    plan = rn(N + 1, C, lanes).to(dtype).cuda()
    return t, plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
@pytest.mark.parametrize("shape", [(40, 12, 12, 16, 37), (300, 3, 1, 2, 70)],
                         ids=["quadruped", "zmp"])
def test_gains_kernel_matches_precompute_lqr_gains(cuda, shape, dtype, tol):
    """One launch writes the plan's A, B, d, K, nF, qb and rb columns as
    ``precompute_lqr_gains`` (the plain route, on the CPU in float64) gives
    them, within ``tol`` x max(1, max |column|) (float64 at 1e-10; float32
    at 2e-4, rounding over N dependent stages), into the lane-last plan
    and the lane-first copy the tick kernel reads, leaving every other
    column as it was; one launch counted each."""
    N, x, u, r, lanes = shape
    t, plan = _random(N, x, u, r, lanes, dtype, seed=N + x)
    want = plan.double().cpu()
    gk.riccati_gains_plain(want, lane_first=False, x=x, u=u, r=r,
                           **{k: None if v is None else v.double().cpu()
                              for k, v in t.items()})
    lo = sk._Layout(x, u, r)
    fields = {"A": x * x, "B": x * u, "d": x, "K": u * x, "nF": u * u,
              "qb": x, "rb": u}
    for lane_first in (False, True):
        out = (sk.lane_first_plan(plan) if lane_first else plan).clone()
        before = out.clone()
        n0 = gk.riccati_gains_into_plan.launches
        c0 = profiling.counters().get(gk.LAUNCH_COUNTER, 0)
        gk.riccati_gains_into_plan(out, lane_first=lane_first, x=x, u=u,
                                   r=r, **t)
        torch.cuda.synchronize()
        assert gk.riccati_gains_into_plan.launches == n0 + 1
        assert profiling.counters()[gk.LAUNCH_COUNTER] == c0 + 1
        got = (sk._lane_last(out, lo.C) if lane_first else out).double().cpu()
        kept = (sk._lane_last(before, lo.C) if lane_first
                else before).double().cpu()
        written = torch.zeros(lo.C, dtype=torch.bool)
        for name, n in fields.items():
            off = getattr(lo, name)
            written[off:off + n] = True
            w, g = want[:, off:off + n], got[:, off:off + n]
            bound = tol * max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) <= bound, (name, lane_first)
        assert torch.equal(got[:, ~written], kept[:, ~written])
        if lane_first:      # the padding past C is left alone
            assert torch.equal(out[..., lo.C:], before[..., lo.C:])


def _fleet(robots, N, device):
    phase = torch.arange(robots) * 3 % 20
    model = srb.TrotModel.create(
        phase.tolist(), N=N, dt=0.025, mass=25.0, inertia=[0.35, 1.2, 1.3],
        w=W, terminal=10.0, r=1e-5, height=0.3, period_s=0.5, duty=0.5,
        device=device)
    x0 = torch.zeros((robots, 12), device=device)
    x0[:, 5] = 0.3
    x0[:, 2] = torch.linspace(-2.0, 2.0, robots, device=device)
    nominal = torch.zeros((1, 12), device=device)
    nominal[:, 5] = 0.3
    scales = stagewise_scales(srb.trot_qp(srb.stance_model(model), nominal,
                                          **BOX))
    return model, x0, scales


@pytest.mark.cuda
def test_captured_rebuilt_tick_replays_once_a_tick(cuda):
    """The chain with a per-tick problem on the card: the first warm call
    captures one graph, every later call replays it (no new capture), the
    device counter ``stagewise.rebuilds`` moves by one a tick as
    ``stagewise.ticks`` does, and after a replay the plan the tick kernel
    reads is the fresh plan of that tick's linearisation (gains within
    2e-4 of the largest, float32), and the chain keeps no lane-last plan
    beside it."""
    model, x0, scales = _fleet(16, 40, "cuda")
    sqp = srb.trot_qp(model, x0, **BOX)
    opts = SolverOptions(max_iter=50, early_exit=False, polish=False,
                         eps_abs=1e-4, rho=0.1, topup_iters=200)
    step = make_stagewise_multistep(
        sqp, opts, cold_options=opts.replace(max_iter=300, topup_iters=0),
        backend="fused", scaling=scales,
        problem=lambda x: srb.linearise(model, x))
    warm, xs = None, x0.clone()
    g = torch.Generator(device="cuda").manual_seed(3)
    counts = []
    for t in range(5):
        xs = xs + 0.02 * torch.randn(xs.shape, generator=g, device="cuda")
        _, _, _, info, warm = step(None, 1, warm=warm, x0_seq=xs[None])
        c = profiling.counters()
        counts.append((c["chain.captures"], c["stagewise.rebuilds"],
                       c["stagewise.ticks"]))
        assert bool(torch.isfinite(info.x).all())
    caps, rebuilds, ticks = np.array(counts).T
    assert len(step.chains) == 1
    assert np.all(np.diff(caps) == 0)          # captured at the first call
    assert np.all(np.diff(rebuilds) == 1) and np.all(np.diff(ticks) == 1)
    fp = step._data[3]
    # only the copy the tick kernel reads is kept, so none can go stale
    assert fp.plan is None and fp.plan_lf is not None
    fresh = sk.build_fused_plan(
        scale_stagewise(srb.trot_qp(model, xs, **BOX), *scales), opts)
    lo = sk._Layout(12, 12, 16)
    got = sk._lane_last(fp.plan_lf, lo.C)
    for name, n in (("K", 144), ("nF", 144), ("qb", 12), ("rb", 12),
                    ("A", 144), ("B", 144)):
        off = getattr(lo, name)
        w, h = fresh.plan[:, off:off + n], got[:, off:off + n]
        assert float((h - w).abs().max()) <= 2e-4 * max(
            1.0, float(w.abs().max())), name
    # the ridged Hessians the chain keeps are the fresh plan's
    Qx_r = _penalized(fresh.sqp, opts, fresh.rho_x, fresh.rho_u)[0]
    assert torch.allclose(step._data[4][0], Qx_r, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_serve_replays_one_graph_and_matches_the_carried_chain(cuda):
    """``serve`` on the card: one capture at its first warm call, one
    replay a call after it, a rebuild and a tick counted each, and the
    controls of the chain called with the warm tuple carried (within
    1e-5 of the largest force: the same kernels on the same data)."""
    model, x0, scales = _fleet(16, 40, "cuda")
    sqp = srb.trot_qp(model, x0, **BOX)
    opts = SolverOptions(max_iter=50, early_exit=False, polish=False,
                         eps_abs=1e-4, rho=0.1, topup_iters=200)

    def make():
        return make_stagewise_multistep(
            sqp, opts, cold_options=opts.replace(max_iter=300,
                                                 topup_iters=0),
            backend="fused", scaling=scales,
            problem=lambda x: srb.linearise(model, x))

    a, b = make(), make()
    warm, xs = None, x0.clone()
    g = torch.Generator(device="cuda").manual_seed(4)
    counts = []
    for t in range(5):
        xs = xs + 0.02 * torch.randn(xs.shape, generator=g, device="cuda")
        _, _, _, info, warm = a(None, 1, warm=warm, x0_seq=xs[None])
        got = b.serve(xs)
        c = profiling.counters()
        counts.append((c["chain.captures"], c["stagewise.rebuilds"],
                       c["stagewise.ticks"]))
        scale = float(info.x.abs().max())
        assert float((got - info.x).abs().max()) <= 1e-5 * scale, t
    caps, rebuilds, ticks = np.array(counts[1:]).T
    assert list(b.chains) == ["serve"]
    assert np.all(np.diff(caps) == 0)
    # each later call: one tick of each chain, one rebuild each
    assert np.all(np.diff(rebuilds) == 2) and np.all(np.diff(ticks) == 2)
