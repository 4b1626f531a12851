"""The stagewise tick kernel's envelope and its lane-first repack, on the
CPU: which shapes the CUDA kernel serves, the launch plan it makes (shared
memory ring, threads, unroll bound), and the fused serving path of a box-only shape
(its plain version on CPU tensors) against the JAX reference in float64
(1e-9, the reference's fused-vs-XLA tolerance).  The kernels themselves
are held against the plain version in ``test_torch_stagewise_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
from copra_tpu.qp import riccati as jr

import copra_tpu_torch as tt
from copra_tpu_torch.convert import stagewise_from_numpy
from copra_tpu_torch.ops import stagewise_kernel as sk
from copra_tpu_torch.qp import riccati as tr
from test_torch_stagewise import _fields, _same_solution, _warm

tt.set_default_device("cpu")


@pytest.mark.parametrize("shape", [(3, 2, 0), (6, 2, 4), (12, 12, 12),
                                   (32, 32, 32), (3, 1, 2), (2, 3, 2)])
def test_envelope_takes_every_shape_whose_ring_fits(shape):
    sk.check_fused_envelope(40, *shape, torch.float32)
    sk.check_fused_envelope(8, *shape, torch.float64)


@pytest.mark.parametrize("shape,dtype", [((60, 60, 9), torch.float32),
                                         ((100, 20, 9), torch.float64),
                                         ((64, 64, 0), torch.float64),
                                         ((3, 2, 2), torch.float16),
                                         ((3, 0, 2), torch.float32)],
                         ids=["width", "width_f64", "ring", "dtype",
                              "no_control"])
def test_envelope_raises_with_guidance(shape, dtype):
    with pytest.raises(ValueError, match="backend='xla'") as e:
        sk.check_fused_envelope(10, *shape, dtype)
    assert "envelope" in str(e.value)


@pytest.mark.parametrize("N,x,u,r,itemsize,want", [
    (40, 12, 12, 12, 4, (1008, 72, 36, 32, 2, 1, 16, 1)),  # config 6, f32
    (40, 12, 12, 12, 8, (1008, 72, 36, 32, 3, 1, 8, 1)),   # config 6, f64
    (8, 32, 32, 32, 8, (6528, 192, 96, 64, 2, 1, 2, 0)),   # near the limit
    (10, 64, 64, 0, 4, (16960, 256, 192, 128, 3, 1, 1, 0)),
    (10, 64, 64, 0, 8, (16960, 256, 192, 128, 0, 0, 1, 0)),  # no fit
    (3000, 100, 20, 8, 4, (15964, 256, 140, 160, 3, 0, 1, 0)),  # kk out
    (300, 3, 1, 2, 8, (50, 12, 6, 32, 2, 1, 16, 1))],
    ids=["config6_f32", "config6_f64", "wide_f64", "x64_f32", "x64_f64",
         "kk_streamed", "config5_f64"])
def test_ring_plan(N, x, u, r, itemsize, want):
    """Rows padded to 16 bytes; a block a lane.  The warp body: one warp,
    up to WARP_TILES tiles beside kk and the slots' mbarriers in 227 KB,
    in 2 or 3 slots of the largest power-of-two group up to WARP_GROUP.
    The block body: warps for the state coordinates and warps for the
    control and row coordinates, as many tiles (2..8) as fit in 227 KB
    beside the vectors and kk, in slots of 4, 2 or 1 tiles."""
    got = sk.ring_config(N, x, u, r, itemsize)
    assert got[:6] + got[8:] == want
    lo = sk._Layout(x, u, r)
    assert got[0] >= lo.C and got[0] * itemsize % 16 == 0
    if got[4]:
        assert got[6] <= sk.SMEM_LIMIT
        assert got[6] >= got[4] * got[8] * (got[0] + got[1] + got[2]) * \
            itemsize


@pytest.mark.parametrize("N,x,u,r,warp", [
    (300, 3, 1, 2, True), (40, 12, 12, 12, True), (10, 2, 1, 0, True),
    (12, 2, 1, 0, True), (12, 12, 12, 4, True), (12, 13, 12, 4, False),
    (12, 12, 4, 12, True), (12, 13, 4, 12, False), (12, 16, 8, 4, True),
    (12, 16, 16, 4, False), (12, 17, 4, 4, False), (12, 20, 12, 4, False),
    (7, 31, 1, 1, False), (8, 32, 32, 32, False)],
    ids=["config5", "config6", "config1_polish", "fleet_serving",
         "edge_24_u_gt_r", "edge_25_u_gt_r", "edge_24_r_gt_u",
         "edge_25_r_gt_u", "x16", "edge_32", "x17", "x20", "x31", "wide"])
def test_body_by_shape(N, x, u, r, warp):
    """The warp body serves x + max(u, r) <= 24 with x, u, r <= 16, one
    warp a lane, in both dtypes; the block body the rest, with warps for
    the state coordinates beside warps for the control and row
    coordinates.  The shape alone decides."""
    assert sk.warp_body(x, u, r) is warp
    for itemsize in (4, 8):
        got = sk.ring_config(N, x, u, r, itemsize)
        assert got[9] == int(warp)
        assert got[3] == (32 if warp else
                          _round32(x) + _round32(max(u, r)))
        assert got[4] >= 2 and got[6] <= sk.SMEM_LIMIT


def _round32(n):
    return (n + 31) // 32 * 32


def test_plain_route_counts_no_launch():
    """On CPU tensors the wrappers run the plain version: neither body's
    launch counter moves."""
    from copra_tpu_torch import profiling

    N, x, u, r, lanes = 6, 3, 1, 2, 2
    lo = sk._Layout(x, u, r)
    rng = np.random.default_rng(4)
    plan = torch.tensor(rng.normal(size=(N + 1, lo.C, lanes)))
    plan[:, lo.rhos:lo.rhos + r] = 1.0
    before = [profiling.counters().get(n, 0) for n in sk.LAUNCH_COUNTERS]
    sk.fused_stagewise_tick(plan, torch.zeros((x, lanes), dtype=plan.dtype),
                            torch.zeros((N + 1, lo.W, lanes),
                                        dtype=plan.dtype),
                            n_iter=1, N=N, x=x, u=u, r=r, sigma=1e-6,
                            alpha=1.6)
    assert [profiling.counters().get(n, 0)
            for n in sk.LAUNCH_COUNTERS] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows_of", ["C", "W", "Kw"])
def test_lane_first_repack_round_trips_exactly(dtype, rows_of):
    """plan, warm and work go to [B, N+1, rows_p] (zero padding, each
    lane's stage tile contiguous) and back bit for bit."""
    N, x, u, r, lanes = 7, 6, 2, 4, 5
    lo = sk._Layout(x, u, r)
    rows = getattr(lo, rows_of)
    itemsize = torch.finfo(dtype).bits // 8
    cfg = sk.ring_config(N, x, u, r, itemsize)
    rows_p = cfg[("C", "W", "Kw").index(rows_of)]
    t = torch.tensor(np.random.default_rng(3).normal(
        size=(N + 1, rows, lanes)), dtype=dtype)
    lf = sk._lane_first(t, rows_p)
    assert lf.shape == (lanes, N + 1, rows_p) and lf.is_contiguous()
    assert torch.equal(lf[2, 4, :rows], t[4, :, 2])
    assert not lf[:, :, rows:].any()
    back = sk._lane_last(lf, rows)
    assert back.is_contiguous() and torch.equal(back, t)
    if rows_of == "C":
        assert torch.equal(sk.lane_first_plan(t), lf)


@pytest.mark.parametrize("shape,unroll", [((3, 1, 2), 4), ((3, 2, 0), 4),
                                          ((6, 2, 4), 8),
                                          ((12, 12, 12), 16),
                                          ((32, 32, 32), 32),
                                          ((33, 2, 2), 0)])
def test_loops_unroll_to_the_smallest_bound_that_covers_the_shape(shape,
                                                                  unroll):
    assert sk.ring_config(10, *shape, 4)[7] == unroll
    assert sk.ring_config(10, *shape, 8)[7] == unroll


def test_fused_step_on_box_only_shape_matches_reference():
    """make_stagewise_step(backend='fused') on CPU tensors of the
    reference's box-only test shape (3, 2, 0) against the reference's
    backend='xla': a cold tick, then warm ticks from the carried state
    and from distinct non-zero warm tuples, as the box-only reseed test
    does; 1e-9."""
    lanes = 3
    f = _fields(90, lanes=lanes, rows=False)
    opts = ct.SolverOptions(max_iter=15, early_exit=False)
    tick_j = jr.make_stagewise_step(
        jr.StagewiseQP(**{k: jnp.asarray(v) for k, v in f.items()}), opts,
        backend="xla")
    tick_t = tr.make_stagewise_step(stagewise_from_numpy(f), opts,
                                    backend="fused")
    assert tick_t.backend == "fused"
    out_j = tick_j(jnp.asarray(f["x0"]))
    out_t = tick_t(torch.tensor(f["x0"]))
    _same_solution(out_t, out_j, iterations=False)
    warm = _warm(np.random.default_rng(91), f, lanes, rows=False)
    for wj, wt in ((out_j[3], out_t[3]),
                   (tuple(map(jnp.asarray, warm)),
                    tuple(map(torch.tensor, warm)))):
        x0 = f["x0"] + 0.02
        _same_solution(tick_t(torch.tensor(x0), wt),
                       tick_j(jnp.asarray(x0), wj), iterations=False)
