"""The shape envelope of the port's per-lane box kernel, on the CPU.

``csrc/admm_box.cu`` takes every n <= 1024 in every mode, as the reference
serves per-lane plans of any width its VMEM budget allows
(``fused_admm_box`` with a sub-batch down to one lane).  Here: the launch
plan that ``ops/admm_kernel.box_lanes_config`` mirrors from the CUDA source
(checked against the C side when the library loads on the card); the
plain version the wrappers run on CPU tensors, held against the
reference's XLA twin ``xla_admm_box`` on per-lane operators at n = 300
(1e-9 in f64; 2e-4 x max(1, max |ref|) in f32 after 30 iterations, the
reference's kernel tolerance); and a per-lane accurate tick at N = 300
against the native f64 oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu_torch as tt
from copra_tpu.ops.admm_kernel import xla_admm_box
from copra_tpu_torch.ops import admm_kernel as ak
from copra_tpu_torch.plan import _slice_plan

tt.set_default_device("cpu")

SC = dict(sigma=1e-6, alpha=1.6, rho=0.2)
ITERS = 30
# the iterating modes with their refine counts, and the Q x pass
PLANS = {"x0_zero": (ak.MODE_X0_ZERO, 0), "general": (ak.MODE_GENERAL, 0),
         "general_refine": (ak.MODE_GENERAL, 1), "qx": (ak.MODE_QX, 0)}


@pytest.mark.parametrize("case", PLANS)
def test_lanes_plan_covers_every_width(case):
    """Every n from 1 to 1024: the register body up to n = 128 (a warp per
    32 columns, a thread's column quad x 4 ceil(n / 16) rows of Kinv in
    registers, K staged in shared memory only with refine >= 1), the
    streamed body above (256 threads), the Q x pass a thread per
    coordinate; always within the 227 KB a block may use."""
    mode, refine = PLANS[case]
    for n in range(1, ak.BOX_LANES_MAX_N + 1):
        body, chunks, threads, smem = ak.box_lanes_config(n, mode, refine)
        assert smem <= ak.SMEM_LIMIT and threads % 32 == 0
        if mode == ak.MODE_QX:
            assert (body, chunks, smem) == (3, 0, 4 * n)
            assert n <= threads <= 1024 and threads < n + 32
            continue
        assert chunks == -(-n // 16) and 16 * chunks >= n
        vectors = 4 * 2 * 16 * chunks
        if n <= ak.BOX_REGISTER_MAX_N:
            assert body == 1 and threads == -(-n // 32) * 32 <= 128
            staged = 4 * 16 * chunks * threads if refine else 0
            assert smem == vectors + staged
            assert (ak.box_lanes_config(n, mode, refine, "streamed")
                    == (2, chunks, 256, vectors))
        else:
            assert (body, threads, smem) == (2, 256, vectors)
            with pytest.raises(ValueError, match="n <= 128"):
                ak.box_lanes_config(n, mode, refine, "register")


@pytest.mark.parametrize("case", PLANS)
@pytest.mark.parametrize("n", (0, 1025))
def test_lanes_plan_raises_outside_the_envelope(case, n):
    mode, refine = PLANS[case]
    with pytest.raises(ValueError, match="use_fused=False"):
        ak.box_lanes_config(n, mode, refine)


def test_lanes_plan_refuses_a_body_of_another_mode():
    with pytest.raises(ValueError, match="one body"):
        ak.box_lanes_config(100, ak.MODE_QX, 0, "register")
    with pytest.raises(ValueError, match="does not serve"):
        ak.box_lanes_config(100, ak.MODE_X0_ZERO, 0, "qx")
    with pytest.raises(ValueError, match="body must be"):
        ak.box_lanes_config(100, ak.MODE_GENERAL, 0, "tile")


def _lanes(B, n, dtype, seed):
    """Per-lane SPD operators (Q = M M' / n + 0.5 I), x0 = 0 and distinct
    non-zero c, y0, z0."""
    rng = np.random.default_rng(seed)
    Ms = rng.normal(size=(B, n, n))
    K = (np.einsum("bij,bkj->bik", Ms, Ms) / n
         + (0.5 + SC["sigma"] + SC["rho"]) * np.eye(n))
    l, u = np.full((B, n), -0.5), np.full((B, n), 0.5)
    arrays = (np.linalg.inv(K), K, 0.3 * rng.normal(size=(B, n)), l, u,
              np.zeros((B, n)), 0.2 * rng.normal(size=(B, n)),
              np.clip(0.3 * rng.normal(size=(B, n)), l, u))
    return [a.astype(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("refine,x0_zero", [(0, True), (0, False), (1, False)])
def test_lanes_plain_matches_reference_at_300(dtype, refine, x0_zero):
    """``admm_box_plain`` on per-lane operators at n = 300 (what a CPU
    tensor runs, and the yardstick of the kernel on the card) against the
    reference's XLA twin: the x0 = 0 body (g from the w recurrence), the
    general body at refine 0 and 1."""
    args = _lanes(3, 300, dtype, seed=300 + refine)
    want = xla_admm_box(*map(jnp.asarray, args), n_iter=ITERS, refine=refine,
                        **SC)
    got = ak.fused_admm_box_lanes(*(torch.tensor(a) for a in args),
                                  n_iter=ITERS, refine=refine,
                                  assume_x0_zero=x0_zero, **SC)
    for name, g, w in zip("xyzg", got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.from_numpy(w).dtype
        tol = (1e-9 if dtype == np.float64
               else 2e-4 * max(1.0, float(np.abs(w).max())))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)


def test_lanes_accurate_tick_at_300_meets_native_oracle():
    """Config 4's fleet (LTV point-mass lanes, +-60 bound) at horizon N =
    300, B = 2: per-lane plans of width 300, which the former kernel
    refused on the card, served by the accurate tick (2 rounds: one leaves
    the f32 correction floor above the contract at this horizon) within
    1e-5 of the exact f64 solution."""
    N, B, bound = 300, 2, 60.0
    T, mass = 0.005, 5.0
    rng = np.random.default_rng(0)
    A = np.array([[1.0, T], [0.0, 1.0]])
    Bm = np.array([[0.5 * T * T / mass], [T / mass]])
    d = np.array([-9.81 / 2.0 * T * T, -9.81 * T])
    As = np.repeat(np.repeat(A[None], N, 0)[None], B, 0)
    As = As + rng.normal(scale=1e-4, size=As.shape)
    Bs = np.repeat(np.repeat(Bm[None], N, 0)[None], B, 0)
    ds = np.repeat(np.repeat(d[None], N, 0)[None], B, 0)
    x0s = np.array([0.0, -1.5])[None] + rng.normal(scale=[0.02, 0.1],
                                                   size=(B, 2))
    system = tt.LTVSystem(*(torch.tensor(a.astype(np.float32))
                            for a in (As, Bs, ds, x0s)))
    costs = (tt.TargetCost.create(np.eye(2), [0.0, -1.0],
                                  weights=[10.0, 1e4]),
             tt.ControlCost.create([[1.0]], [2.0], weights=[1e-4]))
    cons = (tt.ControlBoundConstraint.create([-bound], [bound]),)
    plan = tt.make_control_plan(system, costs, cons)
    opts = tt.SolverOptions(max_iter=ITERS, early_exit=False, polish=False,
                            rho=1.0, kkt_refine=0)
    acc = dict(seed_center=x0s, accurate=True, accurate_rounds=2)
    opts = opts.replace(rho=tt.auto_rho(plan, x0s, opts, **acc))
    step = tt.make_plan_step(plan, opts, batched=True, **acc)
    assert step.state[0].shape == (B, N, N)
    x0 = torch.tensor(x0s.astype(np.float32))
    warm = None
    for _ in range(2):
        u, sol, warm = step(plan, x0, warm)
    for lane in range(B):
        qp = tt.plan_qp(_slice_plan(plan, lane), x0s[lane])
        exact = tt.solve_qp_native(qp).x.numpy()
        assert (np.abs(exact) >= bound - 1e-9).any()
        assert np.abs(u[lane].numpy() - exact).max() <= 1e-5
    assert (sol.status.numpy() == 0).all()
