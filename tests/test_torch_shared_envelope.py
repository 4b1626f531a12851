"""The shape envelope of the port's shared-operator kernels, on the CPU.

The box kernel (``csrc/admm_box_shared.cu``) takes every n <= 1024 and the
general kernel (``csrc/admm_general_shared.cu``) every n <= 256 with
m <= 1024, as the reference's Pallas kernels serve shared plans of any
width their VMEM budget allows.  Here: the launch plans that
``ops/admm_kernel`` mirrors from the CUDA sources (checked against the C
side when a library loads on the card), and the plain versions the
wrappers run on CPU tensors, held against the JAX reference at the wide
end of the envelope: ``admm_box_plain`` against ``xla_admm_box`` at
n = 300 and 600 (2e-4 after 10 f32 iterations, the reference's kernel
tolerance), and ``admm_general_shared_plain`` against the Pallas kernel in
interpret mode at (n, m) = (100, 400) (2e-4 after 8 iterations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu_torch as tt
from copra_tpu.ops.admm_kernel import (fused_admm_general_shared as
                                       jax_general_shared, xla_admm_box)
from copra_tpu_torch.ops import admm_kernel as ak

tt.set_default_device("cpu")

SC = dict(sigma=1e-6, alpha=1.6, rho=0.2)
GSC = dict(sigma=1e-6, alpha=1.6)
# widths on both sides of each change of the box kernel's plan
BOX_WIDTHS = (1, 4, 5, 8, 9, 16, 17, 21, 22, 32, 33, 64, 65, 255, 256, 257,
              300, 511, 512, 513, 600, 1000, 1023, 1024)


@pytest.mark.parametrize("n", BOX_WIDTHS)
def test_box_plan_covers_every_width(n):
    """The small body up to n = 32 (a lane per group of G threads, each
    with P <= 4 coordinates and its n P <= 64 Kinv entries), the tile body
    above (4 lanes x 8 columns a thread, at most 8 warps, a ring of 2 to 4
    stages of 4..32-row slices), within the 227 KB a block may use."""
    body, a, b, lanes, threads, rows, stages, words, smem = \
        ak.box_shared_config(n)
    assert smem <= ak.SMEM_LIMIT
    if n <= ak.BOX_SMALL_MAX_N:
        assert body == 1 and b == -(-n // a) and b <= 4 and n * b <= 64
        assert a * lanes == threads == 64 and smem == 8 * n * n
        return
    assert body == 2 and 2 <= stages <= 4 and 4 <= rows <= 32
    assert rows % 4 == 0 and lanes in (32, 16, 8) and a * b == 32
    assert threads % 32 == 0 and 32 <= threads <= 256
    # the threads cover the lanes x (n rounded to a warp's columns)
    assert threads * 32 >= lanes * n
    assert words >= rows * (-(-n // 4) * 4)


@pytest.mark.parametrize("n", (1, 10, 32))
def test_box_tile_body_takes_small_widths(n):
    """Either body can be forced where it takes the width (for measuring
    the crossover); the small body stops at n = 32."""
    assert ak.box_shared_config(n, "tile")[0] == 2
    assert ak.box_shared_config(n, "small")[0] == 1
    with pytest.raises(ValueError, match="n <= 32"):
        ak.box_shared_config(n + 32, "small")


@pytest.mark.parametrize("n", (0, 1025, 4096))
def test_box_plan_raises_outside_the_envelope(n):
    with pytest.raises(ValueError, match="use_fused=False"):
        ak.box_shared_config(n)


@pytest.mark.parametrize("n,m,body", [
    (10, 85, 1), (10, 95, 1), (16, 96, 1), (4, 10, 1), (17, 96, 2),
    (16, 97, 2), (40, 90, 2), (40, 160, 2), (64, 256, 2), (64, 257, 2),
    (65, 100, 2), (100, 400, 2), (256, 1024, 2)])
def test_general_plan_covers_the_envelope(n, m, body):
    """The group body for n <= 16 and m <= 96 (config 2), the wide body for
    every other shape up to (256, 1024), within 227 KB."""
    cfg = ak.general_shared_config(n, m)
    assert cfg[0] == body and cfg[-1] <= ak.SMEM_LIMIT
    if body == 1:
        assert m <= 8 * cfg[1] and cfg[1] % 4 == 0 and n <= cfg[2]
    else:
        assert cfg[1:4] == (0, 0, 4)
        with pytest.raises(ValueError, match="group"):
            ak.general_shared_config(n, m, "group")


@pytest.mark.parametrize("n,m", [(257, 10), (10, 1025), (0, 5), (300, 2000)])
def test_general_plan_raises_outside_the_envelope(n, m):
    with pytest.raises(ValueError, match="use_fused=False"):
        ak.general_shared_config(n, m)


def _box(B, n, seed):
    """Shared SPD operators (Q = M M' / n + 0.5 I) and distinct non-zero c,
    x0, y0, z0, f32."""
    rng = np.random.default_rng(seed)
    Mx = rng.normal(size=(n, n))
    K = Mx @ Mx.T / n + (0.5 + SC["sigma"] + SC["rho"]) * np.eye(n)
    l, u = np.full((B, n), -0.5), np.full((B, n), 0.5)
    arrays = (np.linalg.inv(K), K, 0.3 * rng.normal(size=(B, n)), l, u,
              0.3 * rng.normal(size=(B, n)), 0.2 * rng.normal(size=(B, n)),
              np.clip(0.3 * rng.normal(size=(B, n)), l, u))
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("n", (300, 600))
@pytest.mark.parametrize("refine", (0, 1))
def test_box_plain_matches_reference_beyond_256(n, refine):
    """The plain version of the box kernel (what a CPU tensor runs) against
    the reference's XLA twin at widths the former envelope refused."""
    args = _box(4, n, seed=n + refine)
    want = xla_admm_box(*map(jnp.asarray, args), n_iter=10, refine=refine,
                        **SC)
    got = ak.fused_admm_box_shared(*(torch.tensor(a) for a in args),
                                   n_iter=10, refine=refine, **SC)
    for name, g, w in zip("xyzg", got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4, err_msg=name)


def test_general_plain_matches_pallas_kernel_wide():
    """``admm_general_shared_plain`` against the reference's Pallas kernel
    in interpret mode at (n, m) = (100, 400), B = 4, 8 iterations, refine
    1, with -inf lower bounds, two equality rows and distinct non-zero
    warm starts."""
    B, n, m = 4, 100, 400
    rng = np.random.default_rng(11)
    C = np.concatenate([rng.normal(size=(m - n, n)), np.eye(n)])
    C /= np.linalg.norm(C, axis=1, keepdims=True)
    rho = np.full(m, 0.3)
    rho[:2] *= 10.0
    Mx = rng.normal(size=(n, n))
    K = Mx @ Mx.T / n + (1.0 + 1e-6) * np.eye(n) + (C.T * rho) @ C
    l = -0.4 + 0.1 * rng.normal(size=(B, m))
    u = l + 0.8
    l[:, 2:150] = -np.inf
    u[:, :2] = l[:, :2]
    args = [a.astype(np.float32) for a in (
        np.linalg.inv(K), K, C, rho, l, u, 0.2 * rng.normal(size=(B, n)),
        0.1 * rng.normal(size=(B, m)),
        np.clip(0.2 * rng.normal(size=(B, m)), l, u))]
    want = jax_general_shared(*map(jnp.asarray, args), n_iter=8, refine=1,
                              interpret=True, **GSC)
    got = ak.fused_admm_general_shared(*(torch.tensor(a) for a in args),
                                       n_iter=8, refine=1, **GSC)
    for name, g, w in zip("eyz", got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4, err_msg=name)
