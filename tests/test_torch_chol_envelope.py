"""The batched Cholesky kernel's launch plan and its plain version's contract,
on the CPU.

The kernel (``csrc/chol_batched.cu``) takes every n <= 128 in float32 and
float64 (a group of threads per matrix up to n = 32, a block per matrix
above); ``ops/cholesky_kernel.chol_config`` mirrors its launch plan
(checked against the C side when the library loads on the card).  Here:
the plan and its refusals, and what the plain version the wrapper runs on
CPU tensors shares with the reference's Pallas kernel: the factor depends
only on the lower triangle of ``K``, and a failed pivot leaves the
reference's NaN pattern, above the diagonal too (``L * tril``).  Pallas
runs in interpret mode at B <= 3, n <= 8 only.  Tolerances: bit for bit
where the arithmetic is the same; 1e-9 in f64 against
``jnp.linalg.cholesky`` (the reference's own bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu_torch as tt
from copra_tpu.ops.cholesky_kernel import chol_batched as jax_chol_batched
from copra_tpu_torch.ops import cholesky_kernel as ck

tt.set_default_device("cpu")

DTYPES = (torch.float32, torch.float64)


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    Mx = rng.normal(size=(B, n, n))
    return Mx @ Mx.transpose(0, 2, 1) / n + 0.1 * np.eye(n)


def _garbage_above(K, seed):
    """``K`` with random values in its strict upper triangle."""
    rng = np.random.default_rng(seed)
    G = K.copy()
    iu = np.triu_indices(K.shape[-1], 1)
    G[:, iu[0], iu[1]] = 1e3 * rng.normal(size=(K.shape[0], len(iu[0])))
    return G


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,body,width", [
    (1, 1, 8), (8, 1, 8), (9, 1, 16), (10, 1, 16), (16, 1, 16), (17, 1, 32),
    (32, 1, 32), (33, 2, 3), (48, 2, 3), (64, 2, 4), (100, 2, 7),
    (127, 2, 8), (128, 2, 8)])
def test_chol_plan_covers_the_envelope(n, body, width, dtype):
    """The small body up to n = 32 (8, 16 or 32 threads a matrix, 32 /
    width matrices a warp, 4 warps a block, a per-warp stage of 32 rows of
    width + 1 values), the block body above (a matrix per 256-thread block,
    ceil(n / 16) tiles); the block body also takes n <= 32 when forced.
    Shared memory stays within the 48 KB a block takes without opting in."""
    size = 4 if dtype == torch.float32 else 8
    cfg = ck.chol_config(n, dtype)
    assert cfg[:2] == (body, width)
    if body == 1:
        assert cfg[2:] == (128, 4 * (32 // width),
                           size * 4 * 32 * (width + 1))
        assert ck.chol_config(n, dtype, "small") == cfg
        assert ck.chol_config(n, dtype, "block")[:4] == (2, -(-n // 16), 256,
                                                         1)
    else:
        assert cfg[2:4] == (256, 1)
        with pytest.raises(ValueError, match="small"):
            ck.chol_config(n, dtype, "small")
    assert cfg[4] <= 48 * 1024


@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_plan_every_n(dtype):
    """Every n in 1..128: the small body exactly up to 32, the block body's
    tiles cover n with less than one tile to spare, and the block plan's
    shared memory (two 16-row bands, two column vectors, the diagonal)
    grows with its tiles."""
    last = 0
    for n in range(1, ck.MAX_KERNEL_N + 1):
        body, width, threads, mats, smem = ck.chol_config(n, dtype)
        assert body == (1 if n <= 32 else 2)
        if body == 1:
            assert width in (8, 16, 32) and n <= width
            assert width == 8 or n > width // 2
            assert mats * width == 128 and threads == 128
        blk = ck.chol_config(n, dtype, "block")
        assert 16 * (blk[1] - 1) < n <= 16 * blk[1]
        assert blk[4] >= last and blk[4] <= 48 * 1024
        last = blk[4]


@pytest.mark.parametrize("n,dtype,body,exc", [
    (0, torch.float32, "auto", ValueError),
    (129, torch.float32, "auto", ValueError),
    (129, torch.float64, "block", ValueError),
    (10, torch.float16, "auto", TypeError),
    (10, torch.bfloat16, "auto", TypeError),
    (33, torch.float32, "small", ValueError),
    (10, torch.float32, "warp", ValueError)])
def test_chol_plan_refuses_outside_the_envelope(n, dtype, body, exc):
    with pytest.raises(exc):
        ck.chol_config(n, dtype, body)


@pytest.mark.parametrize("B,n", [(3, 6), (4, 40), (2, 128)])
def test_chol_plain_reads_only_the_lower_triangle(B, n):
    """Garbage in the strict upper triangle of K leaves the factor as it is,
    bit for bit in f64 (and f32), and the factor of a matrix that factors
    has an exactly zero upper triangle; at (3, 6) both equal the
    reference's Pallas kernel in interpret mode."""
    K = _spd(B, n, seed=n)
    G = _garbage_above(K, seed=n + 1)
    for dtype in DTYPES:
        L = ck.chol_plain(torch.tensor(K, dtype=dtype))
        Lg = ck.chol_plain(torch.tensor(G, dtype=dtype))
        assert torch.equal(L, Lg)
        assert float(torch.triu(L, 1).abs().max()) == 0.0
        assert bool(torch.isfinite(L).all())
    if n <= 8:
        L = ck.chol_plain(torch.tensor(K))
        for M in (K, G):
            ref = np.asarray(jax_chol_batched(jnp.asarray(M), interpret=True))
            np.testing.assert_allclose(L.numpy(), ref, rtol=1e-14,
                                       atol=1e-14)


def test_chol_plain_nan_pattern_matches_reference():
    """Fault F8: a matrix whose pivot 3 fails gives the reference Pallas
    kernel's NaN pattern, above the diagonal too (every column from the
    failed one on is NaN in all rows; the columns before it stay finite,
    with zeros above the diagonal), and the other matrices of the batch
    are unchanged."""
    B, n = 3, 6
    K = _spd(B, n, seed=7)
    bad = K.copy()
    bad[1, 3, 3] = -100.0
    L = ck.chol_plain(torch.tensor(bad)).numpy()
    ref = np.asarray(jax_chol_batched(jnp.asarray(bad), interpret=True))
    np.testing.assert_array_equal(np.isnan(L), np.isnan(ref))
    assert np.isnan(L[1][:, 3:]).all()
    assert np.isfinite(L[1][:, :3]).all()
    assert (np.triu(L[1][:, :3], 1) == 0).all()
    good = ck.chol_plain(torch.tensor(K)).numpy()
    np.testing.assert_array_equal(L[[0, 2]], good[[0, 2]])
    np.testing.assert_allclose(L[[0, 2]], ref[[0, 2]], rtol=1e-14,
                               atol=1e-14)
    # the CPU wrapper is the plain version
    assert np.array_equal(ck.chol_batched(torch.tensor(bad)).numpy(), L,
                          equal_nan=True)


def test_chol_plain_at_the_envelope_edge():
    """n = 128, f64 (the widest matrix the kernel takes; the reference
    sends it to ``jnp.linalg.cholesky`` by its VMEM rule) within 1e-9 of
    ``jnp.linalg.cholesky``."""
    K = _spd(2, 128, seed=128)
    L = ck.chol_batched(torch.tensor(K))
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(K)))
    np.testing.assert_allclose(L.numpy(), want, rtol=1e-9, atol=1e-9)
