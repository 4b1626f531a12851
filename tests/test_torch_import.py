"""The PyTorch port stands alone: importing it loads neither JAX nor the
reference package (checked in a fresh interpreter, since this test process
has JAX loaded already)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import sys
import copra_tpu_torch
import copra_tpu_torch.convert, copra_tpu_torch.ops.admm_kernel
import copra_tpu_torch.plan, copra_tpu_torch.qp.native
import copra_tpu_torch.qp.admm, copra_tpu_torch.qp.registry
import copra_tpu_torch.ops.cholesky_kernel, copra_tpu_torch.mpc
import copra_tpu_torch.profiling, copra_tpu_torch.parallel
import copra_tpu_torch.parallel.batch, copra_tpu_torch.ops.stagewise_kernel
import copra_tpu_torch.qp.riccati, copra_tpu_torch._scan
import copra_tpu_torch._graph, copra_tpu_torch.ops.counts
import copra_tpu_torch.solve, copra_tpu_torch.ops.polish
copra_tpu_torch.make_plan_multistep, copra_tpu_torch.make_stagewise_multistep
copra_tpu_torch.solve, copra_tpu_torch.make_stagewise_server
copra_tpu_torch.LMPC, copra_tpu_torch.solve_qp_batched
copra_tpu_torch.solve_mpc_batch, copra_tpu_torch.get_solver
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'copra_tpu'))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_import_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_precision_context_turns_tf32_off_and_restores():
    import torch

    from copra_tpu_torch._precision import full_f32

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    try:
        with full_f32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]
        torch.set_float32_matmul_precision(before[2])


def test_public_names_still_to_port():
    """The port exports every public name of the reference (none is left
    to port); each export of the port resolves."""
    import copra_tpu
    import copra_tpu_torch

    missing = set(copra_tpu.__all__) - set(copra_tpu_torch.__all__)
    assert missing == set()
    for name in copra_tpu_torch.__all__:
        assert getattr(copra_tpu_torch, name) is not None, name


def test_every_kernel_wrapper_registers_its_count():
    """The wrappers that launch a hand-written kernel are the ones in
    ``ops.counts.COUNTED`` (what a captured chain and a smoke run read and
    reset), each with its count."""
    from copra_tpu_torch.ops import (admm_kernel, cholesky_kernel, counts,
                                     stagewise_kernel)

    wrappers = {admm_kernel.fused_admm_box_lanes, admm_kernel.fused_admm_box,
                admm_kernel.fused_admm_box_shared,
                admm_kernel.fused_admm_general_shared,
                admm_kernel.fused_admm_general, cholesky_kernel.chol_batched,
                stagewise_kernel.fused_stagewise_tick,
                stagewise_kernel.fused_stagewise_tick_streamed}
    assert set(counts.COUNTED) == wrappers
    assert len(counts.COUNTED) == len(wrappers)
    admm_kernel.fused_admm_box.launches = 3
    counts.reset()
    assert all(w.launches == 0 for w in wrappers)
