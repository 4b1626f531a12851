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
import copra_tpu_torch.qp.riccati
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
