"""The PyTorch port stands alone: importing it loads neither JAX nor the
reference package (checked in a fresh interpreter, since this test process
has JAX loaded already)."""

import ast
import os
import re
import subprocess
import sys

import pytest

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
import copra_tpu_torch.receding, copra_tpu_torch.checkpoint
import copra_tpu_torch.parallel.mesh, copra_tpu_torch.parallel.model
import copra_tpu_torch.parallel.horizon, copra_tpu_torch.parallel._collectives
copra_tpu_torch.make_plan_multistep, copra_tpu_torch.make_stagewise_multistep
copra_tpu_torch.solve, copra_tpu_torch.make_stagewise_server
copra_tpu_torch.LMPC, copra_tpu_torch.solve_qp_batched
copra_tpu_torch.solve_mpc_batch, copra_tpu_torch.get_solver
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'copra_tpu'))
print(bad)
sys.exit(1 if bad else 0)
"""


_EXAMPLES = """
import sys
sys.path.insert(0, 'examples')
import torch_getting_started, torch_bipedal_walking
import torch_quadruped_srb, torch_fleet_serving, torch_batched_serving
from copra_tpu_torch.profiling import trace_span, trace_device_time
from copra_tpu_torch.checkpoint import save_pytree_dcp
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'copra_tpu'))
print(bad)
sys.exit(1 if bad else 0)
"""


def _run_fresh(code: str):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_loads_no_jax_and_no_reference():
    proc = _run_fresh(_CHECK)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_examples_load_no_jax_and_no_reference():
    """The example scripts of the port (``examples/torch_*.py``) and the
    closed-loop, checkpoint and profiling modules they reach import
    neither JAX nor ``copra_tpu``."""
    proc = _run_fresh(_EXAMPLES)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_REFERENCE_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|copra_tpu)(?![A-Za-z0-9_])")


def test_chip_smoke_imports_no_jax_and_no_reference():
    """``chip_smoke.py`` runs on the card's host, which has no JAX: its
    source has no ``import jax``, ``from jax``, ``import copra_tpu`` or
    ``from copra_tpu`` (``copra_tpu_torch`` is the port), at any depth,
    and importing it in a fresh interpreter loads neither."""
    _script_imports_no_jax_and_no_reference("chip_smoke")


@pytest.mark.parametrize("module", ["bench_torch", "bench_all_torch",
                                    "bench_scaling_torch"])
def test_bench_scripts_import_no_jax_and_no_reference(module):
    """The port's benchmark entry points run on the card's host too: their
    sources import neither JAX nor ``copra_tpu``, and importing either in
    a fresh interpreter loads neither."""
    _script_imports_no_jax_and_no_reference(module)


def _script_imports_no_jax_and_no_reference(module: str):
    path = os.path.join(REPO, module + ".py")
    with open(path) as f:
        source = f.read()
    bad = [f"{n}: {line.strip()}"
           for n, line in enumerate(source.splitlines(), 1)
           if _REFERENCE_IMPORT.match(line)]
    for node in ast.walk(ast.parse(source, path)):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        bad += [f"{node.lineno}: {name}" for name in names
                if name.split(".")[0] in ("jax", "jaxlib", "copra_tpu")]
    assert not bad, bad
    proc = _run_fresh(
        f"import sys\nimport {module}\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'copra_tpu'))\n"
        "print(bad)\nsys.exit(1 if bad else 0)\n")
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


def test_parallel_exports_every_reference_name():
    """``copra_tpu_torch.parallel`` exports the 13 names of the
    reference's ``copra_tpu.parallel``; each resolves."""
    import copra_tpu.parallel
    import copra_tpu_torch.parallel

    assert len(copra_tpu.parallel.__all__) == 13
    assert set(copra_tpu_torch.parallel.__all__) == set(
        copra_tpu.parallel.__all__)
    for name in copra_tpu_torch.parallel.__all__:
        assert callable(getattr(copra_tpu_torch.parallel, name)), name


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
