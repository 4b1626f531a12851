"""What the benchmark loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``copra_tpu`` (compared whole: ``copra_tpu_torch``
begins with ``copra_tpu``), and the references load nothing of the
program.

    python -m pytest benchmark/test_benchmark_imports.py -n 0
"""

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark import harness

LOAD_ALL = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness as h
for kind in ("reference", "serving", "metrics", "roofline"):
    for name in {names!r}.get(kind, []):
        h.load_module(kind, name)
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _names(kind):
    return sorted(os.path.splitext(os.path.basename(p))[0] for p in
                  glob.glob(os.path.join(harness.BENCH_DIR, kind, "*.py"))
                  if not p.endswith("__init__.py"))


def _loaded(kinds, extra=""):
    code = LOAD_ALL.format(root=harness.ROOT, extra=extra,
                           names={k: _names(k) for k in kinds})
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    got = _loaded(("reference", "serving", "metrics", "roofline"),
                  extra="import copra_tpu_torch, copra_tpu_torch.parallel")
    assert "copra_tpu_torch" in got
    assert not got & set(harness.FORBIDDEN), got & set(harness.FORBIDDEN)


def test_references_load_nothing_of_the_program():
    got = _loaded(("reference",))
    assert not got & (set(harness.FORBIDDEN) | {"copra_tpu_torch"})


def test_no_source_imports_the_repos_scripts():
    """No file of the benchmark imports ``chip_smoke``, the ``bench*``
    scripts or ``tests``."""
    banned = {"chip_smoke", "tests"}
    for path in glob.glob(os.path.join(harness.BENCH_DIR, "**", "*.py"),
                          recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in banned and not top.startswith("bench_") \
                    and top not in ("bench", "bench_all", "bench_scaling"), \
                    f"{path} imports {n}"
