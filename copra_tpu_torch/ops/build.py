"""Build and load the port's hand-written CUDA kernels.

Each ``copra_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own plain-C shared library,
``copra_tpu_torch/_build/lib<name>_<hash>.so``, keyed by the hash of its
source and flags, and loaded with ctypes.  Nothing is built when a module
is imported: a kernel's first launch builds its library, and
:func:`build_all` builds every source at once, one ``nvcc`` process each,
all started together.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    """``csrc/<name>.cu`` in the package."""
    return os.path.join(CSRC_DIR, f"{name}.cu")


def sources() -> Tuple[str, ...]:
    """Names of every kernel source in ``csrc/``."""
    return tuple(sorted(os.path.splitext(os.path.basename(p))[0]
                        for p in glob.glob(os.path.join(CSRC_DIR, "*.cu"))))


def library_path(name: str) -> str:
    """Where the library of ``name`` lives once built."""
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (needed to build the kernels in "
                       f"{CSRC_DIR}); put the CUDA toolkit on PATH")


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    ``(path, tmp, process or None, start time)``."""
    path = library_path(name)
    if os.path.exists(path):
        return path, None, None, time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                             source_path(name)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return path, tmp, proc, time.perf_counter()


def _finish(name: str, job) -> Tuple[str, float]:
    path, tmp, proc, t0 = job
    if proc is None:
        return path, 0.0
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source_path(name)}:\n{out}{err}")
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


def build_library(name: str) -> Tuple[str, float]:
    """Compile ``csrc/<name>.cu`` unless a library of the same source
    exists.  Returns ``(path, seconds spent)``."""
    return _finish(name, _start(name))


def build_all() -> Dict[str, Tuple[str, float]]:
    """Build every source in ``csrc/`` in parallel; ``{name: (path,
    seconds)}``."""
    jobs = {name: _start(name) for name in sources()}
    return {name: _finish(name, job) for name, job in jobs.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_library(name)[0])
        _libs[name] = lib
    return lib
