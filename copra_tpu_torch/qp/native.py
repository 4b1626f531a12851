"""ctypes binding to the native exact QP oracle (Goldfarb-Idnani).

The port's own binding to the repository's ``native/libcopra_native.so``
(``native/activeset.cpp``), built with ``make -C native`` on first use.
The reference's binding imports ``jax.numpy``, hence this copy.  Host-only
and f64: it feeds :func:`copra_tpu_torch.plan.auto_rho` and the accuracy
gates.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np
import torch

from ..errors import SolverError
from .types import (STATUS_MAX_ITER, STATUS_PRIMAL_INFEASIBLE, STATUS_SOLVED,
                    DenseQP, QPSolution, SolverOptions, WarmStart, _np)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcopra_native.so")

_lib = None


def _load() -> ctypes.CDLL:
    """Load (building on first use) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)
        except (OSError, subprocess.CalledProcessError) as e:
            raise SolverError(
                f"could not build the native active-set solver: {e}")
    lib = ctypes.CDLL(_LIB_PATH)
    d = ctypes.POINTER(ctypes.c_double)
    lib.copra_active_set_solve.restype = ctypes.c_int
    lib.copra_active_set_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        d, d, d, d, d, d, d, d,
        ctypes.c_int, ctypes.c_double,
        d, d, ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except SolverError:
        return False


def _f64(v) -> np.ndarray:
    return np.ascontiguousarray(_np(v), dtype=np.float64)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def solve_qp_native(qp: DenseQP, options: SolverOptions = SolverOptions(),
                    warm_start: Optional[WarmStart] = None) -> QPSolution:
    """Solve one QP exactly on the host in f64 (``warm_start`` is ignored:
    the active-set solver always cold-starts).  Returns CPU f64 tensors."""
    del warm_start
    Q = _f64(qp.Q)
    if Q.ndim != 2:
        raise SolverError("native solver is single-QP; loop over the batch "
                          "on the host.")
    n = Q.shape[0]
    c, lb, ub = _f64(qp.c), _f64(qp.lb), _f64(qp.ub)
    for name, v in (("c", c), ("lb", lb), ("ub", ub)):
        if v.shape != (n,):
            raise SolverError(
                f"native solver needs 1-D '{name}' of length {n}, got "
                f"shape {v.shape} (batched QPs: index one lane).")
    Aeq, beq = _f64(qp.Aeq), _f64(qp.beq)
    Aineq, bineq = _f64(qp.Aineq), _f64(qp.bineq)
    me, mi = Aeq.shape[0], Aineq.shape[0]
    x = np.zeros(n)
    obj = ctypes.c_double()
    n_active = ctypes.c_int()
    lib = _load()
    code = lib.copra_active_set_solve(
        n, me, mi, _ptr(Q), _ptr(c),
        _ptr(Aeq) if me else None, _ptr(beq) if me else None,
        _ptr(Aineq) if mi else None, _ptr(bineq) if mi else None,
        _ptr(lb), _ptr(ub),
        int(options.max_iter), float(max(options.eps_abs, 1e-12)),
        _ptr(x), ctypes.byref(obj), ctypes.byref(n_active))

    status = {0: STATUS_SOLVED, 1: STATUS_MAX_ITER,
              2: STATUS_PRIMAL_INFEASIBLE}.get(code, STATUS_MAX_ITER)
    m = me + mi + n
    viol = np.concatenate([
        np.abs(Aeq @ x - beq) if me else np.zeros(0),
        np.maximum(Aineq @ x - bineq, 0.0) if mi else np.zeros(0),
        np.maximum(x - ub, 0.0) + np.maximum(lb - x, 0.0)])
    rp = float(viol.max()) if viol.size else 0.0
    f64 = torch.float64
    zeros = torch.zeros(m, dtype=f64)
    return QPSolution(x=torch.from_numpy(x), y=zeros, z=zeros,
                      status=torch.tensor(status, dtype=torch.int32),
                      iterations=torch.tensor(int(n_active.value),
                                              dtype=torch.int32),
                      primal_residual=torch.tensor(rp, dtype=f64),
                      dual_residual=torch.tensor(0.0, dtype=f64))
