"""The port's checkpoints against the JAX reference, on the CPU (the
checkpoint half of ``tests/test_aux.py``).

Round trips and resumes are bit for bit (``atol=0``); a structure or a leaf
shape that differs from the template raises.  State written by the
reference's ``save_warm_start`` and carried over through numpy and
``convert.warm_from_numpy`` resumes the port's solve at the golden
tolerance (control 2e-4; measured 2.0e-11).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.checkpoint import save_warm_start as jax_save_warm_start
from copra_tpu_torch.checkpoint import (load_pytree, load_pytree_dcp,
                                        load_warm_start, save_pytree,
                                        save_pytree_dcp, save_warm_start)
from copra_tpu_torch.convert import warm_from_numpy
from copra_tpu_torch.qp.riccati import from_mpc, solve_stagewise
from fixtures import (A, B, D, M, N_MAT, SMALL_N, SMALL_X0, UD, U_LOWER,
                      U_UPPER, WU, WX, XD)

tt.set_default_device("cpu")

CONTROL_TOL = 2e-4


def _problem(pkg):
    system = pkg.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    costs = (pkg.TargetCost.create(M, XD, weights=WX),
             pkg.ControlCost.create(N_MAT, UD, weights=WU))
    constraints = (pkg.ControlBoundConstraint.create(U_LOWER, U_UPPER),)
    return system, costs, constraints


def _zeros_like(warm):
    return tt.WarmStart(*(torch.zeros_like(getattr(warm, f))
                          for f in ("x", "y", "z")))


def _equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("x", "y", "z"))


def test_warm_start_roundtrip_and_resume_bit_for_bit(tmp_path):
    system, costs, constraints = _problem(tt)
    sol = tt.solve_mpc(system, costs, constraints).solution
    warm = tt.WarmStart(x=sol.x, y=sol.y, z=sol.z)
    path = os.path.join(tmp_path, "warm.npz")
    save_warm_start(path, warm, tick=42, scenario="unit-test")
    restored, tick = load_warm_start(path, _zeros_like(warm))
    assert tick == 42 and _equal(restored, warm)
    assert all(getattr(restored, f).dtype == torch.float64
               for f in ("x", "y", "z"))
    r1 = tt.solve_mpc(system, costs, constraints, warm_start=warm)
    r2 = tt.solve_mpc(system, costs, constraints, warm_start=restored)
    assert torch.equal(r1.control, r2.control)
    # the reference's layout: leaf_i, and the structure and metadata as
    # uint8 bytes
    with np.load(path) as data:
        assert sorted(data.files) == ["__meta__", "__treedef__", "leaf_0",
                                      "leaf_1", "leaf_2"]
        assert data["__meta__"].dtype == np.uint8
        assert json.loads(bytes(data["__meta__"]).decode()) == {
            "tick": 42, "scenario": "unit-test"}
        np.testing.assert_array_equal(data["leaf_1"], sol.y.numpy())


def test_save_pytree_atomic_meta_and_dtypes(tmp_path):
    tree = (torch.arange(4.0), (torch.ones((2, 2)),
                                torch.zeros(3, dtype=torch.int32)),
            None, [torch.tensor(7, dtype=torch.int64)])
    path = os.path.join(tmp_path, "tree.npz")
    save_pytree(path, tree, {"note": "x"})
    assert not os.path.exists(path + ".tmp")
    like = (torch.zeros(4), (torch.zeros((2, 2)), torch.zeros(3)), None,
            [torch.zeros(())])
    restored, meta = load_pytree(path, like)
    assert meta == {"note": "x"}
    assert torch.equal(restored[0], tree[0]) and restored[2] is None
    assert restored[1][1].dtype == torch.int32        # the saved dtype
    assert restored[3][0].dtype == torch.int64
    assert int(restored[3][0]) == 7
    # a tree holds tensors: a dict or a numpy leaf is refused
    for bad in ({"a": torch.zeros(1)}, (np.zeros(2),)):
        with pytest.raises(TypeError, match="checkpoint tree holds"):
            save_pytree(path, bad)


def test_mismatched_template_raises(tmp_path):
    warm = tt.WarmStart(x=torch.arange(6.0), y=torch.ones(9),
                        z=torch.zeros(9))
    path = os.path.join(tmp_path, "warm.npz")
    save_pytree(path, warm)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(path, (torch.zeros(6), torch.zeros(9), torch.zeros(9)))
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(path, [torch.zeros(6)])
    with pytest.raises(ValueError, match="leaf 1 shape mismatch"):
        load_pytree(path, tt.WarmStart(x=torch.zeros(6), y=torch.zeros(8),
                                       z=torch.zeros(9)))
    dcp_path = os.path.join(tmp_path, "warm_dcp")
    save_pytree_dcp(dcp_path, warm)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree_dcp(dcp_path, [torch.zeros(6), torch.zeros(9),
                                   torch.zeros(9)])
    with pytest.raises(ValueError, match="leaf 2 shape mismatch"):
        load_pytree_dcp(dcp_path, tt.WarmStart(
            x=torch.zeros(6), y=torch.zeros(9), z=torch.zeros(10)))


def test_stagewise_warm_tuple_roundtrip_and_resume(tmp_path):
    """The stagewise warm tuple (the config-5 fleet state) through both
    formats; resuming from either restored tuple gives the unbroken tick
    bit for bit."""
    sqp = from_mpc(*_problem(tt))
    opts = tt.SolverOptions(max_iter=60, early_exit=False)
    _, _, _, warm = solve_stagewise(sqp, opts, return_warm=True)
    assert isinstance(warm, tuple) and len(warm) == 4
    path = os.path.join(tmp_path, "stagewise_warm.npz")
    save_pytree(path, warm, {"kind": "stagewise-warm"})
    restored, meta = load_pytree(path, warm)
    assert meta["kind"] == "stagewise-warm"
    dcp_path = os.path.join(tmp_path, "stagewise_dcp")
    save_pytree_dcp(dcp_path, warm)
    from_dcp = load_pytree_dcp(dcp_path, tuple(torch.zeros_like(w)
                                               for w in warm))
    nxt = dataclasses.replace(sqp, x0=sqp.x0 + 0.01)
    ref = solve_stagewise(nxt, opts, warm_start=warm)
    for got in (restored, from_dcp):
        assert all(torch.equal(a, b) for a, b in zip(got, warm))
        res = solve_stagewise(nxt, opts, warm_start=got)
        assert torch.equal(res[1], ref[1]) and torch.equal(res[0], ref[0])


def test_dcp_roundtrip_of_a_solution_tree(tmp_path):
    """``save_pytree_dcp`` / ``load_pytree_dcp`` (the orbax pair's
    counterpart) round-trip a ``QPSolution`` with its integer leaves into
    the template's dtypes and device, bit for bit."""
    system, costs, constraints = _problem(tt)
    sol = tt.solve_mpc(system, costs, constraints).solution
    path = os.path.join(tmp_path, "solution")
    save_pytree_dcp(path, (sol, None))
    like = (tt.QPSolution(**{f.name: torch.zeros_like(getattr(sol, f.name))
                             for f in dataclasses.fields(sol)}), None)
    got, none = load_pytree_dcp(path, like)
    assert none is None
    for f in dataclasses.fields(sol):
        assert torch.equal(getattr(got, f.name), getattr(sol, f.name))
        assert getattr(got, f.name).dtype == getattr(sol, f.name).dtype


def test_reference_warm_start_carries_over(tmp_path):
    """A warm start written by ``copra_tpu.checkpoint.save_warm_start``,
    read with numpy and carried over with ``convert.warm_from_numpy``:
    the port's resumed solve meets the reference's resumed solve at the
    golden control tolerance."""
    jsys, jcosts, jcons = _problem(ct)
    jsol = ct.solve_mpc(jsys, jcosts, jcons).solution
    jwarm = ct.WarmStart(x=jsol.x, y=jsol.y, z=jsol.z)
    path = os.path.join(tmp_path, "reference_warm.npz")
    jax_save_warm_start(path, jwarm, tick=7)
    with np.load(path) as data:
        fields = {k: data[f"leaf_{i}"] for i, k in enumerate("xyz")}
        assert json.loads(bytes(data["__meta__"]).decode())["tick"] == 7
    warm = warm_from_numpy(fields)
    assert torch.equal(warm.x, torch.tensor(np.asarray(jwarm.x)))
    x1 = SMALL_X0 + np.array([0.0, 0.05])
    want = ct.solve_mpc(jsys.with_x0(jnp.asarray(x1)), jcosts, jcons,
                        warm_start=jwarm).control
    system, costs, constraints = _problem(tt)
    got = tt.solve_mpc(system.with_x0(torch.tensor(x1)), costs, constraints,
                       warm_start=warm).control
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) \
        <= CONTROL_TOL
