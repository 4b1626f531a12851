"""The random MPC problems of the fuzz suites, drawn in numpy.

A copy of the reference suite's generator (``tests/test_fuzz_frontend.py``,
``_draw_problem``) that takes the package as an argument, so
``copra_tpu`` and ``copra_tpu_torch`` get the same problem from one seed.
It imports numpy only: the port's fuzz tests and ``chip_smoke.py`` (on a
GPU host without JAX) draw from it.
"""

import numpy as np


def host(t) -> np.ndarray:
    """``t`` (a numpy, JAX or PyTorch array on any device) in float64
    numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu()
    return np.asarray(t, np.float64)


def rollout(system, x0, U):
    """The state trajectory ``[x_0, ..., x_N]`` flattened, rolled out in
    numpy: what ``condense`` gives as ``Phi x0 + Psi U + xi``."""
    A, B, d = (host(t) for t in (system.A, system.B, system.d))
    N, u = U.shape[0] // B.shape[-1], B.shape[-1]
    xs = [np.asarray(x0, np.float64)]
    for k in range(N):
        Ak, Bk, dk = (t if t.ndim == n else t[k]
                      for t, n in ((A, 2), (B, 2), (d, 1)))
        xs.append(Ak @ xs[-1] + Bk @ U[k * u:(k + 1) * u] + dk)
    return np.concatenate(xs)


def draw_problem(pkg, seed, eq_rows=True):
    """The reference suite's random MPC problem built with ``pkg``
    (``copra_tpu`` or ``copra_tpu_torch``): every draw is numpy's, so both
    packages get the same problem.  ``eq_rows=False`` leaves out the
    equality rows (their right-hand sides are anchored at the initial
    witness trajectory, so a closed loop that drifts the state can make
    them infeasible; the serving fuzz uses this).  The witness trajectory
    is rolled out in numpy (:func:`rollout`) where the reference's
    generator condenses with the package, so both packages get the same
    bits.  Returns ``(system, costs, constraints, stagewise_ok)``."""
    rng = np.random.default_rng(seed)
    x = int(rng.integers(1, 5))          # state dim 1..4
    u = int(rng.integers(1, min(x, 3) + 1))
    N = int(rng.integers(3, 9))          # horizon 3..8

    # well-behaved dynamics: spectral radius <= ~1.05
    A0 = rng.normal(size=(x, x))
    A0 *= rng.uniform(0.5, 1.05) / max(np.abs(np.linalg.eigvals(A0)).max(),
                                       1e-6)
    B0 = rng.normal(size=(x, u))
    d0 = 0.1 * rng.normal(size=x)
    x0 = rng.normal(size=x)

    if rng.random() < 0.5:
        system = pkg.LTISystem.create(A0, B0, d0, x0, N)
    else:
        As = A0 + 0.05 * rng.normal(size=(N, x, x))
        Bs = B0 + 0.05 * rng.normal(size=(N, x, u))
        ds = d0 + 0.05 * rng.normal(size=(N, x))
        system = pkg.LTVSystem.create(As, Bs, ds, x0)

    # costs: always a PD control cost (bounded problem); random extras.
    # The target pulls hard toward a random state so constraints bind.
    costs = [pkg.SimpleControlCost.create(rng.normal(size=u),
                                          weights=rng.uniform(0.01, 0.1, u))]
    stagewise_ok = True
    if rng.random() < 0.8:
        costs.append(pkg.TargetCost.create(
            rng.normal(size=(x, x)), 3.0 * rng.normal(size=x),
            weights=rng.uniform(0.5, 5.0, x)))
    if rng.random() < 0.6:
        costs.append(pkg.TrajectoryCost.create(
            rng.normal(size=(x, x)), rng.normal(size=x),
            weights=rng.uniform(0.05, 0.5, x)))
    if rng.random() < 0.3:
        costs.append(pkg.SimpleTrajectoryCost.create(
            rng.normal(size=x), weights=rng.uniform(0.05, 0.5, x)))
    if rng.random() < 0.25:
        # MixedCost couples stages: condensed paths only
        costs.append(pkg.MixedCost.create(
            rng.normal(size=(u, x)), rng.normal(size=(u, u)),
            rng.normal(size=u), weights=rng.uniform(0.05, 0.2, u)))
        stagewise_ok = False
    if rng.random() < 0.2:
        # the full-horizon TrajectoryCost entry mode couples stages
        costs.append(pkg.TrajectoryCost.create(
            rng.normal(size=(x, (N + 1) * x)),
            rng.normal(size=x), weights=rng.uniform(0.02, 0.1, x)))
        stagewise_ok = False

    # constraints: always a control box (witness U_w = its center)
    u_lo = -rng.uniform(1.0, 4.0, u)
    u_hi = rng.uniform(1.0, 4.0, u)
    U_w = np.tile((u_lo + u_hi) / 2.0, N)
    constraints = [pkg.ControlBoundConstraint.create(u_lo, u_hi)]

    X_w = rollout(system, x0, U_w)

    if rng.random() < 0.5:
        # trajectory bounds around the witness trajectory, some infinite
        Xb = X_w.reshape(N + 1, x)
        lo = Xb.min(axis=0) - rng.uniform(0.5, 3.0, x)
        hi = Xb.max(axis=0) + rng.uniform(0.5, 3.0, x)
        inf_mask = rng.random(x) < 0.4
        lo = np.where(inf_mask, -np.inf, lo)
        hi = np.where(rng.random(x) < 0.4, np.inf, hi)
        constraints.append(pkg.TrajectoryBoundConstraint.create(lo, hi))
    if rng.random() < 0.5:
        r = int(rng.integers(1, 3))
        E = rng.normal(size=(r, x))
        vals = (E @ X_w.reshape(N + 1, x).T)      # (r, N+1)
        f = vals.max(axis=1) + rng.uniform(0.05, 0.5, r)
        constraints.append(pkg.TrajectoryConstraint.create(E, f))
    if rng.random() < 0.4:
        r = int(rng.integers(1, 3))
        G = rng.normal(size=(r, u))
        vals = G @ U_w.reshape(N, u).T
        f = vals.max(axis=1) + rng.uniform(0.05, 0.5, r)
        constraints.append(pkg.ControlConstraint.create(G, f))
    if rng.random() < 0.4:
        r = int(rng.integers(1, 3))
        E = rng.normal(size=(r, x))
        G = rng.normal(size=(r, u))
        # mixed rows pair x_k with u_k
        vals = (E @ X_w.reshape(N + 1, x)[:-1].T + G @ U_w.reshape(N, u).T)
        f = vals.max(axis=1) + rng.uniform(0.05, 0.5, r)
        constraints.append(pkg.MixedConstraint.create(E, G, f))
    if rng.random() < 0.3:
        # one full-horizon EQUALITY row on X at its witness value
        # (feasible by construction; couples stages)
        e = rng.normal(size=(1, (N + 1) * x))
        if eq_rows:
            constraints.append(pkg.TrajectoryConstraint.create(
                e, e @ X_w, is_inequality=False))
            stagewise_ok = False
    if rng.random() < 0.2:
        # per-step control EQUALITY row at the (step-constant) witness
        G = rng.normal(size=(1, u))
        if eq_rows:
            constraints.append(pkg.ControlConstraint.create(
                G, G @ U_w[:u], is_inequality=False))

    return system, tuple(costs), tuple(constraints), stagewise_ok
