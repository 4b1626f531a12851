"""The one traffic generator: initial states of every lane for every tick.

A traffic file (``benchmark/traffic/<name>.json``) gives the parameters:

- ``mode``: ``"chain"`` (states dispatched ahead, ``ticks_per_call`` ticks
  a call, calls back to back) or ``"periodic"`` (one tick a call, due
  every ``period_ms``; open loop: a late tick delays the next one, and each
  tick's latency runs from when it was due);
- ``pool_ticks``: the length of the state stream, which repeats after it
  (a whole number of calls in ``chain`` mode);
- the states, in one of two ways:

  - ``drift``: ``std`` per state coordinate and ``revert``, so that each
    lane's state is its own mean plus an AR(1) process, ``y_t = revert
    y_{t-1} + e_t``, ``e_t ~ N(0, std)``;
  - ``plant``: each lane is the configuration's own plant (the serving
    module's ``plant(cfg)``: its model, its cost and the columns through
    which a force and a velocity step enter), simulated at the model's
    step under a plain controller, the infinite-horizon LQR of that model
    and cost, with a white force of ``force_std`` (m/s^2) on every step.
    A periodic tick is due every ``period_ms``, a whole number ``k`` of
    model steps, and sees the state after its ``k`` steps;

  either made periodic over the pool (a circular convolution), so that
  the stream wraps around without a jump;
- ``pushes`` (optional, ``plant`` only): ``per_robot_second`` velocity
  steps of ``+-velocity`` (a random sign per lane) on the ``group``
  consecutive lanes of one robot, each landing just before a tick: exactly
  ``round(per_robot_second * pool seconds * robots)`` of them, at (tick,
  robot) pairs drawn without replacement; the plain controller then
  brings the robot back;
- ``sample``: how many ticks the correctness check keeps (``count``) and
  how many lanes of each (``lanes``), besides the lanes pushed there;
- ``sources``: where each value comes from (read by nothing).

The configuration gives the lanes' state (``x0_nominal``) and the spread of
their means (``x0_spread``).  Everything is drawn from the seed: the same
seed gives the same stream, and every seed the same number of pushes.
"""

from __future__ import annotations

import numpy as np
import torch


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), stream])


def steps_per_tick(spec: dict, plant: dict) -> int:
    """The model steps between two periodic ticks: ``period_ms`` over the
    plant's step, which has to be a whole number."""
    k = float(spec["period_ms"]) / 1e3 / float(plant["step_s"])
    if k < 0.5 or abs(k - round(k)) > 1e-9:
        raise ValueError(f"period_ms {spec['period_ms']} is not a whole "
                         f"number of the plant's {plant['step_s']} s steps")
    return int(round(k))


def push_plan(traffic: dict, lanes: int, seed: int):
    """``(ticks, groups)`` of every push, sorted by tick, or two empty
    arrays."""
    spec = traffic.get("pushes")
    P = int(traffic["pool_ticks"])
    if not spec:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    groups = lanes // int(spec["group"])
    seconds = P * float(traffic["period_ms"]) / 1e3
    count = int(round(float(spec["per_robot_second"]) * seconds * groups))
    flat = np.sort(_rng(seed, 3).choice(P * groups, size=count,
                                        replace=False))
    return flat // groups, flat % groups


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one stream of the seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % 2 ** 63)


def dare(A, B, Q, R, iters: int = 64):
    """The stabilising solution ``P`` of the discrete algebraic Riccati
    equation ``P = A'PA - A'PB (R + B'PB)^-1 B'PA + Q``, by the doubling
    algorithm (each step doubles the horizon of the Riccati recursion)."""
    Ak, G, H = A, B @ np.linalg.solve(R, B.T), Q
    eye = np.eye(A.shape[0])
    for _ in range(iters):
        W = eye + G @ H
        AW = np.linalg.solve(W.T, Ak.T).T          # A_k W^-1
        H_next = H + Ak.T @ H @ np.linalg.solve(W, Ak)
        G, Ak = G + AW @ G @ Ak.T, AW @ Ak
        done = np.abs(H_next - H).max() <= 1e-15 * np.abs(H_next).max()
        H = H_next
        if done:
            break
    return 0.5 * (H + H.T)


def closed_loop(plant: dict, k: int):
    """``(M, S)``, float64: the plant under its LQR over ``k`` model steps,
    ``x <- M x + S n`` with ``n ~ N(0, I)``: ``M = (A - B K)^k`` and ``S``
    the square root of the covariance that the force noise of those steps
    leaves."""
    A, B = np.asarray(plant["A"], float), np.asarray(plant["B"], float)
    Q, R = np.asarray(plant["Q"], float), np.asarray(plant["R"], float)
    P = dare(A, B, Q, R)
    K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
    Acl = A - B @ K
    G = np.asarray(plant["force"], float) * float(plant["force_std"])
    C, Ak = np.zeros_like(A), np.eye(A.shape[0])
    for _ in range(k):
        C += Ak @ np.outer(G, G) @ Ak.T
        Ak = Acl @ Ak
    w, V = np.linalg.eigh(0.5 * (C + C.T))
    return Ak, V * np.sqrt(np.clip(w, 0.0, None))


def state_pool(cfg: dict, traffic: dict, lanes: int, seed: int, device,
               plant: dict = None, dtype=torch.float32) -> torch.Tensor:
    """``x0 [pool_ticks, lanes, x]`` in ``dtype`` on ``device``: the
    stream of every lane's initial state, drawn on the device."""
    P = int(traffic["pool_ticks"])
    f64 = dict(dtype=torch.float64, device=device)
    nominal = torch.tensor(cfg["x0_nominal"], **f64)
    x = nominal.shape[0]
    spread = torch.tensor(cfg.get("x0_spread", [0.0] * x), **f64)
    means = nominal + spread * torch.randn(
        (lanes, x), generator=generator(seed, 1, device), **f64)
    e = torch.randn((P, lanes, x), generator=generator(seed, 2, device),
                    **f64)
    if "plant" in traffic:
        M, S = closed_loop(dict(plant, **traffic["plant"]),
                           steps_per_tick(traffic, plant))
        e = e @ torch.tensor(S, **f64).T
    else:
        drift = traffic["drift"]
        M = float(drift["revert"]) * np.eye(x)
        e = e * torch.tensor(drift["std"], **f64)
    spec = traffic.get("pushes")
    if spec:
        ticks, groups = push_plan(traffic, lanes, seed)
        g = int(spec["group"])
        signs = np.where(_rng(seed, 4).random((len(ticks), g)) < 0.5,
                         -1.0, 1.0) * float(spec["velocity"])
        step = torch.tensor(plant["velocity"], **f64)
        for j in range(g):
            e[torch.as_tensor(ticks, device=device),
              torch.as_tensor(groups * g + j, device=device)] += \
                torch.as_tensor(signs[:, j], **f64)[:, None] * step
    # the periodic filter: y_t = M y_{t-1} + e_t, i.e. y_t = sum_j H_j
    # e_{t-j} over the pool, circular, H_j = M^j (I - M^P)^-1
    H = np.empty((P, x, x))
    H[0] = np.linalg.inv(np.eye(x) - np.linalg.matrix_power(M, P))
    for j in range(1, P):
        H[j] = M @ H[j - 1]
    Hf = torch.fft.rfft(torch.tensor(H, **f64), dim=0)
    Ef = torch.fft.rfft(e, dim=0)
    y = torch.fft.irfft(torch.einsum("fij,flj->fli", Hf, Ef), n=P, dim=0)
    return (means[None] + y).to(dtype)


class Traffic:
    """One traffic file read for one cell and seed: the stream ``pool``,
    the pushes and the lanes the check keeps of each tick.  ``plant`` is
    the serving module's ``plant(cfg)``, for a file with a ``plant``."""

    def __init__(self, spec: dict, cfg: dict, lanes: int, seed: int,
                 device, plant: dict = None):
        self.spec, self.lanes, self.seed = spec, int(lanes), int(seed)
        self.mode = spec["mode"]
        self.pool_ticks = int(spec["pool_ticks"])
        if self.mode == "chain" and \
                self.pool_ticks % int(spec["ticks_per_call"]):
            raise ValueError(
                f"pool_ticks {self.pool_ticks} is not a whole number of "
                f"calls of {spec['ticks_per_call']} ticks: a call at the "
                f"pool's end would run short")
        if ("plant" in spec or "pushes" in spec) and plant is None:
            raise ValueError("a traffic file with a plant or pushes needs "
                             "the configuration's plant")
        if "plant" not in spec and "pushes" in spec:
            raise ValueError("pushes need a plant that recovers from them")
        self.pool = state_pool(cfg, spec, self.lanes, self.seed, device,
                               plant)
        self.push_ticks, self.push_groups = push_plan(spec, self.lanes,
                                                      self.seed)
        self.samples = int(spec["sample"]["count"])

    def sample_lanes(self, tick: int):
        """The lanes the check keeps of ``tick`` (an index into the pool):
        a draw of ``sample.lanes`` lanes, and every lane pushed there."""
        k = int(self.spec["sample"]["lanes"])
        pick = set(_rng(self.seed, 10 + tick).choice(
            self.lanes, size=min(k, self.lanes), replace=False).tolist())
        if self.push_ticks.size:
            g = int(self.spec["pushes"]["group"])
            for grp in self.push_groups[self.push_ticks == tick]:
                pick.update(range(int(grp) * g, int(grp) * g + g))
        return sorted(pick)


class Reservoir:
    """A uniform sample, drawn from the seed, of ``count`` of the calls a
    window makes (Algorithm R): ``offer(i)`` says which slot call ``i``
    takes, or None."""

    def __init__(self, count: int, seed: int):
        self.count = int(count)
        self.rng = _rng(seed, 5)

    def offer(self, i: int):
        if i < self.count:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.count else None
