"""The single-rigid-body (SRB) trotting quadruped of convex MPC, linearised
at each tick's state: batched torch ops that a captured CUDA graph holds.

Di Carlo, Wensing, Katz, Bledt and Kim, "Dynamic Locomotion in the MIT
Cheetah 3 Through Convex Model-Predictive Control" (IROS 2018).  The state
is roll, pitch, yaw, position, world angular rate and velocity (12); the
controls are the four feet's ground-reaction forces (12).  With roll and
pitch small,

    d(rpy)/dt = R_z(psi)' omega,   d omega/dt = I_w^-1 sum_i r_i x f_i,
    dp/dt = v,                     dv/dt = sum_i f_i / m + g,

with ``I_w = R_z(psi) I_b R_z(psi)'`` and the lever arms ``r_i = R_z(psi)
r_i^b`` of the nominal foot positions ``r_i^b`` in the body frame.  The
dynamics depend on the yaw, so the QP is linearised again at every MPC
step at the measured ``psi_0`` (forward Euler over ``dt``); a foot in
swing carries no force (its column of ``B`` is zero, and its force is
boxed to 0 in the QP), so ``B_k`` depends on the gait's contact at stage
``k``.  Gravity is the affine term ``d``.

:class:`TrotModel` holds what is fixed for a fleet (the body, the gait,
each robot's phase, the weights); :func:`linearise` maps the fleet's
states ``x0 [B, 12]`` to the tick's :class:`~copra_tpu_torch.qp.riccati.
TickData`; :func:`trot_qp` builds the whole batched
:class:`~copra_tpu_torch.qp.riccati.StagewiseQP` (boxes, friction
pyramid, weights) around one such linearisation.  Nothing here reads a
tensor back to the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from .qp.riccati import StagewiseQP, TickData

Tensor = torch.Tensor

# the nominal feet in the body frame, front-left, front-right, hind-left,
# hind-right (m); the trot's diagonal pairs are (0, 3) and (1, 2)
FEET = ((0.22, 0.15, -0.3), (0.22, -0.15, -0.3), (-0.22, 0.15, -0.3),
        (-0.22, -0.15, -0.3))
PAIRS = ((0, 3), (1, 2))


def _cross_matrix(r: Tensor) -> Tensor:
    """``[r]x`` of ``r [..., 3]``: ``[r]x f = r x f``."""
    z = torch.zeros_like(r[..., 0])
    x, y, w = r[..., 0], r[..., 1], r[..., 2]
    return torch.stack([torch.stack([z, -w, y], -1),
                        torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def contact_schedule(phase_steps: Tensor, N: int, period_steps: int,
                     stance_steps: int) -> Tensor:
    """``[R, N, 4]`` bool: true where a foot is in stance at stage ``k`` of a
    robot whose gait is ``phase_steps`` steps into its period.  The pair
    (0, 3) stands for the first ``stance_steps`` of the period, the pair
    (1, 2) for the rest (a trot at duty ``stance_steps / period_steps`` =
    0.5)."""
    k = torch.arange(N, device=phase_steps.device)
    first = ((phase_steps[:, None] + k[None]) % period_steps) < stance_steps
    legs = torch.tensor([leg in PAIRS[0] for leg in range(4)],
                        device=phase_steps.device)
    # a foot stands when its pair does
    return first[..., None] == legs


@dataclasses.dataclass(frozen=True)
class TrotModel:
    """What is fixed for a fleet: horizon ``N`` and step ``dt``, the body's
    ``mass``, the feet's lever operators ``arms = I_b^-1 [r_b]x`` (the
    inertia ``I_b`` in the body frame), the gait's ``contact [R, N, 4]``,
    the state weights ``w [12]`` (the terminal stage's times
    ``terminal``), the control weight ``r``, the standing ``height`` and
    gravity.  Its tensors share the fleet's dtype and device."""

    N: int
    dt: float
    mass: float
    arms: Tensor           # [4, 3, 3]
    contact: Tensor        # [R, N, 4]
    w: Tensor              # [12]
    terminal: float
    r: float
    height: float
    gravity: float = 9.81

    @staticmethod
    def create(phase_steps: Sequence[int], *, N: int, dt: float,
               mass: float, inertia: Sequence[float],
               w: Sequence[float], terminal: float, r: float,
               height: float, period_s: float, duty: float,
               gravity: float = 9.81, dtype=torch.float32,
               device=None) -> "TrotModel":
        """A fleet of robots trotting in place, robot ``i`` its gait
        ``phase_steps[i]`` steps into its period of ``period_s`` (a whole
        number of ``dt`` steps)."""
        kd = dict(dtype=dtype, device=device)
        period = int(round(period_s / dt))
        stance = int(round(duty * period))
        if abs(period * dt - period_s) > 1e-9 or not 0 < stance < period:
            raise ValueError(f"the gait period {period_s} s is not a whole "
                             f"number of {dt}-s steps, or duty {duty} "
                             f"leaves no stance or no swing")
        phase = torch.as_tensor(phase_steps, dtype=torch.int64,
                                device=device)
        contact = contact_schedule(phase, N, period, stance).to(dtype)
        f64 = dict(dtype=torch.float64, device=device)
        arms = (torch.linalg.inv(torch.diag(torch.tensor(inertia, **f64)))
                @ _cross_matrix(torch.tensor(FEET, **f64)))
        return TrotModel(N=N, dt=dt, mass=mass, arms=arms.to(dtype),
                         contact=contact,
                         w=torch.tensor(w, **kd), terminal=terminal, r=r,
                         height=height, gravity=gravity)


def _yaw(psi: Tensor):
    """``R_z(psi) [B, 3, 3]``."""
    c, s = torch.cos(psi), torch.sin(psi)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def linearise(model: TrotModel, x0: Tensor) -> TickData:
    """The tick's problem data at the fleet's states ``x0 [B, 12]``:
    ``A [B, N, 12, 12]`` at each robot's yaw, ``B [B, N, 12, 12]`` at its
    yaw and the gait's contact, gravity ``d``, and the linear state costs
    ``qx`` that hold the robot where it stands (its position and heading,
    the model's height, roll, pitch and every rate at zero)."""
    nb, N, dt = x0.shape[0], model.N, model.dt
    kd = dict(dtype=x0.dtype, device=x0.device)
    R = _yaw(x0[:, 2])                                       # [B, 3, 3]
    A = torch.eye(12, **kd).repeat(nb, 1, 1)
    A[:, 0:3, 6:9] += dt * R.mT
    A[:, 3:6, 9:12] += dt * torch.eye(3, **kd)
    # I_w^-1 [R r_b]x = R I_b^-1 [r_b]x R'
    arms = model.arms.to(**kd)                               # [4, 3, 3]
    ang = dt * (R[:, None] @ arms[None] @ R.mT[:, None])     # [B, 4, 3, 3]
    lin = (dt / model.mass) * torch.eye(3, **kd)
    Bl = torch.zeros((nb, 12, 4, 3), **kd)
    Bl[:, 6:9] = ang.permute(0, 2, 1, 3)
    Bl[:, 9:12] = lin[None, :, None, :]
    Bk = (Bl[:, None] * model.contact.to(**kd)[:, :, None, :, None]
          ).reshape(nb, N, 12, 12)
    d = torch.zeros((nb, N, 12), **kd)
    d[..., 11] = -model.gravity * dt
    ref = torch.zeros((nb, 12), **kd)
    ref[:, 2:5] = x0[:, 2:5]
    ref[:, 5] = model.height
    q = -(model.w.to(**kd) * ref)                            # [B, 12]
    qx = q[:, None].repeat(1, N + 1, 1)
    qx[:, N] *= model.terminal
    return TickData(A=A[:, None].expand(nb, N, 12, 12), B=Bk, d=d, qx=qx,
                    ru=torch.zeros((nb, N, 12), **kd))


def trot_qp(model: TrotModel, x0: Tensor, *, mu: float, fz_max: float,
            tilt: float, height_range: Sequence[float]) -> StagewiseQP:
    """The fleet's batched QP at ``x0 [B, 12]``: :func:`linearise`'s data,
    the quadratic costs ``diag(w)`` (the terminal stage's times
    ``terminal``) and ``r I``, roll and pitch within ``+-tilt``, the
    height within ``height_range``, ``0 <= f_z <= fz_max`` on a foot in
    stance and ``f = 0`` in swing (boxes with ``lo = hi``), and the
    friction pyramid ``|f_x|, |f_y| <= mu f_z`` of every foot as 16 rows a
    stage."""
    data = linearise(model, x0)
    nb, N = x0.shape[0], model.N
    kd = dict(dtype=x0.dtype, device=x0.device)
    inf = math.inf
    Qx = torch.diag(model.w.to(**kd)).repeat(nb, N + 1, 1, 1)
    Qx[:, N] *= model.terminal
    xlb = torch.full((nb, N + 1, 12), -inf, **kd)
    xub = torch.full((nb, N + 1, 12), inf, **kd)
    xlb[..., 0:2], xub[..., 0:2] = -tilt, tilt
    xlb[..., 5], xub[..., 5] = height_range[0], height_range[1]
    stance = model.contact.to(**kd).repeat_interleave(3, dim=-1)
    fz = torch.tensor([0.0, 0.0, 1.0] * 4, **kd)
    free = torch.tensor([1.0, 1.0, 0.0] * 4, **kd)
    # in stance: f_x, f_y free, 0 <= f_z <= fz_max; in swing: 0
    ulb = torch.where((stance > 0) & (free > 0), -inf, 0.0)
    uub = torch.where(stance > 0, torch.where(free > 0, inf, fz_max), 0.0)
    Cu1 = torch.zeros((16, 12), **kd)
    for leg in range(4):
        for j, (col, sign) in enumerate(((0, 1.0), (0, -1.0), (1, 1.0),
                                         (1, -1.0))):
            Cu1[4 * leg + j, 3 * leg + col] = sign
            Cu1[4 * leg + j, 3 * leg + 2] = -mu
    return StagewiseQP(
        A=data.A.contiguous(), B=data.B, d=data.d, Qx=Qx, qx=data.qx,
        Ru=(model.r * torch.eye(12, **kd)).repeat(nb, N, 1, 1), ru=data.ru,
        x0=x0.clone(), xlb=xlb, xub=xub, ulb=ulb.to(**kd),
        uub=uub.to(**kd), Cx=torch.zeros((nb, N, 16, 12), **kd),
        Cu=Cu1.repeat(nb, N, 1, 1), clo=torch.full((nb, N, 16), -inf, **kd),
        chi=torch.zeros((nb, N, 16), **kd))


def stance_model(model: TrotModel) -> TrotModel:
    """The model with every foot down at every stage: the nominal stance
    that a set-up measures its equilibration at."""
    return dataclasses.replace(model, contact=torch.ones_like(
        model.contact[:1]))
