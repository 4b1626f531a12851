"""Fused stagewise Riccati-in-ADMM tick: the plain PyTorch version, the
wrappers of the hand-written CUDA kernel, and the host side that packs a
:class:`~copra_tpu_torch.qp.riccati.StagewiseQP` for it.

Port of ``copra_tpu/ops/stagewise_kernel.py``.  Two facts make a fused
tick possible: the ridged stage Hessians are iteration-invariant, so the
Riccati gains are computed once per plan (:func:`precompute_lqr_gains`)
and each ADMM iteration runs only the linear backward and forward sweeps;
and the whole fixed-count loop runs in one kernel launch that streams each
stage's plan rows into shared memory ahead of its sweep step.

:func:`fused_stagewise_tick` and :func:`fused_stagewise_tick_streamed`
are the counterparts of the reference's resident and streamed Pallas
entry points (``stagewise_kernel.py:418`` and ``:791``).  Both take one
packed layout with the lane axis last: ``plan [N+1, C, B]``, ``warm [N+1,
W, B]``, ``work [N+1, Kw, B]`` and ``x0 [x, B]`` (:class:`_Layout`), and
both are served by one kernel, ``copra_tpu_torch/csrc/stagewise_tick.cu``
(a lane a warp for the shapes :func:`warp_body` names, else a lane a
block; on lane-first copies that :func:`_launch` makes and undoes), for
every shape inside :func:`check_fused_envelope`.  The reference's
resident/streamed split was a VMEM budget; here
:func:`fused_mode` keeps only its component rule to choose the entry
point.  Dropped as Mosaic layout machinery: ``_pad8``, ``LANES`` and the
128-lane padding, the streamed mode's transposed forward copies, the
VMEM budget and the ``COPRA_FUSED_*`` switches.

:func:`stagewise_tick_plain` is the plain version: the same formulas in
the same order (sums with the index ascending), batched over lanes, with
Python loops over stages.  A wrapper takes it only for tensors on the CPU;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from .. import profiling
from .._precision import highest_precision
from .._tensors import matvec as _mv, matvec_t as _mtv
from ._derivative import refuse_gradient
from .build import load_library
from .counts import counted

Tensor = torch.Tensor

MAX_WIDTH = 128          # x + u + r, the reference's streamed-mode limit
SMEM_LIMIT = 232448      # shared memory one H100 block may use (227 KB)
MAX_STAGES = 8           # stage tiles in the block body's ring, at most
WARP_WIDTH = 24          # x + max(u, r) the warp body serves, at most
WARP_MAX = 16            # x, u and r the warp body serves, at most
WARP_GROUP = 16          # stage tiles a slot of the warp body's ring, most
WARP_TILES = 32          # stage tiles in the warp body's ring, at most
WARP_BAR_BYTES = 32      # the warp body's slot mbarriers


@dataclasses.dataclass(frozen=True)
class LQRGains:
    """Iteration-invariant Riccati operators: per stage ``k`` (with ``V =
    V_{k+1}`` of the quadratic recursion) the feedback ``K [N, u, x]``,
    the negated inverse inner Hessian ``nF = -F^{-1} [N, u, u]``, the
    cross operator ``G = S' + B'VA [N, u, x]`` and the constant drift
    terms ``bvd = B'Vd [N, u]``, ``avd = A'Vd [N, x]``."""

    K: Tensor
    nF: Tensor
    G: Tensor
    bvd: Tensor
    avd: Tensor


@highest_precision
def precompute_lqr_gains(A: Tensor, B: Tensor, d: Tensor, Qx: Tensor,
                         Ru: Tensor, S: Optional[Tensor] = None
                         ) -> LQRGains:
    """The quadratic Riccati backward recursion -> :class:`LQRGains` (the
    recursion of ``lqr_solve`` restricted to the quadratic terms; leading
    batch dims allowed).  Run once per plan."""
    N, udim = A.shape[-3], B.shape[-1]
    if S is None:
        S = torch.zeros(A.shape[:-1] + (udim,), dtype=A.dtype,
                        device=A.device)
    eye = torch.eye(udim, dtype=A.dtype, device=A.device)
    V = Qx[..., N, :, :]
    K, nF, G, bvd, avd = ([None] * N for _ in range(5))
    for k in range(N - 1, -1, -1):
        A_k, B_k, d_k = A[..., k, :, :], B[..., k, :, :], d[..., k, :]
        BtV = B_k.mT @ V
        F = Ru[..., k, :, :] + BtV @ B_k
        G[k] = S[..., k, :, :].mT + BtV @ A_k
        Finv = torch.cholesky_solve(eye.expand(F.shape),
                                    torch.linalg.cholesky(F))
        K[k], nF[k] = -Finv @ G[k], -Finv
        AtV = A_k.mT @ V
        bvd[k], avd[k] = _mv(BtV, d_k), _mv(AtV, d_k)
        V = Qx[..., k, :, :] + AtV @ A_k + G[k].mT @ K[k]
        V = 0.5 * (V + V.mT)
    return LQRGains(K=torch.stack(K, dim=-3), nF=torch.stack(nF, dim=-3),
                    G=torch.stack(G, dim=-3), bvd=torch.stack(bvd, dim=-2),
                    avd=torch.stack(avd, dim=-2))


@highest_precision
def lqr_solve_fixed(gains: LQRGains, A: Tensor, B: Tensor, d: Tensor,
                    qx: Tensor, ru: Tensor, x0: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Linear-terms-only LQ solve with precomputed gains: exactly
    ``lqr_solve`` for the ``(Qx, Ru, S)`` the gains were built from.
    Leading batch dims allowed; returns ``(X [N+1, x], U [N, u])``."""
    N = A.shape[-3]
    v = qx[..., N, :]
    ks = [None] * N
    for k in range(N - 1, -1, -1):
        h = ru[..., k, :] + _mtv(B[..., k, :, :], v) + gains.bvd[..., k, :]
        ks[k] = _mv(gains.nF[..., k, :, :], h)
        v = (qx[..., k, :] + _mtv(A[..., k, :, :], v) + gains.avd[..., k, :]
             + _mtv(gains.G[..., k, :, :], ks[k]))
    X, U = [x0], []
    for k in range(N):
        U.append(_mv(gains.K[..., k, :, :], X[-1]) + ks[k])
        X.append(_mv(A[..., k, :, :], X[-1]) + _mv(B[..., k, :, :], U[-1])
                 + d[..., k, :])
    return torch.stack(X, dim=-2), torch.stack(U, dim=-2)


class _Layout:
    """Row offsets of the packed tensors (mirrored by ``Layout`` in
    ``csrc/stagewise_tick.cu``).

    ``plan [N+1, C, B]`` per stage: ``A`` (row-major, ``A[i][j]`` at
    ``A + i*x + j``), ``B``, ``d``, the gains ``K`` and ``nF``, the base
    linear costs ``qb = qx + A'Vd`` and ``rb = ru + B'Vd`` (the gains'
    constant drift terms folded in), the per-coordinate penalties ``rhox``
    and ``rhou`` (0 where no finite bound), the bounds clamped to
    ``finfo.max/4``, and with rows the normalized ``Cx``, ``Cu``, ``slo``,
    ``shi`` and per-row penalties ``rhos``.  The terminal stage carries
    only ``qb``, ``rhox`` and the state bounds.  ``warm [N+1, W, B]``:
    zX yX | zU yU | zS yS.  ``work [N+1, Kw, B]``: X | U | kk.
    """

    def __init__(self, x: int, u: int, r: int):
        self.x, self.u, self.r = x, u, r
        off = 0

        def take(n):
            nonlocal off
            o = off
            off += n
            return o

        self.A = take(x * x)
        self.B = take(x * u)
        self.d = take(x)
        self.K = take(u * x)
        self.nF = take(u * u)
        self.qb = take(x)
        self.rb = take(u)
        self.rhox = take(x)
        self.rhou = take(u)
        self.xlb = take(x)
        self.xub = take(x)
        self.ulb = take(u)
        self.uub = take(u)
        self.Cx = take(r * x)
        self.Cu = take(r * u)
        self.slo = take(r)
        self.shi = take(r)
        self.rhos = take(r)
        self.C = off
        self.zX, self.yX = 0, x
        self.zU, self.yU = 2 * x, 2 * x + u
        self.zS, self.yS = 2 * x + 2 * u, 2 * x + 2 * u + r
        self.W = 2 * x + 2 * u + 2 * r
        self.X, self.U, self.kk = 0, x, x + u
        self.Kw = x + 2 * u


def stagewise_tick_plain(plan: Tensor, x0: Tensor, warm: Tensor, *,
                         n_iter: int, N: int, x: int, u: int, r: int,
                         sigma: float, alpha: float,
                         work: Optional[Tensor] = None,
                         skip: Optional[Tensor] = None,
                         carry: bool = False
                         ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of one fixed-count tick on the packed tensors.

    Each iteration: the backward sweep, stage ``N-1`` down to 0, shifts
    the linear costs by the ADMM penalties and the proximal term and runs
    ``h = rb + B'v``, ``kk = nF h``, ``v <- qs + A'v + K'h`` (``G'kk =
    K'h``); the forward sweep rolls out ``u = kk + K x``, ``x <- d + A x +
    B u`` and, stage by stage, relaxes by ``alpha``, projects ``x`` (stage
    0 pinned to ``x0``), ``u`` and the rows and updates their duals; the
    terminal state's projection comes last.  Returns ``(warm', work)``.

    ``skip`` (with ``work``, the state of a tick before): a one-element
    int32 flag; when it is non-zero the tick is skipped and ``(warm,
    work)`` come back unchanged, as the kernel returns at its entry (the
    top-up of a tick whose lanes all converged).  Here the flag is read on
    the host.

    The proximal centre ``(X, U)`` of the first iteration is ``(zX, zU)``
    of ``warm``; with ``carry`` it is the ``X``, ``U`` rows of ``work``
    as given, so that a run continues the one that returned ``(warm,
    work)`` as if it had not stopped (the chunks of the early-exit solve,
    the polish from a delivered iterate).
    """
    lo = _Layout(x, u, r)
    if (skip is not None or carry) and work is None:
        raise ValueError("skip and carry need the work tensor they keep")
    if skip is not None and bool(skip):
        return warm.clone(), work.clone()
    oma = 1.0 - alpha
    tiny = 1e-30
    warm = warm.clone()
    if carry:
        work = work.clone()
    else:
        work = torch.zeros((N + 1, lo.Kw, plan.shape[-1]), dtype=plan.dtype,
                           device=plan.device)
        work[:, lo.X:lo.X + x] = warm[:, lo.zX:lo.zX + x]
        work[:N, lo.U:lo.U + u] = warm[:N, lo.zU:lo.zU + u]

    def rows(t, off, n):            # n consecutive rows of a stage
        return t[off:off + n]

    def col(t, off, j, n, stride):  # column j of a row-major [n, stride]
        return t[off + j:off + n * stride:stride]

    def shifted(p, w, wk, base, rho, z, y, var, n):
        return (rows(p, base, n) - (rows(p, rho, n) * rows(w, z, n)
                                    - rows(w, y, n))
                - sigma * rows(wk, var, n))

    def project(p, w, v, rho, lb, ub, z, y, n, pin=False):
        rv = rows(p, rho, n)
        vr = alpha * v + oma * rows(w, z, n)
        yo = rows(w, y, n)
        zn = torch.where(rv > 0, torch.clamp(vr + yo / rv.clamp_min(tiny),
                                             rows(p, lb, n),
                                             rows(p, ub, n)), vr)
        if pin:                     # x_0 is data: pin its copy
            zn = v
        yn = yo + rv * (vr - zn)
        w[z:z + n] = zn
        w[y:y + n] = yn

    for _ in range(int(n_iter)):
        v = shifted(plan[N], warm[N], work[N], lo.qb, lo.rhox, lo.zX, lo.yX,
                    lo.X, x)
        for k in range(N - 1, -1, -1):
            p, w, wk = plan[k], warm[k], work[k]
            qs = shifted(p, w, wk, lo.qb, lo.rhox, lo.zX, lo.yX, lo.X, x)
            hb = shifted(p, w, wk, lo.rb, lo.rhou, lo.zU, lo.yU, lo.U, u)
            if r:
                vS = rows(p, lo.rhos, r) * rows(w, lo.zS, r) \
                    - rows(w, lo.yS, r)
                for j in range(r):
                    qs = qs - rows(p, lo.Cx + j * x, x) * vS[j]
                    hb = hb - rows(p, lo.Cu + j * u, u) * vS[j]
            h = hb
            for i in range(x):
                h = h + rows(p, lo.B + i * u, u) * v[i]
            kk = col(p, lo.nF, 0, u, u) * h[0]
            for b in range(1, u):
                kk = kk + col(p, lo.nF, b, u, u) * h[b]
            wk[lo.kk:lo.kk + u] = kk
            vn = qs
            for j in range(x):
                vn = vn + rows(p, lo.A + j * x, x) * v[j]
            for a in range(u):
                vn = vn + rows(p, lo.K + a * x, x) * h[a]
            v = vn

        xs = x0
        work[0, lo.X:lo.X + x] = xs
        for k in range(N):
            p, w, wk = plan[k], warm[k], work[k]
            uk = rows(wk, lo.kk, u)
            for i in range(x):
                uk = uk + col(p, lo.K, i, u, x) * xs[i]
            wk[lo.U:lo.U + u] = uk
            project(p, w, xs, lo.rhox, lo.xlb, lo.xub, lo.zX, lo.yX, x,
                    pin=k == 0)
            project(p, w, uk, lo.rhou, lo.ulb, lo.uub, lo.zU, lo.yU, u)
            if r:
                s = col(p, lo.Cx, 0, r, x) * xs[0]
                for i in range(1, x):
                    s = s + col(p, lo.Cx, i, r, x) * xs[i]
                for a in range(u):
                    s = s + col(p, lo.Cu, a, r, u) * uk[a]
                rs = rows(p, lo.rhos, r)
                sr = alpha * s + oma * rows(w, lo.zS, r)
                yo = rows(w, lo.yS, r)
                zn = torch.clamp(sr + yo / rs, rows(p, lo.slo, r),
                                 rows(p, lo.shi, r))
                yn = yo + rs * (sr - zn)
                w[lo.zS:lo.zS + r] = zn
                w[lo.yS:lo.yS + r] = yn
            xn = rows(p, lo.d, x)
            for j in range(x):
                xn = xn + col(p, lo.A, j, x, x) * xs[j]
            for a in range(u):
                xn = xn + col(p, lo.B, a, x, u) * uk[a]
            work[k + 1, lo.X:lo.X + x] = xn
            xs = xn
        project(plan[N], warm[N], xs, lo.rhox, lo.xlb, lo.xub, lo.zX,
                lo.yX, x)
    return warm, work


_lib = None

# the offsets csrc/stagewise_tick.cu's make_layout reports, in its order
_LAY_FIELDS = ("A", "B", "d", "K", "nF", "qb", "rb", "rhox", "rhou", "xlb",
               "xub", "ulb", "uub", "Cx", "Cu", "slo", "shi", "rhos", "C",
               "zX", "yX", "zU", "yU", "zS", "yS", "W", "X", "U", "kk", "Kw")
# (N, x, u, r) whose layout and launch plan _load checks against the C++
_CHECKED = ((300, 3, 1, 2), (12, 3, 2, 2), (12, 3, 2, 0), (40, 6, 2, 4),
            (40, 12, 12, 12), (8, 32, 32, 32), (10, 64, 64, 0),
            (3000, 100, 20, 8), (10, 2, 1, 0), (12, 12, 12, 4),
            (12, 13, 12, 4), (12, 16, 8, 4), (12, 20, 12, 4),
            (7, 31, 1, 1))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = load_library("stagewise_tick")
    p, i, dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.copra_stagewise_tick.restype = i
    lib.copra_stagewise_tick.argtypes = ([p] * 3 + [i] * 7 + [dbl] * 2
                                         + [p, i, p])
    lib.copra_stagewise_prepare.restype = i
    lib.copra_stagewise_prepare.argtypes = []
    lib.copra_stagewise_layout.restype = None
    lib.copra_stagewise_layout.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.copra_stagewise_ring_config.restype = None
    lib.copra_stagewise_ring_config.argtypes = [i] * 5 + [ctypes.POINTER(i)]
    lib.copra_stagewise_error_string.restype = ctypes.c_char_p
    lib.copra_stagewise_error_string.argtypes = [i]
    for N, x, u, r in _CHECKED:     # the C++ layout and plan are this module's
        out = (ctypes.c_int * len(_LAY_FIELDS))()
        lib.copra_stagewise_layout(x, u, r, out)
        lo = _Layout(x, u, r)
        if tuple(out) != tuple(getattr(lo, f) for f in _LAY_FIELDS):
            raise RuntimeError(f"csrc/stagewise_tick.cu disagrees with "
                               f"_Layout{(x, u, r)}: {tuple(out)}")
        for itemsize in (4, 8):
            cfg = (ctypes.c_int * 10)()
            lib.copra_stagewise_ring_config(N, x, u, r, int(itemsize == 8),
                                            cfg)
            want = ring_config(N, x, u, r, itemsize)
            if tuple(cfg) != want:
                raise RuntimeError(
                    f"csrc/stagewise_tick.cu's launch plan for "
                    f"{(N, x, u, r)} x {itemsize} B is {tuple(cfg)}, not "
                    f"{want}")
    _lib = lib
    return lib


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def warp_body(x: int, u: int, r: int) -> bool:
    """Whether the kernel serves a shape with its warp body (mirrored by
    ``warp_body`` in ``csrc/stagewise_tick.cu``): a lane a warp when the
    state coordinates and the control or row coordinates fit in one warp,
    ``x + max(u, r) <= WARP_WIDTH``, none of them above ``WARP_MAX``; the
    block body otherwise.  (Wider shapes ran slower than the block body on
    an H100: (20, 12, 4), whose loops unroll to 32 and spill, and (16, 16,
    16) in float64.)"""
    return x + max(u, r) <= WARP_WIDTH and max(x, u, r) <= WARP_MAX


def ring_config(N: int, x: int, u: int, r: int, itemsize: int
                ) -> Tuple[int, int, int, int, int, int, int, int, int, int]:
    """The kernel's launch plan for a problem (mirrored by
    ``ring_config`` in ``csrc/stagewise_tick.cu``): ``(Cp, Wp, Kwp,
    threads, stages, kk_resident, bytes, unroll, group, warp)``.  Rows
    are padded to 16 bytes.  A block serves a lane: the warp body
    (``warp`` 1, :func:`warp_body`) with one warp, the block body (``warp``
    0) with warps for the state coordinates beside warps for the control
    and row coordinates and its vectors in shared memory.  The ring holds
    as many stage tiles as fit (``WARP_TILES`` at most in the warp body,
    beside its slots' mbarriers; ``MAX_STAGES`` in the block body) beside,
    where they fit, every stage's ``kk``, as ``stages`` ring slots of
    ``group`` tiles each (in the warp body the largest power of two up to
    ``WARP_GROUP`` of which two slots fit; in the block body 4 from 8
    tiles, 2 from 4, else 1; ``stages`` is 0 when not even two tiles
    fit).  The loops over x, u and r unroll to the smallest bound that
    covers the shape: 4, 8 or 16 in the warp body, 4, 16 or 32 in the
    block body (0: rolled, above 32)."""
    lo = _Layout(x, u, r)
    per16 = 16 // itemsize
    Cp, Wp, Kwp = (_round_up(n, per16) for n in (lo.C, lo.W, lo.Kw))
    warp = warp_body(x, u, r)
    threads = 32 if warp else _round_up(x, 32) + _round_up(max(u, r), 32)
    tile = (Cp + Wp + Kwp) * itemsize
    vec = 0 if warp else _round_up((2 * x + 2 * u + r) * itemsize, 16)
    bars = WARP_BAR_BYTES if warp else 0
    budget = SMEM_LIMIT - vec - bars
    kk = _round_up(N * u * itemsize, 16) if warp else N * u * itemsize
    tiles = (budget - kk) // tile
    kk_resident = tiles >= 2
    if not kk_resident:
        tiles = budget // tile
    tiles = min(tiles, WARP_TILES if warp else MAX_STAGES)
    if warp:      # the largest group of which two slots fit
        group = WARP_GROUP
        while group > 1 and tiles < 2 * group:
            group //= 2
    else:
        group = 4 if tiles >= 8 else 2 if tiles >= 4 else 1
    slots = tiles // group
    nbytes = slots * group * tile + (kk if kk_resident else 0) + bars + vec
    w = max(x, u, r)
    unroll = next((m for m in ((4, 8, 16) if warp else (4, 16, 32))
                   if w <= m), 0)
    return (Cp, Wp, Kwp, threads, slots if tiles >= 2 else 0,
            int(kk_resident), nbytes, unroll, group, int(warp))


def _lane_first(t: Tensor, rows_p: int) -> Tensor:
    """Lane-last ``[N+1, rows, B]`` -> lane-first ``[B, N+1, rows_p]``,
    rows zero-padded to ``rows_p``: the kernel's layout, where a lane's
    stage tile is one contiguous run."""
    S, rows, nb = t.shape
    out = t.new_zeros((nb, S, rows_p))
    out[:, :, :rows] = t.permute(2, 0, 1)
    return out


def _lane_last(t: Tensor, rows: int) -> Tensor:
    """Inverse of :func:`_lane_first`: ``[B, N+1, rows_p]`` ->
    ``[N+1, rows, B]``."""
    return t[:, :, :rows].permute(1, 2, 0).contiguous()


def lane_first_plan(plan: Tensor) -> Tensor:
    """The kernel's copy of ``plan [N+1, C, B]``: ``[B, N+1, Cp]``, rows
    padded to 16 bytes.  A caller that ticks one plan many times makes it
    once (:class:`FusedStagewisePlan` holds it) and passes it as
    ``plan_lf``; otherwise every launch makes it anew."""
    return _lane_first(plan, _round_up(plan.shape[1],
                                       16 // plan.element_size()))


_prepared = set()


def _prepare(lib, dev) -> None:
    """Opt every instantiation of the kernel into the dynamic shared
    memory it may use, once per device, so that a launch sets nothing (a
    captured launch is one kernel node)."""
    if dev.index in _prepared:
        return
    with torch.cuda.device(dev):
        rc = lib.copra_stagewise_prepare()
    if rc != 0:
        raise RuntimeError(
            f"stagewise tick kernel: setting its shared-memory attribute "
            f"failed: CUDA error {rc} "
            f"({lib.copra_stagewise_error_string(rc).decode()})")
    _prepared.add(dev.index)


# the host counters of the kernel's launches by body: each launch the host
# issues (a captured one included; a graph's replays are not issued)
LAUNCH_COUNTERS = ("stagewise.launches.warp", "stagewise.launches.block")


def _launch(plan, x0, warm, *, n_iter, N, x, u, r, sigma, alpha,
            plan_lf=None, work=None, skip=None, carry=False):
    """Check the lane-last tensors, make the kernel's lane-first copies
    (``plan_lf`` if given, and the state: warm | work per stage), launch
    it and return ``(warm', work)`` lane-last again.  With ``skip`` (a
    one-element int32 flag on the device) or ``carry`` the state also
    takes ``work``: the kernel returns at its entry when the flag is set,
    leaving ``(warm, work)`` as given, and with ``carry`` it starts from
    the work rows' ``X``, ``U`` as the proximal centre."""
    refuse_gradient("fused_stagewise_tick / fused_stagewise_tick_streamed "
                    "(csrc/stagewise_tick.cu)", "make_stagewise_step(..., "
                    "backend='xla') (the plain loop)", plan, x0, warm,
                    plan_lf, work)
    if n_iter < 0 or N < 1:
        raise ValueError(f"n_iter must be >= 0 and N >= 1, got {n_iter}, "
                         f"{N}")
    lo = _Layout(x, u, r)
    nb = plan.shape[-1]
    dev, dt = plan.device, plan.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"plan must be float32 or float64, got {dt}")
    check_fused_envelope(N, x, u, r, dt)
    for name, t, shape in (("plan", plan, (N + 1, lo.C, nb)),
                           ("x0", x0, (x, nb)),
                           ("warm", warm, (N + 1, lo.W, nb))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, plan on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, plan {dt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Cp, Wp, Kwp = ring_config(N, x, u, r, plan.element_size())[:3]
    if plan_lf is None:
        plan_lf = lane_first_plan(plan)
    elif (plan_lf.device != dev or plan_lf.dtype != dt
          or tuple(plan_lf.shape) != (nb, N + 1, Cp)
          or not plan_lf.is_contiguous()):
        raise ValueError(f"plan_lf must be lane_first_plan(plan), a "
                         f"contiguous {dt} [{nb}, {N + 1}, {Cp}] on {dev}")
    if (skip is not None or carry) and work is None:
        raise ValueError("skip and carry need the work tensor they keep")
    if skip is not None:
        if (skip.device != dev or skip.dtype != torch.int32
                or skip.numel() != 1):
            raise ValueError(f"skip must be a one-element int32 tensor on "
                             f"{dev}, got {skip.dtype} {tuple(skip.shape)} "
                             f"on {skip.device}")
    if work is not None:
        if (tuple(work.shape) != (N + 1, lo.Kw, nb) or work.dtype != dt
                or work.device != dev):
            raise ValueError(f"work must be a {dt} [{N + 1}, {lo.Kw}, "
                             f"{nb}] tensor, got {work.dtype} "
                             f"{tuple(work.shape)}")
    lib = _load()
    _prepare(lib, dev)
    with torch.cuda.device(dev):
        state = torch.empty((nb, N + 1, Wp + Kwp), dtype=dt, device=dev)
        state[:, :, :lo.W] = warm.permute(2, 0, 1)
        if work is not None:
            state[:, :, Wp:Wp + lo.Kw] = work.permute(2, 0, 1)
        rc = lib.copra_stagewise_tick(
            plan_lf.data_ptr(), x0.data_ptr(), state.data_ptr(), nb, N, x, u,
            r, int(n_iter), int(dt == torch.float64), float(sigma),
            float(alpha), None if skip is None else skip.data_ptr(),
            int(bool(carry)), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"stagewise tick kernel launch failed: CUDA error {rc} "
            f"({lib.copra_stagewise_error_string(rc).decode()})")
    profiling.count(LAUNCH_COUNTERS[0] if warp_body(x, u, r)
                    else LAUNCH_COUNTERS[1])
    return _lane_last(state, lo.W), _lane_last(state[:, :, Wp:], lo.Kw)


@counted
def fused_stagewise_tick(plan: Tensor, x0: Tensor, warm: Tensor, *,
                         n_iter: int, N: int, x: int, u: int, r: int,
                         sigma: float, alpha: float,
                         plan_lf: Optional[Tensor] = None,
                         work: Optional[Tensor] = None,
                         skip: Optional[Tensor] = None,
                         carry: bool = False
                         ) -> Tuple[Tensor, Tensor]:
    """Run ``n_iter`` stagewise-ADMM iterations in one kernel (the resident
    entry point: small per-stage dimensions, the N=300 ZMP class).

    ``plan [N+1, C, B]``, ``x0 [x, B]``, ``warm [N+1, W, B]``
    (:class:`_Layout`, lane axis last).  Returns ``(warm', work)``;
    ``work [N+1, Kw, B]`` carries the final LQR iterates ``X``/``U``.
    CPU tensors run :func:`stagewise_tick_plain`; CUDA tensors launch
    ``csrc/stagewise_tick.cu`` (see :func:`_launch`), on ``plan_lf``
    (:func:`lane_first_plan`) where the caller holds one.  ``skip`` and
    ``work``: the device-side top-up decision; ``carry`` and ``work``: a
    run that continues from ``work``'s iterate (see
    :func:`stagewise_tick_plain`).  The launch happens, and counts,
    whether or not the flag is set.
    """
    kw = dict(n_iter=n_iter, N=N, x=x, u=u, r=r, sigma=sigma, alpha=alpha,
              work=work, skip=skip, carry=carry)
    if plan.device.type == "cpu":
        return stagewise_tick_plain(plan, x0, warm, **kw)
    out = _launch(plan, x0, warm, **kw, plan_lf=plan_lf)
    fused_stagewise_tick.launches += 1
    return out


@counted
def fused_stagewise_tick_streamed(plan: Tensor, x0: Tensor, warm: Tensor,
                                  *, n_iter: int, N: int, x: int, u: int,
                                  r: int, sigma: float, alpha: float,
                                  plan_lf: Optional[Tensor] = None,
                                  work: Optional[Tensor] = None,
                                  skip: Optional[Tensor] = None,
                                  carry: bool = False
                                  ) -> Tuple[Tensor, Tensor]:
    """The streamed entry point (robot-scale per-stage dimensions, the
    x = u = r = 12 quadruped class): the same kernel and arguments as
    :func:`fused_stagewise_tick`, counted apart."""
    kw = dict(n_iter=n_iter, N=N, x=x, u=u, r=r, sigma=sigma, alpha=alpha,
              work=work, skip=skip, carry=carry)
    if plan.device.type == "cpu":
        return stagewise_tick_plain(plan, x0, warm, **kw)
    out = _launch(plan, x0, warm, **kw, plan_lf=plan_lf)
    fused_stagewise_tick_streamed.launches += 1
    return out


# ---------------------------------------------------------------------------
# Host side: pack a StagewiseQP into the kernel layout and mirror
# solve_stagewise's seed / residual / status semantics.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedStagewisePlan:
    """Precomputed fused-tick plan for a batched StagewiseQP: the packed
    ``plan [N+1, C, B]`` (gains folded in), the entry point ``mode``, the
    unridged problem's gains ``gains_raw`` for the clipped-unconstrained
    seed sweep, what the status pass needs after the kernel, and with
    ``options.polish_iters`` on float32 data the f64 polish's plan
    (:class:`~copra_tpu_torch.ops.polish.PolishPlan`)."""

    plan: Tensor
    mode: str                 # "resident" | "streamed"
    sqp: "object"             # batched StagewiseQP
    gains_raw: Optional[LQRGains]
    rows: "object"            # normalized rows (riccati._Rows) or None
    rho_x: Tensor             # [B, N+1, x]
    rho_u: Tensor             # [B, N, u]
    plan_lf: Optional[Tensor] = None   # lane_first_plan(plan) on CUDA
    polish: "object" = None            # polish.PolishPlan or None


def fused_mode(N: int, x: int, u: int, r: int, dtype) -> str:
    """The entry point for a problem size, by the reference's component
    rule: ``(x+u)(x+u+r) <= 256`` unrolled component expressions per stage
    is ``"resident"`` (config 5), anything larger ``"streamed"`` (config
    6)."""
    return "resident" if (x + u) * (x + u + r) <= 256 else "streamed"


def check_fused_envelope(N: int, x: int, u: int, r: int, dtype) -> None:
    """Raise ``ValueError`` with guidance unless the CUDA kernel can serve
    the problem: float32 or float64 data, ``x, u >= 1``, ``x + u + r <=
    128`` (the reference's streamed-mode limit) and a lane's ring of at
    least two stage tiles within the 227 KB of shared memory one block may
    use (:func:`ring_config`)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(
            f"fused stagewise kernel envelope: {dtype} data; the CUDA "
            f"kernel takes float32 and float64.  Use "
            f"make_stagewise_step(backend='xla').")
    itemsize = 8 if dtype == torch.float64 else 4
    if min(x, u) < 1 or r < 0 or x + u + r > MAX_WIDTH:
        raise ValueError(
            f"fused stagewise kernel envelope exceeded for N={N}, x={x}, "
            f"u={u}, r={r}: the kernel needs x, u >= 1 and x+u+r <= "
            f"{MAX_WIDTH}.  Use make_stagewise_step(backend='xla'), "
            f"optionally with fewer rows per stage.")
    cfg = ring_config(N, x, u, r, itemsize)
    if cfg[4] < 2:
        tile = sum(cfg[:3]) * itemsize
        raise ValueError(
            f"fused stagewise kernel envelope exceeded for N={N}, x={x}, "
            f"u={u}, r={r} in {dtype}: a stage tile is {tile / 1e3:.1f} KB "
            f"and the kernel's ring needs two of them in "
            f"{SMEM_LIMIT / 1024:.0f} KB of shared memory.  Use "
            f"make_stagewise_step(backend='xla'), or float32 data.")


def pack_plan(sqp, gains: LQRGains, rho_x: Tensor, rho_u: Tensor, rows,
              lower, upper) -> Tensor:
    """Lay a batched problem, its ridged gains, penalties and normalized
    rows out as the kernel's ``plan [N+1, C, B]`` (:class:`_Layout`).
    ``lower``/``upper`` map the lower and upper bounds (state, control and
    row) to the values the kernel clips with."""
    nb = sqp.A.shape[0]
    N, x, u, r = sqp.horizon, sqp.xdim, sqp.udim, sqp.nr_rows
    lo = _Layout(x, u, r)
    cols = torch.zeros((nb, N + 1, lo.C), dtype=sqp.A.dtype,
                       device=sqp.A.device)

    def put(off, a, stages=N):
        a = a.reshape(nb, stages, -1)
        cols[:, :stages, off:off + a.shape[-1]] = a

    put(lo.A, sqp.A)
    put(lo.B, sqp.B)
    put(lo.d, sqp.d)
    put(lo.K, gains.K)
    put(lo.nF, gains.nF)
    put(lo.qb, torch.cat([sqp.qx[:, :-1] + gains.avd, sqp.qx[:, -1:]],
                         dim=1), N + 1)
    put(lo.rb, sqp.ru + gains.bvd)
    put(lo.rhox, rho_x, N + 1)
    put(lo.rhou, rho_u)
    put(lo.xlb, lower(sqp.xlb), N + 1)
    put(lo.xub, upper(sqp.xub), N + 1)
    put(lo.ulb, lower(sqp.ulb))
    put(lo.uub, upper(sqp.uub))
    if rows is not None:
        put(lo.Cx, rows.Cx)
        put(lo.Cu, rows.Cu)
        put(lo.slo, lower(rows.slo))
        put(lo.shi, upper(rows.shi))
        put(lo.rhos, rows.rho_s)
    return cols.permute(1, 2, 0).contiguous()


@profiling.traced("copra.build_fused_plan")
@highest_precision
def build_fused_plan(sqp, options) -> FusedStagewisePlan:
    """Pack a (batched) StagewiseQP + options into a fused-tick plan.

    Mirrors ``solve_stagewise``'s preprocessing: per-coordinate box
    penalties, L2 row normalization, the equality-row rho boost, the
    ridged stage Hessians; runs the quadratic Riccati recursion once and
    lays everything out as ``[N+1, C, B]``.  Bounds are clamped to
    ``finfo.max/4`` (an infinite bound times a zero elsewhere would mint
    NaNs) and count as finite below ``finfo.max/8``, the test the
    penalties use, so the gains' ridge and the kernel's z-step agree.
    With ``options.polish_iters > 0`` on float32 data it also builds the
    f64 polish's plan from this plan's penalties and rows
    (:func:`~copra_tpu_torch.ops.polish.build_polish_plan`; a no-op for
    float64 data, as in the reference).
    """
    from ..qp.riccati import _lead, _penalized

    if sqp.A.dim() == 3:
        sqp = _lead(sqp)
    N, x, u, r = sqp.horizon, sqp.xdim, sqp.udim, sqp.nr_rows
    kd = dict(dtype=sqp.A.dtype, device=sqp.A.device)
    fmax = torch.finfo(sqp.A.dtype).max
    big_test = fmax / 8
    rho = torch.tensor(float(options.rho), **kd)
    zero = torch.zeros((), **kd)

    def pen(lb, ub):
        return torch.where((lb > -big_test) | (ub < big_test), rho, zero)

    rho_x = pen(sqp.xlb, sqp.xub)                      # [B, N+1, x]
    rho_u = pen(sqp.ulb, sqp.uub)                      # [B, N, u]
    Qx_r, Ru_r, S_cross, rows = _penalized(sqp, options, rho_x, rho_u)
    gains = precompute_lqr_gains(sqp.A, sqp.B, sqp.d, Qx_r, Ru_r, S_cross)
    gains_raw = None
    if options.seed != "zero":
        gains_raw = precompute_lqr_gains(sqp.A, sqp.B, sqp.d, sqp.Qx, sqp.Ru)
    plan = pack_plan(sqp, gains, rho_x, rho_u, rows,
                     lambda t: t.clamp_min(-fmax / 4),
                     lambda t: t.clamp_max(fmax / 4))
    polish = None
    if (getattr(options, "polish_iters", 0) > 0
            and sqp.A.dtype == torch.float32):
        from .polish import build_polish_plan
        polish = build_polish_plan(sqp, rho_x, rho_u, rows, options)
    return FusedStagewisePlan(
        plan=plan, mode=fused_mode(N, x, u, r, sqp.A.dtype), sqp=sqp,
        gains_raw=gains_raw, rows=rows, rho_x=rho_x, rho_u=rho_u,
        plan_lf=lane_first_plan(plan) if plan.is_cuda else None,
        polish=polish)


def _pack_warm(fp: FusedStagewisePlan, zX, zU, yX, yU, zS, yS) -> Tensor:
    """Lane-leading warm arrays -> the kernel's warm tensor [N+1, W, B]."""
    sqp = fp.sqp
    nb = sqp.A.shape[0]
    N, x, u, r = sqp.horizon, sqp.xdim, sqp.udim, sqp.nr_rows
    lo = _Layout(x, u, r)
    w = torch.zeros((nb, N + 1, lo.W), dtype=sqp.A.dtype,
                    device=sqp.A.device)
    w[:, :, lo.zX:lo.zX + x] = zX
    w[:, :, lo.yX:lo.yX + x] = yX
    w[:, :N, lo.zU:lo.zU + u] = zU
    w[:, :N, lo.yU:lo.yU + u] = yU
    if r:
        w[:, :N, lo.zS:lo.zS + r] = zS
        w[:, :N, lo.yS:lo.yS + r] = yS
    return w.permute(1, 2, 0).contiguous()


def _pack_work(fp: FusedStagewisePlan, X, U) -> Tensor:
    """A proximal centre ``(X [B, N+1, x], U [B, N, u])`` -> the kernel's
    work tensor [N+1, Kw, B] (``kk`` rows zero)."""
    sqp = fp.sqp
    nb = sqp.A.shape[0]
    N, x, u = sqp.horizon, sqp.xdim, sqp.udim
    lo = _Layout(x, u, sqp.nr_rows)
    w = torch.zeros((nb, N + 1, lo.Kw), dtype=sqp.A.dtype,
                    device=sqp.A.device)
    w[:, :, lo.X:lo.X + x] = X
    w[:, :N, lo.U:lo.U + u] = U
    return w.permute(1, 2, 0).contiguous()


def _unpack(warm_t: Tensor, work_t: Tensor, N: int, x: int, u: int,
            r: int):
    """The kernel's lane-last tensors -> lane-leading ``(X, U, zX, zU, yX,
    yU, zS, yS)``."""
    lo = _Layout(x, u, r)

    def take(t, off, c, stages=N + 1):
        return t[:stages, off:off + c].permute(2, 0, 1)

    return (take(work_t, lo.X, x), take(work_t, lo.U, u, N),
            take(warm_t, lo.zX, x), take(warm_t, lo.zU, u, N),
            take(warm_t, lo.yX, x), take(warm_t, lo.yU, u, N),
            take(warm_t, lo.zS, r, N), take(warm_t, lo.yS, r, N))


@highest_precision
def _lane_residuals(sqp, options, rho_x: Tensor, rho_u: Tensor, rows, X, U,
                    zX, zU, yX, yU, zS, yS):
    """Per-lane ``(r_prim, r_dual, converged)`` of iterates: box gaps only
    where a split exists, row gaps and the dual residual in the original
    row metric, against ``10 max(eps_abs, 25 eps(dtype))`` (the dual one
    relative to ``_dual_scale``); shared by the status of both paths
    and the top-up check.  The dual residual is the log-depth scan
    (``parallel=True``), as in the reference's status pass."""
    from ..qp.riccati import _dual_scale, _lane_max, stagewise_dual_residual

    zero = torch.zeros((), dtype=sqp.A.dtype, device=sqp.A.device)
    r_prim = torch.maximum(
        _lane_max(torch.where(rho_x > 0, (X - zX).abs(), zero)),
        _lane_max(torch.where(rho_u > 0, (U - zU).abs(), zero)))
    if rows is not None:
        r_prim = torch.maximum(r_prim, _lane_max(
            ((rows.eval(X, U) - zS) / rows.Es).abs()))
        r_dual = stagewise_dual_residual(sqp, X, U, yX, yU, yS * rows.Es,
                                         parallel=True)
    else:
        r_dual = stagewise_dual_residual(sqp, X, U, yX, yU, parallel=True)
    eps = max(options.eps_abs, 25.0 * torch.finfo(sqp.A.dtype).eps) * 10
    return r_prim, r_dual, (r_prim <= eps) & (r_dual <= eps * _dual_scale(sqp))


# the device counters of the top-up: ticks that took its decision, ticks
# whose top-up ran, and the lanes that missed the tolerance at the
# decision, summed over the ticks
TOPUP_COUNTERS = ("stagewise.ticks", "stagewise.topups",
                  "stagewise.topup_lanes")
_bounds = {}


def _topup_bounds(device) -> Tuple[Tensor, Tensor]:
    """``([1, 0, 0], [1, 1, 2**62])`` on ``device``: the lanes missed,
    clamped between them, give ``(1, 1 if the top-up ran else 0, lanes
    missed)`` in one op."""
    t = _bounds.get(device)
    if t is None:
        t = _bounds[device] = tuple(
            torch.tensor(v, dtype=torch.int64, device=device)
            for v in ([1, 0, 0], [1, 1, 2 ** 62]))
    return t


@highest_precision
def solve_stagewise_fused(sqp, options, warm_start=None,
                          return_warm: bool = False,
                          plan: Optional[FusedStagewisePlan] = None):
    """Drop-in for the batched ``solve_stagewise`` through the fused tick:
    the same update order, seeds, residuals and statuses.  ``plan`` (from
    :func:`build_fused_plan`) skips the pack and gains work; serving
    callers hold one per problem and tick with a fresh ``x0``.

    Fixed count (``options.early_exit=False``, the serving tick): one
    launch of ``max_iter`` iterations, then, with ``options.polish_iters``
    on float32 data, the f64 polish of the delivered iterates
    (:func:`~copra_tpu_torch.ops.polish.polish`, one f64 launch), and the
    residuals of what is delivered.  With ``options.topup_iters`` the
    whole batch runs that many more iterations from the first run's state,
    and is polished again, when any lane's delivered residuals miss the
    tolerance.  That decision stays on the device: the top-up launch (and
    the re-polish) always happens, on a state that holds the first run's
    warm and work rows, and returns at its entry when every lane
    converged, so the first run's values come back bit for bit and no
    tick syncs the host (a tick can be captured in a CUDA graph).  The
    residuals are taken again after it, as the reference does after its
    ``lax.cond``.  The device counters :data:`TOPUP_COUNTERS` add the
    tick, whether its top-up ran and the lanes that missed the tolerance
    at the decision (:func:`~copra_tpu_torch.profiling.counters`).

    Early exit (``options.early_exit=True``): the chunked loop of
    ``solve_stagewise`` (:func:`_solve_early_exit`), each chunk one
    launch; no top-up and no polish, as there.
    """
    from ..qp.riccati import _initial_state, _lead, _result

    single = sqp.A.dim() == 3
    if single:
        sqp = _lead(sqp)
        if warm_start is not None:
            warm_start = tuple(w.unsqueeze(0) for w in warm_start)
    if plan is None:
        plan = build_fused_plan(sqp, options.replace(polish_iters=0)
                                if options.early_exit else options)
    fp = plan
    sqp = fp.sqp
    nb = sqp.A.shape[0]
    N, x, u, r = sqp.horizon, sqp.xdim, sqp.udim, sqp.nr_rows
    zX0, zU0, yX0, yU0, zS0, yS0 = _initial_state(
        sqp, options, warm_start, fp.rows,
        lambda: lqr_solve_fixed(fp.gains_raw, sqp.A, sqp.B, sqp.d, sqp.qx,
                                sqp.ru, sqp.x0))
    warm0 = _pack_warm(fp, zX0, zU0, yX0, yU0, zS0, yS0)
    x0 = sqp.x0.mT.contiguous()                        # [x, B]
    entry = (fused_stagewise_tick if fp.mode == "resident"
             else fused_stagewise_tick_streamed)

    def run(warm_t, n_iter, work_t=None, skip=None, carry=False):
        return entry(fp.plan, x0, warm_t, n_iter=n_iter, N=N, x=x, u=u,
                     r=r, sigma=float(options.sigma),
                     alpha=float(options.alpha), plan_lf=fp.plan_lf,
                     work=work_t, skip=skip, carry=carry)

    def unpack(warm_t, work_t):
        return _unpack(warm_t, work_t, N, x, u, r)

    def residuals(vals):
        return _lane_residuals(sqp, options, fp.rho_x, fp.rho_u, fp.rows,
                               *vals)

    if options.early_exit:
        vals, iters, infeas_code = _solve_early_exit(
            sqp, options, fp.rows, run, unpack, residuals, warm0,
            _pack_work(fp, zX0, zU0))
        return _result(sqp, fp.rows, vals[0], vals[1], vals[2:],
                       residuals(vals), iters, infeas_code, single,
                       return_warm)

    n_polish = (int(getattr(options, "polish_iters", 0))
                if fp.polish is not None else 0)

    def deliver(warm_t, work_t, skip=None):
        """The delivered iterates: the kernel's, polished in f64 when the
        options ask for it."""
        if n_polish > 0:
            from .polish import polish
            warm_t, work_t = polish(fp.polish, entry, x0, warm_t, work_t,
                                    n_iter=n_polish, N=N, x=x, u=u, r=r,
                                    options=options, skip=skip)
        return unpack(warm_t, work_t)

    warm1, work = run(warm0, options.max_iter)
    vals = deliver(warm1, work)
    res = residuals(vals)
    topup = int(getattr(options, "topup_iters", 0))
    if topup > 0:
        # batch-level top-up, skipped on the device when every lane
        # converged; converged lanes of a tick that runs it sit at their
        # fixed point
        missed = (~res[2]).sum()
        skip = (missed == 0).to(torch.int32)
        # counted on the device: (ticks, ticks whose top-up ran, lanes
        # missed)
        profiling.device_counter(TOPUP_COUNTERS, missed.device).add_(
            torch.clamp(missed, *_topup_bounds(missed.device)))
        more = deliver(*run(warm1, topup, work, skip), skip=skip)
        if n_polish > 0:
            # a skipped re-polish returns the unpolished state it was
            # given: keep the first polish's values then
            vals = tuple(torch.where(skip > 0, a, b)
                         for a, b in zip(vals, more))
        else:
            vals = more
        res = residuals(vals)
    iters = torch.full((nb,), int(options.max_iter), dtype=torch.int32,
                       device=sqp.A.device)
    return _result(sqp, fp.rows, vals[0], vals[1], vals[2:], res, iters,
                   torch.zeros_like(iters), single, return_warm)


def _solve_early_exit(sqp, options, rows, run, unpack, residuals, warm0,
                      work0):
    """The early-exit loop of ``solve_stagewise`` on the kernel: chunks of
    ``min(check_interval, max_iter - iters)`` iterations, each one launch
    that continues the last (``carry``: its proximal centre is the last
    iterate, as in the unbroken loop), a residual check after each, and
    with ``infeasibility_detection`` the certificate of one more iteration,
    run on a copy.  A lane freezes once it converged or confirmed a
    certificate (two consecutive checks agree): the ``torch.where`` select
    of the plain loop.  Returns the delivered iterates, the iterations per
    lane and the certificate codes.  The loop's exit is a host check, one
    sync a chunk."""
    from ..qp.riccati import _infeas_cert, _lane_max

    nb, dev = sqp.A.shape[0], sqp.A.device
    kd = dict(dtype=sqp.A.dtype, device=dev)
    a_scale = torch.maximum(torch.maximum(_lane_max(sqp.A.abs()),
                                          _lane_max(sqp.B.abs())),
                            torch.ones((), **kd))
    chunk = max(1, min(int(options.check_interval), int(options.max_iter)))
    izero = torch.zeros((nb,), dtype=torch.int32, device=dev)
    done = torch.zeros((nb,), dtype=torch.bool, device=dev)
    iters, infeas_code, pend = izero, izero, izero
    warm_t, work_t = warm0, work0
    state8 = lambda v: v[2:] + v[:2]
    while True:
        active = (~done) & (iters < options.max_iter)
        if not bool(active.any()):
            break
        todo = min(chunk, int(options.max_iter) - int(iters[active].max()))
        warm_n, work_n = run(warm_t, todo, work_t, carry=True)
        new = unpack(warm_n, work_n)
        conv = residuals(new)[2]
        if options.infeasibility_detection:
            ext = unpack(*run(warm_n, 1, work_n, carry=True))
            infeas = _infeas_cert(sqp, options, rows, a_scale, state8(new),
                                  state8(ext))
        else:
            infeas = izero
        confirmed = torch.where((infeas > 0) & (infeas == pend), infeas,
                                izero)
        lane = active.view(1, 1, nb)
        warm_t = torch.where(lane, warm_n, warm_t)
        work_t = torch.where(lane, work_n, work_t)
        done = torch.where(active, conv | (confirmed > 0), done)
        iters = torch.where(active, iters + todo, iters)
        infeas_code = torch.where(active,
                                  torch.maximum(infeas_code, confirmed),
                                  infeas_code)
        pend = torch.where(active, infeas, pend)
    return unpack(warm_t, work_t), iters, infeas_code
