"""The trotting SRB quadruped served with its QP rebuilt every tick, on the
CPU: the port's SRB linearisation (``copra_tpu_torch.srb``), the chain's
per-tick problem (``make_stagewise_multistep(problem=...)``) against the
benchmark's plain reference (``benchmark/reference/
srb_quadruped_trot.py``, float64, condensed and solved exactly), and the
rebuilt plan against a fresh ``build_fused_plan``.  Small: N = 8, 4
robots, on one torch thread (``tests/_one_thread.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

import copra_tpu_torch as tt
from _one_thread import one_torch_thread  # noqa: F401
from copra_tpu_torch import profiling, srb
from copra_tpu_torch.ops.stagewise_kernel import build_fused_plan
from copra_tpu_torch.qp.riccati import (make_stagewise_multistep,
                                        scale_stagewise, stagewise_scales)

tt.set_default_device("cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(json.load(open(os.path.join(
    ROOT, "benchmark", "configs", "srb_quadruped_trot.json"))),
    robots=4, horizon=8)
BOX = dict(mu=CFG["mu"], fz_max=CFG["fz_max"], tilt=CFG["tilt"],
           height_range=CFG["height_range"])
PHASE = [0, 5, 13, 18]


def _model(dtype=torch.float32, phase=PHASE, N=CFG["horizon"]):
    return srb.TrotModel.create(
        phase, N=N, dt=CFG["dt"], mass=CFG["mass"], inertia=CFG["inertia"],
        w=CFG["state_weights"], terminal=CFG["terminal_factor"],
        r=CFG["force_weight"], height=CFG["height"],
        period_s=CFG["gait"]["period_s"], duty=CFG["gait"]["duty"],
        gravity=CFG["gravity"], dtype=dtype)


def _states(seed, robots=4):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.zeros((robots, 12), dtype=torch.float64)
    x0[:, 5] = 0.3
    x0 += 0.02 * torch.randn((robots, 12), generator=g, dtype=torch.float64)
    x0[:, 2] = torch.randn(robots, generator=g, dtype=torch.float64)
    return x0


def _options(short=False):
    """The configuration's options, or (``short``) a few iterations, for a
    test whose check does not depend on convergence (the kernel's plain
    version costs ~0.1 s an iteration here)."""
    cold = tt.SolverOptions(max_iter=20 if short else CFG["cold_iterations"],
                            early_exit=False, polish=False,
                            eps_abs=CFG["eps_abs"], rho=CFG["rho"])
    return cold.replace(max_iter=5 if short else CFG["warm_iterations"],
                        topup_iters=5 if short else CFG["topup_iterations"]
                        ), cold


def _chain(model, x0, backend, short=False):
    nominal = torch.tensor([CFG["x0_nominal"]], dtype=x0.dtype)
    scales = stagewise_scales(srb.trot_qp(srb.stance_model(model), nominal,
                                          **BOX))
    warm, cold = _options(short)
    step = make_stagewise_multistep(
        srb.trot_qp(model, x0, **BOX), warm, cold_options=cold,
        backend=backend, scaling=scales,
        problem=lambda x: srb.linearise(model, x))
    return step, scales


def test_linearisation_at_the_nominal_stance_is_the_traffic_plant():
    """At yaw 0 with every foot down, ``srb.linearise``'s A and B at every
    stage are the traffic's plant (the serving module's own numpy
    build), to float64 rounding (1e-15); at another yaw they are the
    reference's dynamics (built from I_w = R I_b R' and R r_i, not from
    the rotated body-frame operators) to 1e-15, and a swinging foot's
    columns are zero."""
    from benchmark.reference import srb_quadruped_trot as ref
    from benchmark.serving import srb_trot

    p = srb_trot.plant(CFG)
    stance = srb.stance_model(_model(torch.float64))
    x0 = torch.tensor([CFG["x0_nominal"]], dtype=torch.float64)
    data = srb.linearise(stance, x0)
    for k in range(CFG["horizon"]):
        assert np.abs(data.A[0, k].numpy() - p["A"]).max() <= 1e-15
        assert np.abs(data.B[0, k].numpy() - p["B"]).max() <= 1e-15
    model = _model(torch.float64)
    x0 = _states(3)
    got = srb.linearise(model, x0)
    contact = ref.stance(CFG, torch.tensor(PHASE), CFG["horizon"])
    assert torch.equal(contact, model.contact > 0)
    A, B, d = ref.dynamics(CFG, x0, contact)
    assert float((got.A - A[:, None]).abs().max()) <= 1e-15
    assert float((got.B - B).abs().max()) <= 1e-15
    assert float((got.d - d).abs().max()) == 0.0
    swing = ~contact.repeat_interleave(3, dim=-1)
    assert float(got.B.permute(0, 1, 3, 2)[swing].abs().max()) == 0.0


def test_rebuilt_every_tick_matches_the_plain_reference():
    """Five ticks of the chain (``backend="xla"``, eager on the CPU), each
    re-linearised at a new state of the fleet (headings spread over a
    radian), against the reference's exact float64 forces at the same
    states: ``max |U - U_ref| / max |U_ref|`` within 2e-4 (the solver
    stops at eps_abs 1e-4 in the equilibrated units; float32 data), and
    every tick counted as a rebuild."""
    from benchmark.reference import srb_quadruped_trot as ref

    model = _model()
    x0 = _states(5)
    step, _ = _chain(model, x0.float(), "xla")
    raw = {"phase": torch.tensor(PHASE)}
    warm, xs = None, x0
    g = torch.Generator().manual_seed(6)
    before = profiling.counters().get("stagewise.rebuilds", 0)
    for _ in range(5):
        xs = xs + 0.01 * torch.randn(xs.shape, generator=g,
                                     dtype=torch.float64)
        _, _, _, info, warm = step(None, 1, warm=warm,
                                   x0_seq=xs.float()[None])
        U, res = ref.controls(CFG, raw, xs.float().double(), range(4))
        assert float(res.max()) <= 1e-10 * float(U.abs().max())
        gap = float((info.x.double() - U).abs().max() / U.abs().max())
        assert gap <= 2e-4, gap
    # the cold tick and five warm ticks
    assert profiling.counters()["stagewise.rebuilds"] - before == 6


def test_rebuilt_plan_is_a_fresh_build_of_the_ticks_data():
    """On the fused backend (the kernel's plain version on the CPU) the
    plan after a tick is ``build_fused_plan`` of that tick's linearised,
    equilibrated problem, bit for bit; a tick at another state changes the
    gains, and the plan follows it: a tick that kept the previous tick's
    gains fails here."""
    model = _model()
    x0 = _states(7).float()
    step, scales = _chain(model, x0, "fused", short=True)
    warm, _ = _options(short=True)
    plans = []
    for t, yaw in enumerate((0.0, 0.9)):
        xs = x0.clone()
        xs[:, 2] += yaw
        _, _, _, _, w = step(None, 1, warm=None if t == 0 else w,
                             x0_seq=xs[None])
        fresh = build_fused_plan(
            scale_stagewise(srb.trot_qp(model, xs, **BOX), *scales), warm)
        assert torch.equal(step._data[3].plan, fresh.plan)
        plans.append(fresh.plan)
    assert float((plans[0] - plans[1]).abs().max()) > 1e-3 * float(
        plans[1][:, :200].abs().max())


def test_serve_is_the_carried_warm_chain():
    """``serve`` (the warm state kept by the chain) gives the controls of
    ``step_many(None, 1, warm, x0_seq)`` with the warm tuple carried by
    the caller, bit for bit over four ticks (eager on the CPU, the same
    ops in the same order; the kernel's plain version, a few
    iterations)."""
    model = _model()
    x0 = _states(11).float()
    a, _ = _chain(model, x0, "fused", short=True)
    b, _ = _chain(model, x0, "fused", short=True)
    warm, xs = None, x0
    g = torch.Generator().manual_seed(12)
    for _ in range(4):
        xs = xs + 0.01 * torch.randn(xs.shape, generator=g)
        _, _, _, info, warm = a(None, 1, warm=warm, x0_seq=xs[None])
        assert torch.equal(b.serve(xs), info.x)


def test_per_tick_problem_refuses_what_it_cannot_rebuild():
    """A fused chain cannot rebuild the f64 polish's plan, nor reseed a
    row-free warm tick from gains it does not refactor: both refuse at
    build; a callable whose data do not fit the problem raises naming
    the field."""
    model = _model()
    x0 = _states(9).float()
    sqp = srb.trot_qp(model, x0, **BOX)
    warm, cold = _options()
    for opts, qp in ((warm.replace(polish_iters=2), sqp),
                     (warm, sqp.__class__(**{**sqp.__dict__, "Cx": None,
                                             "Cu": None, "clo": None,
                                             "chi": None}))):
        with pytest.raises(ValueError):
            make_stagewise_multistep(qp, opts, cold_options=cold,
                                     backend="fused",
                                     problem=lambda x: srb.linearise(model,
                                                                     x))
    step = make_stagewise_multistep(
        sqp, warm, cold_options=cold, backend="xla",
        problem=lambda x: srb.linearise(model, x)._replace(
            qx=torch.zeros(4, 3, 12)))
    with pytest.raises(tt.DimensionError, match="qx"):
        step(None, 1, x0_seq=x0[None])
