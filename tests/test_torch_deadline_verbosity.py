"""Deadline and verbosity of the port's ``LMPC`` facade: the seven cases of
``tests/test_deadline_verbosity.py`` against ``copra_tpu_torch.LMPC``.

``SolverOptions.max_wall_time_ms`` is enforced by measurement: the facade
times two fixed-count probe solves of the registered problem, derives ms
per iteration and clamps ``max_iter`` so a solve fits the budget (on the
CPU the basis is the host clock).  ``print_level`` 0-3 maps the
reference's ``SI_printLevel`` onto the logger ``copra_tpu_torch.lmpc``;
level 3 logs the per-status explanation table.
"""

import logging

import numpy as np

import copra_tpu_torch as tt
from fixtures import (A, B, D, M, N_MAT, SMALL_N, SMALL_X0, UD, U_LOWER,
                      U_UPPER, WU, WX, XD)

tt.set_default_device("cpu")

LOGGER = "copra_tpu_torch.lmpc"


def small_controller(**opt_kw):
    system = tt.LTISystem.create(A, B, D, SMALL_X0, SMALL_N)
    controller = tt.LMPC(system, options=tt.SolverOptions(**opt_kw))
    controller.add_cost(tt.TargetCost.create(M, XD, weights=WX))
    controller.add_cost(tt.ControlCost.create(N_MAT, UD, weights=WU))
    controller.add_constraint(
        tt.ControlBoundConstraint.create(U_LOWER, U_UPPER))
    return controller


def test_deadline_clamps_iteration_budget():
    """A tiny wall budget clamps max_iter to the measured fit (and never
    above the configured cap); the calibration is exposed."""
    controller = small_controller(max_iter=5000, early_exit=False,
                                  max_wall_time_ms=1e-4)
    assert controller.deadline_info() is None
    controller.solve()
    info = controller.deadline_info()
    assert info is not None
    # 0.1 microsecond budget: nothing fits -> floor of 1 iteration
    assert info["budget_iters"] == 1
    assert info["marginal_ms_per_iter"] > 0
    assert int(np.asarray(controller.results().solution.iterations)) == 1


def test_deadline_generous_budget_keeps_max_iter():
    controller = small_controller(max_iter=60, early_exit=False,
                                  max_wall_time_ms=60_000.0)
    assert controller.solve()
    info = controller.deadline_info()
    assert info["budget_iters"] == 60          # cap, not the minute
    assert int(np.asarray(controller.results().solution.iterations)) == 60


def test_deadline_recalibrates_on_registry_change():
    controller = small_controller(max_iter=50, early_exit=False,
                                  max_wall_time_ms=60_000.0)
    controller.solve()
    first = controller.deadline_info()
    assert first is not None
    controller.add_cost(tt.ControlCost.create(N_MAT, UD, weights=WU))
    assert controller.deadline_info() is None   # invalidated
    controller.solve()
    assert controller.deadline_info() is not None


def test_print_level_0_is_silent(caplog):
    controller = small_controller(max_iter=200)
    with caplog.at_level(logging.DEBUG, logger=LOGGER):
        controller.solve()
    assert not caplog.records


def test_print_level_2_logs_summary(caplog):
    controller = small_controller(max_iter=200, print_level=2)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        controller.solve()
    assert any("solve" in r.getMessage() for r in caplog.records)


def test_print_level_1_logs_failures_only(caplog):
    # 2 iterations cannot converge: level 1 must warn
    controller = small_controller(max_iter=2, early_exit=False,
                                  polish=False, print_level=1)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        ok = controller.solve()
    assert not ok
    assert any(r.levelno == logging.WARNING for r in caplog.records)
    # ...and stay silent on success
    caplog.clear()
    good = small_controller(max_iter=2000, print_level=1)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        assert good.solve()
    assert not caplog.records


def test_print_level_3_explanation_table(caplog):
    controller = small_controller(max_iter=2, early_exit=False,
                                  polish=False, print_level=3)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        controller.solve()
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert "status" in text and "iteration budget exhausted" in text
