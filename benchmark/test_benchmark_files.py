"""CPU checks of the benchmark's data: ``BENCHMARK.json`` against the
benchmark's contract, every configuration and traffic file, the metric
readers and the roofline counts.

    python -m pytest benchmark/test_benchmark_files.py -n 0
"""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# the reduced-key rule: no width may be cut
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"expansion|experts_per_tok|_dim$|_rank$)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("benchmark/")
    data = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert not any(WIDTH.search(k) for k in cfg["reduced"])
    for key in ("serving", "precision", "x0_nominal"):
        assert key in data
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "serving",
                                       data["serving"] + ".py"))
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "reference",
                                       cfg["name"] + ".py"))
    assert len(cfg["why"]) <= 200 and len(cfg["source"]) <= 200
    assert sum(w["config"] == cfg["name"] for w in BENCH["workloads"]) >= 1


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_traffic_loads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    t = harness.load_json(os.path.join(harness.BENCH_DIR, "traffic",
                                       cell["traffic"] + ".json"))
    assert t["mode"] in ("chain", "periodic")
    if t["mode"] == "chain":
        assert t["pool_ticks"] % t["ticks_per_call"] == 0
    else:
        assert t["period_ms"] > 0
    assert ("drift" in t) != ("plant" in t)
    if "drift" in t:
        assert 0 < t["drift"]["revert"] < 1
    # every value of the mix names where it comes from
    for key in list(t.get("drift", {})) + list(t.get("plant", {})) + \
            list(t.get("pushes", {})):
        assert key in t["sources"] or key in ("group",), key
    limits = harness.load_json(os.path.join(harness.BENCH_DIR, "checks",
                                            cell["name"] + ".json"))
    assert set(limits) == {"u_gap"}
    assert 0 < limits["u_gap"] < 1
    spec = harness.cell_spec(BENCH, cell["name"])
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"], "every cell reports a per-layer metric"


def test_metrics_follow_the_contract():
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  harness.cell_spec(BENCH, w)["end_to_end"]}
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_readers_find_nothing_in_an_empty_trace():
    from types import SimpleNamespace

    from benchmark import trace
    for m in BENCH["per_layer"]:
        cfg_name = harness.cell_spec(BENCH, m["workloads"][0])["config"]
        cfg = harness.load_json(os.path.join(ROOT, cfg_name["file"]))
        ctx = SimpleNamespace(ops=[], spans={}, window=(0, 0), ticks=0,
                              calls=0, cfg=cfg, traffic={}, untraced=None,
                              peaks=harness.load_json(os.path.join(
                                  harness.BENCH_DIR, "peaks.json")),
                              roofline=lambda k: harness.load_module(
                                  "roofline", k), trace=trace)
        assert harness.load_module("metrics", m["name"]).read(ctx) is None


def test_roofline_counts_come_from_the_shapes():
    k1 = harness.load_module("roofline", "k1")
    B, n = 4096, 100
    parts = k1.work(B, n, 30, 1)
    assert [p[0] for p in parts] == ["x0 = 0 body", "Q x pass"]
    # the lane's Kinv and K read once: 164 MB each
    assert parts[0][2] == 4.0 * (B * n * n + 9 * B * n)
    assert parts[1][2] == 4.0 * (B * n * n + 7 * B * n)
    assert parts[0][1] == 30 * (2.0 * B * n * n + 12.0 * B * n)
    assert k1.work(B, n, 30, 2)[:2] == [parts[0]] * 2
    k4 = harness.load_module("roofline", "k4")
    name, flops, nbytes, prec = k4.work(512, 300, 3, 1, 2, 20)
    assert prec == "float32"
    assert flops == (4 * 9 + 8 * 3 + 2 + 4 * 2 * 4 + 33 + 11 + 20) * 300 \
        * 20 * 512
    assert k4.work(512, 300, 3, 1, 2, 80)[1] == 4 * flops
    # bytes do not grow with the iterations
    assert k4.work(512, 300, 3, 1, 2, 80)[2] == nbytes


def test_trace_arithmetic():
    from benchmark import trace
    Op = trace.Op
    ops = [Op(("a", 0, 10, 1)), Op(("b", 5, 20, 1)), Op(("c", 30, 40, 2)),
           Op(("a", 35, 45, 1))]
    assert trace.busy_ns(ops) == 20 + 15
    assert trace.busy_ns(ops, [(0, 8), (38, 100)]) == 8 + 7
    bd = trace.breakdown(ops, {"bench.call": [(20, 30)]}, (0, 50))
    assert bd["device_ops"][0] == ["a", 20 / 1e9]
    assert bd["idle_gaps"] == [["bench.call", 10 / 1e9], ["harness", 5 / 1e9]]
    bd = trace.breakdown(ops, {"bench.call": [(20, 30), (45, 50)]}, (0, 50))
    assert bd["idle_gaps"] == [["bench.call", 15 / 1e9]]


def test_k4_launches_count_the_topups_that_ran():
    from types import SimpleNamespace

    from benchmark import readers, trace
    ms = 1_000_000
    # three ticks: warm 6 ms each, top-ups skipped, ran (25 ms), skipped
    ops = [trace.Op(("stagewise_tick_kernel<float, 4>", s, s + d, 1))
           for s, d in ((0, 6 * ms), (7 * ms, 2000), (10 * ms, 6 * ms),
                        (17 * ms, 25 * ms), (50 * ms, 6 * ms),
                        (57 * ms, 2000))]
    ctx = SimpleNamespace(ops=ops, ticks=3, cfg={"warm_iterations": 20,
                                                 "topup_iterations": 80})
    got = sorted(n for _, n in readers.k4_launches(ctx))
    assert got == [20, 20, 20, 80]


def _tiny_zmp():
    cfg = harness.load_json(os.path.join(harness.BENCH_DIR, "configs",
                                         "zmp_preview_biped.json"))
    return cfg, harness.load_module("serving", cfg["serving"])


DRIFT = {"std": [0.0, 0.0, 0.0], "revert": 0.5}


@pytest.mark.parametrize("bad", [
    {"mode": "chain", "ticks_per_call": 20, "pool_ticks": 2010,
     "drift": DRIFT},
    {"mode": "periodic", "period_ms": 7.0, "pool_ticks": 40,
     "plant": {"force_std": 0.4}},
    {"mode": "periodic", "period_ms": 10.0, "pool_ticks": 40,
     "drift": DRIFT,
     "pushes": {"per_robot_second": 1.0, "group": 2, "velocity": 0.1}},
], ids=["short_last_call", "period_off_the_model_step", "pushes_no_plant"])
def test_traffic_refuses_a_file_the_generator_cannot_honour(bad):
    import torch

    from benchmark.traffic import Traffic
    cfg, serving = _tiny_zmp()
    spec = dict(bad, sample={"count": 2, "lanes": 2})
    with pytest.raises(ValueError):
        Traffic(spec, cfg, 4, 7, torch.device("cpu"), serving.plant(cfg))


def test_plant_traffic_follows_the_closed_loop():
    """The stream of a ``plant`` file is the plant under its LQR: a push
    shows at its tick as the velocity step, then decays as the closed loop
    does; without noise or pushes the states stay at the nominal one."""
    import numpy as np
    import torch

    from benchmark import traffic as tf
    cfg, serving = _tiny_zmp()
    plant = serving.plant(cfg)
    quiet = {"mode": "periodic", "period_ms": 10.0, "pool_ticks": 400,
             "plant": {"force_std": 0.0}, "sample": {"count": 1, "lanes": 1}}
    pool = tf.Traffic(quiet, cfg, 4, 11, torch.device("cpu"), plant).pool
    assert float(pool.abs().max()) == 0.0
    pushed = dict(quiet, pushes={"per_robot_second": 0.25, "group": 2,
                                 "velocity": 0.1})
    t = tf.Traffic(pushed, cfg, 4, 11, torch.device("cpu"), plant)
    # 0.25 a robot-second over 4 s of pool and 2 robots: exactly 2 pushes
    assert len(t.push_ticks) == 2
    tick, grp = int(t.push_ticks[0]), int(t.push_groups[0])
    lane = 2 * grp
    before = t.pool[tick - 1, lane].double()
    M, _ = tf.closed_loop(dict(plant, force_std=0.0), 2)
    step = t.pool[tick, lane].double() - torch.tensor(M) @ before
    assert abs(abs(float(step[1])) - 0.1) < 1e-6
    assert float(step[0].abs() + step[2].abs()) < 1e-6
    # the closed loop is stable and brings the velocity back
    assert max(abs(np.linalg.eigvals(M))) < 1.0
    later = t.pool[(tick + 150) % 400, lane]
    assert float(later[1].abs()) < 0.1 * abs(float(step[1]))


def test_plant_stream_is_stationary_at_the_lqr_sway():
    """With force noise alone, the pool's spread matches the closed loop's
    stationary covariance, and the same seed gives the same stream."""
    import numpy as np
    import scipy.linalg as sl
    import torch

    from benchmark import traffic as tf
    cfg, serving = _tiny_zmp()
    plant = serving.plant(cfg)
    spec = {"mode": "periodic", "period_ms": 10.0, "pool_ticks": 2000,
            "plant": {"force_std": 0.4}, "sample": {"count": 1, "lanes": 1}}
    a = tf.Traffic(spec, cfg, 64, 5, torch.device("cpu"), plant).pool
    b = tf.Traffic(spec, cfg, 64, 5, torch.device("cpu"), plant).pool
    assert torch.equal(a, b)
    M, S = tf.closed_loop(dict(plant, force_std=0.4), 2)
    C = sl.solve_discrete_lyapunov(M, S @ S.T)
    got = a.double().reshape(-1, 3).std(0).numpy()
    assert np.allclose(got, np.sqrt(np.diag(C)), rtol=0.1)


def test_dare_is_scipys():
    """The plain controller's Riccati solution, by doubling, is SciPy's."""
    import numpy as np
    import scipy.linalg as sl

    from benchmark import traffic as tf
    cfg, serving = _tiny_zmp()
    p = serving.plant(cfg)
    got = tf.dare(p["A"], p["B"], p["Q"], p["R"])
    want = sl.solve_discrete_are(p["A"], p["B"], p["Q"], p["R"])
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
