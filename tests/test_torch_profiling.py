"""The port's tracing, timing and metrics against the JAX reference, on the
CPU (the profiling half of ``tests/test_aux.py``).

``solve_metrics`` must equal the reference's dict on the same numbers
(exact); ``trace_device_time`` must give the exact busy time and top ops of
a synthetic Chrome trace (nested and overlapping kernels on two streams,
host events beside them) and ``None`` on a CPU trace; ``trace_span`` must
name its region in a CPU ``torch.profiler`` trace.
"""

import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import copra_tpu as ct
import copra_tpu_torch as tt
from copra_tpu.profiling import solve_metrics as jax_solve_metrics
from copra_tpu_torch.profiling import (solve_metrics, timed,
                                       trace_device_time, trace_span)

tt.set_default_device("cpu")


def _solutions(batch):
    """The same numbers as a reference and a port ``QPSolution``."""
    rng = np.random.default_rng(11)
    shape = (batch,) if batch else ()
    fields = dict(
        x=rng.normal(size=shape + (4,)), y=rng.normal(size=shape + (6,)),
        z=rng.normal(size=shape + (6,)),
        status=rng.integers(0, 3, size=shape).astype(np.int32),
        iterations=rng.integers(10, 400, size=shape).astype(np.int32),
        primal_residual=rng.uniform(1e-9, 1e-3, size=shape),
        dual_residual=rng.uniform(1e-9, 1e-3, size=shape))
    ref = ct.QPSolution(**{k: jnp.asarray(v) for k, v in fields.items()})
    port = tt.QPSolution(**{k: torch.tensor(v) for k, v in fields.items()})
    return ref, port


@pytest.mark.parametrize("batch", [0, 1, 37])
@pytest.mark.parametrize("elapsed_s", [None, 0.0, 0.0125])
def test_solve_metrics_equal_reference(batch, elapsed_s):
    ref, port = _solutions(batch)
    want = jax_solve_metrics(ref, elapsed_s)
    got = solve_metrics(port, elapsed_s)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in
                                               want.values()]


def test_timed_and_log_metrics():
    """``timed`` writes each block's seconds under its key, waiting for the
    devices of the tensors it is given."""
    system = tt.LTISystem.create(*(np.asarray(v) for v in (
        [[1.0, 0.1], [0.0, 1.0]], [[0.005], [0.1]], [0.0, 0.0],
        [1.0, 0.0])), 5)
    box = {}
    with timed(box, block_on=(system, [system.x0], None)):
        res = tt.solve_mpc(system, (tt.SimpleControlCost.create(
            np.zeros(5)),))
    assert box["seconds"] > 0
    with timed(box, key="again"):
        pass
    assert set(box) == {"seconds", "again"}
    m = solve_metrics(res.solution, elapsed_s=box["seconds"])
    assert m["batch"] == 1 and m["converged"] == 1
    assert m["solves_per_s"] > 0


def test_trace_span_names_its_region_and_cpu_trace_has_no_device(tmp_path):
    """A CPU trace holds the span by name, and no device track, so
    ``trace_device_time`` is ``None`` on it (as the reference's is on a CPU
    run); no NVTX call is made on a CPU-only build."""
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_span("unit-test-span"):
            y = (x @ x).sum()
    assert float(y) == 64.0 ** 3
    path = os.path.join(tmp_path, "cpu_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "unit-test-span" in names
    assert trace_device_time(str(tmp_path)) is None
    assert trace_device_time(os.path.join(tmp_path, "empty")) is None


def _x(name, ts, dur, tid, cat="kernel", pid=0):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur}


SYNTHETIC = [
    # stream 7: an enclosing record over two nested kernels, then one
    # overlapping the enclosing record's tail, then a gap, then a memcpy
    _x("graph_envelope", 100.0, 50.0, 7),
    _x("k_a", 105.0, 10.0, 7), _x("k_b", 120.0, 20.0, 7),
    _x("k_a", 140.0, 30.0, 7),
    _x("Memcpy DtoH", 200.0, 5.0, 7, cat="gpu_memcpy"),
    # stream 13, overlapping stream 7 in time: its own track
    _x("k_b", 110.0, 40.0, 13), _x("Memset", 160.0, 2.0, 13,
                                    cat="gpu_memset"),
    # host-side and annotation events: never device time
    _x("cudaLaunchKernel", 90.0, 500.0, 1, cat="cuda_runtime", pid=4242),
    _x("aten::mm", 80.0, 600.0, 1, cat="cpu_op", pid=4242),
    _x("span", 95.0, 200.0, 7, cat="gpu_user_annotation"),
    {"ph": "M", "name": "process_name", "pid": 0,
     "args": {"name": "GPU 0"}},
    {"ph": "i", "cat": "kernel", "name": "instant", "pid": 0, "tid": 7,
     "ts": 300.0},
]


def test_trace_device_time_exact_on_a_synthetic_trace(tmp_path):
    """Busy = per-stream interval union, summed: stream 7 covers
    [100, 170] and [200, 205] (75 us), stream 13 [110, 150] and [160, 162]
    (42 us); 117 us, where summing durations gives 157 and counting the
    host events more.  Top ops sum each name's durations."""
    with open(os.path.join(tmp_path, "old.json"), "w") as f:
        json.dump({"traceEvents": [_x("stale", 0.0, 1e6, 1)]}, f)
    os.utime(os.path.join(tmp_path, "old.json"), (1, 1))
    sub = os.path.join(tmp_path, "plugins", "host")
    os.makedirs(sub)
    path = os.path.join(sub, "worker0.pt.trace.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": SYNTHETIC}, f)
    busy, top = trace_device_time(str(tmp_path), top_k=3)
    assert busy == pytest.approx(117e-6, rel=0, abs=1e-15)
    assert [n for n, _ in top] == ["k_b", "graph_envelope", "k_a"]
    assert [s for _, s in top] == pytest.approx([60e-6, 50e-6, 40e-6],
                                                rel=0, abs=1e-15)
    _, every = trace_device_time(str(tmp_path), top_k=8)
    assert dict(every) == pytest.approx({
        "k_b": 60e-6, "graph_envelope": 50e-6, "k_a": 40e-6,
        "Memcpy DtoH": 5e-6, "Memset": 2e-6})
    # an uncompressed export_chrome_trace file, newer: it is the one read
    plain = os.path.join(tmp_path, "newer.json")
    with open(plain, "w") as f:
        json.dump({"traceEvents": [_x("only", 0.0, 3.0, 2)]}, f)
    os.utime(path, (2, 2))
    busy, top = trace_device_time(str(tmp_path))
    assert busy == pytest.approx(3e-6) and top == [("only", 3e-6)]


def _as_xla_trace(events):
    """The device events of a Chrome trace re-laid as ``jax.profiler``
    lays a device out: one ``/device:GPU:0`` process, each stream an
    ``XLA Ops`` thread, the host events under a host process."""
    meta = [{"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "/device:GPU:0"}},
            {"ph": "M", "name": "process_name", "pid": 2,
             "args": {"name": "/host:CPU"}}]
    out = []
    for e in events:
        if e.get("ph") != "X":
            continue
        if e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset"):
            out.append(dict(e, pid=1))
            meta.append({"ph": "M", "name": "thread_name", "pid": 1,
                         "tid": e["tid"],
                         "args": {"name": f"XLA Ops (stream {e['tid']})"}})
        else:
            out.append(dict(e, pid=2))
    return {"traceEvents": meta + out}


def test_trace_device_time_equals_the_reference_on_the_same_intervals(
        tmp_path):
    """The synthetic intervals read by the port (as a torch Chrome trace)
    and by ``copra_tpu.profiling.trace_device_time`` (as a jax.profiler
    trace): the same busy time and the same top ops."""
    from copra_tpu.profiling import trace_device_time as jax_trace_time

    ours, theirs = tmp_path / "torch", tmp_path / "xla" / "plugins"
    ours.mkdir()
    theirs.mkdir(parents=True)
    with open(ours / "trace.json", "w") as f:
        json.dump({"traceEvents": SYNTHETIC}, f)
    with gzip.open(theirs / "host.trace.json.gz", "wt") as f:
        json.dump(_as_xla_trace(SYNTHETIC), f)
    for k in (1, 3, 8):
        busy, top = trace_device_time(str(ours), top_k=k)
        want_busy, want_top = jax_trace_time(str(tmp_path / "xla"),
                                             top_k=k)
        assert busy == pytest.approx(want_busy, rel=0, abs=1e-15)
        assert [n for n, _ in top] == [n for n, _ in want_top]
        assert [s for _, s in top] == pytest.approx(
            [s for _, s in want_top], rel=0, abs=1e-15)
