"""The benchmark of ``copra_tpu_torch``: one cell of ``BENCHMARK.json``,
run once.

A cell names a configuration (``benchmark/configs/<name>.json``, whose
``serving`` key names the module under ``benchmark/serving/`` that builds
and calls the program, and whose name names its plain reference under
``benchmark/reference/``) and a traffic mix (``benchmark/traffic/
<name>.json``, read by :mod:`benchmark.traffic`); the limits of its check
are ``benchmark/checks/<cell>.json``.  Each per-layer metric is read by
``benchmark/metrics/<name>.py``.  A new cell, configuration or
metric is new files and entries; nothing here names one.

A run: set-up (inputs and weights from the seed, the program's build, a
warm-up of every shape the traffic uses), the measured window, the peak
memory, the program's state freed, then the check of the sampled controls
against the reference.  ``--trace 1`` runs the same window under
``torch.profiler`` and reports the per-layer metrics instead of the
end-to-end ones; where one of them times the host itself, an untraced
window of the same length runs first, and the check covers both.
"""

from __future__ import annotations

import argparse
import collections
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import trace as tr
from benchmark.traffic import Reservoir, Traffic, _rng

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "copra_tpu")
WARMUP_CALLS = 3
# chained calls in flight: the device always has the next call queued
IN_FLIGHT = 2
# the reference's own natural residual, relative to the controls' scale:
# above it the reference did not solve the problem it was given
REF_RESIDUAL = 1e-10


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py``, found by name."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plant_of(serving, cfg: dict):
    """The serving module's ``plant(cfg)`` for the traffic, or None where
    the module has none."""
    return serving.plant(cfg) if hasattr(serving, "plant") else None


def process_start() -> float:
    """The time (``time.time()``) at which this process started."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell ``workload`` of ``bench``: its entry, its configuration's
    entry and the names of its end-to-end and per-layer metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"benchmark: no workload {workload!r} in "
                         f"BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    # a metric with a workloads key is read in those cells; one without,
    # in every cell that reports the end-to-end metric it moves
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [])
             or ("workloads" not in m and m["moves"] in names)]
    return dict(cell=cell, config=config, end_to_end=e2e, per_layer=layer)


class Window:
    """What the measured window leaves: ticks and calls completed, the
    window's seconds, each tick's latency and its parts (periodic), the
    sampled controls and the count of non-finite lane answers."""

    def __init__(self, traffic: Traffic, seed: int):
        self.traffic = traffic
        self.reservoir = Reservoir(traffic.samples, seed)
        self.pick = _rng(seed, 6)
        self.samples = [None] * traffic.samples
        self.ticks = self.calls = 0
        # per tick: seconds from due to done, and (late at issue, issue,
        # synchronise)
        self.latency, self.parts, self.late, self.dropped = [], [], 0, 0
        self.ref_residual = None
        self.seconds = 0.0
        self.bad = None

    def keep(self, U: torch.Tensor, first_tick: int, per_call: int):
        """Count the call's non-finite lane answers and offer it to the
        sample (``U [T, B, n]`` or ``[B, n]``)."""
        if U.dim() == 2:
            U = U[None]
        bad = (~torch.isfinite(U)).any(-1).sum()
        self.bad = bad if self.bad is None else self.bad + bad
        slot = self.reservoir.offer(self.calls)
        if slot is not None:
            off = int(self.pick.integers(per_call))
            tick = (first_tick + off) % self.traffic.pool_ticks
            lanes = self.traffic.sample_lanes(tick)
            # views stacked on the device: an index tensor would be a copy
            # from the host, which waits for the calls in flight
            self.samples[slot] = (tick, lanes,
                                  torch.stack([U[off, i] for i in lanes]))


class Spans:
    """The benchmark's own host spans, ``{name: [(start_ns, end_ns)]}`` on
    ``time.time_ns()``, the clock of the profiler's events; with ``on``
    false it records nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.spans = {}

    @contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append((start, time.time_ns()))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(served, traffic: Traffic, seed: int, seconds: float,
               start_tick: int, device, span: Spans) -> Window:
    """The measured window of ``seconds``: calls back to back (``chain``,
    at most two in flight) or ticks due every ``period_ms`` (``periodic``,
    each synchronised; a tick's latency runs from when it was due)."""
    w = Window(traffic, seed)
    P = traffic.pool_ticks
    t = start_tick
    cuda = device.type == "cuda"
    if traffic.mode == "chain":
        T = int(traffic.spec["ticks_per_call"])
        inflight = collections.deque()
        _sync(device)
        t0 = time.perf_counter()
        with span("bench.window"):
            while time.perf_counter() - t0 < seconds:
                if len(inflight) >= IN_FLIGHT:
                    with span("bench.wait"):
                        inflight.popleft().synchronize()
                s = t % P
                with span("bench.call"):
                    U = served.call(traffic.pool[s:s + T])
                with span("bench.keep"):
                    w.keep(U, s, T)
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record()
                    inflight.append(ev)
                t += T
                w.calls += 1
            with span("bench.drain"):
                _sync(device)
        w.seconds = time.perf_counter() - t0
        w.ticks = w.calls * T
        return w
    period = float(traffic.spec["period_ms"]) / 1e3
    _sync(device)
    t0 = time.perf_counter()
    end = t0
    with span("bench.window"):
        while w.calls * period < seconds:
            due = t0 + w.calls * period
            now = time.perf_counter()
            if now - t0 > 2.0 * seconds + 30.0:
                # far behind its arrivals: the ticks still due are refused
                w.dropped = int(np.ceil(seconds / period)) - w.calls
                break
            if now < due:
                with span("bench.wait_due"):
                    # a sleep may overshoot by milliseconds on a busy
                    # host: sleep to 5 ms short of the due time, then spin
                    if due - now > 10e-3:
                        time.sleep(due - now - 5e-3)
                    while time.perf_counter() < due:
                        pass
            elif now - due > 1e-3:
                w.late += 1
            with span("bench.tick"):
                ts = time.perf_counter()
                with span("bench.issue"):
                    U = served.call(traffic.pool[t % P])
                ti = time.perf_counter()
                with span("bench.sync"):
                    _sync(device)
                end = time.perf_counter()
            w.latency.append(end - due)
            w.parts.append((ts - due, ti - ts, end - ti))
            with span("bench.keep"):
                w.keep(U, t % P, 1)
            t += 1
            w.calls += 1
    w.seconds = end - t0
    w.ticks = w.calls
    return w


def warm_up(served, traffic: Traffic, device, start: int = 0,
            calls: int = WARMUP_CALLS, seed: int = 0) -> int:
    """Run the traffic's call pattern ``calls`` times from tick ``start``,
    each call's output through the window's own bookkeeping (the first call
    of a run builds the kernels, captures the graph or runs the cold tick,
    and the first use of each CUDA kernel loads its module); returns the
    next tick."""
    T = int(traffic.spec["ticks_per_call"]) if traffic.mode == "chain" \
        else 1
    scratch = Window(traffic, seed)
    t = start
    for _ in range(calls):
        s = t % traffic.pool_ticks
        U = served.call(traffic.pool[s:s + T] if traffic.mode == "chain"
                        else traffic.pool[s])
        scratch.keep(U, s, T)
        scratch.calls += 1
        t += T
    _sync(device)
    return t


def gaps(cfg: dict, ref, raw: dict, traffic: Traffic, kept, device,
         precision=None):
    """``(u_gap, ref_residual)`` over the samples ``kept`` (``(tick,
    lanes, U)`` each), all in one call of the reference; with
    ``precision`` the controls judged are the reference's own in that
    precision (the control) instead of the program's."""
    gap = res_rel = 0.0
    if not kept:
        return gap, res_rel
    lanes = [lane for _, ln, _ in kept for lane in ln]
    ticks = [t for t, ln, _ in kept for _ in ln]
    x0 = traffic.pool[torch.as_tensor(ticks, device=device),
                      torch.as_tensor(lanes, device=device)]
    Uref, res = ref.controls(cfg, raw, x0, lanes)
    got = (torch.cat([U for _, _, U in kept]) if precision is None else
           ref.controls(cfg, raw, x0, lanes, precision)[0])
    i = 0
    for _, ln, _ in kept:
        r, rs = Uref[i:i + len(ln)], res[i:i + len(ln)]
        scale = float(r.abs().max().clamp(min=1e-30))
        gap = max(gap, float((got[i:i + len(ln)].double() - r).abs().max())
                  / scale)
        res_rel = max(res_rel, float(rs.max()) / scale)
        i += len(ln)
    return gap, res_rel


def check(cfg: dict, limits: dict, ref, raw: dict, traffic: Traffic,
          windows, device) -> dict:
    """The numbers that decide ``correct``, each with its limit: each
    sampled tick's controls against the reference's at the same initial
    states (``u_gap``: the largest ``max |U - U_ref| / max |U_ref|`` of a
    sample), the lane answers that were not finite or were refused, and
    the samples kept, over every window of the run.  Raises where the
    reference itself did not solve."""
    kept = [s for w in windows for s in w.samples if s is not None]
    gap, res_rel = gaps(cfg, ref, raw, traffic, kept, device)
    for w in windows:
        w.ref_residual = res_rel
    if not res_rel <= REF_RESIDUAL:
        raise RuntimeError(
            f"the reference did not solve the sampled problems (natural "
            f"residual {res_rel!r} of the controls' scale, over "
            f"{REF_RESIDUAL!r}); the run cannot be judged")
    bad = sum((0 if w.bad is None else int(w.bad)) + w.dropped * traffic.lanes
              for w in windows)
    return collections.OrderedDict([
        ("u_gap", {"value": gap, "limit": limits["u_gap"]}),
        ("failed", {"value": bad, "limit": 0}),
        ("samples", {"value": len(kept),
                     "limit": traffic.samples * len(windows)})])


def _passes(checks: dict) -> bool:
    c = checks
    return (c["u_gap"]["value"] <= c["u_gap"]["limit"]
            and c["failed"]["value"] <= 0
            and c["samples"]["value"] >= c["samples"]["limit"])


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, device,
             t_start: float, fault=None, sizes=None, keep=None) -> dict:
    """One run of the cell ``spec`` (:func:`cell_spec`).  For the tests:
    ``fault`` wraps the served object's ``call``, and ``sizes`` updates
    the configuration and the traffic (``{"config": {...}, "traffic":
    {...}}``); a dict ``keep`` receives the run's inputs and samples."""
    sizes = sizes or {}
    cfg = load_json(os.path.join(ROOT, spec["config"]["file"]))
    cfg.update(sizes.get("config", {}))
    traffic_spec = load_json(os.path.join(
        BENCH_DIR, "traffic", f"{spec['cell']['traffic']}.json"))
    traffic_spec.update(sizes.get("traffic", {}))
    serving = load_module("serving", cfg["serving"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    lanes = serving.lanes(cfg)
    phases = {"start": time.time() - t_start}

    def phase(name):
        _sync(device)
        phases[name] = time.time() - t_start - sum(phases.values())

    raw = serving.make_inputs(cfg, seed, device)
    traffic = Traffic(traffic_spec, cfg, lanes, seed, device,
                      plant_of(serving, cfg))
    phase("inputs")
    served = serving.Served(cfg, raw, traffic.pool[0])
    phase("build")
    if fault is not None:
        served.call = fault(served.call)
    start_tick = warm_up(served, traffic, device, seed=seed)
    # what set-up built lives on: out of the collector's scans, so that a
    # full collection in the window walks only what the window makes
    gc.collect()
    gc.freeze()
    phase("warm_up")
    setup_s = time.time() - t_start

    readers = {m["name"]: load_module("metrics", m["name"])
               for m in spec["per_layer"]} if traced else {}
    legs = []
    if any(getattr(r, "UNTRACED", False) for r in readers.values()):
        # a metric of the host's own time is read with the profiler off:
        # a window of its own before the traced one
        legs.append(run_window(served, traffic, seed, seconds, start_tick,
                               device, Spans(False)))
        start_tick += legs[-1].ticks
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        # the device's activity only: recording every host op would slow
        # the host-paced ticks; the benchmark's spans are its own
        prof = profile(activities=[ProfilerActivity.CUDA]
                       if device.type == "cuda" else
                       [ProfilerActivity.CPU])
        prof.__enter__()
        # the profiler's first records are slow: one call before the window
        start_tick = warm_up(served, traffic, device, start_tick, calls=1,
                             seed=seed)
    span = Spans(traced)
    w = run_window(served, traffic, seed, seconds, start_tick, device, span)
    legs.append(w)
    if prof is not None:
        prof.__exit__(None, None, None)
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    lanes_done = sum(v.ticks + v.dropped for v in legs) * lanes
    del served
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = load_module("reference", spec["config"]["name"])
    limits = load_json(os.path.join(BENCH_DIR, "checks",
                                    f"{spec['cell']['name']}.json"))
    checks = check(cfg, limits, ref, raw, traffic, legs, device)
    if keep is not None:
        keep.update(cfg=cfg, ref=ref, raw=raw, traffic=traffic, window=w)

    metrics, info_extra = {}, {}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {}
    if traced:
        ops, spans = tr.collect(prof), span.spans
        win = spans["bench.window"][0]
        busy = tr.busy_ns(ops, [win]) / 1e9
        window_s = (win[1] - win[0]) / 1e9
        dev_info.update(busy_s=busy, window_s=window_s)
        # the spans and the device's events share a clock: nearly all the
        # device's time falls inside the window
        info_extra["ops_in_window"] = busy / max(
            tr.busy_ns(ops) / 1e9, 1e-30) if ops else None
        if "bench.tick" in spans and busy > 0:
            # and a served tick's work falls inside its span
            info_extra["ops_in_ticks"] = tr.busy_ns(
                ops, spans["bench.tick"]) / 1e9 / busy
        ctx = SimpleNamespace(
            ops=[o for o in ops if o.start >= win[0] and o.end <= win[1]],
            spans=spans, window=win, ticks=w.ticks, calls=w.calls,
            cfg=cfg, traffic=traffic.spec, peaks=load_json(
                os.path.join(BENCH_DIR, "peaks.json")),
            roofline=lambda k: load_module("roofline", k), trace=tr,
            untraced=legs[0] if len(legs) > 1 else None)
        for m in spec["per_layer"]:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["breakdown"] = tr.breakdown(ops, spans, win)
    else:
        values = {"setup_s": setup_s}
        if w.ticks:
            values["solves_per_s"] = w.ticks * lanes / w.seconds
        if w.latency:
            values["tick_ms_p95"] = float(
                np.percentile(np.asarray(w.latency) * 1e3, 95))
        for m in spec["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    info = {"seed": seed, "ticks": w.ticks, "calls": w.calls,
            "window_s": w.seconds, "late_ticks": w.late,
            "dropped_ticks": w.dropped,
            "ref_residual": w.ref_residual,
            "setup_s": setup_s, "setup_phases_s": phases,
            "power_limit": power_limit() if device.type == "cuda" else None}
    info.update(info_extra)
    if w.latency:
        lat = np.asarray(w.latency) * 1e3
        worst = np.argsort(lat)[-5:][::-1]
        info.update(tick_ms_p50=float(np.median(lat)),
                    tick_ms_max=float(lat.max()),
                    issue_ms_mean=float(np.mean([p[1] for p in w.parts])
                                        * 1e3),
                    # (tick, ms late at issue, ms to issue, ms to sync)
                    worst_ticks=[[int(i)] + [v * 1e3 for v in w.parts[i]]
                                 for i in worst])
    result = {"correct": _passes(checks), "attempted": int(lanes_done),
              "failed": int(checks["failed"]["value"]),
              "metrics": metrics, "device": dev_info}
    result.update(out)
    result["info"] = info
    result["checks"] = checks
    return result


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = cell_spec(bench, args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell {args.workload} needs {chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(2)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      device, t_start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)}; the "
              f"benchmark and the port must not load them", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    print(json.dumps(result))
    return 0
