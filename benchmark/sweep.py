#!/usr/bin/env python3
"""The capacity sweep of a periodic cell, run once by hand to fix the
cell's ``period_ms`` (the benchmark's runs do not run it):

    python3 benchmark/sweep.py --workload <name> --seed <n> --seconds <s> \
        --periods 0,9,10,11

One set-up, then a window at each period (0: back to back, each tick
issued when the last is done), one JSON line each: ticks, the mean,
median and 95th percentile of the latency from when each tick was due,
the ticks issued late and how far behind its schedule the window ended
(the 5th percentile beside the median shows ticks whose top-up ran).
A period the system sustains ends without a growing backlog.  Where
the traffic's states follow a plant, each period gets the stream of its
own number of model steps a tick.  ``--robots`` replaces the
configuration's fleet (``robots`` or ``lanes``), to see how the tick's time
grows with it.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness as h  # noqa: E402
from benchmark.traffic import Traffic  # noqa: E402


def main(argv):
    t_start = h.process_start()
    ap = argparse.ArgumentParser(prog="benchmark/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--periods", required=True)
    ap.add_argument("--robots", type=int, default=0)
    args = ap.parse_args(argv)
    spec = h.cell_spec(h.load_json(os.path.join(h.ROOT, "BENCHMARK.json")),
                       args.workload)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = h.load_json(os.path.join(h.ROOT, spec["config"]["file"]))
    if args.robots:
        cfg["robots" if "robots" in cfg else "lanes"] = args.robots
    tspec = h.load_json(os.path.join(h.BENCH_DIR, "traffic",
                                     f"{spec['cell']['traffic']}.json"))
    serving = h.load_module("serving", cfg["serving"])
    raw = serving.make_inputs(cfg, args.seed, device)
    plant = h.plant_of(serving, cfg)
    traffic = Traffic(tspec, cfg, serving.lanes(cfg), args.seed, device,
                      plant)
    served = serving.Served(cfg, raw, traffic.pool[0])
    t = h.warm_up(served, traffic, device)
    print(json.dumps({"setup_s": time.time() - t_start}), flush=True)
    for p in (float(p) for p in args.periods.split(",")):
        if p > 0:
            traffic = Traffic(dict(tspec, period_ms=p), cfg,
                              serving.lanes(cfg), args.seed, device, plant)
            w = h.run_window(served, traffic, args.seed, args.seconds, t,
                             device, h.Spans(False))
            lat, n, late = np.asarray(w.latency) * 1e3, w.ticks, w.late
            behind = w.seconds - (n - 1) * p / 1e3
        else:
            # back to back: each tick issued when the last is done
            lat, t0 = [], time.perf_counter()
            while time.perf_counter() - t0 < args.seconds:
                ts = time.perf_counter()
                served.call(traffic.pool[(t + len(lat))
                                         % traffic.pool_ticks])
                torch.cuda.synchronize(device)
                lat.append(time.perf_counter() - ts)
            lat, n, late, behind = np.asarray(lat) * 1e3, len(lat), None, None
        t += n
        print(json.dumps({
            "period_ms": p, "lanes": serving.lanes(cfg), "ticks": n,
            "latency_ms_mean": float(lat.mean()),
            "latency_ms_p05": float(np.percentile(lat, 5)),
            "latency_ms_p50": float(np.median(lat)),
            "latency_ms_p95": float(np.percentile(lat, 95)),
            "late_ticks": late, "behind_at_end_s": behind}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
