#!/usr/bin/env python3
"""The readings that a cell's limit on ``u_gap`` is set from, run by hand
on the card (the benchmark's runs do not run it):

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> --precision float32,tf32

For each seed, one run of the cell (set-up, a window of ``--seconds``,
the check), then the control: the reference itself, computed in each
of ``--precision`` (the precision below the configuration's), put in the
program's place on the same samples.  One JSON line a seed: the program's
``u_gap`` (the lower reading) and the control's (the upper).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import harness as h  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--precision", required=True)
    args = ap.parse_args(argv)
    spec = h.cell_spec(h.load_json(os.path.join(h.ROOT, "BENCHMARK.json")),
                       args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        kept = {}
        r = h.run_cell(spec, seed, args.seconds, False, device, time.time(),
                       keep=kept)
        samples = [s for s in kept["window"].samples if s is not None]
        ctrl = {p: h.gaps(kept["cfg"], kept["ref"], kept["raw"],
                          kept["traffic"], samples, device, p)[0]
                for p in args.precision.split(",")}
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "u_gap": r["checks"]["u_gap"]["value"],
                          "control_u_gap": ctrl,
                          "ref_residual": r["info"]["ref_residual"],
                          "ticks": r["info"]["ticks"],
                          "metrics": r["metrics"]}), flush=True)
        del kept, r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
