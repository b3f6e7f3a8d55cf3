"""Readings that the limits of `correct` are set from, many seeds in one
process (the benchmark's own runs never run this):

    python3 benchmark/calibrate.py --workload <cell> --seconds <s>
        [--program-seeds a,b,..] [--control-seeds x,y,..]
        [--half-batch-seeds u,v,..]

For each program seed, a whole run of the cell with a short window (its
readings: the program against the reference); for each control seed,
the reference in the program's place at the cell's `control` precision;
for each half-batch seed (train cells), the reference on the first half
of every batch. One JSON line a run on standard output.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program-seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--half-batch-seeds", type=seeds, default=[])
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", cell["config"])
    driver = harness.load_module("drivers", cell["driver"])
    dev = torch.device("cuda", 0)

    def ctx(seed):
        return harness.Context(args.workload, cell, config, seed,
                               args.seconds, False, dev, time.perf_counter())

    def emit(seed, side, readings, **extra):
        print(json.dumps(dict(workload=args.workload, seed=seed, side=side,
                              readings=readings, **extra)), flush=True)

    for s in args.program_seeds:
        rec = driver.run(ctx(s))
        emit(s, "program", rec["readings"], e2e=rec["e2e"],
             failed=rec["failed"], peak=rec["memory_peak_bytes"])
    for s in args.control_seeds:
        emit(s, "control", driver.control_readings(ctx(s)))
    for s in args.half_batch_seeds:
        emit(s, "half_batch", driver.control_readings(ctx(s), half_batch=True))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
