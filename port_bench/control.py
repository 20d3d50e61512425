"""Readings for the limits of ``correct``: the program's and the control's.

    python3 -m port_bench.control --workload <name> --seeds 1,2,3 --seconds <s> [--out <file>]

Runs the cell once a seed, in one process, at its own size and load, and
prints for each seed one JSON line: the program's reading of every number
the check compares, and the control's: the plain reference computed in
bfloat16 in the program's place on the same captured inputs, judged by the
float64 reference. A limit lies above the program's readings and below
the control's (PERF.md). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from port_bench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(harness.REPO, ".port_bench_cache", "triton"))
    bench = harness.load_json(f"{harness.REPO}/BENCHMARK.json")
    spec = harness.resolve(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(spec.cell["chips"]):
        print("port_bench.control: no card for this cell", file=sys.stderr)
        return 3
    devices = [torch.device("cuda", i) for i in range(int(spec.cell["chips"]))]
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(spec, seed, args.seconds, False, devices, time.perf_counter(), control=True)
        line = json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                           "program": {k: v[0] for k, v in r["checks"].items()},
                           "control": {k: v[0] for k, v in r["control"]["numbers"].items()},
                           "control_correct": r["control"]["correct"], "checked": r["detail"]["checked"],
                           "metrics": r["metrics"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
