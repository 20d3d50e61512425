"""Run one cell of the port's benchmark once, and print its result.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, one JSON object; the numbers that decide ``correct`` are the last
lines of standard error, each beside its limit. It exits with another code
than 0, and prints no result, where there is no CUDA card or fewer than the
cell asks for, where the program is not beside the benchmark, or where the
JAX package or JAX was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the traffic's raycast kernel (Triton) is built once a checkout, at a
    # fixed place inside it, unless the caller names a cache of its own
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".port_bench_cache", "triton"))

    # one process with few threads: the host's work is the program's Python
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    from port_bench import harness

    bench = harness.load_json(os.path.join(harness.REPO, "BENCHMARK.json"))
    spec = harness.resolve(bench, args.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: the cell needs {chips} CUDA card(s); {n} visible", file=sys.stderr)
        return 3
    try:
        import sycl_points_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"port_bench: the program (sycl_points_tpu_torch) is not beside the benchmark: {e}", file=sys.stderr)
        return 4
    devices = [torch.device("cuda", i) for i in range(chips)]
    # the host's work is this thread's Python: it keeps cores of its own, as
    # many as the cell has cards (the threads it starts later inherit them);
    # the CUDA driver's threads, started with the contexts, keep the rest
    for d in devices:
        torch.empty(1, device=d)
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-chips:])
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), devices, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"port_bench: loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 5
    print(json.dumps({k: v for k, v in result.items() if k != "checks"} | {"checks": result["checks"]}))
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
