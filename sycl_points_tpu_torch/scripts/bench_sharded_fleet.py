"""The fleet split over a mesh of one card, in turns with the unsharded fleet.

Runs the JAX fleet benchmark's deployments (``apps.fleet_replay``: 8 x 1024
x 32, LO over 40 frames, the first 6 a warm-up; LIO over the first
``--lio-frames``, the first 3 a warm-up) through five fleets, in turns
(each round in order, the next one reversed): the unsharded fleet
(``mesh=None``), the same driven from another host thread on a CUDA
stream of its own (what a shard's thread adds, without the shards), the
one-entry mesh ``[cuda:0]``, the two-entry mesh
``[cuda:0, cuda:0]`` as the port runs it (the shards take turns on the
host, ``utils.sync.set_host_turn``), and the same two shards with the turns
replaced by a lock that never blocks (each shard's thread runs whenever
the GIL lets it). All five read the same scans; every run's poses must
equal the first unsharded run's within 1 mm.

Prints, for each fleet and run, the median and max ms of a fleet frame on
the host clock and the last frame's stages (added over the shards), then
the card's name and power limit, and one JSON object as the last line.

Usage: python -m sycl_points_tpu_torch.scripts.bench_sharded_fleet [--rounds 2] [--lio-frames 20]
"""

from __future__ import annotations

import argparse
import json
import queue
import statistics
import subprocess
import threading

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.apps import fleet_replay
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.parallel import fleet as fleet_module
from sycl_points_tpu_torch.points.point_cloud import pad_capacity_for

POSE_TOL_M = 1e-3


class _NoTurn:
    """A host turn that never blocks: the shards run as their threads get
    the GIL."""

    def acquire(self):
        return True

    def release(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _on_thread(fn, dev):
    """``fn()`` on a new host thread, on a CUDA stream of its own."""
    out: queue.SimpleQueue = queue.SimpleQueue()

    def body():
        with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
            try:
                out.put((True, fn()))
            except BaseException as e:  # noqa: BLE001 (raised below, in the caller)
                out.put((False, e))
        torch.cuda.synchronize(dev)

    t = threading.Thread(target=body)
    t.start()
    t.join()
    ok, value = out.get()
    if not ok:
        raise value
    return value


def _run(lio: bool, turns: bool, mesh, scans, trajs, cap, dev, thread: bool = False) -> dict:
    with_turns = fleet_module._host_turn
    if not turns:
        fleet_module._host_turn = _NoTurn
    try:
        kw = {} if mesh is None else {"mesh": mesh}
        if lio:
            def replay():
                return fleet_replay.run_fleet_lio_replay(fleet_replay.fleet_lio_params(), trajs, scans, device=dev,
                                                         capacity=cap, **kw)
        else:
            def replay():
                return fleet_replay.run_fleet_replay(fleet_replay.fleet_params(), trajs, scans, device=dev,
                                                     capacity=cap, **kw)
        out = _on_thread(replay, dev) if thread else replay()
    finally:
        fleet_module._host_turn = with_turns
    ms = [r["ms"] for r in out["rows"][3 if lio else fleet_replay.FLEET_WARMUP:]]
    return {"median_ms": statistics.median(ms), "max_ms": max(ms), "poses": out["poses"],
            "stages_ms": {k: v * 1e3 for k, v in sorted(out["fleet"].processing_times.items())}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--lio-frames", type=int, default=20)
    args = ap.parse_args(argv)
    dev = require_device(torch.device("cuda", 0))
    cuda_knn.load_library()
    trajs, scans = fleet_replay.make_fleet_scans(device=dev)
    cap = pad_capacity_for(fleet_replay.FLEET_RAYS[0] * fleet_replay.FLEET_RAYS[1])
    results = {}
    for tag, frames in (("LO", scans), ("LIO", scans[: args.lio_frames])):
        variants = [(f"{tag} unsharded", None, True, False), (f"{tag} unsharded, on a thread", None, True, True),
                    (f"{tag} [cuda:0]", [dev], True, False), (f"{tag} two shards", [dev, dev], True, False),
                    (f"{tag} two shards, no turns", [dev, dev], False, False)]
        for r in range(args.rounds):
            for name, mesh, turns, thread in (variants if r % 2 == 0 else variants[::-1]):
                out = _run(tag == "LIO", turns, mesh, frames, trajs, cap, dev, thread)
                results.setdefault(name, []).append(out)
                first = results[f"{tag} unsharded"][0]["poses"]
                gap = max(float(np.abs(a[:3, 3] - b[:3, 3]).max())
                          for pa, pb in zip(out["poses"], first) for a, b in zip(pa, pb))
                print(f"{name}, round {r}: ms a fleet frame median {out['median_ms']:.3f}, max {out['max_ms']:.3f}; "
                      f"poses within {gap * 1e3:.4f} mm of the first unsharded run; the last frame's stages "
                      + ", ".join(f"{k} {v:.2f}" for k, v in out["stages_ms"].items()), flush=True)
                if gap > POSE_TOL_M:
                    raise AssertionError(f"{name}: poses {gap} m from the unsharded fleet's")
    summary = {name: {"median_ms": [o["median_ms"] for o in outs], "max_ms": [o["max_ms"] for o in outs]}
               for name, outs in results.items()}
    for name, s in summary.items():
        print(f"{name}: medians {[round(v, 3) for v in s['median_ms']]} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
