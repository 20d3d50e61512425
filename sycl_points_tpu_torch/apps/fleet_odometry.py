"""Multi-sequence fleet odometry runner: N LiDAR sequences through one
:class:`~..parallel.fleet.FleetOdometry`, one launch sequence and one stats
fetch a frame for all of them.

Counterpart of :mod:`sycl_points_tpu.apps.fleet_odometry` (where the
reference runs one rosbag-eval process a sequence). Each positional argument
is a sequence directory of KITTI Velodyne ``.bin`` or ``.ply`` scans.
Sequences of different lengths are padded with empty frames: a finished
stream's pose holds while the others go on. Each stream's trajectory is
written in TUM format. Runs on the card unless ``--device cpu`` is given, and
raises without a card.

    python -m sycl_points_tpu_torch.apps.fleet_odometry SEQ_DIR [SEQ_DIR ...] \\
        [--max-frames N] [--out-prefix fleet] [--config params.yaml] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.apps.kitti_odometry import default_kitti_params, write_tum
from sycl_points_tpu_torch.parallel.fleet import FleetOdometry
from sycl_points_tpu_torch.pipeline.params import LidarOdometryParams, load_params
from sycl_points_tpu_torch.points import io
from sycl_points_tpu_torch.points.conversion import read_kitti_bin
from sycl_points_tpu_torch.points.point_cloud import PointCloud, pad_capacity_for


def _load_scan(path: str) -> np.ndarray:
    if path.endswith(".bin"):
        return read_kitti_bin(path)["points"]
    return io.read_file(path)["points"]


def run_fleet(
    files_per_stream,
    params: LidarOdometryParams,
    out_prefix: str,
    rate: float = 10.0,
    log=sys.stderr,
    device: torch.device | str = "cuda",
    **fleet_kwargs,
) -> list:
    """Run the fleet over per-stream lists of scan files; write
    ``{out_prefix}_{s}.tum`` a stream and return the paths. ``fleet_kwargs``
    go to :class:`~..parallel.fleet.FleetOdometry`. The returned list also
    carries the fleet (``fleet``) and the host ms of each fleet frame's
    ``process_batch`` call (``frame_ms``), for the caller's telemetry."""
    device = require_device(device)
    B = len(files_per_stream)
    n_frames = max(len(f) for f in files_per_stream)
    first_lens = [len(_load_scan(f[0])) for f in files_per_stream]
    raw_cap = pad_capacity_for(int(max(first_lens) * 1.3))

    fleet = FleetOdometry(params, n_streams=B, device=device, **fleet_kwargs)
    truncated = np.zeros(B, np.int64)  # no silent caps: count tail losses
    frame_ms = []
    t_start = time.perf_counter()
    for i in range(n_frames):
        pts_b = np.zeros((B, raw_cap, 3), np.float32)
        mask_b = np.zeros((B, raw_cap), bool)
        for s, files in enumerate(files_per_stream):
            if i < len(files):  # a finished stream gets an empty frame: its pose holds
                full = _load_scan(files[i])
                truncated[s] += max(0, len(full) - raw_cap)
                n = min(len(full), raw_cap)
                pts_b[s, :n] = full[:n, :3]
                mask_b[s, :n] = True
        stacked = PointCloud(points=torch.from_numpy(pts_b).to(device), mask=torch.from_numpy(mask_b).to(device))
        t0 = time.perf_counter()
        fleet.process_batch(stacked, timestamps=i / rate)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if i % 10 == 0:
            elapsed = time.perf_counter() - t_start
            print(f"frame {i}/{n_frames}  ({elapsed / max(i, 1) * 1e3:.0f} ms/fleet-frame, {B} streams)",
                  file=log)
    fleet.flush()
    total = time.perf_counter() - t_start
    print(f"{n_frames} fleet frames x {B} streams in {total:.1f}s ({total / n_frames * 1e3:.1f} ms/fleet-frame, "
          f"{total / n_frames / B * 1e3:.2f} ms/stream-frame)", file=log)

    if truncated.any():
        print(f"WARNING: scans exceeded the capacity tier sized from frame 0 (raw_cap={raw_cap}); "
              f"truncated points per stream: {truncated.tolist()}", file=log)

    outs = _Outputs()
    outs.fleet, outs.frame_ms = fleet, frame_ms
    for s, files in enumerate(files_per_stream):
        stamps = [0.0]
        poses = [fleet._initial_poses[s]]
        for idx, ts, T, _rt in fleet.pose_log[s]:
            if idx < len(files):  # drop the hold-pose padding frames
                stamps.append(ts)
                poses.append(T)
        out = f"{out_prefix}_{s}.tum"
        write_tum(out, stamps, poses)
        outs.append(out)
        print(f"stream {s}: {len(poses)} poses -> {out}", file=log)
    return outs


class _Outputs(list):
    """The TUM paths, with the fleet that made them (``fleet``) and its
    frames' host ms (``frame_ms``)."""

    fleet: FleetOdometry
    frame_ms: list


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("seq_dirs", nargs="+")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out-prefix", default="fleet")
    ap.add_argument("--config", default=None)
    ap.add_argument("--rate", type=float, default=10.0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    files_per_stream = []
    for d in args.seq_dirs:
        files = sorted(glob.glob(os.path.join(d, "*.bin")) + glob.glob(os.path.join(d, "*.ply")))
        if args.max_frames:
            files = files[: args.max_frames]
        if not files:
            print(f"no scans in {d}", file=sys.stderr)
            return 1
        files_per_stream.append(files)

    params = load_params(args.config, LidarOdometryParams) if args.config else default_kitti_params()
    run_fleet(files_per_stream, params, args.out_prefix, rate=args.rate, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
