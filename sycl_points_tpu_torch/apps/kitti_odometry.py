"""KITTI sequence odometry runner: Velodyne ``.bin`` scans through the
odometry, the trajectory written in TUM format (``timestamp tx ty tz qx qy
qz qw``), the stage times printed.

Counterpart of :mod:`sycl_points_tpu.apps.kitti_odometry` (the ROS-less
counterpart of the reference's rosbag-eval nodes). Runs on the card unless
``--device cpu`` is given, and raises without a card.

    python -m sycl_points_tpu_torch.apps.kitti_odometry /path/to/sequence/velodyne \\
        [--max-frames N] [--out traj.tum] [--config params.yaml] [--lio] [--pipelined] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.pipeline.lidar_odometry import LidarOdometry
from sycl_points_tpu_torch.pipeline.params import (
    DownsamplingParams,
    IMUParams,
    LidarInertialOdometryParams,
    LidarOdometryParams,
    PolarDownsamplingParams,
    RandomDownsamplingParams,
    ScanParams,
    VoxelDownsamplingParams,
    load_params,
)
from sycl_points_tpu_torch.points.conversion import read_kitti_bin
from sycl_points_tpu_torch.points.point_cloud import PointCloud, pad_capacity_for
from sycl_points_tpu_torch.utils import lie_np


def default_kitti_params() -> LidarOdometryParams:
    return LidarOdometryParams(
        scan=ScanParams(
            downsampling=DownsamplingParams(
                voxel=VoxelDownsamplingParams(enable=True, size=1.0),
                polar=PolarDownsamplingParams(enable=False),
                random=RandomDownsamplingParams(enable=True, num=5000),
            ),
        ),
    )


def write_tum(path: str, stamps, poses):
    with open(path, "w") as f:
        for t, T in zip(stamps, poses):
            q = lie_np.matrix_to_quat(T[:3, :3])
            tx, ty, tz = T[:3, 3]
            f.write(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def _make_odometry(args, device):
    """The odometry the flags ask for, and its parameters."""
    if args.lio:
        if args.config:
            params = load_params(args.config, LidarInertialOdometryParams)
        else:
            params = LidarInertialOdometryParams(scan=default_kitti_params().scan, imu=IMUParams(enable=True))
        if args.pipelined:
            from sycl_points_tpu_torch.pipeline.pipelined_lio import PipelinedLidarInertialOdometry

            return PipelinedLidarInertialOdometry(params, device=device), params
        from sycl_points_tpu_torch.pipeline.lidar_inertial_odometry import LidarInertialOdometry

        return LidarInertialOdometry(params, device=device), params
    params = load_params(args.config, LidarOdometryParams) if args.config else default_kitti_params()
    if args.pipelined:
        from sycl_points_tpu_torch.pipeline.pipelined_odometry import PipelinedLidarOdometry

        return PipelinedLidarOdometry(params, device=device), params
    return LidarOdometry(params, device=device), params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("velodyne_dir")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out", default="trajectory.tum")
    ap.add_argument("--config", default=None)
    ap.add_argument("--rate", type=float, default=10.0, help="scan rate [Hz]")
    ap.add_argument("--lio", action="store_true",
                    help="run the LiDAR-inertial odometry (it needs an IMU stream; without one the LIO "
                         "degrades to a loose prior)")
    ap.add_argument("--pipelined", action="store_true",
                    help="the pipelined odometry (state on the device, the stats fetch deferred; poses "
                         "resolve a few frames behind and are flushed at the end)")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    files = sorted(glob.glob(os.path.join(args.velodyne_dir, "*.bin")))
    if args.max_frames:
        files = files[: args.max_frames]
    if not files:
        print(f"no .bin scans in {args.velodyne_dir}", file=sys.stderr)
        return 1
    lo, params = _make_odometry(args, device)

    # one capacity for every frame, from the first scan with a margin
    first = read_kitti_bin(files[0])
    raw_cap = pad_capacity_for(int(len(first["points"]) * 1.3))

    stamps, poses = [], []
    t_start = time.perf_counter()
    for i, path in enumerate(files):
        scan = read_kitti_bin(path)
        cloud = PointCloud.from_numpy(scan["points"][:raw_cap], intensities=scan["intensities"][:raw_cap],
                                      capacity=raw_cap, device=device)
        ts = i / args.rate
        result = lo.process(cloud, ts)
        if result.value not in ("success", "first_frame"):  # the LO's and the LIO's ResultType
            print(f"frame {i}: {result.value} ({lo.error_message})", file=sys.stderr)
        if not args.pipelined:
            stamps.append(ts)
            poses.append(lo.get_odometry())
        if i % 10 == 0:
            elapsed = time.perf_counter() - t_start
            t_last = np.round((poses[-1] if poses else lo.get_odometry())[:3, 3], 2)
            print(f"frame {i}/{len(files)}  t={t_last}  ({elapsed / max(i, 1) * 1e3:.0f} ms/frame)",
                  file=sys.stderr)

    if args.pipelined:
        lo.flush()
        stamps = [0.0] + [t for _, t, _, _ in lo.pose_log]
        poses = [np.asarray(params.pose.initial_matrix(), np.float32)] + [T for _, _, T, _ in lo.pose_log]
    write_tum(args.out, stamps, poses)
    total = time.perf_counter() - t_start
    print(f"{len(files)} frames in {total:.1f}s ({total / len(files) * 1e3:.1f} ms/frame)")
    print(f"trajectory written to {args.out}")
    for name, s in sorted(lo.get_processing_times().items()):
        print(f"  {name}: {s * 1e3:.1f} ms (last frame)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
