"""The JAX fleet benchmark's deployment on the port: ``B`` streams of
synthetic Velodyne scans through one :class:`~..parallel.fleet.FleetOdometry`.

The deployment is the JAX package's ``benchmarks/bench_fleet.py:52-117`` on
the voxel-hash map: 8 streams, each on the figure-8 at 0.35 m a frame from
its own turned and shifted start (:func:`~..utils.synthetic.fleet_trajectories`),
1024 x 32 rays a scan (32,768 raw points, the ray pattern and noise seeded
``1000 s + i``), the scan voxel-downsampled at 1.0 m and sampled to 5,000
points, no polar grid, a 2^16-slot map of 1.0 m voxels, 512 points sampled
into it a keyframe; 40 frames, the first 6 a warm-up. Frame ``i`` is at
``t = 0.1 (i + 1)``, as in :mod:`.odometry_replay`, so that a stream and the
single-stream replay of its scans see the same clock.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.apps.odometry_replay import FRAME_DT, ate
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.parallel.fleet import FleetOdometry
from sycl_points_tpu_torch.pipeline.params import (
    DownsamplingParams,
    LidarOdometryParams,
    PolarDownsamplingParams,
    RandomDownsamplingParams,
    ScanParams,
    SubmapParams,
    VoxelDownsamplingParams,
)
from sycl_points_tpu_torch.points.point_cloud import PointCloud, pad_capacity_for
from sycl_points_tpu_torch.utils import sync
from sycl_points_tpu_torch.utils.synthetic import World, fleet_trajectories, scan_at

FLEET_STREAMS = 8
FLEET_FRAMES = 40
FLEET_WARMUP = 6
FLEET_RAYS = (1024, 32)
FLEET_SPEED = 0.35
FLEET_MAP_CAPACITY = 1 << 16
FLEET_KERNELS = ("nn1_batched", "knn_k_batched")


def fleet_params(map_capacity: int = FLEET_MAP_CAPACITY, map_voxel: float = 1.0) -> LidarOdometryParams:
    """The fleet benchmark's parameter tree; every value not named here is
    the tree's default."""
    return LidarOdometryParams(
        scan=ScanParams(downsampling=DownsamplingParams(
            voxel=VoxelDownsamplingParams(enable=True, size=1.0),
            polar=PolarDownsamplingParams(enable=False),
            random=RandomDownsamplingParams(enable=True, num=5000),
        )),
        submap=SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=map_voxel, map_capacity=map_capacity,
                            point_random_sampling_num=512),
    )


def make_fleet_scans(n_streams: int = FLEET_STREAMS, n_frames: int = FLEET_FRAMES, n_az: int = FLEET_RAYS[0],
                     n_rings: int = FLEET_RAYS[1], speed: float = FLEET_SPEED, device: torch.device | str = "cuda"):
    """``(trajs [B][n_frames] of [4, 4], scans [n_frames][B] of [N, 3]
    sensor-frame numpy arrays)``, raycast on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = require_device(device)
    world = World()
    trajs, _ = fleet_trajectories(n_streams, n_frames, speed=speed)
    scans = [[scan_at(world, trajs[s][i], n_az=n_az, n_rings=n_rings, seed=1000 * s + i, device=device)
              for s in range(n_streams)] for i in range(n_frames)]
    return trajs, scans


def stack_frame(frame, capacity: int, device: torch.device) -> PointCloud:
    """One frame of every stream as a fleet's cloud ``[B, capacity]``, made
    on the host and uploaded in one copy a field."""
    pts = np.zeros((len(frame), capacity, 3), np.float32)
    mask = np.zeros((len(frame), capacity), bool)
    for s, p in enumerate(frame):
        n = min(len(p), capacity)
        pts[s, :n] = p[:n]
        mask[s, :n] = True
    return PointCloud(points=torch.from_numpy(pts).to(device), mask=torch.from_numpy(mask).to(device))


def run_fleet_replay(params: LidarOdometryParams, trajs, scans, device: torch.device | str = "cuda",
                     capacity: int | None = None, **fleet_kwargs) -> dict:
    """Drive ``FleetOdometry.process_batch`` over ``scans`` (frame ``i`` at
    ``t = 0.1 (i + 1)``), the upload of each frame untimed, the frames not
    drained between them, then flush. Returns the fleet, a row a frame (ms
    of the call on the host clock, host reads by ``file:line``, the batched
    kernels' launches), the flush's ms, each stream's resolved poses (its
    first pose first) and ATE, the histogram of results, the frames that are
    not a success and the count of frames with no result."""
    device = require_device(device)
    B = len(trajs)
    cap = capacity or pad_capacity_for(max(len(p) for frame in scans for p in frame))
    fleet = FleetOdometry(params, n_streams=B, initial_poses=np.stack([t[0] for t in trajs]), device=device,
                          **fleet_kwargs)
    rows = []
    for i, frame in enumerate(scans):
        cloud = stack_frame(frame, cap, device)
        reads, launches = Counter(sync.by_source), dict(cuda_knn.launch_counts)
        t0 = time.perf_counter()
        fleet.process_batch(cloud, FRAME_DT * (i + 1))
        rows.append({"frame": i, "ms": (time.perf_counter() - t0) * 1e3,
                     "reads": dict(Counter(sync.by_source) - reads),
                     "launches": {k: cuda_knn.launch_counts[k] - launches[k] for k in FLEET_KERNELS}})
    t0 = time.perf_counter()
    fleet.flush()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    flush_ms = (time.perf_counter() - t0) * 1e3

    poses, ates, hist, not_ok = [], [], Counter(), []
    for s in range(B):
        est = [trajs[s][0]] + [T for _, _, T, _ in fleet.pose_log[s]]
        poses.append(est)
        ates.append(ate(est, trajs[s][: len(est)]))
        for i, rt in fleet.deferred_results[s]:
            hist[rt.value] += 1
            if rt.value != "success":
                not_ok.append({"stream": s, "frame": i, "result": rt.value})
    return {"fleet": fleet, "rows": rows, "flush_ms": flush_ms, "poses": poses, "ates": ates,
            "histogram": dict(hist), "not_ok": not_ok,
            "unaccounted": B * (len(scans) - 1) - sum(hist.values())}
