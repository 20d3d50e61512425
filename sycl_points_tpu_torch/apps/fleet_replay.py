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

The fleet-LIO deployment is the same benchmark run with ``--lio``
(``benchmarks/bench_fleet.py:112-200``): :func:`fleet_lio_params` adds the
IMU (noise densities 1e-3 and 1e-2, bias random walks 1e-5 and 1e-4) to the
same scan and submap trees, :func:`feed_fleet_imu` feeds every stream the
planar figure-8's IMU at 200 Hz (the body-frame readings do not change with
a stream's turned start, so the streams share them), frame ``i`` is at
``t = 0.1 i`` and each stream's known initial velocity is set after frame 0
(:func:`run_fleet_lio_replay`). ``default_trees=True`` gives either fleet
the parameter tree's default ``scan`` and ``submap`` (the polar grid, the
occupancy-grid submap, intensity correction), as
:func:`.odometry_replay.default_params` and
:func:`.lio_replay.lio_params` give them to one stream;
:func:`fleet_intensities` gives the scans raw return intensities.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.apps.odometry_replay import FRAME_DT, ate, pipelined_rows
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement, IMUPreintegrationParams
from sycl_points_tpu_torch.parallel.fleet import FleetLIO, FleetOdometry, stream_seeds
from sycl_points_tpu_torch.pipeline.pipelined_lio import PipelinedLidarInertialOdometry
from sycl_points_tpu_torch.pipeline.params import (
    DownsamplingParams,
    IMUParams,
    LidarInertialOdometryParams,
    LidarOdometryParams,
    PolarDownsamplingParams,
    PoseParams,
    RandomDownsamplingParams,
    ScanParams,
    SubmapParams,
    VoxelDownsamplingParams,
)
from sycl_points_tpu_torch.points.point_cloud import PointCloud, pad_capacity_for
from sycl_points_tpu_torch.utils import sync
from sycl_points_tpu_torch.utils.synthetic import World, figure8_imu, fleet_trajectories, return_intensities, scan_at

FLEET_STREAMS = 8
FLEET_FRAMES = 40
FLEET_WARMUP = 6
FLEET_RAYS = (1024, 32)
FLEET_SPEED = 0.35
FLEET_MAP_CAPACITY = 1 << 16
FLEET_KERNELS = ("nn1_batched", "knn_k_batched")
FLEET_IMU_HZ = 200.0


def fleet_params(map_capacity: int = FLEET_MAP_CAPACITY, map_voxel: float = 1.0,
                 default_trees: bool = False) -> LidarOdometryParams:
    """The fleet benchmark's parameter tree; every value not named here is
    the tree's default (all of them with ``default_trees``)."""
    if default_trees:
        return LidarOdometryParams()
    return LidarOdometryParams(
        scan=ScanParams(downsampling=DownsamplingParams(
            voxel=VoxelDownsamplingParams(enable=True, size=1.0),
            polar=PolarDownsamplingParams(enable=False),
            random=RandomDownsamplingParams(enable=True, num=5000),
        )),
        submap=SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=map_voxel, map_capacity=map_capacity,
                            point_random_sampling_num=512),
    )


def fleet_lio_params(default_trees: bool = False) -> LidarInertialOdometryParams:
    """The fleet benchmark's ``--lio`` tree: :func:`fleet_params`' scan and
    submap trees (the tree's defaults with ``default_trees``) and the IMU
    with the benchmark's noise densities and bias random walks."""
    lo = fleet_params(default_trees=default_trees)
    return LidarInertialOdometryParams(
        scan=lo.scan, submap=lo.submap,
        imu=IMUParams(enable=True, preintegration=IMUPreintegrationParams(
            gyro_noise_density=1e-3, accel_noise_density=1e-2, gyro_bias_rw_density=1e-5,
            accel_bias_rw_density=1e-4)),
    )


def imu_readings(t_from: float, t_to: float, speed: float = FLEET_SPEED, hz: float = FLEET_IMU_HZ) -> list:
    """The planar figure-8's IMU readings from ``t_from`` to ``t_to``, both
    ends included, at ``hz``: a chunk of the benchmark's feed."""
    n = max(int(round((t_to - t_from) * hz)), 1)
    out = []
    for k in range(n + 1):
        t = t_from + (t_to - t_from) * k / n
        g, a = figure8_imu(t, speed=speed)
        out.append(IMUMeasurement(timestamp=t, gyro=g.astype(np.float32), accel=a.astype(np.float32)))
    return out


def feed_fleet_imu(fleet: FleetLIO, t_from: float, t_to: float, speed: float = FLEET_SPEED,
                   hz: float = FLEET_IMU_HZ) -> None:
    """Hand every stream of ``fleet`` the readings of :func:`imu_readings`
    (the streams share them), as the benchmark feeds them."""
    for m in imu_readings(t_from, t_to, speed, hz):
        for s in range(fleet.B):
            fleet.add_imu_measurement(s, m)


def initial_velocities(n_streams: int, speed: float = FLEET_SPEED) -> np.ndarray:
    """``[B, 3]``: each stream's true world velocity at ``t = 0``, the base
    figure-8's turned by the stream's start, as the benchmark seeds it."""
    s_dot = speed / (FRAME_DT * 18.0)
    v0 = np.array([18.0 * s_dot, 18.0 * s_dot, 0.0], np.float32)
    turns = fleet_trajectories(n_streams, 1, speed=speed)[1]
    return np.stack([np.ascontiguousarray(R[:3, :3]) @ v0 for R in turns]).astype(np.float32)


def _lio_clock(i: int) -> float:
    """The time of frame ``i`` in the fleet-LIO deployment, and where that
    frame's IMU chunk starts."""
    t = FRAME_DT * i
    return t, max(t - FRAME_DT, -0.5 * FRAME_DT)


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


def fleet_intensities(scans):
    """Raw return intensities of every scan (``[frame][stream]``), seeded as
    the scan's rays (:func:`..utils.synthetic.return_intensities`)."""
    return [[return_intensities(p, 1000 * s + i) for s, p in enumerate(frame)] for i, frame in enumerate(scans)]


def stack_frame(frame, capacity: int, device: torch.device, intensities=None) -> PointCloud:
    """One frame of every stream as a fleet's cloud ``[B, capacity]`` (with
    the streams' ``intensities`` when given), made on the host and uploaded
    in one copy a field."""
    pts = np.zeros((len(frame), capacity, 3), np.float32)
    mask = np.zeros((len(frame), capacity), bool)
    inten = None if intensities is None else np.zeros((len(frame), capacity), np.float32)
    for s, p in enumerate(frame):
        n = min(len(p), capacity)
        pts[s, :n] = p[:n]
        mask[s, :n] = True
        if inten is not None:
            inten[s, :n] = intensities[s][:n]
    return PointCloud(points=torch.from_numpy(pts).to(device), mask=torch.from_numpy(mask).to(device),
                      intensities=None if inten is None else torch.from_numpy(inten).to(device))


def run_fleet_replay(params: LidarOdometryParams, trajs, scans, device: torch.device | str = "cuda",
                     capacity: int | None = None, intensities=None, **fleet_kwargs) -> dict:
    """Drive ``FleetOdometry.process_batch`` over ``scans`` (frame ``i`` at
    ``t = 0.1 (i + 1)``; with :func:`fleet_intensities` when given), the
    upload of each frame untimed, the frames not drained between them, then
    flush. Returns the fleet, a row a frame (ms of the call on the host
    clock, host reads by ``file:line``, the batched kernels' launches), the
    flush's ms, each stream's resolved poses (its first pose first) and ATE,
    the histogram of results, the frames that are not a success and the
    count of frames with no result."""
    device = require_device(device)
    fleet = FleetOdometry(params, n_streams=len(trajs), initial_poses=np.stack([t[0] for t in trajs]),
                          device=device, **fleet_kwargs)
    return _drive_fleet(fleet, trajs, scans, [FRAME_DT * (i + 1) for i in range(len(scans))], device, capacity,
                        intensities)


def run_fleet_lio_replay(params: LidarInertialOdometryParams, trajs, scans, device: torch.device | str = "cuda",
                         capacity: int | None = None, intensities=None, speed: float = FLEET_SPEED,
                         **fleet_kwargs) -> dict:
    """Drive ``FleetLIO.process_batch`` over ``scans`` as the benchmark's
    ``--lio`` run does: frame ``i`` at ``t = 0.1 i``, the IMU fed up to it
    ahead of the call (:func:`feed_fleet_imu`, from ``max(t - 0.1, -0.05)``),
    each stream's known initial velocity (the figure-8's, turned by its
    start) set after frame 0. Returns what :func:`run_fleet_replay` returns,
    its ``fleet`` a ``FleetLIO`` (bias and velocity mirrors, align
    iterations a stream and a loop)."""
    device = require_device(device)
    B = len(trajs)
    fleet = FleetLIO(params, n_streams=B, initial_poses=np.stack([t[0] for t in trajs]), device=device,
                     **fleet_kwargs)
    v0s = initial_velocities(B, speed)

    def before(i, t):
        if i == 1:
            fleet.x = fleet.x._replace(velocity=torch.from_numpy(v0s).to(device))
            fleet.velocity_np = v0s.copy()
        feed_fleet_imu(fleet, _lio_clock(i)[1], t, speed)

    return _drive_fleet(fleet, trajs, scans, [_lio_clock(i)[0] for i in range(len(scans))], device, capacity,
                        intensities, before)


def run_stream_lio_replay(params: LidarInertialOdometryParams, trajs, scans, stream: int,
                          device: torch.device | str = "cuda", capacity: int | None = None, intensities=None,
                          speed: float = FLEET_SPEED, seed: int = 0) -> dict:
    """Stream ``stream`` of :func:`run_fleet_lio_replay` alone: its scans
    through a single-stream ``PipelinedLidarInertialOdometry`` on the fleet's
    clock, IMU feed and initial velocity, its generators seeded as
    ``stream_seeds(seed, stream, inertial=True)``; the frames are timed as
    :func:`.odometry_replay.pipelined_rows` times them. Returns the
    odometry, its rows, the flush's ms, the resolved poses (its first pose
    first), the results and the ATE."""
    device = require_device(device)
    T0 = np.asarray(trajs[stream][0], np.float32)
    odo = PipelinedLidarInertialOdometry(
        dataclasses.replace(params, pose=PoseParams(initial=tuple(T0.ravel().tolist()))), device=device)
    for gen, s in zip((odo.pc_processor._generator, odo.submap._generator, odo._generator),
                      stream_seeds(seed, stream, inertial=True)):
        gen.manual_seed(s)
    cap = capacity or pad_capacity_for(max(len(frame[stream]) for frame in scans))
    clouds = [PointCloud.from_numpy(frame[stream], capacity=cap, device=device,
                                    intensities=None if intensities is None else intensities[i][stream])
              for i, frame in enumerate(scans)]
    v0 = initial_velocities(len(trajs), speed)[stream]

    def before(i):
        t, t_from = _lio_clock(i)
        if i == 1:
            odo.x = odo.x._replace(velocity=torch.from_numpy(v0).to(device))
            odo.velocity_np = v0.copy()
        for m in imu_readings(t_from, t, speed):
            odo.add_imu_measurement(m)

    rows, flush_ms = pipelined_rows(odo, clouds, [_lio_clock(i)[0] for i in range(len(scans))], device, before)
    est = [T0] + [T for _, _, T, _ in odo.pose_log]
    return {"odometry": odo, "rows": rows, "flush_ms": flush_ms, "poses": est,
            "results": [r.value for _, r in odo.deferred_results], "ate_m": ate(est, trajs[stream][: len(est)]),
            "frame_ms": [r["ms"] for r in rows]}


def _drive_fleet(fleet, trajs, scans, times, device, capacity, intensities, before=None) -> dict:
    B = len(trajs)
    cap = capacity or pad_capacity_for(max(len(p) for frame in scans for p in frame))
    rows = []
    for i, frame in enumerate(scans):
        cloud = stack_frame(frame, cap, device, None if intensities is None else intensities[i])
        if before is not None:
            before(i, times[i])
        reads, launches = Counter(sync.by_source), dict(cuda_knn.launch_counts)
        t0 = time.perf_counter()
        fleet.process_batch(cloud, times[i])
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
