"""Replay of synthetic scans through the LiDAR odometry.

The JAX package's documented LiDAR-odometry deployment is its replay
benchmark (``benchmarks/bench_odometry_replay.py`` with its defaults);
:func:`replay_params` holds the same values: box 2-50 m, 1 m voxels, random
sampling to 5,000 points in a capacity of 8,192, robust k=10 covariances,
angle-of-incidence filter 0-80 deg; GICP with Gauss-Newton, at most 20
iterations on 1,000 sampled points; a voxel-hash submap of 2^17 slots at 1 m,
a 2^14-row target within 30 m, 512 points a keyframe. The scans are synthetic
HDL-64 sweeps (:mod:`..utils.synthetic`) along a figure-8 at 10 Hz.

    from sycl_points_tpu_torch.apps.odometry_replay import make_scans, replay_params, run_replay
    poses, scans = make_scans(20)                      # 2048 x 64 rays a scan, on the card
    out = run_replay(replay_params(poses[0]), poses, scans)
    print(out["ate_m"], out["frame_ms"])

:func:`fullcloud_c2f_params` is the JAX package's full-cloud coarse-to-fine
deployment (its replay benchmark run with ``--scan-points 30000
--reg-sampling 0 --coarse-to-fine 20``): the whole preprocessed scan
registers, the first 20 iterations of each align against every 4th target
row.

:func:`default_params` is the parameter tree's defaults (polar
downsampling, the occupancy-grid submap, intensity correction) with only
the initial pose set; ``make_scans(..., intensities=True)`` gives the scans
the intensities that the correction works on.

:func:`run_pipelined_replay` drives ``PipelinedLidarOdometry`` over the same
scans, without draining the device between frames.

With ``run_replay(..., imu=...)`` the odometry also gets an IMU stream (for
parameters with ``imu.enable``); :func:`..apps.lio_replay.make_lio_inputs`
makes one that flies the same figure-8. Both replays feed it through
:func:`feed_imu` and time a frame with :func:`timed_process`.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Optional

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.pipeline.lidar_odometry import LidarOdometry, ResultType
from sycl_points_tpu_torch.pipeline.params import (
    DownsamplingParams,
    LidarOdometryParams,
    PolarDownsamplingParams,
    PoseParams,
    RandomDownsamplingParams,
    RegistrationBlockParams,
    ScanParams,
    SubmapParams,
    VoxelDownsamplingParams,
)
from sycl_points_tpu_torch.pipeline.pipelined_odometry import PipelinedLidarOdometry
from sycl_points_tpu_torch.points.point_cloud import PointCloud, pad_capacity_for
from sycl_points_tpu_torch.registration.pipeline import RandomSamplingParams
from sycl_points_tpu_torch.registration.registration import RegistrationParams
from sycl_points_tpu_torch.utils import sync
from sycl_points_tpu_torch.utils.synthetic import World, figure8_trajectory, return_intensities, scan_at

FRAME_DT = 0.1  # a 10 Hz sensor
IMU_HZ = 400
FRAME_SPAN = "replay.frame"  # the profiler span around each timed frame
FRAME_KERNELS = ("nn1", "knn_k", "range_image", "grid_knn")  # the kernels a frame may launch


def replay_params(initial_pose: np.ndarray, map_capacity: int = 1 << 17,
                  extract_capacity: int = 1 << 14) -> LidarOdometryParams:
    """The replay deployment, starting at ``initial_pose``; every value not
    named here is the parameter tree's default."""
    return LidarOdometryParams(
        scan=ScanParams(downsampling=DownsamplingParams(
            voxel=VoxelDownsamplingParams(enable=True, size=1.0),
            polar=PolarDownsamplingParams(enable=False),
            random=RandomDownsamplingParams(enable=True, num=5000),
        )),
        submap=SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0, map_capacity=map_capacity,
                            extract_capacity=extract_capacity, point_random_sampling_num=512),
        scan_capacity=1 << 13,
        pose=PoseParams(initial=tuple(np.asarray(initial_pose, np.float32).ravel().tolist())),
    )


FULLCLOUD_POINTS = 30000
FULLCLOUD_COARSE_ITERS = 20


def fullcloud_c2f_params(initial_pose: np.ndarray) -> LidarOdometryParams:
    """The full-cloud coarse-to-fine deployment, starting at
    ``initial_pose``: 1 m voxels, polar off, random sampling to 30,000 points
    in a capacity of ``max(8192, pad_capacity_for(30000))``, registration
    sampling off (the whole preprocessed cloud registers), the first 20
    iterations of each align on every 4th target row; a voxel-hash map of
    2^17 slots at 1 m, 512 points a keyframe.

    One number differs from the JAX benchmark's: it left ``max_iterations``
    at its default 20, equal to the coarse iterations, so every iteration of
    every frame searched the strided target there and no align converged.
    Here the full target gets the default 20 iterations after the coarse
    ones, so each pose is refined on it, as ``RegistrationParams`` has it."""
    factor = RegistrationParams(coarse_to_fine_iters=FULLCLOUD_COARSE_ITERS, coarse_stride=4,
                                max_iterations=FULLCLOUD_COARSE_ITERS + RegistrationParams().max_iterations)
    return LidarOdometryParams(
        scan=ScanParams(downsampling=DownsamplingParams(
            voxel=VoxelDownsamplingParams(enable=True, size=1.0),
            polar=PolarDownsamplingParams(enable=False),
            random=RandomDownsamplingParams(enable=True, num=FULLCLOUD_POINTS),
        )),
        submap=SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0, map_capacity=1 << 17,
                            point_random_sampling_num=512),
        registration=RegistrationBlockParams(factor=factor),
        registration_sampling=RandomSamplingParams(enable=False),
        scan_capacity=max(1 << 13, pad_capacity_for(FULLCLOUD_POINTS)),
        pose=PoseParams(initial=tuple(np.asarray(initial_pose, np.float32).ravel().tolist())),
    )


def default_params(initial_pose: np.ndarray) -> LidarOdometryParams:
    """The parameter tree's defaults, starting at ``initial_pose``: polar
    downsampling, the occupancy-grid submap (an insert every frame that
    passes the inlier gate), intensity correction."""
    return LidarOdometryParams(pose=PoseParams(initial=tuple(np.asarray(initial_pose, np.float32).ravel().tolist())))


def make_scans(n_frames: int, n_az: int = 2048, n_rings: int = 64, speed: float = 0.35,
               device: torch.device | str = "cuda", intensities: bool = False):
    """Ground-truth poses of a figure-8 and the scans seen from them, as
    clouds of capacity ``n_az * n_rings`` on ``device`` (the card unless the
    caller asks for the CPU); ``intensities`` gives each scan raw return
    intensities (:func:`..utils.synthetic.return_intensities`, seeded by the
    frame's index)."""
    device = require_device(device)
    world = World()
    poses = figure8_trajectory(n_frames, speed=speed)
    scans = []
    for i, T in enumerate(poses):
        pts = scan_at(world, T, n_az=n_az, n_rings=n_rings, device=device)
        scans.append(PointCloud.from_numpy(pts, intensities=return_intensities(pts, i) if intensities else None,
                                           capacity=n_az * n_rings, device=device))
    return poses, scans


def ate(estimated, truth) -> float:
    """Absolute trajectory error: the RMSE of the translation error, the
    first pose given (the odometry starts at the first true pose)."""
    err = [np.linalg.norm(np.asarray(e)[:3, 3] - np.asarray(t)[:3, 3]) for e, t in zip(estimated, truth, strict=True)]
    return float(np.sqrt(np.mean(np.square(err))))


def feed_imu(add: Callable, imu: Callable, fed_to: Optional[float], s_to: float,
             clock_offset: float = 0.0) -> Optional[float]:
    """Hand ``add`` the IMU measurements of ``imu`` (``s -> (gyro, accel)`` on
    the trajectory's clock, frame ``i`` at ``s = 0.1 i``) at ``IMU_HZ`` from
    ``fed_to`` (half a frame before the first frame when None) up to ``s_to``,
    both ends included, as the JAX package's LIO replay benchmark feeds them;
    each measurement is stamped ``s + clock_offset``. Returns the new
    ``fed_to``."""
    start = -FRAME_DT * 0.5 if fed_to is None else fed_to
    if s_to <= start:
        return fed_to
    n = max(int(round((s_to - start) * IMU_HZ)), 1)
    for k in range(n + 1):
        s = start + (s_to - start) * k / n
        g, a = imu(s)
        add(IMUMeasurement(timestamp=s + clock_offset, gyro=g, accel=a))
    return s_to


def timed_process(odo, scan: PointCloud, t: float, device: torch.device, synchronize: bool = True):
    """``odo.process(scan, t)`` timed on the host clock, inside the profiler
    span ``FRAME_SPAN``; with ``synchronize`` the device is drained before
    and after, so the time is the frame's whole device work (a pipelined
    frame is timed without: its work may run on under the next frame).
    Returns the result, its ms and the ``nn1`` / ``knn_k`` / ``range_image``
    launches it made."""
    sync_dev = synchronize and device.type == "cuda"
    before = dict(cuda_knn.launch_counts)
    if sync_dev:
        torch.cuda.synchronize(device)
    with torch.profiler.record_function(FRAME_SPAN):  # what scripts/profile_lio.py reads
        t0 = time.perf_counter()
        result = odo.process(scan, t)
        if sync_dev:
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
    return result, ms, {k: cuda_knn.launch_counts[k] - before[k] for k in FRAME_KERNELS}


def pipelined_rows(odo, scans, times, device: torch.device, before: Optional[Callable] = None) -> tuple[list, float]:
    """Drive a pipelined odometry over ``scans`` at ``times`` without draining
    the device between frames, then :meth:`flush` it; ``before(i)``, when
    given, runs ahead of frame ``i``, outside its time. Returns a row a frame
    (ms from the call to its return, launches, host reads by the
    ``file:line`` that made them, blocking fetches, frames in flight after
    the call) and the ms of the flush."""
    rows = []
    for i, (scan, t) in enumerate(zip(scans, times, strict=True)):
        if before is not None:
            before(i)
        reads, blocking = Counter(sync.by_source), sync.counts["blocking_fetches"]
        result, ms, launches = timed_process(odo, scan, t, device, synchronize=False)
        rows.append({
            "frame": i, "result": result.value, "ms": ms, "launches": launches,
            "reads": dict(Counter(sync.by_source) - reads),
            "blocking": sync.counts["blocking_fetches"] - blocking,
            "in_flight": len(odo._pending),
        })
    t0 = time.perf_counter()
    odo.flush()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return rows, (time.perf_counter() - t0) * 1e3


def run_pipelined_replay(params: LidarOdometryParams, poses, scans, device: torch.device | str = "cuda",
                         max_in_flight: int = 16) -> dict:
    """:func:`run_replay` through ``PipelinedLidarOdometry``: frame ``i`` at
    ``t = 0.1 (i + 1)``, the frames not drained between them, the window
    flushed at the end. Returns the odometry, per-frame rows
    (:func:`pipelined_rows`), the flush's ms, the resolved poses (the first
    frame's pose first), the deferred results and the ATE."""
    device = require_device(device)
    lo = PipelinedLidarOdometry(params, max_in_flight=max_in_flight, device=device)
    rows, flush_ms = pipelined_rows(lo, scans, [FRAME_DT * (i + 1) for i in range(len(scans))], device)
    estimated = [params.pose.initial_matrix()] + [T for _, _, T, _ in lo.pose_log]
    return {"odometry": lo, "rows": rows, "flush_ms": flush_ms, "poses": estimated,
            "results": [r.value for _, r in lo.deferred_results], "ate_m": ate(estimated, poses),
            "frame_ms": [r["ms"] for r in rows]}


def run_replay(params: LidarOdometryParams, poses, scans, device: torch.device | str = "cuda",
               sync_stage_times: bool = False, imu: Optional[Callable] = None, seed: Optional[int] = None) -> dict:
    """Drive ``LidarOdometry.process`` over ``scans`` at 10 Hz, frame ``i`` at
    ``t = 0.1 (i + 1)``. ``imu`` (as :func:`feed_imu` takes it), when given,
    is fed up to each frame's time. ``seed``, when given, reseeds the scan's
    and the submap's samplers (another sampling stream than the package's
    fixed seeds). Each frame is timed by :func:`timed_process`. Returns the odometry object, per-frame rows
    (result, ms, iterations, inliers, keyframe flag, map load, target size,
    slots used, occupied voxels, kernel launches, host syncs and their
    sources, stage times),
    the estimated poses and the ATE."""
    device = require_device(device)
    lo = LidarOdometry(params, device=device)
    lo.sync_stage_times = sync_stage_times
    if seed is not None:
        for k, gen in enumerate((lo.pc_processor._generator, lo.submap._generator)):
            gen.manual_seed(seed + k)
    rows, estimated, fed_to = [], [], None
    for i, scan in enumerate(scans):
        if imu is not None:
            fed_to = feed_imu(lo.add_imu_measurement, imu, fed_to, FRAME_DT * i, clock_offset=FRAME_DT)
        reads = Counter(sync.by_source)
        result, ms, launches = timed_process(lo, scan, FRAME_DT * (i + 1), device)
        reg = lo.reg_result
        rows.append({
            "frame": i, "result": result.value, "ms": ms,
            "iterations": int(reg.iterations) if reg is not None and result is ResultType.success else 0,
            "inliers": int(reg.inlier) if reg is not None and result is ResultType.success else 0,
            "keyframe": bool(lo.is_keyframe_last_frame),
            "load": float(lo.submap.map_state.used.sum()) / lo.submap.map_capacity,
            "voxels": int(lo.submap.map_state.used.sum()),
            "occupied": lo.submap.occupied_voxels(),
            "map_capacity": lo.submap.map_capacity,
            "target": int(lo.submap.submap_cloud.count()) if lo.submap.submap_cloud is not None else 0,
            "launches": launches,
            "syncs": lo.sync_count_last_frame,
            "reads": dict(Counter(sync.by_source) - reads),
            "stages_ms": {k: v * 1e3 for k, v in lo.get_processing_times().items()},
        })
        estimated.append(lo.get_odometry())
    return {"odometry": lo, "rows": rows, "poses": estimated, "ate_m": ate(estimated, poses),
            "frame_ms": [r["ms"] for r in rows]}
