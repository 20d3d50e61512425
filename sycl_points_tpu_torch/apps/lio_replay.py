"""Replay of synthetic scans and IMU through the LiDAR-inertial odometry.

The JAX package's documented LiDAR-inertial deployment is its LIO replay
benchmark (``benchmarks/bench_lio_replay.py`` with its defaults);
:func:`lio_params` holds the same values: 1 m voxels, no polar stage, random
sampling to 5,000 points; a voxel-hash submap of 2^17 slots with a 2^14-row
target; GICP with Gauss-Newton over ``LIORegistrationParams()``; the IMU on,
with noise densities 1e-3 (gyro) and 1e-2 (accel) and bias random walks of
1e-5 and 1e-4. :func:`make_lio_inputs` makes the figure-8 at 10 Hz, HDL-64
sweeps (:mod:`..utils.synthetic`, optionally motion-distorted) and a 400 Hz
IMU that flies it, with an optional constant bias injected; the filter is
seeded with the true initial velocity.

    from sycl_points_tpu_torch.apps.lio_replay import lio_params, make_lio_inputs, run_lio_replay
    inputs = make_lio_inputs(20)                          # 2048 x 64 rays a scan, on the card
    out = run_lio_replay(lio_params(inputs.poses[0]), inputs)
    print(out["ate_m"], out["frame_ms"], out["gyro_bias_err"])

:func:`run_pipelined_lio_replay` drives ``PipelinedLidarInertialOdometry``
over the same inputs.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, List, NamedTuple

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.apps.odometry_replay import FRAME_DT, ate, feed_imu, pipelined_rows, timed_process
from sycl_points_tpu_torch.imu.preintegration import IMUPreintegrationParams
from sycl_points_tpu_torch.pipeline.lidar_inertial_odometry import LidarInertialOdometry
from sycl_points_tpu_torch.pipeline.pipelined_lio import PipelinedLidarInertialOdometry
from sycl_points_tpu_torch.pipeline.params import (
    DownsamplingParams,
    IMUDeskewParams,
    IMUParams,
    LidarInertialOdometryParams,
    PolarDownsamplingParams,
    PoseParams,
    RandomDownsamplingParams,
    ScanParams,
    SubmapParams,
    VoxelDownsamplingParams,
)
from sycl_points_tpu_torch.points.point_cloud import PointCloud, pad_capacity_for
from sycl_points_tpu_torch.utils import sync
from sycl_points_tpu_torch.utils.synthetic import (
    World,
    figure8_imu,
    figure8_imu_3d,
    figure8_trajectory,
    figure8_velocity,
    return_intensities,
    scan_at,
    scan_at_distorted,
)


def lio_params(initial_pose: np.ndarray, deskew: bool = False, gyro_bias_rw: float = 1e-5,
               accel_bias_rw: float = 1e-4, default_trees: bool = False) -> LidarInertialOdometryParams:
    """The replay deployment, starting at ``initial_pose``; ``deskew`` turns
    the IMU deskew on; ``default_trees`` takes the tree's default ``scan``
    and ``submap`` (polar downsampling, the occupancy-grid submap) in place
    of the replay's. Every value not named here is the tree's default."""
    scan = ScanParams() if default_trees else ScanParams(downsampling=DownsamplingParams(
        voxel=VoxelDownsamplingParams(enable=True, size=1.0),
        polar=PolarDownsamplingParams(enable=False),
        random=RandomDownsamplingParams(enable=True, num=5000),
    ))
    return LidarInertialOdometryParams(
        scan=scan,
        submap=SubmapParams() if default_trees else SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0),
        pose=PoseParams(initial=tuple(np.asarray(initial_pose, np.float32).ravel().tolist())),
        imu=IMUParams(enable=True, preintegration=IMUPreintegrationParams(
            gyro_noise_density=1e-3, accel_noise_density=1e-2,
            gyro_bias_rw_density=gyro_bias_rw, accel_bias_rw_density=accel_bias_rw,
        ), deskew=IMUDeskewParams(enable=deskew)),
    )


class LIOInputs(NamedTuple):
    poses: List[np.ndarray]  # true poses, float64 [4, 4]
    scans: List[PointCloud]  # with timestamp offsets when distorted
    imu: Callable  # t -> (gyro [3], accel [3]) as the sensor reads them
    v0: np.ndarray  # true world velocity at t = 0
    gyro_bias: np.ndarray  # the injected bias
    accel_bias: np.ndarray


def make_lio_inputs(n_frames: int, n_az: int = 2048, n_rings: int = 64, speed: float = 0.35,
                    excite3d: bool = False, distort: bool = False, gyro_bias=(0.0, 0.0, 0.0),
                    accel_bias=(0.0, 0.0, 0.0), device: torch.device | str = "cuda",
                    intensities: bool = False) -> LIOInputs:
    """The figure-8 (3-D excited when asked), a scan a frame raycast on
    ``device`` (the card unless the caller asks for the CPU), motion-distorted
    over the sweep to the next frame's pose when asked, with raw return
    intensities when asked, and the IMU that reads the true motion plus the
    injected constant biases."""
    device = require_device(device)
    world = World()
    poses = figure8_trajectory(n_frames, speed=speed, excite3d=excite3d)
    cap = pad_capacity_for(n_az * n_rings)
    scans = []
    for i, T in enumerate(poses):
        if distort:
            T_end = poses[i + 1] if i + 1 < len(poses) else poses[i] @ (np.linalg.inv(poses[i - 1]) @ poses[i])
            pts, t_ms = scan_at_distorted(world, T, T_end, n_az=n_az, n_rings=n_rings, seed=i, device=device)
        else:
            pts, t_ms = scan_at(world, T, n_az=n_az, n_rings=n_rings, seed=i, device=device), None
        scans.append(PointCloud.from_numpy(pts, timestamp_offsets=t_ms,
                                           intensities=return_intensities(pts, i) if intensities else None,
                                           capacity=cap, device=device))
    gb = np.asarray(gyro_bias, np.float64)
    ab = np.asarray(accel_bias, np.float64)

    def imu(t):
        g, a = figure8_imu_3d(t, speed=speed) if excite3d else figure8_imu(t, speed=speed)
        return (g + gb).astype(np.float32), (a + ab).astype(np.float32)

    v0 = figure8_velocity(0.0, speed=speed, excite3d=excite3d).astype(np.float32)
    return LIOInputs(poses, scans, imu, v0, gb, ab)


def run_lio_replay(params: LidarInertialOdometryParams, inputs: LIOInputs, device: torch.device | str = "cuda",
                   sync_stage_times: bool = False, seed: int | None = None) -> dict:
    """Drive ``LidarInertialOdometry.process`` over the scans at 10 Hz, frame
    ``i`` at ``t = 0.1 i``, the IMU fed up to the scan's start (up to its end
    when the deskew is on: the deskew integrates over the sweep), each frame
    timed by :func:`..apps.odometry_replay.timed_process`. ``seed``, when
    given, reseeds the scan, registration and submap samplers (another
    sampling stream than the package's fixed seeds). Returns the odometry
    object, per-frame rows (result, ms, iterations run, keyframe flag, kernel
    launches, host syncs and their sources, stage times, bias estimates), the
    estimated poses,
    the ATE and the final bias errors."""
    device = require_device(device)
    odo = LidarInertialOdometry(params, device=device)
    odo.sync_stage_times = sync_stage_times
    if seed is not None:
        for k, gen in enumerate((odo.pc_processor._generator, odo._generator, odo.submap._generator)):
            gen.manual_seed(seed + k)
    _seed_velocity(odo, inputs.v0, device)
    ahead = FRAME_DT if params.imu.deskew.enable else 0.0
    rows, estimated, fed_to = [], [], None
    for i, scan in enumerate(inputs.scans):
        ts = FRAME_DT * i
        fed_to = feed_imu(odo.add_imu_measurement, inputs.imu, fed_to, ts + ahead)
        reads = Counter(sync.by_source)
        result, ms, launches = timed_process(odo, scan, ts, device)
        rows.append({
            "frame": i, "result": result.value, "ms": ms, "iterations": odo.iterations_last_frame,
            "keyframe": bool(odo.is_keyframe_last_frame), "launches": launches,
            "syncs": odo.sync_count_last_frame, "reads": dict(Counter(sync.by_source) - reads),
            "stages_ms": {k: v * 1e3 for k, v in odo.get_processing_times().items()},
            "gyro_bias": odo.gyro_bias_np.tolist(), "accel_bias": odo.accel_bias_np.tolist(),
        })
        estimated.append(odo.get_odometry())
    return {
        "odometry": odo, "rows": rows, "poses": estimated, "ate_m": ate(estimated, inputs.poses),
        "frame_ms": [r["ms"] for r in rows],
        "gyro_bias_err": float(np.linalg.norm(odo.gyro_bias_np - inputs.gyro_bias)),
        "accel_bias_err": float(np.linalg.norm(odo.accel_bias_np - inputs.accel_bias)),
        "map_voxels": int(odo.submap.map_state.used.sum()),
    }


def _seed_velocity(odo, v0: np.ndarray, device: torch.device) -> None:
    """The filter's initial velocity: the true one at t = 0."""
    odo.x = odo.x._replace(velocity=torch.as_tensor(v0, dtype=torch.float32, device=device))
    odo.velocity_np = v0.copy()
    odo.imu_v_world_at_reset = v0.copy()


def run_pipelined_lio_replay(params: LidarInertialOdometryParams, inputs: LIOInputs,
                             device: torch.device | str = "cuda", max_in_flight: int = 16) -> dict:
    """:func:`run_lio_replay` through ``PipelinedLidarInertialOdometry``: the
    IMU fed up to each scan's start ahead of the frame, the frames not drained
    between them, the window flushed at the end. Returns the odometry, the
    per-frame rows (:func:`..apps.odometry_replay.pipelined_rows`), the
    flush's ms, the resolved poses (the first frame's pose first), the
    deferred results, the ATE and the final bias errors."""
    device = require_device(device)
    odo = PipelinedLidarInertialOdometry(params, max_in_flight=max_in_flight, device=device)
    _seed_velocity(odo, inputs.v0, device)
    times = [FRAME_DT * i for i in range(len(inputs.scans))]
    fed_to = None

    def feed(i):
        nonlocal fed_to
        fed_to = feed_imu(odo.add_imu_measurement, inputs.imu, fed_to, times[i])

    rows, flush_ms = pipelined_rows(odo, inputs.scans, times, device, before=feed)
    estimated = [params.pose.initial_matrix()] + [T for _, _, T, _ in odo.pose_log]
    return {"odometry": odo, "rows": rows, "flush_ms": flush_ms, "poses": estimated,
            "results": [r.value for _, r in odo.deferred_results], "ate_m": ate(estimated, inputs.poses),
            "frame_ms": [r["ms"] for r in rows],
            "gyro_bias_err": float(np.linalg.norm(odo.gyro_bias_np - inputs.gyro_bias)),
            "accel_bias_err": float(np.linalg.norm(odo.accel_bias_np - inputs.accel_bias))}
