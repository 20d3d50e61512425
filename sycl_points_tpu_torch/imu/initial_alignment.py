"""Stationary-IMU gravity alignment (roll/pitch + gyro bias bootstrap).

This package's own copy of :mod:`sycl_points_tpu.imu.initial_alignment`
(numpy only; held to the original in ``tests/test_torch_imu.py``): mean
specific force over a stationary window gives
the body "up" direction; the minimum rotation mapping it onto -gravity
defines the gravity-aligned orientation (yaw unobservable, ~0 by
construction); the gyro mean becomes the gyro bias.  Stillness is checked
via per-axis std thresholds with a timeout that eventually forces alignment.

Host-side logic on the host IMU buffer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement


@dataclasses.dataclass(frozen=True)
class InitialAlignmentParams:
    enable: bool = False
    required_duration_sec: float = 1.0
    max_gyro_std: float = 0.05  # [rad/s]
    max_accel_std: float = 0.2  # [m/s^2]
    max_accel_norm_error: float = 0.5  # [m/s^2]
    estimate_gyro_bias: bool = True
    max_wait_sec: float = 5.0


@dataclasses.dataclass
class InitialAlignmentResult:
    success: bool = False
    R_world_imu: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3, dtype=np.float32))
    gyro_bias: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    accel_mean: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    gyro_std: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    accel_std: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    accel_norm: float = 0.0
    roll_rad: float = 0.0
    pitch_rad: float = 0.0
    error_message: str = ""


def _rotation_from_two_vectors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Minimum rotation R with R a = b for unit vectors (Eigen FromTwoVectors)."""
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s2 = float(np.dot(v, v))
    if s2 < 1e-12:
        if c > 0:
            return np.eye(3, dtype=np.float32)
        # antiparallel: rotate pi about any axis orthogonal to a
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.dot(axis, axis) < 1e-8:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis = axis / np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        return (np.eye(3) + 2.0 * K @ K).astype(np.float32)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return (np.eye(3) + K + K @ K * ((1.0 - c) / s2)).astype(np.float32)


def estimate_initial_alignment(
    imu_buffer: Sequence[IMUMeasurement],
    gravity_world: np.ndarray,
    params: InitialAlignmentParams,
    gyro_bias: np.ndarray,
    accel_bias: np.ndarray,
    bypass_stationarity: bool = False,
) -> InitialAlignmentResult:
    """imu_initial_alignment.hpp:85-205."""
    res = InitialAlignmentResult()
    g_norm = float(np.linalg.norm(gravity_world))
    if g_norm < 1e-3:
        res.error_message = "gravity vector is (near) zero"
        return res
    if len(imu_buffer) < 2:
        res.error_message = "IMU buffer has fewer than 2 samples"
        return res

    t_end = imu_buffer[-1].timestamp
    if (t_end - imu_buffer[0].timestamp) + 1e-6 < params.required_duration_sec:
        res.error_message = "IMU buffer spans less than required_duration_sec"
        return res

    t_start = t_end - params.required_duration_sec
    window = [m for m in imu_buffer if m.timestamp >= t_start]
    pre = [m for m in imu_buffer if m.timestamp < t_start]
    if not window:
        res.error_message = "no IMU samples in required window"
        return res
    if pre and window[0].timestamp > t_start + 1e-6:
        window.insert(0, pre[-1])

    gyro = np.stack([m.gyro for m in window]).astype(np.float64)
    accel = np.stack([m.accel for m in window]).astype(np.float64)
    gyro_mean = gyro.mean(axis=0)
    accel_mean = accel.mean(axis=0)
    res.gyro_std = gyro.std(axis=0).astype(np.float32)
    res.accel_std = accel.std(axis=0).astype(np.float32)
    res.accel_mean = accel_mean.astype(np.float32)
    res.accel_norm = float(np.linalg.norm(accel_mean))

    if not bypass_stationarity:
        if np.any(res.gyro_std > params.max_gyro_std):
            res.error_message = "gyro_std exceeds threshold (robot not stationary?)"
            return res
        if np.any(res.accel_std > params.max_accel_std):
            res.error_message = "accel_std exceeds threshold (robot not stationary?)"
            return res
        if abs(res.accel_norm - g_norm) > params.max_accel_norm_error:
            res.error_message = "|a_mean| - |gravity| exceeds threshold (unmodelled accel bias?)"
            return res

    a_unbiased = res.accel_mean - np.asarray(accel_bias, np.float32)
    a_norm = float(np.linalg.norm(a_unbiased))
    if a_norm < 1e-3:
        res.error_message = "bias-corrected accel magnitude is (near) zero"
        return res

    body_up = a_unbiased / a_norm
    world_up = -np.asarray(gravity_world) / g_norm
    res.R_world_imu = _rotation_from_two_vectors(body_up.astype(np.float64), world_up.astype(np.float64))
    res.roll_rad = math.atan2(res.R_world_imu[2, 1], res.R_world_imu[2, 2])
    res.pitch_rad = math.asin(-float(np.clip(res.R_world_imu[2, 0], -1.0, 1.0)))
    res.gyro_bias = (
        gyro_mean.astype(np.float32) if params.estimate_gyro_bias else np.asarray(gyro_bias, np.float32)
    )
    res.success = True
    return res


class InitialAlignmentEstimator:
    """Polling state machine with wait/timeout clock
    (imu_initial_alignment.hpp:236-344)."""

    def __init__(
        self,
        params: InitialAlignmentParams,
        gravity_world: np.ndarray,
        T_imu_to_lidar: np.ndarray,
    ):
        self.params = params
        self.gravity_world = np.asarray(gravity_world, np.float32)
        self.T_imu_to_lidar = np.asarray(T_imu_to_lidar, np.float32)
        self.done = False
        self._start_ts: Optional[float] = None

    def enabled(self) -> bool:
        return self.params.enable

    def is_done(self) -> bool:
        return self.done

    def try_align(self, scan_timestamp: float, imu_buffer, gyro_bias, accel_bias):
        """Returns (success, R_gravity_lidar, gyro_bias, diagnostics)."""
        if self.done:
            return True, np.eye(3, dtype=np.float32), np.asarray(gyro_bias, np.float32), None
        if self._start_ts is None:
            self._start_ts = scan_timestamp
        elapsed = scan_timestamp - self._start_ts
        timeout = self.params.max_wait_sec > 0.0 and elapsed >= self.params.max_wait_sec

        result = estimate_initial_alignment(
            imu_buffer, self.gravity_world, self.params, gyro_bias, accel_bias
        )
        if not result.success and timeout:
            result = estimate_initial_alignment(
                imu_buffer, self.gravity_world, self.params, gyro_bias, accel_bias,
                bypass_stationarity=True,
            )
        if not result.success:
            return False, None, None, result

        R_il = self.T_imu_to_lidar[:3, :3]
        R_gravity_lidar = result.R_world_imu @ R_il.T
        self.done = True
        return True, R_gravity_lidar.astype(np.float32), result.gyro_bias, result
