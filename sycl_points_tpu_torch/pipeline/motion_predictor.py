"""Motion prediction: the initial guess of a frame's registration.

Counterpart of :mod:`sycl_points_tpu.pipeline.motion_predictor` (an own copy:
host-side numpy on 4x4 matrices, held to the original in
``tests/test_torch_lo_ops.py``). Constant-velocity prediction with
EMA-smoothed velocities and degeneracy-adaptive damping (the smallest
eigenvalue per inlier of the previous raw Hessian's blocks scales how much of
the predicted rotation and translation is applied), and the mode selection
LIDAR_CV / GYRO_LIDAR_CV (a gyro delta rotation replaces the predicted
rotation) / IMU_SE3 (a full preintegrated pose).
"""


from __future__ import annotations

from typing import Optional

import numpy as np

from sycl_points_tpu_torch.pipeline.params import MotionPredictionParams
from sycl_points_tpu_torch.utils import lie_np


def _axis_factor(H_block: np.ndarray, inlier: int, axis) -> float:
    """Degeneracy-adaptive application factor: how much of the predicted
    motion to apply, from the smallest eigenvalue per inlier of ``H_block``."""
    if inlier <= 0:
        return axis.factor_max
    w = np.linalg.eigvalsh(0.5 * (H_block + H_block.T))
    min_eig_ratio = float(w.min()) / inlier
    lo, hi = axis.min_eigenvalue_low, axis.min_eigenvalue_high
    score = float(np.clip((min_eig_ratio - lo) / max(hi - lo, 1e-6), 0.0, 1.0))
    return axis.factor_max * (1.0 - score) + axis.factor_min * score


class AdaptiveMotionPredictor:
    def __init__(self, params: MotionPredictionParams):
        self.params = params
        self._lin_smooth: Optional[np.ndarray] = None
        self._ang_smooth: Optional[np.ndarray] = None

    def predict(
        self,
        linear_velocity: np.ndarray,
        angular_velocity: np.ndarray,  # rotation vector * rate [rad/s]
        odom: np.ndarray,
        dt: float,
        H_raw: Optional[np.ndarray],
        inlier: int,
        registrated: bool,
    ) -> np.ndarray:
        p = self.params
        rot_factor = p.rotation.factor_max
        trans_factor = p.translation.factor_max
        if registrated and H_raw is not None and inlier > 0:
            rot_factor = _axis_factor(H_raw[:3, :3], inlier, p.rotation)
            trans_factor = _axis_factor(H_raw[3:, 3:], inlier, p.translation)

        a = p.velocity_ema_alpha
        lv = np.asarray(linear_velocity, np.float32)
        av = np.asarray(angular_velocity, np.float32)
        self._lin_smooth = lv if self._lin_smooth is None else a * lv + (1 - a) * self._lin_smooth
        self._ang_smooth = av if self._ang_smooth is None else a * av + (1 - a) * self._ang_smooth

        delta_trans = self._lin_smooth * dt * trans_factor
        delta_rot = self._ang_smooth * dt * rot_factor

        odom = np.asarray(odom, np.float32)
        R_delta = lie_np.so3_exp_matrix(delta_rot).astype(np.float32)
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = odom[:3, :3] @ R_delta
        out[:3, 3] = odom[:3, 3] + odom[:3, :3] @ delta_trans
        return out


class MotionPredictor:
    """Mode-selecting wrapper. Without an IMU the gyro rotation and the
    preintegrated pose are ``None`` and every mode is the adaptive
    constant-velocity predictor."""

    def __init__(self, params: MotionPredictionParams):
        self.params = params
        self._cv = AdaptiveMotionPredictor(params)

    def predict(
        self,
        linear_velocity,
        angular_velocity,
        odom,
        dt,
        H_raw,
        inlier,
        registrated,
        gyro_delta_rotation_lidar: Optional[np.ndarray] = None,
        imu_se3_pose: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        mode = self.params.mode.upper()
        if mode == "IMU_SE3" and imu_se3_pose is not None:
            return np.asarray(imu_se3_pose, np.float32)
        pred = self._cv.predict(
            linear_velocity, angular_velocity, odom, dt, H_raw, inlier, registrated
        )
        if mode == "GYRO_LIDAR_CV" and gyro_delta_rotation_lidar is not None:
            odom = np.asarray(odom, np.float32)
            rel = np.linalg.inv(odom) @ pred
            rel[:3, :3] = gyro_delta_rotation_lidar
            pred = (odom @ rel).astype(np.float32)
        return pred
