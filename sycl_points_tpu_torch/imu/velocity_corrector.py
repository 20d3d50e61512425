"""ICP-corrected end-of-window velocity for IMU window resets.

This package's own copy of :mod:`sycl_points_tpu.imu.velocity_corrector`
(held to the original in ``tests/test_torch_imu.py``): back-solve the
window-start velocity from the ICP displacement and propagate it to the
window end through the preintegrated IMU dynamics (snapshot / return):

  v_start = (disp_icp - 0.5 g dt^2 - R dP) / dt
  v_end   = v_start + g dt + R dV

The snapshot of the device-side preintegration is one counted host read.
"""

from __future__ import annotations

import numpy as np
import torch

from sycl_points_tpu_torch.utils.sync import to_host


class IMUVelocityCorrector:
    def __init__(self):
        self._snap_dv = np.zeros(3, np.float32)
        self._snap_dp = np.zeros(3, np.float32)
        self._snap_dt = 0.0
        self._snap_valid = False
        self._corrected_v = np.zeros(3, np.float32)
        self._corrected_valid = False

    def get_reset_velocity(self, preintegration, gyro_bias, accel_bias, fallback_v_world):
        """Velocity for the next window reset; snapshots the current
        preintegration state."""
        v_reset = self._corrected_v if self._corrected_valid else np.asarray(fallback_v_world, np.float32)
        self._corrected_valid = False
        snap = preintegration.get_corrected(gyro_bias, accel_bias)
        host = np.asarray(to_host(torch.cat([snap.Delta_v, snap.Delta_p, snap.dt_total[None]])), np.float32)
        self._snap_dv = host[0:3]
        self._snap_dp = host[3:6]
        self._snap_dt = float(host[6])
        self._snap_valid = True
        return v_reset

    def update(self, disp_icp, R_world_imu, gravity):
        """Store the ICP-corrected end-of-window velocity."""
        if not self._snap_valid or self._snap_dt <= 0.0:
            return
        dt = self._snap_dt
        g = np.asarray(gravity, np.float32)
        R = np.asarray(R_world_imu, np.float32)
        v_start = (np.asarray(disp_icp, np.float32) - 0.5 * g * dt * dt - R @ self._snap_dp) / dt
        self._corrected_v = v_start + g * dt + R @ self._snap_dv
        self._corrected_valid = True
        self._snap_valid = False
