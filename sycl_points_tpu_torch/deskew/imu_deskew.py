"""IMU-based motion-distortion compensation (SE(3) deskew).

Counterpart of :mod:`sycl_points_tpu.deskew.imu_deskew`: the buffered IMU
window is integrated into a relative-pose trajectory (gravity- and
initial-velocity-compensated as ``predict_relative_transform``), moved into
the LiDAR frame by the extrinsic, and every point is corrected by the
slerp / lerp-interpolated pose at its timestamp.

  * host: buffer filtering, coverage checks, the scan-start boundary sample,
    and one upload of the whole window with its initial conditions;
  * device: the parallel-prefix trajectory integration
    (:mod:`..imu.preintegration`) and one batched searchsorted / slerp /
    apply pass over the cloud.
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence

import numpy as np
import torch

from sycl_points_tpu_torch.imu import preintegration as pre
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils import lie
from sycl_points_tpu_torch.utils.smallmat import matvec3, rotate_mat3
from sycl_points_tpu_torch.utils.sync import to_device

_F32 = torch.float32


class IMUDeskewStatus(enum.Enum):
    success = "success"
    insufficient_imu_coverage = "insufficient_imu_coverage"
    no_timestamps = "no_timestamps"
    invalid_scan_duration = "invalid_scan_duration"
    empty_cloud = "empty_cloud"


_MARGIN_SEC = 0.05  # 50 ms window margin


def _quat_slerp(q0: torch.Tensor, q1: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Batched slerp through so3 log / exp."""
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    omega = lie.so3_log(lie.quat_mul(lie.quat_conj(q0), q1))
    return lie.quat_mul(q0, lie.so3_exp(omega * alpha[..., None]))


def apply_trajectory(cloud: PointCloud, traj_q: torch.Tensor, traj_t: torch.Tensor,
                     traj_ts: torch.Tensor) -> PointCloud:
    """Per-point pose interpolation and SE(3) correction. ``traj_q [K, 4]``
    (xyzw), ``traj_t [K, 3]``, ``traj_ts [K]`` seconds from scan start
    (ascending, ``ts[0] = 0``). Points with non-finite timestamps pass
    through unchanged."""
    t_sec = cloud.timestamp_offsets * 1e-3
    finite = torch.isfinite(t_sec)
    t_q = torch.where(finite, t_sec, 0.0)

    K = traj_ts.shape[0]
    hi = torch.clamp(torch.searchsorted(traj_ts.contiguous(), t_q.contiguous(), right=True), 1, K - 1)
    lo = hi - 1
    t_lo, t_hi = traj_ts[lo], traj_ts[hi]
    alpha = torch.clamp((t_q - t_lo) / torch.clamp_min(t_hi - t_lo, 1e-12), 0.0, 1.0)

    q = _quat_slerp(traj_q[lo], traj_q[hi], alpha)
    t = traj_t[lo] + alpha[:, None] * (traj_t[hi] - traj_t[lo])
    R = lie.quat_to_matrix(q)

    new_pts = torch.where(finite[:, None], matvec3(R, cloud.points) + t, cloud.points)
    new_normals = None
    if cloud.normals is not None:
        new_normals = torch.where(finite[:, None], matvec3(R, cloud.normals), cloud.normals)
    new_covs = None
    if cloud.covs is not None:
        new_covs = torch.where(finite[:, None, None], rotate_mat3(R, cloud.covs), cloud.covs)
    return cloud.replace(points=new_pts, normals=new_normals, covs=new_covs)


def deskew_point_cloud_imu(
    cloud: PointCloud,
    imu_buffer: Sequence[pre.IMUMeasurement],
    scan_start_time_sec: float,
    scan_duration_sec: float,
    T_imu_to_lidar: np.ndarray,
    gyro_bias: np.ndarray,
    accel_bias: np.ndarray,
    preintegration_params: pre.IMUPreintegrationParams = pre.IMUPreintegrationParams(),
    R_world_body_i: Optional[np.ndarray] = None,
    v_world_body_i: Optional[np.ndarray] = None,
    gyro_only: bool = False,
):
    """Full IMU deskew on the cloud's device. Returns ``(cloud, status)``;
    the cloud is unchanged unless the status is ``success``."""
    if cloud.timestamp_offsets is None:
        return cloud, IMUDeskewStatus.no_timestamps
    if scan_duration_sec <= 0.0:
        return cloud, IMUDeskewStatus.invalid_scan_duration
    scan_end = scan_start_time_sec + scan_duration_sec

    filtered = [m for m in imu_buffer
                if scan_start_time_sec - _MARGIN_SEC <= m.timestamp <= scan_end + _MARGIN_SEC]
    if len(filtered) < 2:
        return cloud, IMUDeskewStatus.insufficient_imu_coverage
    if (filtered[0].timestamp > scan_start_time_sec + _MARGIN_SEC
            or filtered[-1].timestamp < scan_end - _MARGIN_SEC):
        return cloud, IMUDeskewStatus.insufficient_imu_coverage

    # a virtual boundary sample at exactly scan start
    ts = np.array([m.timestamp for m in filtered])
    nxt = int(np.searchsorted(ts, scan_start_time_sec, side="left"))
    if nxt == 0:
        m_start = pre.IMUMeasurement(scan_start_time_sec, filtered[0].gyro, filtered[0].accel)
    elif nxt >= len(filtered):
        m_start = pre.IMUMeasurement(scan_start_time_sec, filtered[-1].gyro, filtered[-1].accel)
        nxt = len(filtered)
    else:
        m_start = pre.interpolate_measurement(filtered[nxt - 1], filtered[nxt], scan_start_time_sec)

    window = [m_start] + [m for m in filtered[nxt:] if m.timestamp <= scan_end + _MARGIN_SEC]
    if len(window) < 2:
        return cloud, IMUDeskewStatus.insufficient_imu_coverage
    t_rel = np.array([m.timestamp - scan_start_time_sec for m in window[1:]], np.float32)
    if t_rel[-1] < scan_duration_sec - _MARGIN_SEC:
        return cloud, IMUDeskewStatus.insufficient_imu_coverage

    # Padded steps carry dt = 0 / valid = False, so the integrator holds its
    # state and the trajectory's tail repeats the final pose; t_rel pads with
    # its last value, which searchsorted resolves to that same pose.
    steps = pre.pack_steps(*pre.padded_steps_from_window(window))
    t_rel_p = np.concatenate([t_rel, np.full(steps.shape[0] - len(t_rel), t_rel[-1], np.float32)])
    R0 = np.eye(3, dtype=np.float32) if R_world_body_i is None else np.asarray(R_world_body_i, np.float32)
    v0 = np.zeros(3, np.float32) if v_world_body_i is None else np.asarray(v_world_body_i, np.float32)
    device_args = to_device(cloud.device, steps, t_rel_p, gyro_bias, accel_bias, R0, v0, T_imu_to_lidar)
    return _deskew_device(preintegration_params, gyro_only, cloud, *device_args), IMUDeskewStatus.success


def _deskew_device(params: pre.IMUPreintegrationParams, gyro_only: bool, cloud: PointCloud, packed, t_rel,
                   gyro_bias, accel_bias, R0, v0, T_il) -> PointCloud:
    """Trajectory integration and per-point correction, all on the device."""
    dev = cloud.device
    _, (dR_seq, dp_seq, dt_seq) = pre.integrate_steps_with_outputs(
        params, pre.init_state(device=dev), *pre.unpack_steps(packed), gyro_bias, accel_bias, R0)

    # gravity and initial-velocity compensation per trajectory sample, as
    # predict_relative_transform
    if gyro_only:
        dp_comp = torch.zeros_like(dp_seq)
    else:
        g = pre.gravity_vector(params, dev)
        dp_comp = dp_seq + 0.5 * (R0.T @ g)[None, :] * dt_seq[:, None] ** 2 + (R0.T @ v0)[None, :] * dt_seq[:, None]

    # IMU-frame relative pose -> LiDAR frame: T_l = T_il T_imu T_il^-1
    R_il, t_il = T_il[:3, :3], T_il[:3, 3]
    R_lidar = rotate_mat3(R_il, dR_seq)
    t_lidar = matvec3(R_il, dp_comp) + t_il[None, :] - matvec3(R_lidar, t_il)

    identity_q = torch.zeros((1, 4), dtype=_F32, device=dev)
    identity_q[0, 3] = 1.0
    traj_q = torch.cat([identity_q, lie.matrix_to_quat(R_lidar)])
    traj_t = torch.cat([torch.zeros((1, 3), dtype=_F32, device=dev), t_lidar])
    traj_ts = torch.cat([torch.zeros((1,), dtype=_F32, device=dev), t_rel])
    return apply_trajectory(cloud, traj_q, traj_t, traj_ts)
