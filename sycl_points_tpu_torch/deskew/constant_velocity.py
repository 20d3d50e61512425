"""Constant-velocity ("VICP") motion-distortion compensation.

Counterpart of :mod:`sycl_points_tpu.deskew.constant_velocity`: body twist =
log(prev_pose^-1 current_pose); each point is moved by se3_exp(tau twist)
with tau = clamp(t_offset / scan_duration, 0, 1); normals and covariances
turn with the rotation part. One batched se3_exp over the whole cloud.
"""

from __future__ import annotations

import torch

from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils import lie
from sycl_points_tpu_torch.utils.smallmat import matvec3, rotate_mat3


def deskew_constant_velocity(cloud: PointCloud, previous_pose: torch.Tensor, current_pose: torch.Tensor,
                             scan_duration_seconds) -> PointCloud:
    """Deskew a timestamped cloud; points with non-finite timestamps stay
    where they are, and a cloud without timestamps is returned as it is."""
    if cloud.timestamp_offsets is None:
        return cloud
    delta_twist = lie.se3_log(lie.transform_inverse(previous_pose) @ current_pose)
    t_sec = cloud.timestamp_offsets * 1e-3
    finite = torch.isfinite(t_sec)
    tau = torch.clamp(torch.where(finite, t_sec, 0.0) / scan_duration_seconds, 0.0, 1.0)
    tau = torch.where(finite, tau, 0.0)  # identity motion for non-finite stamps

    motion = lie.se3_exp(tau[:, None] * delta_twist[None, :])  # [N, 4, 4]
    R = motion[:, :3, :3]
    return cloud.replace(
        points=matvec3(R, cloud.points) + motion[:, :3, 3],
        normals=None if cloud.normals is None else matvec3(R, cloud.normals),
        covs=None if cloud.covs is None else rotate_mat3(R, cloud.covs),
    )
