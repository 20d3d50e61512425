"""SE(3) transforms of point-cloud attributes (counterpart of
:mod:`sycl_points_tpu.ops.transform`): elementwise broadcast sums, exact f32."""

from __future__ import annotations

import torch

from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils.smallmat import matvec3, rotate_mat3


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply ``T [4,4]`` to ``points [..., 3]``: ``R p`` as a row-wise sum,
    then ``+ t``."""
    return matvec3(T[..., :3, :3], points) + T[..., :3, 3]


def rotate_vectors(vecs: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Rotate direction vectors (normals) by the rotation block of ``T``."""
    return matvec3(T[..., :3, :3], vecs)


def rotate_covs(covs: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """``R C R^T`` for ``covs [..., 3, 3]``."""
    return rotate_mat3(T[..., :3, :3], covs)


def transform_cloud(cloud: PointCloud, T: torch.Tensor) -> PointCloud:
    """Whole-cloud transform."""
    return cloud.replace(
        points=transform_points(cloud.points, T),
        normals=None if cloud.normals is None else rotate_vectors(cloud.normals, T),
        covs=None if cloud.covs is None else rotate_covs(cloud.covs, T),
    )
