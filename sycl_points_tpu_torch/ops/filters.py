"""Mask-based point filters (counterpart of :mod:`sycl_points_tpu.ops.filters`):
the box filter and the angle-incidence filter; the outlier removals are not
ported yet."""

from __future__ import annotations

import math

import torch

from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils.eigh3 import smallest_eigenvector3


def box_filter(cloud: PointCloud, min_distance: float, max_distance: float) -> PointCloud:
    """Keep finite points whose Chebyshev (L-inf) norm lies in [min, max]."""
    finite = torch.isfinite(cloud.points).all(-1)
    linf = torch.abs(cloud.points).amax(-1)
    keep = finite & (linf >= min_distance) & (linf <= max_distance)
    return cloud.replace(mask=cloud.mask & keep)


def angle_incidence_filter(cloud: PointCloud, min_angle: float, max_angle: float) -> PointCloud:
    """Keep points whose |cos| of the angle between ray and normal lies in
    [cos(max_angle), cos(min_angle)]. Normals come from the ``normals``
    field, else from the covariances (smallest-eigenvalue eigenvector)."""
    if cloud.normals is None and cloud.covs is None:
        raise ValueError("angle incidence filter requires normals or covariances")
    if min_angle < 0.0 or max_angle > math.pi * 0.5 or min_angle >= max_angle:
        raise ValueError("invalid angle range")
    normals = cloud.normals if cloud.normals is not None else smallest_eigenvector3(cloud.covs)
    max_cos = math.cos(min_angle)
    min_cos = math.cos(max_angle)

    finite = torch.isfinite(cloud.points).all(-1)
    dot = (cloud.points * normals).sum(-1)
    denom = torch.linalg.vector_norm(cloud.points, dim=-1) * torch.linalg.vector_norm(normals, dim=-1)
    abs_cos = torch.abs(dot / torch.clamp_min(denom, 1e-30))
    keep = finite & (denom > 1e-6) & (abs_cos >= min_cos) & (abs_cos <= max_cos)
    return cloud.replace(mask=cloud.mask & keep)
