"""Mask-based point filters (counterpart of :mod:`sycl_points_tpu.ops.filters`):
the box filter, the angle-incidence filter and the statistical and radius
outlier removals. Every filter clears mask bits and moves no data."""

from __future__ import annotations

import math

import torch

from sycl_points_tpu_torch.ops.knn import KNNResult
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


def statistical_outlier_removal(cloud: PointCloud, knn: KNNResult, stddev_mul_thresh: float = 1.0) -> PointCloud:
    """Statistical outlier removal on *squared* neighbour distances, as the
    reference does: each point's mean of its k squared distances, their mean
    and standard deviation over the valid points, and points whose mean lies
    above ``mean + stddev_mul_thresh * stddev`` removed. ``knn`` is a
    self-search of ``cloud`` (``ops.knn.self_knn``). The global sums run in
    another order than JAX's, so a point within float32 rounding of the
    threshold may land on the other side."""
    d = torch.where(torch.isfinite(knn.distances), knn.distances, 0.0)
    local_mean = d.sum(-1) / knn.distances.shape[-1]
    m = cloud.mask.to(local_mean.dtype)
    # padded slots count 0: normalize by the valid count (the reference's N
    # when the cloud has no padding)
    n = torch.clamp_min(m.sum(), 1.0)
    g_mean = (local_mean * m).sum() / n
    g_var = (((g_mean - local_mean) ** 2) * m).sum() / n
    keep = local_mean <= g_mean + stddev_mul_thresh * torch.sqrt(g_var)
    return cloud.replace(mask=cloud.mask & keep)


def radius_outlier_removal(cloud: PointCloud, knn: KNNResult, radius: float, min_neighbors: int) -> PointCloud:
    """Radius outlier removal: keep points with at least ``min_neighbors``
    neighbours within ``radius``, the self-match excluded. ``knn`` is a
    self-search of ``cloud`` with k > ``min_neighbors``."""
    within = (knn.distances <= radius * radius) & torch.isfinite(knn.distances)
    keep = within.sum(-1) - 1 >= min_neighbors
    return cloud.replace(mask=cloud.mask & keep)
