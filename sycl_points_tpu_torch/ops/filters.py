"""Mask-based point filters (counterpart of :mod:`sycl_points_tpu.ops.filters`;
the box filter only in this slice)."""

from __future__ import annotations

import torch

from sycl_points_tpu_torch.points.point_cloud import PointCloud


def box_filter(cloud: PointCloud, min_distance: float, max_distance: float) -> PointCloud:
    """Keep finite points whose Chebyshev (L-inf) norm lies in [min, max]."""
    finite = torch.isfinite(cloud.points).all(-1)
    linf = torch.abs(cloud.points).amax(-1)
    keep = finite & (linf >= min_distance) & (linf <= max_distance)
    return cloud.replace(mask=cloud.mask & keep)
