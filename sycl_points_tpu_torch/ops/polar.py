"""Polar-grid downsampling: (range, elevation, azimuth) binning.

Counterpart of :mod:`sycl_points_tpu.ops.polar`: polar coordinates in the
LIDAR (x forward, z up) or CAMERA (z forward, y down) convention, each axis
quantized, then the voxel stage's sort / segment-reduce aggregation over the
bins (:func:`..voxel.downsample_by_coords`), one stream after another for a
fleet's ``[B, N]`` cloud. A point within float rounding
of a bin edge may land in the neighbouring bin on another device or package
(``atan2`` rounds differently).
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from sycl_points_tpu_torch.ops.voxel import COORD_MASK, COORD_OFFSET, _SENTINEL, downsample_by_coords
from sycl_points_tpu_torch.points.point_cloud import PointCloud


class CoordinateSystem(enum.Enum):
    LIDAR = "lidar"
    CAMERA = "camera"

    @staticmethod
    def from_string(s: str) -> "CoordinateSystem":
        return CoordinateSystem[s.strip().upper()]


def _bin(v: torch.Tensor, size: float) -> torch.Tensor:
    """``floor(v / size)`` as int32 plus the coordinate offset; non-finite
    values convert defined (clamped in float first) and are masked by the
    caller."""
    f = torch.nan_to_num(torch.floor(v / size), nan=0.0).clamp(-(2.0**30), 2.0**30)
    return f.to(torch.int32) + COORD_OFFSET


def polar_coords(
    points: torch.Tensor,
    valid: torch.Tensor,
    distance_size: float,
    elevation_size: float,
    azimuth_size: float,
    coord_system: CoordinateSystem = CoordinateSystem.LIDAR,
):
    """Integer (range, elevation, azimuth) bin coordinates ``[..., N, 3]``
    (_SENTINEL for invalid points) and the validity mask ``[..., N]``."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    finite = torch.isfinite(points).all(-1) & valid
    r = torch.sqrt(x * x + y * y + z * z)
    if coord_system is CoordinateSystem.LIDAR:
        planar_sq = x * x + y * y
        azimuth = torch.atan2(y, x)
        elevation = torch.atan2(z, torch.sqrt(torch.clamp_min(planar_sq, 0.0)))
    elif coord_system is CoordinateSystem.CAMERA:
        planar_sq = x * x + z * z
        azimuth = torch.atan2(x, z)
        elevation = torch.atan2(-y, torch.sqrt(torch.clamp_min(planar_sq, 0.0)))
    else:
        raise ValueError(coord_system)

    coords = torch.stack([_bin(r, distance_size), _bin(elevation, elevation_size), _bin(azimuth, azimuth_size)],
                         dim=-1)
    in_range = ((coords >= 0) & (coords <= COORD_MASK)).all(-1)
    ok = finite & (r > 0.0) & (planar_sq > 0.0) & in_range
    return torch.where(ok[..., None], coords, _SENTINEL), ok


def polar_downsample(
    cloud: PointCloud,
    distance_size: float,
    elevation_size: float,
    azimuth_size: float,
    coord_system: CoordinateSystem = CoordinateSystem.LIDAR,
    min_voxel_count: int = 1,
    out_capacity: Optional[int] = None,
) -> PointCloud:
    """Polar-grid downsampling: one point a bin (the centroid, and the
    attribute means or median as the voxel stage takes them), compacted to
    the front at ``out_capacity`` (default: the input capacity). A fleet's
    cloud ``[B, N]`` bins each stream into its own rows ``[B, out_capacity]``."""
    coords, ok = polar_coords(cloud.points, cloud.mask, distance_size, elevation_size, azimuth_size, coord_system)
    return downsample_by_coords(cloud, coords, ok, min_voxel_count, out_capacity)
