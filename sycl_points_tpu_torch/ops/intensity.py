"""Intensity processing: correction, directional Gaussian smoothing,
local-mean normalization, z-score.

Counterpart of :mod:`sycl_points_tpu.ops.intensity`; each op is a gather
over the k-NN neighbourhoods and elementwise work on the cloud's device, for
one cloud ``[N]`` or a fleet's ``[B, N]`` (each stream's neighbours among its
own rows, as ``self_knn_streams`` gives them):

  * correction: I' = clamp(scale I (dist / ref)^exponent |cos|^-angle_exponent,
    min, max), the angle factor from the normals when there are any;
  * directional Gaussian smoothing: a Gaussian in each point's sensor-local
    (range, azimuth, elevation) frame, with a fallback basis near the zenith;
  * local-mean normalization: division by that Gaussian's local mean;
  * z-score against the plain k-NN neighbourhood, with a floor on sigma.
"""

from __future__ import annotations

import torch

from sycl_points_tpu_torch.ops.knn import KNNResult
from sycl_points_tpu_torch.points.point_cloud import PointCloud, gather_streams


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def _gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The neighbour rows ``idx [..., N, k]`` of ``values [..., N, ...]``:
    of each stream's own rows for a fleet's ``[B, N]`` cloud."""
    return gather_streams(values, idx) if idx.dim() == 3 else values[idx]


def _require_intensities(cloud: PointCloud) -> None:
    if cloud.intensities is None:
        raise ValueError("intensity field not found")


def correct_intensity(
    cloud: PointCloud,
    exponent: float = 2.0,
    scale: float = 1.0,
    min_intensity: float = 0.0,
    max_intensity: float = 1000.0,
    ref_distance: float = 1.0,
    angle_exponent: float = 0.0,
) -> PointCloud:
    """Distance and incidence-angle compensation of the intensities, in the
    cloud's sensor frame."""
    _require_intensities(cloud)
    if exponent < 0.0:
        raise ValueError("exponent must be non-negative")
    if ref_distance <= 0.0:
        raise ValueError("ref_distance must be positive")

    pts = cloud.points
    dist = _norm(pts)
    dist_factor = torch.pow(dist / ref_distance, exponent)
    angle_factor = torch.ones_like(dist)
    if angle_exponent != 0.0 and cloud.normals is not None:
        denom = dist * _norm(cloud.normals)
        abs_cos = torch.abs((pts * cloud.normals).sum(-1) / torch.clamp_min(denom, 1e-30))
        af = torch.pow(torch.clamp_min(abs_cos, 1e-3), -angle_exponent)
        angle_factor = torch.where(denom > 1e-6, af, 1.0)
    out = torch.clamp(cloud.intensities * dist_factor * angle_factor * scale, min_intensity, max_intensity)
    return cloud.replace(intensities=out)


def _directional_gaussian_mean(
    cloud: PointCloud,
    knn: KNNResult,
    sigma_azimuth: float,
    sigma_elevation: float,
    sigma_range: float,
    k_limit: int = 0,
) -> torch.Tensor:
    """Gaussian-weighted local intensity mean in each point's sensor-local
    (range, azimuth, elevation) basis; the point's own intensity where no
    neighbour weighs anything or the point sits at the sensor."""
    if sigma_azimuth <= 0 or sigma_elevation <= 0 or sigma_range <= 0:
        raise ValueError("all sigma values must be positive")
    pts, inten = cloud.points, cloud.intensities
    k_stride = knn.indices.shape[-1]
    k_use = k_limit if 0 < k_limit < k_stride else k_stride
    nbr = knn.indices[..., :k_use].to(torch.int64)
    idx = torch.clamp_min(nbr, 0)

    r = _norm(pts)
    r_safe = torch.clamp_min(r, 1e-6)
    r_hat = pts / r_safe[..., None]
    rxy = _norm(pts[..., :2])
    near_zenith = rxy < 1e-6
    inv_rxy = 1.0 / torch.clamp_min(rxy, 1e-6)
    ax = torch.where(near_zenith, 1.0, -pts[..., 1] * inv_rxy)
    ay = torch.where(near_zenith, 0.0, pts[..., 0] * inv_rxy)
    ex = torch.where(near_zenith, 0.0, -r_hat[..., 2] * ay)
    ey = torch.where(near_zenith, 1.0, r_hat[..., 2] * ax)
    ez = torch.where(near_zenith, 0.0, rxy / r_safe)

    dp = _gather(pts, idx) - pts[..., None, :]  # [..., N, k, 3]
    dp_r = (dp * r_hat[..., None, :]).sum(-1)
    dp_az = dp[..., 0] * ax[..., None] + dp[..., 1] * ay[..., None]
    dp_el = dp[..., 0] * ex[..., None] + dp[..., 1] * ey[..., None] + dp[..., 2] * ez[..., None]

    inv2_az = 0.5 / (sigma_azimuth * sigma_azimuth)
    inv2_el = 0.5 / (sigma_elevation * sigma_elevation)
    inv2_r = 0.5 / (sigma_range * sigma_range)
    w = torch.exp(-(dp_r**2 * inv2_r + dp_az**2 * inv2_az + dp_el**2 * inv2_el))
    w = torch.where((nbr >= 0) & torch.isfinite(knn.distances[..., :k_use]), w, 0.0)

    sum_w = w.sum(-1)
    mean = torch.where(sum_w > 0.0, (w * _gather(inten, idx)).sum(-1) / torch.clamp_min(sum_w, 1e-30), inten)
    return torch.where(r >= 1e-6, mean, inten)


def smooth_intensity(
    cloud: PointCloud,
    knn: KNNResult,
    sigma_azimuth: float,
    sigma_elevation: float,
    sigma_range: float = 0.05,
    k_limit: int = 0,
) -> PointCloud:
    """Directional anisotropic Gaussian smoothing of the intensities."""
    _require_intensities(cloud)
    return cloud.replace(intensities=_directional_gaussian_mean(
        cloud, knn, sigma_azimuth, sigma_elevation, sigma_range, k_limit))


def local_mean_normalize(
    cloud: PointCloud,
    knn: KNNResult,
    sigma_azimuth: float,
    sigma_elevation: float,
    sigma_range: float = 0.05,
    mean_min: float = 1e-3,
    k_limit: int = 0,
) -> PointCloud:
    """Divide each intensity by its directional-Gaussian local mean."""
    _require_intensities(cloud)
    if mean_min <= 0.0:
        raise ValueError("mean_min must be positive")
    mean = _directional_gaussian_mean(cloud, knn, sigma_azimuth, sigma_elevation, sigma_range, k_limit)
    return cloud.replace(intensities=cloud.intensities / torch.clamp_min(mean, mean_min))


def intensity_zscore(cloud: PointCloud, knn: KNNResult, sigma_min: float = 0.01) -> PointCloud:
    """Each intensity's z-score against its k-NN neighbourhood; 0 where the
    neighbourhood's sigma is below ``sigma_min``."""
    _require_intensities(cloud)
    if knn.indices.shape[-1] < 3:
        raise ValueError("neighbors.k must be >= 3")
    nI = _gather(cloud.intensities, torch.clamp_min(knn.indices.to(torch.int64), 0))  # [..., N, k]
    mean = nI.mean(-1)
    sigma = torch.sqrt(torch.clamp_min((nI * nI).mean(-1) - mean * mean, 0.0))
    z = (cloud.intensities - mean) / torch.clamp_min(sigma, 1e-30)
    return cloud.replace(intensities=torch.where(sigma < sigma_min, 0.0, z))
