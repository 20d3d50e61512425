"""Per-point covariance and normal estimation from k-NN neighbourhoods
(counterpart of :mod:`sycl_points_tpu.ops.covariance`; the robust IRLS
estimator is not ported yet)."""

from __future__ import annotations

import torch

from sycl_points_tpu_torch.ops.knn import KNNResult
from sycl_points_tpu_torch.utils import eigh3
from sycl_points_tpu_torch.utils.eigh3 import normalize_covariance, plane_regularize  # noqa: F401 (re-export)


def _neighbor_validity(knn: KNNResult) -> torch.Tensor:
    return (knn.indices >= 0) & torch.isfinite(knn.distances)


def _weighted_moments(points: torch.Tensor, knn: KNNResult, weights: torch.Tensor, min_num: int):
    """Weighted mean/covariance over gathered neighbourhoods: ``(cov [N,3,3],
    mean [N,3], success [N])``, identity where fewer than ``max(min_num, 4)``
    valid neighbours or zero total weight. Centered two-pass form: the
    E[xx^T] - mu mu^T identity cancels in f32 at LiDAR coordinates."""
    valid = _neighbor_validity(knn)
    w = torch.where(valid, weights, 0.0)
    nbr = points[torch.clamp_min(knn.indices, 0).long()]  # [N, k, 3]

    total_w = w.sum(1)
    count = valid.sum(1)
    total_w_safe = torch.clamp_min(total_w, 1e-30)
    mean = (w[:, :, None] * nbr).sum(1) / total_w_safe[:, None]
    diff = nbr - mean[:, None, :]
    second_c = (w[:, :, None, None] * diff[:, :, :, None] * diff[:, :, None, :]).sum(1)
    cov = eigh3.ensure_symmetric(second_c / total_w_safe[:, None, None])

    success = (count >= max(min_num, 4)) & (total_w > torch.finfo(torch.float32).eps)
    eye = torch.eye(3, dtype=points.dtype, device=points.device).expand(cov.shape)
    return torch.where(success[:, None, None], cov, eye), mean, success


def estimate_covariances(points: torch.Tensor, knn: KNNResult, min_num: int = 4) -> torch.Tensor:
    """Plain neighbourhood covariance."""
    cov, _, _ = _weighted_moments(points, knn, torch.ones_like(knn.distances), min_num)
    return cov


def extract_normals(points: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """Normal = smallest-eigenvalue eigenvector, negated where
    ``dot(n, p) > 1`` (kept pointing toward the sensor)."""
    n = eigh3.smallest_eigenvector3(covs)
    flip = (n * points).sum(-1) > 1.0
    return torch.where(flip[..., None], -n, n)
