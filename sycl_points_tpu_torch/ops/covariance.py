"""Per-point covariance and normal estimation from k-NN neighbourhoods
(counterpart of :mod:`sycl_points_tpu.ops.covariance`): the plain estimator
and the robust IRLS one. A fleet's points ``[B, N, 3]`` take neighbour
indices ``[B, N, k]`` into their own stream."""

from __future__ import annotations

import torch

from sycl_points_tpu_torch.ops.knn import KNNResult
from sycl_points_tpu_torch.ops.robust import RobustLossType, compute_weight
from sycl_points_tpu_torch.points.point_cloud import gather_streams
from sycl_points_tpu_torch.utils import eigh3
from sycl_points_tpu_torch.utils.eigh3 import normalize_covariance, plane_regularize  # noqa: F401 (re-export)


def _neighbor_validity(knn: KNNResult) -> torch.Tensor:
    return (knn.indices >= 0) & torch.isfinite(knn.distances)


def _neighbors(points: torch.Tensor, knn: KNNResult) -> torch.Tensor:
    """The neighbours' coordinates ``[..., N, k, 3]``."""
    idx = torch.clamp_min(knn.indices, 0).long()
    return points[idx] if points.dim() == 2 else gather_streams(points, idx)


def _weighted_moments(points: torch.Tensor, knn: KNNResult, weights: torch.Tensor, min_num: int):
    """Weighted mean/covariance over gathered neighbourhoods: ``(cov [N,3,3],
    mean [N,3], success [N])``, identity where fewer than ``max(min_num, 4)``
    valid neighbours or zero total weight. Centered two-pass form: the
    E[xx^T] - mu mu^T identity cancels in f32 at LiDAR coordinates."""
    valid = _neighbor_validity(knn)
    w = torch.where(valid, weights, 0.0)
    nbr = _neighbors(points, knn)  # [N, k, 3]

    total_w = w.sum(-1)
    count = valid.sum(-1)
    total_w_safe = torch.clamp_min(total_w, 1e-30)
    mean = (w[..., None] * nbr).sum(-2) / total_w_safe[..., None]
    diff = nbr - mean[..., None, :]
    second_c = (w[..., None, None] * diff[..., :, None] * diff[..., None, :]).sum(-3)
    cov = eigh3.ensure_symmetric(second_c / total_w_safe[..., None, None])

    success = (count >= max(min_num, 4)) & (total_w > torch.finfo(torch.float32).eps)
    eye = torch.eye(3, dtype=points.dtype, device=points.device).expand(cov.shape)
    return torch.where(success[..., None, None], cov, eye), mean, success


def estimate_covariances(points: torch.Tensor, knn: KNNResult, min_num: int = 4) -> torch.Tensor:
    """Plain neighbourhood covariance."""
    cov, _, _ = _weighted_moments(points, knn, torch.ones_like(knn.distances), min_num)
    return cov


def _row_median(x: torch.Tensor) -> torch.Tensor:
    """Median along the last axis, the mean of the two middle values for an
    even length (``torch.median`` would take the lower one)."""
    k = x.shape[-1]
    s, _ = torch.sort(x, dim=-1)
    return 0.5 * (s[..., (k - 1) // 2] + s[..., k // 2])


def estimate_covariances_robust(
    points: torch.Tensor,
    knn: KNNResult,
    loss: RobustLossType = RobustLossType.CAUCHY,
    mad_scale: float = 1.4826,
    min_robust_scale: float = 1e-4,
    max_iterations: int = 3,
    min_num: int = 4,
) -> torch.Tensor:
    """IRLS robust covariance. The robust weight's argument is the squared
    Mahalanobis distance of a neighbour under the current estimate; the
    per-point scale is ``mad_scale * median(d^2)``, floored at
    ``min_robust_scale``. Invalid neighbour slots count as 0 in the median.
    A failed re-estimate freezes the previous value."""
    if loss is RobustLossType.NONE:
        return estimate_covariances(points, knn, min_num)

    valid = _neighbor_validity(knn)
    nbr = _neighbors(points, knn)
    cov, mean, success0 = _weighted_moments(points, knn, torch.ones_like(knn.distances), min_num)
    keep_running = success0

    for _ in range(max_iterations):
        cov_inv = eigh3.inv3(cov)
        diff = nbr - mean[..., None, :]
        u = (cov_inv[..., None, :, :] * diff[..., None, :]).sum(-1)  # [N, k, 3]
        d2 = torch.where(valid, (diff * u).sum(-1), 0.0)
        scale = torch.clamp_min(mad_scale * _row_median(d2), min_robust_scale)
        weights = compute_weight(loss, d2, scale[..., None])
        new_cov, new_mean, ok = _weighted_moments(points, knn, weights, min_num)
        upd = keep_running & ok
        cov = torch.where(upd[..., None, None], new_cov, cov)
        mean = torch.where(upd[..., None], new_mean, mean)
        keep_running = upd

    eye = torch.eye(3, dtype=points.dtype, device=points.device).expand(cov.shape)
    return torch.where(success0[..., None, None], cov, eye)


def extract_normals(points: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """Normal = smallest-eigenvalue eigenvector, negated where
    ``dot(n, p) > 1`` (kept pointing toward the sensor)."""
    n = eigh3.smallest_eigenvector3(covs)
    flip = (n * points).sum(-1) > 1.0
    return torch.where(flip[..., None], -n, n)
