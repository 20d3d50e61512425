"""Random point sampling (counterpart of :mod:`sycl_points_tpu.ops.sampling`;
weighted, mixed and farthest-point sampling are not ported yet).

Uniform sampling without replacement is a Gumbel top-k over the valid
points. The noise comes from an explicit ``torch.Generator``; the top-k sits
in :func:`sample_by_scores` so that a caller can supply the scores.
"""

from __future__ import annotations

import torch

from sycl_points_tpu_torch.points.point_cloud import PointCloud

_NEG = -1e30


def _take(cloud: PointCloud, idx: torch.Tensor, valid: torch.Tensor) -> PointCloud:
    def g(a):
        return None if a is None else a[idx]

    return PointCloud(
        points=cloud.points[idx],
        mask=valid & cloud.mask[idx],
        covs=g(cloud.covs),
        normals=g(cloud.normals),
        rgb=g(cloud.rgb),
        intensities=g(cloud.intensities),
        timestamp_offsets=g(cloud.timestamp_offsets),
    )


def gumbel_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in (0, 1)."""
    u = torch.rand(n, generator=generator, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_by_scores(cloud: PointCloud, num: int, scores: torch.Tensor) -> PointCloud:
    """The ``num`` valid points of highest ``scores [capacity]``, in
    descending score order; slots beyond the valid count are masked."""
    score = torch.where(cloud.mask, scores, _NEG)
    _, idx = torch.topk(score, num, sorted=True)
    valid = torch.arange(num, device=cloud.device) < cloud.count()
    return _take(cloud, idx, valid)


def random_sampling(cloud: PointCloud, num: int, generator: torch.Generator) -> PointCloud:
    """Uniform sampling without replacement to ``num`` points. A request that
    covers the whole capacity returns the cloud unchanged."""
    if num >= cloud.capacity:
        return cloud
    return sample_by_scores(cloud, num, gumbel_noise(cloud.capacity, generator, cloud.device))
