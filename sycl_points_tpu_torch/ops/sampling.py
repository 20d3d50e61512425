"""Point sampling (counterpart of :mod:`sycl_points_tpu.ops.sampling`):
random, weighted and mixed sampling, and farthest-point sampling.

Sampling without replacement is a Gumbel top-k: uniform over the valid
points, or weighted (Efraimidis-Spirakis: ``log w`` plus the noise). The
noise comes from an explicit ``torch.Generator``, or from the caller as
``noise``; the top-k sits in :func:`sample_by_scores` so that a caller can
supply the scores.

Every sampler takes a fleet's cloud (``[B, N, ...]``) too, with scores or
noise ``[B, N]``: one top-k over the stream axis. The ``*_streams`` forms draw
stream ``b``'s noise from its own generator, so that stream ``b`` takes what
a single-stream call with that generator takes.
"""

from __future__ import annotations

from typing import Optional

import torch

from sycl_points_tpu_torch.points.point_cloud import PointCloud, gather_streams

_NEG = -1e30


def _take(cloud: PointCloud, idx: torch.Tensor, valid: torch.Tensor) -> PointCloud:
    def g(a):
        if a is None:
            return None
        return a[idx] if idx.dim() == 1 else gather_streams(a, idx)

    return PointCloud(
        points=g(cloud.points),
        mask=valid & g(cloud.mask),
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


def _top_eligible(scores: torch.Tensor, eligible: torch.Tensor, num: int):
    """Indices of the ``num`` highest ``scores`` among ``eligible`` rows, in
    descending order, and which of them are real (``num`` may exceed the
    eligible count)."""
    _, idx = torch.topk(torch.where(eligible, scores, _NEG), num, sorted=True)
    taken = torch.arange(num, device=scores.device) < eligible.sum(-1, dtype=torch.int32)[..., None]
    return idx, taken


def sample_by_scores(
    cloud: PointCloud, num: int, scores: torch.Tensor, eligible: Optional[torch.Tensor] = None
) -> PointCloud:
    """The ``num`` points of highest ``scores [capacity]`` among the
    ``eligible`` rows (default: the valid ones), in descending score order;
    slots beyond the eligible count are masked."""
    idx, taken = _top_eligible(scores, cloud.mask if eligible is None else eligible, num)
    return _take(cloud, idx, taken)


def random_sampling(cloud: PointCloud, num: int, generator: torch.Generator) -> PointCloud:
    """Uniform sampling without replacement to ``num`` points. A request that
    covers the whole capacity returns the cloud unchanged."""
    if num >= cloud.capacity:
        return cloud
    return sample_by_scores(cloud, num, gumbel_noise(cloud.capacity, generator, cloud.device))


def _weighted_scores(cloud: PointCloud, weights: torch.Tensor, noise: torch.Tensor):
    """Gumbel scores of the weighted draw and the rows it may take: valid
    points of positive finite weight."""
    w_ok = cloud.mask & (weights > 0.0) & torch.isfinite(weights)
    return torch.log(torch.clamp_min(weights, 1e-30)) + noise, w_ok


def weighted_sampling(
    cloud: PointCloud,
    num: int,
    weights: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> PointCloud:
    """Weighted sampling without replacement to ``num`` points; points of
    non-positive or non-finite weight are never taken. ``noise [capacity]``,
    when given, replaces the Gumbel noise drawn from ``generator``."""
    if num >= cloud.capacity:
        return cloud
    if noise is None:
        noise = gumbel_noise(cloud.capacity, generator, cloud.device)
    scores, w_ok = _weighted_scores(cloud, weights, noise)
    return sample_by_scores(cloud, num, scores, w_ok)


def mixed_sampling(
    cloud: PointCloud,
    num: int,
    weights: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    weighted_ratio: float = 0.8,
    noise: Optional[tuple] = None,
) -> PointCloud:
    """``weighted_ratio`` of the draw weighted, the remainder uniform over
    the valid points not yet taken. ``noise``, when given, is the pair of
    ``[capacity]`` Gumbel arrays of the two draws."""
    if num >= cloud.capacity:
        return cloud
    n_weighted = int(round(num * weighted_ratio))
    n_uniform = num - n_weighted
    if noise is None:
        noise = (gumbel_noise(cloud.capacity, generator, cloud.device),
                 gumbel_noise(cloud.capacity, generator, cloud.device))
    scores_w, w_ok = _weighted_scores(cloud, weights, noise[0])
    idx_w, w_taken = _top_eligible(scores_w, w_ok, n_weighted)
    selected = torch.zeros_like(cloud.mask).scatter_(-1, idx_w, w_taken)
    idx_u, u_taken = _top_eligible(noise[1], cloud.mask & ~selected, n_uniform)
    return _take(cloud, torch.cat([idx_w, idx_u], -1), torch.cat([w_taken, u_taken], -1))


def stream_noise(generators, n: int, device, draw=None) -> torch.Tensor:
    """``[B, n]`` Gumbel noise, row ``b`` drawn from ``generators[b]``; a
    row whose host flag ``draw[b]`` is False draws nothing and is zero."""
    rows = [gumbel_noise(n, g, device) if draw is None or draw[b] else torch.zeros(n, device=device)
            for b, g in enumerate(generators)]
    return torch.stack(rows)


def random_sampling_streams(cloud: PointCloud, num: int, generators) -> PointCloud:
    """:func:`random_sampling` of every stream of a fleet's cloud, stream
    ``b`` drawing from ``generators[b]``."""
    if num >= cloud.capacity:
        return cloud
    return sample_by_scores(cloud, num, stream_noise(generators, cloud.capacity, cloud.device))


def farthest_point_sampling(cloud: PointCloud, num: int, generator: torch.Generator) -> PointCloud:
    """Iterative farthest-point sampling to ``num`` points: the first is the
    valid point of highest uniform noise drawn from ``generator``; each next
    one is the valid point farthest from those taken (the first of equal
    distances). A request that covers the whole capacity returns the cloud
    unchanged; slots beyond the valid count are masked."""
    if num >= cloud.capacity:
        return cloud
    u = torch.rand(cloud.capacity, generator=generator, device=cloud.device)
    return _farthest_point_sampling(cloud, num, torch.argmax(torch.where(cloud.mask, u, -1.0)))


def _farthest_point_sampling(cloud: PointCloud, num: int, first: torch.Tensor) -> PointCloud:
    """:func:`farthest_point_sampling` from the given first index (a 0-dim
    device tensor): ``num - 1`` rounds of a distance update and an argmax,
    queued with no host read."""
    pts, valid = cloud.points, cloud.mask
    sel = torch.zeros(num, dtype=torch.int64, device=cloud.device)
    sel[0] = first
    min_d = torch.where(valid, torch.inf, -1.0)
    for i in range(1, num):
        e = pts - pts.index_select(0, sel[i - 1:i])
        min_d = torch.where(valid, torch.minimum(min_d, e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2]),
                            -1.0)
        sel[i] = torch.argmax(min_d)
    taken = torch.arange(num, device=cloud.device) < valid.sum()
    return _take(cloud, sel, taken)
