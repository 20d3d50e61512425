"""PreprocessFilter: the reference's filter object, with a settable seed.

Counterpart of :mod:`sycl_points_tpu.ops.preprocess_filter` (the reference's
``PreprocessFilter``): the box and angle-incidence filters and the random,
weighted, mixed and farthest-point samplers behind one object whose draws
come from its own ``torch.Generator`` on ``device`` (the card unless the
caller asks for the CPU). The filters mask in place, so the reference's flag
buffers have no counterpart.
"""

from __future__ import annotations

import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.ops import filters as _filters
from sycl_points_tpu_torch.ops import sampling as _sampling
from sycl_points_tpu_torch.points.point_cloud import PointCloud


class PreprocessFilter:
    def __init__(self, seed: int = 1234, device: torch.device | str = "cuda"):
        self.device = require_device(device)
        self._generator = torch.Generator(device=self.device)
        self.set_random_seed(seed)

    def set_random_seed(self, seed: int) -> None:
        self._generator.manual_seed(seed)

    def box_filter(self, cloud: PointCloud, min_distance: float, max_distance: float) -> PointCloud:
        return _filters.box_filter(cloud, min_distance, max_distance)

    def angle_incidence_filter(self, cloud: PointCloud, min_angle: float, max_angle: float) -> PointCloud:
        return _filters.angle_incidence_filter(cloud, min_angle, max_angle)

    def random_sampling(self, cloud: PointCloud, num: int) -> PointCloud:
        return _sampling.random_sampling(cloud, num, self._generator)

    def weighted_random_sampling(self, cloud: PointCloud, weights: torch.Tensor, num: int) -> PointCloud:
        return _sampling.weighted_sampling(cloud, num, weights, self._generator)

    def mixed_random_sampling(self, cloud: PointCloud, weights: torch.Tensor, num: int,
                              weighted_ratio: float = 0.8) -> PointCloud:
        return _sampling.mixed_sampling(cloud, num, weights, self._generator, weighted_ratio)

    def farthest_point_sampling(self, cloud: PointCloud, num: int) -> PointCloud:
        return _sampling.farthest_point_sampling(cloud, num, self._generator)
