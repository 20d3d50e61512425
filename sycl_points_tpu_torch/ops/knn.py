"""Exact nearest-neighbour search (counterpart of :mod:`sycl_points_tpu.ops.knn`).

  * :func:`brute_force_knn`: exact k-NN of arbitrary queries;
  * :class:`BruteForceKNN`: the correspondence-search structure over a target
    cloud; ``search(k=1)`` goes through the ``nn1`` kernel wrapper with the
    pose folded into the queries (the ICP hot loop);
  * :func:`self_knn`: the exact self-k-NN of a cloud through the ``knn_k``
    kernel wrapper. It takes the place of ``approx_knn``, whose
    ``lax.approx_max_k`` exists only on a TPU and lowers to an exact top-k
    everywhere else.

The wrappers in :mod:`.cuda_knn` run the plain versions for CPU tensors and
launch the CUDA kernels for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops.transform import transform_points
from sycl_points_tpu_torch.points.point_cloud import PointCloud


class KNNResult(NamedTuple):
    indices: torch.Tensor  # [Q, k] int32 into the target arrays
    distances: torch.Tensor  # [Q, k] float32 squared L2 (inf where missing)


def brute_force_knn(
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    query_points: torch.Tensor,
    k: int,
    pose: Optional[torch.Tensor] = None,
) -> KNNResult:
    """Exact k-NN (``k <= 16``) through the ``knn_k`` wrapper; ``pose`` (4x4),
    when given, moves the queries first."""
    if pose is not None:
        query_points = transform_points(query_points, pose)
    idx, d2 = cuda_knn.knn_k(
        target_points.contiguous(), target_mask.contiguous(), query_points.contiguous(), k
    )
    return KNNResult(idx, d2)


def self_knn(points: torch.Tensor, mask: torch.Tensor, k: int) -> KNNResult:
    """Exact k nearest neighbours of every point among the valid points of its
    own cloud (the query itself included), ascending."""
    return brute_force_knn(points, mask, points, k)


@dataclasses.dataclass(frozen=True)
class BruteForceKNN:
    """Correspondence search over a target cloud.

    ``prepped()`` holds the kernel-ready target (contiguous xyz and a uint8
    mask), made once per align outside the ICP loop."""

    points: torch.Tensor  # [M, 3]
    mask: torch.Tensor  # [M]
    is_prepped: bool = False

    @staticmethod
    def build(cloud: PointCloud) -> "BruteForceKNN":
        return BruteForceKNN(points=cloud.points, mask=cloud.mask)

    def prepped(self) -> "BruteForceKNN":
        if self.is_prepped:
            return self
        return BruteForceKNN(
            points=self.points.contiguous(),
            mask=self.mask.to(torch.uint8).contiguous(),
            is_prepped=True,
        )

    def search(
        self, query_points: torch.Tensor, k: int, pose: Optional[torch.Tensor] = None
    ) -> KNNResult:
        if k == 1:
            t = self.prepped()
            i, d = cuda_knn.nn1(
                t.points, t.mask, query_points.contiguous(),
                None if pose is None else pose.contiguous(),
            )
            return KNNResult(i[:, None], d[:, None])
        return brute_force_knn(self.points, self.mask, query_points, k, pose)

    def radius_search(
        self,
        query_points: torch.Tensor,
        radius: float,
        max_k: int,
        pose: Optional[torch.Tensor] = None,
    ) -> KNNResult:
        """Search with a ``max_k`` cap; neighbours beyond ``radius`` get index
        -1 and distance inf."""
        res = self.search(query_points, max_k, pose)
        within = res.distances <= radius * radius
        return KNNResult(
            torch.where(within, res.indices, -1),
            torch.where(within, res.distances, torch.inf),
        )
