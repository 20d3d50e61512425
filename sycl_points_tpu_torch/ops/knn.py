"""Exact nearest-neighbour search (counterpart of :mod:`sycl_points_tpu.ops.knn`).

  * :func:`brute_force_knn`: exact k-NN of arbitrary queries;
  * :class:`BruteForceKNN`: the correspondence-search structure over a target
    cloud, prepared once (``cuda_knn.prep_target``); ``search(k=1)`` goes
    through the ``nn1`` kernel wrapper with the pose folded into the queries
    (the ICP hot loop);
  * :func:`self_knn`: the exact self-k-NN of a cloud through the ``knn_k``
    kernel wrapper. It takes the place of ``approx_knn``, whose
    ``lax.approx_max_k`` exists only on a TPU and lowers to an exact top-k
    everywhere else.

:func:`build_target_knn` picks a target's correspondence search: brute force
at or below ``GRID_KNN_TARGET_THRESHOLD`` rows, :class:`~.grid_knn.GridKNN`
above it (never, at the default threshold).

A fleet's clouds (``[B, N, 3]``) go through the batched kernels in one
launch: :func:`self_knn_streams`, and :class:`BruteForceKNN` built on
``[B, M, 3]`` targets, whose ``search(k=1)`` takes queries ``[B, Q, 3]`` and
poses ``[B, 4, 4]``.

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
    """Exact k-NN (any k on the CPU, ``k <= cuda_knn.MAX_K`` on the card)
    through the ``knn_k`` wrapper, on a target prepared once for the call;
    ``pose`` (4x4), when given, moves the queries first."""
    if pose is not None:
        query_points = transform_points(query_points, pose)
    prep = cuda_knn.prep_target(target_points, target_mask)
    idx, d2 = cuda_knn.knn_k_prepped(prep, query_points.contiguous(), k)
    return KNNResult(idx, d2)


def self_knn(points: torch.Tensor, mask: torch.Tensor, k: int) -> KNNResult:
    """Exact k nearest neighbours of every point among the valid points of its
    own cloud (the query itself included), ascending."""
    return brute_force_knn(points, mask, points, k)


def self_knn_streams(points: torch.Tensor, mask: torch.Tensor, k: int) -> KNNResult:
    """:func:`self_knn` of every stream of ``points [B, N, 3]``, in one
    launch: ``[B, N, k]`` indices into each stream's own rows."""
    prep = cuda_knn.prep_targets(points, mask)
    return KNNResult(*cuda_knn.knn_k_batched(prep, points.contiguous(), k))


@dataclasses.dataclass(frozen=True)
class BruteForceKNN:
    """Correspondence search over a target cloud.

    ``prepped()`` holds the kernel-ready target (``cuda_knn.prep_target``:
    +inf on masked rows, padded to the kernels' tile, with each stream's
    extent, 1 + its last valid row), made once per align outside the ICP
    loop."""

    points: torch.Tensor  # [M, 3]
    mask: torch.Tensor  # [M]
    target: Optional[cuda_knn.PreppedTarget] = None

    @staticmethod
    def build(cloud: PointCloud) -> "BruteForceKNN":
        return BruteForceKNN(points=cloud.points, mask=cloud.mask)

    def prepped(self) -> "BruteForceKNN":
        if self.target is not None:
            return self
        prep = cuda_knn.prep_targets if self.points.dim() == 3 else cuda_knn.prep_target
        return dataclasses.replace(self, target=prep(self.points, self.mask))

    def search(
        self, query_points: torch.Tensor, k: int, pose: Optional[torch.Tensor] = None
    ) -> KNNResult:
        if self.points.dim() == 3:
            if k != 1:
                raise NotImplementedError("a fleet's target searches k = 1 only")
            i, d = cuda_knn.nn1_prepped_batched(
                self.prepped().target, query_points.contiguous(), None if pose is None else pose.contiguous())
            return KNNResult(i[..., None], d[..., None])
        if k == 1:
            i, d = cuda_knn.nn1_prepped(
                self.prepped().target, query_points.contiguous(),
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


# Rows above which build_target_knn picks the grid search. JAX measured no
# crossover on its TPU (brute force won at every size), so the default never
# picks the grid; a caller or a test lowers it to opt in.
GRID_KNN_TARGET_THRESHOLD = 1 << 62


def build_target_knn(cloud: PointCloud, *, max_correspondence_distance: float, threshold: Optional[int] = None):
    """The correspondence search of a target cloud: a prepared
    :class:`BruteForceKNN` at or below ``threshold`` rows (default
    :data:`GRID_KNN_TARGET_THRESHOLD`), else ``GridKNN.build_auto`` with
    ``cell_size = max_correspondence_distance``. ICP drops correspondences
    beyond that distance, and the grid is exact within one cell, so both
    give the registration the same correspondences."""
    thr = GRID_KNN_TARGET_THRESHOLD if threshold is None else threshold
    if cloud.capacity > thr:
        from sycl_points_tpu_torch.ops.grid_knn import GridKNN

        return GridKNN.build_auto(cloud, cell_size=max_correspondence_distance)
    return BruteForceKNN.build(cloud).prepped()
