"""Fused two-cloud preprocessing: one sort and one segment reduction for a
scan pair, then the features of both clouds in one k-NN launch.

Counterpart of :mod:`sycl_points_tpu.ops.pair_preprocess`. Registration
always preprocesses two clouds (the reference harness does it one cloud
after the other, ``cpp/examples/example_registration.cpp:54-161``). Here both
clouds share one stable sort on the packed cell key, the cloud's number in
the bit above it, and one segment sum; the k-NN, covariances and normals then
run on the stacked pair ``[2, N]``, the k-NN through the stream-batched
``knn_k`` (``ops.knn.self_knn_streams``, B = 2) where JAX vmaps
``approx_knn``. The result equals two ``voxel_downsample`` calls and two
single-cloud feature passes.
"""

from __future__ import annotations

import torch

from sycl_points_tpu_torch.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu_torch.ops.knn import self_knn_streams
from sycl_points_tpu_torch.ops.voxel import MAX_CELLS_PER_AXIS, segment_sum_sorted, voxel_coords
from sycl_points_tpu_torch.points.point_cloud import PointCloud

_SENT = 2**31 - 1


def voxel_downsample_pair(a: PointCloud, b: PointCloud, voxel_size: float, out_capacity: int):
    """Voxel-grid downsample two point-only clouds with one sort: ``(a_down,
    b_down)``, each of capacity ``out_capacity``, equal to
    ``voxel_downsample(c, voxel_size, out_capacity=out_capacity)`` of each
    (centroids; clouds with attribute channels take the single-cloud path).
    Each cloud's key is re-based to its own minimum; a cloud's voxels beyond
    ``out_capacity`` are dropped, as the single call drops them."""
    ca, oka = voxel_coords(a.points, a.mask, voxel_size)
    cb, okb = voxel_coords(b.points, b.mask, voxel_size)
    coords = torch.cat([ca, cb])
    ok = torch.cat([oka, okb])
    dev = coords.device
    is_a = torch.cat([torch.ones(a.capacity, dtype=torch.bool, device=dev),
                      torch.zeros(b.capacity, dtype=torch.bool, device=dev)])
    pts = torch.cat([a.points, b.points])

    masked = torch.where(ok[:, None], coords, 2**30)
    min_a = torch.where(is_a[:, None], masked, 2**30).amin(0)
    min_b = torch.where(is_a[:, None], 2**30, masked).amin(0)
    rel = coords - torch.where(is_a[:, None], min_a, min_b)
    in_bound = ok & ((rel >= 0) & (rel < MAX_CELLS_PER_AXIS)).all(-1)
    key = (rel[:, 0] * MAX_CELLS_PER_AXIS + rel[:, 1]) * MAX_CELLS_PER_AXIS + rel[:, 2]
    key = key + torch.where(is_a, 0, 2**30)  # the cloud's number above the cell bits
    key = torch.where(in_bound, key, _SENT)

    key_s, order = torch.sort(key, stable=True)
    ok_s = key_s != _SENT
    new_seg = torch.ones_like(ok_s)
    new_seg[1:] = key_s[1:] != key_s[:-1]
    seg_id = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    w = ok_s.to(torch.float32)
    moments = segment_sum_sorted(torch.cat([pts[order], torch.ones_like(w[:, None])], 1) * w[:, None], seg_id,
                                 key.shape[0])

    # a's voxels are segments 0 .. n_a - 1, b's the n_b after them
    row_is_a = ok_s & (key_s < 2**30)
    n_a = torch.where(row_is_a, seg_id, -1).max() + 1
    n_b = torch.where(ok_s & ~row_is_a, seg_id, -1).max() + 1 - n_a
    j = torch.arange(out_capacity, device=dev)

    def take(first, n):
        rows = (first + j).clamp_max(moments.shape[0] - 1)
        m = torch.where((j < n)[:, None], moments[rows], 0.0)
        counts = m[:, 3]
        return PointCloud(points=m[:, :3] / torch.clamp_min(counts, 1.0)[:, None], mask=counts >= 1.0)

    return take(0, n_a), take(n_a, n_b)


def features_pair(a: PointCloud, b: PointCloud, k: int = 10):
    """Covariances and normals of two clouds of one capacity, the pair
    stacked ``[2, N]``: the k-NN in one ``knn_k_batched`` launch."""
    pts = torch.stack([a.points, b.points])
    msk = torch.stack([a.mask, b.mask])
    covs = estimate_covariances(pts, self_knn_streams(pts, msk, k))
    normals = extract_normals(pts, covs)
    return a.replace(covs=covs[0], normals=normals[0]), b.replace(covs=covs[1], normals=normals[1])


def preprocess_pair(a: PointCloud, b: PointCloud, voxel_size: float, out_capacity: int, k: int = 10):
    """The fused pair preprocess: the shared voxel downsample, then the
    features of both. Clouds must be point-only."""
    ad, bd = voxel_downsample_pair(a, b, voxel_size, out_capacity)
    return features_pair(ad, bd, k)
