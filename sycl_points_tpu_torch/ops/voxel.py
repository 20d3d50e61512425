"""Voxel keys and sort/segment-reduce voxel-grid downsampling.

Counterpart of :mod:`sycl_points_tpu.ops.voxel`, in plain PyTorch: integer
voxel coordinates, one stable sort on a packed int32 cell key (3 x 10 bits,
rebased to the per-frame minimum), segment ids from the key boundaries, and
one ``[N, C]`` segment sum with ``index_add_`` for every mean channel plus the
count. Voxels come out compacted to the front at a static capacity.
"""

from __future__ import annotations

from typing import Optional

import torch

from sycl_points_tpu_torch.points.point_cloud import PointCloud

# 21 bits per axis, offset 2^20.
COORD_BITS = 21
COORD_OFFSET = 1 << (COORD_BITS - 1)
COORD_MASK = (1 << COORD_BITS) - 1
_SENTINEL = 2**31 - 1
# Per-axis cell budget of the packed sort key: bounds one frame's extent.
MAX_CELLS_PER_AXIS = 1024


def voxel_coords(points: torch.Tensor, valid: torch.Tensor, voxel_size: float):
    """Integer voxel coordinates ``[N, 3]`` (sentinel for invalid points) and
    the validity mask: floor(p / voxel_size) + offset, invalid when
    non-finite or outside the 21-bit range."""
    scaled = points * (1.0 / voxel_size)
    finite = torch.isfinite(scaled).all(-1) & valid
    # Clamp before the cast so huge or non-finite values convert defined;
    # they are masked out below either way.
    floor = torch.nan_to_num(torch.floor(scaled), nan=0.0).clamp(-(2.0**30), 2.0**30)
    c = floor.to(torch.int32) + COORD_OFFSET
    in_range = ((c >= 0) & (c <= COORD_MASK)).all(-1)
    ok = finite & in_range
    c = torch.where(ok[:, None], c, _SENTINEL)
    return c, ok


def voxel_downsample(
    cloud: PointCloud,
    voxel_size: float,
    min_voxel_count: int = 1,
    out_capacity: Optional[int] = None,
    return_lost: bool = False,
):
    """Voxel-grid downsampling to a static ``out_capacity`` (default: the
    input capacity). With ``return_lost`` returns ``(cloud, n_extent_lost)``,
    the count of valid points outside the per-frame extent budget."""
    coords, ok = voxel_coords(cloud.points, cloud.mask, voxel_size)
    return downsample_by_coords(cloud, coords, ok, min_voxel_count, out_capacity, return_lost)


def downsample_by_coords(
    cloud: PointCloud,
    coords: torch.Tensor,
    ok: torch.Tensor,
    min_voxel_count: int = 1,
    out_capacity: Optional[int] = None,
    return_lost: bool = False,
):
    """Sort/segment-reduce aggregation over integer bin coordinates: centroid,
    RGB / timestamp / covariance / normal means, intensity median."""
    out_cap = out_capacity or cloud.capacity
    dev = cloud.device

    masked = torch.where(ok[:, None], coords, 2**30)
    rel = coords - masked.amin(0)
    in_bound = ok & ((rel >= 0) & (rel < MAX_CELLS_PER_AXIS)).all(-1)
    n_extent_lost = (ok & ~in_bound).sum(dtype=torch.int32)
    key = (rel[:, 0] * MAX_CELLS_PER_AXIS + rel[:, 1]) * MAX_CELLS_PER_AXIS + rel[:, 2]
    key = torch.where(in_bound, key, _SENTINEL)

    # Invalid points share the maximal key and sort to the tail as one
    # zero-weight segment.
    key_s, order = torch.sort(key, stable=True)
    ok_s = key_s != _SENTINEL
    new_seg = torch.ones_like(ok_s)
    new_seg[1:] = key_s[1:] != key_s[:-1]
    seg_id = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    w = ok_s.to(cloud.points.dtype)

    cols = [cloud.points]
    if cloud.rgb is not None:
        cols.append(cloud.rgb[:, :3])
    if cloud.timestamp_offsets is not None:
        cols.append(cloud.timestamp_offsets[:, None])
    if cloud.covs is not None:
        cv = cloud.covs
        cols.append(torch.stack(
            [cv[:, 0, 0], cv[:, 0, 1], cv[:, 0, 2], cv[:, 1, 1], cv[:, 1, 2], cv[:, 2, 2]], dim=1
        ))
    if cloud.normals is not None:
        cols.append(cloud.normals)
    vals = torch.cat(cols + [torch.ones_like(cloud.points[:, :1])], dim=1)[order] * w[:, None]

    # Segment sum; segments at or beyond out_cap land in one spare row that
    # is cut off (segment_sum(num_segments=out_cap) drops them).
    moments = torch.zeros((out_cap + 1, vals.shape[1]), dtype=vals.dtype, device=dev)
    moments.index_add_(0, torch.clamp_max(seg_id, out_cap), vals)
    moments = moments[:out_cap]
    counts = moments[:, -1]
    means = moments[:, :-1] / torch.clamp_min(counts, 1.0)[:, None]
    voxel_ok = counts >= float(min_voxel_count)

    col = 3
    rgb = ts = covs = normals = intens = None
    if cloud.rgb is not None:
        rgb = means[:, col : col + 3]
        col += 3
    if cloud.timestamp_offsets is not None:
        ts = means[:, col]
        col += 1
    if cloud.covs is not None:
        u = means[:, col : col + 6]
        covs = torch.stack(
            [
                torch.stack([u[:, 0], u[:, 1], u[:, 2]], dim=1),
                torch.stack([u[:, 1], u[:, 3], u[:, 4]], dim=1),
                torch.stack([u[:, 2], u[:, 4], u[:, 5]], dim=1),
            ],
            dim=1,
        )
        col += 6
    if cloud.normals is not None:
        nm = means[:, col : col + 3]
        normals = nm / torch.clamp_min(torch.linalg.vector_norm(nm, dim=1, keepdim=True), 1e-9)
        col += 3
    if cloud.intensities is not None:
        intens = _segment_median(cloud.intensities[order], seg_id, w, counts, out_cap)

    out = PointCloud(
        points=means[:, :3],
        mask=voxel_ok,
        rgb=rgb,
        covs=covs,
        normals=normals,
        intensities=intens,
        timestamp_offsets=ts,
    )
    if return_lost:
        return out, n_extent_lost
    return out


def _segment_median(values, seg_id, w, counts, num_segments: int):
    """Per-segment median (mean of the two central elements for even
    counts). Invalid entries sort to their segment's tail as +inf."""
    n = values.shape[0]
    sort_vals = torch.where(w > 0, values, torch.inf)
    # lexsort on (seg_id, value): stable sort by value, then by segment.
    by_val = torch.argsort(sort_vals, stable=True)
    order2 = by_val[torch.argsort(seg_id[by_val], stable=True)]
    vals2 = values[order2]
    seg2 = seg_id[order2].contiguous()
    starts = torch.searchsorted(seg2, torch.arange(num_segments, device=seg2.device), side="left")
    cnt = counts.to(torch.int64)
    lo = torch.clamp(starts + torch.clamp_min(cnt - 1, 0) // 2, 0, n - 1)
    hi = torch.clamp(starts + cnt // 2, 0, n - 1)
    return 0.5 * (vals2[lo] + vals2[hi])
