"""Voxel keys and sort/segment-reduce voxel-grid downsampling.

Counterpart of :mod:`sycl_points_tpu.ops.voxel`, in plain PyTorch: integer
voxel coordinates, one stable sort on a packed int32 cell key (3 x 10 bits,
rebased to the per-frame minimum), segment ids from the key boundaries, and
one ``[N, C]`` segment sum (:func:`segment_sum_sorted`, the same bits on the
card and the CPU) for every mean channel plus the count. Voxels come out
compacted to the front at a static capacity.

A fleet's clouds (``[B, N, ...]``, B streams) take the same path in one
sort: the stream number sits above the cell key, so stream ``b``'s rows sort
as they sort alone, its segments follow those of the streams before it, and
each voxel's sum is taken in the same row order as in a single-stream call:
the result equals ``B`` single-stream calls bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from sycl_points_tpu_torch.points.point_cloud import PointCloud, flatten_streams, unflatten_streams

# 21 bits per axis, offset 2^20.
COORD_BITS = 21
COORD_OFFSET = 1 << (COORD_BITS - 1)
COORD_MASK = (1 << COORD_BITS) - 1
_SENTINEL = 2**31 - 1
# Per-axis cell budget of the packed sort key: bounds one frame's extent.
MAX_CELLS_PER_AXIS = 1024


def voxel_coords_counted(points: torch.Tensor, valid: torch.Tensor, voxel_size: float):
    """Integer voxel coordinates ``[N, 3]`` (sentinel for invalid points), the
    validity mask, and the count of finite valid points outside the 21-bit
    coordinate range (the map surfaces it as budget loss):
    floor(p / voxel_size) + offset, invalid when non-finite or out of range."""
    scaled = points * (1.0 / voxel_size)
    finite = torch.isfinite(scaled).all(-1) & valid
    # Clamp before the cast so huge or non-finite values convert defined;
    # they are masked out below either way.
    floor = torch.nan_to_num(torch.floor(scaled), nan=0.0).clamp(-(2.0**30), 2.0**30)
    c = floor.to(torch.int32) + COORD_OFFSET
    in_range = ((c >= 0) & (c <= COORD_MASK)).all(-1)
    ok = finite & in_range
    n_range_lost = (finite & ~in_range).sum(-1, dtype=torch.int32)
    c = torch.where(ok[..., None], c, _SENTINEL)
    return c, ok, n_range_lost


def voxel_coords(points: torch.Tensor, valid: torch.Tensor, voxel_size: float):
    """:func:`voxel_coords_counted` without the count."""
    c, ok, _ = voxel_coords_counted(points, valid, voxel_size)
    return c, ok


def cell_sort_ids(coords: torch.Tensor, ok: torch.Tensor):
    """Sort rows by cell with one stable sort on a packed int32 key (3 x 10
    bits, rebased to the per-frame minimum). Invalid rows and rows beyond the
    per-axis extent budget get the maximal key and sort to the tail as one
    segment.

    Returns ``(order, ok_sorted, seg_id, new_seg, n_extent_lost)``:
    ``seg_id`` (int64) numbers the cells in key order, ``new_seg`` marks each
    cell's first row, ``n_extent_lost`` counts valid rows outside the extent
    budget.

    For a fleet's ``coords [B, N, 3]`` the key of stream ``b`` is rebased to
    that stream's minimum and offset by ``b * 2^31`` (int64): one sort over
    the ``B * N`` flattened rows, stream after stream; ``order``, ``ok_sorted``
    and ``seg_id`` are flat (``seg_id`` numbers the cells of all streams in
    turn, see :func:`stream_segments`), ``n_extent_lost`` is ``[B]``."""
    masked = torch.where(ok[..., None], coords, 2**30)
    rel = coords - masked.amin(-2, keepdim=True)
    in_bound = ok & ((rel >= 0) & (rel < MAX_CELLS_PER_AXIS)).all(-1)
    n_extent_lost = (ok & ~in_bound).sum(-1, dtype=torch.int32)
    key = (rel[..., 0] * MAX_CELLS_PER_AXIS + rel[..., 1]) * MAX_CELLS_PER_AXIS + rel[..., 2]
    key = torch.where(in_bound, key, _SENTINEL)
    if key.dim() == 2:
        stream = torch.arange(key.shape[0], device=key.device)[:, None] << 31
        key = (key.to(torch.int64) + stream).reshape(-1)
        key_s, order = torch.sort(key, stable=True)
        ok_s = (key_s & _SENTINEL) != _SENTINEL
    else:
        key_s, order = torch.sort(key, stable=True)
        ok_s = key_s != _SENTINEL
    new_seg = torch.ones_like(ok_s)
    new_seg[1:] = key_s[1:] != key_s[:-1]
    seg_id = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    return order, ok_s, seg_id, new_seg, n_extent_lost


def stream_segments(seg_id: torch.Tensor, streams: int, out_capacity: int):
    """For the flat ``seg_id`` of :func:`cell_sort_ids` over ``streams``
    streams of equal row counts: ``(rows, valid)``, both ``[streams,
    out_capacity]``, the global segment number of each stream's segment
    ``j`` and whether the stream has that many segments."""
    n = seg_id.shape[0] // streams
    ends = seg_id.reshape(streams, n)
    first, last = ends[:, :1], ends[:, -1:]
    j = torch.arange(out_capacity, device=seg_id.device)
    valid = j < last - first + 1
    return torch.where(valid, first + j, 0), valid


def segment_sum_sorted(vals: torch.Tensor, seg_id: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment sums of the rows of ``vals``, whose segment ids ``seg_id``
    (in ``[0, len(vals))``) do not decrease: ``[num_segments, ...]``, 0 for
    an empty segment, segments from ``num_segments`` on dropped. Each
    segment is summed in row order from zero on every device, so the card
    and the CPU give the same bits (``index_add_`` sums in no fixed order on
    the card)."""
    n = vals.shape[0]
    lengths = torch.zeros(n, dtype=torch.int64, device=vals.device).index_add_(0, seg_id, torch.ones_like(seg_id))
    sums = torch.segment_reduce(vals, "sum", lengths=lengths, axis=0, unsafe=True)
    if num_segments <= n:
        return sums[:num_segments]
    return torch.cat([sums, sums.new_zeros((num_segments - n,) + sums.shape[1:])])


def sort_by_cell(coords: torch.Tensor, ok: torch.Tensor):
    """:func:`cell_sort_ids` plus the gathered sorted coordinates: ``(order,
    coords_sorted, ok_sorted, seg_id, new_seg, n_extent_lost)`` (flat over a
    fleet's streams)."""
    order, ok_s, seg_id, new_seg, n_extent_lost = cell_sort_ids(coords, ok)
    return order, coords.reshape(-1, 3)[order], ok_s, seg_id, new_seg, n_extent_lost


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
    RGB / timestamp / covariance / normal means, intensity median. A fleet's
    cloud (``[B, N, ...]``) comes out ``[B, out_capacity, ...]``."""
    out_cap = out_capacity or cloud.capacity
    lead = cloud.points.shape[:-2]
    if lead:
        cloud = flatten_streams(cloud)

    # Invalid points share the maximal key and sort to the tail as one
    # zero-weight segment.
    order, ok_s, seg_id, _, n_extent_lost = cell_sort_ids(coords, ok)
    w = ok_s.to(cloud.points.dtype)
    if lead:
        rows, row_ok = stream_segments(seg_id, lead[0], out_cap)
        rows, row_ok = rows.reshape(-1), row_ok.reshape(-1)

    def segment_sums(vals):
        if not lead:
            return segment_sum_sorted(vals, seg_id, out_cap)
        sums = segment_sum_sorted(vals, seg_id, vals.shape[0])
        return torch.where(row_ok[:, None], sums[rows], 0.0)

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

    # Segment sum; segments at or beyond out_cap are dropped
    # (segment_sum(num_segments=out_cap)).
    moments = segment_sums(vals)
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
        if lead:
            n = seg_id.shape[0]
            all_counts = segment_sum_sorted(w[:, None], seg_id, n)[:, 0]
            med = _segment_median(cloud.intensities[order], seg_id, w, all_counts, n)
            intens = torch.where(row_ok, med[rows], 0.0)
        else:
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
    if lead:
        out = unflatten_streams(out, lead[0])
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
