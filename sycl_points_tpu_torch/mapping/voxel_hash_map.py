"""Persistent voxel hash map on the device (the submap's backend).

Counterpart of :mod:`sycl_points_tpu.mapping.voxel_hash_map`, in plain
PyTorch (the JAX side computes it in XLA ops outside any Pallas kernel). An
insert is

  1. a per-frame pre-aggregation by one sort and a segment sum, which leaves
     at most one contribution per voxel;
  2. :func:`~.hash_table.resolve_slots`, which finds or claims a slot for
     each of those voxels;
  3. ``index_add_`` of the contributions into the table's accumulators.

A voxel holds the position sum and count, the sum of log-Euclidean
covariances (rotated into the map frame and matrix-log'ed before summing,
matrix-exp'ed on extraction), RGBA and intensity sums, and the stamp of its
last update for staleness pruning.

The state is a frozen dataclass of tensors and every function returns a new
one: the odometry keeps the state from before an insert so that an insert
that dropped contributions can be retried on a grown table. The frame's
segment sums are taken in row order (``ops.voxel.segment_sum_sorted``) and
each voxel then takes one ``index_add_`` row, so an insert gives the same
bits on the card and on the CPU.

Capacity is fixed per state; :func:`grow` re-inserts the table into one
``factor`` times larger, and :func:`add_point_cloud_auto` wraps insertion
with the growth policy: grow while the load exceeds ``max_load``, and grow
and retry the same insert when any contribution was dropped on probe
exhaustion (``state.dropped``).

A fleet's maps are stacked: every field of the state takes a leading stream
axis (``coords [B, C, 3]``, ``frame [B]``, ...), one shared capacity
(:func:`stack_streams`). :func:`add_point_cloud`, :func:`extract`,
:func:`grow`, :func:`load_factor` and :func:`remove_old_data` take such a
state with clouds ``[B, N]``, poses ``[B, 4, 4]`` and centres ``[B, 3]``,
and run all streams through one sort, one set of probe rounds
(:mod:`.hash_table`) and one ``index_add_``; stream ``b``'s result equals a
single-stream call on its own map bit for bit. A stream that is not to
insert keeps its state through :func:`select_streams`.
"""

from __future__ import annotations

import dataclasses

import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.mapping.hash_table import (
    compact_indices_ranked,
    lookup_slots,
    resolve_slots,
)
from sycl_points_tpu_torch.ops.transform import rotate_covs, transform_points
from sycl_points_tpu_torch.ops.voxel import (
    _SENTINEL,
    segment_sum_sorted,
    sort_by_cell,
    stream_segments,
    voxel_coords,
    voxel_coords_counted,
)
from sycl_points_tpu_torch.points.point_cloud import PointCloud, gather_streams, stream_offsets
from sycl_points_tpu_torch.utils import eigh3
from sycl_points_tpu_torch.utils.sync import to_host

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class VoxelHashMapConfig:
    voxel_size: float = 1.0
    capacity: int = 1 << 18  # slots (power of two)
    max_probes: int = 32
    min_num_point: int = 1
    max_staleness: int = 100
    remove_old_data_cycle: int = 10


@dataclasses.dataclass(frozen=True)
class VoxelHashMapState:
    coords: torch.Tensor  # [C, 3] int32 voxel coords; _SENTINEL when empty
    used: torch.Tensor  # [C] bool
    sum_pos: torch.Tensor  # [C, 3]
    count: torch.Tensor  # [C] float32
    sum_logcov: torch.Tensor  # [C, 6] upper triangle of the summed log-covariances
    sum_rgba: torch.Tensor  # [C, 4]
    sum_intensity: torch.Tensor  # [C]
    last_update: torch.Tensor  # [C] int32 frame stamp
    frame: torch.Tensor  # scalar int32
    dropped: torch.Tensor  # scalar int32: contributions lost to probe exhaustion
    # scalar int32: contributions lost to fixed budgets that a larger table
    # cannot raise (out-of-extent sort keys, the 21-bit coordinate range);
    # kept apart from ``dropped`` so the growth policy never retries them.
    budget_lost: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.coords.device


_TRI = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _tri_pack(M: torch.Tensor) -> torch.Tensor:
    return torch.stack([M[..., i, j] for i, j in _TRI], dim=-1)


def _tri_unpack(v: torch.Tensor) -> torch.Tensor:
    xx, xy, xz, yy, yz, zz = (v[..., i] for i in range(6))
    return torch.stack(
        [torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1), torch.stack([xz, yz, zz], -1)],
        dim=-2,
    )


def create(config: VoxelHashMapConfig, device: torch.device | str = "cuda") -> VoxelHashMapState:
    """An empty map on ``device`` (the card unless the caller asks for the
    CPU)."""
    dev = require_device(device)
    C = config.capacity

    def zeros(*shape, dtype=_F32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return VoxelHashMapState(
        coords=torch.full((C, 3), _SENTINEL, dtype=torch.int32, device=dev),
        used=zeros(C, dtype=torch.bool),
        sum_pos=zeros(C, 3),
        count=zeros(C),
        sum_logcov=zeros(C, 6),
        sum_rgba=zeros(C, 4),
        sum_intensity=zeros(C),
        last_update=zeros(C, dtype=torch.int32),
        frame=zeros(dtype=torch.int32),
        dropped=zeros(dtype=torch.int32),
        budget_lost=zeros(dtype=torch.int32),
    )


def stack_streams(state, streams: int):
    """A fleet's stacked map state: ``streams`` copies of ``state`` (of
    either backend) along a new leading axis."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).expand((streams,) + getattr(state, f.name).shape).clone()
        for f in dataclasses.fields(state)})


def select_streams(flag: torch.Tensor, a, b):
    """Stream by stream, the fields of stacked state ``a`` where ``flag [B]``
    holds, else those of ``b``."""
    def pick(x, y):
        return torch.where(flag.reshape(flag.shape + (1,) * (x.dim() - 1)), x, y)

    return dataclasses.replace(a, **{f.name: pick(getattr(a, f.name), getattr(b, f.name))
                                     for f in dataclasses.fields(a)})


def _flat_rows(slot: torch.Tensor, ok: torch.Tensor, capacity: int) -> torch.Tensor:
    """Flat table rows of each stream's slots (``capacity`` slots a stream),
    the spare row past the last stream's where not ``ok``."""
    if slot.dim() == 1:
        return torch.where(ok, slot, capacity)
    B = slot.shape[0]
    off = stream_offsets(B, capacity, slot.device)
    return torch.where(ok, slot + off, B * capacity).reshape(-1)


def _flat(t: torch.Tensor, lead) -> torch.Tensor:
    return t.reshape((-1,) + t.shape[len(lead) + 1:]) if lead else t


def _set_rows(table: torch.Tensor, tgt: torch.Tensor, values: torch.Tensor, lead=()) -> torch.Tensor:
    """A copy of ``table`` with ``values`` written at rows ``tgt``; rows equal
    to the table's length are dropped (they land in a spare row). A stacked
    table (``lead`` its stream axis) takes flat rows (:func:`_flat_rows`)."""
    flat = _flat(table, lead)
    out = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])
    out.index_copy_(0, tgt, _flat(values, lead))
    return out[:-1].reshape(table.shape)


def _add_rows(table: torch.Tensor, tgt: torch.Tensor, values: torch.Tensor, lead=()) -> torch.Tensor:
    """:func:`_set_rows` with ``values`` added (``index_add``)."""
    flat = _flat(table, lead)
    out = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])
    out.index_add_(0, tgt, _flat(values, lead).to(table.dtype))
    return out[:-1].reshape(table.shape)


def _segments(payload: torch.Tensor, coords: torch.Tensor, ok: torch.Tensor):
    """Sort and segment-sum the frame's weighted payload rows by voxel:
    ``(seg_keys [..., N, 3], agg [..., N, P], n_extent_lost)``; a stream's
    segments past its last hold nothing (a zero count column)."""
    N = ok.shape[-1]
    dev = ok.device
    order, coords_s, ok_s, seg_id, _, n_extent_lost = sort_by_cell(coords, ok)
    rows = payload.reshape(-1, payload.shape[-1])[order] * ok_s.to(_F32)[:, None]
    n = seg_id.shape[0]
    agg = segment_sum_sorted(rows, seg_id, n if ok.dim() > 1 else N)
    first = torch.full((n,), n - 1, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, seg_id, torch.arange(n, device=dev), "amin")
    if ok.dim() == 1:
        return coords_s[first], agg, n_extent_lost
    seg, seg_ok = stream_segments(seg_id, ok.shape[0], N)
    agg = torch.where(seg_ok[..., None], agg[seg], 0.0)
    return coords_s[first[seg]], agg, n_extent_lost


def add_point_cloud(
    state: VoxelHashMapState,
    config: VoxelHashMapConfig,
    cloud: PointCloud,
    sensor_pose: torch.Tensor,
) -> VoxelHashMapState:
    """Insert a sensor-frame cloud at ``sensor_pose`` (a fleet's clouds at
    their poses)."""
    lead = cloud.points.shape[:-2]
    N = cloud.capacity
    dev = cloud.device
    pose = sensor_pose[:, None] if lead else sensor_pose
    pts_map = transform_points(cloud.points, pose)
    coords, ok, n_range_lost = voxel_coords_counted(pts_map, cloud.mask, config.voxel_size)

    # Per-point payload in the map frame, one [N, 15] block: position, count,
    # log-covariance, RGBA, intensity.
    def zeros(*tail):
        return torch.zeros(lead + (N,) + tail, dtype=_F32, device=dev)

    if cloud.covs is not None:
        logcov = _tri_pack(eigh3.spd_log(rotate_covs(cloud.covs, pose)))
    else:
        logcov = zeros(6)
    rgba = cloud.rgb if cloud.rgb is not None else zeros(4)
    inten = cloud.intensities if cloud.intensities is not None else zeros()
    payload = torch.cat([pts_map, torch.ones_like(pts_map[..., :1]), logcov, rgba, inten[..., None]], dim=-1)

    # Frame-local pre-aggregation: packed-key sort, one segment sum; a
    # segment's key is that of its first sorted row.
    seg_keys, agg, n_extent_lost = _segments(payload, coords, ok)
    agg_cnt = agg[..., 3]
    seg_valid = agg_cnt > 0.0

    coords_tbl, used, slot, resolved = resolve_slots(
        state.coords, state.used, seg_keys, seg_valid, config.capacity, config.max_probes
    )
    # Unresolved segments add zeros to slot 0.
    tgt = _flat_rows(torch.where(resolved, slot, 0), torch.ones_like(resolved), config.capacity)
    agg = agg * resolved.to(_F32)[..., None]

    def added(table, cols):
        return _add_rows(table, tgt, cols, lead) if lead else table.index_add(0, tgt, cols)

    frame = state.frame[..., None].expand(lead + (N,))
    return VoxelHashMapState(
        coords=coords_tbl,
        used=used,
        sum_pos=added(state.sum_pos, agg[..., 0:3]),
        count=added(state.count, agg[..., 3]),
        sum_logcov=added(state.sum_logcov, agg[..., 4:10]),
        sum_rgba=added(state.sum_rgba, agg[..., 10:14]),
        sum_intensity=added(state.sum_intensity, agg[..., 14]),
        last_update=_set_rows(state.last_update, _flat_rows(slot, resolved, config.capacity), frame, lead),
        frame=state.frame + 1,
        dropped=state.dropped + (seg_valid & ~resolved).sum(-1, dtype=torch.int32),
        budget_lost=state.budget_lost + n_range_lost + n_extent_lost,
    )


def load_factor(state: VoxelHashMapState, config: VoxelHashMapConfig) -> torch.Tensor:
    """Occupied fraction of the table (the growth policy rehashes above 0.7);
    ``[B]`` for a fleet."""
    return state.used.sum(-1, dtype=_F32) / config.capacity


def grow(
    state: VoxelHashMapState, config: VoxelHashMapConfig, factor: int = 2
) -> tuple[VoxelHashMapState, VoxelHashMapConfig]:
    """Re-insert every used slot into a ``factor``-times-larger table (every
    stream's, for a fleet)."""
    lead = state.frame.shape
    new_config = dataclasses.replace(config, capacity=config.capacity * factor)
    new = create(new_config, state.device)
    if lead:
        new = stack_streams(new, lead[0])
    coords_tbl, used, slot, resolved = resolve_slots(
        new.coords, new.used, state.coords, state.used,
        new_config.capacity, new_config.max_probes,
    )
    tgt = _flat_rows(slot, resolved, new_config.capacity)

    def moved(f):
        return _set_rows(getattr(new, f), tgt, getattr(state, f), lead)

    out = VoxelHashMapState(
        coords=coords_tbl,
        used=used,
        sum_pos=moved("sum_pos"),
        count=moved("count"),
        sum_logcov=moved("sum_logcov"),
        sum_rgba=moved("sum_rgba"),
        sum_intensity=moved("sum_intensity"),
        last_update=moved("last_update"),
        frame=state.frame,
        dropped=state.dropped + (state.used & ~resolved).sum(-1, dtype=torch.int32),
        budget_lost=state.budget_lost,
    )
    return out, new_config


def add_point_cloud_auto(
    state: VoxelHashMapState,
    config: VoxelHashMapConfig,
    cloud: PointCloud,
    sensor_pose: torch.Tensor,
    max_load: float = 0.7,
    max_grow_steps: int = 8,
) -> tuple[VoxelHashMapState, VoxelHashMapConfig]:
    """Insertion with the growth policy, decided on the host: grow while the
    load factor exceeds ``max_load``, insert, and if any contribution was
    dropped on probe exhaustion retry the same insert on a grown table (the
    state from before the insert is kept, so a retried insert loses
    nothing)."""
    for _ in range(max_grow_steps):
        if to_host(load_factor(state, config)) <= max_load:
            break
        state, config = grow(state, config)
    for _ in range(max_grow_steps):
        new_state = add_point_cloud(state, config, cloud, sensor_pose)
        if to_host(new_state.dropped == state.dropped):
            return new_state, config
        state, config = grow(state, config)
    return add_point_cloud(state, config, cloud, sensor_pose), config


def remove_old_data(state: VoxelHashMapState, config: VoxelHashMapConfig) -> VoxelHashMapState:
    """Staleness pruning: clear the slots not touched within
    ``max_staleness`` frames."""
    age = state.frame[..., None] - 1 - state.last_update
    keep = ~(state.used & (age > config.max_staleness))
    kf = keep.to(_F32)
    return dataclasses.replace(
        state,
        coords=torch.where(keep[..., None], state.coords, _SENTINEL),
        used=state.used & keep,
        sum_pos=state.sum_pos * kf[..., None],
        count=state.count * kf,
        sum_logcov=state.sum_logcov * kf[..., None],
        sum_rgba=state.sum_rgba * kf[..., None],
        sum_intensity=state.sum_intensity * kf,
        last_update=torch.where(keep, state.last_update, 0),
    )


def voxel_count(state: VoxelHashMapState) -> torch.Tensor:
    return state.used.sum(dtype=torch.int32)


def _taker(order: torch.Tensor):
    """Rows ``order`` of a table (of each stream's table, for a fleet)."""
    return (lambda t: t[order]) if order.dim() == 1 else (lambda t: gather_streams(t, order))


def extract(
    state: VoxelHashMapState,
    config: VoxelHashMapConfig,
    center: torch.Tensor,
    distance: float = 100.0,
    out_capacity: int = 1 << 15,
    with_covs: bool = True,
    with_rgb: bool = False,
    with_intensity: bool = False,
    with_overflow: bool = False,
):
    """The voxels within the L-inf box of half-width ``distance`` around
    ``center [3]`` (a fleet's ``[B, 3]``) as a cloud of static capacity: centroid, matrix-exp of the
    mean log-covariance, attribute means, ``min_num_point`` filtering.

    When more voxels are in range than ``out_capacity``, the nearest to
    ``center`` are kept, and with ``with_overflow`` the count of the others
    is returned too: ``(cloud, n_overflow)``."""
    cnt_safe = torch.clamp_min(state.count, 1.0)
    centroid = state.sum_pos / cnt_safe[..., None]
    center = center[..., None, :]
    inside = ((centroid >= center - distance) & (centroid <= center + distance)).all(-1)
    keep = state.used & (state.count >= config.min_num_point) & inside

    dist_sq = ((centroid - center) ** 2).sum(-1)
    order, mask, n_overflow = compact_indices_ranked(keep, dist_sq, out_capacity)
    take = _taker(order)

    cnt = take(cnt_safe)
    covs = None
    if with_covs:
        covs = eigh3.spd_exp(_tri_unpack(take(state.sum_logcov) / cnt[..., None]))
    rgb = take(state.sum_rgba) / cnt[..., None] if with_rgb else None
    inten = take(state.sum_intensity) / cnt if with_intensity else None
    out = PointCloud(points=take(centroid), mask=mask, covs=covs, rgb=rgb, intensities=inten)
    if with_overflow:
        return out, n_overflow
    return out


def compute_overlap_ratio(
    state: VoxelHashMapState,
    config: VoxelHashMapConfig,
    cloud: PointCloud,
    sensor_pose: torch.Tensor,
) -> torch.Tensor:
    """Fraction of the cloud's points whose voxel exists in the map."""
    pts_map = transform_points(cloud.points, sensor_pose)
    coords, ok = voxel_coords(pts_map, cloud.mask, config.voxel_size)
    _, found = lookup_slots(state.coords, state.used, coords, ok, config.capacity, config.max_probes)
    n = torch.clamp_min(cloud.mask.sum(dtype=_F32), 1.0)
    return found.sum(dtype=_F32) / n
