"""Occupancy-grid map on the device: a log-odds voxel hash with free-space
ray carving (the submap's default backend).

Counterpart of :mod:`sycl_points_tpu.mapping.occupancy_grid`, in plain
PyTorch (the JAX side computes it in XLA ops outside any Pallas kernel). The
table is the voxel-hash map's (:mod:`.hash_table`), and a voxel holds a
log-odds occupancy beside the hit statistics (position sums, log-Euclidean
covariance sums, RGBA, intensity, hit count). An insert is

  1. hits: one sort and segment sum of the frame's points by voxel, then
     :func:`~.hash_table.resolve_slots` and ``index_add_`` into the table;
  2. free space: the closed-form carve (:func:`_ray_carve_keys`) lists every
     voxel strictly between the sensor and each (length-clamped) return as a
     packed int32 key relative to the origin's voxel; the keys are merged to
     unique voxels with their counts (:func:`_merge_miss_keys`), the origin's
     voxel joins as one row, and :func:`~.hash_table.resolve_slots_tiered`
     finds their slots;
  3. the frame's pending log-odds (hits and misses) are added once and
     clamped; stale voxels are pruned.

The state is a frozen dataclass of tensors and every function returns a new
one, as in :mod:`.voxel_hash_map`, so that an insert that dropped
contributions can be retried on a grown table.

What differs from the JAX side, and why: XLA converts inf to int32 by
saturating and NaN to 0, which PyTorch leaves undefined (and the CPU and the
card differ), so every float-to-int conversion of the carve clamps in float
first (:func:`_floor_int`); the values that differ from XLA's lie only in
rows that emit nothing. ``lax.cond`` on the carve cycle becomes a counted
host read, made only when ``free_space_update_cycle > 1``.

A fleet's grids are stacked as the voxel-hash map's are
(:func:`~.voxel_hash_map.stack_streams`): :func:`add_point_cloud` takes
clouds ``[B, N]`` and poses ``[B, 4, 4]`` and carves, merges and resolves
every stream at once (the carve keys are relative to each stream's own
origin; the merge sorts each stream's row); :func:`extract_occupied_points`,
:func:`grow`, :func:`load_factor` and :func:`prune_stale_voxels` take the
stacked state. Stream ``b``'s result equals a single-stream call bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.mapping.hash_table import (
    compact_indices,
    compact_indices_ranked,
    lookup_slots,
    resolve_slots,
    resolve_slots_tiered,
)
from sycl_points_tpu_torch.mapping.voxel_hash_map import (
    _add_rows,
    _flat_rows,
    _segments,
    _set_rows,
    _taker,
    _tri_pack,
    _tri_unpack,
    stack_streams,
)
from sycl_points_tpu_torch.ops.transform import rotate_covs, transform_points
from sycl_points_tpu_torch.ops.voxel import (
    _SENTINEL,
    COORD_MASK,
    COORD_OFFSET,
    voxel_coords,
    voxel_coords_counted,
)
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils import eigh3
from sycl_points_tpu_torch.utils.sync import to_host

_F32 = torch.float32
_I32 = torch.int32
_EPS = float(torch.finfo(torch.float32).eps)
_BIG = 3.0e38  # finite: avoids 0 * inf NaNs downstream
_INT_CLAMP = float(2**30)


def probability_to_log_odds(p: float) -> float:
    return math.log(p / (1.0 - p))


@dataclasses.dataclass(frozen=True)
class OccupancyGridConfig:
    voxel_size: float = 1.0
    capacity: int = 1 << 18  # slots (power of two)
    max_probes: int = 32
    log_odds_hit: float = 0.85
    log_odds_miss: float = -0.4
    min_log_odds: float = -4.0
    max_log_odds: float = 4.0
    occupancy_threshold_log_odds: float = 0.0  # p = 0.5
    stale_frame_threshold: int = 100
    free_space_updates_enabled: bool = True
    # Carve free space every k-th insert; hits integrate every insert.
    free_space_update_cycle: int = 1
    voxel_pruning_enabled: bool = True
    # Bound on the voxels a ray crosses; 0 derives it from max_ray_distance.
    # Rays cut short by a set bound are counted in state.truncated_rays.
    max_ray_steps: int = 0
    max_ray_distance: float = 50.0
    # Per-frame bound on the unique free-space voxels of the carve merge;
    # the excess is counted in state.budget_lost.
    miss_budget: int = 1 << 17

    @property
    def ray_step_budget(self) -> int:
        """Crossings of a ray of length max_ray_distance, at most (the
        merged-order DDA of :func:`extract_visible_points`)."""
        if self.max_ray_steps > 0:
            return self.max_ray_steps
        return int(math.ceil(math.sqrt(3.0) * self.max_ray_distance / self.voxel_size)) + 3

    @property
    def ray_axis_budget(self) -> int:
        """Crossings of one axis by a ray no longer than max_ray_distance, at
        most: ceil(L / voxel) + 1 (an exact bound, so the carve truncates
        nothing unless max_ray_steps caps it)."""
        n = int(math.ceil(self.max_ray_distance / self.voxel_size)) + 2
        if self.max_ray_steps > 0:
            n = min(n, self.max_ray_steps + 1)
        if 2 * n + 2 > 1290:  # (2n+2)^3 must fit an int32 packed key
            raise ValueError(
                f"max_ray_distance/voxel_size = {self.max_ray_distance / self.voxel_size:.0f} "
                "exceeds the int32 packed-key budget (642 cells); raise voxel_size, "
                "lower max_ray_distance, or set max_ray_steps to bound the carve"
            )
        return n

    @property
    def miss_merge_budget(self) -> int:
        return min(self.miss_budget, self.capacity)


@dataclasses.dataclass(frozen=True)
class OccupancyGridState:
    coords: torch.Tensor  # [C, 3] int32 voxel coords; _SENTINEL when empty
    used: torch.Tensor  # [C] bool
    log_odds: torch.Tensor  # [C]
    sum_pos: torch.Tensor  # [C, 3] hit positions
    hit_count: torch.Tensor  # [C] float32
    sum_logcov: torch.Tensor  # [C, 6]
    sum_rgba: torch.Tensor  # [C, 4]
    sum_intensity: torch.Tensor  # [C]
    last_update: torch.Tensor  # [C] int32 frame stamp
    frame: torch.Tensor  # scalar int32
    dropped: torch.Tensor  # scalar int32: contributions lost to probe exhaustion
    truncated_rays: torch.Tensor  # scalar int32: rays cut short by max_ray_steps
    # scalar int32: contributions lost to fixed budgets that a larger table
    # cannot raise (the miss-merge budget, the extent and coordinate range);
    # kept apart from ``dropped`` so the growth policy never retries them.
    budget_lost: torch.Tensor
    # scalar int32: rays longer than max_ray_distance whose carve was clamped
    # to that length (their hits still count at full range).
    clamped_rays: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.coords.device


_TABLE_FIELDS = ("log_odds", "sum_pos", "hit_count", "sum_logcov", "sum_rgba", "sum_intensity", "last_update")


def create(config: OccupancyGridConfig, device: torch.device | str = "cuda") -> OccupancyGridState:
    """An empty map on ``device`` (the card unless the caller asks for the
    CPU)."""
    dev = require_device(device)
    C = config.capacity

    def zeros(*shape, dtype=_F32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return OccupancyGridState(
        coords=torch.full((C, 3), _SENTINEL, dtype=_I32, device=dev),
        used=zeros(C, dtype=torch.bool),
        log_odds=zeros(C),
        sum_pos=zeros(C, 3),
        hit_count=zeros(C),
        sum_logcov=zeros(C, 6),
        sum_rgba=zeros(C, 4),
        sum_intensity=zeros(C),
        last_update=zeros(C, dtype=_I32),
        frame=zeros(dtype=_I32),
        dropped=zeros(dtype=_I32),
        truncated_rays=zeros(dtype=_I32),
        budget_lost=zeros(dtype=_I32),
        clamped_rays=zeros(dtype=_I32),
    )


def _floor_int(x: torch.Tensor) -> torch.Tensor:
    """``floor(x)`` as int32, defined for inf and NaN (clamped in float first)."""
    return torch.floor(torch.nan_to_num(x, nan=0.0).clamp(-_INT_CLAMP, _INT_CLAMP)).to(_I32)


def _ceil_int(x: torch.Tensor) -> torch.Tensor:
    return torch.ceil(torch.nan_to_num(x, nan=0.0).clamp(-_INT_CLAMP, _INT_CLAMP)).to(_I32)


def _ray_setup(origin: torch.Tensor, targets: torch.Tensor, voxel_size: float):
    """Voxel-space DDA setup of the rays from ``origin`` to ``targets``:
    origin and target voxels, the step sign, and the parameter ``t`` of each
    axis's first boundary crossing and the spacing of the others (t = 0 at
    the origin, 1 at the target; ``_BIG`` on an axis the ray does not move
    along)."""
    inv = 1.0 / voxel_size
    so = origin * inv
    st = targets * inv
    i0 = torch.floor(so).to(_I32)
    it = _floor_int(st)
    d = st - so
    abs_d = d.abs()
    step = torch.sign(d).to(_I32)
    inv_mag = torch.where(abs_d > _EPS, 1.0 / torch.clamp_min(abs_d, _EPS), _BIG)
    frac = so - torch.floor(so)
    t0 = torch.where(step != 0, torch.where(step > 0, 1.0 - frac, frac) * inv_mag, _BIG)
    dt = torch.where(step != 0, inv_mag, _BIG)
    return i0, it, step, t0, dt


def _dda_ray_coords(origin: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor, voxel_size: float,
                    max_steps: int):
    """Exclusive 3-D DDA: the voxel coordinates strictly between ``origin``
    and each target, ``[N, S, 3]`` with a validity mask. The ``S`` first
    boundary crossings of each ray come from one stable sort of its 3 S
    candidate crossings (ties in axis order), and a cumulative sum of the
    axis steps gives the voxels in walk order.

    Returns ``(coords, emit, origin_coord, target_coords, truncated)``."""
    S = max_steps
    N = targets.shape[0]
    dev = targets.device
    i0, it, step, t0, dt = _ray_setup(origin, targets, voxel_size)
    j = torch.arange(S, dtype=_F32, device=dev)
    t_all = t0[:, :, None] + dt[:, :, None] * j
    t_all = torch.where(t_all < 1.0, t_all, _BIG)
    t_sorted, perm = torch.sort(t_all.reshape(N, 3 * S), dim=1, stable=True)
    t_s = t_sorted[:, :S]
    axis_s = perm[:, :S] // S  # the flat layout holds axis 0's S crossings first
    crossed = t_s < 1.0
    onehot = torch.nn.functional.one_hot(axis_s, 3).to(_I32) * crossed[:, :, None]
    pos = i0 + torch.cumsum(onehot * step[:, None, :], dim=1, dtype=_I32)

    reached = (pos == it[:, None, :]).all(-1)
    emit = valid[:, None] & crossed & ~reached
    # The crossing count of a straight segment is the Manhattan distance of
    # its end voxels; beyond S the walk's tail is lost.
    truncated = valid & ((it - i0).abs().sum(1) > S)

    c = pos + COORD_OFFSET
    emit = emit & ((c >= 0) & (c <= COORD_MASK)).all(-1)
    c = torch.where(emit[..., None], c, _SENTINEL)
    return c, emit, i0 + COORD_OFFSET, it + COORD_OFFSET, truncated


def _ray_carve_keys(origin: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor, voxel_size: float,
                    axis_budget: int, max_len: float, step_limit: int = 0):
    """Packed int32 keys of the voxels strictly between ``origin`` and each
    target clamped to ``max_len``, without the merged-crossing sort.

    Closed-form DDA: crossing ``j`` of axis ``a`` happens at ``t = t0_a + j
    dt_a``; the voxel entered there is ``i0 + step n``, where ``n_b`` counts
    the crossings of axis ``b`` at or before ``t`` (ties in axis order, as
    the stable merged sort has them): a floor or a ceil of ``(t - t0_b) /
    dt_b``. ``axis_budget`` crossings an axis cover a clamped ray, so nothing
    is truncated unless ``step_limit`` (max_ray_steps) caps the merged order.
    Keys are packed relative to the origin's voxel, ``B = 2 axis_budget + 2``
    cells an axis.

    Returns ``(keys [N, 3 Sa] int32 (_SENTINEL when not emitted),
    origin_emit [N], origin_coord [3], base_coord [3], B, n_clamped,
    n_range_lost, n_truncated)``. A fleet's ``origin [B, 3]`` and ``targets
    [B, N, 3]`` give each stream's keys relative to its own origin, and the
    counts ``[B]``."""
    Sa = axis_budget
    B = 2 * Sa + 2
    N = targets.shape[-2]
    lead = targets.shape[:-2]
    dev = targets.device
    if lead:
        origin = origin[:, None, :]

    d = targets - origin
    L = torch.sqrt((d * d).sum(-1))
    clamped = valid & (L > max_len)
    scale = torch.where(L > max_len, max_len / torch.clamp_min(L, _EPS), 1.0)
    tgt = origin + d * scale[..., None]
    i0, it, step, t0, dt = _ray_setup(origin, tgt, voxel_size)
    nmax = (it - i0).abs()  # [N, 3] the exact crossing count of each axis

    ar = torch.arange(Sa, device=dev)
    t = t0[..., None] + dt[..., None] * ar.to(_F32)  # [N, 3, Sa]
    exists = ar < nmax[..., None]

    # crossings of axis b at or before t (a tie counts iff b <= a); b == a is j + 1
    x = (t[..., None] - t0[..., None, None, :]) / dt[..., None, None, :]  # [N, 3, Sa, 3]
    a_idx = torch.arange(3, device=dev)[None, :, None, None]
    b_idx = torch.arange(3, device=dev)[None, None, None, :]
    n = torch.where(b_idx < a_idx, _floor_int(x) + 1, _ceil_int(x))
    n = torch.where(b_idx == a_idx, (ar + 1).to(_I32)[None, None, :, None], n)
    n = torch.minimum(torch.clamp_min(n, 0), nmax[..., None, None, :])
    pos = i0[..., None, None, :] + step[..., None, None, :] * n  # [N, 3, Sa, 3]

    reached = (pos == it[..., None, None, :]).all(-1)
    emit = valid[..., None, None] & exists & ~reached

    # A manual step limit suppresses the crossings past it in merged order:
    # a crossing's rank is the count of crossings at or before it, sum_b n_b.
    n_truncated = torch.zeros(lead, dtype=_I32, device=dev)
    if step_limit > 0:
        rank = n.sum(-1) - 1
        over = exists & valid[..., None, None] & (rank >= step_limit)
        n_truncated = over.flatten(-2).any(-1).sum(-1, dtype=_I32)
        emit = emit & (rank < step_limit)

    base = i0 + COORD_OFFSET - (Sa + 1)  # carved cells lie in [base, base + B)
    window_ok = ((base >= 0) & (base + B <= COORD_MASK)).all(-1)
    rel = pos + COORD_OFFSET - base[..., None, None, :]
    in_b = ((rel >= 0) & (rel < B)).all(-1) & window_ok[..., None, None]
    n_range_lost = (emit & ~in_b).flatten(-3).sum(-1, dtype=_I32)
    emit = emit & in_b
    key = torch.where(emit, (rel[..., 0] * B + rel[..., 1]) * B + rel[..., 2], _SENTINEL)

    origin_coord = i0 + COORD_OFFSET
    origin_differs = (origin_coord != it + COORD_OFFSET).any(-1)
    origin_in_range = ((origin_coord >= 0) & (origin_coord <= COORD_MASK)).all(-1)
    origin_emit = valid & origin_differs & origin_in_range
    return (key.reshape(lead + (N, 3 * Sa)), origin_emit, origin_coord.reshape(lead + (3,)),
            base.reshape(lead + (3,)), B, clamped.sum(-1, dtype=_I32), n_range_lost, n_truncated)


def _decode_keys(rep: torch.Tensor, valid: torch.Tensor, B: int, base_coord: torch.Tensor) -> torch.Tensor:
    """Packed carve keys -> voxel coordinates ``[M, 3]`` int32, _SENTINEL
    where not ``valid``."""
    keys = torch.stack([rep // (B * B), (rep // B) % B, rep % B], dim=-1).to(_I32) + base_coord[..., None, :]
    return torch.where(valid[..., None], keys, _SENTINEL)


def _merge_miss_keys(keys_flat, capacity: int, B: int, base_coord):
    """The unique voxels of the flattened carve keys and their counts, in key
    order, at most ``capacity``: ``(keys [capacity, 3], cnt [capacity],
    n_lost)``; ``n_lost`` counts the occurrences of the unique voxels beyond
    ``capacity`` (a fixed-budget loss). Three interchangeable forms, equal on
    every input: run-length (the default), sort + segment sums, and a dense
    grid over the B^3 carve window."""
    return _merge_miss_keys_rle(keys_flat, capacity, B, base_coord)


def _sorted_runs(keys_flat):
    key_s = torch.sort(keys_flat).values
    okr = key_s != _SENTINEL
    new_seg = torch.ones_like(okr)
    new_seg[..., 1:] = key_s[..., 1:] != key_s[..., :-1]
    return key_s, okr, new_seg


def _merge_miss_keys_rle(keys_flat, capacity: int, B: int, base_coord):
    """Sort + run length, with no scatter: after the sort each unique voxel is
    a run and the sentinels are the tail; a second sort of the run-start
    positions (every other entry the sentinel) gives run ``r``'s start as its
    ``r``-th entry, and the run lengths are the differences of the starts."""
    K = keys_flat.shape[-1]
    lead = keys_flat.shape[:-1]
    dev = keys_flat.device
    key_s, okr, new_seg = _sorted_runs(keys_flat)
    n_valid = okr.sum(-1)[..., None]
    pos = torch.where(new_seg & okr, torch.arange(K, device=dev), _SENTINEL)
    pos_s = torch.sort(pos).values
    take = min(capacity + 1, K)
    starts = torch.minimum(pos_s[..., :take], n_valid)
    if take < capacity + 1:
        starts = torch.cat([starts, n_valid.expand(lead + (capacity + 1 - take,))], -1)
    cnt = (starts[..., 1:] - starts[..., :-1]).to(_F32)
    valid = cnt > 0.0
    rep = torch.where(valid, torch.gather(key_s, -1, torch.clamp_max(starts[..., :-1], K - 1)).to(torch.int64), 0)
    return _decode_keys(rep, valid, B, base_coord), cnt, (n_valid - starts[..., capacity:])[..., 0].to(_I32)


def _merge_miss_keys_sort(keys_flat, capacity: int, B: int, base_coord):
    """Sort + segment sums: the unique voxels beyond ``capacity`` share one
    overflow segment, whose occurrences are counted as lost."""
    key_s, okr, new_seg = _sorted_runs(keys_flat)
    seg_raw = torch.cumsum((new_seg & okr).to(torch.int64), 0) - 1
    n_lost = (okr & (seg_raw >= capacity)).sum(dtype=_I32)
    seg_id = torch.where(okr, torch.clamp_max(seg_raw, capacity), capacity)
    cnt = torch.zeros(capacity + 1, dtype=_F32, device=keys_flat.device)
    cnt.index_add_(0, seg_id, okr.to(_F32))
    rep = torch.full((capacity + 1,), _SENTINEL, dtype=torch.int64, device=keys_flat.device)
    rep.scatter_reduce_(0, seg_id, key_s.to(torch.int64), "amin")
    cnt, rep = cnt[:capacity], rep[:capacity]
    valid = cnt > 0.0
    return _decode_keys(torch.where(valid, rep, 0), valid, B, base_coord), cnt, n_lost


def _merge_miss_keys_dense(keys_flat, capacity: int, B: int, base_coord):
    """A count grid over the B^3 carve window, then its occupied cells in
    cell order (= key order)."""
    dev = keys_flat.device
    ncells = B * B * B
    k = keys_flat.to(torch.int64)
    dense = torch.zeros(ncells + 1, dtype=_F32, device=dev)
    dense.index_add_(0, torch.where((k >= 0) & (k < ncells), k, ncells), torch.ones_like(k, dtype=_F32))
    dense = dense[:ncells]
    occ = dense > 0.0
    rank = torch.cumsum(occ.to(torch.int64), 0) - 1
    n_lost = torch.where(occ & (rank >= capacity), dense, 0.0).sum().to(_I32)
    tgt = torch.where(occ & (rank < capacity), rank, capacity)
    rep = torch.full((capacity + 1,), -1, dtype=torch.int64, device=dev)
    rep.index_copy_(0, tgt, torch.arange(ncells, device=dev))
    rep = rep[:capacity]
    filled = rep >= 0
    cnt = torch.where(filled, dense[torch.clamp_min(rep, 0)], 0.0)
    return _decode_keys(torch.where(filled, rep, 0), filled, B, base_coord), cnt, n_lost


def add_point_cloud(
    state: OccupancyGridState,
    config: OccupancyGridConfig,
    cloud: PointCloud,
    sensor_pose: torch.Tensor,
) -> OccupancyGridState:
    """Insert a sensor-frame cloud seen from ``sensor_pose``: hits, the
    free-space carve, the pending log-odds with the clamp, pruning (a
    fleet's clouds from their poses)."""
    lead = cloud.points.shape[:-2]
    N = cloud.capacity
    C = config.capacity
    dev = cloud.device
    origin = sensor_pose[..., :3, 3]
    pose = sensor_pose[:, None] if lead else sensor_pose
    pts_map = transform_points(cloud.points, pose)
    coords, ok, n_range_lost = voxel_coords_counted(pts_map, cloud.mask, config.voxel_size)
    o = origin[..., None, :]
    ok = ok & (((pts_map - o) ** 2).sum(-1) > _EPS)  # a return at the sensor carves nothing

    def zeros(*tail):
        return torch.zeros(lead + (N,) + tail, dtype=_F32, device=dev)

    if cloud.covs is not None:
        logcov = _tri_pack(eigh3.spd_log(rotate_covs(cloud.covs, pose)))
    else:
        logcov = zeros(6)
    rgba = cloud.rgb if cloud.rgb is not None else zeros(4)
    inten = cloud.intensities if cloud.intensities is not None else zeros()
    payload = torch.cat([pts_map, logcov, rgba, inten[..., None], torch.ones_like(inten[..., None])], dim=-1)

    # ---- hits -----------------------------------------------------------------
    seg_keys, agg, n_extent_lost = _segments(payload, coords, ok)
    hit_cnt = agg[..., -1]
    seg_valid = hit_cnt > 0.0
    coords_tbl, used, slot, resolved = resolve_slots(
        state.coords, state.used, seg_keys, seg_valid, C, config.max_probes)
    tgt = _flat_rows(slot, resolved, C)
    pending = _add_rows(torch.zeros(lead + (C,), dtype=_F32, device=dev), tgt, hit_cnt * config.log_odds_hit, lead)
    fields = {
        "sum_pos": _add_rows(state.sum_pos, tgt, agg[..., 0:3], lead),
        "hit_count": _add_rows(state.hit_count, tgt, hit_cnt, lead),
        "sum_logcov": _add_rows(state.sum_logcov, tgt, agg[..., 3:9], lead),
        "sum_rgba": _add_rows(state.sum_rgba, tgt, agg[..., 9:13], lead),
        "sum_intensity": _add_rows(state.sum_intensity, tgt, agg[..., 13], lead),
    }
    last_update = _set_rows(state.last_update, tgt, state.frame[..., None].expand(lead + (N,)), lead)
    n_dropped = (seg_valid & ~resolved).sum(-1, dtype=_I32)
    n_budget_lost = n_range_lost + n_extent_lost
    n_truncated = n_clamped = torch.zeros(lead, dtype=_I32, device=dev)

    # ---- free space (misses) -----------------------------------------------
    cycle = config.free_space_update_cycle
    if config.free_space_updates_enabled and config.log_odds_miss != 0.0:
        # every stream carves on its cycle; the read is made only for a cycle
        due = torch.ones(lead, dtype=torch.bool, device=dev) if cycle <= 1 else state.frame % cycle == 0
    if (config.free_space_updates_enabled and config.log_odds_miss != 0.0
            and (cycle <= 1 or to_host(due.any()))):
        carve = ok & due[..., None]
        (miss_keys, origin_emit, origin_coord, base, B, n_clamped, carve_lost,
         n_truncated) = _ray_carve_keys(origin, pts_map, carve, config.voxel_size, config.ray_axis_budget,
                                        config.max_ray_distance, step_limit=config.max_ray_steps)
        # Every ray misses the origin's voxel unless a point hit it this
        # frame; the N misses of that one voxel join the merged keys as one
        # row, first (the carve never emits the origin's voxel).
        origin_hit = (ok & (coords == origin_coord[..., None, :]).all(-1)).any(-1)
        origin_cnt = torch.where(origin_hit, 0.0, origin_emit.sum(-1, dtype=_F32))
        m_keys, m_cnt, m_lost = _merge_miss_keys(miss_keys.reshape(lead + (-1,)), config.miss_merge_budget, B,
                                                 base)
        m_keys = torch.cat([origin_coord[..., None, :], m_keys], -2)
        m_cnt = torch.cat([origin_cnt[..., None], m_cnt], -1)
        m_valid = m_cnt > 0.0
        coords_tbl, used, m_slot, m_resolved = resolve_slots_tiered(
            coords_tbl, used, m_keys, m_valid, C, config.max_probes)
        m_tgt = _flat_rows(m_slot, m_resolved, C)
        pending = _add_rows(pending, m_tgt, m_cnt * config.log_odds_miss, lead)
        last_update = _set_rows(last_update, m_tgt, state.frame[..., None].expand(m_cnt.shape), lead)
        n_dropped = n_dropped + (m_valid & ~m_resolved).sum(-1, dtype=_I32)
        n_budget_lost = n_budget_lost + carve_lost + m_lost

    # ---- the frame's log-odds, clamped --------------------------------------
    log_odds = torch.where(
        used & (pending != 0.0),
        torch.clamp(state.log_odds + pending, config.min_log_odds, config.max_log_odds),
        state.log_odds,
    )
    new_state = OccupancyGridState(
        coords=coords_tbl, used=used, log_odds=log_odds, last_update=last_update, **fields,
        frame=state.frame + 1,
        dropped=state.dropped + n_dropped,
        truncated_rays=state.truncated_rays + n_truncated,
        budget_lost=state.budget_lost + n_budget_lost,
        clamped_rays=state.clamped_rays + n_clamped,
    )
    if config.voxel_pruning_enabled:
        new_state = prune_stale_voxels(new_state, config)
    return new_state


def prune_stale_voxels(state: OccupancyGridState, config: OccupancyGridConfig) -> OccupancyGridState:
    """Clear the voxels not updated within ``stale_frame_threshold`` frames."""
    keep = ~(state.used & (state.frame[..., None] - state.last_update > config.stale_frame_threshold))
    kf = keep.to(_F32)
    return dataclasses.replace(
        state,
        coords=torch.where(keep[..., None], state.coords, _SENTINEL),
        used=state.used & keep,
        log_odds=state.log_odds * kf,
        sum_pos=state.sum_pos * kf[..., None],
        hit_count=state.hit_count * kf,
        sum_logcov=state.sum_logcov * kf[..., None],
        sum_rgba=state.sum_rgba * kf[..., None],
        sum_intensity=state.sum_intensity * kf,
        last_update=torch.where(keep, state.last_update, 0),
    )


def voxel_count(state: OccupancyGridState) -> torch.Tensor:
    return state.used.sum(dtype=_I32)


def load_factor(state: OccupancyGridState, config: OccupancyGridConfig) -> torch.Tensor:
    """Occupied fraction of the table (the growth policy rehashes above 0.7);
    ``[B]`` for a fleet."""
    return state.used.sum(-1, dtype=_F32) / config.capacity


def grow(
    state: OccupancyGridState, config: OccupancyGridConfig, factor: int = 2
) -> tuple[OccupancyGridState, OccupancyGridConfig]:
    """Re-insert every used slot into a ``factor``-times-larger table (every
    stream's, for a fleet)."""
    lead = state.frame.shape
    new_config = dataclasses.replace(config, capacity=config.capacity * factor)
    new = create(new_config, state.device)
    if lead:
        new = stack_streams(new, lead[0])
    coords_tbl, used, slot, resolved = resolve_slots(
        new.coords, new.used, state.coords, state.used, new_config.capacity, new_config.max_probes)
    tgt = _flat_rows(slot, resolved, new_config.capacity)
    moved = dataclasses.replace(
        state, coords=coords_tbl, used=used,
        dropped=state.dropped + (state.used & ~resolved).sum(-1, dtype=_I32),
        **{f: _set_rows(getattr(new, f), tgt, getattr(state, f), lead) for f in _TABLE_FIELDS},
    )
    return moved, new_config


def add_point_cloud_auto(
    state: OccupancyGridState,
    config: OccupancyGridConfig,
    cloud: PointCloud,
    sensor_pose: torch.Tensor,
    max_load: float = 0.7,
    max_grow_steps: int = 8,
) -> tuple[OccupancyGridState, OccupancyGridConfig]:
    """Insertion with the growth policy, decided on the host: grow while the
    load factor exceeds ``max_load``, insert, and retry the same insert on a
    grown table when a contribution was dropped (the state from before the
    insert is kept, so a retried insert loses nothing)."""
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


def voxel_probability(state: OccupancyGridState, config: OccupancyGridConfig,
                      position: torch.Tensor) -> torch.Tensor:
    """Occupancy probability at a world position; 0.5 where unknown."""
    coords, ok = voxel_coords(position[None, :], torch.ones(1, dtype=torch.bool, device=position.device),
                              config.voxel_size)
    slot, found = lookup_slots(state.coords, state.used, coords, ok, config.capacity, config.max_probes)
    lo = torch.where(found[0], state.log_odds[torch.clamp_min(slot[0], 0)], 0.0)
    return torch.sigmoid(lo)


def _occupied_mask(state: OccupancyGridState, config: OccupancyGridConfig) -> torch.Tensor:
    return state.used & (state.hit_count > 0.0) & (state.log_odds >= config.occupancy_threshold_log_odds)


def extract_occupied_points(
    state: OccupancyGridState,
    config: OccupancyGridConfig,
    sensor_position: torch.Tensor,
    max_distance: float = 100.0,
    out_capacity: int = 1 << 15,
    with_covs: bool = False,
    with_rgb: bool = False,
    with_intensity: bool = False,
    with_overflow: bool = False,
):
    """The centroids of the occupied voxels within the L-inf box of
    half-width ``max_distance`` around the sensor, as a cloud of static
    capacity. When more are in range than ``out_capacity``, the nearest to
    the sensor are kept, and with ``with_overflow`` the count of the others
    is returned too: ``(cloud, n_overflow)``."""
    cnt_safe = torch.clamp_min(state.hit_count, 1.0)
    centroid = state.sum_pos / cnt_safe[..., None]
    sensor_position = sensor_position[..., None, :]
    inside = ((centroid - sensor_position).abs() <= max_distance).all(-1)
    keep = _occupied_mask(state, config) & inside
    dist_sq = ((centroid - sensor_position) ** 2).sum(-1)
    order, mask, n_overflow = compact_indices_ranked(keep, dist_sq, out_capacity)
    take = _taker(order)
    cnt = take(cnt_safe)
    covs = eigh3.spd_exp(_tri_unpack(take(state.sum_logcov) / cnt[..., None])) if with_covs else None
    out = PointCloud(
        points=take(centroid), mask=mask, covs=covs,
        rgb=take(state.sum_rgba) / cnt[..., None] if with_rgb else None,
        intensities=take(state.sum_intensity) / cnt if with_intensity else None,
    )
    if with_overflow:
        return out, n_overflow
    return out


def extract_visible_points(
    state: OccupancyGridState,
    config: OccupancyGridConfig,
    sensor_pose: torch.Tensor,
    max_distance: float,
    horizontal_fov: float,
    vertical_fov: float,
    out_capacity: int = 1 << 14,
) -> PointCloud:
    """[Experimental] The occupied voxels in the field of view within range
    that no occupied voxel hides from the sensor: a cone test, then a DDA
    walk of each candidate's ray looked up in the table."""
    horizontal_fov = min(max(horizontal_fov, 1e-3), math.pi - 1e-3)
    vertical_fov = min(max(vertical_fov, 1e-3), 2.0 * math.pi - 1e-3)

    sensor_pos = sensor_pose[:3, 3]
    cnt_safe = torch.clamp_min(state.hit_count, 1.0)
    centroid = state.sum_pos / cnt_safe[:, None]
    occupied = _occupied_mask(state, config)

    diff = centroid - sensor_pos
    in_range = (diff * diff).sum(-1) <= max_distance * max_distance
    local = diff @ sensor_pose[:3, :3]  # R^T diff, row-wise
    fwd = local[:, 0]
    h_norm = torch.sqrt(torch.clamp_min(fwd**2 + local[:, 1] ** 2, 1e-30))
    v_norm = torch.sqrt(torch.clamp_min(fwd**2 + local[:, 2] ** 2, 1e-30))
    cos_h = torch.clamp(fwd / h_norm, -1.0, 1.0)
    cos_v = torch.clamp(fwd / v_norm, -1.0, 1.0)
    in_fov = (cos_h >= math.cos(horizontal_fov * 0.5)) & (cos_v >= math.cos(vertical_fov * 0.5)) & (fwd > 0.0)

    order, sel_mask = compact_indices(occupied & in_range & in_fov, out_capacity)
    sel_centroid = centroid[order]
    S = config.ray_step_budget
    ray_coords, ray_emit, _, _, _ = _dda_ray_coords(sensor_pos, sel_centroid, sel_mask, config.voxel_size, S)
    flat_valid = ray_emit.reshape(-1)
    slot, found = lookup_slots(state.coords, state.used, ray_coords.reshape(-1, 3), flat_valid,
                               config.capacity, config.max_probes)
    blocked = found & occupied[torch.clamp_min(slot, 0)] & flat_valid
    visible = sel_mask & ~blocked.reshape(out_capacity, S).any(-1)
    return PointCloud(points=sel_centroid, mask=visible)


def compute_overlap_ratio(
    state: OccupancyGridState,
    config: OccupancyGridConfig,
    cloud: PointCloud,
    sensor_pose: torch.Tensor,
) -> torch.Tensor:
    """Fraction of the cloud's points that land in occupied voxels."""
    coords, ok = voxel_coords(transform_points(cloud.points, sensor_pose), cloud.mask, config.voxel_size)
    slot, found = lookup_slots(state.coords, state.used, coords, ok, config.capacity, config.max_probes)
    occ = _occupied_mask(state, config)[torch.clamp_min(slot, 0)] & found
    return occ.sum(dtype=_F32) / torch.clamp_min(cloud.mask.sum(dtype=_F32), 1.0)
