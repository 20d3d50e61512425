"""Grid-bucket k-NN: sorted voxel buckets and a 27-cell neighbourhood search.

Counterpart of :mod:`sycl_points_tpu.ops.grid_knn`, the stand-in for the
reference's KD-tree and octree (``algorithms/knn/kdtree.hpp``,
``algorithms/knn/octree.hpp``):

  * build: the points are bucketed into cells of ``cell_size`` (the port's
    ``voxel_coords``), sorted by cell so that each cell is a contiguous slice
    (``sort_by_cell``), and each cell's (start, count) is stored in an
    open-addressing table keyed by its coordinates (``resolve_slots``);
  * search: each query (moved by ``pose`` first, when given) looks up the 27
    cells around its own, takes the first ``max_per_cell`` points of each
    and keeps the ``k`` nearest: :func:`grid_search`, the ``grid_knn`` kernel
    of ``csrc/grid_knn.cu`` on the card (``cuda_knn.grid_lanes`` lanes a
    query), :func:`grid_search_plain` on the CPU; :func:`grid_search_simple`
    is the kernel's first design (one thread a query), the reference it is
    timed against.

Results are exact for neighbours closer than ``cell_size`` (any such
neighbour lies in the 27 cells); farther ones may be missed (distance inf).
``overflow`` counts the points beyond a cell's budget and ``cells_dropped``
the cells the table could not hold; :meth:`GridKNN.build_auto` rebuilds until
both read 0 (one host read a build).

Indices refer to the ORIGINAL point order. A query with fewer than ``k``
candidates gets JAX's padding: ``argmin`` (k = 1) or ``top_k`` over +inf
takes the earliest candidate slots, so the padded entries are the original
indices of the first invalid slots in the order (cell offset, lane), with a
distance of +inf.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sycl_points_tpu_torch.mapping.hash_table import lookup_slots, resolve_slots
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops.knn import KNNResult
from sycl_points_tpu_torch.ops.transform import transform_points
from sycl_points_tpu_torch.ops.voxel import _SENTINEL, COORD_MASK, COORD_OFFSET, sort_by_cell, voxel_coords
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils.sync import to_host

# The 27 neighbour offsets in JAX's order: dx outer, dz inner.
OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


@dataclasses.dataclass(frozen=True)
class GridKNN:
    points: torch.Tensor  # [M, 3] sorted by cell
    mask: torch.Tensor  # [M]
    orig_idx: torch.Tensor  # [M] int32: sorted -> original index
    cell_coords: torch.Tensor  # [C, 3] int32 table keys
    cell_used: torch.Tensor  # [C] bool
    cell_start: torch.Tensor  # [C] int32 start into the sorted arrays
    cell_count: torch.Tensor  # [C] int32
    cell_size: float  # the f32 value of the cell size
    # points beyond the per-cell budget (invisible to searches) and cells
    # lost to probe exhaustion (0-dim int32 device tensors)
    overflow: torch.Tensor
    cells_dropped: torch.Tensor
    max_probes: int = 16
    max_per_cell: int = 32

    @staticmethod
    def build(
        cloud: PointCloud,
        cell_size: float,
        table_capacity: Optional[int] = None,
        max_probes: int = 16,
        max_per_cell: int = 32,
    ) -> "GridKNN":
        """Bucket the cloud into a table of ``table_capacity`` slots (a power
        of two; by default the cloud's capacity rounded up, at least 256)."""
        N = cloud.capacity
        dev = cloud.points.device
        cap = table_capacity or max(256, 1 << (N - 1).bit_length())
        coords, ok = voxel_coords(cloud.points, cloud.mask, cell_size)
        order, coords_s, ok_s, seg_id, _, _ = sort_by_cell(coords, ok)

        pos = torch.arange(N, dtype=torch.int32, device=dev)
        seg_start = torch.full((N,), N, dtype=torch.int32, device=dev).scatter_reduce_(0, seg_id, pos, "amin")
        seg_count = torch.zeros(N, dtype=torch.int32, device=dev).index_add_(0, seg_id, ok_s.to(torch.int32))
        seg_keys = coords_s[seg_start.clamp(0, N - 1).long()]
        seg_valid = seg_count > 0

        tbl_coords = torch.full((cap, 3), _SENTINEL, dtype=torch.int32, device=dev)
        tbl_used = torch.zeros(cap, dtype=torch.bool, device=dev)
        tbl_coords, tbl_used, slot, resolved = resolve_slots(tbl_coords, tbl_used, seg_keys, seg_valid, cap,
                                                             max_probes)
        tgt = torch.where(resolved, slot, cap)
        cell_start = torch.zeros(cap + 1, dtype=torch.int32, device=dev).index_copy_(0, tgt, seg_start)[:cap]
        cell_count = torch.zeros(cap + 1, dtype=torch.int32, device=dev).index_copy_(0, tgt, seg_count)[:cap]
        return GridKNN(
            points=cloud.points[order].contiguous(),
            mask=(cloud.mask[order] & ok_s).contiguous(),
            orig_idx=order.to(torch.int32),
            cell_coords=tbl_coords.contiguous(),
            cell_used=tbl_used.contiguous(),
            cell_start=cell_start.contiguous(),
            cell_count=cell_count.contiguous(),
            cell_size=float(np.float32(cell_size)),
            overflow=torch.clamp_min(seg_count - max_per_cell, 0).sum(dtype=torch.int32),
            cells_dropped=(seg_valid & ~resolved).sum(dtype=torch.int32),
            max_probes=max_probes,
            max_per_cell=max_per_cell,
        )

    @staticmethod
    def build_auto(
        cloud: PointCloud,
        cell_size: float,
        max_per_cell: int = 32,
        max_per_cell_cap: int = 256,
    ) -> "GridKNN":
        """Rebuild with a doubled per-cell budget or table capacity until the
        counters read 0 (or the budget reaches ``max_per_cell_cap``), so no
        point is silently invisible to searches; one host read a build."""
        cap = None
        for _ in range(8):
            g = GridKNN.build(cloud, cell_size=cell_size, table_capacity=cap, max_probes=16,
                              max_per_cell=max_per_cell)
            dropped, overflow = to_host(torch.stack([g.cells_dropped, g.overflow]))
            if dropped == 0 and (overflow == 0 or max_per_cell >= max_per_cell_cap):
                return g
            if dropped > 0:
                cap = 2 * (cap or g.cell_coords.shape[0])
            if overflow > 0 and max_per_cell < max_per_cell_cap:
                max_per_cell = min(2 * max_per_cell, max_per_cell_cap)
        return g

    @property
    def inv_cell(self) -> float:
        """``1 / cell_size`` as JAX's search computes it: an f32 division."""
        return float(np.float32(1.0) / np.float32(self.cell_size))

    def search(self, query_points: torch.Tensor, k: int, pose: Optional[torch.Tensor] = None) -> KNNResult:
        """27-cell bounded k-NN (``k <= 27 max_per_cell``; at most
        ``cuda_knn.MAX_K`` on the card); indices in the original order."""
        return KNNResult(*grid_search(self, query_points, k, pose))

    def radius_search(self, query_points, radius: float, max_k: int, pose=None) -> KNNResult:
        res = self.search(query_points, max_k, pose)
        within = res.distances <= radius * radius
        return KNNResult(torch.where(within, res.indices, -1), torch.where(within, res.distances, torch.inf))

    def remove_points(self, keep: torch.Tensor) -> "GridKNN":
        """Invalidate points without rebuilding (the reference's
        ``remove_nodes_by_flags``); ``keep`` is in the ORIGINAL order."""
        return dataclasses.replace(self, mask=self.mask & keep[self.orig_idx.long()])


def _query_coords(queries: torch.Tensor, inv: float):
    """``voxel_coords`` of the queries at the search's ``1 / cell_size``."""
    scaled = queries * inv
    finite = torch.isfinite(scaled).all(-1)
    floor = torch.nan_to_num(torch.floor(scaled), nan=0.0).clamp(-(2.0**30), 2.0**30)
    c = floor.to(torch.int32) + COORD_OFFSET
    ok = finite & ((c >= 0) & (c <= COORD_MASK)).all(-1)
    return torch.where(ok[:, None], c, _SENTINEL), ok


def grid_search_plain(grid: GridKNN, queries: torch.Tensor, k: int, pose: Optional[torch.Tensor] = None):
    """The search in plain PyTorch, as JAX writes it: the ``[Q, 27 P]``
    candidate slots in the order (cell offset, lane), +inf where a slot is
    empty or masked, then ``argmin`` (k = 1) or a stable ascending sort
    (``lax.top_k``'s order): ``(idx [Q, k] int32, d2 [Q, k] f32)``."""
    queries, valid, idx = grid_candidates(grid, queries, pose)
    e = grid.points[idx] - queries[:, None, :]
    d2 = torch.where(valid, e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2], torch.inf)
    orig = grid.orig_idx[idx]
    if k == 1:
        j = torch.argmin(d2, dim=1, keepdim=True)
    else:
        j = torch.sort(d2, dim=1, stable=True)[1][:, :k]
    return orig.gather(1, j).to(torch.int32), d2.gather(1, j)


def grid_candidates(grid: GridKNN, queries: torch.Tensor, pose: Optional[torch.Tensor] = None):
    """The search's candidate slots: ``(moved queries [Q, 3], valid [Q, 27
    P], sorted positions [Q, 27 P] clipped into [0, M))``."""
    if pose is not None:
        queries = transform_points(queries, pose)
    Q, M, P = queries.shape[0], grid.points.shape[0], grid.max_per_cell
    C = grid.cell_coords.shape[0]
    dev = queries.device
    qc, q_ok = _query_coords(queries, grid.inv_cell)
    offs = torch.tensor(OFFSETS, dtype=torch.int32, device=dev)
    cand = (qc[:, None, :] + offs[None]).reshape(-1, 3)
    slot, found = lookup_slots(grid.cell_coords, grid.cell_used, cand, q_ok.repeat_interleave(27), C,
                               grid.max_probes)
    slot = slot.clamp_min(0)
    start = torch.where(found, grid.cell_start[slot], 0).reshape(Q, 27)
    count = torch.where(found, grid.cell_count[slot], 0).reshape(Q, 27)
    lane = torch.arange(P, dtype=torch.int32, device=dev)
    valid = (lane[None, None] < torch.clamp_max(count, P)[:, :, None]).reshape(Q, 27 * P)
    idx = (start[:, :, None] + lane[None, None]).reshape(Q, 27 * P).clamp(0, M - 1).long()
    return queries, valid & grid.mask[idx], idx


def _check_search(grid: GridKNN, queries: torch.Tensor, k: int, pose: Optional[torch.Tensor]):
    """Check a search's arguments (k up to the 27 cells' slots, and up to
    ``cuda_knn.MAX_K`` on the card); returns the queries' device."""
    device = cuda_knn._check_queries(queries, pose, grid.points, grid.mask, grid.cell_coords)
    cuda_knn.check_k(k, "GridKNN.search", device, 27 * grid.max_per_cell)
    if grid.points.shape[0] == 0:
        raise ValueError("GridKNN.search needs a target of at least one row")
    return device


def _grid_launch(name: str, grid: GridKNN, queries: torch.Tensor, k: int, pose: Optional[torch.Tensor], device,
                 entry: str, extra=()):
    """Launch ``lib.<entry>`` (the grid kernels' shared arguments, then
    ``extra``) once on CUDA tensors, counted under ``name``."""
    cuda_knn._require_cuda(device, name)
    tensors = (queries, pose, grid.points, grid.mask, grid.orig_idx, grid.cell_coords, grid.cell_used,
               grid.cell_start, grid.cell_count)
    cuda_knn._require_contiguous(*tensors)
    C, Q, M = grid.cell_coords.shape[0], queries.shape[0], grid.points.shape[0]
    if C & (C - 1):
        raise ValueError(f"the grid's table capacity must be a power of two, got {C}")
    pose_ptr = None if pose is None else pose.data_ptr()
    return cuda_knn._launch(name, device, (Q, k), lambda lib, i, d, s: getattr(lib, entry)(
        queries.data_ptr(), Q, pose_ptr, grid.inv_cell, grid.points.data_ptr(), grid.mask.data_ptr(),
        grid.orig_idx.data_ptr(), M, grid.cell_coords.data_ptr(), grid.cell_used.data_ptr(),
        grid.cell_start.data_ptr(), grid.cell_count.data_ptr(), C, grid.max_probes, grid.max_per_cell, k, *extra,
        i, d, s))


def grid_search(grid: GridKNN, queries: torch.Tensor, k: int, pose: Optional[torch.Tensor] = None,
                lanes: Optional[int] = None):
    """:func:`grid_search_plain` through the ``grid_knn`` kernel
    (``csrc/grid_knn.cu``, ``lanes`` a query, by default
    ``cuda_knn.grid_lanes``'s choice) for CUDA tensors; CPU tensors run the
    plain version."""
    device = _check_search(grid, queries, k, pose)
    if lanes is not None and lanes not in cuda_knn.GRID_LANES:
        raise ValueError(f"grid_knn takes lanes in {cuda_knn.GRID_LANES}, got {lanes}")
    if device.type == "cpu":
        return grid_search_plain(grid, queries, k, pose)
    if lanes is None:
        lanes = cuda_knn.grid_lanes(queries.shape[0], cuda_knn._sm_count(device.index))
    return _grid_launch("grid_knn", grid, queries, k, pose, device, "spt_grid_knn", (lanes,))


def grid_search_simple(grid: GridKNN, queries: torch.Tensor, k: int, pose: Optional[torch.Tensor] = None):
    """:func:`grid_search` through the kernel's first design (one thread a
    query, ``csrc/grid_knn.cu``): the reference the lane-group kernel is
    held to and timed against; ``k <= 16``. CPU tensors run the plain
    version."""
    device = _check_search(grid, queries, k, pose)
    cuda_knn.check_fast_k(k, "grid_search_simple")
    if device.type == "cpu":
        return grid_search_plain(grid, queries, k, pose)
    return _grid_launch("grid_knn_simple", grid, queries, k, pose, device, "spt_grid_knn_simple")
