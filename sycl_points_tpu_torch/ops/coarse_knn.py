"""Coarse-to-fine candidate k-NN for very large target clouds.

Counterpart of :mod:`sycl_points_tpu.ops.coarse_knn`, the sub-linear tier
that takes the place of the reference's KD-tree
(``algorithms/knn/kdtree.hpp:424-562``):

  * build: one sort of the points by coarse cell (``sort_by_cell``), then
    segment reductions for each cell's centroid, covering radius, slice
    start and count, and the counters ``overflow`` (points beyond the
    per-cell budget L), ``cells_lost`` (cells beyond the capacity C) and
    ``points_lost`` (valid points outside the sort key's extent). The
    occupied cells are numbered ``0 .. occupied - 1`` (segment ids run in
    sorted order), and ``occupied`` is kept as a device scalar;
  * search: the lower bound ``max(|q - centroid| - radius - margin, 0)`` of
    each query and cell and the ``P + 1`` best cells per query in JAX's
    ``lax.top_k`` order (ascending bound, the lower cell index first on
    ties): :func:`coarse_rank`, the ``coarse_rank`` kernel of
    ``csrc/coarse_knn.cu`` on the card (the occupied cells only),
    :func:`rank_cells_plain` on the CPU; then the refine over the ``P x L``
    candidate points and the exactness certificate: :func:`coarse_refine`,
    the lane-group ``coarse_refine`` kernel on the card,
    :func:`coarse_refine_plain` on the CPU. Two launches on the card.

A query is ``certified`` when its k-th distance is at most the bound of
every cell it did not search, every selected cell was searched whole, and
the build lost nothing; a certified result is exact. Indices refer to the
SORTED target layout (``points`` / ``mask``), as JAX's do.

The ranking packs each bound's f32 bits (non-negative, so they order as
integers) above the cell index into one int64 key: the keys are unique, so
the smallest ``P + 1`` are JAX's order, ties included. Its plain version
writes ``q . c`` elementwise as ``(qx cx + qy cy) + qz cz``, the kernel's
order, where JAX (and :func:`rank_cells_matmul`, the first design kept for
timing) take it from a matrix product. The first refine design, one thread
a query, is :func:`coarse_refine_simple`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops.knn import KNNResult
from sycl_points_tpu_torch.ops.transform import transform_points
from sycl_points_tpu_torch.ops.voxel import segment_sum_sorted, sort_by_cell, voxel_coords
from sycl_points_tpu_torch.points.point_cloud import PointCloud


# Cells a query keeps in the card's ranking (its warp's list of up to 4 keys
# a lane), and the lane-group refine's threads a block.
RANK_MAX_TAKE = 128
REFINE_THREADS = 256


def _norm3(e: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2])


@dataclasses.dataclass(frozen=True)
class CoarseKNN:
    points: torch.Tensor  # [M, 3] sorted by cell
    mask: torch.Tensor  # [M] valid (sorted)
    centroids: torch.Tensor  # [C, 3]
    radii: torch.Tensor  # [C] covering radius of each cell
    starts: torch.Tensor  # [C] int32 slice start into the sorted arrays
    counts: torch.Tensor  # [C] int32
    valid: torch.Tensor  # [C] bool: cell occupied
    overflow: torch.Tensor  # 0-dim int32: points beyond the per-cell budget
    cells_lost: torch.Tensor  # 0-dim int32: cells beyond the capacity C
    points_lost: torch.Tensor  # 0-dim int32: valid points outside the sort key's extent
    occupied: torch.Tensor  # 0-dim int32: every occupied cell lies in [0, occupied)
    max_per_cell: int = 64

    @staticmethod
    def build(cloud: PointCloud, coarse_cell: float, cells_capacity: Optional[int] = None,
              max_per_cell: int = 64) -> "CoarseKNN":
        """One sort by cell, then segment reductions. The default capacity C
        is the cloud's capacity / 8 rounded up to a power of two (at least
        256)."""
        N = cloud.capacity
        dev = cloud.points.device
        C = cells_capacity or max(256, 1 << (max(N // 8, 1) - 1).bit_length())
        coords, ok = voxel_coords(cloud.points, cloud.mask, coarse_cell)
        order, _, ok_s, seg_id, _, n_lost = sort_by_cell(coords, ok)
        pts_s = cloud.points[order]

        # segment ids run contiguously in sorted order; cells from C on share
        # the overflow segment C
        lost_cells = torch.where(ok_s, seg_id, -1).max() + 1 - C
        seg_c = torch.clamp_max(seg_id, C)
        w = ok_s.to(torch.float32)
        moments = segment_sum_sorted(torch.cat([pts_s * w[:, None], w[:, None]], 1), seg_c, C + 1)
        counts_f = moments[:, 3]
        centroids = moments[:, :3] / torch.clamp_min(counts_f[:, None], 1.0)
        d_cent = _norm3(pts_s - centroids[seg_c]) * w
        radii = torch.zeros(C + 1, dtype=torch.float32, device=dev).scatter_reduce_(
            0, seg_c, d_cent, "amax", include_self=False)
        pos = torch.arange(N, dtype=torch.int32, device=dev)
        starts = torch.full((C + 1,), N, dtype=torch.int32, device=dev).scatter_reduce_(
            0, seg_c, torch.where(ok_s, pos, N), "amin")
        counts = counts_f.to(torch.int32)
        over = torch.clamp_min(counts[:C] - max_per_cell, 0).sum(dtype=torch.int32) + counts[C]
        return CoarseKNN(
            points=pts_s.contiguous(),
            mask=ok_s.contiguous(),
            centroids=centroids[:C].contiguous(),
            radii=torch.where(counts[:C] > 0, radii[:C], 0.0).contiguous(),
            starts=torch.clamp_max(starts[:C], N - 1).contiguous(),
            counts=counts[:C].contiguous(),
            valid=(counts[:C] > 0).contiguous(),
            overflow=over.to(torch.int32),
            cells_lost=torch.clamp_min(lost_cells, 0).to(torch.int32),
            points_lost=n_lost.to(torch.int32),
            occupied=torch.clamp(lost_cells + C, 0, C).to(torch.int32),
            max_per_cell=max_per_cell,
        )

    def select_cells(self, q: torch.Tensor, top_cells: int, margin: float, chunk: int = 2048):
        """The ``top_cells`` best cells of each query ``[Q, P]`` (int32, in
        order) and the best bound among the cells not selected ``[Q]`` (+inf
        when every cell is selected): :func:`coarse_rank` (one launch on the
        card; ``chunk`` queries at a time on the CPU)."""
        return coarse_rank(self, q, top_cells, margin, chunk)

    def search(self, query_points: torch.Tensor, k: int, pose: Optional[torch.Tensor] = None, top_cells: int = 8,
               chunk: int = 2048, margin: float = 1e-2):
        """Candidate search: ``(KNNResult, certified [Q] bool)``; squared
        distances, indices into the SORTED layout. ``margin`` is taken off
        every bound to absorb the f32 cancellation of ``q2 + c2 - 2 q.c``, so
        a borderline query reports uncertified, never falsely exact. On the
        card the ranking and the refine are one launch each; on the CPU the
        ranking runs in chunks of ``chunk`` queries (its ``[chunk, C]``
        bounds)."""
        q = query_points if pose is None else transform_points(query_points, pose)
        cells, lb_u = self.select_cells(q, top_cells, margin, chunk)
        idx, d2, cert = coarse_refine(self, q.contiguous(), cells, lb_u, k)
        return KNNResult(idx, d2), cert


def _rank_keys(ck: CoarseKNN, q: torch.Tensor, margin: float, matmul: bool) -> torch.Tensor:
    """The ``[q, C]`` int64 keys (bound bits << 32 | cell) of a chunk."""
    C = ck.centroids.shape[0]
    q2 = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2])[:, None]
    c = ck.centroids
    c2 = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2])[None, :]
    if matmul:
        qc = q @ c.T
    else:
        qc = q[:, None, 0] * c[None, :, 0] + q[:, None, 1] * c[None, :, 1] + q[:, None, 2] * c[None, :, 2]
    d2c = torch.clamp_min(q2 + c2 - 2.0 * qc, 0.0)
    lb = torch.clamp_min(torch.sqrt(d2c) - ck.radii[None, :] - margin, 0.0)
    lb = torch.where(ck.valid[None, :], lb, torch.inf).contiguous()
    return (lb.view(torch.int32).to(torch.int64) << 32) | torch.arange(C, device=q.device)


def _rank_take(C: int, P: int) -> int:
    """Keys a query keeps: ``P + 1`` (the last one's bound is the unexplored
    bound), or all ``P == C`` cells."""
    if not 1 <= P <= C:
        raise ValueError(f"top_cells={P} must lie in [1, {C}], the cells")
    return P + 1 if P < C else P


def _rank_chunks(ck: CoarseKNN, q: torch.Tensor, top_cells: int, margin: float, chunk: int, matmul: bool):
    C, P = ck.centroids.shape[0], top_cells
    take = _rank_take(C, P)
    cells, lbs = [], []
    for s in range(0, q.shape[0], chunk):
        key = _rank_keys(ck, q[s : s + chunk], margin, matmul)
        sel = torch.topk(key, take, dim=1, largest=False, sorted=True)[0]
        cells.append((sel[:, :P] & 0xFFFFFFFF).to(torch.int32))
        if P < C:
            lbs.append((sel[:, P] >> 32).to(torch.int32).view(torch.float32))
        else:
            lbs.append(torch.full((sel.shape[0],), torch.inf, device=q.device))
    if not cells:
        return (torch.zeros((0, P), dtype=torch.int32, device=q.device), torch.zeros(0, device=q.device))
    return torch.cat(cells).contiguous(), torch.cat(lbs).contiguous()


def rank_cells_plain(ck: CoarseKNN, q: torch.Tensor, top_cells: int, margin: float, chunk: int = 2048):
    """The ranking in plain PyTorch, ``chunk`` queries at a time: each
    query's ``[C]`` bounds, ``q . c`` written elementwise in the kernel's
    order, and the ``top_cells + 1`` smallest int64 keys: ``(cells [Q, P]
    int32, lb_unexplored [Q])``."""
    return _rank_chunks(ck, q, top_cells, margin, chunk, matmul=False)


def rank_cells_matmul(ck: CoarseKNN, q: torch.Tensor, top_cells: int, margin: float, chunk: int = 2048):
    """The ranking's first design on the card, kept to time the kernel
    against: ``q . c`` from one f32 matrix product (``torch.matmul``, as JAX
    leaves it to XLA) and ``torch.topk`` over every cell's key, ``chunk``
    queries at a time (a ``[chunk, C]`` matrix each). The product may round
    ``q . c`` otherwise than :func:`rank_cells_plain`, so a bound can differ
    in its last bits."""
    return _rank_chunks(ck, q, top_cells, margin, chunk, matmul=True)


def coarse_rank(ck: CoarseKNN, q: torch.Tensor, top_cells: int, margin: float, chunk: int = 2048):
    """:func:`rank_cells_plain` through the ``coarse_rank`` kernel
    (``csrc/coarse_knn.cu``: a warp a query over the occupied cells, one
    launch) for CUDA tensors; CPU tensors run the plain version in chunks
    of ``chunk`` queries. On the card ``top_cells + 1`` (``top_cells`` when
    it equals C) is at most :data:`RANK_MAX_TAKE`."""
    C, Q = ck.centroids.shape[0], q.shape[0]
    if q.shape != (Q, 3) or q.dtype != torch.float32:
        raise ValueError(f"expected [Q, 3] float32 queries, got {tuple(q.shape)} {q.dtype}")
    take = _rank_take(C, top_cells)
    device = cuda_knn._check_queries(q, None, ck.centroids, ck.radii, ck.valid)
    if device.type == "cpu":
        return rank_cells_plain(ck, q, top_cells, margin, chunk)
    cuda_knn._require_cuda(device, "coarse_rank")
    if take > RANK_MAX_TAKE:
        raise ValueError(f"coarse_rank on the card keeps at most {RANK_MAX_TAKE} cells a query (top_cells + 1), "
                         f"got {take}; the CPU path is unbounded")
    q = q.contiguous()
    cuda_knn._require_contiguous(ck.centroids, ck.radii, ck.valid, ck.occupied)
    cells = torch.empty((Q, top_cells), dtype=torch.int32, device=device)
    lb = torch.empty(Q, dtype=torch.float32, device=device)
    if Q == 0:
        return cells, lb
    cuda_knn._run("coarse_rank", device, lambda lib, s: lib.spt_coarse_rank(
        q.data_ptr(), Q, ck.centroids.data_ptr(), ck.radii.data_ptr(), ck.valid.data_ptr(), C, ck.occupied.data_ptr(),
        margin, top_cells, cells.data_ptr(), lb.data_ptr(), s))
    return cells, lb


def coarse_refine_plain(ck: CoarseKNN, q: torch.Tensor, cells: torch.Tensor, lb_unexplored: torch.Tensor, k: int):
    """The refine and the certificate in plain PyTorch, as JAX writes them:
    the ``[q, P L]`` candidate slots (cell order, then lane), +inf where a
    slot is out of its cell, masked or in an empty cell, then ``argmin``
    (k = 1) or a stable ascending sort: ``(idx [q, k] int32 (sorted
    layout), d2 [q, k], certified [q])``."""
    L, cl = ck.max_per_cell, cells.long()
    ok, idx = coarse_candidates(ck, cells)
    e = ck.points[idx] - q[:, None, None, :]
    d2 = torch.where(ok, e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2], torch.inf)
    d2f, idxf = d2.reshape(q.shape[0], -1), idx.reshape(q.shape[0], -1)
    if k == 1:
        j = torch.argmin(d2f, dim=1, keepdim=True)
    else:
        j = torch.sort(d2f, dim=1, stable=True)[1][:, :k]
    dk, ik = d2f.gather(1, j), idxf.gather(1, j)
    kth = torch.sqrt(torch.where(torch.isfinite(dk[:, -1]), dk[:, -1], torch.inf))
    complete = (ck.counts[cl] <= L).all(1)
    certified = (kth <= lb_unexplored) & complete & (ck.cells_lost == 0) & (ck.points_lost == 0)
    return ik.to(torch.int32), dk, certified


def coarse_candidates(ck: CoarseKNN, cells: torch.Tensor):
    """The refine's candidate slots: ``(valid [q, P, L], sorted positions
    [q, P, L] clipped into [0, M))``."""
    L, M = ck.max_per_cell, ck.points.shape[0]
    cl = cells.long()
    lane = torch.arange(L, dtype=torch.int32, device=cells.device)
    idx = (ck.starts[cl][:, :, None] + lane).clamp(0, M - 1).long()
    return (lane < ck.counts[cl][:, :, None]) & ck.mask[idx] & ck.valid[cl][:, :, None], idx


def _check_refine(ck: CoarseKNN, q: torch.Tensor, cells: torch.Tensor, lb_unexplored: torch.Tensor, k: int,
                  name: str):
    """Check a refine's arguments; returns the device."""
    P, L = cells.shape[1], ck.max_per_cell
    M, Q = ck.points.shape[0], q.shape[0]
    if cells.shape != (Q, P) or cells.dtype != torch.int32 or lb_unexplored.shape != (Q,):
        raise ValueError(f"expected [{Q}, P] int32 cells and [{Q}] bounds, got {tuple(cells.shape)} "
                         f"{cells.dtype}, {tuple(lb_unexplored.shape)}")
    device = cuda_knn._check_queries(q, None, cells, lb_unexplored, ck.points, ck.starts)
    cuda_knn.check_k(k, name, device, P * L)
    if M == 0:
        raise ValueError("CoarseKNN.search needs a target of at least one row")
    return device


def _refine_launch(name: str, entry: str, ck: CoarseKNN, q, cells, lb_unexplored, k: int, device, extra=()):
    """Launch ``lib.<entry>`` (the refine kernels' shared arguments, then
    ``extra``) once on CUDA tensors, counted under ``name``."""
    cuda_knn._require_cuda(device, name)
    cuda_knn._require_contiguous(q, cells, lb_unexplored, ck.points, ck.mask, ck.starts, ck.counts, ck.valid,
                                 ck.cells_lost, ck.points_lost)
    M, Q, P = ck.points.shape[0], q.shape[0], cells.shape[1]
    cert = torch.empty(Q, dtype=torch.bool, device=device)
    idx, d2 = cuda_knn._launch(name, device, (Q, k), lambda lib, i, d, s: getattr(lib, entry)(
        q.data_ptr(), Q, cells.data_ptr(), P, lb_unexplored.data_ptr(), ck.points.data_ptr(), ck.mask.data_ptr(),
        M, ck.starts.data_ptr(), ck.counts.data_ptr(), ck.valid.data_ptr(), ck.max_per_cell, ck.cells_lost.data_ptr(),
        ck.points_lost.data_ptr(), k, *extra, i, d, cert.data_ptr(), s))
    return idx, d2, cert


def coarse_refine(ck: CoarseKNN, q: torch.Tensor, cells: torch.Tensor, lb_unexplored: torch.Tensor, k: int,
                  lanes: Optional[int] = None):
    """:func:`coarse_refine_plain` through the lane-group ``coarse_refine``
    kernel (``csrc/coarse_knn.cu``, ``lanes`` a query, by default
    ``cuda_knn.refine_lanes``'s choice; ``k <= cuda_knn.MAX_K``) for CUDA
    tensors; CPU tensors run the plain version (``k <= P L``)."""
    device = _check_refine(ck, q, cells, lb_unexplored, k, "CoarseKNN.search")
    if lanes is not None and lanes not in cuda_knn.GRID_LANES:
        raise ValueError(f"coarse_refine takes lanes in {cuda_knn.GRID_LANES}, got {lanes}")
    if device.type == "cpu":
        return coarse_refine_plain(ck, q, cells, lb_unexplored, k)
    P, L = cells.shape[1], ck.max_per_cell
    if P * L >= 2**31 - 1:
        raise ValueError(f"coarse_refine numbers its P x L = {P * L} slots in int32")
    if lanes is None:
        lanes = cuda_knn.refine_lanes(P * L, k)
    smem = 4 * (REFINE_THREADS // lanes) * (2 * P + 1 + cuda_knn.instance_k(k))
    if smem > cuda_knn.SMEM_BYTES:
        raise ValueError(f"coarse_refine keeps 2 P + 1 + K ints a query in shared memory: {smem} B a block at "
                         f"P={P}, {lanes} lanes, above {cuda_knn.SMEM_BYTES}")
    return _refine_launch("coarse_refine", "spt_coarse_refine", ck, q, cells, lb_unexplored, k, device, (lanes,))


def coarse_refine_simple(ck: CoarseKNN, q: torch.Tensor, cells: torch.Tensor, lb_unexplored: torch.Tensor, k: int):
    """:func:`coarse_refine` through its first design (one thread a query,
    ``csrc/coarse_knn.cu``; ``k <= 16``): the reference the lane-group
    refine is timed against. CPU tensors run the plain version."""
    device = _check_refine(ck, q, cells, lb_unexplored, k, "coarse_refine_simple")
    cuda_knn.check_fast_k(k, "coarse_refine_simple")
    if device.type == "cpu":
        return coarse_refine_plain(ck, q, cells, lb_unexplored, k)
    return _refine_launch("coarse_refine_simple", "spt_coarse_refine_simple", ck, q, cells, lb_unexplored, k, device)
