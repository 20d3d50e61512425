"""Coarse-to-fine candidate k-NN for very large target clouds.

Counterpart of :mod:`sycl_points_tpu.ops.coarse_knn`, the sub-linear tier
that takes the place of the reference's KD-tree
(``algorithms/knn/kdtree.hpp:424-562``):

  * build: one sort of the points by coarse cell (``sort_by_cell``), then
    segment reductions for each cell's centroid, covering radius, slice
    start and count, and the counters ``overflow`` (points beyond the
    per-cell budget L), ``cells_lost`` (cells beyond the capacity C) and
    ``points_lost`` (valid points outside the sort key's extent);
  * search: a ``[q, C]`` lower bound ``max(|q - centroid| - radius - margin,
    0)`` per query and cell from one f32 matrix product (``torch.matmul``,
    as JAX leaves it to XLA), the ``P + 1`` best cells per query in JAX's
    ``lax.top_k`` order (ascending bound, the lower cell index first on
    ties), then the refine over the ``P x L`` candidate points and the
    exactness certificate: :func:`coarse_refine`, the ``coarse_refine``
    kernel of ``csrc/coarse_knn.cu`` on the card, :func:`coarse_refine_plain`
    on the CPU.

A query is ``certified`` when its k-th distance is at most the bound of
every cell it did not search, every selected cell was searched whole, and
the build lost nothing; a certified result is exact. Indices refer to the
SORTED target layout (``points`` / ``mask``), as JAX's do.

The cell selection packs each bound's f32 bits (non-negative, so they order
as integers) above the cell index into one int64 key: the keys are unique,
so ``torch.topk`` on them returns JAX's order, ties included.
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
            max_per_cell=max_per_cell,
        )

    def select_cells(self, q: torch.Tensor, top_cells: int, margin: float, chunk: int = 2048):
        """The ``top_cells`` best cells of each query ``[Q, P]`` (int32, in
        order) and the best bound among the cells not selected ``[Q]`` (+inf
        when every cell is selected), ranked ``chunk`` queries at a time (the
        ``[chunk, C]`` bounds)."""
        parts = [self._select_chunk(q[s : s + chunk], top_cells, margin) for s in range(0, q.shape[0], chunk)]
        if not parts:
            return (torch.zeros((0, top_cells), dtype=torch.int32, device=q.device),
                    torch.zeros(0, device=q.device))
        return torch.cat([p[0] for p in parts]).contiguous(), torch.cat([p[1] for p in parts]).contiguous()

    def _select_chunk(self, q: torch.Tensor, top_cells: int, margin: float):
        C, P = self.centroids.shape[0], top_cells
        q2 = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2])[:, None]
        c = self.centroids
        c2 = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2])[None, :]
        d2c = torch.clamp_min(q2 + c2 - 2.0 * (q @ c.T), 0.0)
        lb = torch.clamp_min(torch.sqrt(d2c) - self.radii[None, :] - margin, 0.0)
        lb = torch.where(self.valid[None, :], lb, torch.inf).contiguous()
        take = P + 1 if P < C else P
        if take > C:
            raise ValueError(f"top_cells={P} exceeds the {C} cells")
        key = (lb.view(torch.int32).to(torch.int64) << 32) | torch.arange(C, device=q.device)
        sel = torch.topk(key, take, dim=1, largest=False, sorted=True)[0] & 0xFFFFFFFF
        if P < C:
            return sel[:, :P].to(torch.int32), lb.gather(1, sel[:, P:])[:, 0]
        return sel.to(torch.int32), torch.full((q.shape[0],), torch.inf, device=q.device)

    def search(self, query_points: torch.Tensor, k: int, pose: Optional[torch.Tensor] = None, top_cells: int = 8,
               chunk: int = 2048, margin: float = 1e-2):
        """Candidate search: ``(KNNResult, certified [Q] bool)``; squared
        distances, indices into the SORTED layout. ``margin`` is taken off
        every bound to absorb the product's f32 cancellation, so a borderline
        query reports uncertified, never falsely exact. The ranking runs in
        chunks of ``chunk`` queries (its ``[chunk, C]`` bounds); the refine
        is one launch for all queries."""
        q = query_points if pose is None else transform_points(query_points, pose)
        cells, lb_u = self.select_cells(q, top_cells, margin, chunk)
        idx, d2, cert = coarse_refine(self, q.contiguous(), cells, lb_u, k)
        return KNNResult(idx, d2), cert


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


def coarse_refine(ck: CoarseKNN, q: torch.Tensor, cells: torch.Tensor, lb_unexplored: torch.Tensor, k: int):
    """:func:`coarse_refine_plain` through the ``coarse_refine`` kernel
    (``csrc/coarse_knn.cu``) for CUDA tensors; CPU tensors run the plain
    version."""
    P, L = cells.shape[1], ck.max_per_cell
    if not 1 <= k <= min(cuda_knn.MAX_K, P * L):
        raise ValueError(f"CoarseKNN.search takes 1 <= k <= {cuda_knn.MAX_K}, got {k}")
    M, Q = ck.points.shape[0], q.shape[0]
    if M == 0:
        raise ValueError("CoarseKNN.search needs a target of at least one row")
    if cells.shape != (Q, P) or cells.dtype != torch.int32 or lb_unexplored.shape != (Q,):
        raise ValueError(f"expected [{Q}, P] int32 cells and [{Q}] bounds, got {tuple(cells.shape)} "
                         f"{cells.dtype}, {tuple(lb_unexplored.shape)}")
    device = cuda_knn._check_queries(q, None, cells, lb_unexplored, ck.points, ck.starts)
    if device.type == "cpu":
        return coarse_refine_plain(ck, q, cells, lb_unexplored, k)
    cuda_knn._require_cuda(device, "coarse_refine")
    cuda_knn._require_contiguous(q, cells, lb_unexplored, ck.points, ck.mask, ck.starts, ck.counts, ck.valid,
                                 ck.cells_lost, ck.points_lost)
    cert = torch.empty(Q, dtype=torch.bool, device=device)
    idx, d2 = cuda_knn._launch("coarse_refine", device, (Q, k), lambda lib, i, d, s: lib.spt_coarse_refine(
        q.data_ptr(), Q, cells.data_ptr(), P, lb_unexplored.data_ptr(), ck.points.data_ptr(), ck.mask.data_ptr(),
        M, ck.starts.data_ptr(), ck.counts.data_ptr(), ck.valid.data_ptr(), L, ck.cells_lost.data_ptr(),
        ck.points_lost.data_ptr(), k, i, d, cert.data_ptr(), s))
    return idx, d2, cert
