"""Range-image k-NN: the neighbour search of a raw spinning-LiDAR scan in O(N).

Counterpart of :mod:`sycl_points_tpu.ops.range_image_knn`. Every return of a
spinning LiDAR lies in one (azimuth column, elevation ring) cell, so the scan
is scattered into a dense ``[n_az, n_rings]`` range image and each point's k
nearest neighbours are sought among the points of a small cell window around
its own cell (azimuth circular, elevation not): 117 candidate cells at the
default window (6, 4) instead of the whole cloud.

  1. azimuth and elevation bins (center-offset bins; the elevation span is the
     scan's masked min and max unless ``el_min`` / ``el_max`` are given);
  2. the occupancy (one scatter-add, ``collisions`` counts the points that
     share a cell with another) and the dense image: a cell holds the point of
     the highest index that falls in it, as the JAX scatter leaves it on the
     CPU (a scatter-max of the index, so the card gives the same winner);
  3. the window distances and the k smallest of each cell (k at most the
     window's ``(2 window_az + 1)(2 window_el + 1)`` candidates, as JAX's
     ``top_k`` takes; a larger k raises a ``ValueError`` on every path):
     :func:`range_image_window`, the ``range_image`` kernel of
     ``csrc/range_image.cu`` on the card (a shared-memory tile of
     :func:`range_image_tile` azimuth columns a block; a thread a cell up to
     k = 16, a warp a cell above), :func:`range_image_window_plain` on the
     CPU; :func:`range_image_window_simple` is the kernel's first design (one
     thread a cell, k <= 16) and :func:`range_image_window_spill` the
     one-thread tile above 16, the references they are timed against;
  4. each point reads its cell's row; missing slots and invalid points fall
     back to the point itself at an infinite distance.

On the CPU, :func:`range_image_knn` runs the plain sequence
(:func:`range_image`, :func:`range_image_window`, :func:`point_rows`). On a
CUDA tensor it runs as a memset and four hand-written kernels of
``csrc/range_image.cu``, equal to the plain sequence bit for bit: the
elevation bounds (skipped when both are given), the cells with the occupancy,
the winners and ``collisions``, the window search reading the winners'
points straight from the scan, and the per-point rows.

Nothing here reads the host: ``collisions`` stays a device tensor. A point
that shares its cell inherits the cell winner's neighbourhood (distances from
the winner), as in JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops.knn import KNNResult

BIG = 3.0e38
# The window kernel's tile: about TILE_CELLS cells (one a thread) a block up
# to k = 16, WARP_TILE_CELLS (one a warp of the WARP_THREADS // 32) above,
# within a block's SMEM_BYTES of shared memory (227 KB on the H100).
TILE_CELLS = 512
WARP_TILE_CELLS = 64
WARP_THREADS = 256
SMEM_BYTES = cuda_knn.SMEM_BYTES
# The bins' constants as PyTorch's CUDA kernels apply them: pi rounded to
# f32, and the division by the CPU scalar 2 pi as a product with the f32
# reciprocal of f32(2 pi).
PI_F32 = float(np.float32(math.pi))
INV_TWO_PI_F32 = float(np.float32(1.0) / np.float32(2.0 * math.pi))


class RangeImageKNNResult(NamedTuple):
    knn: KNNResult
    collisions: torch.Tensor  # 0-dim int32: points sharing a cell with another point


def window_offsets(window_az: int, window_el: int):
    """The window's ``(da, de)`` offsets in JAX's column order: ``da``
    outer, ``de`` inner."""
    return [(da, de) for da in range(-window_az, window_az + 1) for de in range(-window_el, window_el + 1)]


def range_image_window_plain(img_p: torch.Tensor, img_i: torch.Tensor, n_az: int, n_rings: int, window_az: int,
                             window_el: int, k: int):
    """The window search in plain PyTorch: for each cell of the image
    (``img_p [C, 3]`` points, ``img_i [C]`` point indices, -1 where the cell
    is empty, row ``a * n_rings + e``), the ``k`` smallest squared distances
    ``dx*dx + dy*dy + dz*dz`` to the points of its window's occupied cells,
    ascending, the earlier window column first on ties: ``(idx [C, k] int32,
    d2 [C, k] f32)``, slots not filled at 3e38 with index -1. ``k`` above
    the window's candidates raises, as JAX's ``top_k`` does."""
    check_candidates(k, window_az, window_el)
    C = n_az * n_rings
    dev = img_p.device
    offs = torch.tensor(window_offsets(window_az, window_el), dtype=torch.int64, device=dev)  # [W, 2]
    cell = torch.arange(C, device=dev)
    az, el = cell // n_rings, cell % n_rings
    nb_el = el[:, None] + offs[None, :, 1]
    el_ok = (nb_el >= 0) & (nb_el < n_rings)
    nb = torch.remainder(az[:, None] + offs[None, :, 0], n_az) * n_rings + nb_el.clamp(0, n_rings - 1)  # [C, W]
    J = img_i[nb]
    valid = (img_i >= 0)[:, None] & (J >= 0) & el_ok
    P2 = img_p[nb]
    dx = img_p[:, None, 0] - P2[..., 0]
    dy = img_p[:, None, 1] - P2[..., 1]
    dz = img_p[:, None, 2] - P2[..., 2]
    D = torch.where(valid, dx * dx + dy * dy + dz * dz, BIG)
    d_sorted, order = (x[:, :k] for x in torch.sort(D, dim=1, stable=True))
    idx = torch.where(d_sorted < BIG, J.gather(1, order), -1).to(torch.int32)
    return idx, d_sorted.contiguous()


def window_candidates(window_az: int, window_el: int) -> int:
    """The window's candidate cells, ``(2 window_az + 1)(2 window_el + 1)``:
    117 at the default (6, 4)."""
    return (2 * window_az + 1) * (2 * window_el + 1)


def check_candidates(k: int, window_az: int, window_el: int) -> None:
    """Refuse ``k`` outside ``[1, window_candidates]``, as JAX's ``top_k``
    over the window's columns does, on every device."""
    cap = window_candidates(window_az, window_el)
    if not 1 <= k <= cap:
        raise ValueError(f"the range-image search takes 1 <= k <= {cap} (its window's candidates at window "
                         f"({window_az}, {window_el})), got {k}")


def tile_smem(n_rings: int, window_az: int, tile_az: int, k: int = cuda_knn.FAST_MAX_K) -> int:
    """Shared memory of a block of the one-thread tile kernel (``k <= 16``,
    and :func:`range_image_window_spill`): the ``tile_az + 2 window_az``
    staged columns (16 B a ring) and the block's rows of the result (8 K B a
    thread, one thread a cell up to TILE_CELLS), K the kernel instance that
    serves ``k`` (``cuda_knn.instance_k``)."""
    threads = min(TILE_CELLS, -(-tile_az * n_rings // 32) * 32)
    return 16 * n_rings * (tile_az + 2 * window_az) + 8 * cuda_knn.instance_k(k) * threads


def warp_tile_smem(n_rings: int, window_az: int, tile_az: int, k: int) -> int:
    """Shared memory of a block of the warp kernel (``k > 16``): the staged
    columns at the odd column stride ``n_rings | 1`` (16 B a ring) and one
    row of K keys (8 B each) a warp."""
    return 16 * (n_rings | 1) * (tile_az + 2 * window_az) + 8 * cuda_knn.instance_k(k) * (WARP_THREADS // 32)


def _plan(n_rings: int, window_az: int, cells: int, smem) -> int:
    """The largest power of two ``ta`` with ``ta x n_rings <= cells`` (at
    least 1) whose ``smem(ta)`` fits :data:`SMEM_BYTES`; raises when one
    column and its halo do not fit."""
    if n_rings < 1 or window_az < 0:
        raise ValueError(f"range_image_tile takes n_rings >= 1 and window_az >= 0, got {n_rings}, {window_az}")
    if smem(1) > SMEM_BYTES:
        raise ValueError(f"one azimuth column of {n_rings} rings and its halo of 2 x {window_az} columns take "
                         f"{smem(1)} B of shared memory, above a block's {SMEM_BYTES}")
    ta = 1 << (max(1, cells // n_rings).bit_length() - 1)
    while smem(ta) > SMEM_BYTES:
        ta //= 2
    return ta


def range_image_tile(n_rings: int, window_az: int, k: int = cuda_knn.FAST_MAX_K) -> int:
    """Azimuth columns a block of the window kernel owns (TA) for a search of
    ``k``: up to 16 (a thread a cell) the largest power of two whose ``TA x
    n_rings`` cells stay within :data:`TILE_CELLS` and whose
    :func:`tile_smem` fits :data:`SMEM_BYTES`; above 16 (a warp a cell) the
    same within :data:`WARP_TILE_CELLS` and :func:`warp_tile_smem`. Raises
    when one column and its halo do not fit. 2048 x 64 at the default window
    takes 8 columns (512 cells, 84 KB) up to k = 16 and 1 above (64 cells,
    15,568 B at K = 32, 21,712 B at K = 128): 2,048 blocks, which spread
    over the H100's 132 SMs more evenly than 512 of 4 columns (PERF.md §6)."""
    if cuda_knn.instance_k(k) <= cuda_knn.FAST_MAX_K:
        return _plan(n_rings, window_az, TILE_CELLS, lambda ta: tile_smem(n_rings, window_az, ta, k))
    return _plan(n_rings, window_az, WARP_TILE_CELLS, lambda ta: warp_tile_smem(n_rings, window_az, ta, k))


def spill_tile(n_rings: int, window_az: int, k: int) -> int:
    """TA of :func:`range_image_window_spill` (the one-thread tile above 16):
    as :func:`range_image_tile` up to 16, with the block's 8 K B a thread of
    result rows in its :func:`tile_smem`. 2048 x 64 at the default window
    takes 8 columns at k = 32, 4 at 64 and 2 at 128."""
    return _plan(n_rings, window_az, TILE_CELLS, lambda ta: tile_smem(n_rings, window_az, ta, k))


def _check_k_window(k: int, window_az: int, window_el: int, device) -> None:
    if not (0 <= window_az < 1 << 15 and 0 <= window_el < 1 << 16):
        raise ValueError(f"the range-image search takes windows in [0, 2^15) x [0, 2^16), got {window_az}, "
                         f"{window_el}")
    check_candidates(k, window_az, window_el)
    cuda_knn.check_k(k, "the range-image search", device)


def _check_window(img_p: torch.Tensor, img_i: torch.Tensor, n_az: int, n_rings: int, window_az: int,
                  window_el: int, k: int):
    """Check a window search's arguments; returns the image's device."""
    C = n_az * n_rings
    _check_k_window(k, window_az, window_el, img_p.device)
    if img_p.shape != (C, 3) or img_i.shape != (C,):
        raise ValueError(f"expected a [{C}, 3] image and [{C}] indices, got {tuple(img_p.shape)}, "
                         f"{tuple(img_i.shape)}")
    if img_p.dtype != torch.float32 or img_i.dtype != torch.int32:
        raise TypeError(f"expected float32 points and int32 indices, got {img_p.dtype}, {img_i.dtype}")
    if img_p.device != img_i.device:
        raise ValueError(f"inputs on more than one device: {img_p.device}, {img_i.device}")
    return img_p.device


def range_image_window(img_p: torch.Tensor, img_i: torch.Tensor, n_az: int, n_rings: int, window_az: int,
                       window_el: int, k: int):
    """:func:`range_image_window_plain` through the ``range_image`` kernel
    (``csrc/range_image.cu``, :func:`range_image_tile` columns a block: a
    thread a cell up to k = 16, a warp a cell above) for CUDA tensors; CPU
    tensors run the plain version."""
    device = _check_window(img_p, img_i, n_az, n_rings, window_az, window_el, k)
    if device.type == "cpu":
        return range_image_window_plain(img_p, img_i, n_az, n_rings, window_az, window_el, k)
    cuda_knn._require_cuda(device, "range_image_window")
    cuda_knn._require_contiguous(img_p, img_i)
    ta = range_image_tile(n_rings, window_az, k)
    return cuda_knn._launch("range_image", device, (n_az * n_rings, k),
                            lambda lib, i, d, s: lib.spt_range_image_window(
                                img_p.data_ptr(), img_i.data_ptr(), 0, n_az, n_rings, window_az, window_el, k, ta,
                                i, d, s))


def range_image_window_spill(img_p: torch.Tensor, img_i: torch.Tensor, n_az: int, n_rings: int, window_az: int,
                             window_el: int, k: int):
    """:func:`range_image_window` above 16 through the one-thread tile
    kernel's instances (``csrc/range_image.cu``, a cell's K-key list in
    registers, spilled; :func:`spill_tile` columns a block), kept for timing
    against the warp kernel, counted under ``range_image_spill``; the same
    result. CPU tensors run the plain version."""
    if not cuda_knn.FAST_MAX_K < k <= cuda_knn.MAX_K:
        raise ValueError(f"range_image_window_spill serves {cuda_knn.FAST_MAX_K} < k <= {cuda_knn.MAX_K}, got {k}")
    device = _check_window(img_p, img_i, n_az, n_rings, window_az, window_el, k)
    if device.type == "cpu":
        return range_image_window_plain(img_p, img_i, n_az, n_rings, window_az, window_el, k)
    cuda_knn._require_cuda(device, "range_image_window_spill")
    cuda_knn._require_contiguous(img_p, img_i)
    ta = spill_tile(n_rings, window_az, k)
    return cuda_knn._launch("range_image_spill", device, (n_az * n_rings, k),
                            lambda lib, i, d, s: lib.spt_range_image_window_spill(
                                img_p.data_ptr(), img_i.data_ptr(), 0, n_az, n_rings, window_az, window_el, k, ta,
                                i, d, s))


def range_image_window_simple(img_p: torch.Tensor, img_i: torch.Tensor, n_az: int, n_rings: int, window_az: int,
                              window_el: int, k: int):
    """:func:`range_image_window` through the kernel's first design (one
    thread a cell, reading the image through L1): the reference the tiled
    kernel is held to and timed against; ``k <= 16``. CPU tensors run the
    plain version."""
    device = _check_window(img_p, img_i, n_az, n_rings, window_az, window_el, k)
    cuda_knn.check_fast_k(k, "range_image_window_simple")
    if device.type == "cpu":
        return range_image_window_plain(img_p, img_i, n_az, n_rings, window_az, window_el, k)
    cuda_knn._require_cuda(device, "range_image_window_simple")
    cuda_knn._require_contiguous(img_p, img_i)
    return cuda_knn._launch("range_image_simple", device, (n_az * n_rings, k),
                            lambda lib, i, d, s: lib.spt_range_image_window_simple(
                                img_p.data_ptr(), img_i.data_ptr(), n_az, n_rings, window_az, window_el, k, i, d, s))


def point_angles(points: torch.Tensor, mask: torch.Tensor):
    """Step 1 of each point: ``(ok [N], az [N], el [N])``."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = torch.sqrt(x * x + y * y + z * z)
    ok = mask & torch.isfinite(r) & (r > 1e-6)
    az = torch.atan2(y, x)
    el = torch.asin(torch.clamp(z / torch.clamp_min(r, 1e-9), -1.0, 1.0))
    return ok, az, el


def elevation_bounds(ok: torch.Tensor, el: torch.Tensor):
    """The masked min and max of the elevations (0-dim; +inf / -inf when no
    point is valid)."""
    if not el.shape[0]:
        return torch.tensor(torch.inf, device=el.device), torch.tensor(-torch.inf, device=el.device)
    return torch.where(ok, el, torch.inf).amin(), torch.where(ok, el, -torch.inf).amax()


def range_image(points: torch.Tensor, mask: torch.Tensor, n_az: int = 2048, n_rings: int = 64,
                el_min: Optional[float] = None, el_max: Optional[float] = None):
    """Steps 1-2: ``(img_p [C, 3], img_i [C] int32, cell [N] int64 (C for an
    invalid point), ok [N], collisions)`` of a sensor-frame scan."""
    N = points.shape[0]
    C = n_az * n_rings
    dev = points.device
    ok, az, el = point_angles(points, mask)
    if el_min is None or el_max is None:
        lo, hi = elevation_bounds(ok, el)
    el_lo = lo if el_min is None else torch.tensor(el_min, dtype=torch.float32, device=dev)
    el_hi = hi if el_max is None else torch.tensor(el_max, dtype=torch.float32, device=dev)
    span = torch.clamp_min(el_hi - el_lo, 1e-6)

    # center-offset bins: the ray angles sit at bin centers, not at edges
    azf = torch.floor((az + math.pi) / (2.0 * math.pi) * n_az + 0.5)
    elf = torch.floor((el - el_lo) / span * (n_rings - 1) + 0.5)
    azb = torch.remainder(torch.nan_to_num(azf, nan=0.0, posinf=0.0, neginf=0.0).to(torch.int64), n_az)
    elb = torch.nan_to_num(elf, nan=0.0, posinf=0.0, neginf=0.0).clamp(0, n_rings - 1).to(torch.int64)
    cell = torch.where(ok, azb * n_rings + elb, C)

    occ = torch.zeros(C + 1, dtype=torch.int32, device=dev).index_add_(
        0, cell, torch.ones(N, dtype=torch.int32, device=dev))
    collisions = torch.clamp_min(occ[:C] - 1, 0).sum(dtype=torch.int32)
    winner = torch.full((C + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, cell, torch.arange(N, device=dev), "amax")
    img_i = winner[:C]
    img_p = torch.where((img_i >= 0)[:, None], points[img_i.clamp_min(0)], 0.0)
    return img_p.contiguous(), img_i.to(torch.int32).contiguous(), cell, ok, collisions


def range_image_knn(
    points: torch.Tensor,  # [N, 3] sensor frame
    mask: torch.Tensor,  # [N] bool
    k: int,
    n_az: int = 2048,
    n_rings: int = 64,
    window_az: int = 6,
    window_el: int = 4,
    el_min: Optional[float] = None,
    el_max: Optional[float] = None,
) -> RangeImageKNNResult:
    """Self-k-NN of a raw spinning-LiDAR scan through its dense range image.

    ``el_min`` / ``el_max`` bound the elevation fan; ``None`` takes them from
    the scan (its masked min and max: right for a full scan; pass the
    sensor's constants for a partial one). ``k`` above the window's
    candidates raises before any work, on either device."""
    _check_k_window(k, window_az, window_el, points.device)
    if points.device.type != "cpu":
        return _range_image_knn_cuda(points, mask, k, n_az, n_rings, window_az, window_el, el_min, el_max)
    img_p, img_i, cell, ok, collisions = range_image(points, mask, n_az, n_rings, el_min, el_max)
    idx_c, d_c = range_image_window(img_p, img_i, n_az, n_rings, window_az, window_el, k)
    return RangeImageKNNResult(knn=point_rows(idx_c, d_c, cell, ok), collisions=collisions)


def _check_scan(points: torch.Tensor, mask: torch.Tensor, n_az: int, n_rings: int) -> None:
    N = points.shape[0]
    if points.shape != (N, 3) or mask.shape != (N,):
        raise ValueError(f"expected [N, 3] points and an [N] mask, got {tuple(points.shape)}, {tuple(mask.shape)}")
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"expected float32 points and a bool mask, got {points.dtype}, {mask.dtype}")
    if points.device != mask.device:
        raise ValueError(f"inputs on more than one device: {points.device}, {mask.device}")
    if n_az < 1 or n_rings < 1:
        raise ValueError(f"expected a non-empty image, got {n_az} x {n_rings}")


def range_image_cells_plain(points: torch.Tensor, mask: torch.Tensor, n_az: int = 2048, n_rings: int = 64,
                            el_min: Optional[float] = None, el_max: Optional[float] = None):
    """Steps 1-2 as :func:`range_image` computes them: ``(cell [N] int32
    (n_az * n_rings for an invalid point), winner [C] int32 (the cell's
    point index + 1, 0 where empty), occupancy [C] int32, collisions)``."""
    C = n_az * n_rings
    _, img_i, cell, ok, collisions = range_image(points, mask, n_az, n_rings, el_min, el_max)
    occ = torch.bincount(cell[ok], minlength=C).to(torch.int32)
    return cell.to(torch.int32), img_i + 1, occ, collisions


def range_image_cells(points: torch.Tensor, mask: torch.Tensor, n_az: int = 2048, n_rings: int = 64,
                      el_min: Optional[float] = None, el_max: Optional[float] = None):
    """:func:`range_image_cells_plain` on the card: one memset, then the
    kernels ``range_image_elevation`` (the masked elevation bounds, skipped
    when both are given) and ``range_image_cells`` (bins, cells, occupancy,
    winners, collisions). CPU tensors run the plain version."""
    _check_scan(points, mask, n_az, n_rings)
    dev = points.device
    if dev.type == "cpu":
        return range_image_cells_plain(points, mask, n_az, n_rings, el_min, el_max)
    cuda_knn._require_cuda(dev, "range_image_cells")
    points, mask = points.contiguous(), mask.contiguous()
    N, C = points.shape[0], n_az * n_rings
    # [occupancy C | winner + 1 C | collisions | max el key | max ~el key]
    scratch = torch.zeros(2 * C + 3, dtype=torch.int32, device=dev)
    occ, win1, collisions = scratch[:C], scratch[C:2 * C], scratch[2 * C]
    cell = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return cell, win1, occ, collisions
    if el_min is None or el_max is None:
        _elevation_launch(points, mask, scratch)
    _cells_launch(points, mask, n_az, n_rings, el_min, el_max, scratch, cell)
    return cell, win1, occ, collisions


def _elevation_launch(points, mask, scratch) -> None:
    """Kernel (a) into the elevation keys of ``scratch`` (zeroed)."""
    N, keys = points.shape[0], scratch[-2:]
    cuda_knn._run("range_image_elevation", points.device, lambda lib, s: lib.spt_range_image_elevation(
        points.data_ptr(), mask.data_ptr(), N, keys.data_ptr(), s))


def _cells_launch(points, mask, n_az, n_rings, el_min, el_max, scratch, cell) -> None:
    """Kernel (b): occupancy, winners and collisions into ``scratch``
    (zeroed), the cells into ``cell``."""
    N, C = points.shape[0], n_az * n_rings
    ptr = lambda i: scratch[i:].data_ptr()
    cuda_knn._run("range_image_cells", points.device, lambda lib, s: lib.spt_range_image_cells(
        points.data_ptr(), mask.data_ptr(), N, n_az, n_rings, ptr(2 * C + 1), 0.0 if el_min is None else el_min,
        0.0 if el_max is None else el_max, el_min is not None, el_max is not None, PI_F32, INV_TWO_PI_F32, ptr(0),
        ptr(C), ptr(2 * C), cell.data_ptr(), s))


def range_image_window_gather(points: torch.Tensor, win1: torch.Tensor, n_az: int, n_rings: int, window_az: int,
                              window_el: int, k: int):
    """:func:`range_image_window` on the image that ``win1`` (a cell's
    winner index + 1, 0 where empty) makes of the scan ``points``: the
    ``range_image`` kernel reads the winners' points into its tile itself.
    CPU tensors build the image and run the plain version."""
    C = n_az * n_rings
    if win1.shape != (C,) or win1.dtype != torch.int32 or win1.device != points.device:
        raise ValueError(f"expected [{C}] int32 winners on {points.device}, got {tuple(win1.shape)} {win1.dtype} "
                         f"on {win1.device}")
    _check_k_window(k, window_az, window_el, points.device)
    if points.device.type == "cpu":
        img_i = win1 - 1
        img_p = torch.where((img_i >= 0)[:, None], points[img_i.clamp_min(0)], 0.0)
        return range_image_window(img_p, img_i, n_az, n_rings, window_az, window_el, k)
    cuda_knn._require_cuda(points.device, "range_image_window_gather")
    cuda_knn._require_contiguous(points, win1)
    ta = range_image_tile(n_rings, window_az, k)
    return cuda_knn._launch("range_image", points.device, (C, k), lambda lib, i, d, s: lib.spt_range_image_window(
        points.data_ptr(), win1.data_ptr(), 1, n_az, n_rings, window_az, window_el, k, ta, i, d, s))


def cell_rows(idx_c: torch.Tensor, d_c: torch.Tensor, cell: torch.Tensor) -> KNNResult:
    """:func:`point_rows` for ``cell [N]`` int32 (C for an invalid point)
    through the ``range_image_rows`` kernel on CUDA tensors; CPU tensors run
    :func:`point_rows`."""
    C, k = idx_c.shape
    if d_c.shape != (C, k) or cell.dim() != 1 or cell.dtype != torch.int32:
        raise ValueError(f"expected [C, k] rows and [N] int32 cells, got {tuple(idx_c.shape)}, "
                         f"{tuple(d_c.shape)}, {tuple(cell.shape)} {cell.dtype}")
    if cell.device.type == "cpu":
        return point_rows(idx_c, d_c, cell.long(), cell < C)
    cuda_knn._require_cuda(cell.device, "range_image_rows")
    cuda_knn._require_contiguous(idx_c, d_c, cell)
    N = cell.shape[0]
    return KNNResult(*cuda_knn._launch("range_image_rows", cell.device, (N, k), lambda lib, i, d, s:
                                       lib.spt_range_image_rows(idx_c.data_ptr(), d_c.data_ptr(), cell.data_ptr(),
                                                                N, C, k, i, d, s)))


def _range_image_knn_cuda(points, mask, k, n_az, n_rings, window_az, window_el, el_min, el_max):
    """:func:`range_image_knn` on the card: :func:`range_image_cells` (a
    memset and one or two kernels), the window search on the winners'
    points, the rows: at most 5 device launches."""
    _check_scan(points, mask, n_az, n_rings)
    range_image_tile(n_rings, window_az, k)  # raises before any launch when the tile does not fit
    points = points.contiguous()
    cell, win1, _, collisions = range_image_cells(points, mask, n_az, n_rings, el_min, el_max)
    if points.shape[0] == 0:
        return RangeImageKNNResult(knn=KNNResult(torch.empty((0, k), dtype=torch.int32, device=points.device),
                                                 torch.empty((0, k), device=points.device)), collisions=collisions)
    idx_c, d_c = range_image_window_gather(points, win1, n_az, n_rings, window_az, window_el, k)
    return RangeImageKNNResult(knn=cell_rows(idx_c, d_c, cell), collisions=collisions)


def point_rows(idx_c: torch.Tensor, d_c: torch.Tensor, cell: torch.Tensor, ok: torch.Tensor) -> KNNResult:
    """Step 4: each point reads its own cell's row of the window search;
    missing slots and invalid points fall back to the point itself at an
    infinite distance (covariance.py takes fewer than 4 valid neighbours as
    the identity)."""
    out_i, out_d = idx_c[cell.clamp_max(idx_c.shape[0] - 1)], d_c[cell.clamp_max(d_c.shape[0] - 1)]
    self_i = torch.arange(cell.shape[0], dtype=torch.int32, device=cell.device)[:, None]
    missing = (out_i < 0) | (out_d >= BIG) | ~ok[:, None]
    return KNNResult(torch.where(missing, self_i, out_i), torch.where(missing, torch.inf, out_d))
