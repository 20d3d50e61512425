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
  3. the window distances and the k smallest of each cell:
     :func:`range_image_window`, the ``range_image`` kernel of
     ``csrc/range_image.cu`` on the card, :func:`range_image_window_plain`
     on the CPU;
  4. each point reads its cell's row; missing slots and invalid points fall
     back to the point itself at an infinite distance.

Nothing here reads the host: ``collisions`` stays a device tensor. A point
that shares its cell inherits the cell winner's neighbourhood (distances from
the winner), as in JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops.knn import KNNResult

BIG = 3.0e38


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
    d2 [C, k] f32)``, slots not filled at 3e38 with index -1."""
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
    d_sorted, order = torch.sort(D, dim=1, stable=True)
    kk = min(k, D.shape[1])
    d2 = torch.full((C, k), BIG, dtype=torch.float32, device=dev)
    idx = torch.full((C, k), -1, dtype=torch.int32, device=dev)
    d2[:, :kk] = d_sorted[:, :kk]
    filled = d_sorted[:, :kk] < BIG
    idx[:, :kk] = torch.where(filled, J.gather(1, order[:, :kk]), -1).to(torch.int32)
    return idx, d2


def range_image_window(img_p: torch.Tensor, img_i: torch.Tensor, n_az: int, n_rings: int, window_az: int,
                       window_el: int, k: int):
    """:func:`range_image_window_plain` through the ``range_image`` kernel
    (``csrc/range_image.cu``) for CUDA tensors; CPU tensors run the plain
    version."""
    C = n_az * n_rings
    if not 1 <= k <= cuda_knn.MAX_K:
        raise ValueError(f"range_image_window takes 1 <= k <= {cuda_knn.MAX_K}, got {k}")
    if img_p.shape != (C, 3) or img_i.shape != (C,):
        raise ValueError(f"expected a [{C}, 3] image and [{C}] indices, got {tuple(img_p.shape)}, "
                         f"{tuple(img_i.shape)}")
    if img_p.dtype != torch.float32 or img_i.dtype != torch.int32:
        raise TypeError(f"expected float32 points and int32 indices, got {img_p.dtype}, {img_i.dtype}")
    if img_p.device != img_i.device:
        raise ValueError(f"inputs on more than one device: {img_p.device}, {img_i.device}")
    device = img_p.device
    if device.type == "cpu":
        return range_image_window_plain(img_p, img_i, n_az, n_rings, window_az, window_el, k)
    cuda_knn._require_cuda(device, "range_image_window")
    cuda_knn._require_contiguous(img_p, img_i)
    return cuda_knn._launch("range_image", device, (C, k), lambda lib, i, d, s: lib.spt_range_image_window(
        img_p.data_ptr(), img_i.data_ptr(), n_az, n_rings, window_az, window_el, k, i, d, s))


def range_image(points: torch.Tensor, mask: torch.Tensor, n_az: int = 2048, n_rings: int = 64,
                el_min: Optional[float] = None, el_max: Optional[float] = None):
    """Steps 1-2: ``(img_p [C, 3], img_i [C] int32, cell [N] int64 (C for an
    invalid point), ok [N], collisions)`` of a sensor-frame scan."""
    N = points.shape[0]
    C = n_az * n_rings
    dev = points.device
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = torch.sqrt(x * x + y * y + z * z)
    ok = mask & torch.isfinite(r) & (r > 1e-6)
    az = torch.atan2(y, x)
    el = torch.asin(torch.clamp(z / torch.clamp_min(r, 1e-9), -1.0, 1.0))

    if el_min is None:
        el_lo = torch.where(ok, el, torch.inf).amin() if N else torch.tensor(torch.inf, device=dev)
    else:
        el_lo = torch.tensor(el_min, dtype=torch.float32, device=dev)
    if el_max is None:
        el_hi = torch.where(ok, el, -torch.inf).amax() if N else torch.tensor(-torch.inf, device=dev)
    else:
        el_hi = torch.tensor(el_max, dtype=torch.float32, device=dev)
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
    sensor's constants for a partial one)."""
    img_p, img_i, cell, ok, collisions = range_image(points, mask, n_az, n_rings, el_min, el_max)
    idx_c, d_c = range_image_window(img_p, img_i, n_az, n_rings, window_az, window_el, k)
    return RangeImageKNNResult(knn=point_rows(idx_c, d_c, cell, ok), collisions=collisions)


def point_rows(idx_c: torch.Tensor, d_c: torch.Tensor, cell: torch.Tensor, ok: torch.Tensor) -> KNNResult:
    """Step 4: each point reads its own cell's row of the window search;
    missing slots and invalid points fall back to the point itself at an
    infinite distance (covariance.py takes fewer than 4 valid neighbours as
    the identity)."""
    out_i, out_d = idx_c[cell.clamp_max(idx_c.shape[0] - 1)], d_c[cell.clamp_max(d_c.shape[0] - 1)]
    self_i = torch.arange(cell.shape[0], dtype=torch.int32, device=cell.device)[:, None]
    missing = (out_i < 0) | (out_d >= BIG) | ~ok[:, None]
    return KNNResult(torch.where(missing, self_i, out_i), torch.where(missing, torch.inf, out_d))
