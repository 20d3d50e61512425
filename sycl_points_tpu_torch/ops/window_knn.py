"""Morton-window approximate self-k-NN for large clouds.

Counterpart of :mod:`sycl_points_tpu.ops.window_knn`: the points are ordered
along a space-filling curve, so that most of a point's true neighbours sit
within a small window of the sorted order, and each point keeps the ``k``
nearest among the ``2 W`` points at sorted offsets ``-W .. -1, 1 .. W``:

  1. 30-bit Morton codes (3 x 10-bit interleave of cells of ``cell_size``,
     re-based to the cloud's minimum; invalid points get the largest code),
     bit-equal to JAX's;
  2. one sort by code (stable: among equal codes the original order, where
     JAX's unstable ``lax.sort`` leaves the order to the backend);
  3. the window search over the sorted order, written back in the original
     order: :func:`window_search`, the ``morton_window`` kernel of
     ``csrc/window_knn.cu`` on the card, :func:`window_search_plain` on the
     CPU.

``window_self_knn`` runs a second pass on a curve with the axes rotated and
keeps the ``k`` best of the union (duplicates dropped), recovering most of
the curve-boundary misses. Reported distances are exact; approximate means a
true neighbour outside both windows is replaced by a farther one. Slots with
no valid partner read +inf (3e38 inside a pass, as in JAX).
"""

from __future__ import annotations

import torch

from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops.knn import KNNResult

BIG = 3.0e38
_CODE_MAX = 2**31 - 1


def _spread10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 lanes to every 3rd bit position."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(points: torch.Tensor, valid: torch.Tensor, cell_size: float, axis_order: tuple = (0, 1, 2)):
    """30-bit Morton codes ``[N]`` int32 over 10-bit cells re-based to the
    cloud's minimum (an extent of 1024 cells an axis); invalid or
    non-finite points get ``2^31 - 1``. ``axis_order`` picks which axis owns
    the low interleave bit."""
    pts = points[:, list(axis_order)]
    scaled = pts * (1.0 / cell_size)
    finite = torch.isfinite(scaled).all(-1) & valid
    # clamp before the cast so that every value converts defined; the
    # non-finite rows are replaced below
    c = torch.nan_to_num(torch.floor(scaled), nan=0.0).clamp(-(2.0**31), 2.0**31 - 128).to(torch.int32)
    cmin = torch.where(finite[:, None], c, 2**30).amin(0)
    rel = torch.clamp(c - cmin, 0, 1023)
    code = _spread10(rel[:, 0]) | (_spread10(rel[:, 1]) << 1) | (_spread10(rel[:, 2]) << 2)
    return torch.where(finite, code, _CODE_MAX)


def _offsets(window: int, device) -> torch.Tensor:
    """JAX's column order: ``-W .. -1, 1 .. W``."""
    return torch.cat([torch.arange(-window, 0, device=device), torch.arange(1, window + 1, device=device)])


def window_search_plain(pts_s: torch.Tensor, ok_s: torch.Tensor, idx_s: torch.Tensor, window: int, k: int):
    """The window search in plain PyTorch, as JAX writes it: for sorted
    position ``s`` the ``[2 W]`` values ``d2`` to the points at ``s + o``
    (3e38 when either point is invalid or ``s + o`` is off the cloud), the
    ``k`` smallest by a stable ascending sort (``lax.top_k``'s order), each
    slot's index the original index of the clipped partner position, the
    rows written at the original positions ``idx_s``: ``(idx [N, k] int32,
    d2 [N, k])``."""
    N = pts_s.shape[0]
    dev = pts_s.device
    offs = _offsets(window, dev)
    j = torch.arange(N, device=dev)[:, None] + offs[None, :]
    jc = j.clamp(0, N - 1)
    e = pts_s[:, None, :] - pts_s[jc]
    d2 = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]
    D = torch.where(ok_s[:, None] & ok_s[jc] & (j >= 0) & (j < N), d2, BIG)
    sel = torch.sort(D, dim=1, stable=True)[1][:, :k]
    d = D.gather(1, sel)
    orig = idx_s[jc.gather(1, sel)]
    out_i = torch.empty((N, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((N, k), dtype=torch.float32, device=dev)
    out_i[idx_s.long()] = orig
    out_d[idx_s.long()] = d
    return out_i, out_d


def window_search(pts_s: torch.Tensor, ok_s: torch.Tensor, idx_s: torch.Tensor, window: int, k: int):
    """:func:`window_search_plain` through the ``morton_window`` kernel
    (``csrc/window_knn.cu``) for CUDA tensors; CPU tensors run the plain
    version. ``idx_s`` must be a permutation of ``[0, N)``; ``k <= 2
    window`` (and ``cuda_knn.MAX_K`` on the card)."""
    N = pts_s.shape[0]
    if pts_s.shape != (N, 3) or ok_s.shape != (N,) or idx_s.shape != (N,):
        raise ValueError(f"expected [N,3] points, [N] validity and [N] indices, got {tuple(pts_s.shape)}, "
                         f"{tuple(ok_s.shape)}, {tuple(idx_s.shape)}")
    if pts_s.dtype != torch.float32 or ok_s.dtype != torch.bool or idx_s.dtype != torch.int32:
        raise TypeError(f"expected float32 points, bool validity and int32 indices, got {pts_s.dtype}, "
                        f"{ok_s.dtype}, {idx_s.dtype}")
    device = cuda_knn._check_queries(pts_s, None, ok_s, idx_s)
    cuda_knn.check_k(k, f"window_search (window={window})", device, 2 * window)
    if device.type == "cpu":
        return window_search_plain(pts_s, ok_s, idx_s, window, k)
    cuda_knn._require_cuda(device, "morton_window")
    cuda_knn._require_contiguous(pts_s, ok_s, idx_s)
    return cuda_knn._launch("morton_window", device, (N, k), lambda lib, i, d, s: lib.spt_morton_window(
        pts_s.data_ptr(), ok_s.data_ptr(), idx_s.data_ptr(), N, window, k, i, d, s))


def window_pass(points: torch.Tensor, mask: torch.Tensor, k: int, window: int, cell_size: float,
                axis_order: tuple):
    """One sorted-window pass: ``(idx [N, k] int32, d2 [N, k])`` in the
    original order, 3e38 where a slot has no valid partner."""
    code = morton_codes(points, mask, cell_size, axis_order)
    order = torch.sort(code, stable=True)[1]
    return window_search(points[order].contiguous(), mask[order].contiguous(), order.to(torch.int32), window, k)


def window_self_knn(points: torch.Tensor, mask: torch.Tensor, k: int, window: int = 64, cell_size: float = 0.5,
                    passes: int = 2) -> KNNResult:
    """Approximate self-k-NN (every point queries the whole cloud, itself
    excluded). ``window`` is the one-sided search radius in the sorted
    order; ``passes=2`` adds a second curve (axes rotated) and keeps the
    ``k`` best of the union, a neighbour found twice counted once."""
    i1, d1 = window_pass(points, mask, k, window, cell_size, (0, 1, 2))
    if passes <= 1:
        return KNNResult(i1, torch.where(d1 >= BIG, torch.inf, d1))
    i2, d2 = window_pass(points, mask, k, window, cell_size, (2, 0, 1))
    idx, perm = torch.sort(torch.cat([i1, i2], 1), dim=1, stable=True)
    dd = torch.cat([d1, d2], 1).gather(1, perm)
    dup = torch.zeros_like(idx, dtype=torch.bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    dd = torch.where(dup, BIG, dd)
    sel = torch.sort(dd, dim=1, stable=True)[1][:, :k]
    out_d = dd.gather(1, sel)
    return KNNResult(idx.gather(1, sel), torch.where(out_d >= BIG, torch.inf, out_d))
