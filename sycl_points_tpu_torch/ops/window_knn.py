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
     order.

``window_self_knn`` runs a second pass on a curve with the axes rotated and
keeps the ``k`` best of the union (duplicates dropped), recovering most of
the curve-boundary misses. Reported distances are exact; approximate means a
true neighbour outside both windows is replaced by a farther one. Slots with
no valid partner read +inf (3e38 inside a pass, as in JAX).

On CUDA tensors ``window_self_knn`` is a memset and four kernels of
``csrc/window_knn.cu`` around one ``torch.sort`` of both passes' codes:
:func:`morton_codes_passes` (the minimum, then the codes of both passes), the
sort, then :func:`window_gather` twice (the first pass, then the second with
the union folded in), each reading the cloud through the sort's permutation.
Each kernel has its plain version here (:func:`morton_codes_passes_plain`,
:func:`window_search_plain`, :func:`window_gather_plain`,
:func:`window_union_plain`), which the CPU runs. :func:`window_search` runs
the window kernel on sorted copies, and :func:`morton_window_simple` the
first design (one thread a position), kept for timing.
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


AXES = ((0, 1, 2), (2, 0, 1))  # the passes' axis orders


def morton_codes_passes_plain(points: torch.Tensor, valid: torch.Tensor, cell_size: float,
                              orders: tuple = AXES) -> torch.Tensor:
    """:func:`morton_codes` of every axis order of ``orders``, ``[len(orders),
    N]`` int32."""
    return torch.stack([morton_codes(points, valid, cell_size, o) for o in orders])


def morton_codes_passes(points: torch.Tensor, valid: torch.Tensor, cell_size: float,
                        orders: tuple = AXES) -> torch.Tensor:
    """:func:`morton_codes_passes_plain` (one or two orders) through the
    ``morton_min`` and ``morton_codes`` kernels for CUDA tensors (a memset
    and two launches: the per-axis minimum is the same for every order); CPU
    tensors run the plain version."""
    N = points.shape[0]
    if points.shape != (N, 3) or valid.shape != (N,) or points.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"expected [N,3] float32 points and [N] bool validity, got {points.dtype} "
                         f"{tuple(points.shape)}, {valid.dtype} {tuple(valid.shape)}")
    if not 1 <= len(orders) <= 2 or any(sorted(o) != [0, 1, 2] for o in orders):
        raise ValueError(f"expected one or two axis orders, each a permutation of (0, 1, 2), got {orders}")
    device = cuda_knn._check_queries(points, None, valid)
    if device.type == "cpu":
        return morton_codes_passes_plain(points, valid, cell_size, orders)
    cuda_knn._require_cuda(device, "morton_codes")
    cuda_knn._require_contiguous(points, valid)
    codes = torch.empty((len(orders), N), dtype=torch.int32, device=device)
    if N == 0:
        return codes
    cmin = torch.empty(3, dtype=torch.int32, device=device)
    inv = 1.0 / cell_size  # the plain version's f32 scale, rounded once by ctypes
    packed = sum((o[0] | o[1] << 2 | o[2] << 4) << (6 * p) for p, o in enumerate(orders))
    cuda_knn._run("morton_min", device, lambda lib, s: lib.spt_morton_min(
        points.data_ptr(), valid.data_ptr(), N, inv, cmin.data_ptr(), s))
    cuda_knn._run("morton_codes", device, lambda lib, s: lib.spt_morton_codes(
        points.data_ptr(), valid.data_ptr(), N, inv, cmin.data_ptr(), packed, len(orders), codes.data_ptr(), s))
    return codes


def window_smem(window: int, k: int, union: bool = False) -> int:
    """Shared memory of a window-kernel block (``csrc/window_knn.cu``): its
    sorted positions (128 up to k = 16, a thread each; 64 above, 8 a warp)
    and a ``window`` halo each side, 16 B a position; the union form above
    16 adds two rows of K keys and K + 2 counts a warp."""
    K = cuda_knn.instance_k(k)
    warp = K > cuda_knn.FAST_MAX_K
    return 16 * ((64 if warp else 128) + 2 * window) + (8 * (16 * K + 4 * (K + 2)) if warp and union else 0)


def _check_tile(window: int, k: int, union: bool, name: str) -> None:
    """Raise before a launch whose tile would not fit a block's shared memory
    (the plain version on the CPU takes any window)."""
    smem = window_smem(window, k, union)
    if smem > cuda_knn.SMEM_BYTES:
        raise ValueError(f"{name} on the card stages {smem} B of shared memory at window={window}, k={k}"
                         f"{' (the union form)' if union else ''}, above a block's {cuda_knn.SMEM_BYTES}")


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


def _check_sorted(pts_s, ok_s, idx_s, window: int, k: int, name: str):
    N = pts_s.shape[0]
    if pts_s.shape != (N, 3) or ok_s.shape != (N,) or idx_s.shape != (N,):
        raise ValueError(f"expected [N,3] points, [N] validity and [N] indices, got {tuple(pts_s.shape)}, "
                         f"{tuple(ok_s.shape)}, {tuple(idx_s.shape)}")
    if pts_s.dtype != torch.float32 or ok_s.dtype != torch.bool or idx_s.dtype != torch.int32:
        raise TypeError(f"expected float32 points, bool validity and int32 indices, got {pts_s.dtype}, "
                        f"{ok_s.dtype}, {idx_s.dtype}")
    device = cuda_knn._check_queries(pts_s, None, ok_s, idx_s)
    cuda_knn.check_k(k, f"{name} (window={window})", device, 2 * window)
    if device.type != "cpu":
        cuda_knn._require_cuda(device, name)
        cuda_knn._require_contiguous(pts_s, ok_s, idx_s)
        if name == "window_search":
            _check_tile(window, k, False, name)
    return device


def window_search(pts_s: torch.Tensor, ok_s: torch.Tensor, idx_s: torch.Tensor, window: int, k: int):
    """:func:`window_search_plain` through the ``morton_window`` kernel
    (``csrc/window_knn.cu``: a block's sorted positions and their halo in
    shared memory) for CUDA tensors; CPU tensors run the plain version.
    ``idx_s`` must be a permutation of ``[0, N)``; ``k <= 2 window`` (and
    ``cuda_knn.MAX_K`` on the card, where the staged window,
    :func:`window_smem`, must fit a block's shared memory)."""
    device = _check_sorted(pts_s, ok_s, idx_s, window, k, "window_search")
    if device.type == "cpu":
        return window_search_plain(pts_s, ok_s, idx_s, window, k)
    return cuda_knn._launch("morton_window", device, (pts_s.shape[0], k), lambda lib, i, d, s: lib.spt_morton_window(
        pts_s.data_ptr(), ok_s.data_ptr(), idx_s.data_ptr(), pts_s.shape[0], window, k, i, d, s))


def morton_window_simple(pts_s: torch.Tensor, ok_s: torch.Tensor, idx_s: torch.Tensor, window: int, k: int):
    """:func:`window_search` through the first design (one thread a sorted
    position reading the sorted copies), kept for timing."""
    device = _check_sorted(pts_s, ok_s, idx_s, window, k, "morton_window_simple")
    if device.type == "cpu":
        return window_search_plain(pts_s, ok_s, idx_s, window, k)
    return cuda_knn._launch("morton_window_simple", device, (pts_s.shape[0], k),
                            lambda lib, i, d, s: lib.spt_morton_window_simple(
                                pts_s.data_ptr(), ok_s.data_ptr(), idx_s.data_ptr(), pts_s.shape[0], window, k, i,
                                d, s))


def window_union_plain(i1: torch.Tensor, d1: torch.Tensor, i2: torch.Tensor, d2: torch.Tensor, k: int):
    """The two passes' union, as JAX writes it: the ``2 k`` entries ``[pass
    1, pass 2]`` stably sorted by index, every later occurrence of an index
    at 3e38, the ``k`` smallest by a stable sort, 3e38 and above as +inf:
    ``(idx [N, k] int32, d2 [N, k])``."""
    idx, perm = torch.sort(torch.cat([i1, i2], 1), dim=1, stable=True)
    dd = torch.cat([d1, d2], 1).gather(1, perm)
    dup = torch.zeros_like(idx, dtype=torch.bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    dd = torch.where(dup, BIG, dd)
    sel = torch.sort(dd, dim=1, stable=True)[1][:, :k]
    out_d = dd.gather(1, sel)
    return idx.gather(1, sel), torch.where(out_d >= BIG, torch.inf, out_d)


def window_gather_plain(points: torch.Tensor, mask: torch.Tensor, order: torch.Tensor, window: int, k: int,
                        prev=None, final: bool = False):
    """One pass over the cloud in the order of ``order`` (the sort's
    permutation, int64): :func:`window_search_plain` of the gathered copies;
    with ``prev = (idx, d2)`` (the first pass's rows) their union by
    :func:`window_union_plain`; else 3e38 kept, or +inf where ``final``."""
    i, d = window_search_plain(points[order], mask[order], order.to(torch.int32), window, k)
    if prev is not None:
        return window_union_plain(prev[0], prev[1], i, d, k)
    return (i, torch.where(d >= BIG, torch.inf, d)) if final else (i, d)


def window_gather(points: torch.Tensor, mask: torch.Tensor, order: torch.Tensor, window: int, k: int,
                  prev=None, final: bool = False):
    """:func:`window_gather_plain` through the window kernel's gather form
    for CUDA tensors, which stages the cloud through ``order`` (no gathered
    copies), counted under ``morton_window`` (``morton_window_union`` with
    ``prev``: the second pass writes the union); CPU tensors run the plain
    version. ``order`` must be a permutation of ``[0, N)``; on the card the
    staged window, :func:`window_smem`, must fit a block's shared memory."""
    N = points.shape[0]
    if points.shape != (N, 3) or mask.shape != (N,) or order.shape != (N,):
        raise ValueError(f"expected [N,3] points, [N] validity and an [N] order, got {tuple(points.shape)}, "
                         f"{tuple(mask.shape)}, {tuple(order.shape)}")
    if points.dtype != torch.float32 or mask.dtype != torch.bool or order.dtype != torch.int64:
        raise TypeError(f"expected float32 points, bool validity and an int64 order, got {points.dtype}, "
                        f"{mask.dtype}, {order.dtype}")
    if prev is not None and (prev[0].shape != (N, k) or prev[0].dtype != torch.int32 or prev[1].shape != (N, k)
                             or prev[1].dtype != torch.float32):
        raise ValueError(f"expected the first pass's [{N},{k}] int32 / float32 rows")
    device = cuda_knn._check_queries(points, None, mask, order, *(prev or ()))
    cuda_knn.check_k(k, f"window_gather (window={window})", device, 2 * window)
    if device.type == "cpu":
        return window_gather_plain(points, mask, order, window, k, prev, final)
    cuda_knn._require_cuda(device, "morton_window")
    cuda_knn._require_contiguous(points, mask, order, *(prev or ()))
    _check_tile(window, k, prev is not None, "window_gather")
    p_i, p_d = (None, None) if prev is None else (prev[0].data_ptr(), prev[1].data_ptr())
    return cuda_knn._launch("morton_window" if prev is None else "morton_window_union", device, (N, k),
                            lambda lib, i, d, s: lib.spt_morton_window_gather(
                                points.data_ptr(), mask.data_ptr(), order.data_ptr(), N, window, k, int(final), p_i,
                                p_d, i, d, s))


def window_pass(points: torch.Tensor, mask: torch.Tensor, k: int, window: int, cell_size: float,
                axis_order: tuple):
    """One sorted-window pass: ``(idx [N, k] int32, d2 [N, k])`` in the
    original order, 3e38 where a slot has no valid partner."""
    code = morton_codes_passes(points, mask, cell_size, (axis_order,))[0]
    order = torch.sort(code, stable=True)[1]
    return window_gather(points, mask, order, window, k)


def window_self_knn_plain(points: torch.Tensor, mask: torch.Tensor, k: int, window: int = 64,
                          cell_size: float = 0.5, passes: int = 2) -> KNNResult:
    """:func:`window_self_knn` in plain PyTorch on any device: each pass's
    codes, sort, gathered copies and window search, then the union."""
    p1 = window_gather_plain(points, mask, torch.sort(morton_codes(points, mask, cell_size, AXES[0]), stable=True)[1],
                             window, k, final=passes <= 1)
    if passes <= 1:
        return KNNResult(*p1)
    order = torch.sort(morton_codes(points, mask, cell_size, AXES[1]), stable=True)[1]
    return KNNResult(*window_gather_plain(points, mask, order, window, k, prev=p1))


def window_self_knn(points: torch.Tensor, mask: torch.Tensor, k: int, window: int = 64, cell_size: float = 0.5,
                    passes: int = 2) -> KNNResult:
    """Approximate self-k-NN (every point queries the whole cloud, itself
    excluded). ``window`` is the one-sided search radius in the sorted
    order; ``passes=2`` adds a second curve (axes rotated) and keeps the
    ``k`` best of the union, a neighbour found twice counted once.

    CPU tensors run :func:`window_self_knn_plain`. CUDA tensors run the
    codes of every pass in one call, one ``torch.sort`` of them, and one
    window launch a pass, the second writing the union."""
    if points.device.type == "cpu":
        return window_self_knn_plain(points, mask, k, window, cell_size, passes)
    orders = AXES[: 1 if passes <= 1 else 2]
    cuda_knn.check_k(k, f"window_self_knn (window={window})", points.device, 2 * window)
    _check_tile(window, k, passes > 1, "window_self_knn")  # before any launch
    order = torch.sort(morton_codes_passes(points, mask, cell_size, orders), dim=1, stable=True)[1]
    p1 = window_gather(points, mask, order[0], window, k, final=passes <= 1)
    if passes <= 1:
        return KNNResult(*p1)
    return KNNResult(*window_gather(points, mask, order[1], window, k, prev=p1))
