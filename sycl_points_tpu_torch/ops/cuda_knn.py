"""Hand-written CUDA nearest-neighbour kernels: build, wrappers, plain versions.

Counterpart of :mod:`sycl_points_tpu.ops.pallas_knn` and of the two TPU
studies of its kernel. The production kernels, in ``csrc/knn_cluster.cu``,
split the target across the blocks of a thread-block cluster and read a
target prepared once by :func:`prep_target`:

  * ``nn1``   exact 1-NN with the 4x4 pose folded into the queries; replaces
              the Pallas kernel ``nn1_pallas_prepped`` (the ICP
              correspondence search);
  * ``knn_k`` exact k-NN, k <= 128 on the card (any k on the CPU); replaces
              ``_approx_knn_single``, which rests on the TPU-only
              ``lax.approx_max_k``. Up to :data:`FAST_MAX_K` one thread a
              query; above, a warp a query (:data:`KNN_WARP_QUERY_TILE`
              queries a cluster) with its list spread over the lanes. PR
              16's one-thread instances above 16, whose lists spill, stay
              as :func:`knn_k_spill` for timing.

Every production search kernel (``knn_k``, ``grid_knn``, the range-image
window, ``morton_window``, ``coarse_refine``) is built at ``k = 1 ..
FAST_MAX_K`` and at :data:`LARGE_K` (32, 64, 128): a request for ``k`` in
``(FAST_MAX_K, MAX_K]`` runs the smallest instance ``K >= k``
(:func:`instance_k`) and writes the first ``k`` entries of its list, which
are the ``k``-list, ties and padding included. Above ``MAX_K`` the card
raises; the plain versions on the CPU take any ``k`` their candidates
allow.

Both take a leading stream axis in one launch (``nn1_prepped_batched``,
``knn_k_batched`` on targets made by :func:`prep_targets`): stream ``b``'s
queries search stream ``b``'s target only, and the result equals ``B``
single-stream launches bit for bit. The fleet runs its streams through them.
A prepared target carries each stream's extent (:func:`_target_extent`, 1 +
its last valid row, made on the device), and the kernels sweep only the
rows below it: a submap extraction holds ~430 valid rows of its 16,384.

``nn1_tiled`` (``csrc/nn1_tiles.cu``) replaces the TPU tile sweep's
``make_nn1`` (``scripts/bench_pallas_tiles.py``) with the sweep's two
parameters, queries a block (:data:`NN1_QUERY_TILES_STUDY`) and target points
a chunk (:data:`NN1_TILES`): two queries a thread, the target packed once
(:func:`pack_target`) and streamed by bulk copies through a two-stage ring,
split over the grid (:func:`nn1_tiled_span`) and merged by a 64-bit
``atomicMin`` (its plain model :func:`nn1_tiled_plain`). In
``csrc/knn.cu``, the first designs, one thread a query on the raw target
and its mask: ``nn1_tiled_simple``, the study's first design at a chosen
(threads per block, target tile) instance, whose ``(128, 2048)`` instance
was the first production ``nn1``; and ``knn_k_simple``, the first ``knn_k``,
kept as the exact reference for ties. In ``csrc/nn1_variants.cu``, the
formulations of the variant study (``scripts/bench_nn1_variants.py``) on
queries already moved by the pose: ``nn1_bias`` (v1) and ``nn1_unroll2``
(v3) run in ``nn1_tiled``'s ring (``csrc/nn1_ring.cuh``) on a target made
once by :func:`pack_bias_target` (``*_prepped``; plain models
:func:`nn1_bias_plain`, :func:`nn1_unroll2_plain`), their first designs
(one thread a query on the raw target) kept as ``nn1_bias_simple`` and
``nn1_unroll2_simple``; ``nn1_lanes`` (v2, 8 or 32 lanes a query, each with
its own running best, reduced once a split) is the ring's lane form on the
same target (``nn1_lanes_prepped``; plain model :func:`nn1_lanes_plain`),
its first design kept as ``nn1_lanes_simple``. Every 1-NN kernel equals
:func:`nn1_plain`.

``csrc/range_image.cu`` holds the range-image k-NN of the raw scans; its
wrappers in :mod:`..range_image_knn` count their launches here: the window
search under ``range_image`` (:func:`..range_image_knn.range_image_window`
and the fused ``range_image_knn``), the fused path's other kernels under
``range_image_elevation``, ``range_image_cells`` and ``range_image_rows``,
and the first window design under ``range_image_simple``. The searches of
the structured targets count here too: ``grid_knn`` (``csrc/grid_knn.cu``,
wrapper :func:`..grid_knn.grid_search`, lanes a query from
:func:`grid_lanes`; its first design ``grid_knn_simple``), ``coarse_rank``
and ``coarse_refine`` (``csrc/coarse_knn.cu``, :func:`..coarse_knn.coarse_rank`
and :func:`..coarse_knn.coarse_refine`, lanes a query from
:func:`refine_lanes`; the refine's first design ``coarse_refine_simple``) and
the Morton window (``csrc/window_knn.cu``): ``morton_min`` and
``morton_codes`` (:func:`..window_knn.morton_codes_passes`), ``morton_window``
(:func:`..window_knn.window_search` and the passes of
:func:`..window_knn.window_gather`), ``morton_window_union`` (the second
pass with the union folded in) and the first design ``morton_window_simple``
(:func:`..window_knn.morton_window_simple`).

On first use every source under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` (one ``nvcc`` a source, all started together) and linked into one
shared library with a plain C interface under ``_build/``, keyed by a hash of
the sources and flags, and loaded with ``ctypes``. There is no fallback: a
missing or failing ``nvcc`` raises with its output.

Each wrapper runs its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors (or raises). ``launch_counts`` counts
kernel launches only; the plain versions never touch it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from functools import lru_cache, partial
from typing import NamedTuple, Optional

import torch

from sycl_points_tpu_torch.ops.transform import transform_points

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
)
# k on the card: one kernel instance a k up to FAST_MAX_K (the first designs
# stop there), then the LARGE_K instances up to MAX_K (the reference's largest
# KD-tree dispatch, 100, rounded up to a power of two).
FAST_MAX_K = 16
LARGE_K = (32, 64, 128)
MAX_K = LARGE_K[-1]
# The cluster kernels (csrc/knn_cluster.cu): a prepared target is padded to a
# multiple of TARGET_TILE; a cluster is one query tile (one of
# NN1_QUERY_TILES for nn1, KNN_QUERY_TILE for knn_k, KNN_WARP_QUERY_TILE
# above FAST_MAX_K) against the target's extent cut into CLUSTER_SLICES
# slices of whole 32-row units (LARGE_K_SLICES above FAST_MAX_K: a cluster of
# at most 8 blocks, the portable size), a block each; cluster_shape() chooses
# both from the host's shapes (the extents stay on the device).
TARGET_TILE = 512
CLUSTER_SLICES = (1, 2, 4, 8, 16)
LARGE_K_SLICES = (1, 2, 4, 8)
NN1_QUERY_TILES = (32, 64, 128)
KNN_QUERY_TILE = 128
KNN_WARP_QUERY_TILE = 8
BLOCKS_PER_SM = 4
# Shared memory a block can have on the H100 (227 KB).
SMEM_BYTES = 232448
# The grid search (csrc/grid_knn.cu): lanes a query, chosen by grid_lanes().
GRID_LANES = (8, 16, 32)
GRID_THREADS_PER_SM = 1024
# Instances compiled into the library (csrc/knn.cu, csrc/nn1_tiles.cu,
# csrc/nn1_variants.cu): the first tile design's threads a block, the target
# tile (first design) or chunk (nn1_tiled), nn1_tiled's queries a block.
NN1_THREADS = (64, 128, 256, 512)
NN1_TILES = (512, 1024, 2048, 4096)
NN1_QUERY_TILES_STUDY = (64, 128, 256, 512)
NN1_LANES = (8, 32)
# nn1_tiled's split of the target over the grid (nn1_tiled_span): enough
# blocks for NN1_TILED_WARPS_PER_SM warps an SM (a thread holds
# NN1_TILED_QUERIES_A_THREAD queries), no split under NN1_TILED_MIN_SPAN rows;
# on the CPU the plan of an H100's H100_SMS.
NN1_TILED_QUERIES_A_THREAD = 2
NN1_TILED_WARPS_PER_SM = 32
NN1_TILED_MIN_SPAN = 256
H100_SMS = 132
# The variant study's v1 / v3 in the ring: the bias of a masked row (the TPU
# study's _BIG; valid squared distances must stay below it), and each form's
# (queries a block, target rows a chunk), the instance fastest at the pair's
# shape (1,000 queries against 24,576 rows) in the study's sweep
# (scripts/bench_nn1_variants.py --sweep): 256 queries a block; there a
# split is 256 rows, under any chunk, so every chunk reads the same, and
# 1,024 is the fastest chunk at 256 queries at the study's larger shapes.
BIAS_BIG = 3.0e38
NN1_BIAS_INSTANCE = (256, 1024)
NN1_UNROLL2_INSTANCE = (256, 1024)
# v2 in the ring (nn1_lanes_prepped): lanes -> (query tile, chunk), the
# instance fastest at the pair's shape in the same sweep. A lane form's query
# tile counts (query, lane) slots: query_tile / 2 threads and query_tile /
# lanes queries a block (64 a block at 8 lanes, 8 at 32).
NN1_LANES_INSTANCE = {8: (512, 1024), 32: (256, 1024)}

# Kernel launches per wrapper; reset with reset_launch_counts().
launch_counts = {
    "nn1": 0, "knn_k": 0, "nn1_batched": 0, "knn_k_batched": 0, "knn_k_simple": 0,
    "nn1_tiled": 0, "nn1_tiled_simple": 0, "nn1_bias": 0, "nn1_bias_simple": 0, "nn1_lanes": 0, "nn1_unroll2": 0,
    "nn1_lanes_simple": 0, "nn1_unroll2_simple": 0, "range_image": 0,
    "range_image_elevation": 0, "range_image_cells": 0, "range_image_rows": 0, "range_image_simple": 0,
    "grid_knn": 0, "grid_knn_simple": 0, "coarse_rank": 0, "coarse_refine": 0, "coarse_refine_simple": 0,
    "morton_min": 0, "morton_codes": 0, "morton_window": 0, "morton_window_union": 0, "morton_window_simple": 0,
    "knn_k_spill": 0, "range_image_spill": 0,
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
# launch_counts is updated under a lock (a fleet's shards launch from one
# host thread each); each thread also keeps its own count.
_count_lock = threading.Lock()
_local = threading.local()

# Plain versions bound the [rows, M] distance block they materialise.
_PLAIN_BLOCK_ELEMS = 1 << 24


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def thread_launches() -> Counter:
    """The launches made on the calling thread since it began, by wrapper
    (never reset: a caller takes differences)."""
    launches = getattr(_local, "launches", None)
    if launches is None:
        launches = _local.launches = Counter()
    return launches


def count_launch(name: str) -> None:
    """Count one launch of ``name`` in :data:`launch_counts` and in the
    calling thread's :func:`thread_launches`."""
    with _count_lock:
        launch_counts[name] += 1
    thread_launches()[name] += 1


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
        candidate = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(candidate):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; cannot build the kNN kernels")
    return nvcc


def build_library() -> str:
    """Compile every ``csrc/*.cu`` into one library unless a library for these
    sources (headers included) and these flags exists; returns its path."""
    files = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    sources = [f for f in files if f.endswith(".cu")]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in files:
        with open(name, "rb") as f:
            digest.update(os.path.basename(name).encode() + b"\0" + f.read())
    path = os.path.join(BUILD_DIR, f"libspt_knn_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objects = [os.path.join(work, os.path.basename(src) + ".o") for src in sources]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objects)
        ]
        outputs = [p.communicate()[0] for p in procs]
        failed = [f"{src} ({p.returncode}):\n{out}" for src, p, out in zip(sources, procs, outputs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed compiling " + "\n".join(failed))
        lib = os.path.join(work, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objects], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) linking {objects}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(lib, path)
    return path


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.spt_nn1_batched.argtypes = [p, i, p, p, i, p, i, i, i, p, p, p]
            lib.spt_knn_k_batched.argtypes = [p, i, p, p, i, i, i, i, p, p, p]
            lib.spt_knn_k_spill_batched.argtypes = [p, i, p, p, i, i, i, i, p, p, p]
            lib.spt_knn_k_simple.argtypes = [p, p, i, p, i, i, p, p, p]
            lib.spt_nn1_tiled_simple.argtypes = [p, p, i, p, i, i, i, p, p, p]
            lib.spt_nn1_tiled.argtypes = [p, i, p, i, i, i, i, p, p, p, p]
            lib.spt_nn1_bias.argtypes = [p, i, p, i, i, i, i, p, p, p, p]
            lib.spt_nn1_unroll2.argtypes = [p, i, p, i, i, i, i, p, p, p, p]
            lib.spt_nn1_bias_simple.argtypes = [p, p, i, p, i, p, p, p]
            lib.spt_nn1_lanes.argtypes = [p, i, p, i, i, i, i, i, p, p, p, p]
            lib.spt_nn1_lanes_simple.argtypes = [p, p, i, p, i, i, p, p, p]
            lib.spt_nn1_unroll2_simple.argtypes = [p, p, i, p, i, p, p, p]
            f = ctypes.c_float
            lib.spt_range_image_window.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p]
            lib.spt_range_image_window_spill.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p]
            lib.spt_range_image_window_simple.argtypes = [p, p, i, i, i, i, i, p, p, p]
            lib.spt_range_image_elevation.argtypes = [p, p, i, p, p]
            lib.spt_range_image_cells.argtypes = [p, p, i, i, i, p, f, f, i, i, f, f, p, p, p, p, p]
            lib.spt_range_image_rows.argtypes = [p, p, p, i, i, i, p, p, p]
            lib.spt_grid_knn.argtypes = [p, i, p, f, p, p, p, i, p, p, p, p, i, i, i, i, i, p, p, p]
            lib.spt_grid_knn_simple.argtypes = [p, i, p, f, p, p, p, i, p, p, p, p, i, i, i, i, p, p, p]
            lib.spt_coarse_refine.argtypes = [p, i, p, i, p, p, p, i, p, p, p, i, p, p, i, i, p, p, p, p]
            lib.spt_coarse_refine_simple.argtypes = [p, i, p, i, p, p, p, i, p, p, p, i, p, p, i, p, p, p, p]
            lib.spt_coarse_rank.argtypes = [p, i, p, p, p, i, p, f, i, p, p, p]
            lib.spt_morton_window.argtypes = [p, p, p, i, i, i, p, p, p]
            lib.spt_morton_window_simple.argtypes = [p, p, p, i, i, i, p, p, p]
            lib.spt_morton_window_gather.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p]
            lib.spt_morton_min.argtypes = [p, p, i, f, p, p]
            lib.spt_morton_codes.argtypes = [p, p, i, f, p, i, i, p, p]
            for fn in (lib.spt_nn1_batched, lib.spt_knn_k_batched, lib.spt_knn_k_spill_batched,
                       lib.spt_knn_k_simple, lib.spt_nn1_tiled_simple, lib.spt_nn1_tiled,
                       lib.spt_nn1_bias, lib.spt_nn1_unroll2, lib.spt_nn1_bias_simple, lib.spt_nn1_lanes,
                       lib.spt_nn1_lanes_simple, lib.spt_nn1_unroll2_simple,
                       lib.spt_range_image_window, lib.spt_range_image_window_spill,
                       lib.spt_range_image_window_simple,
                       lib.spt_range_image_elevation, lib.spt_range_image_cells, lib.spt_range_image_rows,
                       lib.spt_grid_knn, lib.spt_grid_knn_simple, lib.spt_coarse_refine,
                       lib.spt_coarse_refine_simple, lib.spt_coarse_rank, lib.spt_morton_window,
                       lib.spt_morton_window_simple, lib.spt_morton_window_gather, lib.spt_morton_min,
                       lib.spt_morton_codes):
                fn.restype = i
            _lib = lib
    return _lib


def _check_queries(queries, pose, *others):
    """Check ``queries [Q,3]`` f32 and ``pose [4,4]`` f32 (or None), all on
    the device of ``others``; returns that device."""
    Q = queries.shape[0]
    if queries.shape != (Q, 3):
        raise ValueError(f"expected [Q,3] queries, got {tuple(queries.shape)}")
    if pose is not None and pose.shape != (4, 4):
        raise ValueError(f"expected a [4,4] pose, got {tuple(pose.shape)}")
    tensors = [*others, queries] + ([] if pose is None else [pose])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on more than one device: {devices}")
    for t in (queries,) + (() if pose is None else (pose,)):
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 coordinates, got {t.dtype}")
    return devices.pop()


def _check_target(target_xyz, target_mask):
    M = target_xyz.shape[0]
    if target_xyz.shape != (M, 3):
        raise ValueError(f"expected [M,3] targets, got {tuple(target_xyz.shape)}")
    if target_mask.shape != (M,):
        raise ValueError(f"expected a [{M}] target mask, got {tuple(target_mask.shape)}")
    if target_xyz.dtype != torch.float32:
        raise TypeError(f"expected float32 coordinates, got {target_xyz.dtype}")
    if target_mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"expected a bool or uint8 mask, got {target_mask.dtype}")


def _check_inputs(target_xyz, target_mask, queries, pose=None):
    _check_target(target_xyz, target_mask)
    return _check_queries(queries, pose, target_xyz, target_mask)


def _require_cuda(device, name: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {device}")


def instance_k(k: int) -> int:
    """The kernel instance that serves a request for ``k`` on the card:
    ``k`` itself up to :data:`FAST_MAX_K`, else the smallest of
    :data:`LARGE_K` at or above it (``csrc/best_k.cuh``'s ``instance_k``)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"no kernel instance serves k={k}: 1 <= k <= {MAX_K}")
    return k if k <= FAST_MAX_K else next(K for K in LARGE_K if K >= k)


def check_k(k: int, name: str, device, cap: Optional[int] = None) -> None:
    """Refuse ``k`` below 1 or above the search's candidate count ``cap``
    everywhere, and above :data:`MAX_K` on the card (the CPU's plain
    versions take any ``k``)."""
    if k < 1 or (cap is not None and k > cap):
        raise ValueError(f"{name} takes 1 <= k <= {cap if cap is not None else 'any'} (its candidates), got {k}")
    if device.type != "cpu" and k > MAX_K:
        raise ValueError(f"{name} on the card takes k <= {MAX_K} (its largest kernel instance), got {k}; "
                         f"the CPU path is unbounded")


def check_fast_k(k: int, name: str) -> None:
    """The first designs' bound: one instance a k up to :data:`FAST_MAX_K`."""
    if not 1 <= k <= FAST_MAX_K:
        raise ValueError(f"{name} (a first design) takes 1 <= k <= {FAST_MAX_K}, got {k}")


def _require_contiguous(*tensors):
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("the kNN kernels take contiguous tensors")


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


# --------------------------------------------------------------------------
# The prepared target
# --------------------------------------------------------------------------


class PreppedTarget(NamedTuple):
    """A kernel-ready target: ``xyz [3, Mp]`` float32, the x, y and z rows,
    with masked rows and the padding up to ``Mp`` (a multiple of
    :data:`TARGET_TILE`) at +inf; ``M`` is the true target count. A fleet's
    targets (:func:`prep_targets`) are ``xyz [B, 3, Mp]``, one a stream.

    ``extent`` (int32 ``[B]``, ``[1]`` for one stream, on the target's
    device) is 1 + the index of each stream's last valid row, 0 for a stream
    with none: every row from it on is +inf, so the kernels sweep only
    ``[0, extent)``. A target built without one sweeps all of ``Mp``."""

    xyz: torch.Tensor
    M: int
    extent: Optional[torch.Tensor] = None

    def points(self) -> torch.Tensor:
        """``[M, 3]`` (``[B, M, 3]``) coordinates, +inf on masked rows (a view)."""
        return self.xyz[..., : self.M].transpose(-1, -2)


def prep_target(points: torch.Tensor, mask: torch.Tensor) -> PreppedTarget:
    """The target as the cluster kernels read it, made once for any number of
    searches (the counterpart of ``pallas_knn.prep_target``): an +inf target
    has an +inf distance, which no strict ``<`` takes, so the kernels read
    whole aligned tiles with no mask and no edge test."""
    _check_target(points, mask)
    return _prep(points, mask)


def _prep(points, mask) -> PreppedTarget:
    if points.device != mask.device:
        raise ValueError(f"inputs on more than one device: {points.device}, {mask.device}")
    M = points.shape[-2]
    Mp = -(-M // TARGET_TILE) * TARGET_TILE
    valid = mask.bool()
    xyz = torch.where(valid[..., None, :], points.transpose(-1, -2), torch.inf)
    return PreppedTarget(torch.nn.functional.pad(xyz, (0, Mp - M), value=torch.inf).contiguous(), M,
                         _target_extent(valid))


def _target_extent(valid: torch.Tensor) -> torch.Tensor:
    """1 + the index of the last true entry of each row of ``valid [..., M]``
    (0 for a row with none), as int32 ``[B]`` (``[1]`` for one row), made on
    ``valid``'s device with no host read."""
    if valid.shape[-1] == 0:
        return torch.zeros(valid.shape[:-1].numel(), dtype=torch.int32, device=valid.device)
    rows = torch.arange(1, valid.shape[-1] + 1, dtype=torch.int32, device=valid.device)
    return torch.where(valid, rows, 0).amax(-1).reshape(-1)


def prep_targets(points: torch.Tensor, mask: torch.Tensor) -> PreppedTarget:
    """The targets of ``B`` streams, ``points [B, M, 3]`` and ``mask [B, M]``,
    as the batched kernels read them: ``xyz [B, 3, Mp]``, stream ``b`` equal
    to ``prep_target(points[b], mask[b])``."""
    if points.dim() != 3 or points.shape[-1] != 3 or mask.shape != points.shape[:2]:
        raise ValueError(f"expected [B,M,3] targets and a [B,M] mask, got {tuple(points.shape)}, "
                         f"{tuple(mask.shape)}")
    if points.dtype != torch.float32:
        raise TypeError(f"expected float32 coordinates, got {points.dtype}")
    return _prep(points, mask)


def _check_prepped(prep: PreppedTarget, queries, pose):
    xyz = prep.xyz
    if xyz.dim() != 2 or xyz.shape[0] != 3 or xyz.shape[1] % TARGET_TILE or not 0 <= prep.M <= xyz.shape[1]:
        raise ValueError(f"expected a prepared [3, Mp] target, Mp a multiple of {TARGET_TILE}, "
                         f"got {tuple(xyz.shape)} with M={prep.M}")
    if xyz.dtype != torch.float32:
        raise TypeError(f"expected float32 coordinates, got {xyz.dtype}")
    return _check_queries(queries, pose, xyz)


def _check_prepped_batched(prep: PreppedTarget, queries, poses):
    """Check a fleet's prepared targets ``[B, 3, Mp]``, queries ``[B, Q, 3]``
    and poses ``[B, 4, 4]`` (or None); returns their device."""
    xyz = prep.xyz
    if xyz.dim() != 3 or xyz.shape[1] != 3 or xyz.shape[2] % TARGET_TILE or not 0 <= prep.M <= xyz.shape[2]:
        raise ValueError(f"expected prepared [B, 3, Mp] targets, Mp a multiple of {TARGET_TILE}, "
                         f"got {tuple(xyz.shape)} with M={prep.M}")
    B = xyz.shape[0]
    if queries.dim() != 3 or queries.shape[0] != B or queries.shape[2] != 3:
        raise ValueError(f"expected [{B},Q,3] queries, got {tuple(queries.shape)}")
    if poses is not None and poses.shape != (B, 4, 4):
        raise ValueError(f"expected [{B},4,4] poses, got {tuple(poses.shape)}")
    tensors = [xyz, queries] + ([] if poses is None else [poses])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on more than one device: {devices}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 coordinates, got {t.dtype}")
    return devices.pop()


# --------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the reference for the kernels)
# --------------------------------------------------------------------------


def _sqdist_block(q: torch.Tensor, t: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Exact ``[Q, M]`` squared distances ``e0*e0 + e1*e1 + e2*e2`` (the
    kernels' operation order); invalid targets are +inf."""
    e = q[:, None, :] - t[None, :, :]
    d2 = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]
    return d2 if valid is None else torch.where(valid[None, :], d2, torch.inf)


def _query_chunk(M: int) -> int:
    return max(1, _PLAIN_BLOCK_ELEMS // max(M, 1))


def _nn1_plain(target_xyz, valid, queries, pose):
    if pose is not None:
        queries = transform_points(queries, pose)
    Q, M = queries.shape[0], target_xyz.shape[0]
    idx = torch.zeros(Q, dtype=torch.int32, device=queries.device)
    d2 = torch.full((Q,), torch.inf, dtype=torch.float32, device=queries.device)
    if M == 0:
        return idx, d2
    step = _query_chunk(M)
    for s in range(0, Q, step):
        block = _sqdist_block(queries[s : s + step], target_xyz, valid)
        d, i = torch.min(block, dim=1)
        idx[s : s + step] = i.to(torch.int32)
        d2[s : s + step] = d
    return idx, d2


def nn1_plain(target_xyz, target_mask, queries, pose=None):
    """Exact 1-NN: ``(idx [Q] int32, d2 [Q] f32)``; the earliest index wins
    ties; with no valid target, idx 0 and d2 = +inf."""
    return _nn1_plain(target_xyz, target_mask.bool(), queries, pose)


def _knn_k_plain(target_xyz, valid, queries, k: int, ties_by_index: bool = False):
    Q, M = queries.shape[0], target_xyz.shape[0]
    idx = torch.zeros((Q, k), dtype=torch.int32, device=queries.device)
    d2 = torch.full((Q, k), torch.inf, dtype=torch.float32, device=queries.device)
    kk = min(k, M)
    if kk == 0:
        return idx, d2
    step = _query_chunk(M)
    for s in range(0, Q, step):
        block = _sqdist_block(queries[s : s + step], target_xyz, valid)
        if ties_by_index:  # whole rows sorted stably: equal distances keep the index order
            d, i = (x[:, :kk] for x in torch.sort(block, dim=1, stable=True))
        else:
            d, i = torch.topk(block, kk, dim=1, largest=False, sorted=True)
        idx[s : s + step, :kk] = torch.where(torch.isfinite(d), i, 0).to(torch.int32)
        d2[s : s + step, :kk] = d
    return idx, d2


def knn_k_plain(target_xyz, target_mask, queries, k: int):
    """Exact k-NN, ascending: ``(idx [Q,k] int32, d2 [Q,k] f32)``. Slots with
    no valid neighbour get idx 0 and d2 = +inf."""
    return _knn_k_plain(target_xyz, target_mask.bool(), queries, k)


def knn_k_sorted_plain(target_xyz, target_mask, queries, k: int):
    """:func:`knn_k_plain` with its ties ordered as the kernels order them,
    the lower index first (``topk`` on the card orders ties in no stated
    way): the bit-exact reference of ``knn_k`` above :data:`FAST_MAX_K`,
    where ``knn_k_simple`` stops. It sorts whole rows, so it is for checks,
    not for the path."""
    return _knn_k_plain(target_xyz, target_mask.bool(), queries, k, ties_by_index=True)


def nn1_batched_plain(target_xyz, target_mask, queries, poses=None):
    """:func:`nn1_plain` of every stream: ``target_xyz [B,M,3]``,
    ``target_mask [B,M]``, ``queries [B,Q,3]``, ``poses [B,4,4]`` (or None)
    -> ``(idx [B,Q] int32, d2 [B,Q] f32)``."""
    out = [_nn1_plain(target_xyz[b], None if target_mask is None else target_mask[b].bool(), queries[b],
                      None if poses is None else poses[b]) for b in range(queries.shape[0])]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def knn_k_batched_plain(target_xyz, target_mask, queries, k: int):
    """:func:`knn_k_plain` of every stream: ``(idx [B,Q,k] int32, d2
    [B,Q,k] f32)``."""
    out = [_knn_k_plain(target_xyz[b], None if target_mask is None else target_mask[b].bool(), queries[b], k)
           for b in range(queries.shape[0])]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def nn1_mismatches(idx, d2, ref_idx, ref_d2, tie_tol: float = 1e-6) -> int:
    """Rows whose 1-NN index differs from the reference's without the two
    distances lying within ``tie_tol`` (both +inf counts as a tie)."""
    both_inf = torch.isinf(d2) & torch.isinf(ref_d2)
    tie = both_inf | ((d2 - ref_d2).abs() <= tie_tol)
    return int(((idx.long() != ref_idx.long()) & ~tie).sum())


def knn_mismatches(idx, d2, ref_idx, ref_d2, tie_tol: float) -> int:
    """Rows whose k-NN sets differ from the reference's beyond ties.

    Only finite entries count. A member missing from the other set is
    allowed only if its distance lies within ``tie_tol`` of the row's k-th
    distance; the rows must also hold the same number of finite entries."""
    idx, ref_idx = idx.long(), ref_idx.long()
    fin, fin_r = torch.isfinite(d2), torch.isfinite(ref_d2)
    neg = torch.full((), -torch.inf, device=d2.device)
    kth = torch.maximum(
        torch.where(fin, d2, neg).amax(-1), torch.where(fin_r, ref_d2, neg).amax(-1)
    )[:, None]
    in_ref = ((idx[:, :, None] == ref_idx[:, None, :]) & fin_r[:, None, :]).any(-1)
    in_out = ((ref_idx[:, :, None] == idx[:, None, :]) & fin[:, None, :]).any(-1)
    bad = (fin & ~in_ref & (d2 < kth - tie_tol)).any(-1)
    bad |= (fin_r & ~in_out & (ref_d2 < kth - tie_tol)).any(-1)
    bad |= fin.sum(-1) != fin_r.sum(-1)
    return int(bad.sum())


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cluster_shape(Q: int, query_tiles, n_sm: int, streams: int = 1,
                  slice_counts: tuple = CLUSTER_SLICES) -> tuple[int, int]:
    """``(queries a cluster, slices a cluster)`` for ``Q`` queries in each of
    ``streams`` streams: the largest query tile, then the fewest slices, that
    give the grid ``BLOCKS_PER_SM`` blocks an SM, else the smallest tile and
    the most slices. On the H100 (132 SMs) Q=1000 runs 32 x 16 = 512 blocks
    and Q=24,576 runs 192 x 4 = 768: few queries take many slices, many take
    few, as a merge costs more than a block saves there. A fleet's query
    tiles are counted over all its streams: 8 streams of 1000 queries run
    64 tiles of 128 queries x 16 slices, where one stream alone runs 32 x
    16. ``slice_counts`` are the slice counts to choose from
    (:data:`LARGE_K_SLICES` for knn_k above :data:`FAST_MAX_K`)."""
    want = BLOCKS_PER_SM * n_sm
    tiles = lambda qt: streams * -(-Q // qt)
    qt = next((qt for qt in sorted(query_tiles, reverse=True) if tiles(qt) * slice_counts[-1] >= want),
              min(query_tiles))
    slices = next((s for s in slice_counts if tiles(qt) * s >= want), slice_counts[-1])
    return qt, slices


def knn_slices(k: int) -> tuple:
    """The slice counts knn_k's instance for ``k`` may take."""
    return CLUSTER_SLICES if k <= FAST_MAX_K else LARGE_K_SLICES


def knn_cluster_slices(Q: int, k: int, n_sm: int, streams: int = 1) -> int:
    """The slices a cluster of knn_k at ``k`` for ``Q`` queries in each of
    ``streams`` streams: :func:`cluster_shape` at its query tile
    (:data:`KNN_QUERY_TILE` up to :data:`FAST_MAX_K`, a warp a query's
    :data:`KNN_WARP_QUERY_TILE` above). On the H100 the LO scan's 5,000
    queries take 1 slice above 16 (625 blocks of 8 queries), where the one-thread
    128-query tiles took 8."""
    tile = KNN_QUERY_TILE if k <= FAST_MAX_K else KNN_WARP_QUERY_TILE
    return cluster_shape(Q, (tile,), n_sm, streams, knn_slices(k))[1]


def grid_lanes(Q: int, n_sm: int) -> int:
    """Lanes a query of the ``grid_knn`` kernel for ``Q`` queries: the fewest
    of :data:`GRID_LANES` whose ``Q x G`` threads give the card
    :data:`GRID_THREADS_PER_SM` an SM, else the most. On the H100 (132 SMs)
    Q = 1,000 and 5,000 take 32 lanes (a warp a query), 12,000 take 16 and
    30,000 take 8: few queries spread their ~200 candidates over a warp,
    many keep the card full with fewer lanes and shorter merges."""
    want = GRID_THREADS_PER_SM * n_sm
    return next((g for g in GRID_LANES if Q * g >= want), GRID_LANES[-1])


def refine_lanes(candidates: int, k: int) -> int:
    """Lanes a query of the lane-group ``coarse_refine`` for ``k`` nearest
    among at most ``candidates`` (P x L) slots a query. Up to
    :data:`FAST_MAX_K`, a warp a query, halved (down to 8) while a lane
    would have fewer than 4 slots: unlike ``grid_knn``'s ~200 candidates, a
    CoarseKNN query walks hundreds to thousands of them, and the queries
    beside a dense cell bound the launch (on the H100 at 30,000 queries 32
    lanes were the fastest at every build measured, where
    :func:`grid_lanes` picks 8). Above it 8 lanes: every lane fills a list
    of K = 32 to 128 entries, which spill, and the fewer lists the fewer
    insertions (8 lanes the fastest there; PERF.md, PR 16)."""
    if k > FAST_MAX_K:
        return GRID_LANES[0]
    g = GRID_LANES[-1]
    while g > GRID_LANES[0] and candidates < 4 * g:
        g //= 2
    return g


def _run(name, device, call) -> None:
    """Run ``call(lib, stream)`` once on ``device``'s current stream, raise on
    its error code and count it under ``name``."""
    lib = load_library()
    with torch.cuda.device(device):
        rc = call(lib, torch.cuda.current_stream(device).cuda_stream)
    _check_rc(rc, name)
    count_launch(name)


def _launch(name, device, shape, call):
    """Allocate ``idx`` (int32) and ``d2`` (f32) of ``shape`` on ``device``,
    then, unless they are empty, run ``call(lib, idx_ptr, d2_ptr, stream)``
    once on the current stream, raise on its error code and count it under
    ``name``."""
    idx = torch.empty(shape, dtype=torch.int32, device=device)
    d2 = torch.empty(shape, dtype=torch.float32, device=device)
    if idx.numel() == 0:
        return idx, d2
    _run(name, device, lambda lib, s: call(lib, idx.data_ptr(), d2.data_ptr(), s))
    return idx, d2


def _check_prepped_cuda(prep: PreppedTarget, queries, pose, device, name: str) -> None:
    _require_cuda(device, name)
    _require_contiguous(prep.xyz, queries, pose, prep.extent)
    if prep.xyz.data_ptr() % 16:
        raise ValueError(f"{name} reads the prepared target in 16-byte copies: it must be 16-byte aligned")
    e = prep.extent
    streams = prep.xyz.shape[0] if prep.xyz.dim() == 3 else 1
    if e is not None and (e.shape != (streams,) or e.dtype != torch.int32 or e.device != device):
        raise ValueError(f"{name} takes an int32 [{streams}] extent on {device}, got "
                         f"{e.dtype} {tuple(e.shape)} on {e.device}")


def _extent_ptr(prep: PreppedTarget):
    return None if prep.extent is None else prep.extent.data_ptr()


def _nn1_cluster(name: str, prep: PreppedTarget, queries, poses, query_tile: int, slices: int):
    """Launch the cluster nn1 once, at ``query_tile`` queries and ``slices``
    blocks a cluster, on a checked target (``[3, Mp]`` with queries ``[Q,
    3]``, or ``[B, 3, Mp]`` with ``[B, Q, 3]``), counted under ``name``."""
    B, Q = (1, queries.shape[0]) if queries.dim() == 2 else queries.shape[:2]
    pose_ptr = None if poses is None else poses.data_ptr()
    return _launch(name, queries.device, queries.shape[:-1], lambda lib, i, d, s: lib.spt_nn1_batched(
        prep.xyz.data_ptr(), prep.xyz.shape[-1], _extent_ptr(prep), queries.data_ptr(), Q, pose_ptr, B,
        query_tile, slices, i, d, s))


def _knn_k_cluster(name: str, prep: PreppedTarget, queries, k: int, slices: int):
    """Launch the cluster knn_k once at ``slices`` blocks a cluster; as
    :func:`_nn1_cluster`."""
    B, Q = (1, queries.shape[0]) if queries.dim() == 2 else queries.shape[:2]
    return _launch(name, queries.device, (*queries.shape[:-1], k), lambda lib, i, d, s: lib.spt_knn_k_batched(
        prep.xyz.data_ptr(), prep.xyz.shape[-1], _extent_ptr(prep), queries.data_ptr(), Q, B, k, slices, i, d, s))


def nn1_prepped(prep: PreppedTarget, queries, pose=None):
    """Exact 1-NN of ``queries [Q,3]`` (moved by ``pose [4,4]`` if given)
    against a target made by :func:`prep_target`: ``(idx [Q] int32, d2 [Q]
    f32)``, the earliest index on ties, idx 0 and d2 = +inf with no valid
    target. The ICP loop's call: the target is prepared once per align.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    device = _check_prepped(prep, queries, pose)
    if device.type == "cpu":
        return _nn1_plain(prep.points(), None, queries, pose)
    _check_prepped_cuda(prep, queries, pose, device, "nn1")
    return _nn1_cluster("nn1", prep, queries, pose,
                        *cluster_shape(queries.shape[0], NN1_QUERY_TILES, _sm_count(device.index)))


def nn1(target_xyz, target_mask, queries, pose=None):
    """Exact 1-NN of ``queries [Q,3]`` (moved by ``pose [4,4]`` if given)
    against the masked ``target_xyz [M,3]``: ``(idx [Q] int32, d2 [Q] f32)``.
    Prepares the target for this one call; see :func:`nn1_prepped`."""
    _check_inputs(target_xyz, target_mask, queries, pose)
    return nn1_prepped(prep_target(target_xyz, target_mask), queries, pose)


def knn_k_prepped(prep: PreppedTarget, queries, k: int):
    """Exact k nearest neighbours (``k >= 1``; at most :data:`MAX_K` on the
    card) of ``queries [Q,3]`` in a target made by :func:`prep_target`,
    ascending by distance, lower index first on ties: ``(idx [Q,k] int32, d2
    [Q,k] f32)``; slots with no valid neighbour get idx 0 and d2 = +inf.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    device = _check_prepped(prep, queries, None)
    check_k(k, "knn_k", device)
    if device.type == "cpu":
        return _knn_k_plain(prep.points(), None, queries, k)
    _check_prepped_cuda(prep, queries, None, device, "knn_k")
    return _knn_k_cluster("knn_k", prep, queries, k, knn_cluster_slices(queries.shape[0], k, _sm_count(device.index)))


def knn_k(target_xyz, target_mask, queries, k: int):
    """Exact k nearest neighbours (``k >= 1``; at most :data:`MAX_K` on the
    card) of ``queries [Q,3]`` in the masked ``target_xyz [M,3]``. Prepares the target for this one call;
    see :func:`knn_k_prepped`."""
    _check_inputs(target_xyz, target_mask, queries)
    return knn_k_prepped(prep_target(target_xyz, target_mask), queries, k)


def nn1_prepped_batched(prep: PreppedTarget, queries, poses=None):
    """Exact 1-NN of the queries ``[B,Q,3]`` of ``B`` streams (moved by
    ``poses [B,4,4]`` if given) against their targets made by
    :func:`prep_targets`, in one launch: ``(idx [B,Q] int32, d2 [B,Q]
    f32)``, equal to :func:`nn1_prepped` of each stream.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    device = _check_prepped_batched(prep, queries, poses)
    if device.type == "cpu":
        return nn1_batched_plain(prep.points(), None, queries, poses)
    _check_prepped_cuda(prep, queries, poses, device, "nn1_batched")
    B, Q = queries.shape[:2]
    return _nn1_cluster("nn1_batched", prep, queries, poses,
                        *cluster_shape(Q, NN1_QUERY_TILES, _sm_count(device.index), B))


def knn_k_batched(prep: PreppedTarget, queries, k: int):
    """Exact k nearest neighbours (``k >= 1``; at most :data:`MAX_K` on the
    card) of the queries ``[B,Q,3]`` of ``B`` streams in their targets made
    by :func:`prep_targets`, in one launch: ``(idx [B,Q,k] int32, d2
    [B,Q,k] f32)``, equal to :func:`knn_k_prepped` of each stream.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    device = _check_prepped_batched(prep, queries, None)
    check_k(k, "knn_k", device)
    if device.type == "cpu":
        return knn_k_batched_plain(prep.points(), None, queries, k)
    _check_prepped_cuda(prep, queries, None, device, "knn_k_batched")
    B, Q = queries.shape[:2]
    return _knn_k_cluster("knn_k_batched", prep, queries, k, knn_cluster_slices(Q, k, _sm_count(device.index), B))


def knn_k_spill(prep: PreppedTarget, queries, k: int):
    """:func:`knn_k_prepped` (``queries [Q,3]``, a ``[3, Mp]`` target) or
    :func:`knn_k_batched` (``[B,Q,3]``, ``[B, 3, Mp]``) above
    :data:`FAST_MAX_K` through the first instances: one thread a query, its
    K-list in registers (spilled at K = 64 and 128), 128 queries a cluster.
    Kept for timing against the warp-a-query instances; the same result."""
    if not FAST_MAX_K < k <= MAX_K:
        raise ValueError(f"knn_k_spill serves {FAST_MAX_K} < k <= {MAX_K}, got {k}")
    batched = queries.dim() == 3
    device = (_check_prepped_batched if batched else _check_prepped)(prep, queries, None)
    if device.type == "cpu":
        return (knn_k_batched_plain if batched else _knn_k_plain)(prep.points(), None, queries, k)
    _check_prepped_cuda(prep, queries, None, device, "knn_k_spill")
    B, Q = queries.shape[:2] if batched else (1, queries.shape[0])
    _, slices = cluster_shape(Q, (KNN_QUERY_TILE,), _sm_count(device.index), B, LARGE_K_SLICES)
    return _launch("knn_k_spill", device, (*queries.shape[:-1], k), lambda lib, i, d, s: lib.spt_knn_k_spill_batched(
        prep.xyz.data_ptr(), prep.xyz.shape[-1], _extent_ptr(prep), queries.data_ptr(), Q, B, k, slices, i, d, s))


def _raw_launch(name, entry, target_xyz, target_mask, queries, shape, extra):
    """The first designs' shared body (raw target and mask): launch
    ``lib.<entry>(tgt, mask, M, queries, Q, *extra, idx, d2, stream)``."""
    _require_contiguous(target_xyz, target_mask, queries)
    M, Q = target_xyz.shape[0], queries.shape[0]
    return _launch(name, queries.device, shape, lambda lib, i, d, s: getattr(lib, entry)(
        target_xyz.data_ptr(), target_mask.data_ptr(), M, queries.data_ptr(), Q, *extra, i, d, s))


def knn_k_simple(target_xyz, target_mask, queries, k: int):
    """:func:`knn_k` through its first design (one thread a query, the whole
    target per block, ``csrc/knn.cu``): the exact reference the cluster
    kernel is held to, ties included, and timed against; ``k <= 16``."""
    check_fast_k(k, "knn_k_simple")
    device = _check_inputs(target_xyz, target_mask, queries)
    if device.type == "cpu":
        return knn_k_plain(target_xyz, target_mask, queries, k)
    _require_cuda(device, "knn_k_simple")
    return _raw_launch("knn_k_simple", "spt_knn_k_simple", target_xyz, target_mask, queries,
                       (queries.shape[0], k), (k,))


def _nn1_launch(name, entry, target_xyz, target_mask, queries, extra=()):
    """The study 1-NN wrappers' shared body: check the inputs, run
    :func:`nn1_plain` for CPU tensors, else launch the study kernel once on
    the raw target and mask and count it under ``name``."""
    device = _check_inputs(target_xyz, target_mask, queries)
    if device.type == "cpu":
        return nn1_plain(target_xyz, target_mask, queries)
    _require_cuda(device, name)
    return _raw_launch(name, entry, target_xyz, target_mask, queries, (queries.shape[0],), extra)


def nn1_tiled_simple(target_xyz, target_mask, queries, threads: int, tile: int):
    """:func:`nn1` without a pose, through the TPU tile study's first design
    (one thread a query, ``csrc/knn.cu``) at the instance with ``threads``
    per block (one of :data:`NN1_THREADS`) and a shared-memory target tile of
    ``tile`` points (one of :data:`NN1_TILES`). ``(128, 2048)`` was the first
    production instance. Kept as the reference :func:`nn1_tiled` is timed
    against."""
    if threads not in NN1_THREADS or tile not in NN1_TILES:
        raise ValueError(f"nn1_tiled_simple has threads in {NN1_THREADS} and tile in {NN1_TILES}, got {threads}, "
                         f"{tile}")
    return _nn1_launch("nn1_tiled_simple", "spt_nn1_tiled_simple", target_xyz, target_mask, queries, (threads, tile))


def pack_target(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The target as :func:`nn1_tiled` reads it, made once for any number of
    searches: ``[M, 4]`` float32, x, y, z and a 0 pad a row, masked rows at
    +inf, so that a bulk copy moves a chunk of rows as it lies."""
    _check_target(points, mask)
    xyz = torch.where(mask.bool()[:, None], points, torch.inf)
    return torch.nn.functional.pad(xyz, (0, 1)).contiguous()


def pack_bias_target(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The target as :func:`nn1_bias_prepped`, :func:`nn1_lanes_prepped` and
    :func:`nn1_unroll2_prepped` read it (the variant study's v1 / v2 / v3),
    made once: ``[M', 4]`` float32 rows x, y, z, b, with b = 0 for a valid
    row and :data:`BIAS_BIG` for a masked one, whose coordinates stay as
    they are. ``M'`` is ``M`` rounded up to even: after an odd ``M`` one
    masked row (0, 0, 0, BIAS_BIG), so that v3's pairs of adjacent rows
    never reach past the target."""
    _check_target(points, mask)
    M = points.shape[0]
    packed = points.new_zeros((M + M % 2, 4))
    packed[:, 3] = BIAS_BIG
    packed[:M, :3] = points
    packed[:M, 3] = torch.where(mask.bool(), 0.0, BIAS_BIG)
    return packed


def nn1_tiled_span(Q: int, M: int, query_tile: int, n_sm: int, lanes: int = 1) -> int:
    """Target rows a split of :func:`nn1_tiled` at ``query_tile`` queries a
    block (of a ring form of ``lanes`` lanes a query, as
    :func:`nn1_lanes_prepped`: ``query_tile`` (query, lane) slots, so
    ``query_tile / lanes`` queries a block): the target is cut into as many spans as give the card
    :data:`NN1_TILED_WARPS_PER_SM` warps an SM over the ``ceil(Q /
    (query_tile / lanes))`` query blocks launched, none under
    :data:`NN1_TILED_MIN_SPAN` rows. On the H100 (132 SMs) 1,000 queries
    against 24,576 rows take 96 spans of 256 at every query tile; 22,528
    against 22,528 take 12 spans of 1,878 at 64 queries a block; with 32
    lanes, 1,000 queries against 24,576 rows take 9 spans of 2,731 at 512
    slots (63 blocks of 16 queries)."""
    warps = max(1, query_tile // (32 * NN1_TILED_QUERIES_A_THREAD))
    tiles = -(-Q // (query_tile // lanes))
    blocks = -(-NN1_TILED_WARPS_PER_SM * n_sm // warps)
    splits = max(1, min(-(-blocks // max(tiles, 1)), -(-M // NN1_TILED_MIN_SPAN)))
    return max(1, -(-M // splits))


def nn1_even_span(Q: int, M: int, query_tile: int, n_sm: int) -> int:
    """Target rows a split of :func:`nn1_bias_prepped` and
    :func:`nn1_unroll2_prepped`: :func:`nn1_tiled_span` rounded up to even,
    so that every split of an even target holds whole pairs of rows."""
    span = nn1_tiled_span(Q, M, query_tile, n_sm)
    return span + span % 2


_NO_KEY = torch.iinfo(torch.int64).max


def _split_merge(packed: torch.Tensor, queries: torch.Tensor, span: int, search, none: float):
    """The plain model of the ring's split merge: ``search(rows, queries)``
    gives each span's ``(idx, d2)``, the first least distance in index
    order; a span whose best is below ``none`` packs it as ``(d2 bits << 32)
    | index`` and the least word over the spans wins; a query with no word
    is idx 0, d2 = +inf."""
    Q, M = queries.shape[0], packed.shape[0]
    word = torch.full((Q,), _NO_KEY, dtype=torch.int64, device=queries.device)
    for s in range(0, M, span):
        i, d = search(packed[s : s + span], queries)
        bits = d.view(torch.int32).to(torch.int64)
        word = torch.minimum(word, torch.where(d < none, (bits << 32) | (i.to(torch.int64) + s), _NO_KEY))
    none_found = word == _NO_KEY
    idx = torch.where(none_found, 0, word & 0xFFFFFFFF).to(torch.int32)
    d2 = torch.where(none_found, torch.inf, (word >> 32).to(torch.int32).view(torch.float32))
    return idx, d2


def nn1_tiled_plain(packed: torch.Tensor, queries: torch.Tensor, span: int):
    """The plain model of :func:`nn1_tiled`'s split merge on a packed target
    (:func:`pack_target`): each span of ``span`` rows finds its first least
    distance (the kernel's strict ``<`` in index order), packs it as
    ``(d2 bits << 32) | index``, and the least word over the spans wins; a
    span with no finite distance leaves no word, and a query with none is idx
    0, d2 = +inf. Equal to :func:`nn1_plain` on the unpacked target."""
    return _split_merge(packed, queries, span, lambda rows, q: _nn1_plain(rows[:, :3], None, q, None), torch.inf)


def _biased_blocks(rows: torch.Tensor, queries: torch.Tensor):
    """``(query offset, [q, n] biased distances ((e0*e0 + e1*e1) + e2*e2) +
    b)`` of bias-packed ``rows`` for bounded blocks of the queries, with NaN
    (a masked row's NaN coordinate) at +inf: the kernels' strict ``<`` never
    takes either."""
    step = _query_chunk(rows.shape[0])
    for s in range(0, queries.shape[0], step):
        d = _sqdist_block(queries[s : s + step], rows[:, :3], None) + rows[:, 3]
        yield s, torch.nan_to_num(d, nan=torch.inf, posinf=torch.inf)


def _bias_search(rows: torch.Tensor, queries: torch.Tensor):
    idx = torch.zeros(queries.shape[0], dtype=torch.int32, device=queries.device)
    d2 = torch.full((queries.shape[0],), torch.inf, dtype=torch.float32, device=queries.device)
    for s, block in _biased_blocks(rows, queries):
        d, i = torch.min(block, dim=1)
        idx[s : s + d.shape[0]], d2[s : s + d.shape[0]] = i.to(torch.int32), d
    return idx, d2


def _unroll2_search(rows: torch.Tensor, queries: torch.Tensor):
    idx = torch.zeros(queries.shape[0], dtype=torch.int32, device=queries.device)
    d2 = torch.full((queries.shape[0],), torch.inf, dtype=torch.float32, device=queries.device)
    for s, block in _biased_blocks(rows, queries):
        d0, d1 = block[:, 0::2], block[:, 1::2]  # rows j and j + 1 of each step
        cd = torch.fmin(d0, d1)
        pair = torch.arange(0, rows.shape[0], 2, dtype=torch.int64, device=rows.device)
        ci = torch.where(cd == d0, pair, pair + 1)  # j on a tie
        d, p = torch.min(cd, dim=1)  # the first least pair: the strict `<` in order
        idx[s : s + d.shape[0]] = ci.gather(1, p[:, None])[:, 0].to(torch.int32)
        d2[s : s + d.shape[0]] = d
    return idx, d2


def _lanes_search(rows: torch.Tensor, queries: torch.Tensor, lanes: int):
    """v2's search of one span: lane ``l`` keeps the first least biased
    distance below :data:`BIAS_BIG` of rows ``l, l + lanes, ...`` (else
    BIAS_BIG at index 0, the kernel's start), then the lanes reduce to the
    least distance and, on equal distance, the least index."""
    n = rows.shape[0]
    steps = -(-n // lanes)
    idx = torch.zeros(queries.shape[0], dtype=torch.int32, device=queries.device)
    d2 = torch.full((queries.shape[0],), torch.inf, dtype=torch.float32, device=queries.device)
    lane_rows = torch.arange(lanes, dtype=torch.int64, device=rows.device)
    for s, block in _biased_blocks(rows, queries):
        block = torch.nn.functional.pad(block, (0, steps * lanes - n), value=torch.inf)
        d, k = torch.min(block.view(-1, steps, lanes), dim=1)  # each lane's first least row
        found = d < BIAS_BIG
        d = torch.where(found, d, BIAS_BIG)
        i = torch.where(found, k * lanes + lane_rows, 0)
        least = d.min(dim=1, keepdim=True).values
        i = torch.where(d == least, i, _NO_KEY).min(dim=1).values
        idx[s : s + d.shape[0]], d2[s : s + d.shape[0]] = i.to(torch.int32), least[:, 0]
    return idx, d2


def _check_pairs(rows: int, span: int, name: str) -> None:
    if rows % 2 or span % 2:
        raise ValueError(f"{name} takes pairs of rows: an even packed target (pack_bias_target) and an even span, "
                         f"got {rows} rows, span {span}")


def nn1_bias_plain(packed: torch.Tensor, queries: torch.Tensor, span: int):
    """The plain model of :func:`nn1_bias_prepped` on a bias-packed target
    (:func:`pack_bias_target`): each span of ``span`` rows finds its first
    least biased distance ``sqdist + b`` (the kernel's strict ``<`` from
    :data:`BIAS_BIG`), and the spans merge as in :func:`nn1_tiled_plain`; a
    span with no row below BIAS_BIG leaves no word. Equal to
    :func:`nn1_plain` while valid distances stay below BIAS_BIG."""
    return _split_merge(packed, queries, span, _bias_search, BIAS_BIG)


def nn1_unroll2_plain(packed: torch.Tensor, queries: torch.Tensor, span: int):
    """The plain model of :func:`nn1_unroll2_prepped`: as
    :func:`nn1_bias_plain`, but each span folds rows ``j`` and ``j + 1``
    (adjacent; ``span`` even) into ``fmin(d0, d1)``, index ``j`` where it
    equals ``d0``, before the first least fold wins."""
    _check_pairs(packed.shape[0], span, "nn1_unroll2_plain")
    return _split_merge(packed, queries, span, _unroll2_search, BIAS_BIG)


def _check_lanes(lanes: int, name: str) -> None:
    if lanes not in NN1_LANES:
        raise ValueError(f"{name} has lanes in {NN1_LANES}, got {lanes}")


def nn1_lanes_plain(packed: torch.Tensor, queries: torch.Tensor, span: int, lanes: int):
    """The plain model of :func:`nn1_lanes_prepped` (v2) on a bias-packed
    target (:func:`pack_bias_target`): in each span of ``span`` rows, lane
    ``l`` of ``lanes`` keeps its first least biased distance below
    :data:`BIAS_BIG` over the span's rows ``l, l + lanes, ...`` (the kernel's
    strict ``<`` in index order), the lanes reduce to the least distance and,
    on equal distance, the least index (the kernel's shuffle reduce), and the
    spans merge as in :func:`nn1_tiled_plain`. Equal to :func:`nn1_plain`
    while valid distances stay below BIAS_BIG."""
    _check_lanes(lanes, "nn1_lanes_plain")
    return _split_merge(packed, queries, span, lambda rows, q: _lanes_search(rows, q, lanes), BIAS_BIG)


def _nn1_ring(name: str, entry: str, packed: torch.Tensor, queries, query_tile: int, chunk: int, plain, span_of,
              pairs: bool = False, extra: tuple = ()):
    """The ring's wrappers' shared body: refuse an instance not built or a
    packed target of the wrong shape (an odd row count where the form reads
    ``pairs`` of rows), type or alignment before any launch; CPU tensors run
    ``plain(packed, queries, span)`` at the split an H100 takes, CUDA tensors
    launch ``lib.<entry>(packed, M, queries, Q, *extra, query_tile, chunk,
    span, ...)`` once (a memset, the kernel and the unpack) at the card's
    split, ``span_of(Q, M, query_tile, n_sm)``, counted under ``name``."""
    if query_tile not in NN1_QUERY_TILES_STUDY or chunk not in NN1_TILES:
        raise ValueError(f"{name} has query_tile in {NN1_QUERY_TILES_STUDY} and chunk in {NN1_TILES}, got "
                         f"{query_tile}, {chunk}")
    M = packed.shape[0]
    if packed.shape != (M, 4) or packed.dtype != torch.float32:
        raise ValueError(f"expected a packed [M, 4] float32 target, got {tuple(packed.shape)} {packed.dtype}")
    if pairs:
        _check_pairs(M, 0, name)
    if packed.data_ptr() % 16:
        raise ValueError(f"{name} reads the packed target in 16-byte bulk copies: it must be 16-byte aligned")
    device = _check_queries(queries, None, packed)
    Q = queries.shape[0]
    if device.type == "cpu":
        return plain(packed, queries, span_of(Q, M, query_tile, H100_SMS))
    _require_cuda(device, name)
    _require_contiguous(packed, queries)
    span = span_of(Q, M, query_tile, _sm_count(device.index))
    best = torch.empty(Q, dtype=torch.int64, device=device)
    return _launch(name, device, (Q,), lambda lib, i, d, s: getattr(lib, entry)(
        packed.data_ptr(), M, queries.data_ptr(), Q, *extra, query_tile, chunk, span, best.data_ptr(), i, d, s))


def nn1_tiled_prepped(packed: torch.Tensor, queries, query_tile: int, chunk: int):
    """:func:`nn1` without a pose against a target made by
    :func:`pack_target`, through the tile study's kernel for this card
    (``csrc/nn1_tiles.cu``) at ``query_tile`` queries a block (one of
    :data:`NN1_QUERY_TILES_STUDY`) and ``chunk`` target points a stage (one
    of :data:`NN1_TILES`); the target split by :func:`nn1_tiled_span`.
    ``(idx [Q] int32, d2 [Q] f32)``, equal to :func:`nn1_plain`. CPU
    tensors run :func:`nn1_tiled_plain` at the split an H100 takes."""
    return _nn1_ring("nn1_tiled", "spt_nn1_tiled", packed, queries, query_tile, chunk, nn1_tiled_plain,
                     nn1_tiled_span)


def nn1_tiled(target_xyz, target_mask, queries, query_tile: int, chunk: int):
    """:func:`nn1_tiled_prepped` with the target packed for this one call."""
    _check_inputs(target_xyz, target_mask, queries)
    return nn1_tiled_prepped(pack_target(target_xyz, target_mask), queries, query_tile, chunk)


def nn1_bias_prepped(packed: torch.Tensor, queries, query_tile: int = NN1_BIAS_INSTANCE[0],
                     chunk: int = NN1_BIAS_INSTANCE[1]):
    """:func:`nn1` without a pose, masking by an added 0 / 3e38 bias (the TPU
    study's v1), against a target made once by :func:`pack_bias_target`:
    ``nn1_tiled``'s ring (``csrc/nn1_ring.cuh``) with the biased compare
    (``csrc/nn1_variants.cu``) at :data:`NN1_BIAS_INSTANCE` unless another
    query tile and chunk are given, the target split by
    :func:`nn1_even_span`. ``(idx [Q] int32, d2 [Q] f32)``, equal to
    :func:`nn1_plain`: idx 0, d2 = +inf where no row is valid. CPU tensors
    run :func:`nn1_bias_plain` at the split an H100 takes."""
    return _nn1_ring("nn1_bias", "spt_nn1_bias", packed, queries, query_tile, chunk, nn1_bias_plain,
                     nn1_even_span, pairs=True)


def nn1_unroll2_prepped(packed: torch.Tensor, queries, query_tile: int = NN1_UNROLL2_INSTANCE[0],
                        chunk: int = NN1_UNROLL2_INSTANCE[1]):
    """:func:`nn1_bias_prepped` with two adjacent rows a step, folded per
    query before the running best (the TPU study's v3), at
    :data:`NN1_UNROLL2_INSTANCE` unless given; CPU tensors run
    :func:`nn1_unroll2_plain`."""
    return _nn1_ring("nn1_unroll2", "spt_nn1_unroll2", packed, queries, query_tile, chunk, nn1_unroll2_plain,
                     nn1_even_span, pairs=True)


def nn1_bias(target_xyz, target_mask, queries):
    """:func:`nn1_bias_prepped` with the target packed for this one call."""
    _check_inputs(target_xyz, target_mask, queries)
    return nn1_bias_prepped(pack_bias_target(target_xyz, target_mask), queries)


def nn1_unroll2(target_xyz, target_mask, queries):
    """:func:`nn1_unroll2_prepped` with the target packed for this one call."""
    _check_inputs(target_xyz, target_mask, queries)
    return nn1_unroll2_prepped(pack_bias_target(target_xyz, target_mask), queries)


def nn1_bias_simple(target_xyz, target_mask, queries):
    """:func:`nn1_bias` through its first design (one thread a query, the
    raw target and mask staged into shared memory, the bias added there),
    kept for timing; counted under ``nn1_bias_simple``."""
    return _nn1_launch("nn1_bias_simple", "spt_nn1_bias_simple", target_xyz, target_mask, queries)


def nn1_lanes_prepped(packed: torch.Tensor, queries, lanes: int, query_tile: Optional[int] = None,
                      chunk: Optional[int] = None):
    """:func:`nn1` without a pose with ``lanes`` (one of :data:`NN1_LANES`)
    threads a query, each keeping its own running best over rows ``l, l +
    lanes, ...`` of each chunk, reduced once a split (the TPU study's v2),
    against a target made once by :func:`pack_bias_target`: the lane form of
    ``nn1_tiled``'s ring (``csrc/nn1_ring.cuh``, ``csrc/nn1_variants.cu``) at
    :data:`NN1_LANES_INSTANCE` unless another ``query_tile`` (one of
    :data:`NN1_QUERY_TILES_STUDY`) and ``chunk`` are given. The query tile
    counts (query, lane) slots: ``query_tile / 2`` threads and ``query_tile
    / lanes`` queries a block. The target is split by :func:`nn1_tiled_span`
    with ``lanes``. ``(idx [Q] int32, d2 [Q] f32)``, equal to
    :func:`nn1_plain`: idx 0, d2 = +inf where no row is valid. CPU tensors
    run :func:`nn1_lanes_plain` at the split an H100 takes."""
    _check_lanes(lanes, "nn1_lanes_prepped")
    tile, tc = NN1_LANES_INSTANCE[lanes]
    return _nn1_ring("nn1_lanes", "spt_nn1_lanes", packed, queries, tile if query_tile is None else query_tile,
                     tc if chunk is None else chunk, partial(nn1_lanes_plain, lanes=lanes),
                     partial(nn1_tiled_span, lanes=lanes), extra=(lanes,))


def nn1_lanes(target_xyz, target_mask, queries, lanes: int):
    """:func:`nn1_lanes_prepped` with the target packed for this one call."""
    _check_lanes(lanes, "nn1_lanes")
    _check_inputs(target_xyz, target_mask, queries)
    return nn1_lanes_prepped(pack_bias_target(target_xyz, target_mask), queries, lanes)


def nn1_lanes_simple(target_xyz, target_mask, queries, lanes: int):
    """:func:`nn1_lanes` through its first design (``lanes`` threads a query
    over the raw target and mask staged into shared memory, 256 threads a
    block, no split), kept for timing; counted under ``nn1_lanes_simple``."""
    _check_lanes(lanes, "nn1_lanes_simple")
    return _nn1_launch("nn1_lanes_simple", "spt_nn1_lanes_simple", target_xyz, target_mask, queries, (lanes,))


def nn1_unroll2_simple(target_xyz, target_mask, queries):
    """:func:`nn1_unroll2` through its first design (one thread a query, two
    targets a step), kept for timing; counted under ``nn1_unroll2_simple``."""
    return _nn1_launch("nn1_unroll2_simple", "spt_nn1_unroll2_simple", target_xyz, target_mask, queries)
