"""Hand-written CUDA nearest-neighbour kernels: build, wrappers, plain versions.

Counterpart of :mod:`sycl_points_tpu.ops.pallas_knn` and of the two TPU
studies of its kernel. In ``csrc/knn.cu``:

  * ``nn1``   exact 1-NN with the 4x4 pose folded into the queries; replaces
              the Pallas kernel ``nn1_pallas_prepped`` (the ICP
              correspondence search);
  * ``nn1_tiled`` the same kernel at a chosen (threads per block, target
              tile) instance; replaces the tile sweep's ``make_nn1``
              (``scripts/bench_pallas_tiles.py``);
  * ``knn_k`` exact k-NN, k <= 16; replaces ``_approx_knn_single``, which
              rests on the TPU-only ``lax.approx_max_k``.

In ``csrc/nn1_variants.cu``, the formulations of the variant study
(``scripts/bench_nn1_variants.py``) on queries already moved by the pose:
``nn1_bias`` (v1), ``nn1_lanes`` (v2, 8 or 32 lanes a query) and
``nn1_unroll2`` (v3). Every 1-NN kernel equals :func:`nn1_plain`.

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
from typing import Optional

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
MAX_K = 16
# Instances compiled into the library (csrc/knn.cu, csrc/nn1_variants.cu).
NN1_THREADS = (64, 128, 256, 512)
NN1_TILES = (512, 1024, 2048, 4096)
NN1_LANES = (8, 32)

# Kernel launches per wrapper; reset with reset_launch_counts().
launch_counts = {"nn1": 0, "knn_k": 0, "nn1_tiled": 0, "nn1_bias": 0, "nn1_lanes": 0, "nn1_unroll2": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

# Plain versions bound the [rows, M] distance block they materialise.
_PLAIN_BLOCK_ELEMS = 1 << 24


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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
            lib.spt_nn1.argtypes = [p, p, i, p, i, p, p, p, p]
            lib.spt_knn_k.argtypes = [p, p, i, p, i, i, p, p, p]
            lib.spt_nn1_tiled.argtypes = [p, p, i, p, i, i, i, p, p, p]
            lib.spt_nn1_bias.argtypes = [p, p, i, p, i, p, p, p]
            lib.spt_nn1_lanes.argtypes = [p, p, i, p, i, i, p, p, p]
            lib.spt_nn1_unroll2.argtypes = [p, p, i, p, i, p, p, p]
            for fn in (lib.spt_nn1, lib.spt_knn_k, lib.spt_nn1_tiled, lib.spt_nn1_bias,
                       lib.spt_nn1_lanes, lib.spt_nn1_unroll2):
                fn.restype = i
            _lib = lib
    return _lib


def _check_inputs(target_xyz, target_mask, queries, pose=None):
    M, Q = target_xyz.shape[0], queries.shape[0]
    if target_xyz.shape != (M, 3) or queries.shape != (Q, 3):
        raise ValueError(f"expected [M,3] targets and [Q,3] queries, got {tuple(target_xyz.shape)}, {tuple(queries.shape)}")
    if target_mask.shape != (M,):
        raise ValueError(f"expected a [{M}] target mask, got {tuple(target_mask.shape)}")
    if pose is not None and pose.shape != (4, 4):
        raise ValueError(f"expected a [4,4] pose, got {tuple(pose.shape)}")
    tensors = [target_xyz, target_mask, queries] + ([] if pose is None else [pose])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on more than one device: {devices}")
    for t in (target_xyz, queries) + (() if pose is None else (pose,)):
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 coordinates, got {t.dtype}")
    if target_mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"expected a bool or uint8 mask, got {target_mask.dtype}")
    return devices.pop()


def _require_contiguous(*tensors):
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("the kNN kernels take contiguous tensors")


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


# --------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the reference for the kernels)
# --------------------------------------------------------------------------


def _sqdist_block(q: torch.Tensor, t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact ``[Q, M]`` squared distances ``e0*e0 + e1*e1 + e2*e2`` (the
    kernels' operation order); invalid targets are +inf."""
    e = q[:, None, :] - t[None, :, :]
    d2 = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]
    return torch.where(valid[None, :], d2, torch.inf)


def _query_chunk(M: int) -> int:
    return max(1, _PLAIN_BLOCK_ELEMS // max(M, 1))


def nn1_plain(target_xyz, target_mask, queries, pose=None):
    """Exact 1-NN: ``(idx [Q] int32, d2 [Q] f32)``; the earliest index wins
    ties; with no valid target, idx 0 and d2 = +inf."""
    if pose is not None:
        queries = transform_points(queries, pose)
    valid = target_mask.bool()
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


def knn_k_plain(target_xyz, target_mask, queries, k: int):
    """Exact k-NN, ascending: ``(idx [Q,k] int32, d2 [Q,k] f32)``. Slots with
    no valid neighbour get idx 0 and d2 = +inf."""
    valid = target_mask.bool()
    Q, M = queries.shape[0], target_xyz.shape[0]
    idx = torch.zeros((Q, k), dtype=torch.int32, device=queries.device)
    d2 = torch.full((Q, k), torch.inf, dtype=torch.float32, device=queries.device)
    kk = min(k, M)
    if kk == 0:
        return idx, d2
    step = _query_chunk(M)
    for s in range(0, Q, step):
        block = _sqdist_block(queries[s : s + step], target_xyz, valid)
        d, i = torch.topk(block, kk, dim=1, largest=False, sorted=True)
        idx[s : s + step, :kk] = torch.where(torch.isfinite(d), i, 0).to(torch.int32)
        d2[s : s + step, :kk] = d
    return idx, d2


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


def _nn1_launch(name, entry, target_xyz, target_mask, queries, pose=None, extra=()):
    """The 1-NN wrappers' shared body: check the inputs, run :func:`nn1_plain`
    for CPU tensors, else launch ``lib.<entry>(tgt, mask, M, queries, Q,
    *extra, idx, d2, stream)`` once and count it under ``name``."""
    device = _check_inputs(target_xyz, target_mask, queries, pose)
    if device.type == "cpu":
        return nn1_plain(target_xyz, target_mask, queries, pose)
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {device}")
    _require_contiguous(target_xyz, target_mask, queries, pose)
    Q, M = queries.shape[0], target_xyz.shape[0]
    idx = torch.empty(Q, dtype=torch.int32, device=device)
    d2 = torch.empty(Q, dtype=torch.float32, device=device)
    if Q == 0:
        return idx, d2
    lib = load_library()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(
            target_xyz.data_ptr(), target_mask.data_ptr(), M, queries.data_ptr(), Q, *extra,
            idx.data_ptr(), d2.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _check_rc(rc, name)
    launch_counts[name] += 1
    return idx, d2


def nn1(target_xyz, target_mask, queries, pose=None):
    """Exact 1-NN of ``queries [Q,3]`` (moved by ``pose [4,4]`` if given)
    against the masked ``target_xyz [M,3]``: ``(idx [Q] int32, d2 [Q] f32)``.

    CPU tensors run :func:`nn1_plain`; CUDA tensors launch the kernel."""
    pose_ptr = None if pose is None else pose.data_ptr()
    return _nn1_launch("nn1", "spt_nn1", target_xyz, target_mask, queries, pose, (pose_ptr,))


def nn1_tiled(target_xyz, target_mask, queries, threads: int, tile: int):
    """:func:`nn1` without a pose, at the kernel instance with ``threads`` per
    block (one of :data:`NN1_THREADS`) and a shared-memory target tile of
    ``tile`` points (one of :data:`NN1_TILES`). ``(128, 2048)`` is the
    production instance."""
    if threads not in NN1_THREADS or tile not in NN1_TILES:
        raise ValueError(f"nn1_tiled has threads in {NN1_THREADS} and tile in {NN1_TILES}, got {threads}, {tile}")
    return _nn1_launch("nn1_tiled", "spt_nn1_tiled", target_xyz, target_mask, queries, extra=(threads, tile))


def nn1_bias(target_xyz, target_mask, queries):
    """:func:`nn1` without a pose, masking by an added 0 / 3e38 bias (the TPU
    study's v1); masked and none-valid rows as in :func:`nn1`."""
    return _nn1_launch("nn1_bias", "spt_nn1_bias", target_xyz, target_mask, queries)


def nn1_lanes(target_xyz, target_mask, queries, lanes: int):
    """:func:`nn1` without a pose, with ``lanes`` (one of :data:`NN1_LANES`)
    threads a query, each keeping its own best, reduced at the end (the TPU
    study's v2)."""
    if lanes not in NN1_LANES:
        raise ValueError(f"nn1_lanes has lanes in {NN1_LANES}, got {lanes}")
    return _nn1_launch("nn1_lanes", "spt_nn1_lanes", target_xyz, target_mask, queries, extra=(lanes,))


def nn1_unroll2(target_xyz, target_mask, queries):
    """:func:`nn1` without a pose, two targets a step (the TPU study's v3)."""
    return _nn1_launch("nn1_unroll2", "spt_nn1_unroll2", target_xyz, target_mask, queries)


def knn_k(target_xyz, target_mask, queries, k: int):
    """Exact k nearest neighbours (``1 <= k <= 16``) of ``queries [Q,3]`` in
    the masked ``target_xyz [M,3]``, ascending by distance, lower index first
    on ties: ``(idx [Q,k] int32, d2 [Q,k] f32)``.

    CPU tensors run :func:`knn_k_plain`; CUDA tensors launch the kernel."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_k takes 1 <= k <= {MAX_K}, got {k}")
    device = _check_inputs(target_xyz, target_mask, queries)
    if device.type == "cpu":
        return knn_k_plain(target_xyz, target_mask, queries, k)
    if device.type != "cuda":
        raise ValueError(f"knn_k runs on cpu or cuda tensors, got {device}")
    _require_contiguous(target_xyz, target_mask, queries)
    Q, M = queries.shape[0], target_xyz.shape[0]
    idx = torch.empty((Q, k), dtype=torch.int32, device=device)
    d2 = torch.empty((Q, k), dtype=torch.float32, device=device)
    if Q == 0:
        return idx, d2
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.spt_knn_k(
            target_xyz.data_ptr(), target_mask.data_ptr(), M,
            queries.data_ptr(), Q, k,
            idx.data_ptr(), d2.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _check_rc(rc, "knn_k")
    launch_counts["knn_k"] += 1
    return idx, d2
