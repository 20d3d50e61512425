"""Hand-written CUDA nearest-neighbour kernels: build, wrappers, plain versions.

Counterpart of :mod:`sycl_points_tpu.ops.pallas_knn`. Two kernels live in
``csrc/knn.cu``:

  * ``nn1``   exact 1-NN with the 4x4 pose folded into the queries; replaces
              the Pallas kernel ``nn1_pallas_prepped`` (the ICP
              correspondence search);
  * ``knn_k`` exact k-NN, k <= 16; replaces ``_approx_knn_single``, which
              rests on the TPU-only ``lax.approx_max_k``.

On first use the source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``_build/``, keyed by a hash of
the source and flags, and loaded with ``ctypes``. There is no fallback: a
missing or failing ``nvcc`` raises with its output.

Each wrapper runs its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors (or raises). ``launch_counts`` counts
kernel launches only; the plain versions never touch it.
"""

from __future__ import annotations

import ctypes
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
SOURCE = os.path.join(_PKG_DIR, "csrc", "knn.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
MAX_K = 16

# Kernel launches per wrapper; reset with reset_launch_counts().
launch_counts = {"nn1": 0, "knn_k": 0}

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
    """Compile ``csrc/knn.cu`` unless a library for this source and these flags
    exists; returns its path."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libspt_knn_{key}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {SOURCE}:\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.spt_nn1.argtypes = [p, p, i, p, i, p, p, p, p]
            lib.spt_nn1.restype = i
            lib.spt_knn_k.argtypes = [p, p, i, p, i, i, p, p, p]
            lib.spt_knn_k.restype = i
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


def nn1(target_xyz, target_mask, queries, pose=None):
    """Exact 1-NN of ``queries [Q,3]`` (moved by ``pose [4,4]`` if given)
    against the masked ``target_xyz [M,3]``: ``(idx [Q] int32, d2 [Q] f32)``.

    CPU tensors run :func:`nn1_plain`; CUDA tensors launch the kernel."""
    device = _check_inputs(target_xyz, target_mask, queries, pose)
    if device.type == "cpu":
        return nn1_plain(target_xyz, target_mask, queries, pose)
    if device.type != "cuda":
        raise ValueError(f"nn1 runs on cpu or cuda tensors, got {device}")
    _require_contiguous(target_xyz, target_mask, queries, pose)
    Q, M = queries.shape[0], target_xyz.shape[0]
    idx = torch.empty(Q, dtype=torch.int32, device=device)
    d2 = torch.empty(Q, dtype=torch.float32, device=device)
    if Q == 0:
        return idx, d2
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.spt_nn1(
            target_xyz.data_ptr(), target_mask.data_ptr(), M,
            queries.data_ptr(), Q, None if pose is None else pose.data_ptr(),
            idx.data_ptr(), d2.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _check_rc(rc, "nn1")
    launch_counts["nn1"] += 1
    return idx, d2


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
