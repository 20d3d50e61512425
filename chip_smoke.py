"""Smoke run of the PyTorch + CUDA port (sycl_points_tpu_torch) on one card.

    python3 chip_smoke.py

1. Builds the CUDA kNN kernels from ``sycl_points_tpu_torch/csrc``.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (nn1: 1000 queries against the target's voxels under a
   non-identity pose, and all targets masked; knn_k: k=10 self-search over
   the voxels with some masked) and times both with CUDA events; runs the
   slice on a small pair on the card and through the plain versions on the
   CPU and compares the poses.
3. Drives the main path, ``apps.example_registration.register_pair``, on a
   synthetic HDL-64 pair (2048 x 64 rays raycast on the card, two poses of a
   figure-8 about 1 m apart) and checks the pose against the ground truth,
   that every output lies on the card, and that both kernels launched.

Prints per-phase results, then a JSON line of kernel results, the card's name
and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises (exit code != 0). Without a CUDA card it exits with
an error before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from benchmarks.synthetic_velodyne import World, figure8_trajectory
from sycl_points_tpu_torch.apps.example_registration import (
    PAIR_PARAMS,
    downsample,
    pose_error,
    preprocess,
    register_pair,
    voxel_capacity,
)
from sycl_points_tpu_torch.convert import cloud_from_numpy
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu_torch.ops.knn import BruteForceKNN, self_knn
from sycl_points_tpu_torch.ops.sampling import random_sampling
from sycl_points_tpu_torch.registration.pipeline import align_pipeline
from sycl_points_tpu_torch.utils.synthetic import scan_at

VOXEL = 0.25
K = 10
N_QUERIES = 1000
SEED = 1234
TIE_TOL = 1e-6  # index disagreements allowed only between distances this close
D2_ATOL = 1e-5  # squared-distance agreement, kernel vs plain
MAX_TRANS_ERR_M = 0.05
MAX_ROT_ERR_DEG = 0.5
KERNEL_SOURCE = "sycl_points_tpu_torch/csrc/knn.cu"


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def event_times_ms(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def compare_times(kernel_fn, plain_fn, reps: int = 10, warmup: int = 3):
    """Median CUDA-event times (ms) of kernel and plain, taken in turns
    plain, kernel, kernel, plain after a warm-up."""
    for _ in range(warmup):
        kernel_fn()
        plain_fn()
    torch.cuda.synchronize()
    plain = event_times_ms(plain_fn, reps)
    kern = event_times_ms(kernel_fn, reps) + event_times_ms(kernel_fn, reps)
    plain += event_times_ms(plain_fn, reps)
    return statistics.median(kern), statistics.median(plain)


def finite_max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool((torch.isfinite(a) == torch.isfinite(b)).all()):
        raise AssertionError("kernel and plain disagree on which distances are finite")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def check_nn1(target, queries, pose) -> dict:
    mask = target.mask.to(torch.uint8)
    idx, d2 = cuda_knn.nn1(target.points, mask, queries, pose)
    ref_idx, ref_d2 = cuda_knn.nn1_plain(target.points, mask, queries, pose)
    torch.cuda.synchronize()
    bad = cuda_knn.nn1_mismatches(idx, d2, ref_idx, ref_d2, TIE_TOL)
    err = finite_max_abs_err(d2, ref_d2)
    print(f"nn1: Q={queries.shape[0]} M={target.capacity} (valid {int(target.count())}): "
          f"{bad} index mismatches beyond ties, max |d2 - plain| = {err:.3g}")
    if bad or err > D2_ATOL:
        raise AssertionError("nn1 kernel disagrees with its plain version")

    none = torch.zeros_like(mask)
    idx0, d20 = cuda_knn.nn1(target.points, none, queries, pose)
    torch.cuda.synchronize()
    if not (bool(torch.isinf(d20).all()) and bool((idx0 == 0).all())):
        raise AssertionError("nn1 with every target masked must give idx 0, d2 = inf")
    print("nn1 all-masked: idx 0, d2 = inf everywhere")

    ms, plain_ms = compare_times(
        lambda: cuda_knn.nn1(target.points, mask, queries, pose),
        lambda: cuda_knn.nn1_plain(target.points, mask, queries, pose),
    )
    print(f"nn1 time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of CUDA-event timings)")
    return {"name": "nn1", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": "sycl_points_tpu/ops/pallas_knn.py:111",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_knn(cloud) -> dict:
    keep = torch.arange(cloud.capacity, device=cloud.device) % 10 != 3
    pts, mask = cloud.points, cloud.mask & keep
    idx, d2 = cuda_knn.knn_k(pts, mask, pts, K)
    ref_idx, ref_d2 = cuda_knn.knn_k_plain(pts, mask, pts, K)
    torch.cuda.synchronize()
    bad = cuda_knn.knn_mismatches(idx, d2, ref_idx, ref_d2, TIE_TOL)
    err = finite_max_abs_err(d2, ref_d2)
    print(f"knn_k: k={K} Q=M={cloud.capacity} (valid {int(mask.sum())}): "
          f"{bad} set mismatches beyond ties, max |d2 - plain| = {err:.3g}")
    if bad or err > D2_ATOL:
        raise AssertionError("knn_k kernel disagrees with its plain version")
    ms, plain_ms = compare_times(
        lambda: cuda_knn.knn_k(pts, mask, pts, K),
        lambda: cuda_knn.knn_k_plain(pts, mask, pts, K),
    )
    print(f"knn_k time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of CUDA-event timings)")
    return {"name": "knn_k", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": "sycl_points_tpu/ops/knn.py:223",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def stage_times(src_raw, tgt_raw, cap, runs: int = 5) -> dict:
    """Median wall time (ms) of each stage, synchronizing around each."""
    times = {"preprocess (box+voxel) per scan": [], "self-kNN per scan": [],
             "covariances+normals per scan": [], "align_pipeline": []}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for i in range(runs + 1):
        clouds = []
        for raw in (src_raw, tgt_raw):
            c = timed("preprocess (box+voxel) per scan", lambda: downsample(raw, VOXEL, cap))
            knn = timed("self-kNN per scan", lambda: self_knn(c.points, c.mask, K))

            def feats():
                covs = estimate_covariances(c.points, knn)
                return c.replace(covs=covs, normals=extract_normals(c.points, covs))

            clouds.append(timed("covariances+normals per scan", feats))
        gen = torch.Generator(device=src_raw.device).manual_seed(SEED)
        timed("align_pipeline", lambda: align_pipeline(
            clouds[0], clouds[1], BruteForceKNN.build(clouds[1]), PAIR_PARAMS, generator=gen))
        if i == 0:  # warm-up round
            for v in times.values():
                v.clear()
    return {name: statistics.median(v) for name, v in times.items()}


def check_small_pair_against_cpu(world, pose_src, pose_tgt, device) -> None:
    """The slice on a 512 x 32 pair, on the card and through the plain
    versions on the CPU, with the same sampling scores: poses within 2 mm and
    0.1 deg of each other."""
    pts = [scan_at(world, pose, n_az=512, n_rings=32, device=device) for pose in (pose_src, pose_tgt)]
    cap = voxel_capacity([cloud_from_numpy(p) for p in pts], VOXEL)
    scores = np.random.default_rng(SEED).gumbel(size=cap).astype(np.float32)
    poses = []
    for dev in (torch.device("cpu"), device):
        src, tgt = (preprocess(cloud_from_numpy(p, device=dev), VOXEL, K, cap) for p in pts)
        out = align_pipeline(src, tgt, BruteForceKNN.build(tgt), PAIR_PARAMS,
                             scores=torch.from_numpy(scores).to(dev))
        poses.append(out.result.T.cpu().numpy())
    trans, rot = pose_error(poses[1], poses[0])
    print(f"small pair (512 x 32), card vs CPU plain path: {trans * 1e3:.4f} mm, {rot:.5f} deg apart")
    if not (trans <= 2e-3 and rot <= 0.1):
        raise AssertionError("the card and the CPU reference disagree on the small pair")


def check_on_device(tree, device) -> None:
    for name, value in tree.items():
        if isinstance(value, torch.Tensor) and value.device.type != device.type:
            raise AssertionError(f"{name} lies on {value.device}, not on {device}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda_knn.load_library()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s")

    # --- data: a synthetic HDL-64 pair raycast on the card -----------------
    t0 = time.perf_counter()
    world = World()
    pose_tgt, pose_src = figure8_trajectory(2, speed=0.7)
    T_gt = np.linalg.inv(pose_tgt) @ pose_src
    src_np = scan_at(world, pose_src, device=dev)
    tgt_np = scan_at(world, pose_tgt, device=dev)
    src_raw = cloud_from_numpy(src_np, device=dev)
    tgt_raw = cloud_from_numpy(tgt_np, device=dev)
    cap = voxel_capacity((src_raw, tgt_raw), VOXEL)
    print(f"scan pair: {len(src_np)} / {len(tgt_np)} raw points, voxel capacity {cap}, "
          f"raycast+upload {time.perf_counter() - t0:.2f} s")

    # --- kernel phases at the main path's shapes ---------------------------
    src_vox = downsample(src_raw, VOXEL, cap)
    tgt_vox = downsample(tgt_raw, VOXEL, cap)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    queries = random_sampling(src_vox, N_QUERIES, gen).points.contiguous()
    pose = torch.as_tensor(T_gt, dtype=torch.float32, device=dev).contiguous()
    results = [check_nn1(tgt_vox, queries, pose), check_knn(tgt_vox)]
    check_small_pair_against_cpu(world, pose_src, pose_tgt, dev)

    # --- the main path -------------------------------------------------------
    register_pair(src_raw, tgt_raw, VOXEL, K, cap, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    res = register_pair(src_raw, tgt_raw, VOXEL, K, cap, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    print(f"main-path kernel launches: {launches}")
    for r in results:
        r["launches"] = launches[r["name"]]
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    out = res.output.result
    check_on_device(out._asdict(), dev)
    for cloud in (res.source, res.target, res.output.registration_input):
        check_on_device(vars(cloud), dev)
    T = out.T.cpu().numpy().astype(np.float64)
    if T.shape != (4, 4) or not np.isfinite(T).all():
        raise AssertionError(f"bad pose {T}")
    trans_err, rot_err = pose_error(T, T_gt)
    print(f"voxels: source {int(res.source.count())}, target {int(res.target.count())}; "
          f"iterations {int(out.iterations)}, inliers {int(out.inlier)} of "
          f"{int(res.output.registration_input.count())}, error {float(out.error):.4f}")
    print(f"pose error vs ground truth: translation {trans_err * 100:.3f} cm, rotation {rot_err:.4f} deg "
          f"(ground-truth motion {np.linalg.norm(T_gt[:3, 3]):.3f} m)")
    if not (trans_err <= MAX_TRANS_ERR_M and rot_err <= MAX_ROT_ERR_DEG):
        raise AssertionError("registration error above 5 cm / 0.5 deg")

    # --- timing --------------------------------------------------------------
    pair_ms = []
    for i in range(6):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        register_pair(src_raw, tgt_raw, VOXEL, K, cap, gen)
        torch.cuda.synchronize()
        if i:  # the first run is a warm-up
            pair_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"register_pair: {statistics.median(pair_ms):.3f} ms per pair "
          f"(median of {len(pair_ms)}; runs {[round(t, 3) for t in pair_ms]})")
    for name, ms in stage_times(src_raw, tgt_raw, cap).items():
        print(f"stage {name}: {ms:.3f} ms (median of 5)")

    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
