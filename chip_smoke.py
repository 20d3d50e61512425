"""Smoke run of the PyTorch + CUDA port (sycl_points_tpu_torch) on one card.

    python3 chip_smoke.py

1. Builds the CUDA kNN kernels from ``sycl_points_tpu_torch/csrc``.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (nn1: 1000 queries against the target's voxels under a
   non-identity pose, and all targets masked; knn_k: k=10 self-search over
   the voxels with some masked); runs the slice on a small pair on the card
   and through the plain versions on the CPU and compares the poses.
3. Holds every instance of the study kernels (nn1_tiled, nn1_bias,
   nn1_lanes, nn1_unroll2) against nn1_plain at the nn1 shape, on queries
   moved by the ground-truth pose, with some targets masked, with every
   target masked, and on an odd count of targets: equal indices and equal
   distances, bit for bit.
4. Times every kernel, its plain version and a PyTorch yardstick that the
   port never calls (``torch.cdist`` over +inf-masked targets, then ``min``
   or ``topk``), as marginal per-launch CUDA-event times, and computes each
   kernel's bound (``scripts.measure``): the larger of its bytes over
   3.35 TB/s and its FP32 operations (9 a query/target pair) over 33.5e12 a
   second.
5. Drives the main path, ``apps.example_registration.register_pair``, on a
   synthetic HDL-64 pair (2048 x 64 rays raycast on the card, two poses of a
   figure-8 about 1 m apart) and checks the pose against the ground truth,
   that every output lies on the card, and that nn1 and knn_k launched.
6. Drives the two study entry points (``scripts.bench_nn1_tiles`` and
   ``scripts.bench_nn1_variants``) at one small shape, each with the launch
   counts set to 0 just before and read just after, and fails if a study
   kernel never launched or an instance differs from nn1_plain there.

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
from sycl_points_tpu_torch.ops.transform import transform_points
from sycl_points_tpu_torch.registration.pipeline import align_pipeline
from sycl_points_tpu_torch.scripts import bench_nn1_tiles, bench_nn1_variants
from sycl_points_tpu_torch.scripts.measure import FP32_OPS_PER_S, bound, marginal_ms, nn1_bound
from sycl_points_tpu_torch.utils.synthetic import World, figure8_trajectory, scan_at

VOXEL = 0.25
K = 10
N_QUERIES = 1000
SEED = 1234
TIE_TOL = 1e-6  # index disagreements allowed only between distances this close
D2_ATOL = 1e-5  # squared-distance agreement, kernel vs plain
MAX_TRANS_ERR_M = 0.05
MAX_ROT_ERR_DEG = 0.5
KNN_SOURCE = "sycl_points_tpu_torch/csrc/knn.cu"
VARIANTS_SOURCE = "sycl_points_tpu_torch/csrc/nn1_variants.cu"
STUDY_SHAPE = ((1024, 6144),)  # the TPU variant study's small shape
MASK_EVERY = 37


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def compare_times(kernel_fn, plain_fn, library_fn, rounds: int = 2):
    """Marginal per-launch CUDA-event times (ms) of kernel, plain and library:
    medians of kernel and plain taken in turns plain, kernel, kernel, plain,
    and one time of the library."""
    dev = torch.device("cuda", torch.cuda.current_device())
    times = {"kernel": [], "plain": []}
    for _ in range(rounds):
        for name, fn in (("plain", plain_fn), ("kernel", kernel_fn), ("kernel", kernel_fn), ("plain", plain_fn)):
            times[name].append(marginal_ms(fn, dev))
    return statistics.median(times["kernel"]), statistics.median(times["plain"]), marginal_ms(library_fn, dev)


def inf_masked(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Targets with masked rows moved to +inf, the yardstick's input."""
    return torch.where(mask.bool()[:, None], points, torch.inf).contiguous()


def cdist_min(q: torch.Tensor, t_inf: torch.Tensor):
    """The yardstick of nn1: PyTorch's exact pairwise distances, then min."""
    return torch.cdist(q, t_inf, compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)


def row(name, source, replaces, path, err, times, bound_ms_by, **extra) -> dict:
    ms, plain_ms, library_ms = times
    b_ms, b_by = bound_ms_by
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "path": path,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, **extra}


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

    moved, t_inf = transform_points(queries, pose).contiguous(), inf_masked(target.points, mask)
    times = compare_times(
        lambda: cuda_knn.nn1(target.points, mask, queries, pose),
        lambda: cuda_knn.nn1_plain(target.points, mask, queries, pose),
        lambda: cdist_min(moved, t_inf),
    )
    b = nn1_bound(queries.shape[0], target.capacity, int(mask.sum()))
    print(f"nn1 time: kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms, cdist+min {times[2]:.4f} ms, "
          f"bound {b[0]:.4f} ms ({b[1]}) (marginal CUDA-event ms per launch, medians)")
    return row("nn1", KNN_SOURCE, "sycl_points_tpu/ops/pallas_knn.py:111", "register_pair", err, times, b)


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
    t_inf = inf_masked(pts, mask)
    times = compare_times(
        lambda: cuda_knn.knn_k(pts, mask, pts, K),
        lambda: cuda_knn.knn_k_plain(pts, mask, pts, K),
        lambda: torch.cdist(pts, t_inf, compute_mode="donot_use_mm_for_euclid_dist").topk(K, largest=False),
    )
    Q = M = cloud.capacity
    # the distance and the compare against the k-th best of every pair; the
    # data-dependent insertions are not counted
    b = bound(Q * int(mask.sum()), 13 * M + 12 * Q + 8 * Q * K)
    print(f"knn_k time: kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms, cdist+topk {times[2]:.4f} ms, "
          f"bound {b[0]:.4f} ms ({b[1]}) (marginal CUDA-event ms per launch, medians)")
    return row("knn_k", KNN_SOURCE, "sycl_points_tpu/ops/knn.py:223", "register_pair", err, times, b)


STUDIES = (bench_nn1_tiles, bench_nn1_variants)
# Each study kernel's launch-count key -> (its source, the TPU kernel it
# replaces). The studies' v0 is the production nn1, checked above.
STUDY_KERNELS = {
    "nn1_tiled": (KNN_SOURCE, "scripts/bench_pallas_tiles.py:27"),
    "nn1_bias": (VARIANTS_SOURCE, "scripts/bench_nn1_variants.py:106"),
    "nn1_lanes": (VARIANTS_SOURCE, "scripts/bench_nn1_variants.py:134"),
    "nn1_unroll2": (VARIANTS_SOURCE, "scripts/bench_nn1_variants.py:168"),
}


def study_name(module) -> str:
    return module.__name__.rsplit(".", 1)[1]


def check_study_kernels(target, queries, pose) -> list:
    """Every study kernel instance against nn1_plain at the nn1 shape, on the
    queries moved by ``pose``: equal indices and bit-equal distances with
    every 37th target (and the padding) masked, with every target masked, and
    on the first odd number of targets (a partial last tile at every tile
    size, and an odd tail for nn1_unroll2); then its time (median of 3
    marginal times). A wrapper's row carries its fastest instance."""
    t = target.points
    moved = transform_points(queries, pose).contiguous()
    keep = torch.arange(target.capacity, device=t.device) % MASK_EVERY != 0
    mask = (target.mask & keep).to(torch.uint8)
    n_odd = (target.capacity - 1) | 1
    cases = {"some masked": (t, mask), "all masked": (t, torch.zeros_like(mask)),
             f"first {n_odd} targets": (t[:n_odd], mask[:n_odd])}
    refs = {what: cuda_knn.nn1_plain(tt, m, moved) for what, (tt, m) in cases.items()}
    i0, d0 = refs["all masked"]
    if not (bool((i0 == 0).all()) and bool(torch.isinf(d0).all())):
        raise AssertionError("nn1_plain with every target masked must give idx 0, d2 = inf")
    t_inf = inf_masked(t, mask)
    b = nn1_bound(moved.shape[0], target.capacity, int(mask.sum()))
    # plain and library are the same calls for every instance: timed once, in
    # turns with the production nn1
    _, plain_ms, lib_ms = compare_times(
        lambda: cuda_knn.nn1(t, mask, moved), lambda: cuda_knn.nn1_plain(t, mask, moved),
        lambda: cdist_min(moved, t_inf),
    )
    print(f"study kernels at Q={moved.shape[0]} M={target.capacity} (valid {int(mask.sum())}): "
          f"plain {plain_ms:.4f} ms, cdist+min {lib_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
    dev = t.device
    per, study = {name: {} for name in STUDY_KERNELS}, {}
    for module in STUDIES:
        for label, (name, fn) in module.INSTANCES.items():
            if name not in STUDY_KERNELS:
                continue
            for what, (tt, m) in cases.items():
                idx, d2 = fn(tt, m, moved)
                torch.cuda.synchronize()
                ri, rd = refs[what]
                bad = int((idx != ri).sum())
                if bad or not torch.equal(d2, rd):
                    raise AssertionError(f"{name} {label} ({what}): {bad} index mismatches, "
                                         f"distances equal: {torch.equal(d2, rd)}")
            ms = statistics.median(marginal_ms(lambda: fn(t, mask, moved), dev) for _ in range(3))
            per[name][label], study[name] = ms, study_name(module)
            print(f"{name} {label}: equal to nn1_plain ({', '.join(cases)}); kernel {ms:.4f} ms")
    rows = []
    for name, (source, replaces) in STUDY_KERNELS.items():
        best = min(per[name], key=per[name].get)
        rows.append(row(name, source, replaces, study[name], 0.0, (per[name][best], plain_ms, lib_ms), b,
                        instance=best, instance_ms=per[name]))
    return rows


def run_studies(results: list) -> None:
    """Each study entry point at STUDY_SHAPE with the counts set to 0 just
    before it and read just after; every row must equal nn1_plain exactly,
    and every kernel of the study must have launched."""
    for module in STUDIES:
        path = study_name(module)
        names = {name for name, _ in module.INSTANCES.values() if name in STUDY_KERNELS}
        cuda_knn.reset_launch_counts()
        rows = module.main(shapes=STUDY_SHAPE)
        torch.cuda.synchronize()
        counts = dict(cuda_knn.launch_counts)
        print(f"{path} launches: {counts}")
        if any(r["agree"] != 1.0 or r["dmax"] != 0.0 for r in rows):
            raise AssertionError(f"{path}: an instance disagrees with nn1_plain")
        if min(counts[n] for n in names) <= 0:
            raise AssertionError(f"a kernel of {path} never launched: {counts}")
        for r in results:
            if r["name"] in names:
                r["launches"] = counts[r["name"]]


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
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi("name,power.limit")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"clocks.max.sm {sm_mhz:.0f} MHz x {n_sm} SMs x 128 FP32 lanes = "
          f"{n_sm * 128 * sm_mhz * 1e6:.4g} lane-ops/s (bounds use {FP32_OPS_PER_S:.4g})")

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
    results += check_study_kernels(tgt_vox, queries, pose)

    # --- the main path -------------------------------------------------------
    register_pair(src_raw, tgt_raw, VOXEL, K, cap, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    res = register_pair(src_raw, tgt_raw, VOXEL, K, cap, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    print(f"main-path kernel launches: {launches}")
    for r in results:
        if r["path"] == "register_pair":
            r["launches"] = launches[r["name"]]
    if min(launches["nn1"], launches["knn_k"]) <= 0:
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

    # --- the study entry points ------------------------------------------------
    run_studies(results)

    print(f"smoke run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
