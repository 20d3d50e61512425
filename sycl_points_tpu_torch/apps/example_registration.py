"""Scan-pair registration example with per-stage timing.

Counterpart of :mod:`sycl_points_tpu.apps.example_registration` and of the
benchmark's step: box filter 0.5-50 m, voxel 0.25 m, exact k=10 self-k-NN,
covariances and normals for both clouds, then GICP with GEMAN_MCCLURE
annealing 10 -> 2.5 over 3 levels, LM, at most 10 iterations per level.

Usage:
  python -m sycl_points_tpu_torch.apps.example_registration SOURCE.ply TARGET.ply \
      [--voxel 0.25] [--k 10] [--loops 20] [--gt T.txt] [--device cuda]

It runs on the card unless ``--device cpu`` is given, and raises when no card
is present.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu_torch.ops.filters import box_filter
from sycl_points_tpu_torch.ops.knn import BruteForceKNN, self_knn
from sycl_points_tpu_torch.ops.robust import RobustLossType
from sycl_points_tpu_torch.ops.voxel import voxel_downsample
from sycl_points_tpu_torch.points import io
from sycl_points_tpu_torch.points.point_cloud import PointCloud, pad_capacity_for
from sycl_points_tpu_torch.registration.factors import RegType
from sycl_points_tpu_torch.registration.pipeline import (
    PipelineOutput,
    RandomSamplingParams,
    RegistrationPipelineParams,
    RobustScheduleParams,
    align_pipeline,
)
from sycl_points_tpu_torch.registration.registration import RegistrationParams, RobustParams

BOX_MIN, BOX_MAX = 0.5, 50.0

# The benchmark's registration parameters.
PAIR_PARAMS = RegistrationPipelineParams(
    registration=RegistrationParams(
        reg_type=RegType.GICP,
        robust=RobustParams(type=RobustLossType.GEMAN_MCCLURE),
        optimization_method="levenberg_marquardt",
        max_iterations=10,
    ),
    random_sampling=RandomSamplingParams(enable=True, num=1000),
    robust=RobustScheduleParams(
        auto_scale=True, init_scale=10.0, min_scale=2.5,
        rotation_init_scale=5.0, rotation_min_scale=2.5, auto_scaling_iter=3,
    ),
)


def downsample(cloud: PointCloud, voxel: float, out_capacity: Optional[int] = None) -> PointCloud:
    """Box filter, then voxel downsample into ``out_capacity`` slots."""
    return voxel_downsample(box_filter(cloud, BOX_MIN, BOX_MAX), voxel, out_capacity=out_capacity)


def with_features(cloud: PointCloud, k: int) -> PointCloud:
    """Self-k-NN, covariances and normals of a downsampled cloud."""
    knn = self_knn(cloud.points, cloud.mask, k)
    covs = estimate_covariances(cloud.points, knn)
    return cloud.replace(covs=covs, normals=extract_normals(cloud.points, covs))


def preprocess(cloud: PointCloud, voxel: float, k: int, out_capacity: Optional[int] = None) -> PointCloud:
    """The benchmark's per-scan preprocess."""
    return with_features(downsample(cloud, voxel, out_capacity), k)


def voxel_capacity(clouds, voxel: float) -> int:
    """Static post-voxel capacity for the largest voxel count of ``clouds``."""
    n_vox = max(int(downsample(c, voxel).count()) for c in clouds)
    return pad_capacity_for(n_vox)


class PairResult(NamedTuple):
    output: PipelineOutput
    source: PointCloud  # preprocessed
    target: PointCloud  # preprocessed


def register_pair(
    src_raw: PointCloud,
    tgt_raw: PointCloud,
    voxel: float = 0.25,
    k: int = 10,
    out_capacity: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    params: RegistrationPipelineParams = PAIR_PARAMS,
) -> PairResult:
    """Preprocess both raw clouds and align source onto target; the pose
    maps source coordinates into the target frame."""
    if out_capacity is None:
        out_capacity = voxel_capacity((src_raw, tgt_raw), voxel)
    src = preprocess(src_raw, voxel, k, out_capacity)
    tgt = preprocess(tgt_raw, voxel, k, out_capacity)
    out = align_pipeline(src, tgt, BruteForceKNN.build(tgt), params, generator=generator)
    return PairResult(out, src, tgt)


class StageTimer:
    """Per-stage wall times; synchronizes the device around each stage."""

    def __init__(self, device: torch.device):
        self.device = device
        self.times = defaultdict(list)

    def measure(self, name, fn):
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        self.times[name].append(time.perf_counter() - t0)
        return out

    def report(self) -> str:
        return "\n".join(
            f"{name}: {np.mean(ts) * 1e6:.0f} us (n={len(ts)})" for name, ts in sorted(self.times.items())
        )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("source")
    ap.add_argument("target")
    ap.add_argument("--voxel", type=float, default=0.25)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--loops", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--gt", default=None, help="ground-truth 4x4 matrix txt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    src_raw, tgt_raw = (
        PointCloud.from_numpy(io.read_file(path)["points"], device=device)
        for path in (args.source, args.target)
    )
    cap = voxel_capacity((src_raw, tgt_raw), args.voxel)
    generator = torch.Generator(device=device).manual_seed(1234)

    timer = StageTimer(device)
    T = None
    for i in range(args.loops + args.warmup):
        tm = timer if i >= args.warmup else StageTimer(device)
        sd = tm.measure("2. Downsampling", lambda: downsample(src_raw, args.voxel, cap))
        td = tm.measure("2. Downsampling", lambda: downsample(tgt_raw, args.voxel, cap))
        sk = tm.measure("4. kNN Search", lambda: self_knn(sd.points, sd.mask, args.k))
        tk = tm.measure("4. kNN Search", lambda: self_knn(td.points, td.mask, args.k))
        sc = tm.measure("5. compute Covariances", lambda: estimate_covariances(sd.points, sk))
        tc = tm.measure("5. compute Covariances", lambda: estimate_covariances(td.points, tk))
        sn = tm.measure("6. compute Normals", lambda: extract_normals(sd.points, sc))
        tn = tm.measure("6. compute Normals", lambda: extract_normals(td.points, tc))
        s = sd.replace(covs=sc, normals=sn)
        t = td.replace(covs=tc, normals=tn)
        out = tm.measure(
            "7. Registration",
            lambda: align_pipeline(s, t, BruteForceKNN.build(t), PAIR_PARAMS, generator=generator),
        )
        T = out.result.T.cpu().numpy()

    print(T)
    print()
    print(timer.report())
    if args.gt:
        trans_err, rot_err = pose_error(T, np.loadtxt(args.gt))
        print(f"\nvs ground truth: translation {trans_err * 100:.2f} cm, rotation {rot_err:.3f} deg")
    return 0


def pose_error(T: np.ndarray, T_gt: np.ndarray) -> tuple[float, float]:
    """(translation error [m], rotation error [deg]) of ``T`` against ``T_gt``."""
    E = np.linalg.inv(np.asarray(T_gt, np.float64)) @ np.asarray(T, np.float64)
    R = E[:3, :3]
    sin = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    cos = 0.5 * (np.trace(R) - 1.0)
    return float(np.linalg.norm(E[:3, 3])), float(np.degrees(np.arctan2(sin, cos)))


if __name__ == "__main__":
    sys.exit(main())
