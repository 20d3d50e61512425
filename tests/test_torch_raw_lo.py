"""The LiDAR-odometry frames of the port at ``raw_range_image=True`` against
the JAX package, on the CPU.

  * ``LidarOdometry`` at the replay deployment (``apps.odometry_replay``,
    the raw-features covariances at 512 x 32, a small map, every point
    taken), 5 frames of the synthetic figure-8 through both packages: every
    pose within ``test_torch_lo_frame.py``'s bound of the truth (0.1 m /
    0.05 rad), the final poses within 0.05 m / 0.02 rad of each other;
  * the raw frame searches no self-k-NN for its scan, only for a keyframe's
    submap;
  * ``PipelinedLidarOdometry`` on the same scans: every deferred result a
    success, the poses equal to the synchronous frames' within 1e-5 m.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_parity import clouds

from sycl_points_tpu.pipeline import lidar_odometry as j_lo
from sycl_points_tpu.pipeline import params as P
from sycl_points_tpu.imu.preintegration import IMUPreintegrationParams as JPreParams
from sycl_points_tpu_torch.apps import odometry_replay
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.pipeline import lidar_odometry as t_lo
from sycl_points_tpu_torch.pipeline.pipelined_odometry import PipelinedLidarOdometry
from sycl_points_tpu_torch.points.point_cloud import PointCloud as TCloud

from test_torch_checkpoint import _every_point
from test_torch_lio_frame import pose_gap

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import synthetic_velodyne as ref_synth  # noqa: E402

N_AZ, N_RINGS = 512, 32
LO_FRAMES = 5


def _replay_tree(T0, lio=False):
    """The replay deployments (``apps.odometry_replay.replay_params``,
    ``apps.lio_replay.lio_params``) in the JAX package's parameter tree, on a
    small map, with the raw-features covariances at N_AZ x N_RINGS and every
    point taken."""
    common = dict(
        scan=P.ScanParams(downsampling=P.DownsamplingParams(
            voxel=P.VoxelDownsamplingParams(enable=True, size=1.0), polar=P.PolarDownsamplingParams(enable=False),
            random=P.RandomDownsamplingParams(enable=True, num=5000))),
        submap=P.SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0, map_capacity=1 << 12,
                              extract_capacity=1 << 11, point_random_sampling_num=512),
        covariance_estimation=P.CovarianceEstimationParams(
            raw_range_image=True, range_image_n_az=N_AZ, range_image_n_rings=N_RINGS),
        pose=P.PoseParams(initial=tuple(np.asarray(T0, np.float32).ravel().tolist())),
    )
    if lio:
        params = P.LidarInertialOdometryParams(**common, imu=P.IMUParams(enable=True, preintegration=JPreParams(
            gyro_noise_density=1e-3, accel_noise_density=1e-2, gyro_bias_rw_density=1e-5,
            accel_bias_rw_density=1e-4)))
    else:
        params = P.LidarOdometryParams(**common, scan_capacity=1 << 13)
    return _every_point(params)


@pytest.fixture(scope="module")
def lo_frames():
    poses = ref_synth.figure8_trajectory(LO_FRAMES, speed=0.35)
    world = ref_synth.World()
    return poses, [ref_synth.scan_at(world, T, n_az=N_AZ, n_rings=N_RINGS, seed=i) for i, T in enumerate(poses)]


@pytest.fixture(scope="module")
def lo_pair(lo_frames):
    poses, scans = lo_frames
    params = _replay_tree(poses[0])
    jlo, tlo = j_lo.LidarOdometry(params), t_lo.LidarOdometry(params_from_reference(params), device="cpu")
    rows = []
    for i, pts in enumerate(scans):
        jc, tc = clouds(pts, capacity=N_AZ * N_RINGS)
        before = cuda_knn.launch_counts["knn_k"]
        jr, tr = jlo.process(jc, 0.1 * (i + 1)), tlo.process(tc, 0.1 * (i + 1))
        rows.append(dict(jr=jr, tr=tr, j=jlo.get_odometry(), t=tlo.get_odometry(), truth=poses[i],
                         kf=tlo.is_keyframe_last_frame, covs=tlo.preprocessed.covs is not None))
        assert cuda_knn.launch_counts["knn_k"] == before  # the CPU runs the plain versions
    return params, rows


def test_raw_lidar_odometry_matches_jax(lo_pair):
    _, rows = lo_pair
    for i, r in enumerate(rows):
        want = "first_frame" if i == 0 else "success"
        assert r["tr"].name == r["jr"].name == want and r["covs"]
        for side in ("j", "t"):
            trans, rot = pose_gap(r[side], r["truth"])
            assert trans < 0.1 and rot < 0.05, (i, side, trans, rot)
    trans, rot = pose_gap(rows[-1]["t"], rows[-1]["j"])
    assert trans < 0.05 and rot < 0.02, (trans, rot)


def test_raw_frame_searches_no_scan_knn(lo_frames, monkeypatch):
    """The raw frame estimates its covariances from the range image: the
    self-k-NN runs only for a keyframe's submap, never for the scan."""
    from sycl_points_tpu_torch.ops import knn as t_knn

    poses, scans = lo_frames
    calls = []
    real = t_knn.brute_force_knn
    monkeypatch.setattr(t_knn, "brute_force_knn", lambda *a, **kw: calls.append(a[0].shape[0]) or real(*a, **kw))
    lo = t_lo.LidarOdometry(params_from_reference(_replay_tree(poses[0])), device="cpu")
    for i, pts in enumerate(scans[:3]):
        n = len(calls)
        lo.process(clouds(pts, capacity=N_AZ * N_RINGS)[1], 0.1 * (i + 1))
        assert len(calls) - n == (1 if i == 0 or lo.is_keyframe_last_frame else 0), (i, calls)


def test_raw_pipelined_frames_equal_the_synchronous(lo_frames, lo_pair):
    poses, scans = lo_frames
    params, rows = lo_pair
    tp = params_from_reference(params)
    tscans = [TCloud.from_numpy(p, capacity=N_AZ * N_RINGS, device="cpu") for p in scans]
    out = odometry_replay.run_pipelined_replay(tp, poses, tscans, device="cpu")
    assert out["results"] == ["success"] * (LO_FRAMES - 1)
    for T, r in zip(out["poses"][1:], rows[1:], strict=True):
        np.testing.assert_allclose(T[:3, 3], r["t"][:3, 3], atol=1e-5)
    assert isinstance(out["odometry"], PipelinedLidarOdometry)
