"""The port's deskew against the JAX package, on the CPU.

  * constant-velocity deskew of a timestamped cloud with normals and
    covariances, some timestamps non-finite: points and normals
    rtol=1e-5, atol=2e-5, covariances atol=1e-5 (float32 se3_exp per point);
    a cloud without timestamps comes back as it is;
  * IMU deskew of a motion-distorted 512 x 32 synthetic scan (the figure-8 at
    0.7 m a frame, IMU at 400 Hz): every status the function returns, the
    deskewed cloud within 2e-5 m of JAX's (full and gyro-only, with a
    non-identity extrinsic, with normals and covariances), and closer to the
    undistorted scan than the input;
  * ``align_pipeline`` with the velocity update (VICP) against JAX's, fed
    JAX's own Gumbel scores so that both align the same sampled points: the
    sampled points equal, the deskewed registration input within 1e-4 m,
    the final pose within 1e-4 in every entry.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_parity import both, clouds, np_, rigid, spd

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import synthetic_velodyne as ref_synth  # noqa: E402

from sycl_points_tpu.deskew import constant_velocity as j_cv  # noqa: E402
from sycl_points_tpu.deskew import imu_deskew as j_deskew  # noqa: E402
from sycl_points_tpu.imu import preintegration as j_pre  # noqa: E402
from sycl_points_tpu.ops.covariance import estimate_covariances  # noqa: E402
from sycl_points_tpu.ops.filters import box_filter  # noqa: E402
from sycl_points_tpu.ops.knn import BruteForceKNN as JBruteForceKNN, approx_knn  # noqa: E402
from sycl_points_tpu.ops.voxel import voxel_downsample  # noqa: E402
from sycl_points_tpu.registration import factors as j_factors  # noqa: E402
from sycl_points_tpu.registration import pipeline as j_pipeline  # noqa: E402
from sycl_points_tpu.registration import registration as j_reg  # noqa: E402
from sycl_points_tpu_torch.convert import cloud_from_numpy, params_from_reference  # noqa: E402
from sycl_points_tpu_torch.deskew import constant_velocity as t_cv  # noqa: E402
from sycl_points_tpu_torch.deskew import imu_deskew as t_deskew  # noqa: E402
from sycl_points_tpu_torch.imu import preintegration as t_pre  # noqa: E402
from sycl_points_tpu_torch.ops.knn import BruteForceKNN as TBruteForceKNN  # noqa: E402
from sycl_points_tpu_torch.registration import pipeline as t_pipeline  # noqa: E402
from sycl_points_tpu_torch.utils import synthetic  # noqa: E402

SPEED = 0.7
PP = dict(gyro_noise_density=1e-3, accel_noise_density=1e-2)


def test_constant_velocity_deskew_matches_jax():
    rng = np.random.default_rng(0)
    n = 300
    pts = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    t_ms = rng.uniform(0, 100, size=n).astype(np.float32)
    t_ms[::17] = np.nan
    jc, tc = clouds(pts, capacity=512, normals=nrm, covs=spd(rng, n), timestamp_offsets=t_ms)
    prev, cur = rigid(rng, 0.05, 0.5), rigid(rng, 0.05, 0.5)
    jp, tp = both(prev)
    jq, tq = both(cur)
    jo = j_cv.deskew_constant_velocity(jc, jp, jq, 0.1)
    to = t_cv.deskew_constant_velocity(tc, tp, tq, 0.1)
    for name, atol in (("points", 2e-5), ("normals", 2e-5), ("covs", 1e-5)):
        np.testing.assert_allclose(np_(getattr(to, name)), np_(getattr(jo, name)), rtol=1e-5, atol=atol,
                                   err_msg=name)
    keep = ~np.isfinite(t_ms)
    np.testing.assert_array_equal(np_(to.points)[:n][keep], pts[keep])
    plain = tc.replace(timestamp_offsets=None)
    assert t_cv.deskew_constant_velocity(plain, tp, tq, 0.1) is plain


@pytest.fixture(scope="module")
def distorted():
    """A distorted 512 x 32 sweep from frame 1 to frame 2 of the figure-8,
    every return's true position in frame 1's sensor frame, and the IMU
    around the sweep."""
    from sycl_points_tpu.utils import lie_np

    poses = ref_synth.figure8_trajectory(3, speed=SPEED)
    pts, t_ms = ref_synth.scan_at_distorted(ref_synth.World(), poses[1], poses[2], n_az=512, n_rings=32, seed=1)
    xi = lie_np.se3_log(np.linalg.inv(poses[1]) @ poses[2])
    truth = np.empty_like(pts)
    for t in np.unique(t_ms):  # one sweep pose a column
        m = t_ms == t
        T = lie_np.se3_exp(float(t) / 100.0 * xi)
        truth[m] = pts[m] @ T[:3, :3].T + T[:3, 3]
    meas = []
    for k in range(121):
        t = 0.05 + k / 400
        g, a = ref_synth.figure8_imu(t, speed=SPEED)
        meas.append((t, g.astype(np.float32), a.astype(np.float32)))
    R0 = poses[1][:3, :3].astype(np.float32)
    v0 = ref_synth.figure8_velocity(0.1, speed=SPEED).astype(np.float32)
    return pts, t_ms, truth, meas, R0, v0


def _buffers(meas):
    return ([j_pre.IMUMeasurement(t, g, a) for t, g, a in meas],
            [t_pre.IMUMeasurement(t, g, a) for t, g, a in meas])


def test_distorted_scan_equals_the_original(distorted):
    pts, t_ms = distorted[:2]
    poses = synthetic.figure8_trajectory(3, speed=SPEED)
    ours = synthetic.scan_at_distorted(synthetic.World(), poses[1], poses[2], n_az=512, n_rings=32, seed=1,
                                       device="cpu")
    np.testing.assert_array_equal(ours[1], t_ms)
    np.testing.assert_allclose(ours[0], pts, atol=2e-5)  # float32 raycast against float64


@pytest.mark.parametrize("gyro_only", [False, True], ids=["full", "gyro-only"])
@pytest.mark.parametrize("extrinsic", [False, True], ids=["identity", "extrinsic"])
def test_imu_deskew_matches_jax(distorted, gyro_only, extrinsic):
    pts, t_ms, truth, meas, R0, v0 = distorted
    rng = np.random.default_rng(2)
    n = len(pts)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    jc, tc = clouds(pts, normals=nrm, covs=spd(rng, n), timestamp_offsets=t_ms)
    T_il = rigid(rng, 0.1, 0.2) if extrinsic else np.eye(4, dtype=np.float32)
    jb, tb = _buffers(meas)
    bias = np.array([0.002, -0.001, 0.0005], np.float32), np.array([0.01, 0.0, -0.02], np.float32)
    jo, js = j_deskew.deskew_point_cloud_imu(jc, jb, 0.1, 0.1, T_il, *bias, j_pre.IMUPreintegrationParams(**PP),
                                             R0, v0, gyro_only=gyro_only)
    to, ts = t_deskew.deskew_point_cloud_imu(tc, tb, 0.1, 0.1, T_il, *bias, t_pre.IMUPreintegrationParams(**PP),
                                             R0, v0, gyro_only=gyro_only)
    assert ts is t_deskew.IMUDeskewStatus.success and js.name == ts.name
    for name in ("points", "normals", "covs"):
        np.testing.assert_allclose(np_(getattr(to, name)), np_(getattr(jo, name)), rtol=1e-5, atol=2e-5,
                                   err_msg=name)
    if not (gyro_only or extrinsic):
        # the full deskew undoes the sweep
        before = np.linalg.norm(pts - truth, axis=1)
        after = np.linalg.norm(np_(to.points)[:n] - truth, axis=1)
        assert after.max() < 0.2 * before.max()


@pytest.mark.parametrize("case,status", [
    ("no-timestamps", "no_timestamps"),
    ("zero-duration", "invalid_scan_duration"),
    ("empty-buffer", "insufficient_imu_coverage"),
    ("late-start", "insufficient_imu_coverage"),
    ("early-end", "insufficient_imu_coverage"),
    ("short-window", "insufficient_imu_coverage"),
])
def test_imu_deskew_statuses_match_jax(distorted, case, status):
    pts, t_ms, _, meas, R0, v0 = distorted
    start, duration = 0.1, 0.1
    if case == "late-start":
        meas = [m for m in meas if m[0] > 0.16]
    elif case == "early-end":
        meas = [m for m in meas if m[0] < 0.14]
    elif case == "empty-buffer":
        meas = meas[:1]
    elif case == "short-window":
        start = 0.33  # the buffer ends 0.02 s into the sweep
    elif case == "zero-duration":
        duration = 0.0
    jc, tc = clouds(pts, timestamp_offsets=None if case == "no-timestamps" else t_ms)
    jb, tb = _buffers(meas)
    z = np.zeros(3, np.float32)
    jo, js = j_deskew.deskew_point_cloud_imu(jc, jb, start, duration, np.eye(4, dtype=np.float32), z, z,
                                             j_pre.IMUPreintegrationParams(**PP), R0, v0)
    to, ts = t_deskew.deskew_point_cloud_imu(tc, tb, start, duration, np.eye(4, dtype=np.float32), z, z,
                                             t_pre.IMUPreintegrationParams(**PP), R0, v0)
    assert ts.name == js.name == status
    assert to is tc  # unchanged


def _vicp_source(pose_from, pose_to, pose_ref):
    """A distorted 256 x 24 sweep between two figure-8 poses, voxelised with
    its timestamps, in both packages."""
    pts, t_ms = ref_synth.scan_at_distorted(ref_synth.World(), pose_from, pose_to, n_az=256, n_rings=24, seed=3)
    jc, _ = clouds(pts, timestamp_offsets=t_ms)
    jc = voxel_downsample(box_filter(jc, 0.5, 50.0), 0.5, out_capacity=2048)
    knn = approx_knn(jc.points, jc.mask, jc.points, 10)
    jc = jc.replace(covs=estimate_covariances(jc.points, knn))
    tc = cloud_from_numpy(jc.to_numpy(compacted=False), device="cpu")
    return jc, tc.replace(mask=both(np_(jc.mask))[1])


def test_vicp_align_pipeline_matches_jax():
    poses = ref_synth.figure8_trajectory(3, speed=SPEED)
    js, ts = _vicp_source(poses[1], poses[2], poses[1])
    jt, tt = _vicp_source(poses[0], poses[0], poses[0])  # an undistorted target at frame 0
    params = j_pipeline.RegistrationPipelineParams(
        registration=j_reg.RegistrationParams(
            reg_type=j_factors.RegType.GICP, optimization_method="gauss_newton", max_iterations=10,
            robust=j_reg.RobustParams(type=j_reg.RobustLossType.GEMAN_MCCLURE, default_scale=2.5)),
        random_sampling=j_pipeline.RandomSamplingParams(enable=True, num=500),
        velocity_update=j_pipeline.VelocityUpdateParams(enable=True, iter=2),
    )
    key = jax.random.key(1234)
    init = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    prev = np.eye(4, dtype=np.float32)
    ji, ti = both(init)
    jprev, tprev = both(prev)
    jout = j_pipeline.align_pipeline(js, jt, JBruteForceKNN.build(jt), params, initial_guess=ji, key=key,
                                     prev_pose=jprev, dt=0.1)
    scores = np_(jax.random.gumbel(key, (js.capacity,)))
    tout = t_pipeline.align_pipeline(ts, tt, TBruteForceKNN.build(tt), params_from_reference(params),
                                     initial_guess=ti, scores=both(scores)[1], prev_pose=tprev, dt=0.1)
    np.testing.assert_array_equal(np_(tout.registration_input.points), np_(jout.registration_input.points))
    assert tout.deskewed is not tout.registration_input
    np.testing.assert_allclose(np_(tout.deskewed.points), np_(jout.deskewed.points), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np_(tout.result.T), np_(jout.result.T), rtol=0, atol=1e-4)
