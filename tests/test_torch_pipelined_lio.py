"""``PipelinedLidarInertialOdometry`` of the port against its synchronous LIO
frame and against the JAX package's pipelined LIO, on the CPU: the three
cases of ``tests/test_pipelined_lio.py`` (a room scanned from a sensor
moving forward at 2 m/s, 10 Hz scans, a 200 Hz IMU).

  * 6 frames through the port's pipelined and synchronous LIO and the JAX
    pipelined LIO: the deferred results all ``success``; the port's
    pipelined translations within 0.02 m of its synchronous ones (the JAX
    test's bound), equal keyframe counts, nothing dropped; against JAX (other
    sampled points), pose bounds only: every pose and the final one within
    the JAX test's 0.15 m of the truth, and within 0.05 m of JAX's;
  * a tiny cloud comes back ``imu_only``, deferred, as in JAX; the pose stays
    finite;
  * the refusal of the host IMU deskew.
"""

import dataclasses

import numpy as np
import pytest

from sycl_points_tpu.imu.preintegration import IMUMeasurement as JMeas
from sycl_points_tpu.pipeline.pipelined_lio import PipelinedLidarInertialOdometry as JPipelined
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement as TMeas
from sycl_points_tpu_torch.pipeline.lidar_inertial_odometry import LidarInertialOdometry, ResultType
from sycl_points_tpu_torch.pipeline.pipelined_lio import PipelinedLidarInertialOdometry
from sycl_points_tpu_torch.points.point_cloud import PointCloud

from test_lidar_inertial_odometry import G, lio_params, make_world, scan_at  # noqa: E402

FRAME_DT, N_FRAMES = 0.1, 6
V = np.array([2.0, 0.0, 0.0], np.float32)


def _T_at(t):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = V * t
    return T


def _feed(odo, t_to):
    meas = JMeas if odo.__class__.__module__.startswith("sycl_points_tpu.") else TMeas
    for t in np.arange(-0.2, t_to, 1.0 / 200):
        odo.add_imu_measurement(meas(timestamp=10.0 + float(t), gyro=np.zeros(3, np.float32),
                                     accel=np.array([0, 0, G], np.float32)))


def _cloud(odo, pts):
    if odo.__class__.__module__.startswith("sycl_points_tpu."):
        return JCloud.from_numpy(pts)
    return PointCloud.from_numpy(pts, device="cpu")


def _run(odo, clouds):
    _feed(odo, N_FRAMES * FRAME_DT + 0.01)
    results, est = [], []
    for i, pts in enumerate(clouds):
        results.append(odo.process(_cloud(odo, pts), 10.0 + i * FRAME_DT))
        est.append(odo.get_odometry())
    if hasattr(odo, "flush"):
        odo.flush()
    return results, est


@pytest.fixture(scope="module")
def runs():
    world = make_world()
    clouds = [scan_at(world, _T_at(i * FRAME_DT)) for i in range(N_FRAMES)]
    tparams = params_from_reference(lio_params())
    sync = LidarInertialOdometry(tparams, device="cpu")
    rs, es = _run(sync, clouds)
    pl = PipelinedLidarInertialOdometry(tparams, device="cpu")
    rp, _ = _run(pl, clouds)
    jpl = JPipelined(lio_params())
    _run(jpl, clouds)
    return sync, rs, es, pl, rp, jpl


def test_pipelined_lio_matches_sync(runs):
    sync, rs, es, pl, rp, _ = runs
    assert all(r in (ResultType.first_frame, ResultType.success) for r in rs)
    assert rp[0] is ResultType.first_frame and all(r is ResultType.success for r in rp[1:])
    assert [rt for _, rt in pl.deferred_results] == [ResultType.success] * (N_FRAMES - 1)
    for j, (idx, _, T, _) in enumerate(pl.pose_log):
        assert idx == j
        np.testing.assert_allclose(T[:3, 3], es[j + 1][:3, 3], atol=0.02)
    assert len(pl.submap.keyframe_poses) == len(sync.submap.keyframe_poses)
    assert int(pl.submap.map_state.dropped) == 0


def test_pipelined_lio_matches_jax(runs):
    _, _, _, pl, _, jpl = runs
    assert [rt.value for _, rt in jpl.deferred_results] == [rt.value for _, rt in pl.deferred_results]
    for j, ((_, _, T, _), (_, _, jT, _)) in enumerate(zip(pl.pose_log, jpl.pose_log, strict=True)):
        truth = _T_at((j + 1) * FRAME_DT)
        assert np.linalg.norm(T[:3, 3] - truth[:3, 3]) < 0.15
        assert np.linalg.norm(T[:3, 3] - np.asarray(jT)[:3, 3]) < 0.05
    truth = _T_at((N_FRAMES - 1) * FRAME_DT)
    assert np.linalg.norm(pl.get_odometry()[:3, 3] - truth[:3, 3]) < 0.15


def test_pipelined_lio_imu_only_deferred():
    world = make_world(1000)
    rng = np.random.default_rng(66)
    tiny = rng.normal(size=(8, 3)).astype(np.float32) * 3
    kinds = []
    for odo in (PipelinedLidarInertialOdometry(params_from_reference(lio_params()), device="cpu"),
                JPipelined(lio_params())):
        _feed(odo, 0.5)
        assert odo.process(_cloud(odo, scan_at(world, np.eye(4))), 10.0).value == "first_frame"
        assert odo.process(_cloud(odo, tiny), 10.1).value == "success"  # optimistic
        odo.flush()
        kinds.append(odo.deferred_results[-1][1].value)
        assert np.all(np.isfinite(odo.get_odometry()))
    assert kinds == ["imu_only", "imu_only"]


def test_pipelined_lio_rejects_host_deskew():
    p = params_from_reference(lio_params())
    p = dataclasses.replace(p, imu=dataclasses.replace(p.imu, deskew=dataclasses.replace(p.imu.deskew, enable=True)))
    with pytest.raises(ValueError, match="deskew"):
        PipelinedLidarInertialOdometry(p, device="cpu")
