"""The LiDAR-inertial frame of the port against the JAX package, on the CPU.

The world, the parameters and the motion are those of
``tests/test_lidar_inertial_odometry.py``: a room scanned from a sensor
moving forward at 2 m/s, level, 10 Hz scans and a 200 Hz IMU.

  * the slice as a whole: 6 frames through both packages'
    ``LidarInertialOdometry``. The sampled sets differ (JAX keys against
    torch generators), so the trajectories are held by bounds: every pose
    within the JAX test's bound of the truth (0.15 m / 0.05 rad), the two
    final poses within 0.05 m / 0.02 rad of each other, the velocities
    within 0.3 m/s; result types, stage names and host syncs;
  * the ``imu_only`` fallback on a tiny cloud (the prediction alone: both
    packages' poses within 1e-3 m, the registration does not enter),
    ``old_timestamp``, ``waiting_initial_alignment`` then the aligned first
    frame (the rotation equal to JAX's to 1e-6), the ``error`` result on a
    non-finite IMU, ``collect_trace``;
  * a 4-frame deskew-on run on the JAX test's spinning-sweep distortion:
    every frame tracked, ATE under the JAX test's 0.25 m, no gyro bias
    invented (under 0.005 rad/s);
  * ``LidarOdometry`` with the IMU in ``GYRO_LIDAR_CV`` and ``IMU_SE3``
    prediction and with ``lo_velocity_update`` (VICP) on timestamped scans:
    5 frames each through both packages, every pose within 0.1 m / 0.05 rad
    of the truth and the final poses within 0.05 m / 0.02 rad of each other.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import clouds, np_

from sycl_points_tpu.imu.initial_alignment import InitialAlignmentParams
from sycl_points_tpu.imu.preintegration import IMUMeasurement as JMeas
from sycl_points_tpu.pipeline import lidar_inertial_odometry as j_lio
from sycl_points_tpu.pipeline import lidar_odometry as j_lo
from sycl_points_tpu.pipeline import params as P
from sycl_points_tpu.registration.pipeline import VelocityUpdateParams
from sycl_points_tpu.utils import lie_np
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement as TMeas
from sycl_points_tpu_torch.lio.lio_registration import TRACE_COLS
from sycl_points_tpu_torch.pipeline import lidar_inertial_odometry as t_lio
from sycl_points_tpu_torch.pipeline import lidar_odometry as t_lo

from test_lidar_inertial_odometry import (  # noqa: E402
    G,
    _circle_motion,
    _distorted_scan,
    lio_params,
    make_world,
    scan_at,
)

FRAME_DT = 0.1
V = np.array([2.0, 0.0, 0.0], np.float32)
STAGES = {"1. preprocessing", "3. registration", "4a. submap dispatch", "4b. stats fetch", "4. build submap"}


def pose_gap(A, B):
    """(translation distance, rotation angle in rad) between two poses."""
    d = np.linalg.inv(np.asarray(A, np.float64)) @ np.asarray(B, np.float64)
    return float(np.linalg.norm(d[:3, 3])), float(np.linalg.norm(lie_np.se3_log(d)[:3]))


def T_at(t):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = V * t
    return T


def feed(odos, t_from, t_to, hz=200.0, gyro=(0.0, 0.0, 0.0), accel=(0.0, 0.0, G)):
    g, a = np.asarray(gyro, np.float32), np.asarray(accel, np.float32)
    for t in np.arange(t_from, t_to, 1.0 / hz):
        for odo in odos:
            meas = JMeas if odo.__class__.__module__.startswith("sycl_points_tpu.") else TMeas
            odo.add_imu_measurement(meas(timestamp=10.0 + float(t), gyro=g, accel=a))


def both_lio(params=None, **kw):
    params = params or lio_params()
    return j_lio.LidarInertialOdometry(params, **kw), t_lio.LidarInertialOdometry(
        params_from_reference(params), device="cpu", **kw)


@pytest.fixture(scope="module")
def replay():
    """6 frames of the constant-velocity track through both packages."""
    world = make_world()
    jodo, todo = both_lio()
    feed((jodo, todo), -0.2, 6 * FRAME_DT + 0.01)
    rows = []
    for i in range(6):
        jc, tc = clouds(scan_at(world, T_at(i * FRAME_DT)))
        jr, tr = jodo.process(jc, 10.0 + i * FRAME_DT), todo.process(tc, 10.0 + i * FRAME_DT)
        rows.append(dict(jr=jr, tr=tr, j=jodo.get_odometry(), t=todo.get_odometry(), truth=T_at(i * FRAME_DT),
                         syncs=todo.sync_count_last_frame, times=todo.get_processing_times(),
                         iterations=todo.iterations_last_frame))
    return jodo, todo, rows


def test_replay_result_types(replay):
    _, _, rows = replay
    assert rows[0]["tr"] is t_lio.ResultType.first_frame and rows[0]["jr"] is j_lio.ResultType.first_frame
    for r in rows[1:]:
        assert r["tr"] is t_lio.ResultType.success and r["jr"] is j_lio.ResultType.success
    assert [m.name for m in t_lio.ResultType] == [m.name for m in j_lio.ResultType]


@pytest.mark.parametrize("frame", range(6))
def test_replay_tracks_the_truth(replay, frame):
    r = replay[2][frame]
    for side in ("j", "t"):
        trans, rot = pose_gap(r[side], r["truth"])
        assert trans < 0.15 and rot < 0.05, (side, trans, rot)


def test_replay_final_state_agrees(replay):
    jodo, todo, rows = replay
    trans, rot = pose_gap(rows[-1]["t"], rows[-1]["j"])
    assert trans < 0.05 and rot < 0.02, (trans, rot)
    v_t, v_j = np_(todo.get_state().velocity), np.asarray(jodo.get_state().velocity)
    assert np.linalg.norm(v_t - v_j) < 0.3 and np.linalg.norm(v_t - V) < 0.6
    np.testing.assert_allclose(todo.velocity_np, v_t, atol=1e-6)
    assert np.linalg.norm(todo.gyro_bias_np) <= 0.1 + 1e-6 and np.linalg.norm(todo.accel_bias_np) <= 0.5 + 1e-6
    assert np.isfinite(np_(todo.P_post)).all()
    assert todo.last_imu_reset_timestamp == todo.last_frame_time == 10.5
    assert todo.precompile_growth(1 << 20) == 0
    for r in rows[1:]:
        assert set(r["times"]) == STAGES
        # the two fetches and one exit test an iteration, a few probe loops on a keyframe
        assert r["iterations"] + 2 <= r["syncs"] <= r["iterations"] + 12
        assert 1 <= r["iterations"] <= 12


def test_imu_only_fallback():
    world = make_world(1000)
    jodo, todo = both_lio()
    feed((jodo, todo), -0.2, 0.5)
    jc, tc = clouds(scan_at(world, np.eye(4)))
    assert jodo.process(jc, 10.0) is j_lio.ResultType.first_frame
    assert todo.process(tc, 10.0) is t_lio.ResultType.first_frame
    tiny = np.random.default_rng(66).normal(size=(8, 3)).astype(np.float32) * 3
    jc, tc = clouds(tiny)
    assert jodo.process(jc, 10.1) is j_lio.ResultType.imu_only
    assert todo.process(tc, 10.1) is t_lio.ResultType.imu_only
    assert "IMU only" in todo.error_message
    np.testing.assert_allclose(todo.get_odometry(), jodo.get_odometry(), atol=1e-3)
    assert len(todo.get_keyframe_poses()) == 1


def test_old_timestamp():
    _, todo = both_lio()
    feed((todo,), -0.2, 0.3)
    c = clouds(scan_at(make_world(1000), np.eye(4)))[1]
    assert todo.process(c, 10.1) is t_lio.ResultType.first_frame
    assert todo.process(c, 10.05) is t_lio.ResultType.old_timestamp and todo.error_message == "old timestamp"


def test_waiting_initial_alignment_then_aligned():
    base = lio_params()
    params = dataclasses.replace(base, imu=dataclasses.replace(
        base.imu, initial_alignment=InitialAlignmentParams(enable=True, required_duration_sec=0.5)))
    jodo, todo = both_lio(params)
    tilt = lie_np.so3_exp_matrix(np.array([0.05, -0.03, 0.0]))
    feed((jodo, todo), -0.2, 0.0, accel=tilt.T @ np.array([0.0, 0.0, G]))
    jc, tc = clouds(scan_at(make_world(1000), np.eye(4)))
    assert todo.process(tc, 10.0) is t_lio.ResultType.waiting_initial_alignment
    assert jodo.process(jc, 10.0) is j_lio.ResultType.waiting_initial_alignment
    assert todo.error_message.startswith("initial_alignment: ")
    feed((jodo, todo), 0.0, 0.4, accel=tilt.T @ np.array([0.0, 0.0, G]))
    assert jodo.process(jc, 10.4) is j_lio.ResultType.first_frame
    assert todo.process(tc, 10.4) is t_lio.ResultType.first_frame
    np.testing.assert_allclose(todo.get_odometry(), jodo.get_odometry(), atol=1e-6)
    np.testing.assert_allclose(np_(todo.get_state().rotation), np.asarray(jodo.get_state().rotation), atol=1e-6)


def test_non_finite_imu_is_an_error():
    world = make_world(1000)
    jodo, todo = both_lio()
    feed((jodo, todo), -0.2, 0.05)
    feed((jodo, todo), 0.05, 0.3, accel=(np.nan, 0.0, G))
    jc, tc = clouds(scan_at(world, np.eye(4)))
    jodo.process(jc, 10.0), todo.process(tc, 10.0)
    odom = todo.get_odometry()
    assert jodo.process(jc, 10.1) is j_lio.ResultType.error
    assert todo.process(tc, 10.1) is t_lio.ResultType.error
    assert todo.error_message == jodo.error_message
    np.testing.assert_array_equal(todo.get_odometry(), odom)


def test_collect_trace():
    world = make_world(1000)
    _, todo = both_lio(collect_trace=True)
    feed((todo,), -0.2, 0.3)
    for i in range(2):
        todo.process(clouds(scan_at(world, T_at(i * FRAME_DT)))[1], 10.0 + i * FRAME_DT)
    tr = todo.last_trace
    assert set(tr) == {"iter_trace", "T_pred", "innovation_rot", "innovation_trans", "v_pred", "dv_update"}
    assert tr["iter_trace"].shape == (12, len(TRACE_COLS)) and tr["T_pred"].shape == (4, 4)
    assert int((~np.isnan(tr["iter_trace"][:, 0])).sum()) == todo.iterations_last_frame
    # the velocity was not seeded: the prediction stands still, the scan moved 0.2 m
    assert 0.1 < tr["innovation_trans"] < 0.3


def test_deskew_on_run():
    T_circ, v_at, gyro, accel = _circle_motion()
    world = make_world(9000)
    base = lio_params()
    params = dataclasses.replace(base, imu=dataclasses.replace(base.imu, deskew=P.IMUDeskewParams(enable=True)))
    _, todo = both_lio(params)
    v0 = v_at(0.0).astype(np.float32)
    todo.x = todo.x._replace(velocity=torch.from_numpy(v0))
    todo.velocity_np = v0
    todo.imu_v_world_at_reset = v0
    feed((todo,), -0.2, 5 * FRAME_DT + 0.01, gyro=gyro, accel=accel)
    errs = []
    for i in range(4):
        pts, t_ms = _distorted_scan(world, T_circ, i * FRAME_DT)
        tc = clouds(pts, timestamp_offsets=t_ms)[1]
        r = todo.process(tc, 10.0 + i * FRAME_DT)
        assert r in (t_lio.ResultType.first_frame, t_lio.ResultType.success), r
        errs.append(np.linalg.norm(todo.get_odometry()[:3, 3] - T_circ(i * FRAME_DT)[:3, 3]))
    assert float(np.sqrt(np.mean(np.square(errs)))) < 0.25
    assert float(np.linalg.norm(todo.gyro_bias_np)) < 0.005


# --------------------------------------------------------------------------
# the IMU branches of LidarOdometry
# --------------------------------------------------------------------------


def _lo_params(mode, imu=True, velocity_update=False):
    base = lio_params()
    return P.LidarOdometryParams(
        scan=base.scan, submap=base.submap, covariance_estimation=base.covariance_estimation,
        imu=dataclasses.replace(base.imu, enable=imu), registration=base.registration,
        registration_sampling=base.registration_sampling, scan_capacity=base.scan_capacity,
        motion_prediction=P.MotionPredictionParams(mode=mode),
        lo_velocity_update=VelocityUpdateParams(enable=velocity_update),
    )


@pytest.mark.parametrize("mode,imu,vu", [("GYRO_LIDAR_CV", True, False), ("IMU_SE3", True, False),
                                         ("LIDAR_CV", False, True)],
                         ids=["imu-gyro-lidar-cv", "imu-se3", "velocity-update"])
def test_lidar_odometry_imu_branches(mode, imu, vu):
    params = _lo_params(mode, imu, vu)
    jlo, tlo = j_lo.LidarOdometry(params), t_lo.LidarOdometry(params_from_reference(params), device="cpu")
    feed((jlo, tlo), -0.2, 5 * FRAME_DT + 0.01)
    world = make_world()
    for i in range(5):
        pts = scan_at(world, T_at(i * FRAME_DT))
        t_ms = np.linspace(0.0, 100.0, len(pts)).astype(np.float32) if vu else None
        jc, tc = clouds(pts, timestamp_offsets=t_ms)
        jr, tr = jlo.process(jc, 10.0 + i * FRAME_DT), tlo.process(tc, 10.0 + i * FRAME_DT)
        assert tr.name == jr.name == ("first_frame" if i == 0 else "success")
        for side in (jlo, tlo):
            trans, rot = pose_gap(side.get_odometry(), T_at(i * FRAME_DT))
            assert trans < 0.1 and rot < 0.05, (type(side).__module__, i, trans, rot)
    trans, rot = pose_gap(tlo.get_odometry(), jlo.get_odometry())
    assert trans < 0.05 and rot < 0.02, (trans, rot)
    if imu:
        assert tlo.imu_window_complete and tlo.last_imu_reset_timestamp == tlo.last_frame_time
        assert tlo.imu_preintegration.num_measurements == 0  # reset at the frame's end
    if mode == "IMU_SE3":
        assert tlo.imu_velocity_corrector._corrected_valid == jlo.imu_velocity_corrector._corrected_valid
        np.testing.assert_allclose(tlo.imu_v_world_at_reset, jlo.imu_v_world_at_reset, atol=0.3)
    if vu:
        assert tlo.preprocessed.timestamp_offsets is not None
