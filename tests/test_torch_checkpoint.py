"""Checkpoint and resume of the port, and across the two packages, on the CPU.

  * port save -> port load: the world and ``small_params`` of
    ``tests/test_torch_lo_frame.py`` with every sampling stage taking all the
    points (the checkpoint holds no generator state, as in JAX), 3 frames,
    a checkpoint, 3 frames more; the checkpoint loaded into a fresh
    ``LidarOdometry`` and a fresh ``PipelinedLidarOdometry`` resumes within
    1e-5 m and 1e-5 (rotation entries) of the uninterrupted run, the bound of
    ``chip_smoke.py``; saving a pipelined frame drains its window first;
  * JAX save -> port load and port save -> JAX load, on both map backends:
    every saved array, the map's included, arrives equal to float32 bits and
    with its dtype, and both packages go on from it for 2 frames with poses
    within 0.1 m / 0.05 rad of the truth and 0.05 m / 0.02 rad of each other
    (the synchronous slice test's bounds);
  * the LIO state (``x``, ``P_post``, the resets) across the packages, bit
    for bit, both ways;
  * a checkpoint of another kind is refused by name.
"""

import dataclasses

import numpy as np
import pytest

from sycl_points_tpu.imu.preintegration import IMUMeasurement as JMeas
from sycl_points_tpu.pipeline import checkpoint as j_ckpt
from sycl_points_tpu.pipeline.lidar_inertial_odometry import LidarInertialOdometry as JLIO
from sycl_points_tpu.pipeline.lidar_odometry import LidarOdometry as JLO
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.pipeline import checkpoint as t_ckpt
from sycl_points_tpu_torch.pipeline.lidar_inertial_odometry import LidarInertialOdometry as TLIO
from sycl_points_tpu_torch.pipeline.lidar_odometry import LidarOdometry as TLO
from sycl_points_tpu_torch.pipeline import pipelined_odometry as t_pl
from sycl_points_tpu_torch.pipeline.pipelined_odometry import PipelinedLidarOdometry as TPipelined
from sycl_points_tpu_torch.points.point_cloud import PointCloud as TCloud
from sycl_points_tpu_torch.utils import lie_np

from test_lidar_inertial_odometry import G, lio_params  # noqa: E402
from test_lidar_inertial_odometry import make_world as lio_world  # noqa: E402
from test_lidar_inertial_odometry import scan_at as lio_scan_at  # noqa: E402
from test_torch_lo_frame import make_world, scan_at, small_params, trajectory
from test_torch_pipelined_lo import _InFlight

RESUME_ATOL = 1e-5


def _every_point(p):
    down = dataclasses.replace(p.scan.downsampling,
                               random=dataclasses.replace(p.scan.downsampling.random, enable=False))
    return dataclasses.replace(
        p, scan=dataclasses.replace(p.scan, downsampling=down),
        registration_sampling=dataclasses.replace(p.registration_sampling, enable=False),
        submap=dataclasses.replace(p.submap, point_random_sampling_num=p.scan_capacity))


def _frames(n):
    world, poses = make_world(), trajectory(n)
    return poses, [scan_at(world, T) for T in poses]


def _tcloud(pts):
    return TCloud.from_numpy(pts, capacity=1 << 13, device="cpu")


def test_port_resume_equals_the_uninterrupted_run(tmp_path):
    poses, pts = _frames(6)
    params = params_from_reference(_every_point(small_params()))
    path = str(tmp_path / "state.npz")
    lo = TLO(params, device="cpu")
    full = []
    for i, p in enumerate(pts):
        lo.process(_tcloud(p), 0.1 * (i + 1))
        if i == 2:
            t_ckpt.save_checkpoint(path, lo)
        if i >= 3:
            full.append(lo.get_odometry())
    for cls in (TLO, TPipelined):
        odo = cls(params, device="cpu")
        t_ckpt.load_checkpoint(path, odo)
        got = []
        for i in range(3, 6):
            assert odo.process(_tcloud(pts[i]), 0.1 * (i + 1)).value == "success"
            got.append(odo.get_odometry())
        if cls is TPipelined:
            odo.flush()
            got = [T for _, _, T, _ in odo.pose_log]
            assert [i for i, _, _, _ in odo.pose_log] == [2, 3, 4]  # frame indices go on
        for a, b in zip(got, full, strict=True):
            np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=RESUME_ATOL)
            np.testing.assert_allclose(a[:3, :3], b[:3, :3], atol=RESUME_ATOL)


def test_saving_a_pipelined_frame_drains_it(tmp_path, monkeypatch):
    monkeypatch.setattr(t_pl, "DeferredFetch", _InFlight)
    _, pts = _frames(3)
    pl = TPipelined(params_from_reference(small_params()), device="cpu")
    for i, p in enumerate(pts):
        pl.process(_tcloud(p), 0.1 * (i + 1))
    assert len(pl._pending) == 2 and not pl.pose_log
    t_ckpt.save_checkpoint(str(tmp_path / "pl.npz"), pl)
    assert not pl._pending and len(pl.pose_log) == 2
    lo = TLO(params_from_reference(small_params()), device="cpu")
    t_ckpt.load_checkpoint(str(tmp_path / "pl.npz"), lo)
    np.testing.assert_array_equal(lo.odom, pl.odom)
    assert lo.frame_count == pl.frame_count and lo.registrated


def _assert_same_arrays(path_a, path_b, skip=("__meta__", "prev_Hraw", "prev_inlier")):
    a, b = np.load(path_a), np.load(path_b)
    assert set(a.files) - set(skip) == set(b.files) - set(skip)
    for k in set(a.files) - set(skip):
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _gap(A, B):
    d = np.linalg.inv(np.asarray(A, np.float64)) @ np.asarray(B, np.float64)
    return float(np.linalg.norm(d[:3, 3])), float(np.linalg.norm(lie_np.se3_log(d)[:3]))


@pytest.mark.parametrize("map_type,voxel_size", [("VOXEL_HASH_MAP", 0.5), ("OCCUPANCY_GRID_MAP", 1.0)])
def test_across_the_packages(tmp_path, map_type, voxel_size):
    # 1 m voxels on the occupancy grid: its carve walks every voxel of every
    # ray, which at 0.5 m takes a minute on the CPU
    poses, pts = _frames(5)
    jp = small_params()
    jp = dataclasses.replace(jp, submap=dataclasses.replace(jp.submap, map_type=map_type, voxel_size=voxel_size))
    tp = params_from_reference(jp)
    j_path, t_path, back = (str(tmp_path / f) for f in ("jax.npz", "port.npz", "back.npz"))

    # JAX save -> port load, and the port's save of what it loaded equals JAX's file
    jlo = JLO(jp)
    for i in range(3):
        jlo.process(JCloud.from_numpy(pts[i], capacity=1 << 13), 0.1 * (i + 1))
    j_ckpt.save_checkpoint(j_path, jlo)
    tlo = TLO(tp, device="cpu")
    t_ckpt.load_checkpoint(j_path, tlo)
    t_ckpt.save_checkpoint(t_path, tlo)
    _assert_same_arrays(j_path, t_path)

    # port save -> JAX load: JAX writes back the port's arrays unchanged
    j2 = JLO(jp)
    j_ckpt.load_checkpoint(t_path, j2)
    j_ckpt.save_checkpoint(back, j2)
    _assert_same_arrays(t_path, back)

    # both packages go on from the same state
    for i in range(3, 5):
        assert tlo.process(_tcloud(pts[i]), 0.1 * (i + 1)).value == "success"
        assert j2.process(JCloud.from_numpy(pts[i], capacity=1 << 13), 0.1 * (i + 1)).value == "success"
        for T in (tlo.get_odometry(), j2.get_odometry()):
            trans, rot = _gap(T, poses[i])
            assert trans < 0.1 and rot < 0.05
    trans, rot = _gap(tlo.get_odometry(), j2.get_odometry())
    assert trans < 0.05 and rot < 0.02


def test_lio_state_across_the_packages(tmp_path):
    world = lio_world()
    jodo, todo = JLIO(lio_params()), TLIO(params_from_reference(lio_params()), device="cpu")
    for t in np.arange(-0.2, 0.25, 1.0 / 200):
        jodo.add_imu_measurement(JMeas(timestamp=10.0 + float(t), gyro=np.zeros(3, np.float32),
                                       accel=np.array([0, 0, G], np.float32)))
    for i in range(2):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.2 * i
        jodo.process(JCloud.from_numpy(lio_scan_at(world, T)), 10.0 + 0.1 * i)
    j_path, t_path, back = (str(tmp_path / f) for f in ("jax.npz", "port.npz", "back.npz"))
    j_ckpt.save_checkpoint(j_path, jodo)
    t_ckpt.load_checkpoint(j_path, todo)
    for name in todo.x._fields:
        np.testing.assert_array_equal(getattr(todo.x, name).numpy(), np.asarray(getattr(jodo.x, name)))
    np.testing.assert_array_equal(todo.P_post.numpy(), np.asarray(jodo.P_post))
    assert todo.last_imu_reset_timestamp == pytest.approx(10.1)
    t_ckpt.save_checkpoint(t_path, todo)
    _assert_same_arrays(j_path, t_path)
    j2 = JLIO(lio_params())
    j_ckpt.load_checkpoint(t_path, j2)
    j_ckpt.save_checkpoint(back, j2)
    _assert_same_arrays(t_path, back)


def test_refuses_another_kind(tmp_path):
    _, pts = _frames(2)
    lo = TLO(params_from_reference(small_params()), device="cpu")
    lo.process(_tcloud(pts[0]), 0.1)
    path = str(tmp_path / "lo.npz")
    t_ckpt.save_checkpoint(path, lo)
    with pytest.raises(ValueError, match="checkpoint is for LidarOdometry, not LidarInertialOdometry"):
        t_ckpt.load_checkpoint(path, TLIO(params_from_reference(lio_params()), device="cpu"))
    lio_path = str(tmp_path / "lio.npz")
    t_ckpt.save_checkpoint(lio_path, TLIO(params_from_reference(lio_params()), device="cpu"))
    with pytest.raises(ValueError, match="checkpoint is for LidarInertialOdometry, not PipelinedLidarOdometry"):
        t_ckpt.load_checkpoint(lio_path, TPipelined(params_from_reference(small_params()), device="cpu"))
    # the JAX loader refuses the port's file by the same rule
    with pytest.raises(ValueError, match="checkpoint is for LidarOdometry"):
        j_ckpt.load_checkpoint(path, JLIO(lio_params()))
