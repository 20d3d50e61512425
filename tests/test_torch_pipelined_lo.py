"""``PipelinedLidarOdometry`` of the port against its synchronous frame and
against the JAX package's pipelined frame, on the CPU.

  * port pipelined against port synchronous, the world and ``small_params``
    of ``tests/test_torch_lo_frame.py`` over 8 frames of the trajectory of
    ``tests/test_pipelined_odometry.py``: the JAX test's bounds (translation
    0.02 m, rotation entries 0.01, every pose within 0.1 m of the truth,
    equal keyframe counts, map voxels within max(3, 2%), nothing dropped);
  * port pipelined against JAX pipelined on the same scans: the samplers
    draw from other generators, so pose bounds only (every pose within 0.1 m
    of the truth, the final poses within 0.05 m / 0.02 rad of each other, as
    the synchronous slice test);
  * frames kept in flight (a fetch that never reports ready): the window
    fills to ``max_in_flight``, only a full window waits, every pose still
    within the JAX test's bounds of the synchronous run's, and the stashed
    map states equal their clones taken at dispatch after later inserts;
  * the small-frame hold (the pose exactly held, the stream recovers within
    0.1 m), the refusal of ``imu.enable``, ``_axis_factor_dev`` against the
    host predictor's ``_axis_factor`` (1e-6);
  * ``DeferredFetch`` on the CPU: ready at once, the value as it was when
    fetched, no host sync counted, and a refusal on another thread;
  * the default tree (occupancy grid, polar grid, intensities) at 256 x 32:
    pipelined against synchronous with the JAX test's bounds, occupied voxels
    within max(3, 2%).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from _torch_parity import np_

from sycl_points_tpu.pipeline.pipelined_odometry import PipelinedLidarOdometry as JPipelined
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu_torch.apps.odometry_replay import default_params, make_scans, run_pipelined_replay, run_replay
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.pipeline import pipelined_odometry as t_pl
from sycl_points_tpu_torch.pipeline.lidar_odometry import LidarOdometry, ResultType
from sycl_points_tpu_torch.pipeline.motion_predictor import _axis_factor
from sycl_points_tpu_torch.pipeline.params import AdaptiveAxisParams
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils import lie_np, sync
from sycl_points_tpu_torch.utils.sync import DeferredFetch

from test_torch_lo_frame import make_world, scan_at, small_params

TRANS_M, ROT = 0.02, 0.01  # tests/test_pipelined_odometry.py:70-71
N_FRAMES = 8


def _trajectory(n=N_FRAMES):
    """tests/test_pipelined_odometry.py's: 0.25 m forward, a slight turn."""
    poses, T = [], np.eye(4, dtype=np.float32)
    step = lie_np.se3_exp(np.array([0.0, 0.0, 0.03, 0.25, 0.05, 0.0])).astype(np.float32)
    for _ in range(n):
        poses.append(T.copy())
        T = (T @ step).astype(np.float32)
    return poses


def _scans(small_at=None):
    world, poses = make_world(), _trajectory()
    pts = [np.zeros((4, 3), np.float32) if i == small_at else scan_at(world, T) for i, T in enumerate(poses)]
    return poses, pts


def _tparams():
    return params_from_reference(small_params())


def _run(odo, pts):
    results = [odo.process(PointCloud.from_numpy(p, device="cpu"), 0.1 * i) for i, p in enumerate(pts)]
    odo.flush()
    return results


def _assert_close_poses(a, b, trans=TRANS_M, rot=ROT):
    np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=trans)
    np.testing.assert_allclose(a[:3, :3], b[:3, :3], atol=rot)


@pytest.fixture(scope="module")
def runs():
    poses, pts = _scans()
    sync_lo = LidarOdometry(_tparams(), device="cpu")
    sync_est = []
    for i, p in enumerate(pts):
        sync_lo.process(PointCloud.from_numpy(p, device="cpu"), 0.1 * i)
        sync_est.append(sync_lo.get_odometry())
    pl = t_pl.PipelinedLidarOdometry(_tparams(), device="cpu")
    results = _run(pl, pts)
    jpl = JPipelined(small_params())
    for i, p in enumerate(pts):
        jpl.process(JCloud.from_numpy(p), timestamp=0.1 * i)
    jpl.flush()
    return poses, pts, sync_lo, sync_est, pl, results, jpl


def test_pipelined_matches_sync(runs):
    poses, _, sync_lo, sync_est, pl, results, _ = runs
    assert results[0] is ResultType.first_frame
    assert all(r is ResultType.success for r in results[1:])
    assert [rt for _, rt in pl.deferred_results] == [ResultType.success] * (N_FRAMES - 1)
    assert [i for i, _, _, _ in pl.pose_log] == list(range(N_FRAMES - 1))
    for j, (_, _, T, _) in enumerate(pl.pose_log):
        _assert_close_poses(T, sync_est[j + 1])
        assert np.linalg.norm(T[:3, 3] - poses[j + 1][:3, 3]) < 0.1
    assert len(pl.get_keyframe_poses()) == len(sync_lo.get_keyframe_poses())
    vox, sync_vox = int(pl.submap.map_state.used.sum()), int(sync_lo.submap.map_state.used.sum())
    assert abs(vox - sync_vox) <= max(3, 0.02 * sync_vox)
    assert int(pl.submap.map_state.dropped) == 0
    np.testing.assert_array_equal(pl.get_odometry(), pl.pose_log[-1][2])


def test_pipelined_matches_jax(runs):
    poses, _, _, _, pl, _, jpl = runs
    assert [rt.value for _, rt in jpl.deferred_results] == [rt.value for _, rt in pl.deferred_results]
    for (_, _, T, _), (_, _, jT, _), truth in zip(pl.pose_log, jpl.pose_log, poses[1:], strict=True):
        assert np.linalg.norm(T[:3, 3] - truth[:3, 3]) < 0.1
        assert np.linalg.norm(np.asarray(jT)[:3, 3] - truth[:3, 3]) < 0.1
    T, jT = pl.pose_log[-1][2], np.asarray(jpl.pose_log[-1][2])
    assert np.linalg.norm(T[:3, 3] - jT[:3, 3]) < 0.05
    assert np.linalg.norm(lie_np.se3_log(np.linalg.inv(jT) @ T)[:3]) < 0.02


class _InFlight(DeferredFetch):
    """A fetch that never reports its copy landed: frames stay in flight, and
    only a full window (or a flush) takes them, counted as a blocking fetch."""

    def ready(self) -> bool:
        return False

    def get(self) -> np.ndarray:
        sync.counts["blocking_fetches"] += 1
        return self._host.numpy()


@pytest.mark.parametrize("map_type", ["VOXEL_HASH_MAP", "OCCUPANCY_GRID_MAP"])
def test_frames_in_flight_and_stashes(runs, monkeypatch, map_type):
    _, pts, _, sync_est, _, _, _ = runs
    monkeypatch.setattr(t_pl, "DeferredFetch", _InFlight)
    params = _tparams()
    params = dataclasses.replace(params, submap=dataclasses.replace(params.submap, map_type=map_type))
    pl = t_pl.PipelinedLidarOdometry(params, max_in_flight=3, device="cpu")
    stashes, blocking = [], []
    for i, p in enumerate(pts):
        sync.reset_sync_count()
        pl.process(PointCloud.from_numpy(p, device="cpu"), 0.1 * i)
        blocking.append(sync.counts["blocking_fetches"])
        if pl._pending:
            st = pl._pending[-1].prev_map_state
            stashes.append((st, {f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)}))
    # frames 1-3 fill the window, each later one waits for the oldest
    assert blocking == [0, 0, 0, 0, 1, 1, 1, 1] and pl.in_flight_peak == 3 and len(pl._pending) == 3
    # no later insert wrote into a stashed state
    for st, clone in stashes:
        for name, value in clone.items():
            assert torch.equal(getattr(st, name), value), name
    pl.flush()
    assert len(pl.pose_log) == N_FRAMES - 1 and int(pl.submap.map_state.dropped) == 0
    if map_type == "VOXEL_HASH_MAP":  # the synchronous run is on the voxel-hash map
        for j, (_, _, T, _) in enumerate(pl.pose_log):
            _assert_close_poses(T, sync_est[j + 1])


def test_small_frame_holds_pose():
    poses, pts = _scans(small_at=3)
    pl = t_pl.PipelinedLidarOdometry(_tparams(), device="cpu")
    _run(pl, pts[:6])
    kinds = {i: rt for i, _, _, rt in pl.pose_log}  # process call i logs as frame i - 1
    assert kinds[2] is ResultType.small_number_of_points
    assert kinds[1] is ResultType.success and kinds[3] is ResultType.success
    T = {i: T for i, _, T, _ in pl.pose_log}
    np.testing.assert_array_equal(T[1], T[2])
    assert np.linalg.norm(T[4][:3, 3] - poses[5][:3, 3]) < 0.1


def test_refuses_imu():
    p = _tparams()
    with pytest.raises(ValueError, match="imu.enable=False"):
        t_pl.PipelinedLidarOdometry(dataclasses.replace(p, imu=dataclasses.replace(p.imu, enable=True)),
                                    device="cpu")


@pytest.mark.parametrize("inlier", [0, 1, 37, 5000])
def test_axis_factor_on_the_device_equals_the_host(inlier):
    rng = np.random.default_rng(inlier)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    H = (q * rng.uniform(0, 12 * max(inlier, 1), 3)) @ q.T
    axis = AdaptiveAxisParams(factor_min=0.2, factor_max=1.0, min_eigenvalue_low=5.0, min_eigenvalue_high=10.0)
    got = t_pl._axis_factor_dev(torch.from_numpy(H.astype(np.float32)), torch.tensor(inlier, dtype=torch.int32),
                                axis)
    assert float(got) == pytest.approx(_axis_factor(H.astype(np.float32), inlier, axis), abs=1e-6)


def test_deferred_fetch_on_the_cpu():
    x = torch.arange(6, dtype=torch.float32)
    sync.reset_sync_count()
    f = DeferredFetch(x)
    x.add_(1.0)  # the fetch holds the value it was made from
    assert f.ready()
    np.testing.assert_array_equal(f.get(), np.arange(6, dtype=np.float32))
    assert sync.counts == {"host_syncs": 0, "blocking_fetches": 0}
    errors = []
    t = threading.Thread(target=lambda: errors.append(pytest.raises(RuntimeError, f.ready)))
    t.start()
    t.join(10.0)
    assert not t.is_alive() and len(errors) == 1


def test_default_tree():
    poses, scans = make_scans(5, 256, 32, device="cpu", intensities=True)
    p = default_params(poses[0])
    p = dataclasses.replace(p, submap=dataclasses.replace(p.submap, map_capacity=1 << 12, extract_capacity=1 << 11))
    sync_out = run_replay(p, poses, scans, device="cpu")
    out = run_pipelined_replay(p, poses, scans, device="cpu")
    assert out["results"] == ["success"] * 4
    for a, b in zip(out["poses"], sync_out["poses"], strict=True):
        _assert_close_poses(a, b)
    occ, sync_occ = out["odometry"].submap.occupied_voxels(), sync_out["odometry"].submap.occupied_voxels()
    assert abs(occ - sync_occ) <= max(3, 0.02 * sync_occ)
    assert int(out["odometry"].submap.map_state.frame) == 5  # an insert every frame
    assert np_(out["odometry"].preprocessed.intensities) is not None
