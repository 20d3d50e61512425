"""The port's ``FleetOdometry`` against the JAX package's, on the CPU.

  * Both fleets, two streams of the test world from turned and shifted
    starts, 4 frames of ``small_params()`` with every point taken (no
    sampler, so both packages draw nothing: ROADMAP "Random paths"), on both
    map backends: the same result types, every pose within 1 mm and 1e-3 rad
    of JAX's, stream and frame by stream and frame (the sampled
    single-stream test allows 5 cm, too loose to catch a wrong select in the
    batched align), the final carries within 1e-5 (converted with
    ``convert.carry_from_reference``), and the maps as sets: the stacked JAX
    state, converted with ``map_state_from_reference`` /
    ``og_state_from_reference``, holds the same voxels in every stream, with
    equal counts and sums within 1e-4 relative (float32 sums in another
    order).
  * A mesh the streams do not split over evenly is refused
    (``tests/test_torch_fleet_sharded.py`` tests the sharded fleet),
    ``precompile_growth`` is 0, and a wrong stream count is refused.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_

from sycl_points_tpu.parallel.fleet import FleetOdometry as JFleet
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu_torch.convert import (
    carry_from_reference,
    map_state_from_reference,
    og_state_from_reference,
    params_from_reference,
)
from sycl_points_tpu_torch.parallel.fleet import FleetOdometry
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils import lie_np

from test_torch_checkpoint import _every_point
from test_torch_lo_frame import make_world, scan_at, small_params

B, N_FRAMES, CAP = 2, 4, 1 << 13
TRANS_M, ROT_RAD = 1e-3, 1e-3
SUM_RTOL = 1e-4


def stream_trajectories(b, n):
    """tests/test_fleet.py's: 0.25 m a frame with a slight turn, each stream
    from its own yaw and x offset."""
    step = lie_np.se3_exp(np.array([0.0, 0.0, 0.03, 0.25, 0.05, 0.0])).astype(np.float32)
    out = []
    for s in range(b):
        yaw = 2.0 * np.pi * s / b
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
        T[0, 3] = 2.0 * s
        poses = []
        for _ in range(n):
            poses.append(T.copy())
            T = (T @ step).astype(np.float32)
        out.append(poses)
    return out


def stacked_frame(pts_list, cap=CAP):
    pts = np.zeros((len(pts_list), cap, 3), np.float32)
    mask = np.zeros((len(pts_list), cap), bool)
    for s, p in enumerate(pts_list):
        pts[s, : len(p)] = p[:cap]
        mask[s, : len(p)] = True
    return pts, mask


def run_port(fleet, scans):
    for i, frame in enumerate(scans):
        pts, mask = stacked_frame(frame)
        fleet.process_batch(PointCloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask)), 0.1 * i)
    fleet.flush()
    return fleet


@pytest.fixture(scope="module")
def world_scans():
    world = make_world()
    trajs = stream_trajectories(B, N_FRAMES)
    scans = [[scan_at(world, trajs[s][i]) for s in range(B)] for i in range(N_FRAMES)]
    return trajs, scans


def _as_set(state, b, count_field):
    used = np_(state.used[b])
    c = np_(state.coords[b])[used].astype(np.int64)
    order = np.argsort((c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2])
    return c[order], np_(getattr(state, count_field)[b])[used][order], np_(state.sum_pos[b])[used][order]


@pytest.mark.parametrize("map_type", ["VOXEL_HASH_MAP", "OCCUPANCY_GRID_MAP"])
def test_fleet_matches_jax(world_scans, map_type):
    trajs, scans = world_scans
    jp = _every_point(small_params())
    jp = dataclasses.replace(jp, submap=dataclasses.replace(jp.submap, map_type=map_type))
    init = np.stack([t[0] for t in trajs])
    jf = JFleet(jp, n_streams=B, initial_poses=init)
    for i, frame in enumerate(scans):
        pts, mask = stacked_frame(frame)
        jf.process_batch(JCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask)), 0.1 * i)
    jf.flush()
    tf = run_port(FleetOdometry(params_from_reference(jp), n_streams=B, initial_poses=init, device="cpu"), scans)

    for s in range(B):
        assert [(i, rt.value) for i, rt in tf.deferred_results[s]] == \
            [(i, rt.value) for i, rt in jf.deferred_results[s]]
        assert all(rt.value == "success" for _, rt in tf.deferred_results[s])
        for (i, ts, T, _), (ji, jts, jT, _) in zip(tf.pose_log[s], jf.pose_log[s], strict=True):
            jT = np.asarray(jT)
            assert i == ji and ts == pytest.approx(jts)
            np.testing.assert_allclose(T[:3, 3], jT[:3, 3], atol=TRANS_M)
            assert np.linalg.norm(lie_np.se3_log(np.linalg.inv(jT) @ T)[:3]) < ROT_RAD
            assert np.linalg.norm(T[:3, 3] - trajs[s][i][:3, 3]) < 0.1

    jc = carry_from_reference(jf._carry, device="cpu")
    names = ["odom", "lin_vel", "ang_vel", "last_kf_pose", "prev_T"]
    if map_type == "VOXEL_HASH_MAP":
        # the occupancy grid keeps no keyframe time: the port's carry holds
        # the first frame's timestamp, as the single-stream pipeline's does,
        # where the JAX fleet starts it at -1
        names.append("last_kf_time")
    for name in names:
        np.testing.assert_allclose(np_(getattr(tf._carry, name)), np_(getattr(jc, name)), atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(np_(tf._carry.registrated), np_(jc.registrated))

    convert, count = ((map_state_from_reference, "count") if map_type == "VOXEL_HASH_MAP"
                      else (og_state_from_reference, "hit_count"))
    jstate = convert(jf.map_state, device="cpu")
    assert jstate.coords.shape == tf.map_state.coords.shape
    for s in range(B):
        (jcoords, jcnt, jsum), (tcoords, tcnt, tsum) = _as_set(jstate, s, count), _as_set(tf.map_state, s, count)
        np.testing.assert_array_equal(tcoords, jcoords)
        np.testing.assert_array_equal(tcnt, jcnt)
        np.testing.assert_allclose(tsum, jsum, rtol=SUM_RTOL, atol=1e-3)
    assert (np_(tf.map_state.dropped) == 0).all() and not tf.growth_events


def test_fleet_refusals():
    p = params_from_reference(small_params())
    with pytest.raises(ValueError, match="2 streams do not split evenly over the 3 devices"):
        FleetOdometry(p, n_streams=2, mesh=[torch.device("cpu")] * 3, device="cpu")
    fleet = FleetOdometry(p, n_streams=2, device="cpu")
    assert fleet.precompile_growth(1 << 20) == 0
    with pytest.raises(ValueError, match="2 streams"):
        fleet.process_batch(PointCloud(points=torch.zeros(3, 8, 3), mask=torch.ones(3, 8, dtype=torch.bool)), 0.0)
    np.testing.assert_array_equal(fleet.get_odometry(1), np.eye(4, dtype=np.float32))
