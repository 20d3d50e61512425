"""The odometry frames at the parameter tree's defaults on the CPU, against
the JAX package, the runs that take longest (``test_torch_og_frame.py`` has
the stages and the sampled LO replay):

  * ``LidarOdometry`` at :func:`test_torch_og_frame.og_params` with every
    random stage off (no random downsampling, no registration sampling, the
    submap's sample no smaller than the scan), 5 frames through both
    packages: the final poses within 2 mm / 0.01 deg (the bound of the
    runs that take every point in ``test_torch_lio_replay.py``), the map
    sizes within 1% (a point on a voxel edge may move with the last bits of
    the pose);
  * 5 frames of ``LidarInertialOdometry`` with the default ``scan`` and
    ``submap`` trees (at the LIO test's map and target capacities): every
    pose within 0.15 m / 0.05 rad of the truth (the JAX test's bound), the
    final poses within 0.05 m / 0.02 rad of each other.
"""

import dataclasses

import numpy as np

from _torch_parity import clouds

from sycl_points_tpu.pipeline import lidar_odometry as j_lo
from sycl_points_tpu.pipeline import params as P
from sycl_points_tpu_torch.pipeline import lidar_inertial_odometry as t_lio
from sycl_points_tpu_torch.pipeline import lidar_odometry as t_lo

from test_torch_lo_frame import pose_gap
from test_torch_og_frame import _replay, og_params


def test_every_point_replay_matches_jax():
    jlo, tlo, rows = _replay(og_params(every_point=True))
    for r in rows[1:]:
        assert r["tr"] is t_lo.ResultType.success and r["jr"] is j_lo.ResultType.success
    trans, rot = pose_gap(rows[-1]["t"], rows[-1]["j"])
    assert trans < 2e-3 and np.degrees(rot) < 0.01, (trans, rot)
    j_vox, t_vox = rows[-1]["voxels"]
    assert abs(j_vox - t_vox) <= 0.01 * j_vox


def test_lio_default_trees():
    """LidarInertialOdometry with the default scan and submap trees."""
    from test_torch_lio_frame import FRAME_DT, T_at, both_lio, feed
    from test_lidar_inertial_odometry import lio_params
    from test_lidar_inertial_odometry import make_world as lio_world
    from test_lidar_inertial_odometry import scan_at as lio_scan_at

    params = dataclasses.replace(lio_params(), scan=P.ScanParams(),
                                 submap=P.SubmapParams(map_capacity=1 << 14, extract_capacity=1 << 12))
    world = lio_world()
    jodo, todo = both_lio(params)
    assert todo.submap.is_occupancy and todo.params.scan.downsampling.polar.enable
    feed((jodo, todo), -0.2, 5 * FRAME_DT + 0.01)
    for i in range(5):
        jc, tc = clouds(lio_scan_at(world, T_at(i * FRAME_DT)))
        jr, tr = jodo.process(jc, 10.0 + i * FRAME_DT), todo.process(tc, 10.0 + i * FRAME_DT)
        assert tr.value == jr.value == ("first_frame" if i == 0 else "success")
        for side in (jodo, todo):
            trans, rot = pose_gap(side.get_odometry(), T_at(i * FRAME_DT))
            assert trans < 0.15 and rot < 0.05, (i, trans, rot)
    trans, rot = pose_gap(todo.get_odometry(), jodo.get_odometry())
    assert trans < 0.05 and rot < 0.02, (trans, rot)
    assert int(todo.submap.map_state.frame) == 5 and len(todo.get_keyframe_poses()) == 1
    assert isinstance(todo, t_lio.LidarInertialOdometry)
