"""The LiDAR-inertial frames of the port at ``raw_range_image=True`` against
the JAX package, on the CPU.

  * ``LidarInertialOdometry`` at the LIO replay deployment (``apps.lio_replay``,
    the raw-features covariances at 512 x 32, a small map, every point
    taken), 4 frames of the planar figure-8 with its IMU through both
    packages: every pose within ``test_torch_lio_frame.py``'s bound of the
    truth (0.15 m / 0.05 rad), the final poses within 0.05 m / 0.02 rad of
    each other;
  * ``FleetLIO`` at the fleet's ``--lio`` deployment with the flag: every
    stream-frame after the first a success.
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import clouds

from sycl_points_tpu.imu.preintegration import IMUMeasurement as JMeas
from sycl_points_tpu.pipeline import lidar_inertial_odometry as j_lio
from sycl_points_tpu_torch.apps import odometry_replay
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.pipeline import lidar_inertial_odometry as t_lio

from test_torch_lio_frame import pose_gap
from test_torch_raw_fleet import _raw
from test_torch_raw_lo import N_AZ, N_RINGS, _replay_tree

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import synthetic_velodyne as ref_synth  # noqa: E402


def test_raw_lidar_inertial_odometry_matches_jax():
    from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement as TMeas

    n = 4
    poses = ref_synth.figure8_trajectory(n, speed=0.35)
    params = _replay_tree(poses[0], lio=True)
    jodo = j_lio.LidarInertialOdometry(params)
    todo = t_lio.LidarInertialOdometry(params_from_reference(params), device="cpu")
    v0 = ref_synth.figure8_velocity(0.0, speed=0.35).astype(np.float32)
    jodo.x = jodo.x._replace(velocity=jnp.asarray(v0))
    todo.x = todo.x._replace(velocity=torch.as_tensor(v0))
    for odo in (jodo, todo):
        odo.velocity_np, odo.imu_v_world_at_reset = v0.copy(), v0.copy()

    def imu(s):
        g, a = ref_synth.figure8_imu(s, speed=0.35)
        return g.astype(np.float32), a.astype(np.float32)

    world, fed = ref_synth.World(), None
    for i, T in enumerate(poses):
        chunk = []
        fed = odometry_replay.feed_imu(chunk.append, imu, fed, 0.1 * i)
        for m in chunk:
            jodo.add_imu_measurement(JMeas(timestamp=m.timestamp, gyro=m.gyro, accel=m.accel))
            todo.add_imu_measurement(TMeas(timestamp=m.timestamp, gyro=m.gyro, accel=m.accel))
        jc, tc = clouds(ref_synth.scan_at(world, T, n_az=N_AZ, n_rings=N_RINGS, seed=i), capacity=N_AZ * N_RINGS)
        jr, tr = jodo.process(jc, 0.1 * i), todo.process(tc, 0.1 * i)
        assert tr.name == jr.name == ("first_frame" if i == 0 else "success")
        assert todo.preprocessed.covs is not None
        for side in (np.asarray(jodo.odom, np.float64), todo.get_odometry()):
            trans, rot = pose_gap(side, T)
            assert trans < 0.15 and rot < 0.05, (i, trans, rot)
    trans, rot = pose_gap(todo.get_odometry(), np.asarray(jodo.odom, np.float64))
    assert trans < 0.05 and rot < 0.02, (trans, rot)


def test_raw_fleet_lio_runs():
    from sycl_points_tpu_torch.apps import fleet_replay

    trajs, scans = fleet_replay.make_fleet_scans(2, 3, 256, 16, device="cpu")
    p = fleet_replay.fleet_lio_params()
    p = dataclasses.replace(p, submap=dataclasses.replace(p.submap, map_capacity=1 << 10, extract_capacity=1 << 9))
    p = _raw(p, range_image_n_az=256, range_image_n_rings=16)
    out = fleet_replay.run_fleet_lio_replay(p, trajs, scans, device="cpu")
    assert not out["not_ok"] and out["unaccounted"] == 0, out["histogram"]
