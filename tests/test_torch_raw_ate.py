"""The ATE of both packages' raw-features frames beside their standard frames.

On 20 full-width scans (2048 x 64 rays) of the synthetic figure-8 at 0.35 m
a frame, this module runs the LO replay deployment
(``apps/odometry_replay.replay_params``), the parameter tree's defaults
(``default_params``, scans with raw return intensities) and the LIO replay
deployment (``apps/lio_replay.lio_params``, the planar figure-8's IMU), each
with ``covariance_estimation.raw_range_image`` off and on, with the robust
(IRLS) covariance estimator the deployments use and with the plain one the
JAX raw-features test uses:

    JAX_PLATFORMS=cpu python tests/test_torch_raw_ate.py --package jax
    PYTHONPATH=. python tests/test_torch_raw_ate.py --package torch [--device cuda]

``--neighbor-num`` sets the covariances' neighbourhood (default 10, the
trees' own), ``--estimators`` and ``--raw`` pick the runs. Each run prints
one JSON line: the package, the deployment, the estimator, raw or
standard, the neighbor_num and the ATE. As a test module it checks that the JAX
parameter trees it builds convert to the port's deployments exactly, so the
two packages run the same configurations.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
DEPLOYMENTS = ("replay deployment", "default tree", "LIO replay deployment")
FRAMES, N_AZ, N_RINGS, SPEED = 20, 2048, 64, 0.35


def jax_params(deployment: str, raw: bool, robust: bool, pose: np.ndarray, neighbor_num: int = 10):
    """The JAX parameter tree of ``deployment`` starting at ``pose``."""
    from sycl_points_tpu.imu.preintegration import IMUPreintegrationParams
    from sycl_points_tpu.pipeline import params as P

    ce = P.CovarianceEstimationParams(m_estimation=P.MEstimationParams(enable=robust), raw_range_image=raw,
                                      neighbor_num=neighbor_num)
    initial = P.PoseParams(initial=tuple(np.asarray(pose, np.float32).ravel().tolist()))
    if deployment == "default tree":
        return P.LidarOdometryParams(pose=initial, covariance_estimation=ce)
    scan = P.ScanParams(downsampling=P.DownsamplingParams(
        voxel=P.VoxelDownsamplingParams(enable=True, size=1.0), polar=P.PolarDownsamplingParams(enable=False),
        random=P.RandomDownsamplingParams(enable=True, num=5000)))
    if deployment == "replay deployment":
        return P.LidarOdometryParams(
            scan=scan, covariance_estimation=ce, scan_capacity=1 << 13, pose=initial,
            submap=P.SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0, map_capacity=1 << 17,
                                  extract_capacity=1 << 14, point_random_sampling_num=512))
    return P.LidarInertialOdometryParams(
        scan=scan, covariance_estimation=ce, pose=initial,
        submap=P.SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0),
        imu=P.IMUParams(enable=True, preintegration=IMUPreintegrationParams(
            gyro_noise_density=1e-3, accel_noise_density=1e-2, gyro_bias_rw_density=1e-5,
            accel_bias_rw_density=1e-4)))


def port_params(deployment: str, raw: bool, robust: bool, pose: np.ndarray, neighbor_num: int = 10):
    """The port's deployment (``apps``) with the flag, the estimator and the
    neighbourhood."""
    from sycl_points_tpu_torch.apps import lio_replay, odometry_replay

    p = {"replay deployment": odometry_replay.replay_params, "default tree": odometry_replay.default_params,
         "LIO replay deployment": lio_replay.lio_params}[deployment](pose)
    ce = p.covariance_estimation
    return dataclasses.replace(p, covariance_estimation=dataclasses.replace(
        ce, raw_range_image=raw, neighbor_num=neighbor_num,
        m_estimation=dataclasses.replace(ce.m_estimation, enable=robust)))


def run_jax(deployment: str, raw: bool, robust: bool, frames: int, neighbor_num: int = 10) -> float:
    sys.path.insert(0, str(ROOT / "benchmarks"))
    import jax.numpy as jnp
    import synthetic_velodyne as S

    from sycl_points_tpu.imu.preintegration import IMUMeasurement
    from sycl_points_tpu.pipeline.lidar_inertial_odometry import LidarInertialOdometry
    from sycl_points_tpu.pipeline.lidar_odometry import LidarOdometry
    from sycl_points_tpu.points.point_cloud import PointCloud
    from sycl_points_tpu_torch.apps.odometry_replay import ate, feed_imu
    from sycl_points_tpu_torch.utils.synthetic import return_intensities

    poses = S.figure8_trajectory(frames, speed=SPEED)
    world = S.World()
    params = jax_params(deployment, raw, robust, poses[0], neighbor_num)
    lio = deployment == "LIO replay deployment"
    odo = (LidarInertialOdometry if lio else LidarOdometry)(params)
    if lio:
        v0 = S.figure8_velocity(0.0, speed=SPEED).astype(np.float32)
        odo.x = odo.x._replace(velocity=jnp.asarray(v0))
        odo.velocity_np, odo.imu_v_world_at_reset = v0.copy(), v0.copy()

    def imu(s):
        g, a = S.figure8_imu(s, speed=SPEED)
        return g.astype(np.float32), a.astype(np.float32)

    est, fed = [], None
    for i, T in enumerate(poses):
        pts = S.scan_at(world, T, n_az=N_AZ, n_rings=N_RINGS)
        inten = return_intensities(pts, i) if deployment == "default tree" else None
        cloud = PointCloud.from_numpy(pts, intensities=inten, capacity=N_AZ * N_RINGS)
        if lio:
            chunk = []
            fed = feed_imu(chunk.append, imu, fed, 0.1 * i)
            for m in chunk:
                odo.add_imu_measurement(IMUMeasurement(timestamp=m.timestamp, gyro=m.gyro, accel=m.accel))
            odo.process(cloud, 0.1 * i)
        else:
            odo.process(cloud, 0.1 * (i + 1))
        est.append(np.asarray(odo.get_odometry()))
    return ate(est, poses)


def run_torch(deployment: str, raw: bool, robust: bool, frames: int, device: str, neighbor_num: int = 10) -> float:
    from sycl_points_tpu_torch.apps import lio_replay, odometry_replay

    if deployment == "LIO replay deployment":
        inputs = lio_replay.make_lio_inputs(frames, N_AZ, N_RINGS, SPEED, device=device)
        return lio_replay.run_lio_replay(port_params(deployment, raw, robust, inputs.poses[0], neighbor_num),
                                         inputs, device=device)["ate_m"]
    poses, scans = odometry_replay.make_scans(frames, N_AZ, N_RINGS, SPEED, device=device,
                                              intensities=deployment == "default tree")
    return odometry_replay.run_replay(port_params(deployment, raw, robust, poses[0], neighbor_num), poses, scans,
                                      device=device)["ate_m"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--device", default="cpu", help="the port's device (torch only)")
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--deployments", nargs="*", default=list(DEPLOYMENTS))
    ap.add_argument("--neighbor-num", type=int, default=10)
    ap.add_argument("--estimators", nargs="*", choices=("robust", "plain"), default=["robust", "plain"])
    ap.add_argument("--raw", nargs="*", choices=("off", "on"), default=["off", "on"])
    args = ap.parse_args(argv)
    for deployment in args.deployments:
        for robust in [e == "robust" for e in args.estimators]:
            for raw in [r == "on" for r in args.raw]:
                if args.package == "jax":
                    ate = run_jax(deployment, raw, robust, args.frames, args.neighbor_num)
                else:
                    ate = run_torch(deployment, raw, robust, args.frames, args.device, args.neighbor_num)
                print(json.dumps({"package": args.package, "deployment": deployment,
                                  "estimator": "robust" if robust else "plain", "raw": raw,
                                  "neighbor_num": args.neighbor_num, "ate_m": ate}), flush=True)


def test_jax_trees_convert_to_the_port_deployments():
    from sycl_points_tpu_torch.convert import params_from_reference

    pose = np.eye(4)
    pose[:3, 3] = [1.0, -2.0, 0.5]
    for deployment in DEPLOYMENTS:
        for raw in (False, True):
            for robust in (False, True):
                for k in (10, 20):
                    assert params_from_reference(jax_params(deployment, raw, robust, pose, k)) == \
                        port_params(deployment, raw, robust, pose, k), (deployment, raw, robust, k)


if __name__ == "__main__":
    main()
