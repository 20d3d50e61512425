"""``LidarOdometry`` at the full-cloud coarse-to-fine deployment in the
port and in the JAX package, on the CPU.

``apps.odometry_replay.fullcloud_c2f_params`` equals the JAX replay
benchmark's tree (``benchmarks/bench_odometry_replay.py:51-92`` with
``--scan-points 30000 --reg-sampling 0 --coarse-to-fine 20``) but for
``max_iterations`` (40, so that the full target gets iterations after the 20
coarse ones). Both packages' ``LidarOdometry`` at it, every sampler taking
every point (so that neither draws), over 3 frames of 512 x 32 synthetic
scans: every frame a success, each pose within 5 cm / 0.02 rad of the
truth and the two within 1 mm / 1e-3 rad of each other; in every align the
coarse phase ran its 20 iterations and a full-target iteration ended it.
(The scan's capacity of 32,768 rows makes the plain nn1 of each iteration a
[32768, 16384] block on the CPU: ~1.4 s an iteration, ~110 s in all.)
"""

import numpy as np

import _torch_parity  # noqa: F401  (one torch thread per worker)

from sycl_points_tpu.pipeline import lidar_odometry as j_lo
from sycl_points_tpu.pipeline import params as P
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud, pad_capacity_for
from sycl_points_tpu.registration.pipeline import RandomSamplingParams
from sycl_points_tpu.registration.registration import RegistrationParams
from sycl_points_tpu_torch.apps import odometry_replay
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.pipeline import lidar_odometry as t_lo

from test_torch_checkpoint import _every_point  # noqa: E402
from test_torch_lo_frame import pose_gap  # noqa: E402


def _jax_fullcloud_tree(pose):
    """The JAX replay benchmark's tree (benchmarks/bench_odometry_replay.py:51-92
    with --scan-points 30000 --reg-sampling 0 --coarse-to-fine 20), with
    the port's max_iterations."""
    return P.LidarOdometryParams(
        scan=P.ScanParams(downsampling=P.DownsamplingParams(
            voxel=P.VoxelDownsamplingParams(enable=True, size=1.0),
            polar=P.PolarDownsamplingParams(enable=False),
            random=P.RandomDownsamplingParams(enable=True, num=30000))),
        submap=P.SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0, map_capacity=131072,
                              point_random_sampling_num=512),
        registration=P.RegistrationBlockParams(factor=RegistrationParams(coarse_to_fine_iters=20, max_iterations=40)),
        registration_sampling=RandomSamplingParams(enable=False),
        scan_capacity=max(1 << 13, pad_capacity_for(30000)),
        pose=P.PoseParams(initial=tuple(np.asarray(pose, np.float32).ravel().tolist())),
    )


def test_fullcloud_c2f_replay_matches_jax():
    poses, scans = odometry_replay.make_scans(3, 512, 32, device="cpu")
    jparams = _jax_fullcloud_tree(poses[0])
    assert params_from_reference(jparams) == odometry_replay.fullcloud_c2f_params(poses[0])
    # every sampler takes every point, so that neither package draws
    jparams = _every_point(jparams)
    jlo = j_lo.LidarOdometry(jparams)
    tlo = t_lo.LidarOdometry(params_from_reference(jparams), device="cpu")
    for i, (scan, truth) in enumerate(zip(scans, poses)):
        jr = jlo.process(JCloud.from_numpy(scan.to_numpy()["points"], capacity=scan.capacity), 0.1 * (i + 1))
        tr = tlo.process(scan, 0.1 * (i + 1))
        assert (jr.value, tr.value) == (("first_frame",) * 2 if i == 0 else ("success",) * 2)
        jT, tT = np.asarray(jlo.get_odometry()), tlo.get_odometry()
        for T in (jT, tT):
            trans, rot = pose_gap(T, truth)
            assert trans < 0.05 and rot < 0.02, (trans, rot)
        trans, rot = pose_gap(tT, jT)
        assert trans < 1e-3 and rot < 1e-3, (trans, rot)
        if i:  # the coarse phase ran, and a full-target iteration ended the align
            assert tlo.reg_result.coarse_iterations == 20 < int(tlo.reg_result.iterations)
