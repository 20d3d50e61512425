"""The fleets at the parameter tree's defaults (the polar grid, the
occupancy-grid submap, intensity correction), on the CPU.

  * ``polar_downsample`` on a fleet's ``[B, N]`` cloud with intensities, in
    both coordinate conventions, and the intensity ops (correction,
    directional Gaussian smoothing with and without a neighbour limit,
    local-mean normalization, z-score) on ``[B, N]`` clouds with their
    ``[B, N, k]`` neighbourhoods each equal B single calls bit for bit; so
    does ``PCProcessor.preprocess_streams`` at the default tree against the
    single-stream prefilter, covariances and refine filter.
  * ``FleetOdometry(LidarOdometryParams())`` and ``FleetLIO`` at the
    default ``scan`` and ``submap`` trees against the JAX fleets at the same
    trees, two streams with intensities, every point taken (no sampler,
    so both packages draw nothing): the same result types, every pose within
    1 mm (and 1e-3 rad) of JAX's, each stream's map equal to JAX's as a set
    of voxels (counts equal, sums within 1e-4 relative), and the first
    frame's preprocessed intensities within 1e-5 of JAX's on every point
    both packages keep (a point within float rounding of a polar bin edge
    may fall into the neighbouring bin, ``ops/polar.py``; at least 99% are
    common).
  * Both fleets with every value of the tree at its default, the LIO's zero
    IMU noise densities included: two frames of two streams resolve.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_

from sycl_points_tpu.imu.preintegration import IMUMeasurement as JMeas
from sycl_points_tpu.parallel.fleet import FleetLIO as JFleetLIO
from sycl_points_tpu.parallel.fleet import FleetOdometry as JFleet
from sycl_points_tpu.pipeline import params as P
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu_torch.convert import og_state_from_reference, params_from_reference
from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement as TMeas
from sycl_points_tpu_torch.ops import intensity as t_int
from sycl_points_tpu_torch.ops.knn import self_knn
from sycl_points_tpu_torch.ops.polar import CoordinateSystem, polar_downsample
from sycl_points_tpu_torch.parallel.fleet import FleetLIO, FleetOdometry
from sycl_points_tpu_torch.pipeline.pc_processor import PCProcessor
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils import lie_np

from test_lidar_inertial_odometry import G, lio_params  # noqa: E402
from test_lidar_inertial_odometry import make_world as lio_world  # noqa: E402
from test_lidar_inertial_odometry import scan_at as lio_scan_at  # noqa: E402
from test_torch_checkpoint import _every_point  # noqa: E402
from test_torch_fleet import SUM_RTOL, _as_set, stream_trajectories  # noqa: E402
from test_torch_lo_frame import make_world, scan_at  # noqa: E402
from test_torch_polar_intensity import SIZES, _scan  # noqa: E402

TRANS_M, ROT_RAD = 1e-3, 1e-3  # port fleet against JAX fleet, every point taken
INTENSITY_ATOL = 1e-5
COMMON_SHARE = 0.99
CAP = 1 << 13
LIO_T0, LIO_DT = 8.0, 0.125  # frame times float32 holds exactly


def _eq(a, b, err_msg=""):
    np.testing.assert_array_equal(np_(a), np_(b), err_msg=err_msg)


def _cloud_eq(got: PointCloud, want: PointCloud, what=""):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f"{what}{f.name}"
        if b is not None:
            _eq(a, b, f"{what}{f.name}")


def _row(cloud: PointCloud, b: int) -> PointCloud:
    return PointCloud(**{f.name: None if getattr(cloud, f.name) is None else getattr(cloud, f.name)[b]
                         for f in dataclasses.fields(cloud)})


def _stack(clouds) -> PointCloud:
    return PointCloud(**{f.name: None if getattr(clouds[0], f.name) is None
                         else torch.stack([getattr(c, f.name) for c in clouds]) for f in dataclasses.fields(clouds[0])})


# -- the ops on [B, N] against B single calls -------------------------------------


@pytest.mark.parametrize("system", ["LIDAR", "CAMERA"])
@pytest.mark.parametrize("out_capacity", [None, 1024], ids=["input-capacity", "scan-capacity"])
def test_polar_downsample_streams_equal_single_calls(system, out_capacity):
    rng = np.random.default_rng(5)
    singles = []
    for n in (3000, 2200, 2600):
        pts = _scan(rng, n, system)
        singles.append(PointCloud.from_numpy(pts, capacity=3072, device="cpu",
                                             intensities=rng.uniform(0, 100, n).astype(np.float32)))
    cs = CoordinateSystem.from_string(system)
    out = polar_downsample(_stack(singles), *SIZES, cs, out_capacity=out_capacity)
    assert out.points.shape[:2] == (3, out_capacity or 3072)
    for b, one in enumerate(singles):
        _cloud_eq(_row(out, b), polar_downsample(one, *SIZES, cs, out_capacity=out_capacity), f"stream {b}: ")


def test_intensity_ops_streams_equal_single_calls():
    rng = np.random.default_rng(9)
    singles, knns = [], []
    for n in (600, 500):
        pts = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
        pts[1] = [0, 0, 3.0]  # near the zenith
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        c = PointCloud.from_numpy(pts, capacity=640, device="cpu", normals=nrm / np.linalg.norm(nrm, axis=1)[:, None],
                                  intensities=rng.uniform(0, 200, n).astype(np.float32))
        singles.append(c)
        knns.append(self_knn(c.points, c.mask, 10))
    fleet = _stack(singles)
    knn = type(knns[0])(torch.stack([k.indices for k in knns]), torch.stack([k.distances for k in knns]))
    calls = [
        lambda c, k: t_int.correct_intensity(c, 2.0, 1e-3, 0.0, 1.0, 1.0, 0.5),
        lambda c, k: t_int.smooth_intensity(c, k, 0.02, 0.02, 0.05),
        lambda c, k: t_int.smooth_intensity(c, k, 0.02, 0.02, 0.05, k_limit=6),
        lambda c, k: t_int.local_mean_normalize(c, k, 0.02, 0.02, 0.05, 1e-3),
        lambda c, k: t_int.intensity_zscore(c, k, 0.01),
    ]
    for i, call in enumerate(calls):
        got = call(fleet, knn).intensities
        for b, (one, k) in enumerate(zip(singles, knns)):
            _eq(got[b], call(one, k).intensities, f"op {i}, stream {b}")


def test_preprocess_streams_at_the_default_tree_equals_single_stream():
    params = params_from_reference(P.LidarOdometryParams())
    world, trajs = make_world(), stream_trajectories(2, 1)
    rng = np.random.default_rng(2)
    singles = [PointCloud.from_numpy(p, capacity=CAP, device="cpu",
                                     intensities=rng.uniform(0, 100, len(p)).astype(np.float32))
               for p in (scan_at(world, t[0]) for t in trajs)]
    pc = PCProcessor(params, "cpu")
    got = pc.preprocess_streams(_stack(singles), [torch.Generator().manual_seed(s) for s in (3, 4)])
    assert got.intensities is not None and got.covs is not None
    for b, one in enumerate(singles):
        pc._generator.manual_seed(3 + b)
        c = pc.prefilter(one)
        ctx = pc.prepare_context(c)
        _cloud_eq(_row(got, b), pc.refine_filter(pc.compute_covariances(c, ctx), ctx), f"stream {b}: ")


# -- both fleets against the JAX ones at the defaults -----------------------------


def _small_maps(p):
    """The tree with the map and target capacities of the CPU tests
    (``test_torch_og_replay.py``): a 2^14-slot grid, a 2^12-row target."""
    return dataclasses.replace(p, submap=dataclasses.replace(p.submap, map_capacity=1 << 14, extract_capacity=1 << 12))


def _frame(pts_list, seed):
    rng = np.random.default_rng(seed)
    pts = np.zeros((len(pts_list), CAP, 3), np.float32)
    mask = np.zeros((len(pts_list), CAP), bool)
    inten = np.zeros((len(pts_list), CAP), np.float32)
    for s, p in enumerate(pts_list):
        pts[s, : len(p)], mask[s, : len(p)] = p, True
        inten[s, : len(p)] = rng.uniform(0, 100, len(p))
    return pts, mask, inten


def _drive(jf, tf, frames, t0=0.0, dt=0.1, feed=None):
    for i, (pts, mask, inten) in enumerate(frames):
        if feed is not None:
            feed(i)
        jf.process_batch(JCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask), intensities=jnp.asarray(inten)),
                         timestamps=t0 + dt * i)
        tf.process_batch(PointCloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask),
                                    intensities=torch.from_numpy(inten)), t0 + dt * i)
    jf.flush()
    tf.flush()


def _assert_fleets_agree(jf, tf, frames, truth):
    B = len(frames[0][0])
    for s in range(B):
        assert [(i, rt.value) for i, rt in tf.deferred_results[s]] == \
            [(i, rt.value) for i, rt in jf.deferred_results[s]]
        assert all(rt.value == "success" for _, rt in tf.deferred_results[s])
        for (i, _, T, _), (ji, _, jT, _) in zip(tf.pose_log[s], jf.pose_log[s], strict=True):
            jT = np.asarray(jT)
            assert i == ji
            np.testing.assert_allclose(T[:3, 3], jT[:3, 3], atol=TRANS_M)
            assert np.linalg.norm(lie_np.se3_log(np.linalg.inv(jT) @ T)[:3]) < ROT_RAD
            assert np.linalg.norm(T[:3, 3] - truth[s][i][:3, 3]) < 0.15
    jstate = og_state_from_reference(jf.map_state, device="cpu")
    for s in range(B):
        (jc, jn, jsum), (tc, tn, tsum) = _as_set(jstate, s, "hit_count"), _as_set(tf.map_state, s, "hit_count")
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_allclose(tsum, jsum, rtol=SUM_RTOL, atol=1e-3)

    # the first frame's corrected intensities, point by point
    pts, mask, inten = frames[0]
    jpre = jf._pre_jit(JCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask), intensities=jnp.asarray(inten)),
                       jf._split_keys())
    tpre = tf._t.pc_processor.preprocess_streams(
        PointCloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask), intensities=torch.from_numpy(inten)),
        tf._pre_gens, tf._need_covs)
    for s in range(B):
        kept = [{tuple(np.round(p, 4)): v for p, v, m in zip(np_(c.points[s]), np_(c.intensities[s]), np_(c.mask[s]))
                 if m} for c in (jpre, tpre)]
        common = kept[0].keys() & kept[1].keys()
        assert len(common) >= COMMON_SHARE * max(len(k) for k in kept), (len(common), [len(k) for k in kept])
        got = np.array([kept[1][k] for k in common])
        want = np.array([kept[0][k] for k in common])
        assert 0.0 <= got.min() and got.max() <= 1.0  # the correction's clamp of the default tree
        np.testing.assert_allclose(got, want, rtol=0, atol=INTENSITY_ATOL)


def test_fleet_odometry_at_the_defaults_matches_jax():
    world, trajs = make_world(), stream_trajectories(2, 4)
    frames = [_frame([scan_at(world, trajs[s][i]) for s in range(2)], seed=i) for i in range(4)]
    jp = _small_maps(_every_point(P.LidarOdometryParams()))
    init = np.stack([t[0] for t in trajs])
    jf = JFleet(jp, n_streams=2, initial_poses=init)
    tf = FleetOdometry(params_from_reference(jp), n_streams=2, initial_poses=init, device="cpu")
    assert tf._t.submap.is_occupancy and tf.params.scan.downsampling.polar.enable
    _drive(jf, tf, frames)
    _assert_fleets_agree(jf, tf, frames, trajs)


def test_fleet_lio_at_the_defaults_matches_jax():
    """The default ``scan`` and ``submap`` trees with the LIO test's IMU noise
    densities (the tree's zero densities leave the preintegrated prior
    singular-confident), at frame times that float32 holds exactly: the JAX
    fleet rounds its timestamps to float32, which moves the end of each IMU
    window (at 10.1 s that alone moved a stream 5 mm from the JAX
    single-stream pipeline)."""
    world = lio_world()
    vels = [np.array([2.0, 0.0, 0.0], np.float32), np.array([0.0, 1.5, 0.0], np.float32)]
    starts = [np.zeros(3, np.float32), np.array([0.0, 3.0, 0.0], np.float32)]
    n_frames = 4
    truth = []
    for s in range(2):
        poses = []
        for i in range(n_frames):
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = starts[s] + vels[s] * LIO_DT * i
            poses.append(T)
        truth.append(poses)
    frames = [_frame([lio_scan_at(world, truth[s][i]) for s in range(2)], seed=i) for i in range(n_frames)]
    jp = _small_maps(_every_point(dataclasses.replace(lio_params(), scan=P.ScanParams(), submap=P.SubmapParams())))
    init = np.stack([t[0] for t in truth])
    jf = JFleetLIO(jp, n_streams=2, initial_poses=init)
    tf = FleetLIO(params_from_reference(jp), n_streams=2, initial_poses=init, device="cpu")
    assert tf._t.submap.is_occupancy and tf.params.scan.downsampling.polar.enable
    for t in np.arange(-0.2, LIO_DT * n_frames + 0.01, 1.0 / 200):
        for s in range(2):
            tf.add_imu_measurement(s, TMeas(timestamp=LIO_T0 + float(t), gyro=np.zeros(3, np.float32),
                                            accel=np.array([0, 0, G], np.float32)))
            jf.add_imu_measurement(s, JMeas(timestamp=LIO_T0 + float(t), gyro=np.zeros(3, np.float32),
                                            accel=np.array([0, 0, G], np.float32)))

    def seed_velocity(i):  # the known velocities, set after the first frame as the JAX fleet bench does
        if i == 1:
            v = np.stack(vels)
            jf.x = jf.x._replace(velocity=jnp.asarray(v))
            tf.x = tf.x._replace(velocity=torch.from_numpy(v))

    _drive(jf, tf, frames, t0=LIO_T0, dt=LIO_DT, feed=seed_velocity)
    _assert_fleets_agree(jf, tf, frames, truth)
    np.testing.assert_allclose(tf.gyro_bias_np, np.asarray(jf.gyro_bias_np), atol=2e-4)
    np.testing.assert_allclose(tf.accel_bias_np, np.asarray(jf.accel_bias_np), atol=2e-3)


@pytest.mark.parametrize("lio", [False, True], ids=["FleetOdometry", "FleetLIO"])
def test_fleets_run_at_the_untouched_default_trees(lio):
    """``FleetOdometry(LidarOdometryParams())`` and
    ``FleetLIO(LidarInertialOdometryParams())``, every value at its default
    (the LIO's zero IMU noise densities included), over 2 frames of two
    streams with intensities: the second frame resolves a success in each
    stream, with a finite pose within 0.15 m of the truth, and inserts."""
    world, trajs = make_world(), stream_trajectories(2, 2)
    params = params_from_reference(P.LidarInertialOdometryParams() if lio else P.LidarOdometryParams())
    cls = FleetLIO if lio else FleetOdometry
    fleet = cls(params, n_streams=2, initial_poses=np.stack([t[0] for t in trajs]), device="cpu")
    if lio:
        for t in np.arange(-0.05, 0.21, 1.0 / 200):
            for s in range(2):
                fleet.add_imu_measurement(s, TMeas(timestamp=float(t), gyro=np.zeros(3, np.float32),
                                                   accel=np.array([0, 0, G], np.float32)))
    for i in range(2):
        pts, mask, inten = _frame([scan_at(world, trajs[s][i]) for s in range(2)], seed=i)
        fleet.process_batch(PointCloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask),
                                       intensities=torch.from_numpy(inten)), 0.1 * i)
    fleet.flush()
    for s in range(2):
        assert [rt.value for _, rt in fleet.deferred_results[s]] == ["success"]
        for i, _, T, _ in fleet.pose_log[s]:
            assert np.isfinite(T).all() and np.linalg.norm(T[:3, 3] - trajs[s][i][:3, 3]) < 0.15
    assert (fleet.keyframe_counts == 1).all()
