"""The LiDAR-odometry frame of the port against the JAX package, on the CPU.

  * ``PCProcessor`` stage by stage (prefilter without the random stage, the
    k-NN context, robust covariances, the angle filter) on one synthetic
    scan: points equal to 1e-5, squared neighbour distances to 1e-4, covariances
    within 5e-3 of their largest entry (planar neighbourhoods, see
    ``test_torch_lo_ops.py``), masks equal on all but 0.5% of the points (the
    angle threshold on an eigenvector of float32 noise);
  * ``make_submap_step`` on a keyframe whose cloud fits the sample size, so
    that both sides insert the same points: the maps agree as sets (counts
    exactly, position sums rtol=1e-5, atol=2e-5; log-covariance sums
    rtol=5e-3, atol=1e-3: a planar neighbourhood's smallest eigenvalue is
    1e-5 of its largest, which float32 resolves to 1e-2, and so its
    logarithm), the targets as sets (points 2e-5,
    covariances within 5e-3 of their largest entry), ``stats2`` exactly but
    for the load (1e-6); off a keyframe everything passes through;
  * the slice as a whole: the ``small_params()`` configuration and world of
    ``tests/test_lidar_odometry.py``, 5 frames through both packages'
    ``LidarOdometry``. The sampled sets differ (JAX keys against torch
    generators), so the trajectories are held by bounds: every pose within
    0.1 m / 0.05 rad of the truth (the JAX test's own bound), the two final
    poses within 0.05 m / 0.02 rad of each other;
  * the ``old_timestamp``, ``small_number_of_points`` and ``first_frame``
    results, map growth from 2^10 slots, the MAP prior switched on, the
    branches ported since (the default parameter tree, polar downsampling,
    the occupancy grid, the IMU, the velocity update, the raw range-image
    covariances, the intensity ops, the IMU deskew, the registration
    options) running, and intensity correction against JAX's (rtol 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both, clouds, np_

from sycl_points_tpu.pipeline import fused_submap as j_fused
from sycl_points_tpu.pipeline import lidar_odometry as j_lo
from sycl_points_tpu.pipeline import params as P
from sycl_points_tpu.pipeline.pc_processor import PCProcessor as JPCProcessor
from sycl_points_tpu.pipeline.submap import Submap as JSubmap
from sycl_points_tpu.registration.factors import RegType
from sycl_points_tpu.registration.pipeline import RandomSamplingParams, VelocityUpdateParams
from sycl_points_tpu.registration.registration import RegistrationParams
from sycl_points_tpu.utils import lie_np
from sycl_points_tpu_torch.convert import cloud_from_numpy, params_from_reference
from sycl_points_tpu_torch.mapping import voxel_hash_map as t_vhm
from sycl_points_tpu_torch.ops.knn import BruteForceKNN as TBruteForceKNN
from sycl_points_tpu_torch.pipeline import fused_submap as t_fused
from sycl_points_tpu_torch.pipeline import lidar_odometry as t_lo
from sycl_points_tpu_torch.pipeline import params as TP
from sycl_points_tpu_torch.pipeline.pc_processor import PCProcessor as TPCProcessor
from sycl_points_tpu_torch.pipeline.submap import Submap as TSubmap
from sycl_points_tpu_torch.registration.map_prior import MapPriorParams as TMapPriorParams
from sycl_points_tpu_torch.utils import sync

from test_torch_hash_map import _as_set, _sorted_cloud


def make_world(n=4000):
    """A room: floor, two walls and scattered structure
    (tests/test_lidar_odometry.py)."""
    rng = np.random.default_rng(55 + n)
    per = n // 4
    u = rng.uniform(-8, 8, size=(per, 2)).astype(np.float32)
    floor = np.stack([u[:, 0], u[:, 1], np.full(per, -1.0, np.float32)], 1)
    wall1 = np.stack([np.full(per, 8.0, np.float32), u[:, 0], u[:, 1] * 0.25], 1)
    wall2 = np.stack([u[:, 0], np.full(per, 8.0, np.float32), u[:, 1] * 0.25], 1)
    pillars = rng.uniform(-6, 6, size=(per, 3)).astype(np.float32) * np.array([1, 1, 0.3], np.float32)
    world = np.concatenate([floor, wall1, wall2, pillars])
    world += rng.normal(scale=0.005, size=world.shape).astype(np.float32)
    return world


def scan_at(world, T):
    """The world's points seen from pose T, within 20 m."""
    Tinv = np.linalg.inv(T)
    local = world @ Tinv[:3, :3].T + Tinv[:3, 3]
    return local[np.linalg.norm(local, axis=1) < 20.0].astype(np.float32)


def small_params(**submap_kw):
    submap = dict(map_capacity=1 << 14, extract_capacity=1 << 12)
    submap.update(submap_kw)
    return P.LidarOdometryParams(
        scan=P.ScanParams(
            downsampling=P.DownsamplingParams(
                voxel=P.VoxelDownsamplingParams(enable=True, size=0.4),
                polar=P.PolarDownsamplingParams(enable=False),
                random=P.RandomDownsamplingParams(enable=True, num=1500),
            ),
            preprocess=P.PreprocessParams(
                box_filter=P.BoxFilterParams(enable=True, min=0.5, max=30.0),
                angle_incidence_filter=P.AngleIncidenceFilterParams(enable=False),
            ),
        ),
        submap=P.SubmapParams(
            map_type="VOXEL_HASH_MAP", voxel_size=0.5, point_random_sampling_num=1024,
            keyframe=P.KeyframeParams(inlier_ratio_threshold=0.2, distance_threshold=0.2,
                                      angle_threshold_degrees=5.0, time_threshold_seconds=0.5),
            **submap,
        ),
        covariance_estimation=P.CovarianceEstimationParams(m_estimation=P.MEstimationParams(enable=False)),
        registration=P.RegistrationBlockParams(
            min_num_points=50, factor=RegistrationParams(reg_type=RegType.GICP, max_iterations=15)),
        registration_sampling=RandomSamplingParams(enable=True, num=800),
        scan_capacity=1 << 11,
    )


def trajectory(n):
    """Forward with a gentle turn, 15 cm a frame."""
    poses, T = [], np.eye(4, dtype=np.float32)
    for _ in range(n):
        poses.append(T.copy())
        T = (T @ lie_np.se3_exp(np.array([0.0, 0.0, 0.02, 0.15, 0.02, 0.0]))).astype(np.float32)
    return poses


def pose_gap(A, B):
    """(translation distance, rotation angle in rad) between two poses."""
    d = np.linalg.inv(np.asarray(A, np.float64)) @ np.asarray(B, np.float64)
    return float(np.linalg.norm(np.asarray(A)[:3, 3] - np.asarray(B)[:3, 3])), \
        float(np.linalg.norm(lie_np.se3_log(d)[:3]))


def t_cloud(pts, cap=4096):
    return cloud_from_numpy(pts, capacity=cap, device="cpu")


def _rel_close(b, a, rel):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(a).reshape(len(a), -1).max(1).reshape((-1,) + (1,) * (a.ndim - 1))
    assert (np.abs(b - a) <= rel * np.maximum(scale, 1e-12)).all()


# --------------------------------------------------------------------------
# PCProcessor, stage by stage
# --------------------------------------------------------------------------


def stage_params():
    """The full-width preprocessing (box, 1 m voxels, robust covariances,
    angle filter) with the random stage off, so both sides keep the same
    points."""
    p = small_params()
    return dataclasses.replace(
        p,
        scan=P.ScanParams(
            downsampling=P.DownsamplingParams(
                voxel=P.VoxelDownsamplingParams(enable=True, size=0.4),
                polar=P.PolarDownsamplingParams(enable=False),
                random=P.RandomDownsamplingParams(enable=False),
            )),
        covariance_estimation=P.CovarianceEstimationParams(),
    )


def test_pc_processor_stages():
    params = stage_params()
    pts = scan_at(make_world(), np.eye(4, dtype=np.float32))
    jc, tc = clouds(pts, capacity=4096)
    jpc, tpc = JPCProcessor(params), TPCProcessor(params_from_reference(params), device="cpu")

    jpre, tpre = jpc.prefilter(jc), tpc.prefilter(tc)
    assert tpre.capacity == jpre.capacity == params.scan_capacity
    np.testing.assert_array_equal(np_(tpre.mask), np_(jpre.mask))
    m = np_(jpre.mask)
    np.testing.assert_allclose(np_(tpre.points)[m], np_(jpre.points)[m], atol=1e-5)

    jctx, tctx = jpc.prepare_context(jpre), tpc.prepare_context(tpre)
    np.testing.assert_allclose(np_(tctx.knn.distances)[m], np_(jctx.knn.distances)[m], atol=1e-4)
    assert (np_(tctx.knn.indices)[m] == np_(jctx.knn.indices)[m]).mean() > 0.99  # ties aside

    jcov, tcov = jpc.compute_covariances(jpre, jctx), tpc.compute_covariances(tpre, tctx)
    _rel_close(np_(tcov.covs)[m], np_(jcov.covs)[m], 5e-3)
    assert tpc.compute_covariances(tcov, tctx) is tcov  # covariances present: left alone

    jref, tref = jpc.refine_filter(jcov, jctx), tpc.refine_filter(tcov, tctx)
    jm, tm = np_(jref.mask), np_(tref.mask)
    assert (jm != tm).mean() < 0.005 and 0 < tm.sum() < m.sum()


def test_pc_processor_random_stage_and_capacity():
    """The random stage draws ``num`` of the valid points from the
    processor's generator; two processors repeat each other."""
    params = params_from_reference(small_params())
    cloud = t_cloud(scan_at(make_world(), np.eye(4, dtype=np.float32)))
    a, b = (TPCProcessor(params, device="cpu").prefilter(cloud) for _ in range(2))
    assert a.capacity == 1500 and torch.equal(a.points, b.points)
    no_random = dataclasses.replace(params, scan=dataclasses.replace(params.scan, downsampling=dataclasses.replace(
        params.scan.downsampling, random=TP.RandomDownsamplingParams(enable=False))))
    full = TPCProcessor(no_random, device="cpu").prefilter(cloud)
    assert int(a.count()) == min(1500, int(full.count()))
    kept = set(map(tuple, np_(full.points)[np_(full.mask)].round(4)))
    assert set(map(tuple, np_(a.points)[np_(a.mask)].round(4))) <= kept


# --------------------------------------------------------------------------
# make_submap_step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def submap_pair():
    """Both packages' Submap after the same first frame: a 1024-point cloud,
    which the first-frame sampler (1024 of 1024) passes unchanged."""
    params = dataclasses.replace(
        small_params(),
        scan=dataclasses.replace(stage_params().scan, downsampling=P.DownsamplingParams(
            voxel=P.VoxelDownsamplingParams(enable=True, size=0.4), polar=P.PolarDownsamplingParams(enable=False),
            random=P.RandomDownsamplingParams(enable=False))),
        scan_capacity=1 << 10,
    )
    tparams = params_from_reference(params)
    world, poses = make_world(), trajectory(3)
    jpc, tpc = JPCProcessor(params), TPCProcessor(tparams, device="cpu")

    def pre(T):
        jc, tc = clouds(scan_at(world, T), capacity=4096)
        jc, tc = jpc.prefilter(jc), tpc.prefilter(tc)
        jc = jpc.compute_covariances(jc, jpc.prepare_context(jc))
        # the port's cloud takes JAX's values, so that the step is compared on equal inputs
        return jc, cloud_from_numpy(jc.to_numpy(compacted=False), device="cpu").replace(mask=both(np_(jc.mask))[1])

    jsm, tsm = JSubmap(params), TSubmap(tparams, device="cpu")
    jc0, tc0 = pre(poses[0])
    assert jc0.capacity == 1024
    jsm.add_first_frame(jc0, 0.1, poses[0])
    tsm.add_first_frame(tc0, 0.1, poses[0])
    return params, tparams, jsm, tsm, pre, poses


def _assert_same_map(js, ts):
    a, b = _as_set(js), _as_set(ts)
    for name in ("coords", "count", "last_update"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    np.testing.assert_allclose(b["sum_pos"], a["sum_pos"], rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(b["sum_logcov"], a["sum_logcov"], rtol=5e-3, atol=1e-3)
    for name in ("frame", "dropped", "budget_lost"):
        assert int(getattr(js, name)) == int(getattr(ts, name)), name


def _assert_same_target(jc, tc):
    a, b = _sorted_cloud(jc), _sorted_cloud(tc)
    np.testing.assert_allclose(b["points"], a["points"], atol=2e-5)
    _rel_close(b["covs"], a["covs"], 5e-3)


def test_first_frame_submap(submap_pair):
    _, _, jsm, tsm, _, _ = submap_pair
    _assert_same_map(jsm.map_state, tsm.map_state)
    _assert_same_target(jsm.submap_cloud, tsm.submap_cloud)
    assert tsm.submap_cloud.capacity == tsm.extract_capacity == 1 << 12
    assert tsm.submap_knn.target is not None  # prepared once, with the target
    assert len(tsm.keyframe_poses) == 1 and tsm.last_keyframe_time == 0.1


def test_make_submap_step(submap_pair):
    params, tparams, jsm, tsm, pre, poses = submap_pair
    jstep = jax.jit(j_fused.make_submap_step(params, jsm, False, 10.0))
    tstep = t_fused.make_submap_step(tparams, tsm, 10.0)
    jc, tc = pre(poses[2])
    (jT, tT) = both(poses[2])
    gen = torch.Generator().manual_seed(1)

    # off a keyframe: everything passes through
    jout = jstep(jsm.map_state, jsm.submap_cloud, jc, jT, jnp.bool_(False), jax.random.key(0))
    tout = tstep(tsm.map_state, tsm.submap_cloud, tc, tT, False, gen)
    assert tout[0] is tsm.map_state and tout[1] is tsm.submap_cloud and tout[2] is None
    np.testing.assert_allclose(np_(tout[3]), np_(jout[3]), atol=1e-6)

    # a keyframe whose 1024-point cloud is inserted whole
    jout = jstep(jsm.map_state, jsm.submap_cloud, jc, jT, jnp.bool_(True), jax.random.key(0))
    tout = tstep(tsm.map_state, tsm.submap_cloud, tc, tT, True, gen, knn_prev=tsm.submap_knn)
    _assert_same_map(jout[0], tout[0])
    _assert_same_target(jout[1], tout[1])
    assert tout[2] is tc
    js2, ts2 = np_(jout[3]), np_(tout[3])
    np.testing.assert_allclose(ts2[0], js2[0], atol=1e-6)
    np.testing.assert_array_equal(ts2[1:], js2[1:])
    assert ts2[2] == 1.0 and ts2[5] > 500 and int(tout[0].frame) == 2
    assert int(tsm.map_state.frame) == 1  # the submap's own state is untouched


def test_submap_step_weighted_branch(submap_pair):
    """A cloud larger than the sample size goes through the robust weights
    and the mixed sampler: ``num`` points, each from the cloud."""
    _, tparams, _, tsm, pre, poses = submap_pair
    tparams = dataclasses.replace(tparams, submap=dataclasses.replace(tparams.submap, point_random_sampling_num=256))
    step = t_fused.make_submap_step(tparams, tsm)
    _, tc = pre(poses[1])
    sync.reset_sync_count()
    new_state, target, sampled, stats2 = step(
        tsm.map_state, tsm.submap_cloud, tc, both(poses[1])[1], True, torch.Generator().manual_seed(2))
    assert sampled.capacity == 256 and int(sampled.count()) == 256
    assert set(map(tuple, np_(sampled.points))) <= set(map(tuple, np_(tc.points)[np_(tc.mask)]))
    assert int(new_state.frame) == 2 and target.covs is not None and float(stats2[2]) == 1.0
    # the count of the cloud, the table's probe loops, the extract's overflow branch
    assert 0 < sync.counts["host_syncs"] <= 8


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def replay():
    """5 frames through the JAX LidarOdometry and the port's."""
    world, poses = make_world(), trajectory(5)
    params = small_params()
    jlo = j_lo.LidarOdometry(params)
    tlo = t_lo.LidarOdometry(params_from_reference(params), device="cpu")
    rows = []
    for i, T in enumerate(poses):
        pts = scan_at(world, T)
        jc, tc = clouds(pts, capacity=4096)
        jr, tr = jlo.process(jc, 0.1 * (i + 1)), tlo.process(tc, 0.1 * (i + 1))
        rows.append(dict(jr=jr, tr=tr, j=jlo.get_odometry(), t=tlo.get_odometry(), truth=T,
                         syncs=tlo.sync_count_last_frame, times=tlo.get_processing_times(),
                         kf=tlo.is_keyframe_last_frame))
    return jlo, tlo, rows


def test_replay_result_types(replay):
    _, _, rows = replay
    assert rows[0]["tr"] is t_lo.ResultType.first_frame and rows[0]["jr"] is j_lo.ResultType.first_frame
    for r in rows[1:]:
        assert r["tr"] is t_lo.ResultType.success and r["jr"] is j_lo.ResultType.success
    assert [m.name for m in t_lo.ResultType] == [m.name for m in j_lo.ResultType]


@pytest.mark.parametrize("frame", range(5))
def test_replay_tracks_the_truth(replay, frame):
    r = replay[2][frame]
    for side in ("j", "t"):
        trans, rot = pose_gap(r[side], r["truth"])
        assert trans < 0.1 and rot < 0.05, (side, trans, rot)


def test_replay_final_poses_agree(replay):
    r = replay[2][-1]
    trans, rot = pose_gap(r["t"], r["j"])
    assert trans < 0.05 and rot < 0.02, (trans, rot)


def test_replay_state(replay):
    jlo, tlo, rows = replay
    assert tlo.frame_count == jlo.frame_count == 4 and tlo.registrated
    assert len(tlo.get_keyframe_poses()) == len(jlo.get_keyframe_poses()) >= 2
    assert sum(r["kf"] for r in rows) == len(tlo.get_keyframe_poses()) - 1
    assert int(tlo.submap.map_state.frame) == int(jlo.submap.map_state.frame)
    assert abs(int(t_vhm.voxel_count(tlo.submap.map_state)) - int(jlo.submap.map_state.used.sum())) < 100
    assert int(tlo.submap.map_state.dropped) == 0 and tlo.submap.budget_lost == 0
    np.testing.assert_allclose(tlo.linear_velocity, jlo.linear_velocity, atol=0.3)
    assert tlo.precompile_growth(1 << 20) == 0
    # every frame's stages are timed; a keyframe waits on the host more often
    for r in rows[1:]:
        assert {"1. preprocessing", "3. registration", "4a. submap dispatch", "4b. stats fetch",
                "4. build submap"} <= set(r["times"])
        assert 2 < r["syncs"] <= 40
    kf_syncs = [r["syncs"] for r in rows[1:] if r["kf"]]
    other = [r["syncs"] for r in rows[1:] if not r["kf"]]
    assert not other or min(kf_syncs) > min(other)
    # the target's search structure was prepared with the target, not per frame
    assert tlo.submap.submap_knn.target is not None
    assert tlo.submap.submap_knn.points is tlo.submap.submap_cloud.points


def test_non_keyframe_leaves_the_keyframe_state(replay):
    """A frame 1 mm on is no keyframe: the map, the target and the keyframe
    bookkeeping stay; the odometry moves."""
    _, tlo, rows = replay
    sm = tlo.submap
    before = (sm.map_state, sm.submap_cloud, sm.submap_knn, sm.last_keyframe_pose.copy(), sm.last_keyframe_time,
              len(sm.keyframe_poses))
    if rows[-1]["kf"]:
        T = rows[-1]["truth"].copy()
        T[0, 3] += 1e-3
        res = tlo.process(t_cloud(scan_at(make_world(), T)), 0.1 * len(rows) + 0.05)
        assert res is t_lo.ResultType.success and not tlo.is_keyframe_last_frame
        assert sm.map_state is before[0] and sm.submap_cloud is before[1] and sm.submap_knn is before[2]
        np.testing.assert_array_equal(sm.last_keyframe_pose, before[3])
        assert sm.last_keyframe_time == before[4] and len(sm.keyframe_poses) == before[5]
        assert pose_gap(tlo.get_odometry(), T)[0] < 0.1


def _lo(**kw):
    return t_lo.LidarOdometry(params_from_reference(small_params(**kw)), device="cpu")


def test_old_timestamp_rejected():
    lo = _lo()
    c = t_cloud(scan_at(make_world(), np.eye(4, dtype=np.float32)))
    assert lo.process(c, 1.0) is t_lo.ResultType.first_frame
    odom = lo.get_odometry()
    assert lo.process(c, 0.95) is t_lo.ResultType.old_timestamp and lo.error_message == "old timestamp"
    assert lo.process(c, 1.0) is t_lo.ResultType.old_timestamp
    np.testing.assert_array_equal(lo.get_odometry(), odom)


def test_small_cloud_rejected():
    """Too few points on the first frame, and on a later one, where the
    odometry must not move."""
    lo = _lo()
    tiny = t_cloud(np.random.default_rng(0).uniform(1, 2, size=(20, 3)).astype(np.float32), cap=64)
    assert lo.process(tiny, 0.1) is t_lo.ResultType.small_number_of_points and lo.is_first_frame
    assert lo.error_message == "point cloud size is too small"
    full = t_cloud(scan_at(make_world(), np.eye(4, dtype=np.float32)))
    assert lo.process(full, 0.2) is t_lo.ResultType.first_frame
    assert lo.process(full, 0.3) is t_lo.ResultType.success
    odom, frames = lo.get_odometry(), lo.frame_count
    assert lo.process(tiny, 0.4) is t_lo.ResultType.small_number_of_points
    np.testing.assert_array_equal(lo.get_odometry(), odom)
    assert lo.frame_count == frames and lo.last_frame_time == pytest.approx(0.3)


def test_map_growth_from_a_small_table():
    """2^10 slots and as many target rows: the map doubles past a load of
    0.7, the extract tier follows, nothing is dropped and the pose holds.
    (A first-frame target much smaller than the scan's voxel count is cut to
    the nearest voxels until the next frame's overflow backstop, in both
    packages; that case is not this test's.)"""
    lo = _lo(map_capacity=1 << 10, extract_capacity=1 << 10)
    world, poses = make_world(), trajectory(5)
    caps = []
    for i, T in enumerate(poses):
        res = lo.process(t_cloud(scan_at(world, T)), 0.1 * (i + 1))
        assert res is (t_lo.ResultType.first_frame if i == 0 else t_lo.ResultType.success)
        caps.append((lo.submap.map_capacity, lo.submap.extract_capacity))
        assert lo.submap.submap_cloud.capacity == lo.submap.extract_capacity
        assert lo.submap.map_state.used.shape[0] == lo.submap.map_capacity
    assert caps[-1][0] > 1 << 10 and caps[-1][1] > 1 << 10 and caps == sorted(caps)
    assert int(lo.submap.map_state.dropped) == 0 and lo.submap.extract_overflow == 0
    assert float(t_vhm.load_factor(lo.submap.map_state, lo.submap.map_config)) <= 0.7
    trans, rot = pose_gap(lo.get_odometry(), poses[-1])
    assert trans < 0.1 and rot < 0.05


def test_retry_insert_after_drop_loses_nothing():
    """A table too small for one keyframe at 4 probes drops contributions;
    the retry grows it until the same insert fits."""
    params = params_from_reference(small_params(map_capacity=1 << 8, extract_capacity=1 << 8))
    sm = TSubmap(params, device="cpu")
    sm.vhm_config = dataclasses.replace(sm.vhm_config, max_probes=4)
    cloud = TPCProcessor(params, device="cpu").prefilter(t_cloud(scan_at(make_world(), np.eye(4, dtype=np.float32))))
    sampled = dataclasses.replace(cloud, points=cloud.points[:1024], mask=cloud.mask[:1024])
    pose = torch.eye(4)
    before = sm.map_state
    tried, _, _, _ = sm.insert_extract(before, sampled, pose)
    assert int(tried.dropped) > 0 and int(before.dropped) == 0
    sm.retry_insert_after_drop(sampled, np.eye(4, dtype=np.float32))
    assert int(sm.map_state.dropped) == 0 and sm.map_capacity > 1 << 8
    voxels = len(np.unique(np.floor(np_(sampled.points)[np_(sampled.mask)] / 0.5), axis=0))
    assert int(t_vhm.voxel_count(sm.map_state)) == voxels
    assert float(sm.map_state.count.sum()) == float(sampled.mask.sum())
    assert sm.submap_cloud is not None and sm.submap_cloud.capacity == sm.extract_capacity


def test_add_frame_keyframe_policy():
    """The host-side keyframe path: the inlier gate, then distance, angle or
    time since the last keyframe."""
    params = params_from_reference(small_params())
    sm = TSubmap(params, device="cpu")
    pc = TPCProcessor(params, device="cpu")
    world, poses = make_world(), trajectory(3)

    def pre(T):
        c = pc.prefilter(t_cloud(scan_at(world, T)))
        return pc.compute_covariances(c, pc.prepare_context(c))

    sm.add_first_frame(pre(poses[0]), 0.1, poses[0])
    cloud = pre(poses[1])
    assert not sm.add_frame(cloud, poses[1], 0.1, 0.2)  # inlier ratio at or below 0.2
    assert not sm.add_frame(cloud, poses[1], 0.9, 0.2)  # 15 cm, 1 deg, 0.1 s: no keyframe
    assert len(sm.keyframe_poses) == 1 and int(sm.map_state.frame) == 1
    assert sm._is_keyframe(poses[2], 0.2) and sm._is_keyframe(poses[1], 0.7)  # 30 cm; 0.6 s
    turned = poses[0] @ lie_np.se3_exp(np.array([0.0, 0.0, 0.1, 0.0, 0.0, 0.0]))
    assert sm._is_keyframe(turned, 0.2)  # 5.7 deg
    weights = torch.rand(cloud.capacity, generator=torch.Generator().manual_seed(0))
    assert sm.add_frame(cloud, poses[2], 0.9, 0.3, sampling_weights=weights)
    assert len(sm.keyframe_poses) == 2 and sm.last_keyframe_time == 0.3 and int(sm.map_state.frame) == 2
    np.testing.assert_array_equal(sm.last_keyframe_pose, poses[2])
    assert int(sm.last_keyframe_cloud.count()) == 1024 and sm.submap_cloud.covs is not None


def test_map_prior_on():
    lo = t_lo.LidarOdometry(params_from_reference(small_params()), TMapPriorParams(enabled=True), device="cpu")
    world, poses = make_world(), trajectory(4)
    for i, T in enumerate(poses):
        lo.process(t_cloud(scan_at(world, T)), 0.1 * (i + 1))
    trans, rot = pose_gap(lo.get_odometry(), poses[-1])
    assert trans < 0.1 and rot < 0.05


# --------------------------------------------------------------------------
# what is not ported yet, and what was ported since
# --------------------------------------------------------------------------


def _tp(**kw):
    return dataclasses.replace(params_from_reference(small_params()), **kw)


def _timestamped(T=np.eye(4, dtype=np.float32)):
    pts = scan_at(make_world(), T)
    return cloud_from_numpy({"points": pts, "timestamp_offsets": np.linspace(0, 100, len(pts), dtype=np.float32)},
                            capacity=4096, device="cpu")


def _run_imu_branch():
    """LidarOdometry with the IMU on: two frames with a level, still IMU."""
    from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement

    lo = t_lo.LidarOdometry(_tp(imu=TP.IMUParams(enable=True)), device="cpu")
    for t in np.arange(0.0, 0.25, 0.005):
        lo.add_imu_measurement(IMUMeasurement(float(t), np.zeros(3, np.float32),
                                              np.array([0, 0, 9.80665], np.float32)))
    results = [lo.process(t_cloud(scan_at(make_world(), np.eye(4, dtype=np.float32))), t) for t in (0.1, 0.2)]
    return results == [t_lo.ResultType.first_frame, t_lo.ResultType.success] and lo.imu_window_complete


def _run_velocity_update():
    """LidarOdometry with VICP: two timestamped frames; the published cloud
    is deskewed."""
    lo = t_lo.LidarOdometry(_tp(lo_velocity_update=params_from_reference(VelocityUpdateParams(enable=True))),
                            device="cpu")
    results = [lo.process(_timestamped(), t) for t in (0.1, 0.2)]
    return results == [t_lo.ResultType.first_frame, t_lo.ResultType.success] and \
        lo.preprocessed.timestamp_offsets is not None


def _run_imu_deskew():
    """PCProcessor.deskew_with_imu: a timestamped scan and a still IMU."""
    from sycl_points_tpu_torch.deskew.imu_deskew import IMUDeskewStatus
    from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement

    imu = [IMUMeasurement(float(t), np.zeros(3, np.float32), np.array([0, 0, 9.80665], np.float32))
           for t in np.arange(-0.05, 0.16, 0.0025)]
    cloud = _timestamped()
    out, status = TPCProcessor(_tp(), device="cpu").deskew_with_imu(cloud, imu, np.eye(4), 0.0, 0.1)
    # standing still, the IMU sees gravity alone: the deskew moves nothing
    return status is IMUDeskewStatus.success and bool(torch.allclose(out.points, cloud.points, atol=1e-4))


def _run_default_params():
    """LidarOdometry at the parameter tree's defaults: the first frame goes
    through the polar grid into the occupancy grid."""
    lo = t_lo.LidarOdometry(TP.LidarOdometryParams(), device="cpu")
    pts = scan_at(make_world(), np.eye(4, dtype=np.float32))
    ok = lo.process(t_cloud(pts), 0.1) is t_lo.ResultType.first_frame
    return ok and lo.submap.is_occupancy and 0 < int(lo.preprocessed.count()) < len(pts)


def _run_polar():
    """PCProcessor's prefilter at its defaults (box, polar grid, random
    stage) keeps one point a polar bin, at the random stage's capacity."""
    pts = scan_at(make_world(), np.eye(4, dtype=np.float32))
    out = TPCProcessor(TP.CommonParameters(), device="cpu").prefilter(t_cloud(pts, cap=1 << 14))
    return out.capacity == TP.RandomDownsamplingParams().num and 0 < int(out.count()) < len(pts)


def _run_occupancy():
    """The default Submap is the occupancy grid: an insert carves free space
    and extracts the hit voxels."""
    sm = TSubmap(TP.CommonParameters(), device="cpu")
    pts = scan_at(make_world(), np.eye(4, dtype=np.float32))
    state, extracted, load, overflow = sm.insert_extract(sm.map_state, t_cloud(pts), torch.eye(4))
    lo = state.log_odds[state.used]
    return sm.is_occupancy and bool((lo < 0).any() and (lo > 0).any()) and int(extracted.count()) > 100 \
        and int(overflow) == 0 and 0 < float(load) < 0.7


def _run_registration_option(option):
    """LidarOdometry with one registration option on: two frames 0.2 m
    apart, the second a success within 0.1 m of the truth (the bound of the
    frame tests above; with the intensity-weighted draw on these random
    intensities the port lands 6.3 cm off and JAX 9.8 cm)."""
    from sycl_points_tpu_torch.registration.degenerate import DegenerateRegularizationParams
    from sycl_points_tpu_torch.registration.registration import RotationConstraintParams

    base = _tp()
    factor = base.registration.factor
    changes = {
        "rotation-constraint": dict(factor=dataclasses.replace(
            factor, rotation_constraint=RotationConstraintParams(enable=True, weight=0.5))),
        "nl-reg": dict(factor=dataclasses.replace(factor, degenerate_reg=DegenerateRegularizationParams(type="nl_reg"))),
        "coarse-to-fine": dict(factor=dataclasses.replace(factor, coarse_to_fine_iters=4, max_iterations=20)),
        "intensity-sampling": {},
    }[option]
    params = dataclasses.replace(base, registration=dataclasses.replace(base.registration, **changes))
    if option == "intensity-sampling":
        params = dataclasses.replace(params, registration_sampling=dataclasses.replace(
            params.registration_sampling, use_intensities=True))
    lo = t_lo.LidarOdometry(params, device="cpu")
    poses = [np.eye(4, dtype=np.float32), lie_np.se3_exp(np.array([0, 0, 0.02, 0.2, 0, 0])).astype(np.float32)]
    results = []
    for i, T in enumerate(poses):
        pts = scan_at(make_world(), T)
        inten = np.random.default_rng(i).uniform(0.1, 1.0, len(pts)).astype(np.float32)
        results.append(lo.process(cloud_from_numpy({"points": pts, "intensities": inten}, capacity=4096,
                                                   device="cpu"), 0.1 * (i + 1)))
    trans, _ = pose_gap(lo.get_odometry(), poses[-1])
    coarse_ok = lo.reg_result.coarse_iterations == (4 if option == "coarse-to-fine" else 0)
    return results == [t_lo.ResultType.first_frame, t_lo.ResultType.success] and trans < 0.1 and coarse_ok


def _run_intensity_ops():
    """The Gaussian smoothing and the local-mean normalization run on the
    k-NN context."""
    params = _tp(scan=dataclasses.replace(
        _tp().scan, intensity_gaussian=TP.IntensityGaussianParams(enable=True),
        intensity_local_mean_norm=TP.IntensityLocalMeanNormParams(enable=True)))
    pts = scan_at(make_world(), np.eye(4, dtype=np.float32))
    inten = np.random.default_rng(0).uniform(0, 100, len(pts)).astype(np.float32)
    pc = TPCProcessor(params, device="cpu")
    pre = pc.prefilter(cloud_from_numpy({"points": pts, "intensities": inten}, capacity=4096, device="cpu"))
    ctx = pc.prepare_context(pre)
    out = pc.refine_filter(pc.compute_covariances(pre, ctx), ctx)
    return ctx.knn is not None and not torch.allclose(out.intensities, pre.intensities)


def _run_raw_range_image():
    """LidarOdometry with the raw-features covariances: two frames 0.2 m
    apart, the second a success within 0.1 m of the truth (the bound of the
    frame tests above), every scan's covariances from its range image and no
    k-NN context."""
    lo = t_lo.LidarOdometry(_tp(covariance_estimation=TP.CovarianceEstimationParams(raw_range_image=True)),
                            device="cpu")
    poses = [np.eye(4, dtype=np.float32), lie_np.se3_exp(np.array([0, 0, 0.02, 0.2, 0, 0])).astype(np.float32)]
    results = [lo.process(t_cloud(scan_at(make_world(), T)), 0.1 * (i + 1)) for i, T in enumerate(poses)]
    trans, _ = pose_gap(lo.get_odometry(), poses[-1])
    ctx = lo.pc_processor.prepare_context(lo.preprocessed)
    return results == [t_lo.ResultType.first_frame, t_lo.ResultType.success] and trans < 0.1 and ctx.knn is None


REGISTRATION_OPTIONS = ("rotation-constraint", "nl-reg", "coarse-to-fine", "intensity-sampling")


@pytest.mark.parametrize("make,message", [
    (_run_default_params, None),
    (_run_polar, None),
    (_run_occupancy, None),
    (_run_imu_branch, None),
    (_run_velocity_update, None),
    (_run_raw_range_image, None),
    (_run_intensity_ops, None),
    (_run_imu_deskew, None),
    *((lambda option=option: _run_registration_option(option), None) for option in REGISTRATION_OPTIONS),
], ids=["default-params", "polar", "occupancy", "imu", "velocity-update", "raw-range-image", "intensity-ops",
        "imu-deskew", *REGISTRATION_OPTIONS])
def test_not_ported_yet(make, message):
    """What is not ported raises by its message; the branches ported since
    (the default parameter tree, polar downsampling, the occupancy grid, the
    IMU, the velocity update, the raw range-image covariances, the intensity
    ops, the IMU deskew, the registration options) run."""
    if message is None:
        assert make()
        return
    with pytest.raises(NotImplementedError, match=message):
        make()


def test_intensity_correction_of_a_cloud_with_intensities_raises():
    """Intensity correction, on by default, corrects a cloud that carries
    intensities as the JAX package does (rtol 1e-5); switched off, it leaves
    them."""
    pts = scan_at(make_world(), np.eye(4, dtype=np.float32))
    inten = np.random.default_rng(1).uniform(0, 1000, len(pts)).astype(np.float32)
    jc, _ = clouds(pts, capacity=4096, intensities=inten)
    jpc = JPCProcessor(small_params())
    jpre = jpc.prefilter(jc)
    jctx = jpc.prepare_context(jpre)
    jcov = jpc.compute_covariances(jpre, jctx)
    jout = jpc.refine_filter(jcov, jctx)
    tin = cloud_from_numpy(jcov.to_numpy(compacted=False), capacity=jcov.capacity,
                           device="cpu").replace(mask=both(np_(jcov.mask))[1])
    pc = TPCProcessor(_tp(), device="cpu")
    tout = pc.refine_filter(tin, None)
    m = np_(jout.mask)
    np.testing.assert_allclose(np_(tout.intensities)[m], np_(jout.intensities)[m], rtol=1e-5)
    assert not np.allclose(np_(tout.intensities)[m], np_(tin.intensities)[m])
    off = _tp(scan=dataclasses.replace(_tp().scan, intensity_correction=TP.IntensityCorrectionParams(enable=False)))
    assert torch.equal(TPCProcessor(off, device="cpu").refine_filter(tin, None).intensities, tin.intensities)


def test_unknown_map_type_raises():
    with pytest.raises(ValueError, match="unknown map_type"):
        TSubmap(_tp(submap=TP.SubmapParams(map_type="KD_TREE")), device="cpu")
