"""The odometry frames at the parameter tree's defaults (polar downsampling,
the occupancy-grid submap, the intensity ops) against the JAX package, on
the CPU. The world and the motion are those of ``test_torch_lo_frame.py``
(LO) and ``test_torch_lio_frame.py`` (LIO).

  * ``PCProcessor`` stage by stage with the polar grid and intensities: the
    prefilter's points to 1e-5 and its intensity medians to rtol 1e-5, the
    k-NN context and the covariances as in ``test_torch_lo_frame.py``, and
    the refine filter (angle filter, intensity correction, Gaussian
    smoothing, local-mean normalization) fed the JAX stage's inputs:
    intensities rtol 1e-5 / atol 1e-6, masks equal on all but 0.5%;
  * ``Submap`` on the occupancy grid: the first frame, then
    ``make_submap_step`` on a frame that fits the sample size, so that both
    sides insert the same points: maps as sets (the tolerances of
    ``test_torch_occupancy_grid.py``), targets as sets (points 2e-5,
    covariances within 5e-3 of their largest entry), ``stats2`` exactly but
    for the load (1e-6); ``add_frame`` inserts every frame that passes the
    inlier gate and keeps no keyframe bookkeeping;
  * the slice as a whole: the default tree scaled to the CPU as
    ``small_params()`` scales the LO tree (:func:`og_params`), 5 frames
    through both packages' ``LidarOdometry``: every pose within the JAX
    test's 0.1 m / 0.05 rad of the truth, the final poses within 0.05 m /
    0.02 rad of each other. The same run with every random stage off: final
    poses within 2 mm / 0.01 deg, map sizes within 1%
    (``test_torch_og_replay.py``, with the LIO frame at the default trees);
  * the replay app's scans with intensities at the default tree: the
    correction gives the seeded reflectivity back, and ``Submap`` answers
    the backend policy (``inserts_every_frame``, ``occupied_voxels``).
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
from sycl_points_tpu.registration.pipeline import RandomSamplingParams
from sycl_points_tpu.registration.registration import RegistrationParams
from sycl_points_tpu_torch.convert import cloud_from_numpy, params_from_reference
from sycl_points_tpu_torch.mapping import occupancy_grid as t_og
from sycl_points_tpu_torch.ops.knn import KNNResult as TKNN
from sycl_points_tpu_torch.pipeline import fused_submap as t_fused
from sycl_points_tpu_torch.pipeline import lidar_odometry as t_lo
from sycl_points_tpu_torch.pipeline.pc_processor import PCProcessor as TPCProcessor
from sycl_points_tpu_torch.pipeline.submap import Submap as TSubmap

from test_torch_lo_frame import _assert_same_target, _rel_close, make_world, pose_gap, scan_at, trajectory
from test_torch_occupancy_grid import _assert_same_map

SCAN_CAP = 1 << 11


def og_params(every_point: bool = False, scan_capacity: int = SCAN_CAP, **scan_kw):
    """The default tree (polar grid, occupancy-grid submap, intensity
    correction) scaled to the CPU as ``small_params()`` scales the LO tree:
    the box filter, the random stage, the submap's voxel, sample and
    capacities, plain covariances, GICP at most 15 iterations on 800
    points. ``every_point`` turns every random stage off."""
    scan = P.ScanParams(
        downsampling=P.DownsamplingParams(random=P.RandomDownsamplingParams(enable=not every_point, num=1500)),
        preprocess=P.PreprocessParams(box_filter=P.BoxFilterParams(enable=True, min=0.5, max=30.0),
                                      angle_incidence_filter=P.AngleIncidenceFilterParams(enable=False)))
    return P.LidarOdometryParams(
        scan=dataclasses.replace(scan, **scan_kw),
        submap=P.SubmapParams(voxel_size=0.5, point_random_sampling_num=scan_capacity if every_point else 1024,
                              map_capacity=1 << 14, extract_capacity=1 << 12),
        covariance_estimation=P.CovarianceEstimationParams(m_estimation=P.MEstimationParams(enable=False)),
        registration=P.RegistrationBlockParams(
            min_num_points=50, factor=RegistrationParams(reg_type=RegType.GICP, max_iterations=15)),
        registration_sampling=RandomSamplingParams(enable=not every_point, num=800),
        scan_capacity=scan_capacity,
    )


def with_intensities(pts, seed=0, capacity=4096):
    inten = np.random.default_rng(seed).uniform(0, 100, len(pts)).astype(np.float32)
    return clouds(pts, capacity=capacity, intensities=inten)


# --------------------------------------------------------------------------
# PCProcessor with the polar grid and intensities
# --------------------------------------------------------------------------


def test_pc_processor_stages():
    params = og_params(
        every_point=True,
        preprocess=P.PreprocessParams(box_filter=P.BoxFilterParams(enable=True, min=0.5, max=30.0)),
        intensity_gaussian=P.IntensityGaussianParams(enable=True, neighbor_num=8),
        intensity_local_mean_norm=P.IntensityLocalMeanNormParams(enable=True, sigma_range=0.3),
    )
    jc, tc = with_intensities(scan_at(make_world(), np.eye(4, dtype=np.float32)))
    jpc, tpc = JPCProcessor(params), TPCProcessor(params_from_reference(params), device="cpu")

    jpre, tpre = jpc.prefilter(jc), tpc.prefilter(tc)
    assert tpre.capacity == jpre.capacity == SCAN_CAP
    m = np_(jpre.mask)
    np.testing.assert_array_equal(np_(tpre.mask), m)
    assert 500 < m.sum() < len(np_(jc.mask).nonzero()[0])
    np.testing.assert_allclose(np_(tpre.points)[m], np_(jpre.points)[m], atol=1e-5)
    np.testing.assert_allclose(np_(tpre.intensities)[m], np_(jpre.intensities)[m], rtol=1e-5)

    jctx, tctx = jpc.prepare_context(jpre), tpc.prepare_context(tpre)
    np.testing.assert_allclose(np_(tctx.knn.distances)[m], np_(jctx.knn.distances)[m], atol=1e-4)
    assert (np_(tctx.knn.indices)[m] == np_(jctx.knn.indices)[m]).mean() > 0.99  # ties aside
    jcov, tcov = jpc.compute_covariances(jpre, jctx), tpc.compute_covariances(tpre, tctx)
    _rel_close(np_(tcov.covs)[m], np_(jcov.covs)[m], 5e-3)
    # covariances present, but the smoothing needs neighbours: the context stays
    assert tpc.prepare_context(tcov).knn is not None

    # the refine filter on the JAX stage's inputs
    tin = cloud_from_numpy(jcov.to_numpy(compacted=False), device="cpu").replace(mask=both(m)[1])
    tknn = TKNN(*(torch.from_numpy(np.array(a)) for a in jctx.knn))
    jref, tref = jpc.refine_filter(jcov, jctx), tpc.refine_filter(tin, tctx._replace(knn=tknn))
    jm, tm = np_(jref.mask), np_(tref.mask)
    assert (jm != tm).mean() < 0.005 and 0 < tm.sum() < m.sum()
    both_m = jm & tm
    np.testing.assert_allclose(np_(tref.intensities)[both_m], np_(jref.intensities)[both_m], rtol=1e-5, atol=1e-6)
    assert not np.allclose(np_(tref.intensities)[both_m], np_(tin.intensities)[both_m])


def test_polar_stage_writes_into_the_scan_capacity():
    """Polar alone writes its bins straight into the scan capacity; with the
    voxel stage after it, the voxel stage does."""
    tc = with_intensities(scan_at(make_world(), np.eye(4, dtype=np.float32)))[1]
    tp = params_from_reference(og_params(every_point=True))
    polar = TPCProcessor(tp, device="cpu").prefilter(tc)
    assert polar.capacity == SCAN_CAP
    both_grids = dataclasses.replace(tp, scan=dataclasses.replace(tp.scan, downsampling=dataclasses.replace(
        tp.scan.downsampling, voxel=dataclasses.replace(tp.scan.downsampling.voxel, enable=True, size=2.0))))
    out = TPCProcessor(both_grids, device="cpu").prefilter(tc)
    assert out.capacity == SCAN_CAP and 0 < int(out.count()) < int(polar.count())


# --------------------------------------------------------------------------
# Submap on the occupancy grid
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def submap_pair():
    """Both packages' occupancy-grid Submap after the same first frame: a
    1024-point cloud, which the sampler passes unchanged."""
    params = og_params(every_point=True, scan_capacity=1 << 10)
    tparams = params_from_reference(params)
    world, poses = make_world(), trajectory(3)
    jpc = JPCProcessor(params)

    def pre(T):
        jc, _ = with_intensities(scan_at(world, T))
        jc = jpc.prefilter(jc)
        jc = jpc.compute_covariances(jc, jpc.prepare_context(jc))
        # the port's cloud takes JAX's values, so that the step is compared on equal inputs
        return jc, cloud_from_numpy(jc.to_numpy(compacted=False), device="cpu").replace(mask=both(np_(jc.mask))[1])

    jsm, tsm = JSubmap(params), TSubmap(tparams, device="cpu")
    jc0, tc0 = pre(poses[0])
    assert jc0.capacity == 1024 and tsm.is_occupancy and tsm.map_module is t_og
    jsm.add_first_frame(jc0, 0.1, poses[0])
    tsm.add_first_frame(tc0, 0.1, poses[0])
    return params, tparams, jsm, tsm, pre, poses


def test_first_frame_submap(submap_pair):
    _, _, jsm, tsm, _, _ = submap_pair
    _assert_same_map(jsm.map_state, tsm.map_state)
    _assert_same_target(jsm.submap_cloud, tsm.submap_cloud)
    assert tsm.og_config == params_from_reference(jsm.og_config)
    assert tsm.og_config.log_odds_hit == 0.8 and tsm.og_config.max_ray_distance == 50.0
    assert tsm.submap_cloud.capacity == tsm.extract_capacity == 1 << 12
    assert tsm.submap_knn.target is not None


def test_make_submap_step(submap_pair):
    params, tparams, jsm, tsm, pre, poses = submap_pair
    jstep = jax.jit(j_fused.make_submap_step(params, jsm, False, 10.0))
    tstep = t_fused.make_submap_step(tparams, tsm, 10.0)
    jc, tc = pre(poses[2])
    (jT, tT) = both(poses[2])
    gen = torch.Generator().manual_seed(1)

    jout = jstep(jsm.map_state, jsm.submap_cloud, jc, jT, jnp.bool_(False), jax.random.key(0))
    tout = tstep(tsm.map_state, tsm.submap_cloud, tc, tT, False, gen)
    assert tout[0] is tsm.map_state and tout[1] is tsm.submap_cloud and tout[2] is None
    np.testing.assert_allclose(np_(tout[3]), np_(jout[3]), atol=1e-6)

    jout = jstep(jsm.map_state, jsm.submap_cloud, jc, jT, jnp.bool_(True), jax.random.key(0))
    tout = tstep(tsm.map_state, tsm.submap_cloud, tc, tT, True, gen, knn_prev=tsm.submap_knn)
    _assert_same_map(jout[0], tout[0])
    _assert_same_target(jout[1], tout[1])
    js2, ts2 = np_(jout[3]), np_(tout[3])
    np.testing.assert_allclose(ts2[0], js2[0], atol=1e-6)
    np.testing.assert_array_equal(ts2[1:], js2[1:])
    assert ts2[2] == 1.0 and ts2[5] > 300 and int(tout[0].frame) == 2


def test_add_frame_inserts_every_frame_past_the_gate(submap_pair):
    _, tparams, _, _, pre, poses = submap_pair
    tsm = TSubmap(tparams, device="cpu")
    _, tc = pre(poses[0])
    tsm.add_first_frame(tc, 0.1, poses[0])
    # 1 mm on, 0.05 s later: no keyframe by distance, angle or time; inserted all the same
    T = poses[0].copy()
    T[0, 3] += 1e-3
    assert tsm.add_frame(tc, T, 0.9, 0.15)
    assert int(tsm.map_state.frame) == 2 and len(tsm.keyframe_poses) == 1 and tsm.last_keyframe_time == 0.1
    assert not tsm.add_frame(tc, T, 0.1, 0.2)  # below the inlier gate
    assert int(tsm.map_state.frame) == 2


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------


def _replay(params, n=5):
    world, poses = make_world(), trajectory(n)
    jlo = j_lo.LidarOdometry(params)
    tlo = t_lo.LidarOdometry(params_from_reference(params), device="cpu")
    rows = []
    for i, T in enumerate(poses):
        jc, tc = with_intensities(scan_at(world, T), seed=i)
        jr, tr = jlo.process(jc, 0.1 * (i + 1)), tlo.process(tc, 0.1 * (i + 1))
        rows.append(dict(jr=jr, tr=tr, j=jlo.get_odometry(), t=tlo.get_odometry(), truth=T,
                         syncs=tlo.sync_count_last_frame, kf=tlo.is_keyframe_last_frame,
                         voxels=(int(jlo.submap.map_state.used.sum()), int(t_og.voxel_count(tlo.submap.map_state)))))
    return jlo, tlo, rows


@pytest.fixture(scope="module")
def replay():
    return _replay(og_params())


def test_replay_result_types(replay):
    _, _, rows = replay
    assert rows[0]["tr"] is t_lo.ResultType.first_frame and rows[0]["jr"] is j_lo.ResultType.first_frame
    for r in rows[1:]:
        assert r["tr"] is t_lo.ResultType.success and r["jr"] is j_lo.ResultType.success


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


def test_replay_map_grows_every_frame(replay):
    """Every frame passes the gate and is inserted; the keyframe list stays
    at the first frame's."""
    jlo, tlo, rows = replay
    assert all(r["kf"] for r in rows[1:])
    t_vox = [r["voxels"][1] for r in rows]
    assert all(b > a for a, b in zip(t_vox, t_vox[1:]))
    assert int(tlo.submap.map_state.frame) == int(jlo.submap.map_state.frame) == 5
    assert len(tlo.get_keyframe_poses()) == len(jlo.get_keyframe_poses()) == 1
    assert abs(t_vox[-1] - rows[-1]["voxels"][0]) < 0.05 * t_vox[-1]
    assert int(tlo.submap.map_state.dropped) == 0
    # the fetches, the solver's exit tests and two resolves' probe loops a frame
    for r in rows[1:]:
        assert 8 < r["syncs"] <= 40


def test_replay_app_scans_carry_intensities():
    """``make_scans(..., intensities=True)`` through ``run_replay`` at the
    default tree: the correction (1e-3 range^2) gives the seeded
    reflectivity in [0.05, 1] back; ``Submap`` holds the backend policy."""
    from sycl_points_tpu_torch.apps.odometry_replay import default_params, make_scans, replay_params, run_replay
    from sycl_points_tpu_torch.pipeline.submap import Submap

    poses, scans = make_scans(2, 512, 32, device="cpu", intensities=True)
    raw = scans[0].intensities[scans[0].mask]
    assert raw.shape[0] == int(scans[0].count()) and float(raw.min()) > 0.0 and float(raw.max()) > 1.0
    params = default_params(poses[0])
    params = dataclasses.replace(params, submap=dataclasses.replace(  # the CPU's k-NN scans every target row
        params.submap, map_capacity=1 << 12, extract_capacity=1 << 11))
    out = run_replay(params, poses, scans, device="cpu")
    lo = out["odometry"]
    got = lo.preprocessed.intensities[lo.preprocessed.mask]
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    assert 0.4 < float(got.mean()) < 0.65  # the reflectivity's mean is 0.525
    assert lo.submap.inserts_every_frame and len(lo.get_keyframe_poses()) == 1
    assert [r["occupied"] for r in out["rows"]][-1] == lo.submap.occupied_voxels() > 0
    vhm = Submap(replay_params(poses[0]), device="cpu")
    assert not vhm.inserts_every_frame and vhm.occupied_voxels() == 0
