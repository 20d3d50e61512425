"""The port's ``FleetLIO`` and the stream forms under it, on the CPU.

  * The batched preintegration (three windows of different lengths, biases
    and start rotations, padded to one bucket), ``lio.align_streams`` (GN,
    LM and dogleg, two streams that converge after different counts) and
    ``_lio_step_streams`` (two streams, one of them too small) each equal
    the single-window / single-stream call on stream ``b``'s inputs bit for
    bit; ``executed`` counts each stream's iterations and ``loops`` the
    slowest stream's.
  * The port's ``FleetLIO`` against the JAX package's on the scenarios of
    ``tests/test_fleet.py`` (``test_fleet_lio_tracks_streams``,
    ``test_fleet_lio_per_stream_imu_only``), every point taken (no sampler,
    so both packages draw nothing), the port fleet started from the JAX
    fleet's state after the first frame (``convert.fleet_lio_state_from_reference``):
    the same result types, every pose within 1 mm and 1e-3 rad of JAX's,
    the bias mirrors within 2e-4 rad/s and 2e-3 m/s^2.
  * Each stream of a three-stream ``FleetLIO`` (samplers on, one stream
    standing still) against a single-stream ``PipelinedLidarInertialOdometry``
    on its scans and IMU, its generators seeded as ``stream_seeds(0, s,
    inertial=True)``: every pose, the final state and covariance bit for
    bit, the same result types, the maps equal as sets of voxels.
  * The refusals: the initial alignment (which JAX refuses too), the IMU
    deskew and a mesh the streams do not split over evenly; the rotation
    constraint and coarse-to-fine, refused before they were ported, run
    (coarse-to-fine leaves every bit as it was: it is no branch of the LIO
    solve, as in JAX).
  * Zero-loss growth with the LIO stats layout (the JAX
    ``test_fleet_growth_zero_loss`` on ``FleetLIO``): a 2^10-slot fleet at 8
    probes a key drops on a frame after the first, retries it on the grown
    fleet, and ends within max(3, 2%) voxels a stream of a fleet that never
    grows.
  * The LO fleet after its split into the hooks that ``FleetLIO``
    overrides: three streams of ``small_params()`` over 5 frames read the
    host and call the batched kernels' wrappers (one call is one launch on
    the card) as often a frame, file by file, as the fleet did before the
    split (the counts below were taken from it).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_

from sycl_points_tpu.imu.preintegration import IMUMeasurement as JMeas
from sycl_points_tpu.parallel.fleet import FleetLIO as JFleetLIO
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu_torch.convert import fleet_lio_state_from_reference, params_from_reference
from sycl_points_tpu_torch.imu import preintegration as t_pre
from sycl_points_tpu_torch.imu.factor import State
from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement as TMeas
from sycl_points_tpu_torch.lio import lio_registration as t_lio
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops.knn import BruteForceKNN
from sycl_points_tpu_torch.parallel.fleet import FleetLIO, FleetOdometry, stream_seeds
from sycl_points_tpu_torch.pipeline.lidar_inertial_odometry import LidarInertialOdometry
from sycl_points_tpu_torch.pipeline.pipelined_lio import PipelinedLidarInertialOdometry
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.registration.registration import RegistrationParams
from sycl_points_tpu_torch.utils import lie_np, sync

from test_lidar_inertial_odometry import G, lio_params, make_world, scan_at  # noqa: E402
from test_torch_checkpoint import _every_point  # noqa: E402
from test_torch_fleet import stacked_frame  # noqa: E402
from test_torch_imu import NOISE, _window_arrays  # noqa: E402
from test_torch_lio_registration import T_TRUE, _cloud, _spd, corner_scene  # noqa: E402
from test_torch_fleet import stream_trajectories  # noqa: E402
from test_torch_lo_frame import make_world as lo_world  # noqa: E402
from test_torch_lo_frame import scan_at as lo_scan_at  # noqa: E402
from test_torch_lo_frame import small_params  # noqa: E402

TRANS_M, ROT_RAD = 1e-3, 1e-3  # port fleet against JAX fleet, every point taken
GYRO_BIAS_TOL, ACCEL_BIAS_TOL = 2e-4, 2e-3
CAP = 1 << 13
FRAME_DT = 0.1


def _eq(a, b, err_msg=""):
    np.testing.assert_array_equal(np_(a), np_(b), err_msg=err_msg)


def _state_eq(a: State, b: State, what=""):
    for name, x, y in zip(State._fields, a, b):
        _eq(x, y, f"{what}{name}")


# -- the stream forms against single calls --------------------------------------


def test_batched_preintegration_equals_single_windows():
    rng = np.random.default_rng(4)
    tp = t_pre.IMUPreintegrationParams(**NOISE)
    wins = [_window_arrays(rng, S=S, n_valid=n, holes=h) for S, n, h in ((32, 20, ()), (64, 50, (7,)), (64, 64, ()))]
    wins[1] = (*wins[1][:6], wins[1][6] * -2.0, wins[1][7] * 0.5, wins[1][8].T.copy())  # own biases and rotation
    S = max(len(w[0]) for w in wins)
    padded = []
    for w in wins:  # pad as the fleet pads: invalid zero steps up to the largest bucket
        pad = S - len(w[0])
        padded.append([np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]) for a in w[:6]] + list(w[6:]))
    P0 = np.stack([_spd(rng, 15, 1e-3) for _ in wins])
    stacked = [torch.from_numpy(np.stack([p[i] for p in padded])) for i in range(9)]
    raw, outs = t_pre.integrate_steps_with_outputs(tp, t_pre.init_state(torch.from_numpy(P0)), *stacked)
    for b, w in enumerate(wins):
        one, one_outs = t_pre.integrate_steps_with_outputs(
            tp, t_pre.init_state(torch.from_numpy(P0[b])), *[torch.from_numpy(a) for a in w])
        for name, x, y in zip(one._fields, raw, one):
            _eq(x[b], y, f"window {b}: {name}")
        n = len(w[0])
        for x, y in zip(outs, one_outs):
            _eq(x[b, :n], y)
        rel = t_pre.predict_relative_transform(tp, one, torch.from_numpy(w[8]), torch.tensor([1.0, -0.5, 0.2]))
        rel_b = t_pre.predict_relative_transform(tp, raw, stacked[8], torch.tensor([1.0, -0.5, 0.2]).expand(3, 3))
        _eq(rel_b[b], rel)


@pytest.fixture(scope="module")
def two_scenes():
    """Stream 0: the LIO solver tests' corner scene; stream 1: another
    corner under another motion (it converges after another count)."""
    out = []
    for seed, T in ((31, T_TRUE), (8, lie_np.se3_exp(np.array([-0.06, 0.08, 0.04, -0.4, 0.6, 0.2])))):
        tgt = corner_scene(np.random.default_rng(seed))
        src = ((tgt - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
        out.append((_cloud(src)[1], _cloud(tgt)[1]))
    return out


def _stack_clouds(clouds):
    return PointCloud(points=torch.stack([c.points for c in clouds]), mask=torch.stack([c.mask for c in clouds]),
                      covs=torch.stack([c.covs for c in clouds]))


@pytest.mark.parametrize("method", ["gauss_newton", "levenberg_marquardt", "powell_dogleg"])
def test_align_streams_equals_single_aligns(two_scenes, method):
    rng = np.random.default_rng(3)
    params = t_lio.LIORegistrationParams(total_iterations=12, optimization_method=method)
    factor = RegistrationParams()
    starts = []
    for b in range(2):
        x = State(*(torch.from_numpy(np.asarray(a, np.float32)) for a in (
            rng.normal(scale=0.02, size=3), lie_np.so3_exp_matrix(rng.normal(scale=0.01, size=3)),
            rng.normal(size=3), rng.normal(scale=0.01, size=3), rng.normal(scale=0.001, size=3))))
        starts.append((x, torch.from_numpy(_spd(rng, 15, 0.5)), torch.from_numpy(_spd(rng, 15, 1.0))))
    update_bias = torch.tensor([True, False])
    singles = [t_lio.align(src, tgt, BruteForceKNN.build(tgt), x, P, Pp, factor_params=factor, params=params,
                           update_bias=update_bias[b], trace=True)
               for b, ((src, tgt), (x, P, Pp)) in enumerate(zip(two_scenes, starts))]
    src = _stack_clouds([s for s, _ in two_scenes])
    tgt = _stack_clouds([t for _, t in two_scenes])
    res, trace = t_lio.align_streams(
        src, tgt, BruteForceKNN.build(tgt), State(*(torch.stack(f) for f in zip(*[x for x, _, _ in starts]))),
        torch.stack([P for _, P, _ in starts]), torch.stack([Pp for _, _, Pp in starts]),
        factor_params=factor, params=params, update_bias=update_bias, trace=True)
    for b, (one, one_trace) in enumerate(singles):
        _state_eq(State(*(f[b] for f in res.state)), one.state, f"stream {b}: ")
        for name in ("posterior_covariance", "T", "iterations", "inlier", "error"):
            _eq(getattr(res, name)[b], getattr(one, name), f"stream {b}: {name}")
        _eq(trace[b], one_trace)
        assert int(res.executed[b]) == one.executed
    assert res.loops == max(one.executed for one, _ in singles)
    assert int(res.executed[0]) != int(res.executed[1])  # one stream is done while the other runs on
    assert not torch.equal(singles[0][0].state.gyro_bias, starts[0][0].gyro_bias)  # stream 0 updates its bias
    _eq(singles[1][0].state.gyro_bias, starts[1][0].gyro_bias)  # stream 1's is frozen


def test_lio_step_streams_equals_single_steps():
    rng = np.random.default_rng(9)
    p = params_from_reference(lio_params())
    odo = LidarInertialOdometry(p, device="cpu")
    world = make_world()
    poses = [np.eye(4, dtype=np.float32) for _ in range(4)]
    poses[1][:3, 3] = [0.2, 0.0, 0.0]
    poses[3][:3, 3] = [0.0, 3.0, 0.0]
    scans = [scan_at(world, T) for T in poses]
    scans[2] = scans[2][:8]  # stream 1's frame is too small: the IMU-only select
    gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
    pre = odo.pc_processor.preprocess_streams(_stack_pts([scans[1], scans[2]]), gens)
    tgt = odo.pc_processor.preprocess_streams(_stack_pts([scans[0], scans[3]]), gens)
    knn = BruteForceKNN.build(tgt)
    xs = [State(*(torch.from_numpy(np.asarray(a, np.float32)) for a in (
        T[:3, 3] + rng.normal(scale=0.01, size=3), T[:3, :3], [2.0 * (1 - b), 1.5 * b, 0.0],
        rng.normal(scale=0.01, size=3), rng.normal(scale=0.001, size=3)))) for b, T in enumerate((poses[0], poses[3]))]
    Ps = [torch.from_numpy(_spd(rng, 15, 1e-2)) for _ in range(2)]
    packs = []
    for b in range(2):
        w = [TMeas(timestamp=t, gyro=np.array([0.0, 0.0, 0.1 * b], np.float32),
                   accel=np.array([0.1, 0.0, G], np.float32)) for t in np.arange(0.0, 0.1 + 0.1 * b + 1e-9, 0.005)]
        packs.append(t_pre.pack_steps(*t_pre.padded_steps_from_window(w)))
    S = max(len(a) for a in packs)
    pack = torch.from_numpy(np.stack([np.pad(a, ((0, S - len(a)), (0, 0))) for a in packs]))
    misc = torch.from_numpy(np.stack([np.concatenate([T.ravel(), [1.0, float(b)]]).astype(np.float32)
                                      for b, T in enumerate((poses[0], poses[3]))]))
    reg_gens = [torch.Generator().manual_seed(s) for s in (11, 12)]
    out = odo._lio_step_streams(pre, tgt, knn, State(*(torch.stack(f) for f in zip(*xs))), torch.stack(Ps),
                                pack, misc, reg_gens)
    x_new, P_new, source, T_eff, is_kf, s1, result, _ = out
    assert s1.shape == (2, 34) and bool(s1[1, 20]) and not bool(s1[0, 20])  # stream 1 small, stream 0 not
    for b in range(2):
        odo._generator.manual_seed(11 + b)
        one_pre = PointCloud(points=pre.points[b], mask=pre.mask[b], covs=pre.covs[b])
        one_tgt = PointCloud(points=tgt.points[b], mask=tgt.mask[b], covs=tgt.covs[b])
        ox, oP, osrc, oT, okf, os1, executed, _ = odo._lio_step(
            one_pre, one_tgt, BruteForceKNN.build(one_tgt), xs[b], Ps[b], torch.from_numpy(packs[b]), misc[b])
        _state_eq(State(*(f[b] for f in x_new)), ox, f"stream {b}: ")
        for got, want in ((P_new[b], oP), (source.points[b], osrc.points), (T_eff[b], oT), (is_kf[b], okf),
                          (s1[b], os1)):
            _eq(got, want, f"stream {b}")
        assert int(result.executed[b]) == executed


def _stack_pts(pts_list, cap=CAP):
    pts, mask = stacked_frame(pts_list, cap)
    return PointCloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask))


# -- the port's FleetLIO against the JAX one ------------------------------------


def _feed_both(fleets, B, t_from, t_to, imu):
    for t in np.arange(t_from, t_to, 1.0 / 200):
        for s in range(B):
            g, a = imu(s, t)
            for f in fleets:
                meas = JMeas if isinstance(f, JFleetLIO) else TMeas
                f.add_imu_measurement(s, meas(timestamp=10.0 + float(t), gyro=g, accel=a))


def _run_both(frames, init, imu):
    """Both fleets over ``frames`` ([frame][stream] of (points, mask)), every
    point taken; the port fleet takes the JAX fleet's filter state and carry
    after the first frame."""
    B = len(frames[0])
    jp = _every_point(lio_params())
    jf = JFleetLIO(jp, n_streams=B, initial_poses=init)
    tf = FleetLIO(params_from_reference(jp), n_streams=B, initial_poses=init, device="cpu")
    _feed_both((jf, tf), B, -0.2, FRAME_DT * len(frames) + 0.01, imu)
    for i, frame in enumerate(frames):
        pts, mask = np.stack([p for p, _ in frame]), np.stack([m for _, m in frame])
        jf.process_batch(JCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask)), timestamps=10.0 + FRAME_DT * i)
        tf.process_batch(PointCloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask)),
                         10.0 + FRAME_DT * i)
        if i == 0:
            tf.x, tf.P, tf._carry = fleet_lio_state_from_reference(jf, device="cpu")
    jf.flush()
    tf.flush()
    return jf, tf


def _assert_fleets_agree(jf, tf, B):
    for s in range(B):
        assert [(i, rt.value) for i, rt in tf.deferred_results[s]] == \
            [(i, rt.value) for i, rt in jf.deferred_results[s]]
        for (i, _, T, _), (ji, _, jT, _) in zip(tf.pose_log[s], jf.pose_log[s], strict=True):
            jT = np.asarray(jT)
            assert i == ji
            np.testing.assert_allclose(T[:3, 3], jT[:3, 3], atol=TRANS_M)
            assert np.linalg.norm(lie_np.se3_log(np.linalg.inv(jT) @ T)[:3]) < ROT_RAD
    np.testing.assert_allclose(tf.gyro_bias_np, np.asarray(jf.gyro_bias_np), atol=GYRO_BIAS_TOL)
    np.testing.assert_allclose(tf.accel_bias_np, np.asarray(jf.accel_bias_np), atol=ACCEL_BIAS_TOL)
    assert np.isfinite(tf.velocity_np).all()


def _level_imu(s, t):
    return np.zeros(3, np.float32), np.array([0, 0, G], np.float32)


def test_fleet_lio_tracks_streams_as_jax():
    """tests/test_fleet.py::test_fleet_lio_tracks_streams: two streams at
    constant velocities of 2 and 1.5 m/s from two starts, 5 frames."""
    world = make_world()
    vels = [np.array([2.0, 0.0, 0.0], np.float32), np.array([0.0, 1.5, 0.0], np.float32)]
    starts = [np.zeros(3, np.float32), np.array([0.0, 3.0, 0.0], np.float32)]

    def T_at(s, t):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = starts[s] + vels[s] * t
        return T

    frames = [[_padded(scan_at(world, T_at(s, i * FRAME_DT))) for s in range(2)] for i in range(5)]
    jf, tf = _run_both(frames, np.stack([T_at(s, 0.0) for s in range(2)]), _level_imu)
    _assert_fleets_agree(jf, tf, 2)
    for s in range(2):
        assert all(rt.value == "success" for _, rt in tf.deferred_results[s])
        assert np.linalg.norm(tf.get_odometry(s)[:3, 3] - T_at(s, 0.4)[:3, 3]) < 0.15
    assert (np_(tf.map_state.dropped) == 0).all()


def test_fleet_lio_per_stream_imu_only_as_jax():
    """tests/test_fleet.py::test_fleet_lio_per_stream_imu_only: stream 1's
    second frame has 8 points and resolves ``imu_only`` while stream 0
    registers."""
    world = make_world(1000)
    good = scan_at(world, np.eye(4, dtype=np.float32))
    tiny = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32) * 3
    frames = [[_padded(good), _padded(good)], [_padded(good), _padded(tiny)]]
    jf, tf = _run_both(frames, np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)), _level_imu)
    _assert_fleets_agree(jf, tf, 2)
    assert [rt.value for _, rt in tf.deferred_results[0]] == ["success"]
    assert [rt.value for _, rt in tf.deferred_results[1]] == ["imu_only"]
    assert np.isfinite(tf.get_odometry(1)).all()


def _padded(pts, cap=CAP):
    p, m = np.zeros((cap, 3), np.float32), np.zeros(cap, bool)
    p[: len(pts)], m[: len(pts)] = pts[:cap], True
    return p, m


# -- each stream against the single-stream pipelined LIO ------------------------


def test_streams_equal_single_pipelined_lio():
    world = make_world()
    B, n_frames = 3, 5
    vels = [np.array([2.0, 0.0, 0.0]), np.zeros(3), np.array([0.0, -1.5, 0.0])]  # stream 1 stands still
    starts = [np.zeros(3), np.array([1.0, 0.0, 0.0]), np.array([0.0, 3.0, 0.0])]

    def T_at(s, t):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = starts[s] + vels[s] * t
        return T

    def imu(s, t):
        return np.array([0.0, 0.0, 0.02 * s], np.float32), np.array([0.05 * s, 0.0, G], np.float32)

    params = params_from_reference(lio_params())
    frames = [[scan_at(world, T_at(s, i * FRAME_DT)) for s in range(B)] for i in range(n_frames)]
    fleet = FleetLIO(params, n_streams=B, initial_poses=np.stack([T_at(s, 0.0) for s in range(B)]), device="cpu")
    _feed_both((fleet,), B, -0.2, FRAME_DT * n_frames + 0.01, imu)
    for i, frame in enumerate(frames):
        fleet.process_batch(_stack_pts(frame), 10.0 + FRAME_DT * i)
    fleet.flush()
    assert any(k not in (0, n_frames - 1) for k in fleet.keyframe_counts), fleet.keyframe_counts  # mixed keyframes

    for s in range(B):
        p = dataclasses.replace(params, pose=dataclasses.replace(params.pose, initial=tuple(T_at(s, 0.0).ravel())))
        pl = PipelinedLidarInertialOdometry(p, device="cpu")
        pre_seed, map_seed, reg_seed = stream_seeds(0, s, inertial=True)
        pl.pc_processor._generator.manual_seed(pre_seed)
        pl.submap._generator.manual_seed(map_seed)
        pl._generator.manual_seed(reg_seed)
        for t in np.arange(-0.2, FRAME_DT * n_frames + 0.01, 1.0 / 200):
            g, a = imu(s, t)
            pl.add_imu_measurement(TMeas(timestamp=10.0 + float(t), gyro=g, accel=a))
        for i in range(n_frames):
            pl.process(PointCloud.from_numpy(frames[i][s], capacity=CAP, device="cpu"), 10.0 + FRAME_DT * i)
        pl.flush()
        assert [rt for _, rt in pl.deferred_results] == [rt for _, rt in fleet.deferred_results[s]]
        for (_, ts, T, _), (i, fts, fT, _) in zip(pl.pose_log, fleet.pose_log[s], strict=True):
            assert ts == fts
            np.testing.assert_array_equal(fT, T)
            assert np.linalg.norm(fT[:3, 3] - T_at(s, i * FRAME_DT)[:3, 3]) < 0.15
        _state_eq(State(*(f[s] for f in fleet.x)), pl.x, f"stream {s}: ")
        _eq(fleet.P[s], pl.P_post)
        used = np_(fleet.map_state.used[s])
        fleet_voxels = set(map(tuple, np_(fleet.map_state.coords[s])[used].tolist()))
        single_voxels = set(map(tuple, np_(pl.submap.map_state.coords)[np_(pl.submap.map_state.used)].tolist()))
        assert fleet_voxels == single_voxels


# -- refusals --------------------------------------------------------------------


def test_fleet_lio_refusals():
    p = params_from_reference(lio_params())
    imu = p.imu
    with pytest.raises(ValueError, match="initial_alignment"):
        FleetLIO(dataclasses.replace(p, imu=dataclasses.replace(
            imu, initial_alignment=dataclasses.replace(imu.initial_alignment, enable=True))), device="cpu")
    with pytest.raises(ValueError, match="deskew"):
        FleetLIO(dataclasses.replace(p, imu=dataclasses.replace(
            imu, deskew=dataclasses.replace(imu.deskew, enable=True))), device="cpu")
    with pytest.raises(ValueError, match="2 streams do not split evenly over the 3 devices"):
        FleetLIO(p, n_streams=2, mesh=[torch.device("cpu")] * 3, device="cpu")
    # the rotation constraint and coarse-to-fine, which FleetLIO refused
    # before they were ported, run; coarse-to-fine is no branch of the LIO
    # solve (as in JAX), so it leaves every bit as it was
    factor = p.registration.factor
    world = make_world()
    starts = [np.eye(4, dtype=np.float32), lie_np.se3_exp(np.array([0, 0, 0.3, 0.5, 2.0, 0])).astype(np.float32)]
    frames = [_stack_pts([scan_at(world, T @ lie_np.se3_exp(np.array([0, 0, 0, 0.2 * i, 0, 0])).astype(np.float32))
                          for T in starts]) for i in range(3)]
    poses = {}
    for name, changed in (("plain", factor),
                          ("rotation constraint", dataclasses.replace(factor, rotation_constraint=dataclasses.replace(
                              factor.rotation_constraint, enable=True))),
                          ("coarse-to-fine", dataclasses.replace(factor, coarse_to_fine_iters=2))):
        fleet = FleetLIO(dataclasses.replace(p, registration=dataclasses.replace(p.registration, factor=changed)),
                         n_streams=2, initial_poses=np.stack(starts), device="cpu")
        _feed_both((fleet,), 2, -0.2, FRAME_DT * len(frames) + 0.01, _level_imu)
        for i, frame in enumerate(frames):
            fleet.process_batch(frame, 10.0 + FRAME_DT * i)
        fleet.flush()
        assert all(rt.value == "success" for s in range(2) for _, rt in fleet.deferred_results[s]), name
        poses[name] = np.stack([fleet.get_odometry(s) for s in range(2)])
    _eq(poses["coarse-to-fine"], poses["plain"])
    assert not np.array_equal(poses["rotation constraint"], poses["plain"])
    fleet = FleetLIO(p, n_streams=2, device="cpu")
    assert fleet.precompile_growth(1 << 20) == 0
    with pytest.raises(ValueError, match="2 streams"):
        fleet.process_batch(PointCloud(points=torch.zeros(3, 8, 3), mask=torch.ones(3, 8, dtype=torch.bool)), 0.0)
    np.testing.assert_array_equal(fleet.get_odometry(1), np.eye(4, dtype=np.float32))


# -- the LO fleet's reads and launches, unchanged by the hooks --------------------

# per fleet frame: host reads by file, then wrapper calls (= launches on the
# card); counted on the LO fleet before its split into hooks
LO_FLEET_BEFORE = [
    ({"fleet.py": 1, "hash_table.py": 6}, {"knn_k_batched": 2}),
    ({"fleet.py": 1, "hash_table.py": 7, "registration.py": 4}, {"knn_k_batched": 2, "nn1_prepped_batched": 4}),
    ({"fleet.py": 1, "hash_table.py": 8, "registration.py": 5}, {"knn_k_batched": 2, "nn1_prepped_batched": 5}),
    ({"fleet.py": 1, "hash_table.py": 7, "registration.py": 4}, {"knn_k_batched": 2, "nn1_prepped_batched": 4}),
    ({"fleet.py": 1, "hash_table.py": 6, "registration.py": 3}, {"knn_k_batched": 2, "nn1_prepped_batched": 3}),
]


def test_lo_fleet_reads_and_launches_unchanged_by_the_hooks(monkeypatch):
    calls = {}
    for name in ("nn1_prepped_batched", "knn_k_batched"):
        def counted(*args, _f=getattr(cuda_knn, name), _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _f(*args, **kwargs)
        monkeypatch.setattr(cuda_knn, name, counted)
    world, trajs = lo_world(), stream_trajectories(3, 5)
    fleet = FleetOdometry(params_from_reference(small_params()), n_streams=3,
                          initial_poses=np.stack([t[0] for t in trajs]), device="cpu")
    for i, (reads_want, calls_want) in enumerate(LO_FLEET_BEFORE):
        sync.reset_sync_count()
        calls.clear()
        fleet.process_batch(_stack_pts([lo_scan_at(world, trajs[s][i]) for s in range(3)]), 0.1 * i)
        by_file = {}
        for source, n in sync.by_source.items():
            by_file[source.split(":")[0]] = by_file.get(source.split(":")[0], 0) + n
        assert (by_file, calls) == (reads_want, calls_want), f"frame {i}"


def test_fleet_lio_growth_zero_loss():
    """The drop retry and load growth with the LIO stats layout: two streams
    on a 2^10-slot map with 8 probes a key grow the whole fleet, keep every
    stream-frame a success and drop nothing, and end with per-stream voxel
    counts within max(3, 2%) of a fleet that never grows."""
    world = make_world()
    vels = [np.array([2.0, 0.0, 0.0]), np.array([0.0, 1.5, 0.0])]

    def T_at(s, t):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.0, 3.0 * s, 0.0] + vels[s] * t
        return T

    frames = [[scan_at(world, T_at(s, i * FRAME_DT)) for s in range(2)] for i in range(4)]
    p = params_from_reference(lio_params())
    fleets = []
    for capacity in (1 << 10, p.submap.map_capacity):
        q = dataclasses.replace(p, submap=dataclasses.replace(p.submap, map_capacity=capacity))
        fleet = FleetLIO(q, n_streams=2, initial_poses=np.stack([T_at(s, 0.0) for s in range(2)]), device="cpu")
        sm = fleet._t.submap
        sm.map_config = dataclasses.replace(sm.map_config, max_probes=8)
        _feed_both((fleet,), 2, -0.2, 0.41, _level_imu)
        for i, frame in enumerate(frames):
            fleet.process_batch(_stack_pts(frame), 10.0 + FRAME_DT * i)
        fleet.flush()
        fleets.append(fleet)
    small, big = fleets
    assert small.growth_events and small.map_capacity > 1 << 10 and not big.growth_events
    assert small._reconciled_until >= 1  # a frame after the first dropped and was retried
    for s in range(2):
        assert all(rt.value == "success" for _, rt in small.deferred_results[s])
        ns, nb = int(small.map_state.used[s].sum()), int(big.map_state.used[s].sum())
        assert abs(ns - nb) <= max(3, 0.02 * nb), f"stream {s}: grown map diverged ({ns} vs {nb})"
    assert (np_(small.map_state.dropped) == 0).all()
