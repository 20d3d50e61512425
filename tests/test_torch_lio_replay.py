"""The LIO replay apps of the port against the JAX package's LIO replay
benchmark (``benchmarks/bench_lio_replay.py``), on the CPU.

  * ``make_lio_inputs`` / ``lio_params``: the poses, the biased IMU of the
    planar and the 3-D-excited figure-8, the initial velocity and the bias
    random walks equal what the benchmark builds;
  * ``odometry_replay.feed_imu`` feeds the benchmark's chunks;
  * ``run_lio_replay(seed=)``: a reseeded replay repeats itself and samples
    other points than the package's seeds;
  * the 3-D-excited figure-8 at 512 x 32 with the JAX bias record's biases
    and random walks, every point taken (no sampler, so both packages see
    the same points): 5 frames through both packages' LIO on a small map,
    the poses within 2 mm / 5e-4 rad of each other and the bias estimates
    within 2e-4 rad/s and 2e-3 m/s^2.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import clouds

from sycl_points_tpu.imu.preintegration import IMUMeasurement as JMeas
from sycl_points_tpu.imu.preintegration import IMUPreintegrationParams as JPreParams
from sycl_points_tpu.pipeline import params as P
from sycl_points_tpu_torch.apps import lio_replay, odometry_replay

from test_torch_lio_frame import FRAME_DT, both_lio, pose_gap  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import synthetic_velodyne as ref_synth  # noqa: E402


@pytest.mark.parametrize("excite3d", [False, True], ids=["planar", "3d"])
def test_lio_inputs_match_the_jax_replay(excite3d):
    """``make_lio_inputs`` / ``lio_params`` against what
    ``bench_lio_replay.py --excite3d --gyro-bias --accel-bias
    --gyro-bias-rw --accel-bias-rw`` builds: equal poses, IMU readings
    (truth + injected bias, in f32), initial velocity and bias random walks."""
    gb, ab = (0.02, -0.01, 0.015), (0.05, 0.03, -0.04)
    inp = lio_replay.make_lio_inputs(3, 32, 4, excite3d=excite3d, gyro_bias=gb, accel_bias=ab, device="cpu")
    for ours, theirs in zip(inp.poses, ref_synth.figure8_trajectory(3, speed=0.35, excite3d=excite3d), strict=True):
        np.testing.assert_array_equal(ours, theirs)
    truth = ref_synth.figure8_imu_3d if excite3d else ref_synth.figure8_imu
    for t in (-0.05, 0.0, 0.1275, 0.2):
        g, a = truth(t, speed=0.35)
        np.testing.assert_array_equal(inp.imu(t)[0], (g + np.asarray(gb)).astype(np.float32))
        np.testing.assert_array_equal(inp.imu(t)[1], (a + np.asarray(ab)).astype(np.float32))
    np.testing.assert_array_equal(inp.v0, ref_synth.figure8_velocity(0.0, speed=0.35, excite3d=excite3d)
                                  .astype(np.float32))
    np.testing.assert_array_equal(inp.gyro_bias, gb)
    pre = lio_replay.lio_params(inp.poses[0], gyro_bias_rw=1e-4, accel_bias_rw=1e-3).imu.preintegration
    assert (pre.gyro_bias_rw_density, pre.accel_bias_rw_density) == (1e-4, 1e-3)
    assert (pre.gyro_noise_density, pre.accel_noise_density) == (1e-3, 1e-2)


def test_feed_imu_in_the_benchmarks_chunks():
    """The benchmark's feed: from half a frame before the first frame, each
    chunk ``[from, to]`` at 400 Hz with both ends, nothing when ``to`` is
    not ahead; ``clock_offset`` moves the stamps, not the readings."""
    got = []
    fed = odometry_replay.feed_imu(got.append, lambda s: (np.full(3, s), np.zeros(3)), None, 0.0, clock_offset=0.1)
    fed = odometry_replay.feed_imu(got.append, lambda s: (np.full(3, s), np.zeros(3)), fed, 0.1, clock_offset=0.1)
    assert fed == 0.1
    assert odometry_replay.feed_imu(got.append, lambda s: (np.zeros(3), np.zeros(3)), fed, 0.1) == 0.1
    want = [-0.05 + 0.05 * k / 20 for k in range(21)] + [0.1 * k / 40 for k in range(41)]
    assert len(got) == len(want)
    np.testing.assert_allclose([m.timestamp for m in got], np.add(want, 0.1), rtol=0, atol=1e-12)
    np.testing.assert_allclose([m.gyro[0] for m in got], want, rtol=0, atol=1e-12)


def test_reseeded_replay_repeats_and_samples_otherwise():
    """``run_lio_replay(seed=)``: the same seed gives the same poses, another
    seed than the package's fixed ones moves them (other sampled points)."""
    inp = lio_replay.make_lio_inputs(3, 256, 16, device="cpu")
    params = lio_replay.lio_params(inp.poses[0])
    params = dataclasses.replace(params, submap=dataclasses.replace(params.submap, map_capacity=1 << 10,
                                                                    extract_capacity=1 << 9))
    runs = [lio_replay.run_lio_replay(params, inp, device="cpu", seed=seed) for seed in (7, 7, None)]
    for out in runs:
        assert [r["result"] for r in out["rows"]] == ["first_frame", "success", "success"]
    np.testing.assert_array_equal(runs[0]["poses"][-1], runs[1]["poses"][-1])
    assert not np.array_equal(runs[0]["poses"][-1], runs[2]["poses"][-1])


def biased_3d_pair(n_frames, map_capacity=1 << 17, extract_capacity=1 << 14):
    """Both packages' ``LidarInertialOdometry`` over ``n_frames`` of the
    3-D-excited figure-8 at 512 x 32 (``bench_lio_replay.py --excite3d
    --gyro-bias=0.02,-0.01,0.015 --accel-bias=0.05,0.03,-0.04
    --gyro-bias-rw 1e-4 --accel-bias-rw 1e-3 --rings 32 --az 512``), every
    sampling stage taking all the points, the IMU fed as the benchmark feeds
    it, on a map of ``map_capacity`` slots with an ``extract_capacity``-row
    target. Yields per frame both results, both poses and both bias
    estimates."""
    import jax.numpy as jnp

    gb, ab = np.array([0.02, -0.01, 0.015]), np.array([0.05, 0.03, -0.04])
    poses = ref_synth.figure8_trajectory(n_frames, speed=0.35, excite3d=True)
    params = P.LidarInertialOdometryParams(
        scan=P.ScanParams(downsampling=P.DownsamplingParams(
            voxel=P.VoxelDownsamplingParams(enable=True, size=1.0), polar=P.PolarDownsamplingParams(enable=False),
            random=P.RandomDownsamplingParams(enable=False))),
        submap=P.SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0, map_capacity=map_capacity,
                              extract_capacity=extract_capacity),
        pose=P.PoseParams(initial=tuple(np.asarray(poses[0], np.float32).ravel().tolist())),
        imu=P.IMUParams(enable=True, preintegration=JPreParams(
            gyro_noise_density=1e-3, accel_noise_density=1e-2, gyro_bias_rw_density=1e-4,
            accel_bias_rw_density=1e-3)))
    params = dataclasses.replace(
        params, registration_sampling=dataclasses.replace(params.registration_sampling, enable=False),
        submap=dataclasses.replace(params.submap, point_random_sampling_num=params.scan_capacity))
    jodo, todo = both_lio(params)
    v0 = ref_synth.figure8_velocity(0.0, speed=0.35, excite3d=True).astype(np.float32)
    jodo.x = jodo.x._replace(velocity=jnp.asarray(v0))
    todo.x = todo.x._replace(velocity=torch.as_tensor(v0))
    for odo in (jodo, todo):
        odo.velocity_np, odo.imu_v_world_at_reset = v0.copy(), v0.copy()

    def imu(s):
        g, a = ref_synth.figure8_imu_3d(s, speed=0.35)
        return (g + gb).astype(np.float32), (a + ab).astype(np.float32)

    world, fed = ref_synth.World(), None
    for i, T in enumerate(poses):
        chunk = []
        fed = odometry_replay.feed_imu(chunk.append, imu, fed, FRAME_DT * i)
        for m in chunk:
            jodo.add_imu_measurement(JMeas(timestamp=m.timestamp, gyro=m.gyro, accel=m.accel))
            todo.add_imu_measurement(m)
        jc, tc = clouds(ref_synth.scan_at(world, T, n_az=512, n_rings=32, seed=i), capacity=1 << 14)
        yield dict(jr=jodo.process(jc, FRAME_DT * i), tr=todo.process(tc, FRAME_DT * i), truth=T,
                   j=np.asarray(jodo.odom, np.float64), t=np.asarray(todo.get_odometry(), np.float64),
                   jgb=jodo.gyro_bias_np.copy(), tgb=todo.gyro_bias_np.copy(),
                   jab=jodo.accel_bias_np.copy(), tab=todo.accel_bias_np.copy())


def test_biased_3d_replay_every_point_matches_jax():
    for i, r in enumerate(biased_3d_pair(5, 1 << 12, 1 << 11)):
        assert r["tr"].name == r["jr"].name == ("first_frame" if i == 0 else "success")
        trans, rot = pose_gap(r["t"], r["j"])
        assert trans < 2e-3 and rot < 5e-4, (i, trans, rot)
        np.testing.assert_allclose(r["tgb"], r["jgb"], rtol=0, atol=2e-4)
        np.testing.assert_allclose(r["tab"], r["jab"], rtol=0, atol=2e-3)
