"""The port's fleets split over a mesh (``FleetOdometry(mesh=...)``,
``FleetLIO(mesh=...)``) on the CPU, a mesh entry a shard, each shard on a
host thread of its own.

  * ``mesh=[cpu]`` equals ``mesh=None`` bit for bit: the pose logs, the
    deferred results, the align iterations and each stream's map state.
  * Two shards ``[cpu, cpu]`` at B = 4 (``small_params()``, samplers on) equal
    the unsharded fleet bit for bit on both map backends: every stream keeps
    its seeds, and on the CPU a stream's bits do not depend on the streams
    batched beside it. The same under forced growth (B = 2, 2^10 slots, 8
    probes a key, stream 1 standing still, so that shard 1 has no keyframe
    in the frame that shard 0 drops in and retries): the same growth
    events, frames retried, nothing dropped.
  * ``FleetLIO`` on ``[cpu, cpu]``, each stream's IMU routed to its shard
    and the filter state set through the sharded ``x``: every pose, ``x``,
    ``P``, the bias and velocity mirrors and the align loops bit for bit.
  * Against JAX's ``FleetOdometry(..., mesh=make_mesh(2, axis="streams"))``,
    every point taken (no sampler, so both packages draw nothing): every
    pose within JAX's own ``test_fleet_sharded_matches_unsharded``
    tolerances (5e-3 m, 2e-3 on the rotation's entries).
  * The read and launch counters under the shard threads: a fleet frame's
    reads (``utils.sync``) and launches (``cuda_knn.count_launch``, called
    by the wrappers' stand-ins here, as the wrappers call it on the card)
    equal the shards' sums, and two threads counting at once lose nothing.
    A shard thread gives up its host turn while it waits
    (``sync.waiting``).
  * A shard's exception reaches the caller, and the fleet then refuses
    further calls; the refusals (B not divisible by n, an empty mesh, an
    entry of another device type) come before any thread or state is made.
"""

import dataclasses
import threading
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_

from sycl_points_tpu.parallel.fleet import FleetOdometry as JFleet
from sycl_points_tpu.parallel.sharded import make_mesh
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement as TMeas
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.parallel.fleet import (
    FleetLIO,
    FleetOdometry,
    ShardedFleetLIO,
    ShardedFleetOdometry,
)
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils import sync

from test_lidar_inertial_odometry import G, lio_params  # noqa: E402
from test_lidar_inertial_odometry import make_world as lio_world  # noqa: E402
from test_lidar_inertial_odometry import scan_at as lio_scan_at  # noqa: E402
from test_torch_checkpoint import _every_point  # noqa: E402
from test_torch_fleet import run_port, stacked_frame, stream_trajectories  # noqa: E402
from test_torch_lo_frame import make_world, scan_at, small_params  # noqa: E402

B, N_FRAMES, GROW_FRAMES = 4, 3, 4
CPU2 = [torch.device("cpu")] * 2
JAX_TRANS_M, JAX_ROT = 5e-3, 2e-3  # tests/test_fleet.py::test_fleet_sharded_matches_unsharded
# the batched wrappers the fleet calls, and the launch count each adds to
WRAPPERS = {"nn1_prepped_batched": "nn1_batched", "knn_k_batched": "knn_k_batched"}


def _params(map_type="VOXEL_HASH_MAP", **submap):
    p = params_from_reference(small_params())
    return dataclasses.replace(p, submap=dataclasses.replace(p.submap, map_type=map_type, **submap))


def _scans(trajs):
    world = make_world()
    return [[scan_at(world, t[i]) for t in trajs] for i in range(len(trajs[0]))]


@pytest.fixture(scope="module")
def lo_scans():
    trajs = stream_trajectories(B, N_FRAMES)
    return trajs, _scans(trajs)


def _counted_run(fleet, scans):
    """``run_port`` with the batched wrappers' calls counted through
    ``cuda_knn.count_launch`` (as the wrappers count a launch on the card);
    returns the fleet and, a frame, the global reads and launches it added."""
    counts = []
    with pytest.MonkeyPatch.context() as mp:
        for name, key in WRAPPERS.items():
            def counted(*args, _f=getattr(cuda_knn, name), _key=key, **kwargs):
                cuda_knn.count_launch(_key)
                return _f(*args, **kwargs)
            mp.setattr(cuda_knn, name, counted)
        for i, frame in enumerate(scans):
            pts, mask = stacked_frame(frame)
            reads, launches = Counter(sync.by_source), Counter(cuda_knn.launch_counts)
            fleet.process_batch(PointCloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask)), 0.1 * i)
            counts.append((Counter(sync.by_source) - reads, Counter(cuda_knn.launch_counts) - launches))
        fleet.flush()
    return fleet, counts


@pytest.fixture(scope="module")
def lo_runs(lo_scans):
    """The unsharded and the two-shard fleets on both backends."""
    trajs, scans = lo_scans
    init = np.stack([t[0] for t in trajs])
    out = {}
    for map_type in ("VOXEL_HASH_MAP", "OCCUPANCY_GRID_MAP"):
        p = _params(map_type)
        for name, mesh in (("unsharded", None), ("two", CPU2)):
            out[map_type, name] = _counted_run(
                FleetOdometry(p, n_streams=B, initial_poses=init, mesh=mesh, device="cpu"), scans)
    return out


def _assert_same_fleet(a, b, n_streams):
    """Every stream's pose log, results, align iterations and map bit for bit."""
    for s in range(n_streams):
        assert [(i, rt) for i, rt in a.deferred_results[s]] == [(i, rt) for i, rt in b.deferred_results[s]]
        for (i, ts, T, rt), (bi, bts, bT, brt) in zip(a.pose_log[s], b.pose_log[s], strict=True):
            assert (i, ts, rt) == (bi, bts, brt)
            np.testing.assert_array_equal(T, bT, err_msg=f"stream {s} frame {i}")
        assert a.align_iterations[s] == b.align_iterations[s]
    np.testing.assert_array_equal(a.keyframe_counts, b.keyframe_counts)
    np.testing.assert_array_equal(a.extract_overflow, b.extract_overflow)
    np.testing.assert_array_equal(a.budget_lost, b.budget_lost)
    assert a.growth_events == b.growth_events and a.map_capacity == b.map_capacity
    sa, sb = a.map_state, b.map_state
    for f in dataclasses.fields(sa):
        np.testing.assert_array_equal(np_(getattr(sa, f.name)), np_(getattr(sb, f.name)), err_msg=f.name)


def test_one_entry_mesh_equals_unsharded(lo_runs, lo_scans):
    trajs, scans = lo_scans
    one = run_port(FleetOdometry(_params(), n_streams=B, initial_poses=np.stack([t[0] for t in trajs]),
                                 mesh=[torch.device("cpu")], mesh_axis="anything", device="cpu"), scans)
    assert isinstance(one, ShardedFleetOdometry) and isinstance(one, FleetOdometry)
    _assert_same_fleet(one, lo_runs["VOXEL_HASH_MAP", "unsharded"][0], B)


@pytest.mark.parametrize("map_type", ["VOXEL_HASH_MAP", "OCCUPANCY_GRID_MAP"])
def test_two_shards_equal_unsharded(lo_runs, lo_scans, map_type):
    trajs = lo_scans[0]
    two, plain = lo_runs[map_type, "two"][0], lo_runs[map_type, "unsharded"][0]
    _assert_same_fleet(two, plain, B)
    assert two.frame_count == plain.frame_count == N_FRAMES
    assert all(rt.value == "success" for s in range(B) for _, rt in two.deferred_results[s])
    for s in range(B):
        np.testing.assert_array_equal(two.get_odometry(s), plain.get_odometry(s))
        assert np.linalg.norm(two.get_odometry(s)[:3, 3] - trajs[s][-1][:3, 3]) < 0.1
    # the shards' stage times add up to the fleet's
    assert set(two.processing_times) == set(plain.processing_times)
    assert two.processing_times["3. registration"] == pytest.approx(
        sum(sh.processing_times["3. registration"] for sh in two._shards))


@pytest.mark.parametrize("map_type", ["VOXEL_HASH_MAP", "OCCUPANCY_GRID_MAP"])
def test_counters_add_up_over_shard_threads(lo_runs, map_type):
    fleet, counts = lo_runs[map_type, "two"]
    plain_counts = lo_runs[map_type, "unsharded"][1]
    assert len(fleet.shard_counts) == len(counts) == N_FRAMES
    for i, ((reads, launches), shards) in enumerate(zip(counts, fleet.shard_counts)):
        assert reads == sum((sh["reads"] for sh in shards), Counter()), f"frame {i}"
        assert launches == sum((sh["launches"] for sh in shards), Counter()), f"frame {i}"
        assert all(sh["reads"] for sh in shards)
    # each shard launches as the unsharded fleet does (its align loop may run
    # fewer iterations, to its own slowest stream)
    for (_, launches), (_, plain) in zip(counts[1:], plain_counts[1:]):
        assert launches["knn_k_batched"] == 2 * plain["knn_k_batched"]
        assert plain["nn1_batched"] <= launches["nn1_batched"] <= 2 * plain["nn1_batched"]


def test_counters_are_exact_across_threads():
    sync.reset_sync_count()
    cuda_knn.reset_launch_counts()
    n, per_thread = 4, 3000
    start = threading.Barrier(n)
    mine = [None] * n

    def count(t):
        reads, launches = Counter(sync.thread_reads()), Counter(cuda_knn.thread_launches())
        start.wait()
        for _ in range(per_thread):
            sync.to_host(torch.ones(()))
            cuda_knn.count_launch("nn1_batched")
        mine[t] = (sum((sync.thread_reads() - reads).values()),
                   (cuda_knn.thread_launches() - launches)["nn1_batched"])

    threads = [threading.Thread(target=count, args=(t,)) for t in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sync.counts["host_syncs"] == sum(sync.by_source.values()) == n * per_thread
    assert cuda_knn.launch_counts["nn1_batched"] == n * per_thread
    assert mine == [(per_thread, per_thread)] * n


def test_a_waiting_thread_gives_up_its_host_turn():
    turn, seen = threading.Lock(), []

    def shard():
        sync.set_host_turn(turn)
        with turn:
            with sync.waiting():  # as the shard's reads of the card and its exchanges wait
                seen.append(turn.acquire(blocking=False))
                turn.release()
            seen.append(turn.locked())

    t = threading.Thread(target=shard)
    t.start()
    t.join()
    assert seen == [True, True]
    with sync.waiting():  # a thread without a turn (the caller's, an unsharded fleet's) just waits
        pass


def test_two_shards_grow_as_the_unsharded_fleet():
    trajs = stream_trajectories(2, GROW_FRAMES)
    trajs[1] = [trajs[1][0]] * GROW_FRAMES  # stream 1 stands still: no keyframe after the first frame
    scans = _scans(trajs)
    init = np.stack([t[0] for t in trajs])
    p = _params(map_capacity=1 << 10)
    fleets, retried = [], []
    for mesh in (None, CPU2):
        fleet = FleetOdometry(p, n_streams=2, initial_poses=init, mesh=mesh, device="cpu")
        for f in (fleet._shards if mesh else [fleet]):  # a drop after the first frame
            f._t.submap.map_config = dataclasses.replace(f._t.submap.map_config, max_probes=8)
            if mesh:
                def spy(pend, _retry=f._retry_after_drop, _rank=f._rank):
                    retried.append((_rank, pend.frame_index, bool(pend.is_kf.any())))
                    return _retry(pend)
                f._retry_after_drop = spy
        for i, frame in enumerate(scans):  # the clock starts at 10 s: no keyframe for the time since 0
            pts, mask = stacked_frame(frame)
            fleet.process_batch(PointCloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask)), 10.0 + 0.1 * i)
        fleet.flush()
        fleets.append(fleet)
    plain, two = fleets
    _assert_same_fleet(two, plain, 2)
    assert two.growth_events and two.map_capacity > 1 << 10
    assert plain._reconciled_until >= 1  # a frame after the first dropped and was retried
    # shard 1 took part in the retry with no keyframe: it grew and inserted nothing
    assert (1, plain._reconciled_until, False) in retried and (0, plain._reconciled_until, True) in retried
    assert [sh._reconciled_until for sh in two._shards] == [plain._reconciled_until] * 2
    assert [sh.map_capacity for sh in two._shards] == [plain.map_capacity] * 2
    assert all(sh.growth_events == plain.growth_events for sh in two._shards)
    assert (np_(two.map_state.dropped) == 0).all()
    assert two.map_state.coords.shape[:2] == (2, two.map_capacity)


def test_fleet_lio_two_shards_equal_unsharded():
    world = lio_world()
    vels = [np.array([2.0, 0.0, 0.0]), np.zeros(3), np.array([0.0, -1.5, 0.0]), np.array([1.0, 1.0, 0.0])]
    starts = [np.zeros(3), np.array([1.0, 0.0, 0.0]), np.array([0.0, 3.0, 0.0]), np.array([-2.0, 0.0, 0.0])]

    def T_at(s, t):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = starts[s] + vels[s] * t
        return T

    def imu(s):
        return np.array([0.0, 0.0, 0.02 * s], np.float32), np.array([0.05 * s, 0.0, G], np.float32)

    params = params_from_reference(lio_params())
    init = np.stack([T_at(s, 0.0) for s in range(B)])
    fleets = [FleetLIO(params, n_streams=B, initial_poses=init, mesh=mesh, device="cpu") for mesh in (None, CPU2)]
    assert isinstance(fleets[1], ShardedFleetLIO) and fleets[1].x is None
    for t in np.arange(-0.2, 0.1 * N_FRAMES + 0.01, 1.0 / 200):
        for s in range(B):
            for f in fleets:
                f.add_imu_measurement(s, TMeas(timestamp=10.0 + float(t), gyro=imu(s)[0], accel=imu(s)[1]))
    for i in range(N_FRAMES):
        pts, mask = stacked_frame([lio_scan_at(world, T_at(s, 0.1 * i)) for s in range(B)])
        for f in fleets:
            f.process_batch(PointCloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask)), 10.0 + 0.1 * i)
            if i == 0:  # the known velocities, set as fleet_replay.run_fleet_lio_replay sets them
                f.x = f.x._replace(velocity=torch.from_numpy(np.stack(vels).astype(np.float32)))
                f.velocity_np = np.stack(vels).astype(np.float32)
    for f in fleets:
        f.flush()
    plain, two = fleets
    _assert_same_fleet(two, plain, B)
    assert any(k not in (0, N_FRAMES - 1) for k in two.keyframe_counts), two.keyframe_counts  # mixed keyframes
    for name, a, b in zip(plain.x._fields, plain.x, two.x):
        np.testing.assert_array_equal(np_(a), np_(b), err_msg=name)
    np.testing.assert_array_equal(np_(plain.P), np_(two.P))
    for name in ("gyro_bias_np", "accel_bias_np", "velocity_np"):
        np.testing.assert_array_equal(getattr(plain, name), getattr(two, name), err_msg=name)
    assert two.align_loops == plain.align_loops


def test_two_shards_match_jax_sharded_fleet():
    trajs = stream_trajectories(2, N_FRAMES)
    scans = _scans(trajs)
    jp = _every_point(small_params())
    init = np.stack([t[0] for t in trajs])
    jf = JFleet(jp, n_streams=2, initial_poses=init, mesh=make_mesh(2, axis="streams"))
    for i, frame in enumerate(scans):
        pts, mask = stacked_frame(frame)
        jf.process_batch(JCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask)), 0.1 * i)
    jf.flush()
    tf = run_port(FleetOdometry(params_from_reference(jp), n_streams=2, initial_poses=init, mesh=CPU2,
                                device="cpu"), scans)
    for s in range(2):
        assert [(i, rt.value) for i, rt in tf.deferred_results[s]] == \
            [(i, rt.value) for i, rt in jf.deferred_results[s]]
        for (i, _, T, _), (ji, _, jT, _) in zip(tf.pose_log[s], jf.pose_log[s], strict=True):
            jT = np.asarray(jT)
            assert i == ji
            np.testing.assert_allclose(T[:3, 3], jT[:3, 3], atol=JAX_TRANS_M)
            np.testing.assert_allclose(T[:3, :3], jT[:3, :3], atol=JAX_ROT)
    assert tf.growth_events == [] and jf.growth_events == []


def test_a_shard_exception_reaches_the_caller(lo_scans):
    trajs, scans = lo_scans
    fleet = FleetOdometry(_params(), n_streams=B, initial_poses=np.stack([t[0] for t in trajs]), mesh=CPU2,
                          device="cpu")

    def fails(*args, **kwargs):
        raise ArithmeticError("shard 1 fails")

    fleet._shards[1]._bootstrap_streams = fails  # shard 0 then waits for it in an exchange
    pts, mask = stacked_frame(scans[0])
    frame = PointCloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask))
    with pytest.raises(ArithmeticError, match="shard 1 fails"):
        fleet.process_batch(frame, 0.0)
    with pytest.raises(RuntimeError, match="out of step"):
        fleet.process_batch(frame, 0.1)
    # a refusal inside the shards' constructors reaches the caller too
    lp = params_from_reference(lio_params())
    imu = lp.imu
    with pytest.raises(ValueError, match="initial_alignment"):
        FleetLIO(dataclasses.replace(lp, imu=dataclasses.replace(
            imu, initial_alignment=dataclasses.replace(imu.initial_alignment, enable=True))), mesh=CPU2, device="cpu")


def test_sharded_refusals():
    p = _params()
    before = {t.ident for t in threading.enumerate()}
    for mesh, n, error, match in (
            (CPU2, 3, ValueError, "3 streams do not split evenly over the 2 devices"),
            ([], 2, ValueError, "empty"),
            (["cpu", "meta"], 2, ValueError, "meta is not a cpu device"),
            ([object()], 2, TypeError, "device"),
    ):
        with pytest.raises(error, match=match):
            FleetOdometry(p, n_streams=n, mesh=mesh, device="cpu")
        # refused before any thread or state was made
        assert not [t for t in threading.enumerate() if t.name.startswith("fleet shard") and t.ident not in before]
    with pytest.raises(ValueError, match="do not split evenly"):
        FleetLIO(params_from_reference(lio_params()), n_streams=3, mesh=CPU2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            FleetOdometry(p, n_streams=2, mesh=["cuda:0"], device="cuda")
    fleet = FleetOdometry(p, n_streams=2, mesh=CPU2, device="cpu")
    with pytest.raises(ValueError, match="2 streams"):
        fleet.process_batch(PointCloud(points=torch.zeros(3, 8, 3), mask=torch.ones(3, 8, dtype=torch.bool)), 0.0)
    np.testing.assert_array_equal(fleet.get_odometry(1), np.eye(4, dtype=np.float32))
    assert fleet.precompile_growth(1 << 20) == 0 and fleet.map_state.coords.shape[0] == 2
