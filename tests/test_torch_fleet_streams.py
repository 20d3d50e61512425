"""Each stream of the port's ``FleetOdometry`` against the port's own
``PipelinedLidarOdometry`` on its scans, and the fleet runner, on the CPU.

  * Three streams of ``small_params()`` (samplers on) over 5 frames, one of
    them standing still, so that after the first frames only some streams
    are keyframes; the single-stream pipeline of stream ``s`` takes its
    generators' seeds from ``fleet.stream_seeds(0, s)``. Every pose of every
    stream within 1e-5 m (and rotation entries within 1e-5) of the
    single-stream pipeline's, the same result types, and the map of each
    stream equal as a set of voxels, on both map backends. The host reads of a fleet frame do not
    grow with the stream count: at most as many as the single-stream frame
    that read the most, plus the probe rounds' spread.
  * Zero-loss growth (the JAX ``test_fleet_growth_zero_loss``): a fleet at
    2^10 shared slots and 8 probes a key (so that a keyframe's insert drops
    and the drop path runs: rollback and regrow of the whole fleet, the same
    insert again) grows, keeps nothing it dropped, and ends with per-stream
    voxel counts within max(3, 2%) of a fleet that never grows.
  * ``apps.fleet_odometry.run_fleet`` on two temporary ``.bin`` sequences of
    4 and 3 scans: a TUM file a stream with one pose a real scan (the
    padding frames dropped), every pose within 0.1 m of the truth, and the
    finished stream's pose held through its padding frame.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import np_

from sycl_points_tpu_torch.apps import fleet_odometry
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.parallel.fleet import FleetOdometry, stream_seeds
from sycl_points_tpu_torch.pipeline.pipelined_odometry import PipelinedLidarOdometry
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils import sync

from test_torch_fleet import run_port, stacked_frame, stream_trajectories
from test_torch_lo_frame import make_world, scan_at, small_params

B, N_FRAMES, CAP = 3, 5, 1 << 13
POSE_ATOL = 1e-5


@pytest.fixture(scope="module")
def scans():
    world = make_world()
    trajs = stream_trajectories(B, N_FRAMES)
    trajs[1] = [trajs[1][0]] * N_FRAMES  # stream 1 stands still: keyframes only now and then
    return trajs, [[scan_at(world, trajs[s][i]) for s in range(B)] for i in range(N_FRAMES)]


def _params(map_type):
    p = params_from_reference(small_params())
    return dataclasses.replace(p, submap=dataclasses.replace(p.submap, map_type=map_type))


def _voxels(state, b=None):
    used = np_(state.used if b is None else state.used[b])
    c = np_(state.coords if b is None else state.coords[b])[used]
    return set(map(tuple, c.tolist()))


@pytest.mark.parametrize("map_type", ["VOXEL_HASH_MAP", "OCCUPANCY_GRID_MAP"])
def test_streams_equal_single_pipelines(scans, map_type):
    trajs, frames = scans
    params = _params(map_type)
    fleet = FleetOdometry(params, n_streams=B, initial_poses=np.stack([t[0] for t in trajs]), device="cpu")
    fleet_reads, kf_mix = [], []
    step = fleet._submap_step

    def spy(*args):
        kf_mix.append(tuple(args[5]))  # is_kf
        return step(*args)

    fleet._submap_step = spy
    for i, frame in enumerate(frames):
        pts, mask = stacked_frame(frame)
        sync.reset_sync_count()
        fleet.process_batch(PointCloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask)), 0.1 * i)
        fleet_reads.append(sync.counts["host_syncs"])
    fleet.flush()
    if map_type == "VOXEL_HASH_MAP":  # some frames insert for some streams only
        assert any(any(m) and not all(m) for m in kf_mix), kf_mix

    single_reads = []
    for s in range(B):
        p = dataclasses.replace(params, pose=dataclasses.replace(params.pose, initial=tuple(trajs[s][0].ravel())))
        pl = PipelinedLidarOdometry(p, device="cpu")
        pre_seed, map_seed = stream_seeds(0, s)
        pl.pc_processor._generator.manual_seed(pre_seed)
        pl.submap._generator.manual_seed(map_seed)
        reads = []
        for i in range(N_FRAMES):
            sync.reset_sync_count()
            pl.process(PointCloud.from_numpy(frames[i][s], capacity=CAP, device="cpu"), 0.1 * i)
            reads.append(sync.counts["host_syncs"])
        pl.flush()
        single_reads.append(reads)
        assert [rt for _, rt in pl.deferred_results] == [rt for _, rt in fleet.deferred_results[s]]
        for (_, ts, T, _), (i, fts, fT, _) in zip(pl.pose_log, fleet.pose_log[s], strict=True):
            assert ts == fts
            np.testing.assert_allclose(fT[:3, 3], T[:3, 3], atol=POSE_ATOL)
            np.testing.assert_allclose(fT[:3, :3], T[:3, :3], atol=POSE_ATOL)
            assert np.linalg.norm(fT[:3, 3] - trajs[s][i][:3, 3]) < 0.1
        assert _voxels(fleet.map_state, s) == _voxels(pl.submap.map_state)
    # the fleet reads once where the single streams each read: the align
    # loop's exit tests and the probe rounds run to the slowest stream
    for i in range(1, N_FRAMES):
        assert fleet_reads[i] <= max(r[i] for r in single_reads) + 4, (fleet_reads, single_reads)


def test_fleet_growth_zero_loss():
    world = make_world()
    trajs = stream_trajectories(2, 4)
    scans = [[scan_at(world, trajs[s][i]) for s in range(2)] for i in range(4)]
    p = params_from_reference(small_params())
    p_small = dataclasses.replace(p, submap=dataclasses.replace(p.submap, map_capacity=1 << 10))
    init = np.stack([t[0] for t in trajs])
    small = FleetOdometry(p_small, n_streams=2, initial_poses=init, device="cpu")
    sm = small._t.submap
    sm.map_config = dataclasses.replace(sm.map_config, max_probes=8)
    run_port(small, scans)
    big = run_port(FleetOdometry(p, n_streams=2, initial_poses=init, device="cpu"), scans)
    assert small.growth_events and small.map_capacity > 1 << 10 and not big.growth_events
    assert small._reconciled_until >= 1  # a frame after the first dropped and was retried
    assert small.map_state.coords.shape[1] == small.map_capacity
    for s in range(2):
        ns, nb = int(small.map_state.used[s].sum()), int(big.map_state.used[s].sum())
        assert abs(ns - nb) <= max(3, 0.02 * nb), f"stream {s}: grown map diverged ({ns} vs {nb})"
        assert all(rt.value == "success" for _, rt in small.deferred_results[s])
    assert (np_(small.map_state.dropped) == 0).all() and (np_(big.map_state.dropped) == 0).all()


def test_run_fleet_on_unequal_sequences(tmp_path):
    world = make_world()
    trajs = stream_trajectories(2, 4)
    lengths = (4, 3)
    dirs = []
    for s, n in enumerate(lengths):
        d = tmp_path / f"seq{s}"
        d.mkdir()
        for i in range(n):
            pts = scan_at(world, trajs[s][i])
            np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1).astype(np.float32).tofile(
                d / f"{i:06d}.bin")
        dirs.append(sorted(str(f) for f in d.glob("*.bin")))
    params = dataclasses.replace(_params("VOXEL_HASH_MAP"),
                                 pose=dataclasses.replace(small_params().pose))
    outs = fleet_odometry.run_fleet(dirs, params, str(tmp_path / "fleet"), device="cpu",
                                    initial_poses=np.stack([t[0] for t in trajs]))
    assert len(outs) == 2
    for s, (path, n) in enumerate(zip(outs, lengths)):
        rows = np.loadtxt(path, ndmin=2)
        assert len(rows) == n  # the initial pose and one a scan after the first
        np.testing.assert_allclose(rows[:, 0], [0.0] + [0.1 * i for i in range(1, n)], atol=1e-6)
        for i in range(1, n):
            assert np.linalg.norm(rows[i, 1:4] - trajs[s][i][:3, 3]) < 0.1
    fleet = outs.fleet
    held = [T for i, _, T, _ in fleet.pose_log[1] if i >= lengths[1] - 1]
    assert len(held) == 2
    np.testing.assert_array_equal(held[0], held[1])  # the padding frame holds the finished stream's pose
    assert fleet.deferred_results[1][-1][1].value == "small_number_of_points"
