"""The benchmark's traffic generator at a tiny size on the CPU."""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

from port_bench import traffic_gen

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rect_distance(xy: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Distance ``[P, K]`` from points ``[P, 2]`` to rectangles ``[K, 2]``."""
    d = np.maximum(np.maximum(lo[None] - xy[:, None], xy[:, None] - hi[None]), 0.0)
    return np.hypot(d[..., 0], d[..., 1])


def tiny(streams=3, loop=24, imu_hz=0):
    tp = traffic_gen.load(os.path.join(HERE, "traffic", "loop256.json"))
    tp = copy.deepcopy(tp)
    tp.update(streams=streams, rays_azimuth=64, rays_rings=8, imu_hz=imu_hz)
    tp["track"]["loop_frames"] = loop
    return tp


@pytest.mark.parametrize("name", ["loop256", "loop256_imu200"])
@pytest.mark.parametrize("seed", [0, 2**31 + 7, -5])
def test_no_stream_drives_within_clearance_of_a_box(name, seed):
    tp = copy.deepcopy(traffic_gen.load(os.path.join(HERE, "traffic", f"{name}.json")))
    tp["streams"] = 8
    lo, hi, ok = traffic_gen.make_worlds(tp, seed)
    track = traffic_gen.track_xy(tp["track"]["radius_m"], 50_000)  # ~6 mm apart
    clear = tp["world"]["track_clearance_m"]
    for s in range(tp["streams"]):
        d = rect_distance(track, lo[s, ok[s], :2], hi[s, ok[s], :2])
        assert d.size == 0 or d.min() > clear - 0.01
        assert ok[s].sum() > 0  # the world keeps boxes


def test_streams_start_at_their_own_place_of_the_loop():
    tp = tiny(streams=4, loop=24)
    ph = traffic_gen.phases(tp)
    assert ph.tolist() == [0, 6, 12, 18]
    rep = traffic_gen.make_replay(tp, 1, "cpu")
    assert np.array_equal(rep.start_poses(), traffic_gen.track_poses(tp)[ph].astype(np.float32))


def test_every_seed_hands_out_the_same_worlds_in_another_order():
    tp = tiny(streams=8)
    a = traffic_gen.make_worlds(tp, 1)
    b = traffic_gen.make_worlds(tp, 2)
    assert not np.allclose(a[0][0], a[0][1])
    assert not np.allclose(a[0], b[0])
    assert np.array_equal(a[0], traffic_gen.make_worlds(tp, 1)[0])
    key = lambda w: sorted(map(tuple, w[0].reshape(len(w[0]), -1).round(9)))  # noqa: E731
    assert key(a) == key(b)


@pytest.mark.cuda
def test_the_cards_raycast_is_the_plain_one():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the raycast kernel is Triton)")
    tp = tiny(streams=3)
    tp["rays_azimuth"], tp["rays_rings"] = 1024, 32
    dev = torch.device("cuda")
    lo, hi, ok = traffic_gen.make_worlds(tp, 5)
    gen = torch.Generator(device=dev).manual_seed(5)
    dirs = traffic_gen.ray_dirs(tp, gen, dev)
    P = traffic_gen.track_poses(tp)[:4]
    R = torch.as_tensor(np.repeat(P[:, None, :3, :3], 3, 1), dtype=torch.float32, device=dev)
    o = torch.as_tensor(np.repeat(P[:, None, :3, 3], 3, 1), dtype=torch.float32, device=dev)
    args = (torch.as_tensor(lo, dtype=torch.float32, device=dev), torch.as_tensor(hi, dtype=torch.float32, device=dev),
            torch.as_tensor(ok, device=dev), tp["world"]["wall_radius_m"])
    a = traffic_gen.raycast_frames(dirs, R, o, *args)
    b = traffic_gen.raycast_frames_triton(dirs, R, o, *args)
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    assert float((fa != fb).float().mean()) < 1e-4
    both = fa & fb
    assert float(((a - b).abs() / a.abs().clamp_min(1.0))[both].max()) < 1e-4


def test_the_loop_closes():
    tp = tiny(loop=324)
    P = traffic_gen.track_poses(tp)
    assert P.shape == (324, 4, 4)
    step = np.linalg.norm(P[1:, :3, 3] - P[:-1, :3, 3], axis=1)
    wrap = np.linalg.norm(P[0, :3, 3] - P[-1, :3, 3])
    # the last frame steps onto the first as the first onto the second:
    # the replay cycles without a jump
    assert abs(wrap - step[0]) < 1e-9
    assert step.max() < 2 * traffic_gen.speed(tp)
    assert abs(traffic_gen.speed(tp) - 2 * np.pi * 18 / 324) < 1e-12
    # the IMU is periodic with the loop
    g0, a0 = traffic_gen.figure8_imu(tp, 0.0)
    g1, a1 = traffic_gen.figure8_imu(tp, 324 * tp["frame_dt_s"])
    assert np.allclose(g0, g1, atol=1e-9) and np.allclose(a0, a1, atol=1e-9)


def test_replay_is_made_from_the_seed():
    tp = tiny()
    a = traffic_gen.make_replay(tp, 123, "cpu")
    b = traffic_gen.make_replay(tp, 123, "cpu")
    c = traffic_gen.make_replay(tp, 124, "cpu")
    assert a.points[0].shape == (24, 3, 64 * 8, 3) and a.mask[0].shape == (24, 3, 64 * 8)
    assert torch.equal(a.points[0], b.points[0]) and torch.equal(a.mask[0], b.mask[0])
    assert not torch.equal(a.points[0], c.points[0])
    r = a.points[0].norm(dim=-1)
    assert bool(((r > tp["min_range_m"]) & (r < tp["max_range_m"]))[a.mask[0]].all())
    assert float(a.mask[0].float().mean()) > 0.3
    p, m = a.frame(25)  # the loop cycles
    assert torch.equal(p, a.points[0][1]) and torch.equal(m, a.mask[0][1])
    assert torch.equal(a.scan(25, 2)[0], a.points[0][1, 2])


def test_replay_split_over_devices_keeps_each_streams_place():
    tp = tiny(streams=4)
    two = traffic_gen.make_replay(tp, 9, ["cpu", "cpu"])
    assert len(two.points) == 2 and two.streams == 4
    p, m = two.frame(3)
    assert torch.equal(p[2], two.points[1][3, 0]) and torch.equal(two.scan(3, 3)[1], two.mask[1][3, 1])
    # the streams' poses and worlds do not depend on the split
    one = traffic_gen.make_replay(tp, 9, "cpu")
    assert np.array_equal(one.start_poses(), two.start_poses())


def test_imu_feed_covers_each_frame():
    tp = tiny(imu_hz=200)
    t1 = traffic_gen.imu_times(tp, 1)
    assert t1[0] == pytest.approx(0.0) and t1[-1] == pytest.approx(0.1) and len(t1) == 21
    t0 = traffic_gen.imu_times(tp, 0)
    assert t0[0] == pytest.approx(-0.05) and t0[-1] == pytest.approx(0.0)


def test_traffic_files_are_plain_data():
    for name in os.listdir(os.path.join(HERE, "traffic")):
        with open(os.path.join(HERE, "traffic", name)) as f:
            json.load(f)
