"""The port's live server and its wire protocol, on the CPU.

  * the protocol round trips of ``tests/test_stream_odometry.py`` on the
    port's copy (points rtol 1e-6, intensities exact, time offsets 1e-3 ms,
    the pose and IMU payloads rtol 1e-6), and the port's messages equal to
    the JAX module's byte for byte, so that either side's client talks to
    either side's server;
  * the keep-last queue drops the oldest and counts it;
  * IMU messages reach the odometry in arrival order before the next scan;
  * end to end over localhost: 5 scans of 128 x 16 rays through the
    ``lo_pipelined`` server: every pose after the bootstrap comes back tagged
    with its scan's seq and within 0.1 m of the truth, no scan is dropped,
    the requested map snapshot arrives, the final STATUS counts every frame,
    and the server's device work stays on its processing thread.
"""

import threading
import time

import numpy as np
import pytest

from sycl_points_tpu.apps import stream_protocol as j_sp
from sycl_points_tpu_torch.apps import stream_odometry as so
from sycl_points_tpu_torch.apps import stream_protocol as sp
from sycl_points_tpu_torch.apps.odometry_replay import make_scans, replay_params

RNG = np.random.default_rng(77)


def _cloud(n=100):
    return {
        "points": RNG.uniform(-5, 5, size=(n, 3)).astype(np.float32),
        "intensities": RNG.uniform(0, 1, size=n).astype(np.float32),
        "timestamp_offsets": np.linspace(0, 80, n).astype(np.float32),
    }


def test_protocol_pointcloud_roundtrip():
    cloud = _cloud()
    payload = sp.cloud_to_payload(cloud)
    assert payload == j_sp.cloud_to_payload(cloud)
    out = sp.payload_to_cloud(payload)
    np.testing.assert_allclose(out["points"], cloud["points"], rtol=1e-6)
    np.testing.assert_allclose(out["intensities"], cloud["intensities"])
    # the conversion takes time offsets to ms from the scan start; these are
    np.testing.assert_allclose(out["timestamp_offsets"], cloud["timestamp_offsets"], atol=1e-3)


def test_protocol_message_framing_roundtrip():
    msg = sp.Message(msg_type=sp.MSG_IMU, seq=42, timestamp=123.456,
                     payload=sp.encode_imu_payload([0.1, 0.2, 0.3], [0, 0, 9.81]), flags=sp.FLAG_WANT_MAP)
    raw = sp.encode(msg)
    assert raw == j_sp.encode(j_sp.Message(msg_type=msg.msg_type, seq=42, timestamp=123.456, payload=msg.payload,
                                           flags=msg.flags))
    mt, flags, seq, ts, plen = sp.decode_header(raw[:sp.HEADER_SIZE])
    assert (mt, flags, seq) == (sp.MSG_IMU, sp.FLAG_WANT_MAP, 42)
    assert ts == pytest.approx(123.456)
    gyro, accel = sp.decode_imu_payload(raw[sp.HEADER_SIZE:])
    np.testing.assert_allclose(gyro, [0.1, 0.2, 0.3], rtol=1e-6)
    np.testing.assert_allclose(accel, [0, 0, 9.81], rtol=1e-6)


def test_protocol_pose_roundtrip():
    t = np.array([1.5, -2.0, 0.25], np.float32)
    q = np.array([0.0, 0.0, 0.3827, 0.9239], np.float32)
    payload = sp.encode_pose_payload(7, 0, 123.0, t, q)
    assert payload == j_sp.encode_pose_payload(7, 0, 123.0, t, q)
    seq, code, inlier, t2, q2 = sp.decode_pose_payload(payload)
    assert (seq, code) == (7, 0)
    assert inlier == pytest.approx(123.0)
    np.testing.assert_allclose(t2, t)
    np.testing.assert_allclose(q2, q, atol=1e-6)


def test_protocol_status_and_bad_magic():
    st = {"frames": 3, "dropped": 0}
    assert sp.decode_status_payload(sp.encode_status_payload(st)) == st
    with pytest.raises(sp.ProtocolError):
        sp.decode_header(b"XXXX" + b"\0" * (sp.HEADER_SIZE - 4))
    with pytest.raises(sp.ProtocolError, match="short"):
        sp.decode_pointcloud_payload(sp.cloud_to_payload(_cloud(10))[:-4])


def test_keep_last_queue_drops_oldest_counted():
    q = so._KeepLastQueue(depth=3)
    for i in range(5):
        q.push(i)
    assert q.dropped == 2
    assert q.pop() == 2  # the oldest two (0, 1) were dropped
    assert len(q) == 2 and q.drain() == [3, 4] and q.pop() is None


@pytest.fixture(scope="module")
def replay():
    poses, scans = make_scans(5, 128, 16, device="cpu")
    return poses, [{"points": s.points[s.mask].numpy()} for s in scans]


def test_imu_routing_reaches_the_odometry(replay):
    poses, clouds = replay
    server = so.OdometryStreamServer(replay_params(poses[0], 1 << 12, 1 << 11),
                                     so.StreamServerConfig(pipeline="lo"), device="cpu")
    server.start()
    try:
        client = so.OdometryStreamClient("127.0.0.1", server.port, timeout=120.0)
        for i in range(10):
            client.send_imu(0.01 * i, gyro=[0, 0, 0.1], accel=[0, 0, 9.81])
        client.send_cloud(clouds[0], timestamp=0.2)  # a scan feeds the queued IMU first
        seq, code, _, t, _ = client.recv_pose()
        assert (seq, code) == (11, 1)  # the IMU messages took seqs 1-10; first_frame
        ts = [m.timestamp for m in server.pipeline.imu_buffer]
        assert ts == sorted(ts) and len(ts) == 10
        client.finish()
    finally:
        server.stop()


def test_lo_pipelined_end_to_end(replay, monkeypatch):
    poses, clouds = replay
    built_on, make = [], so._make_pipeline
    monkeypatch.setattr(so, "_make_pipeline", lambda *a: built_on.append(threading.current_thread().name) or make(*a))
    server = so.OdometryStreamServer(replay_params(poses[0], 1 << 12, 1 << 11),
                                     so.StreamServerConfig(pipeline="lo_pipelined", status_every=2), device="cpu")
    server.start()
    try:
        assert server.pipeline.device.type == "cpu" and built_on == ["spt-process"]
        client = so.OdometryStreamClient("127.0.0.1", server.port, timeout=120.0)
        for i, c in enumerate(clouds):
            client.send_cloud(c, 0.1 * (i + 1), want_map=(i == len(clouds) - 1))
            time.sleep(0.05)
        tail = client.finish()
        msgs = client.side_messages + tail
        decoded = [sp.decode_pose_payload(m.payload) for m in msgs if m.msg_type == sp.MSG_POSE]
        # scan 1 bootstraps; every later scan's pose comes back with its seq
        assert [d[0] for d in decoded] == list(range(2, len(clouds) + 1))
        assert all(d[1] == 0 for d in decoded)
        for d in decoded:
            assert np.linalg.norm(d[3] - poses[d[0] - 1][:3, 3]) < 0.1
        maps = [sp.payload_to_cloud(m.payload) for m in msgs if m.msg_type == sp.MSG_MAP]
        assert maps and len(maps[-1]["points"]) > 100 and np.isfinite(maps[-1]["points"]).all()
        status = [sp.decode_status_payload(m.payload) for m in msgs if m.msg_type == sp.MSG_STATUS]
        assert status[-1]["frames_processed"] == len(clouds)
        assert status[-1]["scan_queue_dropped"] == 0 and status[-1]["last_error"] == ""
    finally:
        server.stop()
    assert not any(t.is_alive() for t in server._threads)


def test_start_raises_what_the_processing_thread_raised():
    server = so.OdometryStreamServer(replay_params(np.eye(4)), so.StreamServerConfig(pipeline="lio_pipelined"),
                                     device="cpu")
    with pytest.raises(AttributeError, match="initial_accel_bias_sigma"):
        server.start()  # LO parameters for the LIO kind: the odometry cannot be built
    assert not any(t.is_alive() for t in server._threads)
    with pytest.raises(ValueError, match="unknown pipeline"):
        so.OdometryStreamServer(None, so.StreamServerConfig(pipeline="fleet"), device="cpu")
