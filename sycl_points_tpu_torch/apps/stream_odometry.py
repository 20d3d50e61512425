"""Live odometry server over a socket: the ROS-less counterpart of the
reference's live nodes.

Counterpart of :mod:`sycl_points_tpu.apps.stream_odometry`, on the framing of
:mod:`.stream_protocol` (byte for byte the JAX package's, so either side's
client talks to either side's server):

* :class:`OdometryStreamServer` accepts one client at a time, reads
  POINTCLOUD / IMU messages on a reader thread into bounded keep-last queues
  (the ROS QoS ``history=keep_last, depth=N``: overflow drops the oldest
  message and counts it), and drives one of the four odometries (LO / LIO,
  synchronous / pipelined) on a processing thread. Every processed frame
  sends a POSE (the base_link pose in the odom frame); STATUS messages carry
  telemetry; MAP snapshots go out on request (flag bit) or every N frames.
* :class:`OdometryStreamClient` is a small blocking client, for tests, the
  smoke run and as a template.

The transport threads only parse bytes into numpy. All device work happens
on the processing thread: it sets its CUDA device when it starts, builds the
odometry and is the only thread that launches work, so the pipelined
frames' deferred fetches (:class:`..utils.sync.DeferredFetch`, an event on
the thread's current stream) are made and read on one thread. The server
runs on the card unless asked for the CPU, and raises without a card.

    python -m sycl_points_tpu_torch.apps.stream_odometry --pipeline lo_pipelined --port 7510
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.apps import stream_protocol as sp
from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement
from sycl_points_tpu_torch.points.point_cloud import PointCloud, pad_capacity_for
from sycl_points_tpu_torch.utils import lie_np
from sycl_points_tpu_torch.utils.sync import to_host

PIPELINES = ("lo", "lio", "lo_pipelined", "lio_pipelined")


@dataclasses.dataclass
class StreamServerConfig:
    """Transport-side settings (the node parameters of the reference's
    ``lidar_odometry_base_node.cpp:23-100``: message types, QoS queue
    depths, extrinsic, initial pose, map publishing)."""

    host: str = "127.0.0.1"
    port: int = 0  # 0: chosen by the OS; read server.port after start()
    pipeline: str = "lo"  # one of PIPELINES
    # QoS history=keep_last depths
    scan_queue_depth: int = 4
    imu_queue_depth: int = 4096
    # the scan capacity; None: derived from the first scan
    scan_capacity: Optional[int] = None
    scan_duration_sec: float = 0.1
    # T_base_link_to_lidar and the initial base_link pose
    T_base_link_to_lidar: Optional[np.ndarray] = None
    initial_base_link_pose: Optional[np.ndarray] = None
    # a MAP snapshot every N processed frames (0: only on FLAG_WANT_MAP)
    publish_map_every: int = 0
    # a STATUS telemetry message every N processed frames (0: never)
    status_every: int = 0
    # The JAX server compiles the map-growth programs up to this capacity
    # after the first frame; eager PyTorch has none to compile, and the
    # odometry's precompile_growth returns 0.
    precompile_growth_capacity: int = 0


# ResultType values (LO and LIO) -> wire result codes
RESULT_CODES = {
    "success": 0,
    "first_frame": 1,
    "waiting_initial_alignment": 2,
    "error": 3,
    "old_timestamp": 4,
    "small_number_of_points": 5,
    "imu_only": 6,
}


def result_code(rtype) -> int:
    return RESULT_CODES.get(getattr(rtype, "value", str(rtype)), 255)


class _KeepLastQueue:
    """Bounded FIFO with ROS keep-last semantics: a push beyond ``depth``
    drops the oldest element and counts it in ``dropped``."""

    def __init__(self, depth: int):
        self._dq: Deque = deque()
        self._depth = int(depth)
        self._lock = threading.Lock()
        self.dropped = 0

    def push(self, item) -> None:
        with self._lock:
            if len(self._dq) >= self._depth:
                self._dq.popleft()
                self.dropped += 1
            self._dq.append(item)

    def pop(self):
        with self._lock:
            return self._dq.popleft() if self._dq else None

    def drain(self) -> List:
        with self._lock:
            items = list(self._dq)
            self._dq.clear()
            return items

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)


def _make_pipeline(kind: str, params, device: torch.device):
    kind = kind.lower()
    if kind == "lo":
        from sycl_points_tpu_torch.pipeline.lidar_odometry import LidarOdometry

        return LidarOdometry(params, device=device)
    if kind == "lio":
        from sycl_points_tpu_torch.pipeline.lidar_inertial_odometry import LidarInertialOdometry

        return LidarInertialOdometry(params, device=device)
    if kind == "lo_pipelined":
        from sycl_points_tpu_torch.pipeline.pipelined_odometry import PipelinedLidarOdometry

        return PipelinedLidarOdometry(params, device=device)
    if kind == "lio_pipelined":
        from sycl_points_tpu_torch.pipeline.pipelined_lio import PipelinedLidarInertialOdometry

        return PipelinedLidarInertialOdometry(params, device=device)
    raise ValueError(f"unknown pipeline kind {kind!r}")


class OdometryStreamServer:
    """Socket front end around one odometry."""

    def __init__(self, params=None, config: StreamServerConfig = StreamServerConfig(),
                 device: torch.device | str = "cuda"):
        if config.pipeline.lower() not in PIPELINES:
            raise ValueError(f"unknown pipeline kind {config.pipeline!r}")
        self.device = require_device(device)
        self.config = config
        if params is None:
            from sycl_points_tpu_torch.pipeline.params import LidarInertialOdometryParams, LidarOdometryParams

            params = LidarInertialOdometryParams() if "lio" in config.pipeline else LidarOdometryParams()

        # the extrinsic and the initial pose: the odometry runs in the lidar
        # frame, poses go out for base_link
        self.T_bl = (np.asarray(config.T_base_link_to_lidar, np.float32)
                     if config.T_base_link_to_lidar is not None else np.eye(4, dtype=np.float32))
        self.T_lb = np.linalg.inv(self.T_bl).astype(np.float32)
        if config.initial_base_link_pose is not None:
            from sycl_points_tpu_torch.pipeline.params import PoseParams

            T0 = np.asarray(config.initial_base_link_pose, np.float32) @ self.T_bl
            params = dataclasses.replace(params, pose=PoseParams(initial=tuple(T0.ravel().tolist())))

        self.params = params
        self.is_pipelined = config.pipeline.lower().endswith("_pipelined")
        self.pipeline = None  # made by the processing thread in start()
        self._published_poses = 0

        self._scan_q = _KeepLastQueue(config.scan_queue_depth)
        self._imu_q = _KeepLastQueue(config.imu_queue_depth)
        self._send_lock = threading.Lock()
        self._stop = threading.Event()
        self._client: Optional[socket.socket] = None
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._wake = threading.Event()
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None
        self.port: Optional[int] = None
        self.frames_processed = 0
        self.frames_truncated_points = 0
        self.last_error = ""
        self._scan_cap = config.scan_capacity
        self._want_map_seqs: Deque[int] = deque()
        self._flush_requested = threading.Event()
        self._flushed = threading.Event()
        # the pipelined odometries log poses by their frame index: map it
        # back to the client's scan seq, so POSE.frame_seq names its scan
        self._seq_by_frame: Dict[int, int] = {}
        self._last_frame_count = 0
        # per-frame serving breakdown (bounded): queue wait, process time,
        # publish lag, stage times
        self.frame_timings: Deque[Dict] = deque(maxlen=512)
        self._emit_t: Dict[int, float] = {}
        self._arr_t: Dict[int, float] = {}
        # scan arrival -> pose sent, per seq, on the server's clock
        self.pose_e2e_ms: Deque[float] = deque(maxlen=512)
        self._growth_warmed = False

    # -- lifecycle -----------------------------------------------------------
    def start(self, timeout: float = 120.0) -> None:
        """Listen, start the threads, and return once the processing thread
        has built the odometry (raising what that raised)."""
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.config.host, self.config.port))
        self._listener.listen(1)
        self.port = self._listener.getsockname()[1]
        for target, name in ((self._process_loop, "spt-process"), (self._accept_loop, "spt-accept")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        if not self._started.wait(timeout):
            self.stop()
            raise RuntimeError(f"the processing thread did not start within {timeout} s")
        if self._start_error is not None:
            self.stop()
            raise self._start_error

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        for s in (self._client, self._listener):
            if s is not None:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
        for t in self._threads:
            t.join(timeout=timeout)

    # -- socket side -----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _addr = self._listener.accept()
            except OSError:
                return
            client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._client = client
            try:
                self._reader(client)
            except (sp.ProtocolError, OSError) as e:
                self.last_error = f"reader: {e}"
            finally:
                if self._client is client:
                    self._client = None
                try:
                    client.close()
                except OSError:
                    pass

    def _reader(self, client: socket.socket) -> None:
        while not self._stop.is_set():
            msg = sp.read_message(client)
            if msg is None:
                return
            if msg.msg_type == sp.MSG_BYE:
                # end of stream: the processing thread resolves the frames in
                # flight, then BYE tells the client that every pose went out
                self._flushed.clear()
                self._flush_requested.set()
                self._wake.set()
                self._flushed.wait(timeout=120.0)
                self._send(sp.Message(msg_type=sp.MSG_BYE, seq=0, timestamp=0.0, payload=b""))
                return
            if msg.msg_type == sp.MSG_POINTCLOUD:
                self._scan_q.push((msg, time.perf_counter()))
                self._wake.set()
            elif msg.msg_type == sp.MSG_IMU:
                self._imu_q.push(msg)
            # anything else from a client is ignored (forward compatible)

    def _send(self, msg: sp.Message) -> None:
        client = self._client
        if client is None:
            return
        try:
            with self._send_lock:
                sp.write_message(client, msg)
        except OSError as e:
            self.last_error = f"send: {e}"

    # -- processing side ---------------------------------------------------------
    def _process_loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self.pipeline = _make_pipeline(self.config.pipeline, self.params, self.device)
        except Exception as e:  # handed to start(), which raises it
            self._start_error = e
            return
        finally:
            self._started.set()
        while not self._stop.is_set():
            item = self._scan_q.pop()
            if item is None:
                if self.is_pipelined:
                    # idle with frames in flight: resolve the oldest, waiting
                    # for its copy (the card has nothing else to do), so that
                    # a client waiting for a pose gets it without another scan
                    self.pipeline.resolve_oldest()
                    self._drain_pipelined()
                if self._flush_requested.is_set() and not self._flushed.is_set():
                    self.flush()
                    self._send_status(self.telemetry())
                    self._flushed.set()
                    self._flush_requested.clear()
                self._wake.wait(timeout=0.01)
                self._wake.clear()
                continue
            msg, t_arrival = item
            self._arr_t[msg.seq] = t_arrival
            if len(self._arr_t) > 1024:
                for k in sorted(self._arr_t)[:-512]:
                    self._arr_t.pop(k, None)
            try:
                t_deq = time.perf_counter()
                self._process_scan(msg)
                t_done = time.perf_counter()
                self.frame_timings.append({
                    "seq": msg.seq,
                    "queue_wait_ms": (t_deq - t_arrival) * 1e3,
                    "process_ms": (t_done - t_deq) * 1e3,
                    "emit_lag_ms": (self._emit_t[msg.seq] - t_done) * 1e3 if msg.seq in self._emit_t else None,
                    "queue_len_after": len(self._scan_q),
                    "stage_ms": {k: v * 1e3 for k, v in self.pipeline.processing_times.items()},
                })
            except Exception as e:  # serving survives a bad frame and reports it
                self.last_error = f"process: {type(e).__name__}: {e}"
                self._send_status({"error": self.last_error, "seq": msg.seq})

    def _feed_imu(self) -> None:
        for imu_msg in self._imu_q.drain():
            gyro, accel = sp.decode_imu_payload(imu_msg.payload)
            self.pipeline.add_imu_measurement(IMUMeasurement(timestamp=imu_msg.timestamp, gyro=gyro, accel=accel))

    def _process_scan(self, msg: sp.Message) -> None:
        cloud_np = sp.payload_to_cloud(msg.payload)
        n = len(cloud_np["points"])
        if self._scan_cap is None:
            self._scan_cap = pad_capacity_for(max(n, 1))
        if n > self._scan_cap:
            # the scan outgrew its capacity: the tail is dropped, counted,
            # and the client told
            self.frames_truncated_points += 1
            self._send_status({"seq": msg.seq, "truncated_points": n - self._scan_cap,
                               "scan_capacity": self._scan_cap})
            cloud_np = {k: v[: self._scan_cap] for k, v in cloud_np.items()}
        cloud = PointCloud.from_numpy(
            cloud_np["points"], intensities=cloud_np.get("intensities"), rgb=cloud_np.get("rgb"),
            timestamp_offsets=cloud_np.get("timestamp_offsets"), capacity=self._scan_cap, device=self.device)

        self._feed_imu()
        if msg.flags & sp.FLAG_WANT_MAP:
            self._want_map_seqs.append(msg.seq)
        rtype = self.pipeline.process(cloud, msg.timestamp, scan_duration_sec=self.config.scan_duration_sec)
        self.frames_processed += 1
        if self.config.precompile_growth_capacity and not self._growth_warmed:
            self._growth_warmed = True
            self.pipeline.precompile_growth(self.config.precompile_growth_capacity, wait=False)
        if self.is_pipelined:
            fc = self.pipeline.frame_count
            if fc > self._last_frame_count:  # a frame was dispatched
                self._seq_by_frame[fc - 1] = msg.seq
                self._last_frame_count = fc
            self._drain_pipelined()
        else:
            inlier = float(getattr(self.pipeline, "_prev_inlier", 0))
            self._emit_pose(msg.seq, msg.timestamp, self.pipeline.get_odometry(), result_code(rtype), inlier)
        self._maybe_publish_map()
        if self.config.status_every and self.frames_processed % self.config.status_every == 0:
            self._send_status(self.telemetry())

    def _drain_pipelined(self) -> None:
        log = self.pipeline.pose_log
        while self._published_poses < len(log):
            frame_index, ts, T_np, rtype = log[self._published_poses]
            self._published_poses += 1
            seq = self._seq_by_frame.pop(frame_index, frame_index)
            self._emit_pose(seq, ts, T_np, result_code(rtype), 0.0)

    def _emit_pose(self, seq: int, ts: float, T_lidar: np.ndarray, code: int, inlier: float) -> None:
        now = time.perf_counter()
        self._emit_t[seq] = now
        if len(self._emit_t) > 1024:
            for k in sorted(self._emit_t)[:-512]:
                self._emit_t.pop(k, None)
        arr = self._arr_t.get(seq)
        if arr is not None:
            self.pose_e2e_ms.append((now - arr) * 1e3)
        T_base = np.asarray(T_lidar, np.float32) @ self.T_lb
        q = lie_np.matrix_to_quat(T_base[:3, :3])
        self._send(sp.Message(msg_type=sp.MSG_POSE, seq=seq, timestamp=ts,
                              payload=sp.encode_pose_payload(seq, code, inlier, T_base[:3, 3], q)))

    def _maybe_publish_map(self) -> None:
        want = bool(self._want_map_seqs)
        self._want_map_seqs.clear()
        if self.config.publish_map_every and self.frames_processed % self.config.publish_map_every == 0:
            want = True
        sc = self.pipeline.submap.submap_cloud
        if not want or sc is None:
            return
        cols = [sc.points, sc.mask[:, None].to(sc.points.dtype)]
        if sc.intensities is not None:
            cols.append(sc.intensities[:, None])
        rows = np.asarray(to_host(torch.cat(cols, dim=1)), np.float32)
        rows = rows[rows[:, 3] > 0.5]
        cloud: Dict[str, np.ndarray] = {"points": rows[:, :3].copy()}
        if sc.intensities is not None:
            cloud["intensities"] = rows[:, 4].copy()
        self._send(sp.Message(msg_type=sp.MSG_MAP, seq=self.frames_processed, timestamp=time.time(),
                              payload=sp.cloud_to_payload(cloud)))

    def _send_status(self, status: Dict) -> None:
        self._send(sp.Message(msg_type=sp.MSG_STATUS, seq=self.frames_processed, timestamp=time.time(),
                              payload=sp.encode_status_payload(status)))

    def telemetry(self) -> Dict:
        timings = list(self.frame_timings)

        def agg(vals):
            vals = [v for v in vals if v is not None]
            if not vals:
                return None
            return {"median": float(np.median(vals)), "p90": float(np.percentile(vals, 90)),
                    "max": float(np.max(vals))}

        return {
            "frames_processed": self.frames_processed,
            "scan_queue_dropped": self._scan_q.dropped,
            "imu_queue_dropped": self._imu_q.dropped,
            "frames_truncated_points": self.frames_truncated_points,
            "processing_times": dict(self.pipeline.processing_times) if self.pipeline is not None else {},
            "queue_wait_ms": agg([t["queue_wait_ms"] for t in timings]),
            "process_ms": agg([t["process_ms"] for t in timings]),
            "pose_e2e_server_ms": agg(list(self.pose_e2e_ms)),
            "last_error": self.last_error,
        }

    def flush(self) -> None:
        """Resolve the pipelined frames in flight and send their poses."""
        if self.is_pipelined:
            self.pipeline.flush()
            self._drain_pipelined()


class OdometryStreamClient:
    """Blocking client: sends scans and IMU, receives poses, maps, status."""

    def __init__(self, host: str, port: int, timeout: float = 600.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._seq = 0
        # messages other than POSE received by recv_pose()
        self.side_messages: List[sp.Message] = []

    def close(self) -> None:
        try:
            sp.write_message(self.sock, sp.Message(msg_type=sp.MSG_BYE, seq=self._seq, timestamp=0.0, payload=b""))
        except OSError:
            pass
        self.sock.close()

    def finish(self) -> list:
        """End of stream: send BYE, collect every message still to come (late
        pipelined poses, the final STATUS) up to the server's BYE, and close.
        Returns the collected messages."""
        sp.write_message(self.sock, sp.Message(msg_type=sp.MSG_BYE, seq=self._seq, timestamp=0.0, payload=b""))
        tail = []
        while True:
            msg = self.recv()
            if msg is None or msg.msg_type == sp.MSG_BYE:
                break
            tail.append(msg)
        self.sock.close()
        return tail

    def send_cloud(self, cloud: Dict[str, np.ndarray], timestamp: float, want_map: bool = False) -> int:
        self._seq += 1
        sp.write_message(self.sock, sp.Message(
            msg_type=sp.MSG_POINTCLOUD, seq=self._seq, timestamp=timestamp, payload=sp.cloud_to_payload(cloud),
            flags=sp.FLAG_WANT_MAP if want_map else 0))
        return self._seq

    def send_imu(self, timestamp: float, gyro, accel) -> None:
        self._seq += 1
        sp.write_message(self.sock, sp.Message(msg_type=sp.MSG_IMU, seq=self._seq, timestamp=timestamp,
                                               payload=sp.encode_imu_payload(gyro, accel)))

    def recv(self) -> Optional[sp.Message]:
        return sp.read_message(self.sock)

    def recv_pose(self) -> Tuple[int, int, float, np.ndarray, np.ndarray]:
        """Block until the next POSE; returns its payload decoded
        ``(frame_seq, result_code, inlier, t[3], q_xyzw[4])``. Other messages
        received meanwhile go to :attr:`side_messages`."""
        while True:
            msg = self.recv()
            if msg is None:
                raise ConnectionError("server closed the stream")
            if msg.msg_type == sp.MSG_POSE:
                return sp.decode_pose_payload(msg.payload)
            self.side_messages.append(msg)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Live odometry server (ROS-less transport)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7510)
    ap.add_argument("--pipeline", default="lo", choices=PIPELINES)
    ap.add_argument("--config", default=None, help="YAML parameter file")
    ap.add_argument("--scan-capacity", type=int, default=None)
    ap.add_argument("--publish-map-every", type=int, default=0)
    ap.add_argument("--status-every", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    params = None
    if args.config:
        from sycl_points_tpu_torch.pipeline.params import LidarInertialOdometryParams, LidarOdometryParams, load_params

        params = load_params(args.config, LidarInertialOdometryParams if "lio" in args.pipeline
                             else LidarOdometryParams)
    cfg = StreamServerConfig(host=args.host, port=args.port, pipeline=args.pipeline,
                             scan_capacity=args.scan_capacity, publish_map_every=args.publish_map_every,
                             status_every=args.status_every)
    server = OdometryStreamServer(params, cfg, device=args.device)
    server.start()
    print(f"odometry stream server on {cfg.host}:{server.port} pipeline={cfg.pipeline} device={server.device}",
          flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
