"""Wire protocol for the ROS-less live odometry transport.

The reference ships live ROS2 nodes
(``ros2/sycl_points_ros2/src/lidar_odometry_base_node.cpp:21-414``) whose
message boundary is sensor_msgs/PointCloud2 + sensor_msgs/Imu in, and
nav_msgs/Odometry + TF + map PointCloud2 out.  This module defines the
equivalent transport without ROS: a tiny length-prefixed binary framing over
any reliable byte stream (TCP / Unix domain socket / pipe), carrying the
same payloads — the point-cloud payload *is* the PointCloud2 memory layout
(field table + ``point_step``-strided records) so existing tooling can pack
and unpack it with the same code that talks to ROS
(:mod:`sycl_points_tpu_torch.points.conversion`).

This is the port's own copy of :mod:`sycl_points_tpu.apps.stream_protocol`,
byte for byte on the wire.

Frame layout (little-endian)::

    HEADER  "SPT1" | type:u8 | flags:u8 | reserved:u16 | seq:u32
            | timestamp:f64 | payload_len:u32                      (24 bytes)
    PAYLOAD payload_len bytes (type-specific, below)

Message types:

====  ===========  ===========================================================
id    name         payload
====  ===========  ===========================================================
1     POINTCLOUD   u16 n_fields; per field (u8 name_len, name, u32 offset,
                   u8 datatype); u32 point_step; u32 count; raw records —
                   exactly the PointCloud2 field table + data blob
2     IMU          gyro xyz + accel xyz, 6 x f32 (timestamp in the header)
3     POSE         u32 frame_seq; u8 result_code; 3 pad; f32 inlier_ratio;
                   f32 x7 (tx ty tz qx qy qz qw) — nav_msgs/Odometry analog
4     MAP          same encoding as POINTCLOUD (map snapshot out)
5     STATUS       UTF-8 JSON blob (telemetry: queue drops, stage times, ...)
6     BYE          empty; graceful shutdown of either side
====  ===========  ===========================================================

POINTCLOUD flag bit 0 (:data:`FLAG_WANT_MAP`) asks the server to publish a
MAP snapshot after processing that scan.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"SPT1"
_HEADER = struct.Struct("<4sBBHId I".replace(" ", ""))
HEADER_SIZE = _HEADER.size  # 24

MSG_POINTCLOUD = 1
MSG_IMU = 2
MSG_POSE = 3
MSG_MAP = 4
MSG_STATUS = 5
MSG_BYE = 6

FLAG_WANT_MAP = 1

# sensor_msgs/PointField datatype ids (matches conversion._DTYPES)
DATATYPE_OF = {
    np.dtype(np.int8): 1, np.dtype(np.uint8): 2,
    np.dtype(np.int16): 3, np.dtype(np.uint16): 4,
    np.dtype(np.int32): 5, np.dtype(np.uint32): 6,
    np.dtype(np.float32): 7, np.dtype(np.float64): 8,
}

_POSE = struct.Struct("<IB3xf7f")
_IMU = struct.Struct("<6f")


class ProtocolError(ValueError):
    pass


@dataclass
class Message:
    msg_type: int
    seq: int
    timestamp: float
    payload: bytes
    flags: int = 0


def encode(msg: Message) -> bytes:
    header = _HEADER.pack(
        MAGIC, msg.msg_type, msg.flags, 0, msg.seq, msg.timestamp,
        len(msg.payload),
    )
    return header + msg.payload


def decode_header(buf: bytes) -> Tuple[int, int, int, float, int]:
    """-> (msg_type, flags, seq, timestamp, payload_len)."""
    magic, msg_type, flags, _res, seq, ts, plen = _HEADER.unpack(buf)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    return msg_type, flags, seq, ts, plen


# -- POINTCLOUD / MAP payloads ------------------------------------------------

def encode_pointcloud_payload(
    data: bytes,
    fields: Sequence[Tuple[str, int, int]],
    point_step: int,
    count: int,
) -> bytes:
    parts = [struct.pack("<H", len(fields))]
    for name, offset, datatype in fields:
        nb = name.encode("ascii")
        if len(nb) > 255:
            raise ProtocolError("field name too long")
        parts.append(struct.pack("<B", len(nb)) + nb +
                     struct.pack("<IB", offset, datatype))
    parts.append(struct.pack("<II", point_step, count))
    parts.append(data)
    return b"".join(parts)


def decode_pointcloud_payload(
    payload: bytes,
) -> Tuple[bytes, List[Tuple[str, int, int]], int, int]:
    """-> (data, fields, point_step, count)."""
    off = 0
    (n_fields,) = struct.unpack_from("<H", payload, off)
    off += 2
    fields: List[Tuple[str, int, int]] = []
    for _ in range(n_fields):
        (nlen,) = struct.unpack_from("<B", payload, off)
        off += 1
        name = payload[off:off + nlen].decode("ascii")
        off += nlen
        f_off, dtype = struct.unpack_from("<IB", payload, off)
        off += 5
        fields.append((name, f_off, dtype))
    point_step, count = struct.unpack_from("<II", payload, off)
    off += 8
    data = payload[off:]
    if len(data) < point_step * count:
        raise ProtocolError(
            f"pointcloud payload short: {len(data)} < {point_step * count}")
    return data, fields, point_step, count


def cloud_to_payload(cloud: Dict[str, np.ndarray]) -> bytes:
    """Pack a cloud dict via the PointCloud2 packer (conversion.py)."""
    from sycl_points_tpu_torch.points.conversion import to_pointcloud2_bytes

    data, fields, point_step = to_pointcloud2_bytes(cloud)
    n = len(cloud["points"])
    return encode_pointcloud_payload(data, fields, point_step, n)


def payload_to_cloud(payload: bytes) -> Dict[str, np.ndarray]:
    from sycl_points_tpu_torch.points.conversion import from_pointcloud2_bytes

    data, fields, point_step, count = decode_pointcloud_payload(payload)
    return from_pointcloud2_bytes(data, fields, point_step, count)


# -- IMU ----------------------------------------------------------------------

def encode_imu_payload(gyro: np.ndarray, accel: np.ndarray) -> bytes:
    g = np.asarray(gyro, np.float32).ravel()
    a = np.asarray(accel, np.float32).ravel()
    return _IMU.pack(*g.tolist(), *a.tolist())


def decode_imu_payload(payload: bytes) -> Tuple[np.ndarray, np.ndarray]:
    vals = _IMU.unpack(payload[:_IMU.size])
    return (np.asarray(vals[:3], np.float32), np.asarray(vals[3:], np.float32))


# -- POSE ----------------------------------------------------------------------

def encode_pose_payload(
    frame_seq: int,
    result_code: int,
    inlier_ratio: float,
    translation: np.ndarray,
    quat_xyzw: np.ndarray,
) -> bytes:
    t = np.asarray(translation, np.float32).ravel()
    q = np.asarray(quat_xyzw, np.float32).ravel()
    return _POSE.pack(frame_seq, result_code, float(inlier_ratio),
                      t[0], t[1], t[2], q[0], q[1], q[2], q[3])


def decode_pose_payload(
    payload: bytes,
) -> Tuple[int, int, float, np.ndarray, np.ndarray]:
    """-> (frame_seq, result_code, inlier_ratio, t[3], q_xyzw[4])."""
    vals = _POSE.unpack(payload[:_POSE.size])
    frame_seq, code, inlier = vals[0], vals[1], vals[2]
    t = np.asarray(vals[3:6], np.float32)
    q = np.asarray(vals[6:10], np.float32)
    return frame_seq, code, inlier, t, q


# -- STATUS ---------------------------------------------------------------------

def encode_status_payload(status: Dict) -> bytes:
    return json.dumps(status).encode("utf-8")


def decode_status_payload(payload: bytes) -> Dict:
    return json.loads(payload.decode("utf-8"))


# -- stream helpers --------------------------------------------------------------

def read_exact(sock, n: int) -> Optional[bytes]:
    """Read exactly n bytes from a socket; None on clean EOF at a boundary."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise ProtocolError(f"truncated frame: got {got} of {n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_message(sock) -> Optional[Message]:
    head = read_exact(sock, HEADER_SIZE)
    if head is None:
        return None
    msg_type, flags, seq, ts, plen = decode_header(head)
    payload = read_exact(sock, plen) if plen else b""
    if plen and payload is None:
        raise ProtocolError("EOF inside payload")
    return Message(msg_type=msg_type, seq=seq, timestamp=ts,
                   payload=payload or b"", flags=flags)


def write_message(sock, msg: Message) -> None:
    sock.sendall(encode(msg))
