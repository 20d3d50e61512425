"""Sensor-message conversion (host-side, numpy).

The port's own copy of the message boundary of
:mod:`sycl_points_tpu.points.conversion`, without ROS:

  * :func:`from_pointcloud2_bytes` parses a PointCloud2-layout byte buffer
    (field table + ``point_step`` records) into numpy arrays (xyz, and
    intensity, time, rgb, ring, ambient where present);
  * :func:`to_structured_array` / :func:`to_pointcloud2_bytes` pack a cloud
    dict back;
  * :func:`read_kitti_bin` loads KITTI Velodyne ``.bin`` scans;
  * :class:`EnhancedReflectivityCorrector`, the Ouster enhanced reflectivity
    of a scan's intensities with its ring and ambient channels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# PointField datatypes (sensor_msgs/PointField constants)
_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def from_pointcloud2_bytes(
    data: bytes,
    fields: Sequence[Tuple[str, int, int]],  # (name, offset, datatype)
    point_step: int,
    count: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Parse a PointCloud2-layout buffer into a cloud dict.

    Handles unaligned field offsets (the reference does unaligned loads,
    convert.hpp) via a numpy record view with explicit offsets.
    """
    n = count if count is not None else len(data) // point_step
    names, formats, offsets = [], [], []
    for name, offset, datatype in fields:
        names.append(name)
        formats.append(_DTYPES[datatype])
        offsets.append(offset)
    rec = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                    "itemsize": point_step})
    table = np.frombuffer(data, dtype=rec, count=n)

    cols = {name: np.ascontiguousarray(table[name]) for name in names}
    out: Dict[str, np.ndarray] = {
        "points": np.stack(
            [cols["x"], cols["y"], cols["z"]], axis=1
        ).astype(np.float32)
    }
    for cand in ("intensity", "reflectivity", "Intensity"):
        if cand in cols:
            out["intensities"] = cols[cand].astype(np.float32)
            break
    for cand in ("t", "time", "timestamp", "time_offset"):
        if cand in cols:
            ts = cols[cand].astype(np.float64)
            # normalize: seconds -> ms offsets from scan start
            ts = ts - ts.min()
            if ts.max() > 0 and ts.max() < 1.0:  # seconds
                ts = ts * 1e3
            elif ts.max() > 1e6:  # nanoseconds
                ts = ts * 1e-6
            out["timestamp_offsets"] = ts.astype(np.float32)
            break
    if "rgb" in cols or "rgba" in cols:
        packed = cols.get("rgb", cols.get("rgba"))
        p = packed.view(np.uint32) if packed.dtype.kind == "f" else packed.astype(np.uint32)
        out["rgb"] = np.stack(
            [
                ((p >> 16) & 0xFF).astype(np.float32) / 255.0,
                ((p >> 8) & 0xFF).astype(np.float32) / 255.0,
                (p & 0xFF).astype(np.float32) / 255.0,
                np.ones(n, np.float32),
            ],
            axis=1,
        )
    if "ring" in cols:
        out["ring"] = cols["ring"].astype(np.uint16)
    if "ambient" in cols:
        out["ambient"] = cols["ambient"].astype(np.float32)
    return out


def to_structured_array(cloud: Dict[str, np.ndarray]) -> np.ndarray:
    """Pack a cloud dict into a contiguous structured array (toROS2msg analog)."""
    n = len(cloud["points"])
    fields = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
    if "intensities" in cloud:
        fields.append(("intensity", np.float32))
    if "timestamp_offsets" in cloud:
        fields.append(("time", np.float32))
    rec = np.zeros(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = cloud["points"].T
    if "intensities" in cloud:
        rec["intensity"] = cloud["intensities"]
    if "timestamp_offsets" in cloud:
        rec["time"] = cloud["timestamp_offsets"]
    return rec


def to_pointcloud2_bytes(cloud: Dict[str, np.ndarray]):
    """Serialize a cloud dict into a PointCloud2-layout byte buffer.

    Returns ``(data, fields, point_step)`` with ``fields`` as
    ``(name, offset, datatype)`` tuples matching :func:`from_pointcloud2_bytes`
    — the full round trip of the reference's ``toROS2msg``
    (ros2/convert.hpp:322).  RGB is re-packed into the standard float32-viewed
    0x00RRGGBB word.
    """
    rec = to_structured_array(cloud)
    names = rec.dtype.names
    if "rgb" in cloud:
        rgbf = np.zeros(len(rec), np.float32)
        c = np.clip(cloud["rgb"][:, :3] * 255.0, 0, 255).astype(np.uint32)
        packed = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
        rgbf = packed.view(np.float32)
        new_dtype = np.dtype(
            [(n, rec.dtype.fields[n][0]) for n in names] + [("rgb", np.float32)]
        )
        rec2 = np.zeros(len(rec), dtype=new_dtype)
        for n in names:
            rec2[n] = rec[n]
        rec2["rgb"] = rgbf
        rec = rec2
        names = rec.dtype.names
    _DT_CODES = {np.dtype(np.float32): 7, np.dtype(np.float64): 8,
                 np.dtype(np.uint32): 6, np.dtype(np.int32): 5,
                 np.dtype(np.uint16): 4, np.dtype(np.int16): 3,
                 np.dtype(np.uint8): 2, np.dtype(np.int8): 1}
    fields = [
        (n, rec.dtype.fields[n][1], _DT_CODES[rec.dtype.fields[n][0]])
        for n in names
    ]
    return rec.tobytes(), fields, rec.dtype.itemsize


def read_kitti_bin(path: str) -> Dict[str, np.ndarray]:
    """KITTI Velodyne scan: float32 x,y,z,reflectance records."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return {"points": raw[:, :3].copy(), "intensities": raw[:, 3].copy()}


class EnhancedReflectivityCorrector:
    """Ouster enhanced reflectivity: ``ref_i = I_i * r_i^2`` and
    ``amb_i = ambient_i / r_i^2``, each normalized by the per-ring mean,
    smoothed across scans by an exponential moving average, then summed and
    clipped to ``[0, clip_max]``. Rings at or above ``MAX_RINGS`` give 0."""

    MAX_RINGS = 256

    def __init__(self, ema_alpha: float = 0.5):
        self.ema_alpha = ema_alpha
        self.ring_mean_ref = np.zeros(self.MAX_RINGS, np.float64)
        self.ring_mean_amb = np.zeros(self.MAX_RINGS, np.float64)
        self.ring_initialized = np.zeros(self.MAX_RINGS, bool)

    def apply(self, points: np.ndarray, intensities: np.ndarray, ring: np.ndarray, ambient: np.ndarray,
              clip_max: float = 5.0) -> np.ndarray:
        range_sq = np.sum(points * points, axis=1)
        ok = range_sq >= 1e-6
        rs = np.where(ok, range_sq, 1.0)
        en_ref = np.where(ok, intensities * rs, 0.0)
        en_amb = np.where(ok, ambient / rs, 0.0)

        r = np.clip(ring.astype(np.int64), 0, self.MAX_RINGS - 1)
        in_range = ring < self.MAX_RINGS
        w = (ok & in_range).astype(np.float64)
        cnt = np.bincount(r, weights=w, minlength=self.MAX_RINGS)
        sum_ref = np.bincount(r, weights=en_ref * w, minlength=self.MAX_RINGS)
        sum_amb = np.bincount(r, weights=en_amb * w, minlength=self.MAX_RINGS)

        seen = cnt > 0
        new_ref = np.divide(sum_ref, cnt, out=np.zeros_like(sum_ref), where=seen)
        new_amb = np.divide(sum_amb, cnt, out=np.zeros_like(sum_amb), where=seen)
        first = seen & ~self.ring_initialized
        upd = seen & self.ring_initialized
        a = self.ema_alpha
        self.ring_mean_ref[first] = new_ref[first]
        self.ring_mean_amb[first] = new_amb[first]
        self.ring_mean_ref[upd] = a * new_ref[upd] + (1 - a) * self.ring_mean_ref[upd]
        self.ring_mean_amb[upd] = a * new_amb[upd] + (1 - a) * self.ring_mean_amb[upd]
        self.ring_initialized |= seen

        mean_ref = self.ring_mean_ref[r]
        mean_amb = self.ring_mean_amb[r]
        ref_n = np.where(mean_ref > 0, en_ref / np.maximum(mean_ref, 1e-30), en_ref)
        amb_n = np.where(mean_amb > 0, en_amb / np.maximum(mean_amb, 1e-30), en_amb)
        out = np.clip(ref_n + amb_n, 0.0, clip_max)
        return np.where(in_range, out, 0.0).astype(np.float32)
