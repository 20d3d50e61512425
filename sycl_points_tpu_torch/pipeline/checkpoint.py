"""Odometry checkpoint and resume.

Counterpart of :mod:`sycl_points_tpu.pipeline.checkpoint`, in the same
``.npz`` layout, key for key: the pose and velocity bookkeeping, the keyframe
poses, the map's arrays (``map_<field>``, voxel hash or occupancy grid), the
15-DOF state and covariance of the LIO (``x_<field>``, ``P_post``), and a
``__meta__`` JSON blob whose ``kind`` is the class name. A checkpoint written
by either package loads into the other; ``LidarOdometry`` and
``PipelinedLidarOdometry`` take each other's, and so do the two LIO classes.

Two keys go beyond the JAX layout: ``prev_Hraw`` and ``prev_inlier``, the
previous raw Hessian and inlier count that the LiDAR frames' adaptive motion
predictor damps the next guess with. Without them a resumed frame starts from
another guess than the uninterrupted run, and converges elsewhere within the
solver's tolerance; the JAX loader ignores them, and a checkpoint without
them resumes with the first frame's damping, as the JAX package resumes. No
generator state is saved (the JAX format has none), so a resumed run draws
other samples than an uninterrupted one: the two agree bit for bit only with
every sampling stage taking all the points.
"""

from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import torch

from sycl_points_tpu_torch.convert import lio_state_from_reference, map_state_from_reference, og_state_from_reference
from sycl_points_tpu_torch.points.point_cloud import PointCloud

_COMPATIBLE = {
    frozenset({"LidarOdometry", "PipelinedLidarOdometry"}),
    frozenset({"LidarInertialOdometry", "PipelinedLidarInertialOdometry"}),
}


def _flatten(prefix: str, state) -> dict:
    """``{prefix + field: numpy array}`` of a dataclass or NamedTuple of tensors."""
    names = [f.name for f in dataclasses.fields(state)] if dataclasses.is_dataclass(state) else state._fields
    return {f"{prefix}{name}": getattr(state, name).detach().cpu().numpy() for name in names}


def save_checkpoint(path: str, odometry) -> None:
    """Write the state of a ``LidarOdometry`` / ``LidarInertialOdometry`` (or
    a pipelined subclass, whose frames in flight are resolved first: the host
    mirrors that the device carry is rebuilt from on resume are then
    current) to ``path`` (``.npz``)."""
    if hasattr(odometry, "flush"):
        odometry.flush()
    sm = odometry.submap
    data = {
        "odom": np.asarray(odometry.odom),
        "prev_odom": np.asarray(odometry.prev_odom),
        "dt": np.float64(odometry.dt),
        "last_frame_time": np.float64(odometry.last_frame_time),
        "is_first_frame": np.bool_(odometry.is_first_frame),
        "frame_count": np.int64(getattr(odometry, "frame_count", 0)),
        "keyframe_poses": np.stack(sm.keyframe_poses),
        "last_keyframe_pose": np.asarray(sm.last_keyframe_pose),
        "last_keyframe_time": np.float64(sm.last_keyframe_time),
        "extract_capacity": np.int64(sm.extract_capacity),
    }
    data.update(_flatten("map_", sm.map_state))
    meta = {"kind": type(odometry).__name__, "is_occupancy": sm.is_occupancy}
    if hasattr(odometry, "linear_velocity"):
        data["linear_velocity"] = np.asarray(odometry.linear_velocity)
        data["angular_velocity"] = np.asarray(odometry.angular_velocity)
        if odometry._prev_Hraw_np is not None:
            data["prev_Hraw"] = np.asarray(odometry._prev_Hraw_np, np.float32)
            data["prev_inlier"] = np.int64(odometry._prev_inlier)
    if hasattr(odometry, "x"):
        data.update(_flatten("x_", odometry.x))
        data["P_post"] = odometry.P_post.detach().cpu().numpy()
        data["imu_R_world_at_reset"] = np.asarray(odometry.imu_R_world_at_reset)
        data["imu_v_world_at_reset"] = np.asarray(odometry.imu_v_world_at_reset)
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **data)


def load_checkpoint(path: str, odometry) -> None:
    """Restore a saved state into a freshly made odometry of a compatible
    kind, built with the same parameters (the map may have grown since: its
    capacity and extract tier come from the file). Raises ``ValueError`` for
    a checkpoint of another kind."""
    with np.load(path, allow_pickle=False) as npz:
        z = dict(npz)
    meta = json.loads(bytes(z["__meta__"]).decode())
    kinds = {meta["kind"], type(odometry).__name__}
    if len(kinds) > 1 and frozenset(kinds) not in _COMPATIBLE:
        raise ValueError(f"checkpoint is for {meta['kind']}, not {type(odometry).__name__}")
    # a pipelined frame rebuilds its device carry from the host mirrors
    if hasattr(odometry, "_carry"):
        odometry._carry = None
        odometry._pending.clear()

    odometry.odom = z["odom"]
    odometry.prev_odom = z["prev_odom"]
    odometry.dt = float(z["dt"])
    odometry.last_frame_time = float(z["last_frame_time"])
    odometry.is_first_frame = bool(z["is_first_frame"])
    if "frame_count" in z:  # keeps the frame indices after a resume monotone
        odometry.frame_count = int(z["frame_count"])
    sm = odometry.submap
    sm.keyframe_poses = list(z["keyframe_poses"])
    sm.last_keyframe_pose = z["last_keyframe_pose"]
    sm.last_keyframe_time = float(z["last_keyframe_time"])

    # the map, in the slots it was saved in; a field the file lacks (a
    # counter newer than the checkpoint) keeps the fresh map's value
    fields = [f.name for f in dataclasses.fields(sm.map_state)]
    saved = SimpleNamespace(**{
        f: z[f"map_{f}"] if f"map_{f}" in z else getattr(sm.map_state, f).cpu().numpy() for f in fields})
    loaded_cap = int(saved.coords.shape[0])
    sm.map_config = dataclasses.replace(sm.map_config, capacity=loaded_cap)
    sm.extract_capacity = int(z["extract_capacity"]) if "extract_capacity" in z else sm.extract_tier_for(loaded_cap)
    sm.map_state = (og_state_from_reference if sm.is_occupancy else map_state_from_reference)(
        saved, device=odometry.device)
    # map_state.dropped is cumulative: a fresh mirror of 0 would read the
    # restored count as a new drop on the first resumed frame
    odometry._dropped_seen = int(saved.dropped)

    if "linear_velocity" in z and hasattr(odometry, "linear_velocity"):
        odometry.linear_velocity = z["linear_velocity"]
        odometry.angular_velocity = z["angular_velocity"]
        odometry.registrated = not odometry.is_first_frame
        if "prev_Hraw" in z:
            odometry._prev_Hraw_np = z["prev_Hraw"]
            odometry._prev_inlier = int(z["prev_inlier"])
    if "x_position" in z and hasattr(odometry, "x"):
        x, odometry.P_post = lio_state_from_reference(
            SimpleNamespace(**{n: z[f"x_{n}"] for n in odometry.x._fields}), z["P_post"], device=odometry.device)
        odometry.x = x
        odometry.imu_R_world_at_reset = z["imu_R_world_at_reset"]
        odometry.imu_v_world_at_reset = z["imu_v_world_at_reset"]
        odometry.last_imu_reset_timestamp = float(z["last_frame_time"])
        odometry.gyro_bias_np = np.asarray(z["x_gyro_bias"], np.float32)
        odometry.accel_bias_np = np.asarray(z["x_accel_bias"], np.float32)
        odometry.velocity_np = np.asarray(z["x_velocity"], np.float32)

    # the registration target, extracted from the restored map around the pose
    if not odometry.is_first_frame:
        center = torch.as_tensor(np.asarray(odometry.odom[:3, 3], np.float32), device=odometry.device)
        extracted, _ = sm._extract(sm.map_state, center)
        sm._set_target(PointCloud(points=extracted.points, mask=extracted.mask))
