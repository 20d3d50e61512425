"""Pipelined LiDAR-inertial odometry: the stats fetch resolved a few frames late.

Counterpart of :mod:`sycl_points_tpu.pipeline.pipelined_lio`: the design of
:mod:`.pipelined_odometry` on the 15-DOF frame. The filter state ``(x,
P_post)`` already chains on the device, so the keyframe bookkeeping is all
that moves there (:class:`LIOCarry`). Every frame uploads one packed IMU
window and the update-bias flag, runs the inertial step
(:meth:`~.lidar_inertial_odometry.LidarInertialOdometry._lio_step`), reads
the keyframe flag and the registration input's valid count (one read; see
:mod:`.pipelined_odometry` for why this frame reads them where JAX branches
on the device), runs the submap step on keyframes, starts the stats copy to
the host (:class:`..utils.sync.DeferredFetch`) and resolves frames whose
copy has landed, with at most ``max_in_flight`` outstanding.

Semantics that differ from the synchronous frame, as in the JAX package:

- ``process()`` returns ``success`` at once; the outcomes (``imu_only`` for
  a too-small cloud, ``error`` for a non-finite propagation) arrive later in
  :attr:`pose_log` / :attr:`deferred_results` (:meth:`flush` drains them).
- The step holds the state and covariance itself on a non-finite
  propagation, and the preintegration window restarts at every dispatched
  frame, so an error frame's IMU measurements are not integrated again into
  the next window as the synchronous frame does.
- The host mirrors of the biases and the velocity lag a few frames; they
  feed only telemetry.
- The keyframe time is carried in float64.

Constraint: ``imu.deskew.enable`` must be False. The host deskew needs the
bias and velocity mirrors fresh at dispatch, which a deferred fetch cannot
give.
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from sycl_points_tpu_torch.imu.preintegration import build_measurement_window, pack_steps, padded_steps_from_window
from sycl_points_tpu_torch.ops.knn import BruteForceKNN
from sycl_points_tpu_torch.pipeline.lidar_inertial_odometry import _S1, LidarInertialOdometry, ResultType
from sycl_points_tpu_torch.pipeline.params import LidarInertialOdometryParams
from sycl_points_tpu_torch.pipeline.submap import MAX_LOAD
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.utils.sync import DeferredFetch, to_device, to_host


class LIOCarry(NamedTuple):
    """The keyframe bookkeeping, on the device (``x`` and ``P_post`` chain
    there already)."""

    last_kf_pose: torch.Tensor  # [4, 4]
    last_kf_time: torch.Tensor  # float64


class _Pending(NamedTuple):
    stats: DeferredFetch
    sampled: Optional[PointCloud]  # None off a keyframe
    prev_map_state: object
    T_eff: torch.Tensor
    timestamp: float
    frame_index: int


class PipelinedLidarInertialOdometry(LidarInertialOdometry):
    """The 15-DOF LIO whose stats fetch resolves up to ``max_in_flight``
    frames behind dispatch."""

    def __init__(self, params: LidarInertialOdometryParams = LidarInertialOdometryParams(),
                 max_in_flight: int = 16, device: torch.device | str = "cuda"):
        if params.imu.deskew.enable:
            raise ValueError(
                "PipelinedLidarInertialOdometry requires imu.deskew.enable=False (the host deskew needs "
                "fresh per-frame bias and velocity mirrors); use the synchronous LidarInertialOdometry.")
        super().__init__(params, device=device)
        self._carry: Optional[LIOCarry] = None
        self.frame_count = 0
        self._pending: deque = deque()
        self.max_in_flight = max(1, max_in_flight)
        self.in_flight_peak = 0
        self._reconciled_until = -1
        self._load_grown_until = -1
        self.pose_log: list = []
        self.deferred_results: list = []

    def _init_carry(self) -> LIOCarry:
        return LIOCarry(
            last_kf_pose=torch.as_tensor(np.asarray(self.submap.last_keyframe_pose, np.float32), device=self.device),
            last_kf_time=torch.full((), self.submap.last_keyframe_time, dtype=torch.float64, device=self.device),
        )

    # -- the pipelined frame --------------------------------------------------
    def _process_frame(self, pre: PointCloud, timestamp: float) -> ResultType:
        t0 = time.perf_counter()
        if self._carry is None:
            self._carry = self._init_carry()
        c = self._carry
        kfp = self.params.submap.keyframe

        window = build_measurement_window(list(self.imu_buffer), self.last_imu_reset_timestamp, timestamp)
        imu_pack, update_bias = to_device(  # one host-to-device copy a frame
            self.device, pack_steps(*padded_steps_from_window(window)), [float(self._imu_bias_observable())])
        kf_dt_exceeded = (c.last_kf_time <= 0.0) | ((timestamp - c.last_kf_time) >= kfp.time_threshold_seconds)
        misc = torch.cat([c.last_kf_pose.reshape(-1), update_bias, kf_dt_exceeded.to(torch.float32)[None]])
        x_new, P_new, reg_input, T_eff, is_kf, s1, executed, _ = self._lio_step(
            pre, self.submap.submap_cloud, self.submap.submap_knn, self.x, self.P_post, imu_pack, misc)
        self.iterations_last_frame = executed
        self.x = x_new
        self.P_post = P_new
        kf_update = is_kf & (not self.submap.inserts_every_frame)
        self._carry = LIOCarry(
            last_kf_pose=torch.where(kf_update, T_eff, c.last_kf_pose),
            last_kf_time=torch.where(kf_update, torch.full_like(c.last_kf_time, timestamp), c.last_kf_time),
        )
        t0 = self._stage_end("3. registration", t0)

        n_reg, kf = to_host(s1[18:20])
        prev_map_state = self.submap.map_state
        new_map_state, target, sampled, s2 = self._submap_step(
            prev_map_state, self.submap.submap_cloud, reg_input, T_eff, kf > 0.5, self.submap._generator,
            knn_prev=self.submap.submap_knn, n_desk=int(n_reg))
        self.submap.map_state = new_map_state
        if kf > 0.5:
            self.submap.submap_cloud = target
            self.submap.submap_knn = BruteForceKNN.build(target).prepped()
        self._pending.append(_Pending(
            stats=DeferredFetch(torch.cat([s1, s2])), sampled=sampled, prev_map_state=prev_map_state,
            T_eff=T_eff, timestamp=timestamp, frame_index=self.frame_count))
        t0 = self._stage_end("4a. submap dispatch", t0)

        while self._pending and (len(self._pending) > self.max_in_flight or self._pending[0].stats.ready()):
            self._resolve_one(self._pending.popleft())
        self.in_flight_peak = max(self.in_flight_peak, len(self._pending))
        self._stage_end("4b. stats fetch", t0)

        self.frame_count += 1
        self.last_frame_time = timestamp
        self.last_imu_reset_timestamp = timestamp
        return ResultType.success

    def _resolve_one(self, pend: _Pending) -> None:
        stats = pend.stats.get().astype(np.float64)
        T_np = stats[:16].reshape(4, 4).astype(np.float32)
        (n_inlier, n_pre, n_reg, kf_flag, small_flag, finite_ok,
         iterations, error, dt_total) = stats[16:25]
        self.gyro_bias_np = stats[25:28].astype(np.float32)
        self.accel_bias_np = stats[28:31].astype(np.float32)
        self.velocity_np = stats[31:34].astype(np.float32)
        load, overflow, ext_ok, dropped, budget_lost, n_extracted = stats[_S1:_S1 + 6]

        if finite_ok < 0.5:
            rtype = ResultType.error
            self.error_message = "imu-only propagation produced non-finite state or covariance"
        elif small_flag > 0.5:
            rtype = ResultType.imu_only
            self.error_message = "point cloud size is too small; propagated with IMU only"
        else:
            rtype = ResultType.success
        self.deferred_results.append((pend.frame_index, rtype))
        self.pose_log.append((pend.frame_index, pend.timestamp, T_np, rtype))

        # host mirrors (telemetry; the filter state chains on the device)
        if rtype is not ResultType.error:
            self.prev_odom = self.odom.copy()
            self.odom = T_np.copy()
            self.imu_R_world_at_reset = T_np[:3, :3] @ self.params.imu.T_imu_to_lidar_matrix()[:3, :3]
            self.imu_v_world_at_reset = self.velocity_np
        if kf_flag > 0.5:
            self.submap.extract_overflow = int(overflow)
            self.submap.last_keyframe_cloud = pend.sampled
            self.submap._record_keyframe(T_np, pend.timestamp)
        self.submap.budget_lost = int(budget_lost)

        if pend.frame_index <= self._reconciled_until:
            return
        newest = self._pending[-1].frame_index if self._pending else pend.frame_index
        if int(dropped) - self._dropped_seen > 0:
            self.submap.map_state = pend.prev_map_state
            clouds = [pend.sampled] + [p.sampled for p in self._pending]
            poses = [T_np] + [p.T_eff for p in self._pending]
            self.submap.reconcile_chain(clouds, poses, window=self.max_in_flight + 1)
            self._reconciled_until = newest
            self._dropped_seen = to_host(self.submap.map_state.dropped)
        else:
            self._dropped_seen = int(dropped)
            if load > MAX_LOAD and pend.frame_index > self._load_grown_until:
                self.submap._grow_map(origin=T_np)
                self._load_grown_until = newest
        if self.submap.extract_overflow > 0:
            self.submap.resolve_extract_overflow(T_np)

    def flush(self) -> None:
        """Resolve every frame in flight (once, after the stream)."""
        while self._pending:
            self._resolve_one(self._pending.popleft())

    def resolve_oldest(self) -> bool:
        """Resolve the oldest frame in flight, waiting for its copy (see
        ``PipelinedLidarOdometry.resolve_oldest``)."""
        if not self._pending:
            return False
        self._resolve_one(self._pending.popleft())
        return True

    def get_odometry(self) -> np.ndarray:
        """The latest resolved pose (behind dispatch until :meth:`flush`)."""
        return self.odom.copy()
