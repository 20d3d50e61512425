"""Pipelined LiDAR odometry: the frame-to-frame state on the device, and the
one stats fetch a frame resolved a few frames late.

Counterpart of :mod:`sycl_points_tpu.pipeline.pipelined_odometry`. The
synchronous :class:`~.lidar_odometry.LidarOdometry` reads ``stats1`` after
the registration and ``stats2`` after the submap step, and decides the
keyframe, the sampler and the motion prediction on the host. This subclass
reads neither:

- **The state lives on the device** in an :class:`OdomCarry` (pose, the EMA
  velocities, keyframe bookkeeping, the previous raw result for the adaptive
  motion predictor and the MAP prior). The host passes only ``dt`` and the
  timestamp as Python numbers.
- **The motion predictor runs on the device** (constant velocity with the
  degeneracy-adaptive damping, the 3x3 eigenvalues by
  :func:`..utils.eigh3.eigvalsh3`), and so do the min-points gate (a device
  ``small`` flag chosen with ``torch.where``) and the keyframe decision.
- **The stats fetch is deferred**: every frame starts its copy to the host
  (:class:`..utils.sync.DeferredFetch`, a pinned buffer and a CUDA event)
  and frames resolve, oldest first, once their copy has landed, with at most
  ``max_in_flight`` outstanding; only a full window waits.

Where the JAX package gates the submap step with ``lax.cond`` on the device
keyframe flag, this frame reads the flag and the valid count of the
registration input (two numbers, one read, made when the align loop's last
exit test has already drained the stream) and runs the synchronous frame's
submap step (:func:`.fused_submap.make_submap_step`) on keyframes only.
Eager PyTorch has no device-side branch: doing a keyframe's work on every
frame and selecting on the device made the frame 1.6-2.5x the synchronous
one on the voxel-hash tree (H100, PERF.md), and the sampler then draws what
the synchronous frame draws.

Eager PyTorch also reads the device where a loop's exit depends on the
data: once an iteration in the align loop, in the hash table's probe loops
and at the extraction's overflow branch. Those reads drain the stream, so on
the card no frame is still in flight when ``process`` returns; every read is
counted by source in :data:`..utils.sync.by_source`.

The rare drop-retry path reconciles the whole window: on a drop seen at
frame *j* the map rolls back to *j*'s stashed state from before its insert
and :meth:`..submap.Submap.reconcile_chain` re-applies the stashed samples
of *j* and every later frame in flight (their poses are unaffected), growing
the table until nothing is dropped. Growth decisions of frames already
reconciled are skipped. A stash is a handle, not a copy: no map operation
writes into a state's tensors.

Semantics that differ from the synchronous frame, as in the JAX package:

- ``process()`` returns ``success`` at once; the authoritative result of a
  frame arrives later in :attr:`pose_log` / :attr:`deferred_results`
  (:meth:`flush` drains the window).
- ``dt`` comes from the timestamps even across a too-small frame; the
  device carry holds the pose, the velocities and the keyframe state through
  such a frame as the synchronous frame does.
- After a drop-retry rebuild, the frame dispatched next has registered
  against the target from before the retry.
- The keyframe time is carried in float64 (float32 cannot tell one second
  from the next at the scale of a Unix time).

Constraints: the IMU must be off (its prediction and deskew are host-coupled;
use :class:`~.lidar_inertial_odometry.LidarInertialOdometry` or the
synchronous frame), so the prediction is the LiDAR constant-velocity one.

The device prediction (:meth:`PipelinedLidarOdometry._predict`), the
registration step (:meth:`~.lidar_odometry.LidarOdometry._reg_step`) and the
carry update (:meth:`PipelinedLidarOdometry._next_carry`) also take an
:class:`OdomCarry` with a leading stream axis ``[B]``, per-stream ``dt`` and
timestamps: the fleet (:mod:`sycl_points_tpu_torch.parallel.fleet`) runs its
streams' registration through them.
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from sycl_points_tpu_torch.deskew.constant_velocity import deskew_constant_velocity
from sycl_points_tpu_torch.ops.knn import BruteForceKNN
from sycl_points_tpu_torch.pipeline.lidar_odometry import _S1, LidarOdometry, ResultType
from sycl_points_tpu_torch.pipeline.params import LidarOdometryParams
from sycl_points_tpu_torch.pipeline.submap import MAX_LOAD
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.registration.map_prior import MapPriorParams
from sycl_points_tpu_torch.utils import eigh3, lie, lie_np
from sycl_points_tpu_torch.utils.smallmat import matvec3
from sycl_points_tpu_torch.utils.sync import DeferredFetch, to_host

_F32 = torch.float32


class OdomCarry(NamedTuple):
    """The frame-to-frame odometry state, on the device (a fleet's with a
    leading stream axis)."""

    odom: torch.Tensor  # [4, 4] current pose
    lin_vel: torch.Tensor  # [3] velocity from the last successful frame
    ang_vel: torch.Tensor  # [3]
    lin_smooth: torch.Tensor  # [3] EMA predictor state
    ang_smooth: torch.Tensor  # [3]
    have_smooth: torch.Tensor  # bool: EMA state initialised
    registrated: torch.Tensor  # bool: at least one successful registration
    last_kf_pose: torch.Tensor  # [4, 4]
    last_kf_time: torch.Tensor  # float64
    prev_T: torch.Tensor  # [4, 4] previous raw result pose (the prior's input)
    prev_Hraw: torch.Tensor  # [6, 6]
    prev_err_raw: torch.Tensor  # f32
    prev_inlier: torch.Tensor  # i32


class _Pending(NamedTuple):
    """A frame in flight: its stats on their way to the host, and what the
    resolve's slow path may need (device handles: holding them reads
    nothing)."""

    stats: DeferredFetch
    sampled: Optional[PointCloud]  # None off a keyframe
    prev_map_state: object
    T_eff: torch.Tensor  # the pose, for a drop-retry re-insert
    preprocessed: PointCloud
    timestamp: float
    dt: float
    frame_index: int


def _per_stream(dt, like: torch.Tensor) -> torch.Tensor:
    """``dt`` (a number, or a fleet's ``[B]``) as a float32 tensor that
    broadcasts over a ``[..., 3]`` vector: a number becomes a 0-dim tensor
    made by a fill kernel (no copy from the host), so that a stream divides
    by a tensor as the fleet does."""
    if isinstance(dt, torch.Tensor):
        return dt[..., None]
    return torch.full((1,), dt, dtype=_F32, device=like.device)


def _axis_factor_dev(H_block: torch.Tensor, inlier: torch.Tensor, axis) -> torch.Tensor:
    """The device form of ``motion_predictor._axis_factor``: how much of the
    predicted motion to apply, from the smallest eigenvalue per inlier of
    ``H_block``."""
    w = eigh3.eigvalsh3(0.5 * (H_block + H_block.transpose(-1, -2)))
    min_eig_ratio = w.min(-1).values / torch.clamp_min(inlier, 1).to(_F32)
    lo, hi = axis.min_eigenvalue_low, axis.min_eigenvalue_high
    score = torch.clamp((min_eig_ratio - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    f = axis.factor_max * (1.0 - score) + axis.factor_min * score
    return torch.where(inlier > 0, f, axis.factor_max)


class PipelinedLidarOdometry(LidarOdometry):
    """LiDAR odometry whose stats fetch resolves up to ``max_in_flight``
    frames behind dispatch."""

    def __init__(self, params: LidarOdometryParams = LidarOdometryParams(),
                 map_prior_params: MapPriorParams = MapPriorParams(), max_in_flight: int = 16,
                 device: torch.device | str = "cuda"):
        if params.imu.enable:
            raise ValueError(
                "PipelinedLidarOdometry requires imu.enable=False (IMU prediction and deskew are "
                "host-coupled); use LidarInertialOdometry or the synchronous LidarOdometry.")
        super().__init__(params, map_prior_params, device=device)
        self._carry: Optional[OdomCarry] = None
        self._pending: deque = deque()
        self.max_in_flight = max(1, max_in_flight)
        # the most frames left in flight when a call returned (telemetry)
        self.in_flight_peak = 0
        # frames at or before this index had their map contribution
        # reconciled by a drop-retry rebuild: their growth policy is skipped
        self._reconciled_until = -1
        # frames at or before this index were dispatched before the last
        # load growth: their stale load factors must not grow it again
        self._load_grown_until = -1
        # authoritative outcomes, a few frames behind dispatch:
        # (frame_index, timestamp, pose [4, 4], ResultType)
        self.pose_log: list = []
        self.deferred_results: list = []

    def _init_carry(self) -> OdomCarry:
        """The carry from the host mirrors: those of the first frame, or of a
        restored checkpoint (the previous raw Hessian included, so that a
        resumed frame is damped as the uninterrupted one)."""
        dev = self.device
        H = np.zeros((6, 6), np.float32) if self._prev_Hraw_np is None else self._prev_Hraw_np
        t = torch.from_numpy(np.concatenate([
            np.asarray(a, np.float32).ravel() for a in (
                self.odom, self.linear_velocity, self.angular_velocity, self.submap.last_keyframe_pose, H)
        ])).to(dev)
        return OdomCarry(
            odom=t[:16].reshape(4, 4),
            lin_vel=t[16:19],
            ang_vel=t[19:22],
            lin_smooth=torch.zeros(3, dtype=_F32, device=dev),
            ang_smooth=torch.zeros(3, dtype=_F32, device=dev),
            have_smooth=torch.zeros((), dtype=torch.bool, device=dev),
            registrated=torch.full((), self.registrated, dtype=torch.bool, device=dev),
            last_kf_pose=t[22:38].reshape(4, 4),
            last_kf_time=torch.full((), self.submap.last_keyframe_time, dtype=torch.float64, device=dev),
            prev_T=torch.eye(4, dtype=_F32, device=dev),
            prev_Hraw=t[38:74].reshape(6, 6),
            prev_err_raw=torch.zeros((), dtype=_F32, device=dev),
            prev_inlier=torch.full((), self._prev_inlier, dtype=torch.int32, device=dev),
        )

    def _predict(self, c: OdomCarry, dt) -> tuple:
        """The device constant-velocity prediction: ``(init_T, lin_s,
        ang_s)``; ``dt`` a number, or a fleet's ``[B]`` tensor."""
        mp = self.params.motion_prediction
        adaptive = c.registrated & (c.prev_inlier > 0)
        rot_f = torch.where(adaptive, _axis_factor_dev(c.prev_Hraw[..., :3, :3], c.prev_inlier, mp.rotation),
                            mp.rotation.factor_max)[..., None]
        trans_f = torch.where(adaptive, _axis_factor_dev(c.prev_Hraw[..., 3:, 3:], c.prev_inlier, mp.translation),
                              mp.translation.factor_max)[..., None]
        a = mp.velocity_ema_alpha
        smooth = c.have_smooth[..., None]
        lin_s = torch.where(smooth, a * c.lin_vel + (1.0 - a) * c.lin_smooth, c.lin_vel)
        ang_s = torch.where(smooth, a * c.ang_vel + (1.0 - a) * c.ang_smooth, c.ang_vel)
        dt = _per_stream(dt, c.odom)
        R_delta = lie.quat_to_matrix(lie.so3_exp(ang_s * dt * rot_f))
        R = c.odom[..., :3, :3]
        init_T = lie.make_transform(lie.compose(R, R_delta), c.odom[..., :3, 3] + matvec3(R, lin_s * dt * trans_f))
        return init_T, lin_s, ang_s

    def _next_carry(self, c: OdomCarry, result, T_eff, is_kf, small, lin_s, ang_s, dt, timestamp) -> OdomCarry:
        """The carry after a frame: velocity and odometry update, keyframe
        bookkeeping, the raw result for the next prediction and prior; a
        small frame holds. ``dt`` and ``timestamp`` are numbers, or a fleet's
        ``[B]`` tensors."""
        delta = lie.compose(lie.transform_inverse(c.odom), T_eff)
        tw = lie.se3_log(delta)
        upd = ~small
        u1, u2 = upd[..., None], upd[..., None, None]
        dt = _per_stream(dt, T_eff)
        kf_update = is_kf & (not self.submap.inserts_every_frame)
        kf2 = kf_update[..., None, None]
        return OdomCarry(
            odom=T_eff,
            lin_vel=torch.where(u1, delta[..., :3, 3] / dt, c.lin_vel),
            ang_vel=torch.where(u1, tw[..., :3] / dt, c.ang_vel),
            lin_smooth=lin_s,
            ang_smooth=ang_s,
            have_smooth=torch.ones_like(c.have_smooth),
            registrated=c.registrated | upd,
            last_kf_pose=torch.where(kf2, T_eff, c.last_kf_pose),
            last_kf_time=torch.where(kf_update, torch.as_tensor(timestamp, dtype=torch.float64,
                                                                device=T_eff.device), c.last_kf_time),
            prev_T=torch.where(u2, result.T, c.prev_T),
            prev_Hraw=torch.where(u2, result.H_raw, c.prev_Hraw),
            prev_err_raw=torch.where(upd, result.error_raw, c.prev_err_raw),
            prev_inlier=torch.where(upd, result.inlier, c.prev_inlier),
        )

    # -- the pipelined frame --------------------------------------------------
    def _process_frame(self, pre: PointCloud, timestamp: float) -> ResultType:
        t0 = time.perf_counter()
        if self._carry is None:
            self._carry = self._init_carry()
        c = self._carry
        dt = self.dt
        kfp = self.params.submap.keyframe

        # ---- registration: prediction, align, keyframe decision -------------
        init_T, lin_s, ang_s = self._predict(c, dt)
        kf_dt_exceeded = (c.last_kf_time <= 0.0) | ((timestamp - c.last_kf_time) >= kfp.time_threshold_seconds)
        result, deskewed, T_eff, is_kf, small, s1 = self._reg_step(
            pre, init_T, c.odom, c.last_kf_pose, kf_dt_exceeded,
            (c.prev_T, c.prev_Hraw, c.prev_err_raw, c.prev_inlier), c.registrated)

        # ---- the carry: velocity / odometry update, a small frame holds -----
        self._carry = self._next_carry(c, result, T_eff, is_kf, small, lin_s, ang_s, dt, timestamp)
        self.reg_result = result
        t0 = self._stage_end("3. registration", t0)

        # ---- the submap step on keyframes (one read: the flag and the
        # registration input's valid count), then the deferred fetch ----
        n_desk, kf = to_host(s1[19:21])
        prev_map_state = self.submap.map_state
        new_map_state, target, sampled, s2 = self._submap_step(
            prev_map_state, self.submap.submap_cloud, deskewed, T_eff, kf > 0.5, self.submap._generator,
            knn_prev=self.submap.submap_knn, n_desk=int(n_desk))
        self.submap.map_state = new_map_state
        if kf > 0.5:
            self.submap.submap_cloud = target
            self.submap.submap_knn = BruteForceKNN.build(target).prepped()
        self._pending.append(_Pending(
            stats=DeferredFetch(torch.cat([s1, s2])), sampled=sampled, prev_map_state=prev_map_state,
            T_eff=T_eff, preprocessed=self.preprocessed, timestamp=timestamp, dt=dt,
            frame_index=self.frame_count))
        t0 = self._stage_end("4a. submap dispatch", t0)

        # ---- resolve every frame whose copy has landed; wait only when the
        # window is full ----
        while self._pending and (len(self._pending) > self.max_in_flight or self._pending[0].stats.ready()):
            self._resolve_one(self._pending.popleft())
        self.in_flight_peak = max(self.in_flight_peak, len(self._pending))
        self._stage_end("4b. stats fetch", t0)

        self.frame_count += 1
        self.last_frame_time = timestamp
        return ResultType.success

    def _resolve_one(self, pend: _Pending) -> None:
        """Resolve one frame: parse its stats, commit the host mirrors, run
        the growth policy and the extract backstop."""
        stats = pend.stats.get().astype(np.float64)
        T_np = stats[:16].reshape(4, 4).astype(np.float32)
        (n_inlier, n_pre, n_reg, n_desk, kf_flag, small_flag,
         converged, iterations, error) = stats[16:25]
        load, overflow, ext_ok, dropped, budget_lost, n_extracted = stats[_S1:_S1 + 6]

        rtype = ResultType.small_number_of_points if small_flag > 0.5 else ResultType.success
        self.deferred_results.append((pend.frame_index, rtype))
        self.pose_log.append((pend.frame_index, pend.timestamp, T_np, rtype))

        # host mirrors (telemetry and accessors; the carry is authoritative)
        self._prev_Hraw_np = stats[25:61].reshape(6, 6).astype(np.float32)
        self._prev_inlier = int(n_inlier)
        is_kf = kf_flag > 0.5
        if is_kf:
            # only an insert extracts: a frame without one reports no overflow
            self.submap.extract_overflow = int(overflow)
            self.submap.last_keyframe_cloud = pend.sampled
            self.submap._record_keyframe(T_np, pend.timestamp)
        self.submap.budget_lost = int(budget_lost)
        if rtype is ResultType.success:
            # FIFO resolution: prev_odom is frame j-1's pose and pend.dt frame j's
            self.prev_odom = self.odom.copy()
            self.odom = T_np.copy()
            delta = np.linalg.inv(self.prev_odom) @ self.odom
            tw = lie_np.se3_log(delta)
            self.linear_velocity = (delta[:3, 3] / pend.dt).astype(np.float32)
            self.angular_velocity = (tw[:3] / pend.dt).astype(np.float32)
            self.registrated = True
            # the full-resolution constant-velocity deskew, for publishing, a frame late
            if self.pipeline_params.velocity_update.enable and pend.preprocessed.timestamp_offsets is not None:
                prev_T, cur_T = torch.from_numpy(np.stack([self.prev_odom, T_np]).astype(np.float32)).to(self.device)
                self.preprocessed = deskew_constant_velocity(pend.preprocessed, prev_T, cur_T, pend.dt)
        else:
            self.error_message = "point cloud size is too small"

        # growth policy (the rare slow path, which reads the device)
        if pend.frame_index <= self._reconciled_until:
            return
        newest = self._pending[-1].frame_index if self._pending else pend.frame_index
        if int(dropped) - self._dropped_seen > 0:
            # roll back to this frame's state from before its insert and
            # re-apply it and every later frame in flight, growing until
            # nothing is dropped (a frame off a keyframe stashed no sample)
            self.submap.map_state = pend.prev_map_state
            clouds = [pend.sampled] + [p.sampled for p in self._pending]
            poses = [T_np] + [p.T_eff for p in self._pending]
            self.submap.reconcile_chain(clouds, poses, window=self.max_in_flight + 1)
            self._reconciled_until = newest
            self._dropped_seen = to_host(self.submap.map_state.dropped)
        else:
            self._dropped_seen = int(dropped)
            # the frames in flight measured their load on the old capacity:
            # gate the load check (not the drop check) until they drain
            if load > MAX_LOAD and pend.frame_index > self._load_grown_until:
                self.submap._grow_map(origin=T_np)
                self._load_grown_until = newest
        # the extract backstop: the frames in flight registered against the
        # truncated target, the next dispatch gets the grown one
        if self.submap.extract_overflow > 0:
            self.submap.resolve_extract_overflow(T_np)

    def flush(self) -> None:
        """Resolve every frame in flight (once, after the stream)."""
        while self._pending:
            self._resolve_one(self._pending.popleft())

    def resolve_oldest(self) -> bool:
        """Resolve the oldest frame in flight, waiting for its copy; False
        when none is in flight. For a server idle between scans: its poses
        come out without waiting for the next scan."""
        if not self._pending:
            return False
        self._resolve_one(self._pending.popleft())
        return True

    def get_odometry(self) -> np.ndarray:
        """The latest resolved pose (behind dispatch until :meth:`flush`)."""
        return self.odom.copy()
