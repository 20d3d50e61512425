"""Tightly-coupled LiDAR-inertial odometry (15-DOF, IEKF-style).

Counterpart of :mod:`sycl_points_tpu.pipeline.lidar_inertial_odometry`: per
frame, optional IMU deskew of the raw scan -> preprocess -> covariances ->
refine -> IMU window integration -> (IMU-only fallback for tiny clouds) ->
15-DOF LIO registration -> bias clamps -> preintegration reset with the
P_post sigma floors -> submapping.

The inertial step (:meth:`LidarInertialOdometry._lio_step_streams`) is one
function of tensors, as the JAX package's jitted program: the
parallel-prefix preintegration of the padded window, the state and
covariance prediction, the 15-DOF align, the bias clamps, the IMU-only
select and the keyframe decision. It takes a leading stream axis (the LIO
fleet's ``vmap``); a single frame runs it with one stream
(:meth:`LidarInertialOdometry._lio_step`). The window and the host-side scalars go up in one copy; the
filter state (``State``, ``P_post``) stays on the device. A frame reads the
device as the LiDAR-only frame does: the ``stats1`` fetch after the step,
the ``stats2`` fetch after the submap step, one read an iteration for the
solver's exit test, the hash table's probe loops on a keyframe (every frame
on the occupancy grid); all are counted in ``sync_count_last_frame``.
"""

from __future__ import annotations

import enum
import math
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.imu.factor import IDX_ACC_BIAS, IDX_GYR_BIAS, IDX_ROT, IDX_VEL, DOF, State, select
from sycl_points_tpu_torch.imu.initial_alignment import InitialAlignmentEstimator
from sycl_points_tpu_torch.imu.preintegration import (
    IMUMeasurement,
    build_measurement_window,
    gravity_vector,
    init_state,
    integrate_steps,
    pack_steps,
    padded_steps_from_window,
    predict_relative_transform,
    unpack_steps,
)
from sycl_points_tpu_torch.lio import lio_registration as lio
from sycl_points_tpu_torch.ops.sampling import random_sampling_streams
from sycl_points_tpu_torch.pipeline.fused_submap import make_submap_step
from sycl_points_tpu_torch.pipeline.params import LidarInertialOdometryParams
from sycl_points_tpu_torch.pipeline.pc_processor import PCProcessor
from sycl_points_tpu_torch.pipeline.submap import MAX_LOAD, Submap
from sycl_points_tpu_torch.points.point_cloud import PointCloud, flatten_streams, unflatten_streams
from sycl_points_tpu_torch.utils import lie, lie_np
from sycl_points_tpu_torch.utils.smallmat import matvec3
from sycl_points_tpu_torch.utils.sync import counts as sync_counts, to_device, to_host

_F32 = torch.float32
SEED = 99


class ResultType(enum.Enum):
    success = "success"
    first_frame = "first_frame"
    waiting_initial_alignment = "waiting_initial_alignment"
    error = "error"
    old_timestamp = "old_timestamp"
    small_number_of_points = "small_number_of_points"
    imu_only = "imu_only"


# stats1, 34 entries: T_eff (16) | inlier, n_pre, n_reg, is_kf, small,
# finite_ok, iterations, error, dt_total (9) | gyro_bias (3) | accel_bias (3)
# | velocity (3)
_S1 = 34


def _clamp_norm(v: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``v [..., 3]`` scaled down to ``max_norm`` where it is longer."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(n > max_norm, v * (max_norm / torch.clamp_min(n, 1e-30)), v)


class LidarInertialOdometry:
    def __init__(self, params: LidarInertialOdometryParams = LidarInertialOdometryParams(),
                 collect_trace: bool = False, device: torch.device | str = "cuda"):
        """``collect_trace=True`` makes every frame also fetch the 15-DOF
        solver's per-iteration trace (:data:`..lio.lio_registration.TRACE_COLS`)
        and the predicted-vs-registered innovation into :attr:`last_trace`:
        one more host read a frame."""
        self.device = dev = require_device(device)
        self.params = p = params
        self.collect_trace = collect_trace
        self.last_trace: Optional[dict] = None
        self.pc_processor = PCProcessor(params, dev)
        self.submap = Submap(params, dev)
        self._submap_step = make_submap_step(params, self.submap, None)
        # When set, every stage of a frame ends in a device synchronisation
        # (see LidarOdometry.sync_stage_times).
        self.sync_stage_times = False

        init = p.pose.initial_matrix()
        T_il = p.imu.T_imu_to_lidar_matrix()
        P0 = np.zeros((DOF, DOF), np.float32)
        P0[IDX_ACC_BIAS:IDX_ACC_BIAS + 3, IDX_ACC_BIAS:IDX_ACC_BIAS + 3] = p.initial_accel_bias_sigma**2 * np.eye(3)
        P0[IDX_GYR_BIAS:IDX_GYR_BIAS + 3, IDX_GYR_BIAS:IDX_GYR_BIAS + 3] = p.initial_gyro_bias_sigma**2 * np.eye(3)
        floor = np.zeros(DOF, np.float32)
        floor[IDX_VEL:IDX_VEL + 3] = p.fd_velocity_sigma**2
        floor[IDX_ROT:IDX_ROT + 3] = p.icp_rotation_sigma**2
        # the initial state and the constants, in one upload
        pos, R, v, ab, gb, self.P_post, self._T_il, self._P_floor = to_device(
            dev, init[:3, 3], init[:3, :3], np.zeros(3), p.imu.accel_bias, p.imu.gyro_bias, P0, T_il,
            np.diag(floor))
        self.x = State(position=pos, rotation=R, velocity=v, accel_bias=ab, gyro_bias=gb)
        self._T_il_inv = lie.transform_inverse(self._T_il)

        self.odom = init
        self.prev_odom = self.odom.copy()
        self.dt = 0.1
        self.last_frame_time = -1.0
        self.last_imu_reset_timestamp = -1.0
        self.is_first_frame = True
        self.is_keyframe_last_frame = False
        self.iterations_last_frame = 0
        self.preprocessed: Optional[PointCloud] = None
        self.error_message = ""
        self.processing_times: Dict[str, float] = defaultdict(float)
        self.sync_count_last_frame = 0
        self._generator = torch.Generator(device=dev).manual_seed(SEED)
        self._dropped_seen = 0
        # host copies of the filter state (from the stats fetch), for the
        # host-side deskew path
        self.gyro_bias_np = np.asarray(p.imu.gyro_bias, np.float32)
        self.accel_bias_np = np.asarray(p.imu.accel_bias, np.float32)
        self.velocity_np = np.zeros(3, np.float32)

        self.imu_buffer: deque = deque()
        self.imu_R_world_at_reset = np.eye(3, dtype=np.float32)
        self.imu_v_world_at_reset = np.zeros(3, np.float32)
        self.alignment_estimator = (
            InitialAlignmentEstimator(p.imu.initial_alignment, np.asarray(p.imu.preintegration.gravity, np.float32),
                                      T_il)
            if p.imu.initial_alignment.enable
            else None
        )

    def precompile_growth(self, max_capacity: int, wait: bool = True) -> int:
        """Returns 0: eager PyTorch has no per-capacity programs to compile
        (see ``LidarOdometry.precompile_growth``)."""
        return 0

    def _stage_end(self, name: str, t0: float) -> float:
        if self.sync_stage_times and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.processing_times[name] += now - t0
        return now

    # ------------------------------------------------------------------
    def _lio_step(self, pre: PointCloud, submap: PointCloud, knn, x: State, P_post: torch.Tensor,
                  imu_pack: torch.Tensor, misc: torch.Tensor):
        """The inertial step of one frame: :meth:`_lio_step_streams` with one
        stream, so that a frame alone and the same frame as a fleet's stream
        give the same bits. Returns ``(x_new, P_new, source, T_eff, is_kf,
        stats1, iterations run, debug)``."""
        x_new, P_new, source, T_eff, is_kf, s1, result, debug = self._lio_step_streams(
            unflatten_streams(pre, 1), unflatten_streams(submap, 1), lio.OneStreamKNN(knn),
            State(*(f[None] for f in x)), P_post[None], imu_pack[None], misc[None], [self._generator])
        return (State(*(f[0] for f in x_new)), P_new[0], flatten_streams(source), T_eff[0], is_kf[0], s1[0],
                result.loops, None if debug is None else {k: v[0] for k, v in debug.items()})

    def _lio_step_streams(self, pre: PointCloud, submap: PointCloud, knn, x: State, P_post: torch.Tensor,
                          imu_pack: torch.Tensor, misc: torch.Tensor, generators):
        """The inertial step of B streams, on the device: preintegration with
        the reset covariance floors -> prediction -> 15-DOF align -> bias
        clamps -> IMU-only select (small clouds) -> the hold of a non-finite
        propagation -> keyframe decision -> ``stats1``. ``pre [B, N]``,
        ``submap [B, M]`` (``knn`` on its ``[B, M, 3]`` points), ``x`` fields
        ``[B, ...]``, ``P_post [B, 15, 15]``, ``imu_pack [B, S, 14]``; ``misc
        [B, 18]`` is each stream's last keyframe pose (16) and its update-bias
        and keyframe-time flags; stream ``b``'s registration sampling draws
        from ``generators[b]``. Returns ``(x_new, P_new, source, T_eff,
        is_kf, stats1 [B, 34], the align's LIORegistrationResult, debug)``."""
        p = self.params
        pp = p.imu.preintegration
        kfp = p.submap.keyframe
        T_il = self._T_il
        B = pre.points.shape[0]
        dt_s, w0, w1, a0, a1, valid = unpack_steps(imu_pack)
        last_kf_pose = misc[:, :16].reshape(B, 4, 4)
        update_bias = misc[:, 16] > 0.5
        kf_dt_exceeded = misc[:, 17] > 0.5

        # ---- preintegration from the floored posterior ----------------------
        P_imu_init = lio.transform_covariance_lidar_to_imu(P_post + self._P_floor, T_il, x.rotation)
        R_world_imu = lie.compose(x.rotation, T_il[:3, :3])
        raw = integrate_steps(pp, init_state(P_imu_init), dt_s, w0, w1, a0, a1, valid,
                              x.gyro_bias, x.accel_bias, R_world_imu)

        # ---- state / covariance prediction ----------------------------------
        T_imu_rel = predict_relative_transform(pp, raw, R_world_imu, x.velocity)
        T_pred = lie.compose(x.pose(), lie.compose(lie.compose(T_il, T_imu_rel), self._T_il_inv))
        v_pred = (x.velocity + gravity_vector(pp, self.device) * raw.dt_total[:, None]
                  + matvec3(R_world_imu, raw.Delta_v))
        pred = State(position=T_pred[..., :3, 3], rotation=T_pred[..., :3, :3], velocity=v_pred,
                     accel_bias=x.accel_bias, gyro_bias=x.gyro_bias)
        P_pred = lio.transform_covariance_imu_to_lidar(raw.covariance, T_il, pred.rotation)

        # ---- registration -----------------------------------------------------
        n_pre = pre.count()
        small = n_pre <= p.registration.min_num_points
        source = pre
        sampling = p.registration_sampling
        if sampling.enable and sampling.num < pre.capacity:
            source = random_sampling_streams(pre, sampling.num, generators)
        aligned = lio.align_streams(source, submap, knn, pred, P_pred, P_post, factor_params=p.registration.factor,
                                    params=p.lio, update_bias=update_bias, trace=self.collect_trace)
        result, iter_trace = aligned if self.collect_trace else (aligned, None)
        x_reg = result.state
        if p.max_accel_bias_norm > 0.0:
            x_reg = x_reg._replace(accel_bias=_clamp_norm(x_reg.accel_bias, p.max_accel_bias_norm))
        if p.max_gyro_bias_norm > 0.0:
            x_reg = x_reg._replace(gyro_bias=_clamp_norm(x_reg.gyro_bias, p.max_gyro_bias_norm))

        # ---- IMU-only select for small clouds -------------------------------
        x_new = select(small, pred, x_reg)
        P_new = torch.where(small[:, None, None], P_pred, result.posterior_covariance)
        finite_ok = (torch.isfinite(x_new.pose()).flatten(-2).all(-1) & torch.isfinite(x_new.velocity).all(-1)
                     & torch.isfinite(P_new).flatten(-2).all(-1))
        # a non-finite propagation holds the state: the synchronous frame
        # refuses the commit on the host, the pipelined frame commits blind
        x_new = select(finite_ok, x_new, x)
        P_new = torch.where(finite_ok[:, None, None], P_new, P_post)
        T_eff = x_new.pose()

        # ---- keyframe decision ------------------------------------------------
        n_reg = source.count()
        ratio = result.inlier.to(_F32) / torch.clamp_min(n_reg, 1).to(_F32)
        inlier_ok = (ratio > kfp.inlier_ratio_threshold if kfp.inlier_ratio_threshold > 0.0
                     else torch.ones_like(small))
        delta = lie.compose(lie.transform_inverse(last_kf_pose), T_eff)
        dist = torch.linalg.vector_norm(delta[..., :3, 3], dim=-1)
        angle_deg = torch.linalg.vector_norm(lie.se3_log(delta)[..., :3], dim=-1) * (180.0 / math.pi)
        geom_kf = (dist >= kfp.distance_threshold) | (angle_deg >= kfp.angle_threshold_degrees) | kf_dt_exceeded
        if self.submap.inserts_every_frame:
            geom_kf = torch.ones_like(geom_kf)
        is_kf = (~small) & inlier_ok & geom_kf & finite_ok

        stats1 = torch.cat([
            T_eff.reshape(B, 16),
            torch.stack([v.to(_F32) for v in (result.inlier, n_pre, n_reg, is_kf, small, finite_ok,
                                               result.iterations, result.error, raw.dt_total)], -1),
            x_new.gyro_bias, x_new.accel_bias, x_new.velocity,
        ], -1)
        debug = None
        if self.collect_trace:
            innov = lie.se3_log(lie.compose(lie.transform_inverse(T_pred), x_reg.pose()))
            debug = {
                "iter_trace": iter_trace, "T_pred": T_pred,
                "innovation_rot": torch.linalg.vector_norm(innov[..., :3], dim=-1),
                "innovation_trans": torch.linalg.vector_norm(innov[..., 3:], dim=-1),
                "v_pred": v_pred, "dv_update": torch.linalg.vector_norm(x_reg.velocity - v_pred, dim=-1),
            }
        return x_new, P_new, source, T_eff, is_kf, stats1, result, debug

    # ------------------------------------------------------------------
    def add_imu_measurement(self, meas: IMUMeasurement):
        self.imu_buffer.append(meas)
        horizon = meas.timestamp - self.params.imu.buffer_duration_sec
        while self.imu_buffer and self.imu_buffer[0].timestamp < horizon:
            self.imu_buffer.popleft()

    def process(self, scan: PointCloud, timestamp: float, scan_duration_sec: float = 0.1) -> ResultType:
        self.error_message = ""
        syncs_before = sync_counts["host_syncs"]
        self.is_keyframe_last_frame = False
        self.iterations_last_frame = 0
        try:
            return self._process(scan, timestamp, scan_duration_sec)
        finally:
            self.sync_count_last_frame = sync_counts["host_syncs"] - syncs_before

    def _process(self, scan: PointCloud, timestamp: float, scan_duration_sec: float) -> ResultType:
        p = self.params
        if self.is_first_frame and self.alignment_estimator is not None and not self.alignment_estimator.is_done():
            ok, R_gl, gyro_bias, diag = self.alignment_estimator.try_align(
                timestamp, list(self.imu_buffer), self.gyro_bias_np, self.accel_bias_np)
            if not ok:
                self.error_message = f"initial_alignment: {diag.error_message}"
                return ResultType.waiting_initial_alignment
            user_R = self.odom[:3, :3]
            yaw = float(np.arctan2(user_R[1, 0], user_R[0, 0]))
            cz, sz = np.cos(yaw), np.sin(yaw)
            Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
            self.odom[:3, :3] = Rz @ R_gl
            self.prev_odom = self.odom.copy()
            self.gyro_bias_np = np.asarray(gyro_bias, np.float32)
            R, gb = to_device(self.device, self.odom[:3, :3], self.gyro_bias_np)
            self.x = self.x._replace(rotation=R, gyro_bias=gb)

        if self.last_frame_time > 0.0:
            dt = timestamp - self.last_frame_time
            if dt > 0.0:
                self.dt = float(dt)
            else:
                self.error_message = "old timestamp"
                return ResultType.old_timestamp
        self.processing_times.clear()

        # preprocess + covariances + refine, queued on the device
        t0 = time.perf_counter()
        cloud = scan
        if p.imu.deskew.enable:
            if self.is_first_frame:
                R_imu0 = (self.odom[:3, :3] @ p.imu.T_imu_to_lidar_matrix()[:3, :3]).astype(np.float32)
                v0 = self.imu_v_world_at_reset
            else:
                # the deskew's initial conditions at scan start, not at the
                # previous frame's reset
                R_imu0, v0 = self._propagate_to_scan_start(timestamp)
            cloud, _ = self.pc_processor.deskew_with_imu(
                cloud, list(self.imu_buffer), self.odom, timestamp, scan_duration_sec,
                self.gyro_bias_np, self.accel_bias_np, v_world_body=v0, R_world_imu=R_imu0)
        pre = self.pc_processor.prefilter(cloud)
        ctx = self.pc_processor.prepare_context(pre)
        pre = self.pc_processor.compute_covariances(pre, ctx)
        pre = self.pc_processor.refine_filter(pre, ctx)
        self.preprocessed = pre
        t0 = self._stage_end("1. preprocessing", t0)

        if self.is_first_frame:
            if to_host(pre.count()) <= p.registration.min_num_points:
                self.error_message = "point cloud size is too small"
                return ResultType.small_number_of_points
            self.submap.add_first_frame(pre, timestamp, self.odom)
            self._dropped_seen = to_host(self.submap.map_state.dropped)
            self._stage_end("4. build submap", t0)
            self.is_first_frame = False
            self.last_frame_time = timestamp
            self.last_imu_reset_timestamp = timestamp
            # keep the velocity state: a caller-seeded initial velocity must
            # survive the first frame
            pos, R = to_device(self.device, self.odom[:3, 3], self.odom[:3, :3])
            self.x = self.x._replace(position=pos, rotation=R)
            self.imu_R_world_at_reset = self.odom[:3, :3] @ p.imu.T_imu_to_lidar_matrix()[:3, :3]
            return ResultType.first_frame

        return self._process_frame(pre, timestamp)

    # ------------------------------------------------------------------
    def _process_frame(self, pre: PointCloud, timestamp: float) -> ResultType:
        p = self.params
        t0 = time.perf_counter()
        window = build_measurement_window(list(self.imu_buffer), self.last_imu_reset_timestamp, timestamp)
        imu_pack = pack_steps(*padded_steps_from_window(window))
        kfp = p.submap.keyframe
        kf_dt_exceeded = (
            self.submap.last_keyframe_time <= 0.0
            or (timestamp - self.submap.last_keyframe_time) >= kfp.time_threshold_seconds
        )
        misc = np.concatenate([
            np.asarray(self.submap.last_keyframe_pose, np.float32).ravel(),
            np.asarray([self._imu_bias_observable(), kf_dt_exceeded], np.float32),
        ])
        imu_pack_d, misc_d = to_device(self.device, imu_pack, misc)  # one host-to-device copy a frame
        x_new, P_new, reg_input, T_eff, _, s1, executed, debug = self._lio_step(
            pre, self.submap.submap_cloud, self.submap.submap_knn, self.x, self.P_post, imu_pack_d, misc_d)
        self.iterations_last_frame = executed
        if debug is not None:
            flat = to_host(torch.cat([v.reshape(-1).to(_F32) for v in debug.values()]))
            self.last_trace, at = {}, 0
            for k, v in debug.items():
                self.last_trace[k] = np.asarray(flat[at : at + v.numel()], np.float32).reshape(v.shape)
                at += v.numel()
        stats = np.asarray(to_host(s1), np.float64)
        t0 = self._stage_end("3. registration", t0)

        T_np = stats[:16].reshape(4, 4).astype(np.float32)
        (n_inlier, n_pre, n_reg, kf_flag, small_flag, finite_ok,
         iterations, error, dt_total) = stats[16:25]
        if finite_ok < 0.5:
            self.error_message = "imu-only propagation produced non-finite state or covariance"
            self._stage_end("4. build submap", t0)
            return ResultType.error
        self.gyro_bias_np = stats[25:28].astype(np.float32)
        self.accel_bias_np = stats[28:31].astype(np.float32)
        self.velocity_np = stats[31:34].astype(np.float32)

        # ---- commit -----------------------------------------------------------
        self.x = x_new
        self.P_post = P_new
        self.prev_odom = self.odom.copy()
        self.odom = T_np.copy()
        self.last_frame_time = timestamp
        self.last_imu_reset_timestamp = timestamp
        self.imu_R_world_at_reset = T_np[:3, :3] @ p.imu.T_imu_to_lidar_matrix()[:3, :3]
        self.imu_v_world_at_reset = self.velocity_np

        if small_flag > 0.5:
            self.error_message = "point cloud size is too small; propagated with IMU only"
            self._stage_end("4. build submap", t0)
            return ResultType.imu_only

        # ---- submap update (keyframes only), then the second fetch ------------
        is_kf = kf_flag > 0.5
        prev_map_state = self.submap.map_state
        new_map_state, new_submap, sampled, s2 = self._submap_step(
            prev_map_state, self.submap.submap_cloud, reg_input, T_eff, is_kf, self.submap._generator,
            knn_prev=self.submap.submap_knn, n_desk=int(n_reg),
        )
        t0 = self._stage_end("4a. submap dispatch", t0)
        load, overflow, ext_ok, dropped, budget_lost, n_extracted = to_host(s2)
        t0 = self._stage_end("4b. stats fetch", t0)

        self.submap.map_state = new_map_state
        self.submap.budget_lost = int(budget_lost)
        self.is_keyframe_last_frame = is_kf
        if is_kf:
            self.submap.commit_insert(new_submap, sampled, overflow, T_np, timestamp)

        if int(dropped) - self._dropped_seen > 0:
            self.submap.map_state = prev_map_state  # the retry loses nothing
            self.submap.retry_insert_after_drop(sampled, T_np)
            self._dropped_seen = to_host(self.submap.map_state.dropped)
        else:
            self._dropped_seen = int(dropped)
            if float(load) > MAX_LOAD:
                self.submap._grow_map(origin=T_np)
        if self.submap.extract_overflow > 0:
            self.submap.resolve_extract_overflow(T_np)
        self._stage_end("4. build submap", t0)
        return ResultType.success

    # ------------------------------------------------------------------
    def _propagate_to_scan_start(self, timestamp: float):
        """Midpoint propagation of ``(R_world_imu, v_world)`` from the last
        preintegration reset to ``timestamp`` (the scan start) in float64 on
        the host: the IMU deskew's initial conditions."""
        window = build_measurement_window(list(self.imu_buffer), self.last_imu_reset_timestamp, timestamp)
        R = self.imu_R_world_at_reset.astype(np.float64)
        v = self.imu_v_world_at_reset.astype(np.float64)
        g = np.asarray(self.params.imu.preintegration.gravity, np.float64)
        a_scale = self.params.imu.preintegration.accel_scale
        bg = self.gyro_bias_np.astype(np.float64)
        ba = self.accel_bias_np.astype(np.float64)
        for m0, m1 in zip(window[:-1], window[1:]):
            dt = m1.timestamp - m0.timestamp
            if dt <= 1e-9:
                continue
            w = 0.5 * (m0.gyro + m1.gyro).astype(np.float64) - bg
            a = 0.5 * (m0.accel + m1.accel).astype(np.float64) * a_scale - ba
            R_half = R @ lie_np.so3_exp_matrix(w * (0.5 * dt))
            v = v + (R_half @ a + g) * dt
            R = R @ lie_np.so3_exp_matrix(w * dt)
        return R.astype(np.float32), v.astype(np.float32)

    def _imu_bias_observable(self) -> bool:
        """Always: freeze-on-low-excitation is not in the parameter tree."""
        return True

    def get_odometry(self) -> np.ndarray:
        return self.odom.copy()

    def get_state(self) -> State:
        return self.x

    def get_keyframe_poses(self):
        return list(self.submap.keyframe_poses)

    def get_processing_times(self) -> Dict[str, float]:
        return dict(self.processing_times)
