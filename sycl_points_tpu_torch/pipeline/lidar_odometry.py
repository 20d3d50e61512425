"""LiDAR-only odometry pipeline.

Counterpart of :mod:`sycl_points_tpu.pipeline.lidar_odometry`: the per-frame
state machine (initial-alignment handshake, IMU deskew, preprocess,
covariances, refine, first-frame bootstrap, IMU window integration, motion
prediction, registration against the submap with an optional MAP prior and
the optional constant-velocity (VICP) deskew, submap update, velocity /
odometry update and IMU reset), per-stage wall-clock timing and the frame
``ResultType`` codes. Everything on the device stays there from the raw scan
to the pose.

A frame has two parts, as in the JAX package. The registration step (the
min-points gate, the MAP prior, the whole align pipeline, the keyframe
decision) ends in one fetch of the 62-entry ``stats1`` vector: pose, counts,
keyframe flag and the raw Hessian for the next frame's motion prediction. The
submap step (robust-weighted sampling, map insert, extraction, covariance
finalize; :mod:`.fused_submap`) runs on keyframes (on the occupancy grid,
every frame past the inlier gate) and ends in the fetch of ``stats2``. Where the JAX package runs one jitted program per part and waits
on the device once a frame, eager PyTorch also waits at every data-dependent
loop exit (the solver's convergence test, the hash table's probe loops);
``sync_count_last_frame`` counts all of them; with the IMU on, so are the
reads of the preintegrated deltas that the motion prediction and the
velocity corrector take.
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
from sycl_points_tpu_torch.deskew.constant_velocity import deskew_constant_velocity
from sycl_points_tpu_torch.imu.initial_alignment import InitialAlignmentEstimator
from sycl_points_tpu_torch.imu.preintegration import IMUMeasurement, IMUPreintegration, build_measurement_window
from sycl_points_tpu_torch.imu.velocity_corrector import IMUVelocityCorrector
from sycl_points_tpu_torch.pipeline.fused_submap import make_submap_step
from sycl_points_tpu_torch.pipeline.motion_predictor import MotionPredictor
from sycl_points_tpu_torch.pipeline.params import LidarOdometryParams
from sycl_points_tpu_torch.pipeline.pc_processor import PCProcessor
from sycl_points_tpu_torch.pipeline.submap import MAX_LOAD, Submap
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.registration.factors import RegType
from sycl_points_tpu_torch.registration.map_prior import MapPriorParams, update as map_prior_update
from sycl_points_tpu_torch.registration.pipeline import align_pipeline, align_pipeline_streams
from sycl_points_tpu_torch.utils import lie, lie_np
from sycl_points_tpu_torch.utils.sync import counts as sync_counts, to_host

_F32 = torch.float32


class ResultType(enum.Enum):
    success = "success"
    first_frame = "first_frame"
    waiting_initial_alignment = "waiting_initial_alignment"
    error = "error"
    old_timestamp = "old_timestamp"
    small_number_of_points = "small_number_of_points"


# stats1, 62 entries: T_eff (16) | inlier, n_pre, n_reg, n_desk, is_kf, small,
# converged, iterations, error (9) | H_raw (36) | error_raw (1)
_S1 = 62


class LidarOdometry:
    def __init__(self, params: LidarOdometryParams = LidarOdometryParams(),
                 map_prior_params: MapPriorParams = MapPriorParams(),
                 device: torch.device | str = "cuda"):
        self.device = require_device(device)
        self.params = params
        self.map_prior_params = map_prior_params
        self.pc_processor = PCProcessor(params, self.device)
        self.submap = Submap(params, self.device)
        self.motion_predictor = MotionPredictor(params.motion_prediction)
        self.pipeline_params = params.make_registration_pipeline_params()
        self._submap_robust_scale = (
            self.pipeline_params.robust.min_scale
            if self.pipeline_params.robust.auto_scale
            else params.registration.factor.robust.default_scale
        )
        self._submap_step = make_submap_step(params, self.submap, self._submap_robust_scale)
        # When set, every stage of a frame ends in a device synchronisation,
        # so get_processing_times() splits the frame by where the device
        # spent it and not by where the host queued it.
        self.sync_stage_times = False

        self.odom = params.pose.initial_matrix()
        self.prev_odom = self.odom.copy()
        self.linear_velocity = np.zeros(3, np.float32)
        self.angular_velocity = np.zeros(3, np.float32)
        self.dt = 0.1
        self.last_frame_time = -1.0
        self.is_first_frame = True
        self.registrated = False
        self.reg_result = None
        self.is_keyframe_last_frame = False
        self.preprocessed: Optional[PointCloud] = None
        self.error_message = ""
        self.processing_times: Dict[str, float] = defaultdict(float)
        self.frame_count = 0
        self.sync_count_last_frame = 0
        # host copies of the previous frame's stats (the motion predictor's
        # inputs need no device read)
        self._prev_Hraw_np: Optional[np.ndarray] = None
        self._prev_inlier = 0
        self._dropped_seen = 0

        # IMU machinery
        self.imu_buffer: deque = deque()
        self.imu_bias_gyro = np.asarray(params.imu.gyro_bias, np.float32)
        self.imu_bias_accel = np.asarray(params.imu.accel_bias, np.float32)
        self.imu_preintegration = (
            IMUPreintegration(params.imu.preintegration, self.device) if params.imu.enable else None
        )
        self.imu_velocity_corrector = IMUVelocityCorrector()
        self.imu_R_world_at_reset = np.eye(3, dtype=np.float32)
        self.imu_v_world_at_reset = np.zeros(3, np.float32)
        self.last_imu_reset_timestamp = -1.0
        self.imu_window_complete = False
        self.alignment_estimator = (
            InitialAlignmentEstimator(
                params.imu.initial_alignment,
                np.asarray(params.imu.preintegration.gravity, np.float32),
                params.imu.T_imu_to_lidar_matrix(),
            )
            if params.imu.enable and params.imu.initial_alignment.enable
            else None
        )

    def precompile_growth(self, max_capacity: int, wait: bool = True) -> int:
        """Returns 0: there is nothing to compile. The JAX package compiles
        the submap programs of every map capacity up to ``max_capacity``
        ahead of the stream, to keep XLA compile stalls out of a growth
        event; eager PyTorch runs the same code at any capacity."""
        return 0

    # -- timing ---------------------------------------------------------------
    def _stage_end(self, name: str, t0: float) -> float:
        if self.sync_stage_times and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.processing_times[name] += now - t0
        return now

    # -- IMU input -------------------------------------------------------------
    def add_imu_measurement(self, meas: IMUMeasurement):
        self.imu_buffer.append(meas)
        horizon = meas.timestamp - self.params.imu.buffer_duration_sec
        while self.imu_buffer and self.imu_buffer[0].timestamp < horizon:
            self.imu_buffer.popleft()

    # -- frame processing ----------------------------------------------------
    def process(self, scan: PointCloud, timestamp: float, scan_duration_sec: float = 0.1) -> ResultType:
        self.error_message = ""
        # initial-alignment handshake
        if (
            self.is_first_frame
            and self.alignment_estimator is not None
            and self.alignment_estimator.enabled()
            and not self.alignment_estimator.is_done()
        ):
            ok, R_gl, gyro_bias, diag = self.alignment_estimator.try_align(
                timestamp, list(self.imu_buffer), self.imu_bias_gyro, self.imu_bias_accel)
            if not ok:
                self.error_message = f"initial_alignment: {diag.error_message}"
                return ResultType.waiting_initial_alignment
            # gravity-aligned rotation, the user's yaw kept, and the gyro bias
            user_R = self.odom[:3, :3]
            yaw = float(np.arctan2(user_R[1, 0], user_R[0, 0]))
            cz, sz = np.cos(yaw), np.sin(yaw)
            Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
            self.odom[:3, :3] = Rz @ R_gl
            self.prev_odom = self.odom.copy()
            self.imu_bias_gyro = gyro_bias

        if self.last_frame_time > 0.0:
            dt = timestamp - self.last_frame_time
            if dt > 0.0:
                self.dt = float(dt)
            else:
                self.error_message = "old timestamp"
                return ResultType.old_timestamp

        self.processing_times.clear()
        syncs_before = sync_counts["host_syncs"]
        self.is_keyframe_last_frame = False
        try:
            return self._process(scan, timestamp, scan_duration_sec)
        finally:
            self.sync_count_last_frame = sync_counts["host_syncs"] - syncs_before

    def _process(self, scan: PointCloud, timestamp: float, scan_duration_sec: float) -> ResultType:
        p = self.params
        # preprocess: queued on the device, nothing read back
        t0 = time.perf_counter()
        cloud = scan
        if self._imu_deskew_enabled():
            # initial-velocity compensation from the constant-velocity
            # estimate; without it only the rotation is deskewed
            v_world = (self.odom[:3, :3] @ self.linear_velocity).astype(np.float32)
            cloud, _status = self.pc_processor.deskew_with_imu(
                cloud, list(self.imu_buffer), self.odom, timestamp, scan_duration_sec,
                self.imu_bias_gyro, self.imu_bias_accel, v_world_body=v_world)
        pre = self.pc_processor.prefilter(cloud)
        ctx = None
        if self._needs_covariances():
            ctx = self.pc_processor.prepare_context(pre)
            pre = self.pc_processor.compute_covariances(pre, ctx)
            pre = self.pc_processor.refine_filter(pre, ctx)
        self.preprocessed = pre
        t0 = self._stage_end("1. preprocessing", t0)

        if self.is_first_frame:
            # bootstrap: the min-points gate pays its one read here
            if to_host(pre.count()) <= p.registration.min_num_points:
                self.error_message = "point cloud size is too small"
                return ResultType.small_number_of_points
            self.submap.add_first_frame(pre, timestamp, self.odom)
            self._dropped_seen = to_host(self.submap.map_state.dropped)
            self._stage_end("4. build submap", t0)
            self.is_first_frame = False
            self.last_frame_time = timestamp
            if self.imu_preintegration is not None:
                T_il = p.imu.T_imu_to_lidar_matrix()
                self.imu_R_world_at_reset = self.odom[:3, :3] @ T_il[:3, :3]
                self.imu_v_world_at_reset = np.zeros(3, np.float32)
                self.imu_preintegration.reset(self.imu_bias_gyro, self.imu_bias_accel,
                                              R_world_body=self.imu_R_world_at_reset)
                self.last_imu_reset_timestamp = timestamp
            return ResultType.first_frame

        # IMU window integration
        if self.imu_preintegration is not None:
            window = build_measurement_window(list(self.imu_buffer), self.last_imu_reset_timestamp, timestamp)
            tol = 1e-6
            self.imu_window_complete = (
                len(window) >= 2
                and abs(window[0].timestamp - self.last_imu_reset_timestamp) <= tol
                and abs(window[-1].timestamp - timestamp) <= tol
            )
            self.imu_preintegration.integrate_batch(window)

        return self._process_frame(pre, timestamp)

    # ------------------------------------------------------------------
    def _reg_step(self, pre: PointCloud, init_T: torch.Tensor, prev_odom: torch.Tensor,
                  last_kf_pose: torch.Tensor, kf_dt_exceeded, prior_in, registrated, target=None, knn=None):
        """The registration step: the min-points gate, the MAP prior, the
        align pipeline, the keyframe decision and ``stats1``, all on the
        device. ``prior_in`` is the previous raw result ``(T, H_raw,
        error_raw, inlier)`` that the MAP prior starts from (None when the
        prior is off); ``kf_dt_exceeded`` and ``registrated`` are host bools
        (the synchronous frame) or device bools (the pipelined frame).
        ``target`` / ``knn`` default to the submap's. A fleet's step takes
        ``pre [B, N]``, its targets and ``[B]``-leading poses and flags
        (:func:`~..registration.pipeline.align_pipeline_streams`), and gives
        ``stats1 [B, 62]``.
        Returns ``(result, deskewed, T_eff, is_kf, small, stats1)``."""
        p = self.params
        kfp = p.submap.keyframe
        target = self.submap.submap_cloud if target is None else target
        knn = self.submap.submap_knn if knn is None else knn
        n_pre = pre.count()
        small = n_pre <= p.registration.min_num_points

        prior = None
        if self.map_prior_params.enabled:
            prior = map_prior_update(self.map_prior_params, *prior_in, init_T)
            prior = prior._replace(active=prior.active & registrated)

        if pre.points.dim() == 3:
            out = align_pipeline_streams(pre, target, knn, self.pipeline_params, initial_guess=init_T,
                                         map_prior=prior)
        else:
            out = align_pipeline(
                pre, target, knn, self.pipeline_params,
                initial_guess=init_T, map_prior=prior, prev_pose=prev_odom, dt=self.dt,
            )
        result = out.result
        # a too-small frame must not move the odometry
        T_eff = torch.where(small[..., None, None], prev_odom, result.T)

        n_reg = out.registration_input.count()
        n_desk = out.deskewed.count()
        ratio = result.inlier.to(_F32) / torch.clamp_min(n_reg, 1).to(_F32)
        inlier_ok = ratio > kfp.inlier_ratio_threshold if kfp.inlier_ratio_threshold > 0.0 \
            else torch.ones_like(small)
        delta = lie.compose(lie.transform_inverse(last_kf_pose), T_eff)
        dist = torch.linalg.vector_norm(delta[..., :3, 3], dim=-1)
        angle_deg = torch.linalg.vector_norm(lie.se3_log(delta)[..., :3], dim=-1) * (180.0 / math.pi)
        geom_kf = (dist >= kfp.distance_threshold) | (angle_deg >= kfp.angle_threshold_degrees) | kf_dt_exceeded
        if self.submap.inserts_every_frame:
            geom_kf = torch.ones_like(geom_kf)
        is_kf = (~small) & inlier_ok & geom_kf

        lead = small.shape
        stats1 = torch.cat([
            T_eff.reshape(lead + (16,)),
            torch.stack([v.to(_F32) for v in (
                result.inlier, n_pre, n_reg, n_desk, is_kf, small,
                result.converged, result.iterations, result.error)], -1),
            result.H_raw.reshape(lead + (36,)),
            result.error_raw.to(_F32)[..., None],
        ], -1)
        return result, out.deskewed, T_eff, is_kf, small, stats1

    def _prior_inputs(self):
        """The MAP prior's start, ``(T, H_raw, error_raw, inlier)`` of the
        last committed result (identity and zeros before the first); None
        when the prior is off."""
        if not self.map_prior_params.enabled:
            return None
        r = self.reg_result
        if r is not None:
            return r.T, r.H_raw, r.error_raw, r.inlier
        dev = self.device
        return (torch.eye(4, dtype=_F32, device=dev), torch.zeros((6, 6), dtype=_F32, device=dev),
                torch.zeros((), dtype=_F32, device=dev), torch.zeros((), dtype=torch.int32, device=dev))

    def _process_frame(self, pre: PointCloud, timestamp: float) -> ResultType:
        p = self.params

        # ---- motion prediction (host math on the previous frame's stats) ---
        t0 = time.perf_counter()
        mode = p.motion_prediction.mode.upper()
        gyro_delta = imu_pose = None
        if (self.imu_preintegration is not None and self.imu_window_complete
                and self.imu_preintegration.get_dt_total() > 0.0):
            delta_R_imu = np.asarray(to_host(self.imu_preintegration.get_corrected(
                self.imu_bias_gyro, self.imu_bias_accel).Delta_R), np.float32)
            R_il = p.imu.T_imu_to_lidar_matrix()[:3, :3]
            gyro_delta = R_il @ delta_R_imu @ R_il.T
            if mode == "IMU_SE3":
                imu_pose = self._imu_motion_prediction()
        init_T = self.motion_predictor.predict(
            self.linear_velocity, self.angular_velocity, self.odom, self.dt,
            self._prev_Hraw_np, self._prev_inlier, self.registrated, gyro_delta, imu_pose,
        )
        v_reset = np.zeros(3, np.float32)
        if self.imu_preintegration is not None and mode == "IMU_SE3":
            v_reset = self.imu_velocity_corrector.get_reset_velocity(
                self.imu_preintegration, self.imu_bias_gyro, self.imu_bias_accel,
                self.prev_odom[:3, :3] @ self.linear_velocity,
            )
        kf_dt_exceeded = (
            self.submap.last_keyframe_time <= 0.0
            or (timestamp - self.submap.last_keyframe_time) >= p.submap.keyframe.time_threshold_seconds
        )

        # ---- registration + keyframe decision, then the first fetch ---------
        init_T_d, prev_odom, last_kf_pose = torch.from_numpy(np.stack([
            np.asarray(init_T, np.float32), np.asarray(self.odom, np.float32),
            np.asarray(self.submap.last_keyframe_pose, np.float32),
        ])).to(self.device)
        result, deskewed, T_eff, _, _, s1 = self._reg_step(
            pre, init_T_d, prev_odom, last_kf_pose, kf_dt_exceeded, self._prior_inputs(), self.registrated)
        stats = np.asarray(to_host(s1), np.float64)
        t0 = self._stage_end("3. registration", t0)

        T_np = stats[:16].reshape(4, 4).astype(np.float32)
        (n_inlier, n_pre, n_reg, n_desk, kf_flag, small_flag,
         converged, iterations, error) = stats[16:25]
        H_raw_np = stats[25:61].reshape(6, 6).astype(np.float32)
        if small_flag > 0.5:
            self.error_message = "point cloud size is too small"
            return ResultType.small_number_of_points
        is_kf = kf_flag > 0.5

        # ---- submap update (keyframes only), then the second fetch ----------
        prev_map_state = self.submap.map_state
        new_map_state, new_submap, sampled, s2 = self._submap_step(
            prev_map_state, self.submap.submap_cloud, deskewed, T_eff, is_kf,
            self.submap._generator, knn_prev=self.submap.submap_knn, n_desk=int(n_desk),
        )
        t0 = self._stage_end("4a. submap dispatch", t0)
        load, overflow, ext_ok, dropped, budget_lost, n_extracted = to_host(s2)
        t0 = self._stage_end("4b. stats fetch", t0)

        # ---- commit host state --------------------------------------------
        self.reg_result = result
        self._prev_Hraw_np = H_raw_np
        self._prev_inlier = int(n_inlier)
        self.submap.map_state = new_map_state
        self.submap.budget_lost = int(budget_lost)
        self.is_keyframe_last_frame = is_kf
        if is_kf:
            self.submap.commit_insert(new_submap, sampled, overflow, T_np, timestamp)

        # growth policy (rare slow path; reads the device only when it fires)
        if int(dropped) - self._dropped_seen > 0:
            self.submap.map_state = prev_map_state  # the retry loses nothing
            self.submap.retry_insert_after_drop(sampled, T_np)
            self._dropped_seen = to_host(self.submap.map_state.dropped)
        else:
            self._dropped_seen = int(dropped)
            if float(load) > MAX_LOAD:
                self.submap._grow_map(origin=T_np)
        # extract-overflow backstop: the in-range voxel set outgrew the
        # extraction budget without a map growth
        if self.submap.extract_overflow > 0:
            self.submap.resolve_extract_overflow(T_np)
        self._stage_end("4. build submap", t0)

        # the full-resolution constant-velocity deskew, for publishing
        if (self.pipeline_params.velocity_update.enable and not self._imu_deskew_enabled()
                and self.preprocessed.timestamp_offsets is not None):
            prev_T, cur_T = torch.from_numpy(np.stack([self.odom, T_np]).astype(np.float32)).to(self.device)
            self.preprocessed = deskew_constant_velocity(self.preprocessed, prev_T, cur_T, self.dt)

        # velocity / odometry update
        self.prev_odom = self.odom.copy()
        self.odom = T_np.copy()
        self.last_frame_time = timestamp
        delta = np.linalg.inv(self.prev_odom) @ self.odom
        tw = lie_np.se3_log(delta)
        self.linear_velocity = (delta[:3, 3] / self.dt).astype(np.float32)
        self.angular_velocity = (tw[:3] / self.dt).astype(np.float32)

        if self.imu_preintegration is not None:
            T_il = p.imu.T_imu_to_lidar_matrix()
            self.imu_R_world_at_reset = T_np[:3, :3] @ T_il[:3, :3]
            self.imu_v_world_at_reset = v_reset
            self.imu_preintegration.reset(self.imu_bias_gyro, self.imu_bias_accel,
                                          R_world_body=self.imu_R_world_at_reset)
            self.last_imu_reset_timestamp = timestamp
            if mode == "IMU_SE3":
                R_world_imu_prev = self.prev_odom[:3, :3] @ T_il[:3, :3]
                self.imu_velocity_corrector.update(
                    self.odom[:3, 3] - self.prev_odom[:3, 3], R_world_imu_prev,
                    np.asarray(p.imu.preintegration.gravity, np.float32))

        self.registrated = True
        self.frame_count += 1
        return ResultType.success

    # ------------------------------------------------------------------
    def _imu_deskew_enabled(self) -> bool:
        return self.params.imu.enable and self.params.imu.deskew.enable

    def _imu_motion_prediction(self) -> np.ndarray:
        """The absolute pose predicted by the preintegrated window."""
        T_imu_rel = np.asarray(to_host(self.imu_preintegration.predict_relative_transform(
            self.imu_R_world_at_reset, self.imu_v_world_at_reset, self.imu_bias_gyro, self.imu_bias_accel,
        )), np.float32)
        T_il = self.params.imu.T_imu_to_lidar_matrix()
        return (self.odom @ (T_il @ T_imu_rel @ np.linalg.inv(T_il))).astype(np.float32)

    def _needs_covariances(self) -> bool:
        p = self.params
        return (
            p.registration.factor.reg_type is RegType.GICP
            or p.registration.factor.rotation_constraint.enable
            or p.scan.preprocess.angle_incidence_filter.enable
            or p.scan.intensity_gaussian.enable
            or p.scan.intensity_local_mean_norm.enable
        )

    # -- accessors -----------------------------------------------------------
    def get_odometry(self) -> np.ndarray:
        return self.odom.copy()

    def get_keyframe_poses(self):
        return list(self.submap.keyframe_poses)

    def get_processing_times(self) -> Dict[str, float]:
        return dict(self.processing_times)
