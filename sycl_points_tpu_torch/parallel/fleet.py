"""Fleet odometry: B LiDAR odometry streams through one launch sequence a frame.

Counterpart of :class:`sycl_points_tpu.parallel.fleet.FleetOdometry`, the
serving batch of :class:`~..pipeline.pipelined_odometry.PipelinedLidarOdometry`.
Where the JAX class ``vmap``s the per-frame programs over a leading stream
axis, every step here takes that axis explicitly (``[B, ...]``), and one
Python call launches the work of all ``B`` streams: the preprocess
(:meth:`~..pipeline.pc_processor.PCProcessor.preprocess_streams`), the
registration (the device prediction, the MAP prior, the align loop with one
batched ``nn1`` launch and one host read an iteration for the whole fleet,
the keyframe decision), and the submap step on stacked map states
(:func:`~..pipeline.fused_submap.make_submap_step_streams`). The stats of all
streams come back in one deferred fetch a frame. The host's reads a fleet
frame (the align loop's exit tests, the keyframe flags, the hash table's
probe loops, the extraction's overflow test) do not grow with ``B``.

Stream ``s`` computes what a single-stream ``PipelinedLidarOdometry`` on its
scans computes when that pipeline's generators are seeded as stream ``s``'s
(:func:`stream_seeds`), but for the documented deltas of the JAX class:

- all streams share one parameter set and bootstrap together on the first
  :meth:`FleetOdometry.process_batch` call; the first-frame min-points gate
  is not applied;
- map capacity is shared: the growth slow path rolls back and regrows the
  WHOLE fleet when any stream drops a contribution, keeping each stream's
  zero-loss retry semantics;
- there is no per-point-timestamp deskew;
- a non-increasing per-stream timestamp falls back to ``dt = 0.1`` instead of
  the single-stream ``old_timestamp`` rejection;
- one extraction tier is pinned for all streams (the base
  ``extract_capacity``): an extraction overflow is counted, not grown.

A frame whose keyframes are only some streams runs its submap step over
all streams with the others masked, as the JAX class does. Gathering the
keyframe streams' rows, running them alone and scattering the results back
was measured against it on the H100 and was slower (PERF.md §6).

:class:`FleetLIO` runs B tightly-coupled 15-DOF LIO streams the same way
(the JAX class ``vmap``s the pipelined LIO step): each stream's IMU window is
built on the host and padded to the fleet's largest step bucket, all of them
go up in one ``[B, S, 14]`` copy, and one call of
:meth:`~..pipeline.lidar_inertial_odometry.LidarInertialOdometry._lio_step_streams`
integrates, predicts, aligns (one batched ``nn1`` launch and one host read an
iteration for the fleet), clamps, selects and decides the keyframes of all
streams. The two fleets differ only in the hooks that the JAX classes name
(``_make_template``, ``_stats1_len``, ``_run_reg``, ``_init_carry``,
``_post_bootstrap``, ``_stream_result_types``, ``_kf_col``), plus
``_upload_inputs`` (a frame's host inputs, sent before the preprocess) and
``_iter_col`` (where a stream's align iterations sit in the stats).

The JAX class's ``mesh=`` (GSPMD sharding of the stream axis over chips)
raises here: a fleet split over several cards is ROADMAP Queue 1 item 13
(``parallel/sharded.py`` splits one pair, a query batch or a batch of pairs,
not a fleet).
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from sycl_points_tpu_torch.imu.factor import State
from sycl_points_tpu_torch.imu.preintegration import (
    IMUMeasurement,
    build_measurement_window,
    pack_steps,
    padded_steps_from_window,
)
from sycl_points_tpu_torch.lio import lio_registration as lio
from sycl_points_tpu_torch.mapping.voxel_hash_map import select_streams, stack_streams
from sycl_points_tpu_torch.ops.knn import BruteForceKNN
from sycl_points_tpu_torch.ops.sampling import random_sampling_streams
from sycl_points_tpu_torch.ops.transform import transform_cloud
from sycl_points_tpu_torch.pipeline import lidar_inertial_odometry as lio_frame
from sycl_points_tpu_torch.pipeline import pc_processor, submap
from sycl_points_tpu_torch.pipeline.fused_submap import make_submap_step_streams, pick_clouds
from sycl_points_tpu_torch.pipeline.lidar_odometry import _S1, ResultType
from sycl_points_tpu_torch.pipeline.params import LidarInertialOdometryParams, LidarOdometryParams
from sycl_points_tpu_torch.pipeline.pipelined_lio import LIOCarry, PipelinedLidarInertialOdometry
from sycl_points_tpu_torch.pipeline.pipelined_odometry import OdomCarry, PipelinedLidarOdometry
from sycl_points_tpu_torch.points.point_cloud import PointCloud, compact_device
from sycl_points_tpu_torch.registration.map_prior import MapPriorParams
from sycl_points_tpu_torch.utils.sync import DeferredFetch, to_device, to_host

_F32 = torch.float32


def stream_seeds(seed: int, stream: int, inertial: bool = False) -> tuple:
    """``(preprocess seed, submap seed)`` of a fleet's stream: the
    single-stream pipeline's (:data:`..pipeline.pc_processor.SEED`,
    :data:`..pipeline.submap.SEED`) offset by ``seed + stream``; with
    ``inertial`` a third, the LIO registration sampling's
    (:data:`..pipeline.lidar_inertial_odometry.SEED`) offset alike."""
    seeds = (pc_processor.SEED + seed + stream, submap.SEED + seed + stream)
    return seeds + (lio_frame.SEED + seed + stream,) if inertial else seeds


class _Pending(NamedTuple):
    """A fleet frame in flight (device handles: holding them reads nothing)."""

    stats: DeferredFetch  # [B, stats1 + 6]
    sampled: Optional[PointCloud]  # [B, num] keyframe samples; None with no keyframe
    is_kf: np.ndarray  # [B]
    prev_map_state: object  # the stacked state before the insert
    T_eff: torch.Tensor  # [B, 4, 4]
    timestamps: np.ndarray  # [B]
    frame_index: int


class FleetOdometry:
    """``n_streams`` LiDAR odometry streams, one launch sequence a frame."""

    def __init__(
        self,
        params: LidarOdometryParams = LidarOdometryParams(),
        n_streams: int = 4,
        map_prior_params: MapPriorParams = MapPriorParams(),
        initial_poses: Optional[np.ndarray] = None,  # [B, 4, 4]
        mesh=None,
        mesh_axis: str = "streams",
        max_in_flight: int = 16,
        seed: int = 0,
        device: torch.device | str = "cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                f"mesh= (sharding the {mesh_axis!r} axis over cards) is not ported: a fleet split over "
                "several cards is ROADMAP Queue 1 item 13")
        # the template holds the parameters, the preprocessor and the submap
        # config; its own single-stream map is freed
        t = self._make_template(params, map_prior_params, device)
        t.submap.map_state = None
        self._t = t
        self.params = params
        self.device = t.device
        self.B = int(n_streams)
        self._max_in_flight = max(1, max_in_flight)
        self._s1 = self._stats1_len()
        seeds = [stream_seeds(seed, s) for s in range(self.B)]
        self._pre_gens = [torch.Generator(device=self.device).manual_seed(a) for a, _ in seeds]
        self._map_gens = [torch.Generator(device=self.device).manual_seed(b) for _, b in seeds]
        self._need_covs = getattr(t, "_needs_covariances", lambda: True)()
        self._submap_step = make_submap_step_streams(params, t.submap, self._robust_scale(t))

        if initial_poses is None:
            initial_poses = np.broadcast_to(params.pose.initial_matrix(), (self.B, 4, 4))
        self._initial_poses = np.array(initial_poses, np.float32)
        self.map_state = stack_streams(t.submap.map_module.create(t.submap.map_config, self.device), self.B)
        self.submap_cloud: Optional[PointCloud] = None
        self._knn: Optional[BruteForceKNN] = None
        self._carry: Optional[OdomCarry] = None

        self._pending: deque = deque()
        # per stream: (frame_index, timestamp, pose [4, 4], ResultType)
        self.pose_log: List[list] = [[] for _ in range(self.B)]
        self.deferred_results: List[list] = [[] for _ in range(self.B)]
        # per stream: the align loop's iterations of each resolved frame, and
        # the keyframes taken (telemetry)
        self.align_iterations: List[list] = [[] for _ in range(self.B)]
        self.keyframe_counts = np.zeros(self.B, np.int64)
        self._dropped_seen = np.zeros(self.B, np.int64)
        self.extract_overflow = np.zeros(self.B, np.int64)
        self.budget_lost = np.zeros(self.B, np.int64)
        self._reconciled_until = -1
        self._load_grown_until = -1
        self.frame_count = 0
        self.growth_events: List[dict] = []
        self.processing_times: dict = {}
        self._last_ts: Optional[np.ndarray] = None

    # ---- the pipeline's hooks (FleetLIO overrides them) --------------------
    def _make_template(self, params, map_prior_params, device):
        return PipelinedLidarOdometry(params, map_prior_params, device=device)

    def _stats1_len(self) -> int:
        """Columns of a stream's registration stats (the submap step's follow)."""
        return _S1

    def _robust_scale(self, t):
        """The submap step's sampling-weight scale."""
        return t._submap_robust_scale

    def _kf_col(self) -> int:
        """The stats column of the keyframe flag; the one before it is the
        valid count of the cloud the submap step inserts."""
        return 20

    def _iter_col(self) -> int:
        """The stats column of a stream's align iterations."""
        return 23

    def _upload_inputs(self, ts: np.ndarray):
        """The frame's host inputs on the device: each stream's ``dt``
        (a non-increasing clock falls back to 0.1 s) and timestamp."""
        dts = np.where(ts > self._last_ts, ts - self._last_ts, 0.1)
        return torch.from_numpy(dts.astype(np.float32)).to(self.device), torch.from_numpy(ts).to(self.device)

    def _run_reg(self, pre: PointCloud, ts: np.ndarray, inputs):
        """The registration of all streams: the device prediction, the MAP
        prior, the align, the keyframe decision and the carry. Returns
        ``(cloud for the submap step, T_eff [B, 4, 4], stats1 [B, ...])``."""
        dt_d, ts_d = inputs
        t = self._t
        c = self._carry
        kfp = self.params.submap.keyframe
        init_T, lin_s, ang_s = t._predict(c, dt_d)
        kf_dt_exceeded = (c.last_kf_time <= 0.0) | ((ts_d - c.last_kf_time) >= kfp.time_threshold_seconds)
        prior_in = (c.prev_T, c.prev_Hraw, c.prev_err_raw, c.prev_inlier)
        result, deskewed, T_eff, is_kf, small, s1 = t._reg_step(
            pre, init_T, c.odom, c.last_kf_pose, kf_dt_exceeded, prior_in, c.registrated,
            target=self.submap_cloud, knn=self._knn)
        self._carry = t._next_carry(c, result, T_eff, is_kf, small, lin_s, ang_s, dt_d, ts_d)
        return deskewed, T_eff, s1

    def _post_bootstrap(self, ts: np.ndarray) -> None:
        """A pipeline's own state after the fleet's first frame."""

    def _stream_result_types(self, stats: np.ndarray) -> list:
        """Each stream's ``ResultType`` from its stats row."""
        small = stats[:, 21] > 0.5
        return [ResultType.small_number_of_points if small[b] else ResultType.success for b in range(self.B)]

    # ------------------------------------------------------------------
    @property
    def map_capacity(self) -> int:
        return self._t.submap.map_capacity

    def precompile_growth(self, max_capacity: int) -> int:
        """Returns 0: eager PyTorch compiles nothing (as
        :meth:`~..pipeline.lidar_odometry.LidarOdometry.precompile_growth`)."""
        return 0

    def _stage(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.processing_times[name] = now - t0
        return now

    # ------------------------------------------------------------------
    def process_batch(self, clouds: PointCloud, timestamps) -> None:
        """Process one frame of every stream: ``clouds`` a fleet's cloud
        ``[B, N]``, ``timestamps`` ``[B]`` (or one number for all). Results
        arrive deferred in :attr:`pose_log` / :attr:`deferred_results`
        (:meth:`flush` after the last frame)."""
        B = self.B
        if clouds.points.shape[0] != B:
            raise ValueError(f"expected clouds of {B} streams, got {tuple(clouds.points.shape)}")
        ts = np.broadcast_to(np.asarray(timestamps, np.float64), (B,)).copy()
        t0 = time.perf_counter()
        if self._carry is not None:
            # the frame's host inputs go up while the stream is idle (the last
            # frame ended in a read), so the copy waits for nothing
            inputs = self._upload_inputs(ts)
        pre = self._t.pc_processor.preprocess_streams(clouds, self._pre_gens, self._need_covs)
        t0 = self._stage("1. preprocessing", t0)
        if self._carry is None:
            self._bootstrap_streams(pre, ts)
            self._stage("4a. submap dispatch", t0)
            return
        self._last_ts = ts

        # ---- registration: prediction, align, keyframe decision, carry ----
        deskewed, T_eff, s1 = self._run_reg(pre, ts, inputs)
        t0 = self._stage("3. registration", t0)

        # ---- the submap step: the keyframe flags and valid counts in one read ----
        kf_col = self._kf_col()
        n_desk, kf = np.asarray(to_host(s1[:, kf_col - 1 : kf_col + 1])).T
        kf = kf > 0.5
        prev_map_state = self.map_state
        new_state, target, sampled, s2 = self._submap_step(prev_map_state, self.submap_cloud, self._knn, deskewed,
                                                           T_eff, kf, n_desk.astype(np.int64), self._map_gens)
        self.map_state = new_state
        if sampled is not None:
            self._set_target(target)
        self._pending.append(_Pending(
            stats=DeferredFetch(torch.cat([s1, s2], -1)), sampled=sampled, is_kf=kf,
            prev_map_state=prev_map_state, T_eff=T_eff, timestamps=ts, frame_index=self.frame_count))
        t0 = self._stage("4a. submap dispatch", t0)

        while self._pending and (len(self._pending) > self._max_in_flight or self._pending[0].stats.ready()):
            self._resolve_one(self._pending.popleft())
        self._stage("4b. stats fetch", t0)
        self.frame_count += 1

    def _set_target(self, target: PointCloud) -> None:
        self.submap_cloud = target
        self._knn = BruteForceKNN(points=target.points, mask=target.mask).prepped()

    # ------------------------------------------------------------------
    def _init_carry(self, ts: np.ndarray) -> OdomCarry:
        """The carry after the first frame, as each single-stream pipeline
        starts it: the initial pose, no velocity, the first frame the last
        keyframe."""
        B, dev = self.B, self.device
        poses = torch.from_numpy(self._initial_poses).to(dev)
        z3 = torch.zeros((B, 3), dtype=_F32, device=dev)
        return OdomCarry(
            odom=poses, lin_vel=z3, ang_vel=z3, lin_smooth=z3, ang_smooth=z3,
            have_smooth=torch.zeros(B, dtype=torch.bool, device=dev),
            registrated=torch.zeros(B, dtype=torch.bool, device=dev),
            last_kf_pose=poses,
            last_kf_time=torch.from_numpy(ts).to(dev),
            prev_T=torch.eye(4, dtype=_F32, device=dev).expand(B, 4, 4),
            prev_Hraw=torch.zeros((B, 6, 6), dtype=_F32, device=dev),
            prev_err_raw=torch.zeros(B, dtype=_F32, device=dev),
            prev_inlier=torch.zeros(B, dtype=torch.int32, device=dev),
        )

    def _bootstrap_streams(self, pre: PointCloud, ts: np.ndarray) -> None:
        """All streams' first frame together, as ``Submap.add_first_frame``:
        the sample inserted (grown and retried on the same sample while any
        stream drops: the map before it is empty, so nothing is lost); the
        first target is the whole preprocessed cloud."""
        sm = self._t.submap
        poses = torch.from_numpy(self._initial_poses).to(self.device)
        sampled = random_sampling_streams(pre, self.params.submap.point_random_sampling_num, self._map_gens)
        for attempt in range(submap.MAX_GROW + 1):
            new_state, _, load, overflow = sm.insert_extract(self.map_state, sampled, poses)
            s0 = np.asarray(to_host(torch.stack([load, overflow.to(_F32), new_state.dropped.to(_F32),
                                                 new_state.budget_lost.to(_F32)], -1)))
            if (s0[:, 2] == 0).all() or attempt == submap.MAX_GROW:
                break
            self.map_state, sm.map_config = sm.map_module.grow(self.map_state, sm.map_config)
            self.growth_events.append({"frame": 0, "capacity": sm.map_capacity})
        self.map_state = new_state
        first = transform_cloud(compact_device(pre, out_capacity=sm.extract_capacity), poses[:, None])
        self._set_target(sm.finalize_traced(PointCloud(points=first.points, mask=first.mask))
                         if sm._need_covs or sm._need_normals else PointCloud(points=first.points, mask=first.mask))
        self._carry = self._init_carry(ts)
        self._post_bootstrap(ts)
        self._dropped_seen = s0[:, 2].astype(np.int64)
        self.extract_overflow = s0[:, 1].astype(np.int64)
        self.budget_lost = s0[:, 3].astype(np.int64)
        if float(s0[:, 0].max()) > submap.MAX_LOAD:
            self._grow_fleet()
        self._last_ts = ts
        self.frame_count += 1

    # ------------------------------------------------------------------
    def _resolve_one(self, pend: _Pending) -> None:
        stats = pend.stats.get().astype(np.float64)  # [B, stats1 + 6]
        B, s1 = self.B, self._s1
        T_np = stats[:, :16].reshape(B, 4, 4).astype(np.float32)
        load, overflow = stats[:, s1], stats[:, s1 + 1]
        dropped = stats[:, s1 + 3].astype(np.int64)
        for b, rtype in enumerate(self._stream_result_types(stats)):
            self.deferred_results[b].append((pend.frame_index, rtype))
            self.pose_log[b].append((pend.frame_index, float(pend.timestamps[b]), T_np[b], rtype))
            self.align_iterations[b].append(int(stats[b, self._iter_col()]))
        self.keyframe_counts += pend.is_kf
        # only an insert extracts: a stream off a keyframe keeps its mirror
        self.extract_overflow = np.where(pend.is_kf, overflow.astype(np.int64), self.extract_overflow)
        self.budget_lost = stats[:, s1 + 4].astype(np.int64)

        if pend.frame_index <= self._reconciled_until:
            return
        if (dropped > self._dropped_seen).any():
            self._retry_after_drop(pend)
            return
        self._dropped_seen = dropped
        if float(load.max()) > submap.MAX_LOAD and pend.frame_index > self._load_grown_until:
            self._grow_fleet()
            self._load_grown_until = self._pending[-1].frame_index if self._pending else pend.frame_index

    def _grow_state(self, state):
        """Double a stacked state at the current capacity and advance the
        shared config (the extraction tier stays pinned)."""
        sm = self._t.submap
        grown, sm.map_config = sm.map_module.grow(state, sm.map_config)
        self.growth_events.append({"frame": self.frame_count, "capacity": sm.map_capacity})
        return grown

    def _grow_fleet(self) -> None:
        self.map_state = self._grow_state(self.map_state)

    def _retry_after_drop(self, pend: _Pending) -> None:
        """The growth slow path: roll every stream back to this frame's
        state from before its insert, grow the WHOLE fleet and run the same
        stacked insert again until nothing is dropped, then re-apply every
        later frame in flight (growing again only on a new drop); the target
        of each stream that inserted is rebuilt from its last extraction."""
        sm = self._t.submap
        state = pend.prev_map_state
        extracted, inserted = None, torch.zeros(self.B, dtype=torch.bool, device=self.device)
        for j, p in enumerate([pend, *self._pending]):
            if p.sampled is None:
                continue
            kf = torch.from_numpy(p.is_kf).to(self.device)
            for attempt in range(submap.MAX_GROW + 1):
                if attempt > 0 or j == 0:
                    state = self._grow_state(state)
                new, ex, _, _ = sm.insert_extract(state, p.sampled, p.T_eff)
                new = select_streams(kf, new, state)
                if to_host((new.dropped == state.dropped).all()) or attempt == submap.MAX_GROW:
                    break
            state = new
            extracted = ex if extracted is None else pick_clouds(kf, ex, extracted)
            inserted = inserted | kf
            self._reconciled_until = max(self._reconciled_until, p.frame_index)
        self.map_state = state
        self._dropped_seen = np.asarray(to_host(state.dropped), np.int64)
        ok = inserted & (extracted.count() >= self.params.registration.min_num_points)
        target = PointCloud(points=extracted.points, mask=extracted.mask)
        if sm._need_covs or sm._need_normals:
            target = sm.finalize_traced(target)
        self._set_target(pick_clouds(ok, target, self.submap_cloud))

    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Resolve every frame in flight (once, after the streams end)."""
        while self._pending:
            self._resolve_one(self._pending.popleft())

    def get_odometry(self, stream: int) -> np.ndarray:
        """The latest resolved pose of one stream."""
        log = self.pose_log[stream]
        return log[-1][2].copy() if log else self._initial_poses[stream].copy()


class FleetLIO(FleetOdometry):
    """``n_streams`` tightly-coupled 15-DOF LIO streams, one launch sequence
    a frame: the fleet form of
    :class:`~..pipeline.pipelined_lio.PipelinedLidarInertialOdometry`.

    Each stream has its own IMU buffer (:meth:`add_imu_measurement`), filter
    state (:attr:`x`, :attr:`P` with a leading ``[B]``) and keyframe carry; a
    frame's results arrive deferred, per stream ``success``, ``imu_only`` (a
    too-small cloud, propagated by the IMU alone) or ``error`` (a non-finite
    propagation, held). Stream ``s`` computes what the single-stream
    pipelined LIO computes on its scans and IMU with its generators seeded
    as ``stream_seeds(seed, s, inertial=True)``, with the fleet's deltas of
    :class:`FleetOdometry`. As that class, it needs the IMU deskew off, and
    as the JAX class, the initial alignment off (its handshake is per
    stream and on the host); both raise ``ValueError``.
    """

    def __init__(self, params: LidarInertialOdometryParams = LidarInertialOdometryParams(), n_streams: int = 4,
                 initial_poses: Optional[np.ndarray] = None, mesh=None, mesh_axis: str = "streams",
                 max_in_flight: int = 16, seed: int = 0, device: torch.device | str = "cuda"):
        if params.imu.initial_alignment.enable:
            raise ValueError("FleetLIO requires imu.initial_alignment.enable=False (the alignment handshake is "
                             "host-side and per stream; use the single-stream pipelines)")
        lio._check_supported(params.lio)
        super().__init__(params, n_streams, initial_poses=initial_poses, mesh=mesh, mesh_axis=mesh_axis,
                         max_in_flight=max_in_flight, seed=seed, device=device)
        B = self.B
        self._reg_gens = [torch.Generator(device=self.device).manual_seed(stream_seeds(seed, s, inertial=True)[2])
                          for s in range(B)]
        self._imu_buffers = [deque() for _ in range(B)]
        self._last_reset = np.full(B, -1.0, np.float64)
        self.x: Optional[State] = None  # the filter state, fields [B, ...], from the first frame on
        self.P: Optional[torch.Tensor] = None  # [B, 15, 15]
        # host mirrors of each stream's biases and velocity (telemetry, a few frames late)
        t = self._t
        self.gyro_bias_np = np.repeat(t.gyro_bias_np[None], B, 0)
        self.accel_bias_np = np.repeat(t.accel_bias_np[None], B, 0)
        self.velocity_np = np.zeros((B, 3), np.float32)
        self.align_loops: List[int] = []  # the align loop's iterations a fleet frame (telemetry)

    # ---- hooks ---------------------------------------------------------------
    def _make_template(self, params, map_prior_params, device):
        return PipelinedLidarInertialOdometry(params, device=device)

    def _stats1_len(self) -> int:
        return lio_frame._S1 + 1  # the LIO stats row, then the stream's align iterations

    def _robust_scale(self, t):
        return None  # the LIO convention of the submap step

    def _kf_col(self) -> int:
        return 19

    def _iter_col(self) -> int:
        return lio_frame._S1

    def _init_carry(self, ts: np.ndarray) -> LIOCarry:
        """The keyframe carry after the first frame, as each single-stream
        pipeline starts it: the initial pose and the first frame's time."""
        return LIOCarry(last_kf_pose=torch.from_numpy(self._initial_poses).to(self.device),
                        last_kf_time=torch.from_numpy(ts).to(self.device))

    def _post_bootstrap(self, ts: np.ndarray) -> None:
        """The filter state after the first frame: the initial pose, no
        velocity (a caller may seed it, as the replay does), the template's
        biases and posterior covariance."""
        t, B = self._t, self.B
        poses = torch.from_numpy(self._initial_poses).to(self.device)
        self.x = State(position=poses[:, :3, 3], rotation=poses[:, :3, :3],
                       velocity=torch.zeros((B, 3), dtype=torch.float32, device=self.device),
                       accel_bias=t.x.accel_bias.expand(B, 3), gyro_bias=t.x.gyro_bias.expand(B, 3))
        self.P = t.P_post.expand(B, -1, -1)
        self._last_reset = ts.copy()

    def _upload_inputs(self, ts: np.ndarray):
        """Each stream's IMU window since its last reset, built on the host
        and padded to the fleet's largest step bucket, with the update-bias
        flags in one copy ``[B, S, 14]``; the timestamps in another
        (float64, as the keyframe time is carried)."""
        packs = [pack_steps(*padded_steps_from_window(build_measurement_window(
            list(buf), float(self._last_reset[b]), float(ts[b])))) for b, buf in enumerate(self._imu_buffers)]
        S = max(p.shape[0] for p in packs)
        pack = np.stack([np.pad(p, ((0, S - p.shape[0]), (0, 0))) for p in packs])
        imu_pack, update_bias = to_device(self.device, pack, np.full(self.B, float(self._t._imu_bias_observable())))
        return imu_pack, update_bias, torch.from_numpy(ts).to(self.device)

    def _run_reg(self, pre: PointCloud, ts: np.ndarray, inputs):
        imu_pack, update_bias, ts_d = inputs
        c = self._carry
        kfp = self.params.submap.keyframe
        kf_dt_exceeded = (c.last_kf_time <= 0.0) | ((ts_d - c.last_kf_time) >= kfp.time_threshold_seconds)
        misc = torch.cat([c.last_kf_pose.reshape(self.B, 16), update_bias[:, None],
                          kf_dt_exceeded.to(torch.float32)[:, None]], -1)
        self.x, self.P, reg_input, T_eff, is_kf, s1, result, _ = self._t._lio_step_streams(
            pre, self.submap_cloud, self._knn, self.x, self.P, imu_pack, misc, self._reg_gens)
        kf_update = is_kf & (not self._t.submap.inserts_every_frame)
        self._carry = LIOCarry(last_kf_pose=torch.where(kf_update[:, None, None], T_eff, c.last_kf_pose),
                               last_kf_time=torch.where(kf_update, ts_d, c.last_kf_time))
        self._last_reset = ts.copy()
        self.align_loops.append(result.loops)
        return reg_input, T_eff, torch.cat([s1, result.executed.to(torch.float32)[:, None]], -1)

    def _stream_result_types(self, stats: np.ndarray) -> list:
        small = stats[:, 20] > 0.5
        finite = stats[:, 21] > 0.5
        self.gyro_bias_np = stats[:, 25:28].astype(np.float32)
        self.accel_bias_np = stats[:, 28:31].astype(np.float32)
        self.velocity_np = stats[:, 31:34].astype(np.float32)
        R = lio_frame.ResultType
        return [R.error if not finite[b] else R.imu_only if small[b] else R.success for b in range(self.B)]

    # ---- IMU input -------------------------------------------------------------
    def add_imu_measurement(self, stream: int, meas: IMUMeasurement) -> None:
        """Buffer one IMU reading of one stream; readings older than
        ``imu.buffer_duration_sec`` before it are dropped."""
        buf = self._imu_buffers[stream]
        buf.append(meas)
        horizon = meas.timestamp - self.params.imu.buffer_duration_sec
        while buf and buf[0].timestamp < horizon:
            buf.popleft()
