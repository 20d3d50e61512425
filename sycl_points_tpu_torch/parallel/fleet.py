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

The JAX class's ``mesh=`` (GSPMD sharding of the stream axis over chips) has
no use on one card; it raises here (ROADMAP Queue 1 item 12). The LIO fleet
(``FleetLIO``) is not ported yet (ROADMAP Queue 1 item 11.1b).
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from sycl_points_tpu_torch.mapping.voxel_hash_map import select_streams, stack_streams
from sycl_points_tpu_torch.ops.knn import BruteForceKNN
from sycl_points_tpu_torch.ops.sampling import random_sampling_streams
from sycl_points_tpu_torch.ops.transform import transform_cloud
from sycl_points_tpu_torch.pipeline import pc_processor, submap
from sycl_points_tpu_torch.pipeline.fused_submap import make_submap_step_streams, pick_clouds
from sycl_points_tpu_torch.pipeline.lidar_odometry import _S1, ResultType
from sycl_points_tpu_torch.pipeline.params import LidarOdometryParams
from sycl_points_tpu_torch.pipeline.pipelined_odometry import OdomCarry, PipelinedLidarOdometry
from sycl_points_tpu_torch.points.point_cloud import PointCloud, compact_device
from sycl_points_tpu_torch.registration.map_prior import MapPriorParams
from sycl_points_tpu_torch.utils.sync import DeferredFetch, to_host

_F32 = torch.float32


def stream_seeds(seed: int, stream: int) -> tuple[int, int]:
    """``(preprocess seed, submap seed)`` of a fleet's stream: the
    single-stream pipeline's (:data:`..pipeline.pc_processor.SEED`,
    :data:`..pipeline.submap.SEED`) offset by ``seed + stream``."""
    return pc_processor.SEED + seed + stream, submap.SEED + seed + stream


class _Pending(NamedTuple):
    """A fleet frame in flight (device handles: holding them reads nothing)."""

    stats: DeferredFetch  # [B, _S1 + 6]
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
                f"mesh= (sharding the {mesh_axis!r} axis over chips) has no use on one card "
                "(ROADMAP Queue 1 item 12)")
        # the template holds the parameters, the preprocessor and the submap
        # config; its own single-stream map is freed
        t = PipelinedLidarOdometry(params, map_prior_params, device=device)
        t.submap.map_state = None
        self._t = t
        self.params = params
        self.device = t.device
        self.B = int(n_streams)
        self._max_in_flight = max(1, max_in_flight)
        seeds = [stream_seeds(seed, s) for s in range(self.B)]
        self._pre_gens = [torch.Generator(device=self.device).manual_seed(a) for a, _ in seeds]
        self._map_gens = [torch.Generator(device=self.device).manual_seed(b) for _, b in seeds]
        self._need_covs = t._needs_covariances()
        self._submap_step = make_submap_step_streams(params, t.submap, t._submap_robust_scale)

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
            dts = np.where(ts > self._last_ts, ts - self._last_ts, 0.1)
            # the frame's host inputs go up while the stream is idle (the last
            # frame ended in a read), so the copy waits for nothing
            dt_d = torch.from_numpy(dts.astype(np.float32)).to(self.device)
            ts_d = torch.from_numpy(ts).to(self.device)
        pre = self._t.pc_processor.preprocess_streams(clouds, self._pre_gens, self._need_covs)
        t0 = self._stage("1. preprocessing", t0)
        if self._carry is None:
            self._bootstrap_streams(pre, ts)
            self._stage("4a. submap dispatch", t0)
            return
        self._last_ts = ts

        # ---- registration: prediction, align, keyframe decision, carry ----
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
        t0 = self._stage("3. registration", t0)

        # ---- the submap step: the keyframe flags and valid counts in one read ----
        n_desk, kf = np.asarray(to_host(s1[:, 19:21])).T
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
        self._dropped_seen = s0[:, 2].astype(np.int64)
        self.extract_overflow = s0[:, 1].astype(np.int64)
        self.budget_lost = s0[:, 3].astype(np.int64)
        if float(s0[:, 0].max()) > submap.MAX_LOAD:
            self._grow_fleet()
        self._last_ts = ts
        self.frame_count += 1

    # ------------------------------------------------------------------
    def _resolve_one(self, pend: _Pending) -> None:
        stats = pend.stats.get().astype(np.float64)  # [B, _S1 + 6]
        B = self.B
        T_np = stats[:, :16].reshape(B, 4, 4).astype(np.float32)
        small = stats[:, 21] > 0.5
        load, overflow = stats[:, _S1], stats[:, _S1 + 1]
        dropped = stats[:, _S1 + 3].astype(np.int64)
        for b in range(B):
            rtype = ResultType.small_number_of_points if small[b] else ResultType.success
            self.deferred_results[b].append((pend.frame_index, rtype))
            self.pose_log[b].append((pend.frame_index, float(pend.timestamps[b]), T_np[b], rtype))
            self.align_iterations[b].append(int(stats[b, 23]))
        self.keyframe_counts += pend.is_kf
        # only an insert extracts: a stream off a keyframe keeps its mirror
        self.extract_overflow = np.where(pend.is_kf, overflow.astype(np.int64), self.extract_overflow)
        self.budget_lost = stats[:, _S1 + 4].astype(np.int64)

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
