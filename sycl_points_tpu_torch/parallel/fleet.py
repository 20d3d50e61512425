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

``mesh=`` splits the stream axis over devices, as the JAX class's GSPMD
sharding does. The mesh is a list of torch devices
(:func:`~.sharded.make_mesh`; the CPU tests pass ``[torch.device("cpu")] *
n``), and either class then makes its sharded form
(:class:`ShardedFleetOdometry`, :class:`ShardedFleetLIO`): shard ``i`` of
``n`` holds streams ``[i B / n, (i + 1) B / n)`` on ``mesh[i]`` as an
unsharded fleet of ``B / n`` streams, each stream with its global seeds.
The shards exchange nothing on the device. They agree on the host on what
JAX's one sharded array makes fleet-wide (:class:`_Exchange`): which
frames to resolve (in lockstep, frame ``f`` in every shard before ``f +
1``), and when the map grows, so that one capacity and one list of growth
events hold for the fleet. Each shard runs on a persistent host thread of
its own, on its device and on a CUDA stream of its own. The shards take
turns on the host (one lock, :func:`..utils.sync.set_host_turn`), and a
shard gives its turn up while it waits for its device or for the other
shards, so one shard's reads do not hold back another's launches, and the
threads do not hand the GIL to each other at every torch call (on the H100
a two-shard fleet frame takes 0.60-0.67 of its time without the turns;
PERF.md §6). The accessors read the whole fleet in stream order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import queue
import threading
import time
import weakref
from collections import Counter, deque
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.imu.factor import State
from sycl_points_tpu_torch.imu.preintegration import (
    IMUMeasurement,
    build_measurement_window,
    pack_steps,
    padded_steps_from_window,
)
from sycl_points_tpu_torch.lio import lio_registration as lio
from sycl_points_tpu_torch.mapping.voxel_hash_map import select_streams, stack_streams
from sycl_points_tpu_torch.ops import cuda_knn
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
from sycl_points_tpu_torch.utils import sync
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


class _MeshDispatch:
    """``cls(..., mesh=[...])`` makes the class's sharded form, whose
    ``__init__`` splits the fleet (a base class, so that the fleets' own
    ``__init__`` signatures are the ones ``inspect`` reads)."""

    def __new__(cls, *args, **kwargs):
        if not issubclass(cls, _ShardedFleet) and _arguments(cls, args, kwargs)["mesh"] is not None:
            cls = ShardedFleetLIO if issubclass(cls, FleetLIO) else ShardedFleetOdometry
        return super().__new__(cls)


class FleetOdometry(_MeshDispatch):
    """``n_streams`` LiDAR odometry streams, one launch sequence a frame;
    with ``mesh=`` (a list of devices) the call makes a
    :class:`ShardedFleetOdometry` (the module's docstring)."""

    # set on each shard of a sharded fleet: where the shards agree, and which
    # of them this one is (an unsharded fleet decides alone)
    _exchange: Optional["_Exchange"] = None
    _rank = 0

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

    def _across(self, value) -> list:
        """``value`` of every shard of the fleet, in shard order (this
        fleet's alone when it is not a shard)."""
        return [value] if self._exchange is None else self._exchange.gather(self._rank, value)

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

        while self._pending and (len(self._pending) > self._max_in_flight
                                 or all(self._across(self._pending[0].stats.ready()))):
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
            if all(self._across(bool((s0[:, 2] == 0).all()))) or attempt == submap.MAX_GROW:
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
        if max(self._across(float(s0[:, 0].max()))) > submap.MAX_LOAD:
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
        if any(self._across(bool((dropped > self._dropped_seen).any()))):
            self._retry_after_drop(pend)
            return
        self._dropped_seen = dropped
        if max(self._across(float(load.max()))) > submap.MAX_LOAD and pend.frame_index > self._load_grown_until:
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
        of each stream that inserted is rebuilt from its last extraction. A
        shard grows as its fleet does; where none of its streams is a
        keyframe, it inserts nothing."""
        sm = self._t.submap
        state = pend.prev_map_state
        extracted, inserted = None, torch.zeros(self.B, dtype=torch.bool, device=self.device)
        for j, p in enumerate([pend, *self._pending]):
            if not any(self._across(bool(p.is_kf.any()))):
                continue
            kf = None if p.sampled is None else torch.from_numpy(p.is_kf).to(self.device)
            for attempt in range(submap.MAX_GROW + 1):
                if attempt > 0 or j == 0:
                    state = self._grow_state(state)
                if kf is None:
                    new, kept = state, True
                else:
                    new, ex, _, _ = sm.insert_extract(state, p.sampled, p.T_eff)
                    new = select_streams(kf, new, state)
                    kept = to_host((new.dropped == state.dropped).all())
                if all(self._across(kept)) or attempt == submap.MAX_GROW:
                    break
            state = new
            if kf is not None:
                extracted = ex if extracted is None else pick_clouds(kf, ex, extracted)
                inserted = inserted | kf
            self._reconciled_until = max(self._reconciled_until, p.frame_index)
        self.map_state = state
        self._dropped_seen = np.asarray(to_host(state.dropped), np.int64)
        if extracted is None:
            return
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


# ---- the fleet split over devices ------------------------------------------------


def _arguments(cls, args, kwargs) -> dict:
    """The arguments of ``cls(*args, **kwargs)`` by name, defaults filled in."""
    bound = inspect.signature(cls.__init__).bind(None, *args, **kwargs)
    bound.apply_defaults()
    return dict(list(bound.arguments.items())[1:])


def _mesh_devices(mesh, device) -> list:
    """The mesh's entries as torch devices, each of ``device``'s type and
    usable; anything else is refused, not replaced."""
    devices = [torch.device(d) for d in mesh]
    if not devices:
        raise ValueError("mesh= is empty: a fleet needs at least one device")
    kind = require_device(device).type
    out = []
    for d in devices:
        if d.type != kind or kind not in ("cpu", "cuda"):
            raise ValueError(f"mesh entry {d} is not a {kind} device (the fleet's device is {device!r}; a CPU "
                             "fleet takes a mesh of CPUs, a card's fleet a mesh of cards)")
        if kind == "cuda":
            require_device(d)
            d = torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
            if d.index >= torch.cuda.device_count():
                raise ValueError(f"mesh entry {d}: only {torch.cuda.device_count()} cards are visible")
        out.append(d)
    return out


def _tensors(tree):
    """Every tensor of a cloud, a map state, a filter state or a tensor."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _tensors(v)


def _combine(fn, trees):
    """Trees of one structure (clouds, map states, filter states, tensors)
    combined leaf by leaf: ``fn(list of tensors)`` at each tensor."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(trees)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{f.name: _combine(fn, [getattr(t, f.name) for t in trees])
                                             for f in dataclasses.fields(first)})
    return type(first)(*(_combine(fn, list(vs)) for vs in zip(*trees)))


def _caller_streams(tree) -> dict:
    """The calling thread's current stream on each card that holds a tensor
    of ``tree``."""
    return {t.device: torch.cuda.current_stream(t.device) for t in _tensors(tree) if t.is_cuda}


def _receive(tree, rows: slice, device: torch.device, streams: dict):
    """Rows ``rows`` of the caller's ``tree`` on ``device``, for use on the
    calling (shard) thread's stream: that stream waits for the caller's
    (``streams``, taken on the caller's thread), and the caller's memory is
    recorded on it, so the allocator does not hand it out while the shard's
    work may still read it."""
    def part(ts):
        x = ts[0][rows]
        if x.is_cuda:
            use = torch.cuda.current_stream(x.device)
            use.wait_stream(streams[x.device])
            x.record_stream(use)
        return x.to(device)

    return _combine(part, [tree])


class _Exchange:
    """The shards of one fleet agreeing on host values: each shard's thread
    puts its own in and takes every shard's, in shard order. A barrier
    before the read and one after it keep a value from being overwritten
    while another shard still reads it. A shard that raises aborts the
    barrier, so the others stop waiting for it."""

    def __init__(self, n: int):
        self._barrier = threading.Barrier(n)
        self._values = [None] * n

    def gather(self, rank: int, value) -> list:
        with sync.waiting():
            self._values[rank] = value
            self._barrier.wait()
            values = list(self._values)
            self._barrier.wait()
        return values

    def abort(self) -> None:
        self._barrier.abort()


def _host_turn():
    """The lock the shards of one fleet take turns on for their host work
    (:func:`..utils.sync.set_host_turn`)."""
    return threading.Lock()


class _ShardThread:
    """A shard's persistent host thread: it runs the shard's work in the
    order given, inside ``torch.cuda.device(device)``, on a CUDA stream of
    its own (on the CPU, as it is) and holding the fleet's host turn but
    while it waits."""

    def __init__(self, device: torch.device, exchange: _Exchange, turn, name: str):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._exchange = exchange
        self._turn = turn
        self._jobs: queue.SimpleQueue = queue.SimpleQueue()
        self._results: queue.SimpleQueue = queue.SimpleQueue()
        threading.Thread(target=self._serve, name=name, daemon=True).start()

    def _serve(self) -> None:
        sync.set_host_turn(self._turn)
        with contextlib.ExitStack() as ctx:
            if self.stream is not None:
                ctx.enter_context(torch.cuda.device(self.device))
                ctx.enter_context(torch.cuda.stream(self.stream))
            while (job := self._jobs.get()) is not None:
                try:
                    with self._turn:
                        out = (True, job())
                except BaseException as e:  # noqa: BLE001 (handed to the caller, never dropped)
                    self._exchange.abort()
                    out = (False, e)
                self._results.put(out)
                del job, out

    def submit(self, job) -> None:
        self._jobs.put(job)

    def result(self) -> tuple:
        """``(True, value)`` or ``(False, exception)`` of the oldest job."""
        return self._results.get()

    def stop(self) -> None:
        self._jobs.put(None)


def _stop_threads(threads) -> None:
    for t in threads:
        t.stop()


class _ShardedFleet:
    """A fleet whose ``B`` streams are cut into ``n = len(mesh)`` shards, an
    unsharded fleet of ``B / n`` streams each on its device and its host
    thread (:class:`_ShardThread`), made by ``FleetOdometry(mesh=...)`` /
    ``FleetLIO(mesh=...)``.

    A call runs every shard's part on its thread and returns when all are
    done; the first exception of a shard is raised in the caller's thread,
    and the fleet then refuses further calls (its shards may be out of
    step). On the card each shard's stream waits for the caller's before it
    reads the caller's tensors, and the caller's streams wait for the
    shards' when a call returns. ``mesh_axis`` is accepted and names
    nothing: a list has no axis names."""

    _fleet_cls: type

    def __init__(self, *args, **kwargs):
        a = _arguments(self._fleet_cls, args, kwargs)
        mesh = _mesh_devices(a.pop("mesh"), a.pop("device"))
        a.pop("mesh_axis")
        B, n = int(a["n_streams"]), len(mesh)
        if B % n:
            raise ValueError(f"{B} streams do not split evenly over the {n} devices of the mesh")
        b = B // n
        initial_poses = a.pop("initial_poses")
        if initial_poses is None:
            initial_poses = np.broadcast_to(a["params"].pose.initial_matrix(), (B, 4, 4))
        self.params, self.B, self.mesh, self.device = a["params"], B, mesh, mesh[0]
        self._initial_poses = np.array(initial_poses, np.float32)
        self._rows = [slice(i * b, (i + 1) * b) for i in range(n)]
        self._failed: Optional[BaseException] = None
        self._exchange = _Exchange(n)
        turn = _host_turn()
        self._threads = [_ShardThread(d, self._exchange, turn, f"fleet shard {i}") for i, d in enumerate(mesh)]
        weakref.finalize(self, _stop_threads, self._threads)
        # per process_batch call, each shard's host reads by file:line and
        # launches by wrapper, counted on its own thread
        self.shard_counts: List[list] = []

        del a["n_streams"]
        seed = a.pop("seed")

        def make(i):
            # stream s of the fleet keeps its seeds: stream_seeds(seed, s) is
            # stream_seeds(seed + i b, s - i b)
            shard = self._fleet_cls(**a, n_streams=b, initial_poses=self._initial_poses[self._rows[i]],
                                    seed=seed + i * b, device=mesh[i])
            shard._exchange, shard._rank = self._exchange, i
            return shard

        self._shards = self._run(make)

    def _run(self, job) -> list:
        """``job(i)`` on shard ``i``'s thread for every shard, joined; the
        results in shard order."""
        if self._failed is not None:
            raise RuntimeError("a shard of this fleet raised in an earlier call; its shards may be out of step") \
                from self._failed
        for i, t in enumerate(self._threads):
            t.submit(functools.partial(job, i))
        outs = [t.result() for t in self._threads]
        errors = [v for ok, v in outs if not ok]
        if errors:
            # the shard that raised first, not the ones its abort released
            self._failed = next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)), errors[0])
            raise self._failed
        return [v for _, v in outs]

    def _join_streams(self, *devices) -> None:
        """The caller's current streams on the mesh's cards (and on
        ``devices``) wait for every shard's stream."""
        for d in {*self.mesh, *devices}:
            if d.type == "cuda":
                for t in self._threads:
                    torch.cuda.current_stream(d).wait_stream(t.stream)

    def _gather(self, trees):
        """The shards' trees stacked in stream order on ``mesh[0]``, read on
        the caller's streams."""
        def cat(parts):
            moved = []
            for x, t in zip(parts, self._threads):
                if x.is_cuda:
                    use = torch.cuda.current_stream(x.device)
                    use.wait_stream(t.stream)
                    x.record_stream(use)
                moved.append(x.to(self.device))
            return torch.cat(moved)

        return _combine(cat, trees)

    # ------------------------------------------------------------------
    def process_batch(self, clouds: PointCloud, timestamps) -> None:
        """Process one frame of every stream, as the unsharded fleet does:
        each shard its rows of ``clouds [B, N]`` and ``timestamps``."""
        B = self.B
        if clouds.points.shape[0] != B:
            raise ValueError(f"expected clouds of {B} streams, got {tuple(clouds.points.shape)}")
        ts = np.broadcast_to(np.asarray(timestamps, np.float64), (B,)).copy()
        streams = _caller_streams(clouds)

        def frame(i):
            reads, launches = Counter(sync.thread_reads()), Counter(cuda_knn.thread_launches())
            self._shards[i].process_batch(_receive(clouds, self._rows[i], self.mesh[i], streams), ts[self._rows[i]])
            return {"reads": Counter(sync.thread_reads()) - reads,
                    "launches": Counter(cuda_knn.thread_launches()) - launches}

        self.shard_counts.append(self._run(frame))
        self._join_streams(clouds.points.device)

    def flush(self) -> None:
        self._run(lambda i: self._shards[i].flush())
        self._join_streams()

    def _scatter(self, name: str, value) -> None:
        """Set ``name`` of every shard to its rows of the caller's ``value``."""
        streams = _caller_streams(value)
        self._run(lambda i: setattr(self._shards[i], name, _receive(value, self._rows[i], self.mesh[i], streams)))

    @property
    def map_capacity(self) -> int:
        return self._shards[0].map_capacity

    @property
    def growth_events(self) -> List[dict]:
        """The fleet's growths (every shard grows with it)."""
        return self._shards[0].growth_events

    @property
    def frame_count(self) -> int:
        return self._shards[0].frame_count

    @property
    def processing_times(self) -> dict:
        """Each stage's seconds in the last call, added over the shards."""
        out: dict = {}
        for s in self._shards:
            for k, v in s.processing_times.items():
                out[k] = out.get(k, 0.0) + v
        return out


def _stream_lists(name: str):
    """A per-stream list attribute of the shards, joined in stream order
    (the shards' own lists: they grow as the shards resolve frames)."""
    return property(lambda self: [x for s in self._shards for x in getattr(s, name)],
                    doc=f"``{name}`` of every stream, in stream order.")


def _stream_arrays(name: str):
    """A per-stream host array of the shards, concatenated; set row-wise."""
    def put(self, value):
        value = np.asarray(value)
        for s, rows in zip(self._shards, self._rows):
            setattr(s, name, value[rows].copy())

    return property(lambda self: np.concatenate([getattr(s, name) for s in self._shards]), put,
                    doc=f"``{name}`` of every stream, in stream order.")


def _stream_tensors(name: str):
    """A stacked device attribute of the shards, gathered on ``mesh[0]``
    (None before the shards have one); set row-wise on the shards."""
    def get(self):
        parts = [getattr(s, name) for s in self._shards]
        return None if parts[0] is None else self._gather(parts)

    return property(get, lambda self, value: self._scatter(name, value),
                    doc=f"``{name}`` of every stream, stacked on ``mesh[0]``.")


for _name in ("pose_log", "deferred_results", "align_iterations"):
    setattr(_ShardedFleet, _name, _stream_lists(_name))
for _name in ("keyframe_counts", "extract_overflow", "budget_lost"):
    setattr(_ShardedFleet, _name, _stream_arrays(_name))
for _name in ("map_state", "submap_cloud"):
    setattr(_ShardedFleet, _name, _stream_tensors(_name))


class ShardedFleetOdometry(_ShardedFleet, FleetOdometry):
    """:class:`FleetOdometry` split over a mesh (``FleetOdometry(mesh=...)``
    makes one)."""

    _fleet_cls = FleetOdometry


class ShardedFleetLIO(_ShardedFleet, FleetLIO):
    """:class:`FleetLIO` split over a mesh (``FleetLIO(mesh=...)`` makes
    one): the filter state, the covariance and the bias and velocity mirrors
    read as the whole fleet's; a stream's IMU goes to its shard."""

    _fleet_cls = FleetLIO
    x = _stream_tensors("x")
    P = _stream_tensors("P")
    gyro_bias_np = _stream_arrays("gyro_bias_np")
    accel_bias_np = _stream_arrays("accel_bias_np")
    velocity_np = _stream_arrays("velocity_np")

    @property
    def align_loops(self) -> List[int]:
        """A fleet frame's align loop: its slowest shard's."""
        return [max(v) for v in zip(*(s.align_loops for s in self._shards))]

    def add_imu_measurement(self, stream: int, meas: IMUMeasurement) -> None:
        b = self.B // len(self._shards)
        self._shards[stream // b].add_imu_measurement(stream % b, meas)
