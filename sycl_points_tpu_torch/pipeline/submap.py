"""Submap management: keyframing, map insertion and target preparation.

Counterpart of :mod:`sycl_points_tpu.pipeline.submap` on both map backends,
the occupancy grid (``OCCUPANCY_GRID_MAP``, the default) and the voxel-hash
map: the keyframe policy (distance >= 2 m or angle >= 20 deg or dt >= 1 s by
default, behind an inlier-ratio gate; the occupancy grid inserts every frame
that passes the gate), per-insert weighted or uniform sampling to
``point_random_sampling_num`` points, insertion into the map with the growth
policy, extraction of the target within range (the occupied voxels, on the
occupancy grid), and the target's search structure and covariances /
normals as the registration type needs.

The search structure (``submap_knn``) comes from ``ops.knn.build_target_knn``
wherever the JAX class calls it (and on the LO / LIO frames' inserts): the
target prepared for the ``nn1`` kernel, or a ``GridKNN`` above
``GRID_KNN_TARGET_THRESHOLD`` rows (never, at the default). It is rebuilt
only when the target changes (inserts, growth), never per registration
iteration.

The pipelined frames' drop-retry reconcile re-applies a window of stashed
inserts in one call (:meth:`Submap.reconcile_chain`). The JAX class's jit
caches and compile log have nothing to hold in eager PyTorch.

:meth:`Submap.insert_extract` and :meth:`Submap.finalize_traced` take a
fleet's stacked map state (``[B, ...]``), clouds ``[B, N]`` and poses
``[B, 4, 4]`` as well: the fleet's submap step
(:func:`.fused_submap.make_submap_step_streams`) runs on them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.mapping import occupancy_grid as og
from sycl_points_tpu_torch.mapping import voxel_hash_map as vhm
from sycl_points_tpu_torch.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu_torch.ops.knn import build_target_knn, self_knn, self_knn_streams
from sycl_points_tpu_torch.ops.sampling import mixed_sampling, random_sampling
from sycl_points_tpu_torch.ops.transform import transform_cloud
from sycl_points_tpu_torch.pipeline.params import CommonParameters
from sycl_points_tpu_torch.points.point_cloud import PointCloud, compact_device
from sycl_points_tpu_torch.registration.factors import RegType
from sycl_points_tpu_torch.utils import lie_np
from sycl_points_tpu_torch.utils.sync import to_host

SEED = 4321
MAX_LOAD = 0.7  # grow the table above this load factor
MAX_GROW = 8


class Submap:
    def __init__(self, params: CommonParameters, device: torch.device | str = "cuda"):
        self.params = params
        self.device = require_device(device)
        sp = params.submap
        map_type = sp.map_type.upper()
        if map_type not in ("OCCUPANCY_GRID_MAP", "VOXEL_HASH_MAP"):
            raise ValueError(f"unknown map_type {sp.map_type!r}")
        self.is_occupancy = map_type == "OCCUPANCY_GRID_MAP"
        if self.is_occupancy:
            ogp = sp.occupancy_grid_map
            self.og_config = og.OccupancyGridConfig(
                voxel_size=sp.voxel_size, capacity=sp.map_capacity,
                log_odds_hit=ogp.log_odds_hit, log_odds_miss=ogp.log_odds_miss,
                min_log_odds=ogp.log_odds_limits_min, max_log_odds=ogp.log_odds_limits_max,
                occupancy_threshold_log_odds=og.probability_to_log_odds(ogp.occupied_threshold),
                stale_frame_threshold=ogp.stale_frame_threshold,
                free_space_updates_enabled=ogp.enable_free_space_updates,
                free_space_update_cycle=ogp.free_space_update_cycle,
                voxel_pruning_enabled=ogp.enable_pruning,
            )
        else:
            self.vhm_config = vhm.VoxelHashMapConfig(
                voxel_size=sp.voxel_size, capacity=sp.map_capacity,
                max_staleness=sp.max_staleness,
                remove_old_data_cycle=sp.remove_old_data_cycle,
            )
        self.map_state = self.map_module.create(self.map_config, self.device)

        initial = np.asarray(params.pose.initial_matrix())
        self.last_keyframe_pose = initial
        self.last_keyframe_time = -1.0
        self.keyframe_poses: List[np.ndarray] = [initial]
        self._generator = torch.Generator(device=self.device).manual_seed(SEED)

        self.submap_cloud: Optional[PointCloud] = None
        self.submap_knn = None  # BruteForceKNN, or GridKNN above the threshold
        self.last_keyframe_cloud: Optional[PointCloud] = None
        # Telemetry (no silent caps): in-range voxels that did not fit the
        # extract capacity on the latest insert, and cumulative fixed-budget
        # losses (a larger table cannot fix those, see the map backend).
        self.extract_overflow = 0
        self.budget_lost = 0
        # Extract capacity tiers with map growth: params.extract_capacity is
        # the base tier; when the map doubles, the extraction budget follows
        # at the same ratio, and the overflow counter grows it directly as a
        # backstop (resolve_extract_overflow), so the target is never
        # silently truncated.
        self.extract_capacity = sp.extract_capacity
        self._extract_ratio = max(1, sp.map_capacity // sp.extract_capacity)
        self._extract_growth = sp.extract_capacity_growth

        reg_type = params.registration.factor.reg_type
        self._need_covs = (
            reg_type in (RegType.GICP, RegType.POINT_TO_DISTRIBUTION, RegType.GENZ)
            or params.registration.factor.rotation_constraint.enable
        )
        self._need_normals = reg_type in (RegType.POINT_TO_PLANE, RegType.GENZ)

    # ------------------------------------------------------------------
    @property
    def map_module(self):
        """The backend's module: :mod:`.occupancy_grid` or :mod:`.voxel_hash_map`."""
        return og if self.is_occupancy else vhm

    @property
    def map_config(self):
        return self.og_config if self.is_occupancy else self.vhm_config

    @map_config.setter
    def map_config(self, cfg) -> None:
        if self.is_occupancy:
            self.og_config = cfg
        else:
            self.vhm_config = cfg

    @property
    def map_capacity(self) -> int:
        return self.map_config.capacity

    @property
    def inserts_every_frame(self) -> bool:
        """The occupancy grid takes every frame that passes the inlier gate
        and keeps no keyframes; the voxel-hash map takes keyframes only."""
        return self.is_occupancy

    def occupied_voxels(self) -> int:
        """The voxels extraction may take (a host read): on the occupancy
        grid, those hit with log-odds at or above the threshold; on the
        voxel-hash map, every voxel."""
        if self.is_occupancy:
            return int(og._occupied_mask(self.map_state, self.og_config).sum())
        return int(self.map_state.used.sum())

    def _pose_tensor(self, pose) -> torch.Tensor:
        if isinstance(pose, torch.Tensor):
            return pose.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(np.ascontiguousarray(pose, dtype=np.float32)).to(self.device)

    def _extract(self, state, origin: torch.Tensor, cfg=None, ext_cap: Optional[int] = None):
        """The target around ``origin``, at ``cfg`` and ``ext_cap`` (default:
        the current map config and extract capacity)."""
        cfg = self.map_config if cfg is None else cfg
        ext_cap = self.extract_capacity if ext_cap is None else ext_cap
        if self.is_occupancy:
            return og.extract_occupied_points(
                state, cfg, origin, self.params.submap.max_distance_range,
                out_capacity=ext_cap, with_overflow=True,
            )
        return vhm.extract(
            state, cfg, origin, self.params.submap.max_distance_range,
            out_capacity=ext_cap, with_covs=False, with_overflow=True,
        )

    def _insert(self, state, cfg, cloud: PointCloud, pose: torch.Tensor):
        """Insert ``cloud`` at ``pose`` into ``state`` (left as it was) and
        prune stale voxels: the voxel-hash map every
        ``remove_old_data_cycle`` inserts, the occupancy grid inside its
        insert."""
        ns = self.map_module.add_point_cloud(state, cfg, cloud, pose)
        if not self.is_occupancy and cfg.remove_old_data_cycle > 0:
            # Both sides of the JAX lax.cond, selected on the device: pruning
            # is a dozen elementwise kernels, a host branch would be a sync.
            pruned = vhm.remove_old_data(ns, cfg)
            ns = vhm.select_streams(ns.frame % cfg.remove_old_data_cycle == 0, pruned, ns)
        return ns

    def insert_extract(self, state, cloud: PointCloud, pose: torch.Tensor):
        """Insert ``cloud`` at ``pose`` into ``state`` (left as it was), prune
        stale voxels, and extract the target around the pose at the current
        map config and extract capacity: ``(new_state, extracted, load,
        extract_overflow)``, the last two on the device."""
        cfg = self.map_config
        ns = self._insert(state, cfg, cloud, pose)
        extracted, overflow = self._extract(ns, pose[..., :3, 3])
        return ns, extracted, self.map_module.load_factor(ns, cfg), overflow

    def _set_target(self, target: PointCloud) -> None:
        """Finalize ``target`` and prepare its search structure."""
        self.submap_cloud = self._finalize_target(target)
        self.submap_knn = self._target_knn(self.submap_cloud)

    def _target_knn(self, target: PointCloud):
        """The target's search structure (``ops.knn.build_target_knn``): a
        prepared brute-force target, or a ``GridKNN`` with the correspondence
        gate as its cell above ``GRID_KNN_TARGET_THRESHOLD`` rows."""
        return build_target_knn(
            target, max_correspondence_distance=self.params.registration.factor.max_correspondence_distance)

    def extract_tier_for(self, map_capacity: int) -> int:
        """The extract capacity the tiering policy pairs with a map capacity:
        the base budget scaled by the map's growth factor. Never shrinks."""
        if not self._extract_growth:
            return self.extract_capacity
        tier = max(self.params.submap.extract_capacity, map_capacity // self._extract_ratio)
        return max(tier, self.extract_capacity)

    def _grow_map(self, reextract: bool = True, origin=None) -> None:
        """Double the map capacity. The extract capacity tiers up with it;
        when the tier changes, the target is re-extracted at the new shape,
        so that the next keyframe can select between the new extraction and
        the kept target. Callers whose own loop extracts right after pass
        ``reextract=False``. ``origin`` (a [3] position or [4,4] pose)
        centres the re-extraction; the default is the last keyframe pose,
        which the occupancy grid never moves: its callers pass the frame's."""
        self.map_state, self.map_config = self.map_module.grow(self.map_state, self.map_config)
        old_ext = self.extract_capacity
        self.extract_capacity = self.extract_tier_for(self.map_capacity)
        if reextract and self.extract_capacity != old_ext and self.submap_cloud is not None:
            self._reextract_target(self.last_keyframe_pose if origin is None else origin)

    def grow_extract_capacity(self) -> None:
        """Double the extraction budget directly: the backstop for an
        in-range voxel set that outgrows its tier without the map growing."""
        self.extract_capacity = self.extract_capacity * 2

    def _reextract_target(self, origin) -> None:
        """Re-extract the target from the committed map state at the current
        extract capacity and rebuild the search structure (slow path: host
        reads). When the extraction comes up short of ``min_num_points``,
        the previous target is kept, mask-padded to the new capacity."""
        origin = np.asarray(origin, np.float32)
        if origin.shape == (4, 4):
            origin = origin[:3, 3]
        extracted, overflow = self._extract(self.map_state, self._pose_tensor(origin))
        self.extract_overflow, n = to_host(torch.stack([overflow, extracted.count()]))
        prev = self.submap_cloud
        pad = 0 if prev is None else self.extract_capacity - prev.capacity
        if n >= self.params.registration.min_num_points or prev is None or pad < 0:
            target = PointCloud(points=extracted.points, mask=extracted.mask)
        else:
            target = PointCloud(
                points=torch.cat([prev.points, prev.points.new_zeros((pad, 3))]),
                mask=torch.cat([prev.mask, prev.mask.new_zeros(pad)]),
            )
        self._set_target(target)

    def resolve_extract_overflow(self, origin, max_grow: int = 6) -> bool:
        """Slow path: the latest extraction overflowed its budget. Grow the
        extract capacity and re-extract the target around ``origin`` until
        the in-range set fits. Returns True when the target was rebuilt."""
        if not self._extract_growth or self.extract_overflow <= 0:
            return False
        changed = False
        for _ in range(max_grow):
            if self.extract_overflow <= 0 or self.extract_capacity >= self.map_capacity:
                break
            self.grow_extract_capacity()
            self._reextract_target(origin)
            changed = True
        return changed

    # ------------------------------------------------------------------
    def add_first_frame(self, cloud: PointCloud, timestamp: float, current_pose: np.ndarray) -> None:
        self.last_keyframe_pose = np.asarray(current_pose)
        self.keyframe_poses = [self.last_keyframe_pose]
        self._build_submap(cloud, self.last_keyframe_pose, is_first_frame=True)
        self.last_keyframe_time = timestamp

    def add_frame(self, cloud: PointCloud, reg_T: np.ndarray, inlier_ratio: float, timestamp: float,
                  sampling_weights: Optional[torch.Tensor] = None) -> bool:
        """Inlier gate, keyframe policy, insertion; True when the frame was
        inserted. The occupancy grid inserts every frame that passes the
        gate, with no keyframe bookkeeping."""
        kf = self.params.submap.keyframe
        if kf.inlier_ratio_threshold > 0.0 and inlier_ratio <= kf.inlier_ratio_threshold:
            return False
        if not (self.inserts_every_frame or self._is_keyframe(reg_T, timestamp)):
            return False
        self._record_keyframe(reg_T, timestamp)
        self._build_submap(cloud, reg_T, False, sampling_weights)
        return True

    def _record_keyframe(self, pose, timestamp: float) -> None:
        """Keyframe bookkeeping (pose, time, list), on the voxel-hash map only."""
        if self.inserts_every_frame:
            return
        self.last_keyframe_pose = np.array(pose)
        self.last_keyframe_time = timestamp
        self.keyframe_poses.append(self.last_keyframe_pose)

    def commit_insert(self, target: PointCloud, sampled: PointCloud, extract_overflow, pose,
                      timestamp: float) -> None:
        """Commit a frame that the fused submap step inserted: the new target
        and its search structure (prepared once, here), the insert's sample
        and extraction overflow, and the keyframe bookkeeping."""
        self.submap_cloud = target
        self.submap_knn = self._target_knn(target)
        self.extract_overflow = int(extract_overflow)
        self.last_keyframe_cloud = sampled
        self._record_keyframe(pose, timestamp)

    def _is_keyframe(self, T: np.ndarray, timestamp: float) -> bool:
        delta = np.linalg.inv(self.last_keyframe_pose) @ np.asarray(T)
        dist = float(np.linalg.norm(delta[:3, 3]))
        angle = float(np.linalg.norm(lie_np.se3_log(delta)[:3])) * 180.0 / np.pi
        dt = timestamp - self.last_keyframe_time if self.last_keyframe_time > 0.0 else float("inf")
        kf = self.params.submap.keyframe
        return (
            dist >= kf.distance_threshold
            or angle >= kf.angle_threshold_degrees
            or dt >= kf.time_threshold_seconds
        )

    def _insert_with_growth(self, sampled: PointCloud, pose: torch.Tensor, grow_first: bool, attempts: int):
        """Insert with the growth policy: retry the same insert on a doubled
        table while any contribution was dropped on probe exhaustion (the
        state from before the insert is kept, so nothing is lost).
        Fixed-budget losses (``budget_lost``) recur at any capacity and never
        trigger growth. Commits the state and the telemetry; returns
        ``(extracted, load, n_extracted)`` with the last two on the host."""
        for attempt in range(attempts):
            if grow_first or attempt > 0:
                self._grow_map(reextract=False)
            new_state, extracted, load, overflow = self.insert_extract(self.map_state, sampled, pose)
            dropped, before, overflow_h, lost, load_h, n_ext = to_host(torch.stack([
                new_state.dropped, self.map_state.dropped, overflow, new_state.budget_lost,
                load, extracted.count(),
            ]).to(torch.float64))
            if dropped == before:
                break
        self.map_state = new_state
        self.extract_overflow = int(overflow_h)
        self.budget_lost = int(lost)
        return extracted, load_h, int(n_ext)

    def _build_submap(self, cloud: PointCloud, pose, is_first_frame: bool, weights=None) -> None:
        """Sample -> insert -> extract -> search structure and covariances."""
        num = self.params.submap.point_random_sampling_num
        if weights is not None:
            sampled = mixed_sampling(cloud, num, weights, self._generator,
                                     self.params.submap.weighted_sampling_ratio)
        else:
            sampled = random_sampling(cloud, num, self._generator)
        self.last_keyframe_cloud = sampled
        pose_t = self._pose_tensor(pose)
        extracted, load, n_ext = self._insert_with_growth(sampled, pose_t, grow_first=False,
                                                          attempts=MAX_GROW + 1)

        if is_first_frame:
            c = transform_cloud(compact_device(cloud, out_capacity=self.extract_capacity), pose_t)
            self._set_target(PointCloud(points=c.points, mask=c.mask))
        elif n_ext >= self.params.registration.min_num_points:
            self._set_target(extracted)
        elif self.submap_cloud is not None and self.submap_cloud.capacity != self.extract_capacity:
            # The previous target is kept, but the retry loop changed the
            # extract tier: pad it to the new shape.
            self._reextract_target(np.asarray(pose))
        if not is_first_frame and self.extract_overflow > 0:
            self.resolve_extract_overflow(np.asarray(pose))
        if load > MAX_LOAD:
            self._grow_map(origin=np.asarray(pose))

    def retry_insert_after_drop(self, sampled: PointCloud, pose_np, grow_first: bool = True) -> None:
        """Slow-path growth retry of the frame step: the caller restored the
        state from before the insert after seeing probe-exhaustion drops, so
        growing and running the same insert again loses nothing.
        ``grow_first=False`` tries the current capacity first (a stashed
        insert re-applied after an earlier one has grown the table)."""
        extracted, load, n_ext = self._insert_with_growth(
            sampled, self._pose_tensor(pose_np), grow_first=grow_first, attempts=MAX_GROW)
        if n_ext >= self.params.registration.min_num_points:
            self._set_target(PointCloud(points=extracted.points, mask=extracted.mask))
        elif self.submap_cloud is not None and self.submap_cloud.capacity != self.extract_capacity:
            self._reextract_target(pose_np)
        if self.extract_overflow > 0:
            self.resolve_extract_overflow(pose_np)
        if load > MAX_LOAD:
            self._grow_map(origin=np.asarray(pose_np))

    # -- the pipelined drop-retry reconcile --------------------------------
    def make_reapply_chain(self, cfg, window: int, ext_cap: Optional[int] = None):
        """The reconcile of the pipelined frames as one function: re-apply a
        window of ``window`` stashed inserts (oldest first) to a map state at
        ``cfg``, then extract once around the newest real pose, at
        ``ext_cap`` rows (default: the current extract capacity).

        Returns ``chain(state, clouds, poses, valid) -> (new_state, extracted,
        load, extract_overflow)``; the slots whose host flag ``valid`` is
        False are padding: they insert nothing, so the map's ``frame``
        counter advances only on real inserts. The JAX package compiles one
        program per (capacity, window, extract capacity) and caches it
        (``chain_fn_for``); eager PyTorch compiles nothing, so there is no
        cache, and the loop over the slots is a host loop."""
        ext = self.extract_capacity if ext_cap is None else ext_cap
        if not 0 < window:
            raise ValueError(f"window must be positive, got {window}")

        def chain(state, clouds, poses, valid):
            if len(clouds) != window or len(poses) != window or len(valid) != window:
                raise ValueError(f"the chain takes {window} slots")
            real = [i for i, v in enumerate(valid) if v]
            for i in real:
                state = self._insert(state, cfg, clouds[i], poses[i])
            origin = poses[real[-1] if real else 0][:3, 3]
            extracted, overflow = self._extract(state, origin, cfg, ext)
            return state, extracted, self.map_module.load_factor(state, cfg), overflow

        return chain

    def reconcile_chain(self, clouds, poses, window: int, grow_first: bool = True) -> None:
        """The pipelined frames' slow path after a drop: the caller has rolled
        ``map_state`` back to the state before the oldest of ``clouds``;
        re-apply them all (the frame that dropped and every later frame in
        flight, oldest first, ``poses`` as [4, 4] arrays or device tensors; a
        frame that inserted nothing stashed ``None``, which takes a padding
        slot) through :meth:`make_reapply_chain`, padded to ``window`` slots, and
        retry from the rolled-back state on a grown table until nothing is
        dropped (at most ``MAX_GROW`` growths). Then commit as
        :meth:`retry_insert_after_drop` does: the target, the telemetry, the
        extract backstop and the load growth. Fixed-budget losses
        (``budget_lost``) never trigger growth."""
        W = len(clouds)
        if W == 0:
            return
        if W > window:
            raise ValueError(f"reconcile window {W} > chain capacity {window}")
        pad = window - W
        clouds_t = list(clouds) + [None] * pad
        poses_t = [self._pose_tensor(T) for T in poses]
        poses_t += [poses_t[-1]] * pad
        valid = [c is not None for c in clouds] + [False] * pad
        for attempt in range(MAX_GROW + 1):
            if grow_first or attempt > 0:
                self._grow_map(reextract=False)
            ns, extracted, load, overflow = self.make_reapply_chain(self.map_config, window)(
                self.map_state, clouds_t, poses_t, valid)
            fetched = to_host(torch.cat([
                torch.stack([ns.dropped, self.map_state.dropped, overflow, ns.budget_lost,
                             extracted.count()]).to(torch.float32),
                load.reshape(1).to(torch.float32), poses_t[W - 1].reshape(-1)]))
            dropped, before, overflow_h, lost, n_ext, load_h = fetched[:6]
            if dropped == before or attempt == MAX_GROW:
                break
        last_pose = np.asarray(fetched[6:], np.float32).reshape(4, 4)
        self.map_state = ns
        self.extract_overflow = int(overflow_h)
        self.budget_lost = int(lost)
        if n_ext >= self.params.registration.min_num_points:
            self._set_target(PointCloud(points=extracted.points, mask=extracted.mask))
        elif self.submap_cloud is not None and self.submap_cloud.capacity != self.extract_capacity:
            self._reextract_target(last_pose)
        if self.extract_overflow > 0:
            self.resolve_extract_overflow(last_pose)
        if load_h > MAX_LOAD:
            self._grow_map(origin=last_pose)

    # ------------------------------------------------------------------
    def finalize_traced(self, cloud: PointCloud) -> PointCloud:
        """Target finalize: neighbourhood covariances (and normals, as the
        registration type requires) from the exact self-k-NN, the ``knn_k``
        kernel on the card."""
        k = self.params.covariance_estimation.neighbor_num
        covs = cloud.covs
        if covs is None:
            knn = self_knn_streams if cloud.points.dim() == 3 else self_knn
            covs = estimate_covariances(cloud.points, knn(cloud.points.contiguous(), cloud.mask, k))
        normals = cloud.normals
        if self._need_normals and normals is None:
            normals = extract_normals(cloud.points, covs)
        return cloud.replace(covs=covs, normals=normals)

    def _finalize_target(self, cloud: PointCloud) -> PointCloud:
        if not (self._need_covs or self._need_normals):
            return cloud
        return self.finalize_traced(cloud)
