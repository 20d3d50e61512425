"""The keyframe submap update of the odometry pipelines.

Counterpart of ``make_submap_step`` of
:mod:`sycl_points_tpu.pipeline.fused_submap`: robust-weighted sampling ->
map insert -> in-range extraction -> covariance finalize, as one plain
function. The keyframe gate and the choice of sampler, which the JAX side
runs under ``lax.cond``, are host branches here.

:func:`make_submap_step_streams` is the fleet's step (the JAX fleet's
vmapped step): every stream's sampling, insert, extraction and finalize at
once, on a stacked map state, with ``is_kf [B]`` masking the streams that
are not keyframes (their map, target and generator stay as they were).

The JAX module's growth-precompile ladder has no counterpart: it compiles
the next capacities' programs ahead of a growth event, and eager PyTorch
compiles nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from sycl_points_tpu_torch.mapping.voxel_hash_map import select_streams
from sycl_points_tpu_torch.ops.knn import BruteForceKNN
from sycl_points_tpu_torch.ops.sampling import mixed_sampling, random_sampling, sample_by_scores, stream_noise
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.registration.registration import compute_icp_robust_weights
from sycl_points_tpu_torch.utils.sync import to_host

_F32 = torch.float32


def make_submap_step(params, submap, robust_scale: Optional[float] = None):
    """The submap update for ``submap``'s backend at its current map config
    and extract capacity (all read at call time, so one step serves a map
    that grows).

    Returns ``step(map_state, submap_prev, deskewed, T_eff, is_kf, generator,
    knn_prev=None, n_desk=None) -> (new_map_state, target, sampled, stats2)``
    with ``stats2 = [load, extract_overflow, extract_ok, dropped,
    budget_lost, n_extracted]`` (float32, on the device). ``is_kf`` is a host
    bool (on the occupancy grid, every frame that passes the inlier gate is
    one); off a keyframe the map and the target pass through and ``sampled``
    is None. ``knn_prev`` is the prepared search structure of
    ``submap_prev`` when the caller has one; ``n_desk`` the valid count of
    ``deskewed`` when the host knows it (else it is fetched).
    ``robust_scale=None`` takes the registration's default scale for the
    sampling weights.
    """
    sp = params.submap
    min_pts = params.registration.min_num_points
    num = sp.point_random_sampling_num
    need_finalize = submap._need_covs or submap._need_normals

    def stats(*values) -> torch.Tensor:
        return torch.stack([v.to(_F32) for v in values])

    def submap_step(map_state, submap_prev: PointCloud, deskewed: PointCloud, T_eff: torch.Tensor,
                    is_kf: bool, generator: torch.Generator,
                    knn_prev: Optional[BruteForceKNN] = None, n_desk: Optional[int] = None):
        zero = torch.zeros((), dtype=_F32, device=T_eff.device)
        if not is_kf:
            stats2 = stats(submap.map_module.load_factor(map_state, submap.map_config), zero, zero,
                           map_state.dropped, map_state.budget_lost, zero)
            return map_state, submap_prev, None, stats2

        if n_desk is None:
            n_desk = to_host(deskewed.count())
        if n_desk > num:
            if knn_prev is None:
                knn_prev = BruteForceKNN.build(submap_prev)
            w = compute_icp_robust_weights(
                deskewed, submap_prev, knn_prev, T_eff, params.registration.factor, robust_scale)
            sampled = mixed_sampling(deskewed, num, w, generator, sp.weighted_sampling_ratio)
        else:
            sampled = random_sampling(deskewed, num, generator)

        new_state, extracted, load, overflow = submap.insert_extract(map_state, sampled, T_eff)
        n_extracted = extracted.count()
        ext_ok = n_extracted >= min_pts
        target = PointCloud(
            points=torch.where(ext_ok, extracted.points, submap_prev.points),
            mask=torch.where(ext_ok, extracted.mask, submap_prev.mask),
        )
        if need_finalize:
            target = submap.finalize_traced(target)
        stats2 = stats(load, overflow, ext_ok, new_state.dropped, new_state.budget_lost, n_extracted)
        return new_state, target, sampled, stats2

    return submap_step


def pick_clouds(flag: torch.Tensor, a: PointCloud, b: PointCloud) -> PointCloud:
    """Stream by stream, the fields of a fleet's cloud ``a`` where ``flag
    [B]`` holds, else those of ``b`` (a field missing from either is
    dropped)."""
    def pick(x, y):
        if x is None or y is None:
            return None
        return torch.where(flag.reshape(flag.shape + (1,) * (x.dim() - 1)), x, y)

    return PointCloud(**{f: pick(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__})


def make_submap_step_streams(params, submap, robust_scale: Optional[float] = None):
    """The fleet's submap update at ``submap``'s current map config and
    extract capacity (read at call time).

    Returns ``step(map_state, target_prev, knn_prev, deskewed, T_eff, is_kf,
    n_desk, generators) -> (new_map_state, target, sampled, stats2)`` over
    ``B`` streams: a stacked map state, the targets ``[B, M]`` and their
    prepared search structure, the registration outputs ``[B, N]`` and
    ``[B, 4, 4]``, and the host arrays ``is_kf [B]`` and ``n_desk [B]``
    (read once with the keyframe flags). Stream ``b`` computes what
    :func:`make_submap_step` computes for it with ``generators[b]``: a
    keyframe stream draws its sample (weighted when it holds more than the
    sample size), inserts, extracts and finalizes its new target; any other
    stream keeps its map and target and draws nothing. ``stats2`` is
    ``[B, 6]`` in :func:`make_submap_step`'s layout; ``sampled`` is the
    fleet's sample (no valid point off a keyframe), None when no stream is a
    keyframe."""
    sp = params.submap
    min_pts = params.registration.min_num_points
    num = sp.point_random_sampling_num
    need_finalize = submap._need_covs or submap._need_normals

    def stats(*values) -> torch.Tensor:
        return torch.stack([v.to(_F32) for v in values], -1)

    def step(map_state, target_prev: PointCloud, knn_prev, deskewed: PointCloud, T_eff: torch.Tensor,
             is_kf, n_desk, generators):
        dev = T_eff.device
        kf = torch.as_tensor(is_kf, device=dev)
        zero = torch.zeros(kf.shape, dtype=_F32, device=dev)
        if not is_kf.any():
            load = submap.map_module.load_factor(map_state, submap.map_config)
            return map_state, target_prev, None, stats(load, zero, zero, map_state.dropped,
                                                       map_state.budget_lost, zero)

        if num >= deskewed.capacity:
            sampled = deskewed
        else:
            weighted = is_kf & (n_desk > num)
            noise0 = stream_noise(generators, deskewed.capacity, dev, draw=is_kf)
            sampled = sample_by_scores(deskewed, num, noise0)
            if weighted.any():
                noise1 = stream_noise(generators, deskewed.capacity, dev, draw=weighted)
                w = compute_icp_robust_weights(
                    deskewed, target_prev, knn_prev, T_eff, params.registration.factor, robust_scale)
                mixed = mixed_sampling(deskewed, num, w, weighted_ratio=sp.weighted_sampling_ratio,
                                       noise=(noise0, noise1))
                sampled = pick_clouds(torch.as_tensor(weighted, device=dev), mixed, sampled)
        sampled = sampled.replace(mask=sampled.mask & kf[:, None])

        new_state, extracted, _, overflow = submap.insert_extract(map_state, sampled, T_eff)
        new_state = select_streams(kf, new_state, map_state)
        n_extracted = torch.where(kf, extracted.count(), 0)
        ext_ok = kf & (n_extracted >= min_pts)
        target = PointCloud(points=extracted.points, mask=extracted.mask)
        if need_finalize:
            target = submap.finalize_traced(target)
        target = pick_clouds(ext_ok, target, target_prev)
        load = submap.map_module.load_factor(new_state, submap.map_config)
        stats2 = stats(load, torch.where(kf, overflow, 0), ext_ok, new_state.dropped, new_state.budget_lost,
                       n_extracted)
        return new_state, target, sampled, stats2

    return step
