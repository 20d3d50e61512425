"""The keyframe submap update of the odometry pipelines.

Counterpart of ``make_submap_step`` of
:mod:`sycl_points_tpu.pipeline.fused_submap`: robust-weighted sampling ->
map insert -> in-range extraction -> covariance finalize, as one plain
function. The keyframe gate and the choice of sampler, which the JAX side
runs under ``lax.cond``, are host branches here.

The JAX module's growth-precompile ladder has no counterpart: it compiles
the next capacities' programs ahead of a growth event, and eager PyTorch
compiles nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from sycl_points_tpu_torch.ops.knn import BruteForceKNN
from sycl_points_tpu_torch.ops.sampling import mixed_sampling, random_sampling
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
