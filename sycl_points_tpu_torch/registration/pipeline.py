"""Registration pipeline: input sampling -> robust-scale annealing -> align.

Counterpart of :mod:`sycl_points_tpu.registration.pipeline`. Without the
velocity update all annealing levels run in one :func:`~.registration.align`
loop; with it (VICP) each level runs ``iter`` constant-velocity deskew passes,
each followed by an align from the pose so far. The input sampling is
uniform, or intensity-weighted (``use_intensities``: ``weighted_ratio`` of
the draw weighted by the source's intensities, the rest uniform) when the
source has intensities.

:func:`align_pipeline_streams` is the fleet's form: one sampling draw (each
single-stream call draws the same one from the default seed) and one
:func:`~.registration.align_streams` loop through the robust schedule.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from sycl_points_tpu_torch.deskew.constant_velocity import deskew_constant_velocity
from sycl_points_tpu_torch.ops.robust import RobustLossType
from sycl_points_tpu_torch.ops.sampling import gumbel_noise, mixed_sampling, random_sampling, sample_by_scores
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.registration.registration import (
    RegistrationParams,
    RegistrationResult,
    align,
    align_streams,
)

DEFAULT_SEED = 1234  # the reference's default sampling seed


@dataclasses.dataclass(frozen=True)
class RandomSamplingParams:
    enable: bool = True
    num: int = 1000
    use_intensities: bool = False
    weighted_ratio: float = 0.8


@dataclasses.dataclass(frozen=True)
class RobustScheduleParams:
    auto_scale: bool = False
    init_scale: float = 10.0
    min_scale: float = 0.5
    rotation_init_scale: float = 10.0
    rotation_min_scale: float = 0.5
    auto_scaling_iter: int = 4


@dataclasses.dataclass(frozen=True)
class VelocityUpdateParams:
    enable: bool = False
    iter: int = 1


@dataclasses.dataclass(frozen=True)
class RegistrationPipelineParams:
    registration: RegistrationParams = RegistrationParams()
    random_sampling: RandomSamplingParams = RandomSamplingParams()
    robust: RobustScheduleParams = RobustScheduleParams()
    velocity_update: VelocityUpdateParams = VelocityUpdateParams()


class PipelineOutput(NamedTuple):
    result: RegistrationResult
    registration_input: PointCloud  # sampled source actually aligned
    deskewed: PointCloud  # the registration input after the last VICP deskew


def _robust_schedule(params: RegistrationPipelineParams) -> tuple[list, list]:
    """Geometric annealing schedule: (geometry_scales, rotation_scales)."""
    reg = params.registration
    rp = params.robust
    auto = (
        rp.auto_scale
        and reg.robust.type is not RobustLossType.NONE
        and 0.0 < rp.min_scale < rp.init_scale
        and 0.0 < rp.rotation_min_scale < rp.rotation_init_scale
        and rp.auto_scaling_iter > 0
    )
    if not auto:
        return [reg.robust.default_scale], [reg.rotation_constraint.robust_scale]
    levels = max(1, rp.auto_scaling_iter)
    if levels == 1:
        return [rp.init_scale], [rp.rotation_init_scale]
    f = (rp.min_scale / rp.init_scale) ** (1.0 / (levels - 1))
    fr = (rp.rotation_min_scale / rp.rotation_init_scale) ** (1.0 / (levels - 1))
    return (
        [rp.init_scale * f**i for i in range(levels)],
        [rp.rotation_init_scale * fr**i for i in range(levels)],
    )


def align_pipeline(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    params: RegistrationPipelineParams = RegistrationPipelineParams(),
    initial_guess: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    scores: Optional[torch.Tensor] = None,
    map_prior=None,
    prev_pose: Optional[torch.Tensor] = None,
    dt: Optional[float] = None,
) -> PipelineOutput:
    """Sample the source, then align through the robust schedule;
    ``map_prior`` goes to :func:`~.registration.align`.

    The sampling noise comes from ``generator`` (default: seeded with
    :data:`DEFAULT_SEED` on the source's device); ``scores``, when given,
    replace the drawn Gumbel noise: ``[capacity]`` for the uniform draw, the
    pair of ``[capacity]`` arrays of the weighted and the uniform part for
    the intensity-weighted one. ``prev_pose`` / ``dt`` feed the VICP deskew
    (unused when the velocity update is off or the source has no
    timestamps).
    """
    sp = params.random_sampling
    src = source
    if sp.enable and sp.num < source.capacity:
        if generator is None and scores is None:
            generator = torch.Generator(device=source.device).manual_seed(DEFAULT_SEED)
        if sp.use_intensities and source.intensities is not None:
            src = mixed_sampling(source, sp.num, source.intensities, generator, sp.weighted_ratio, noise=scores)
        elif scores is not None:
            src = sample_by_scores(source, sp.num, scores)
        else:
            src = random_sampling(source, sp.num, generator)

    geo_scales, rot_scales = _robust_schedule(params)
    vu = params.velocity_update
    deskew_iters = max(1, vu.iter) if (vu.enable and src.timestamp_offsets is not None) else 0
    if deskew_iters == 0:
        result = align(
            src, target, target_knn, params.registration,
            initial_guess=initial_guess, map_prior=map_prior,
            robust_schedule=tuple(zip(geo_scales, rot_scales)),
        )
        return PipelineOutput(result=result, registration_input=src, deskewed=src)

    T = torch.eye(4, dtype=torch.float32, device=src.device) if initial_guess is None else initial_guess
    pp = T if prev_pose is None else prev_pose
    duration = -1.0 if dt is None else float(dt)
    deskewed = src
    for geo_s, rot_s in zip(geo_scales, rot_scales):
        for _ in range(deskew_iters):
            deskewed = deskew_constant_velocity(src, pp, T, duration)
            result = align(deskewed, target, target_knn, params.registration, initial_guess=T,
                           robust_scale=geo_s, rotation_robust_scale=rot_s, map_prior=map_prior)
            T = result.T
    return PipelineOutput(result=result, registration_input=src, deskewed=deskewed)


def align_pipeline_streams(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    params: RegistrationPipelineParams = RegistrationPipelineParams(),
    initial_guess: Optional[torch.Tensor] = None,
    map_prior=None,
) -> PipelineOutput:
    """:func:`align_pipeline` of every stream of a fleet (``source [B, N]``,
    ``target [B, M]``, ``initial_guess [B, 4, 4]``), with the default
    sampling seed: stream ``b`` samples and aligns as a single-stream call
    does (its noise, or its pair for the intensity-weighted draw, drawn as
    that call draws it from its default-seeded generator). The VICP deskew
    is single-stream only (the fleet's frames carry no per-point
    timestamps) and raises here."""
    sp = params.random_sampling
    src = source
    if sp.enable and sp.num < source.capacity:
        generator = torch.Generator(device=source.device).manual_seed(DEFAULT_SEED)

        def noise():
            return gumbel_noise(source.capacity, generator, source.device).expand(source.mask.shape)

        if sp.use_intensities and source.intensities is not None:
            pair = (noise(), noise())
            src = mixed_sampling(source, sp.num, source.intensities, weighted_ratio=sp.weighted_ratio, noise=pair)
        else:
            src = sample_by_scores(source, sp.num, noise())
    if params.velocity_update.enable and src.timestamp_offsets is not None:
        raise NotImplementedError("the fleet has no per-point-timestamp (VICP) deskew")
    geo_scales, rot_scales = _robust_schedule(params)
    result = align_streams(
        src, target, target_knn, params.registration,
        initial_guess=initial_guess, map_prior=map_prior,
        robust_schedule=tuple(zip(geo_scales, rot_scales)),
    )
    return PipelineOutput(result=result, registration_input=src, deskewed=src)


def inlier_ratio(out: PipelineOutput) -> torch.Tensor:
    """result.inlier / registration-input size."""
    n = torch.clamp_min(out.registration_input.count(), 1)
    return out.result.inlier.to(torch.float32) / n.to(torch.float32)
