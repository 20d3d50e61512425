"""Registration pipeline: input sampling -> robust-scale annealing -> align.

Counterpart of :mod:`sycl_points_tpu.registration.pipeline`. All annealing
levels run in one :func:`~.registration.align` loop. Velocity-update (VICP)
deskew and intensity-weighted sampling are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from sycl_points_tpu_torch.ops.robust import RobustLossType
from sycl_points_tpu_torch.ops.sampling import random_sampling, sample_by_scores
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.registration.registration import (
    RegistrationParams,
    RegistrationResult,
    align,
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
    deskewed: PointCloud  # == registration_input (VICP is not ported)


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
) -> PipelineOutput:
    """Sample the source, then align through the robust schedule.

    The sampling noise comes from ``generator`` (default: seeded with
    :data:`DEFAULT_SEED` on the source's device); ``scores [capacity]``, when
    given, replace the drawn Gumbel noise.
    """
    if params.velocity_update.enable:
        raise NotImplementedError("velocity-update (VICP) deskew is not ported yet")
    sp = params.random_sampling
    if sp.enable and sp.num < source.capacity:
        if sp.use_intensities:
            raise NotImplementedError("intensity-weighted sampling is not ported yet")
        if scores is not None:
            src = sample_by_scores(source, sp.num, scores)
        else:
            if generator is None:
                generator = torch.Generator(device=source.device).manual_seed(DEFAULT_SEED)
            src = random_sampling(source, sp.num, generator)
    else:
        src = source

    geo_scales, rot_scales = _robust_schedule(params)
    result = align(
        src, target, target_knn, params.registration,
        initial_guess=initial_guess,
        robust_schedule=tuple(zip(geo_scales, rot_scales)),
    )
    return PipelineOutput(result=result, registration_input=src, deskewed=src)


def inlier_ratio(out: PipelineOutput) -> torch.Tensor:
    """result.inlier / registration-input size."""
    n = torch.clamp_min(out.registration_input.count(), 1)
    return out.result.inlier.to(torch.float32) / n.to(torch.float32)
