"""Carrying state between numpy, this package and the JAX package.

  * :func:`cloud_from_numpy` / :func:`cloud_to_numpy`: host arrays <-> a
    :class:`PointCloud` on a device;
  * :func:`params_from_reference`: rebuilds this package's parameter
    dataclasses from the JAX package's by reading field names. Enums map by
    member name; the JAX modules are never imported.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from sycl_points_tpu_torch.ops.robust import RobustLossType
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.registration import pipeline, registration
from sycl_points_tpu_torch.registration.factors import RegType

_PARAM_CLASSES = {
    cls.__name__: cls
    for cls in (
        registration.RobustParams,
        registration.RotationConstraintParams,
        registration.GaussNewtonParams,
        registration.LevenbergMarquardtParams,
        registration.DoglegParams,
        registration.CriteriaParams,
        registration.RegistrationParams,
        pipeline.RandomSamplingParams,
        pipeline.RobustScheduleParams,
        pipeline.VelocityUpdateParams,
        pipeline.RegistrationPipelineParams,
    )
}
_ENUMS = {cls.__name__: cls for cls in (RegType, RobustLossType)}


def cloud_from_numpy(
    data: dict | np.ndarray,
    capacity: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> PointCloud:
    """A padded cloud on ``device`` (the card unless the caller asks for the
    CPU) from a ``PointCloud.to_numpy``-style dict
    (``points`` plus optional attributes) or from a points array."""
    if not isinstance(data, dict):
        data = {"points": data}
    return PointCloud.from_numpy(**data, capacity=capacity, device=device)


def cloud_to_numpy(cloud: PointCloud, compacted: bool = True) -> dict:
    """Host copy of a cloud as a numpy dict; drops padding when ``compacted``."""
    return cloud.to_numpy(compacted)


def params_from_reference(obj):
    """This package's counterpart of a reference parameter object.

    Dataclasses map to the class of the same name here, field by field;
    enums map by class and member name; other values are copied as they are.
    """
    if isinstance(obj, enum.Enum):
        return _ENUMS[type(obj).__name__][obj.name]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _PARAM_CLASSES[type(obj).__name__]
        return cls(**{f.name: params_from_reference(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return obj
