"""Carrying state between numpy, this package and the JAX package.

  * :func:`cloud_from_numpy` / :func:`cloud_to_numpy`: host arrays <-> a
    :class:`PointCloud` on a device;
  * :func:`params_from_reference`: rebuilds this package's parameter
    dataclasses from the JAX package's by reading field names. Enums map by
    member name; the JAX modules are never imported;
  * :func:`map_state_from_reference`: a JAX ``VoxelHashMapState`` as this
    package's, so that a map filled by one side can be read by the other;
  * :func:`og_state_from_reference`: a JAX ``OccupancyGridState`` as this
    package's, likewise;
  * :func:`lio_state_from_reference`: a JAX LIO filter state (``State`` and
    ``P_post``) as this package's, so that both filters can start from one
    state;
  * :func:`carry_from_reference`: a JAX pipelined ``OdomCarry`` as this
    package's.

The map states and the carry convert a fleet's stacked arrays (a leading
stream axis ``[B, ...]``, as the JAX ``FleetOdometry`` holds them) as they
convert a single stream's.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.imu.factor import State
from sycl_points_tpu_torch.imu.initial_alignment import InitialAlignmentParams
from sycl_points_tpu_torch.imu.preintegration import IMUPreintegrationParams
from sycl_points_tpu_torch.lio import lio_registration as lio
from sycl_points_tpu_torch.mapping.occupancy_grid import OccupancyGridConfig, OccupancyGridState
from sycl_points_tpu_torch.mapping.voxel_hash_map import VoxelHashMapConfig, VoxelHashMapState
from sycl_points_tpu_torch.ops.robust import RobustLossType
from sycl_points_tpu_torch.pipeline import params as pipeline_params
from sycl_points_tpu_torch.pipeline.pipelined_lio import LIOCarry
from sycl_points_tpu_torch.pipeline.pipelined_odometry import OdomCarry
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.registration import map_prior, pipeline, registration
from sycl_points_tpu_torch.registration.degenerate import DegenerateRegularizationParams
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
        DegenerateRegularizationParams,
        pipeline.RandomSamplingParams,
        pipeline.RobustScheduleParams,
        pipeline.VelocityUpdateParams,
        pipeline.RegistrationPipelineParams,
        map_prior.MapPriorParams,
        VoxelHashMapConfig,
        OccupancyGridConfig,
        IMUPreintegrationParams,
        InitialAlignmentParams,
        lio.LIORobustScheduleParams,
        lio.DirectionalIcpWeightingParams,
        lio.LIORegistrationParams,
        *(cls for cls in vars(pipeline_params).values()
          if dataclasses.is_dataclass(cls) and cls.__module__ == pipeline_params.__name__),
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
        return _PARAM_CLASSES[type(obj).__name__](**{
            f.name: params_from_reference(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        })
    return obj


def map_state_from_reference(state, device: torch.device | str = "cuda") -> VoxelHashMapState:
    """This package's map state on ``device`` (the card unless the caller
    asks for the CPU) from a JAX ``VoxelHashMapState``, or any object whose
    attributes of the same names convert with ``numpy.asarray``. Slots keep
    their places: both packages hash alike, so either can go on inserting
    into and reading from the other's table. A fleet's stacked state
    converts to a stacked state."""
    return _state_from_reference(VoxelHashMapState, state, device)


def og_state_from_reference(state, device: torch.device | str = "cuda") -> OccupancyGridState:
    """This package's occupancy-grid state on ``device`` (the card unless
    the caller asks for the CPU) from a JAX ``OccupancyGridState``, or any
    object whose attributes of the same names convert with
    ``numpy.asarray``; slots keep their places, as with
    :func:`map_state_from_reference`."""
    return _state_from_reference(OccupancyGridState, state, device)


def carry_from_reference(carry, device: torch.device | str = "cuda") -> OdomCarry:
    """This package's :class:`OdomCarry` on ``device`` from a JAX pipelined
    ``OdomCarry`` (one stream's, or a fleet's stacked ``[B, ...]``), or any
    object with fields of the same names that convert with
    ``numpy.asarray``. The keyframe time becomes float64, as this package
    carries it."""
    dev = require_device(device)

    def t(name):
        a = np.array(getattr(carry, name))
        if name == "last_kf_time":
            a = a.astype(np.float64)
        return torch.from_numpy(a).to(dev)

    return OdomCarry(*(t(name) for name in OdomCarry._fields))


def _state_from_reference(cls, state, device):
    dev = require_device(device)
    return cls(**{
        f.name: torch.from_numpy(np.array(getattr(state, f.name))).to(dev)
        for f in dataclasses.fields(cls)
    })


def lio_state_from_reference(x, P_post, device: torch.device | str = "cuda"):
    """``(State, P_post)`` of this package on ``device`` (the card unless the
    caller asks for the CPU) from a JAX LIO ``State`` and posterior
    covariance, or any object with fields of the same names that convert
    with ``numpy.asarray``."""
    dev = require_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return State(*(t(getattr(x, name)) for name in State._fields)), t(P_post)


def fleet_lio_state_from_reference(jax_fleet, device: torch.device | str = "cuda"):
    """``(State, P, LIOCarry)`` of a port ``FleetLIO`` on ``device`` (the card
    unless the caller asks for the CPU) from a JAX ``FleetLIO``'s stacked
    ``x``, ``P`` and ``_carry`` (fields ``[B, ...]``), or any object with
    those attributes whose fields convert with ``numpy.asarray``; the
    keyframe time becomes float64, as this package carries it. Assign them
    to the port fleet's ``x``, ``P`` and ``_carry`` to start it from the JAX
    fleet's state."""
    dev = require_device(device)
    x, P = lio_state_from_reference(jax_fleet.x, jax_fleet.P, device=dev)
    c = jax_fleet._carry
    carry = LIOCarry(last_kf_pose=torch.from_numpy(np.array(c.last_kf_pose, np.float32)).to(dev),
                     last_kf_time=torch.from_numpy(np.array(c.last_kf_time, np.float64)).to(dev))
    return x, P, carry

