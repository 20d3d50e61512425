"""15-DOF navigation state and IMU prior factor.

Counterpart of :mod:`sycl_points_tpu.imu.factor`. Error-state ordering:
  [0:3] position (world) | [3:6] rotation (so(3), right-perturbation) |
  [6:9] velocity (world) | [9:12] accel bias | [12:15] gyro bias.

Every function takes leading batch dimensions, so the LM step can try all
its damping candidates as one batch and a fleet runs its streams as one.
:func:`select` picks one state or another under a device condition (one a
stream for a fleet) without a host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.utils import lie
from sycl_points_tpu_torch.utils.smallmat import solve_psd

IDX_POS = 0
IDX_ROT = 3
IDX_VEL = 6
IDX_ACC_BIAS = 9
IDX_GYR_BIAS = 12
DOF = 15

_F32 = torch.float32


class State(NamedTuple):
    """Full navigation state, tensors on one device."""

    position: torch.Tensor  # [..., 3] world
    rotation: torch.Tensor  # [..., 3, 3] body-to-world
    velocity: torch.Tensor  # [..., 3] world
    accel_bias: torch.Tensor  # [..., 3] body
    gyro_bias: torch.Tensor  # [..., 3] body

    @staticmethod
    def identity(device: torch.device | str = "cuda") -> "State":
        dev = require_device(device)
        z = torch.zeros(3, dtype=_F32, device=dev)
        return State(z, torch.eye(3, dtype=_F32, device=dev), z, z, z)

    def pose(self) -> torch.Tensor:
        return lie.make_transform(self.rotation, self.position)


def per_stream(cond: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A condition over leading axes (``[]``, a fleet's ``[B]``) shaped to
    broadcast over ``x``'s trailing axes."""
    return cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))


def select(cond: torch.Tensor, a: State, b: State) -> State:
    """``a`` where the device bool ``cond`` holds, else ``b``, field by
    field; a fleet's ``cond [B]`` picks stream by stream."""
    return State(*(torch.where(per_stream(cond, x), x, y) for x, y in zip(a, b)))


def compute_manifold_residual(x_pred: State, x_op: State) -> torch.Tensor:
    """r = x_op (-) x_pred on the manifold, ``[..., 15]``."""
    r_rot = lie.so3_log(lie.matrix_to_quat(x_pred.rotation.transpose(-1, -2) @ x_op.rotation))
    parts = [
        x_op.position - x_pred.position,
        r_rot,
        x_op.velocity - x_pred.velocity,
        x_op.accel_bias - x_pred.accel_bias,
        x_op.gyro_bias - x_pred.gyro_bias,
    ]
    return torch.cat(torch.broadcast_tensors(*parts), dim=-1)


def compute_imu_hessian_gradient(x_pred: State, x_op: State, P_pred: torch.Tensor):
    """(H_imu, b_imu, ok): H = P^-1, b = H r; zero H and b when P_pred is
    not positive definite."""
    eye = torch.eye(DOF, dtype=_F32, device=P_pred.device).expand(P_pred.shape)
    H, ok = solve_psd(P_pred, eye)
    b = (H @ compute_manifold_residual(x_pred, x_op)[..., None])[..., 0]
    return torch.where(per_stream(ok, H), H, 0.0), torch.where(per_stream(ok, b), b, 0.0), ok


def compute_imu_gradient(x_pred: State, x_op: State, H_imu: torch.Tensor) -> torch.Tensor:
    """Gradient-only update reusing H: ``H r`` over batch dimensions."""
    return (H_imu * compute_manifold_residual(x_pred, x_op)[..., None, :]).sum(-1)


def retract(x: State, delta: torch.Tensor) -> State:
    """Right-perturbation update: p += dp, R = R Exp(dphi), v += dv,
    biases += db; ``delta`` is ``[..., 15]``."""
    return State(
        position=x.position + delta[..., IDX_POS : IDX_POS + 3],
        rotation=x.rotation @ lie.quat_to_matrix(lie.so3_exp(delta[..., IDX_ROT : IDX_ROT + 3])),
        velocity=x.velocity + delta[..., IDX_VEL : IDX_VEL + 3],
        accel_bias=x.accel_bias + delta[..., IDX_ACC_BIAS : IDX_ACC_BIAS + 3],
        gyro_bias=x.gyro_bias + delta[..., IDX_GYR_BIAS : IDX_GYR_BIAS + 3],
    )
