"""MAP prior: the previous frame's Hessian as a Gaussian pose prior.

Counterpart of :mod:`sycl_points_tpu.registration.map_prior`. Once per frame,
:func:`update` turns the previous registration's raw Hessian into a
calibrated information matrix Omega:

  * reduced chi-squared calibration s^2 = max(1, 2 error_raw / (3 inlier - 6));
  * rotation-only adjoint into the predicted frame;
  * adaptive process noise Q (per axis |delta| * vel_sigma^2 + base_sigma^2);
  * inversion lemma Omega = R - R (H + R)^{-1} R (robust to a singular H).

Per iteration, :meth:`MapPriorState.apply` adds Omega and
Omega log(T_pred^-1 T) to the normal equations. The enabled / has-prior gate
is the ``active`` scalar on the device, so nothing here waits on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sycl_points_tpu_torch.utils import lie

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MapPriorParams:
    enabled: bool = False
    rot_vel_sigma: float = 1.0  # sigma contribution at 1 rad inter-frame rotation
    trans_vel_sigma: float = 1.0  # sigma contribution at 1 m inter-frame translation
    rot_base_sigma: float = 3.16e-2  # isotropic baseline [rad]
    trans_base_sigma: float = 1e-2  # isotropic baseline [m]


class MapPriorState(NamedTuple):
    """The prior of one frame."""

    active: torch.Tensor  # bool scalar
    omega: torch.Tensor  # [6, 6]
    T_pred_inv: torch.Tensor  # [4, 4]

    def apply(self, lin, T_est: torch.Tensor):
        """Add the prior to the normal equations ``lin`` (a
        ``LinearizedResult``)."""
        e = lie.se3_log(self.T_pred_inv @ T_est)
        omega_e = self.omega @ e
        act = self.active
        return lin._replace(
            H=torch.where(act, lin.H + self.omega, lin.H),
            b=torch.where(act, lin.b + omega_e, lin.b),
            error=torch.where(act, lin.error + 0.5 * torch.dot(e, omega_e), lin.error),
        )

    def prior_error(self, T_est: torch.Tensor) -> torch.Tensor:
        """The prior's cost at ``T_est`` (``[4,4]`` or ``[C,4,4]``)."""
        e = lie.se3_log(self.T_pred_inv @ T_est)
        cost = 0.5 * (e * (e @ self.omega.T)).sum(-1)
        return torch.where(self.active, cost, torch.zeros_like(cost))


def inactive_prior(device: torch.device | str) -> MapPriorState:
    return MapPriorState(
        active=torch.zeros((), dtype=torch.bool, device=device),
        omega=torch.zeros((6, 6), dtype=_F32, device=device),
        T_pred_inv=torch.eye(4, dtype=_F32, device=device),
    )


def update(
    params: MapPriorParams,
    prev_T: torch.Tensor,
    prev_H_raw: torch.Tensor,
    prev_error_raw: torch.Tensor,
    prev_inlier: torch.Tensor,
    T_pred: torch.Tensor,
) -> MapPriorState:
    """Build the frame's prior on ``T_pred``'s device; inactive when
    disabled, when the degrees of freedom are not positive, or when the
    previous error is invalid."""
    dev = T_pred.device
    if not params.enabled:
        return inactive_prior(dev)

    dof = 3.0 * prev_inlier.to(_F32) - 6.0
    ok = (dof > 0.0) & torch.isfinite(prev_error_raw) & (prev_error_raw >= 0.0)
    s_sq = torch.clamp_min(2.0 * prev_error_raw / torch.clamp_min(dof, 1.0), 1.0)
    H_cal = prev_H_raw / s_sq

    R_prev = prev_T[:3, :3]
    R_pred = T_pred[:3, :3]
    R_rel = R_prev.T @ R_pred

    delta_rot_body = lie.so3_log(lie.matrix_to_quat(R_rel))
    delta_trans_body = R_pred.T @ (T_pred[:3, 3] - prev_T[:3, 3])

    q_rot = torch.abs(delta_rot_body) * params.rot_vel_sigma**2 + params.rot_base_sigma**2
    q_trans = torch.abs(delta_trans_body) * params.trans_vel_sigma**2 + params.trans_base_sigma**2

    Ad = torch.zeros((6, 6), dtype=_F32, device=dev)
    Ad[:3, :3] = R_rel
    Ad[3:, 3:] = R_rel
    H_curr = Ad.T @ H_cal @ Ad

    Rm = torch.diag(torch.cat([1.0 / q_rot, 1.0 / q_trans]))
    # Omega = R - R (H + R)^{-1} R  (matrix inversion lemma; H + R is PD)
    L, info = torch.linalg.cholesky_ex(H_curr + Rm)
    X = torch.cholesky_solve(Rm, L)
    solve_ok = (info == 0) & torch.isfinite(L).all() & torch.isfinite(X).all()
    omega = Rm - Rm @ torch.where(solve_ok, X, torch.zeros_like(X))
    ok = ok & solve_ok & torch.isfinite(omega).all()

    return MapPriorState(
        active=ok,
        omega=torch.where(ok, omega, torch.zeros_like(omega)),
        T_pred_inv=lie.transform_inverse(T_pred),
    )
