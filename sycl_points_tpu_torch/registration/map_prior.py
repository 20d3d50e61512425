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

A fleet's priors carry a leading stream axis (``active [B]``, ``omega
[B, 6, 6]``, ``T_pred_inv [B, 4, 4]``), as do :func:`update`'s inputs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sycl_points_tpu_torch.utils import lie

_F32 = torch.float32


# The products are broadcast sums (lie.compose, _mv, _dot), which give a
# fleet's stream the bits of a single-stream call.


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M * v[..., None, :]).sum(-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _per(flag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``flag`` (a stream's or the frame's) shaped to broadcast over ``x``,
    whose leading dimensions are those of ``flag``."""
    return flag.reshape(flag.shape + (1,) * (x.dim() - flag.dim()))


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
        e = lie.se3_log(lie.compose(self.T_pred_inv, T_est))
        omega_e = _mv(self.omega, e)
        act = self.active
        return lin._replace(
            H=torch.where(_per(act, lin.H), lin.H + self.omega, lin.H),
            b=torch.where(_per(act, lin.b), lin.b + omega_e, lin.b),
            error=torch.where(act, lin.error + 0.5 * _dot(e, omega_e), lin.error),
        )

    def prior_error(self, T_est: torch.Tensor) -> torch.Tensor:
        """The prior's cost at ``T_est`` (``[4,4]`` or ``[C,4,4]``; a fleet's
        ``[B,4,4]`` or ``[B,C,4,4]``)."""
        T_pred_inv = self.T_pred_inv
        if self.active.dim() and T_est.dim() == 4:  # a fleet's candidates
            T_pred_inv = T_pred_inv[:, None]
        e = lie.se3_log(lie.compose(T_pred_inv, T_est))
        if self.active.dim() and e.dim() == 3:  # a fleet's candidates
            omega = self.omega[:, None]
        elif e.dim() == 2 and not self.active.dim():  # one stream's candidates
            omega = self.omega[None]
        else:
            omega = self.omega
        cost = 0.5 * _dot(e, _mv(omega, e))
        return torch.where(_per(self.active, cost), cost, torch.zeros_like(cost))


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
    lead = T_pred.shape[:-2]
    if not params.enabled:
        off = inactive_prior(dev)
        return MapPriorState(*(x.expand(lead + x.shape) for x in off)) if lead else off

    dof = 3.0 * prev_inlier.to(_F32) - 6.0
    ok = (dof > 0.0) & torch.isfinite(prev_error_raw) & (prev_error_raw >= 0.0)
    s_sq = torch.clamp_min(2.0 * prev_error_raw / torch.clamp_min(dof, 1.0), 1.0)
    H_cal = prev_H_raw / _per(s_sq, prev_H_raw)

    R_prev = prev_T[..., :3, :3]
    R_pred = T_pred[..., :3, :3]
    R_rel = lie.compose(R_prev.transpose(-1, -2), R_pred)

    delta_rot_body = lie.so3_log(lie.matrix_to_quat(R_rel))
    delta_trans_body = _mv(R_pred.transpose(-1, -2), T_pred[..., :3, 3] - prev_T[..., :3, 3])

    q_rot = torch.abs(delta_rot_body) * params.rot_vel_sigma**2 + params.rot_base_sigma**2
    q_trans = torch.abs(delta_trans_body) * params.trans_vel_sigma**2 + params.trans_base_sigma**2

    Ad = torch.zeros(lead + (6, 6), dtype=_F32, device=dev)
    Ad[..., :3, :3] = R_rel
    Ad[..., 3:, 3:] = R_rel
    H_curr = lie.compose(lie.compose(Ad.transpose(-1, -2), H_cal), Ad)

    Rm = torch.diag_embed(torch.cat([1.0 / q_rot, 1.0 / q_trans], -1))
    # Omega = R - R (H + R)^{-1} R  (matrix inversion lemma; H + R is PD)
    L, info = torch.linalg.cholesky_ex(H_curr + Rm)
    X = torch.cholesky_solve(Rm, L)
    solve_ok = (info == 0) & torch.isfinite(L).flatten(-2).all(-1) & torch.isfinite(X).flatten(-2).all(-1)
    omega = Rm - lie.compose(Rm, torch.where(_per(solve_ok, X), X, torch.zeros_like(X)))
    ok = ok & solve_ok & torch.isfinite(omega).flatten(-2).all(-1)

    return MapPriorState(
        active=ok,
        omega=torch.where(_per(ok, omega), omega, torch.zeros_like(omega)),
        T_pred_inv=lie.transform_inverse(T_pred),
    )
