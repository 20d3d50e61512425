"""Robust M-estimator losses (counterpart of :mod:`sycl_points_tpu.ops.robust`):
IRLS weights ``compute_weight`` and robust costs ``compute_error`` for the
loss family {NONE, HUBER, TUKEY, CAUCHY, GEMAN_MCCLURE}."""

from __future__ import annotations

import enum

import torch


class RobustLossType(enum.Enum):
    NONE = "none"
    HUBER = "huber"
    TUKEY = "tukey"
    CAUCHY = "cauchy"
    GEMAN_MCCLURE = "geman_mcclure"

    @staticmethod
    def from_string(s: str) -> "RobustLossType":
        """The loss named ``s`` (any case)."""
        return RobustLossType[s.strip().upper()]


def compute_weight(loss: RobustLossType, residual_norm: torch.Tensor, scale) -> torch.Tensor:
    """IRLS weight w(r) in [0, 1]; w=1 below the 1e-8 residual floor."""
    if loss is RobustLossType.NONE:
        return torch.ones_like(residual_norm)
    r = torch.clamp_min(residual_norm / scale, 1e-30)
    if loss is RobustLossType.HUBER:
        w = torch.clamp_max(1.0 / r, 1.0)
    elif loss is RobustLossType.TUKEY:
        f = torch.clamp_min(1.0 - r * r, 0.0)
        w = f * f
    elif loss is RobustLossType.CAUCHY:
        w = 1.0 / (1.0 + r * r)
    elif loss is RobustLossType.GEMAN_MCCLURE:
        d = 1.0 + r * r
        w = 1.0 / (d * d)
    else:
        raise ValueError(loss)
    return torch.where(residual_norm <= 1e-8, 1.0, w)


def compute_error(loss: RobustLossType, residual_norm: torch.Tensor, scale) -> torch.Tensor:
    """Robust cost rho(r)."""
    r = residual_norm
    s2 = scale * scale
    if loss is RobustLossType.NONE:
        return 0.5 * r * r
    if loss is RobustLossType.HUBER:
        return torch.where(r <= scale, 0.5 * r * r, scale * (r - 0.5 * scale))
    if loss is RobustLossType.TUKEY:
        f = torch.clamp_min(1.0 - (r * r) / s2, 0.0)
        return (s2 / 6.0) * (1.0 - f * f * f)
    if loss is RobustLossType.CAUCHY:
        return 0.5 * s2 * torch.log1p((r * r) / s2)
    if loss is RobustLossType.GEMAN_MCCLURE:
        return 0.5 * (s2 * r * r) / (s2 + r * r)
    raise ValueError(loss)
