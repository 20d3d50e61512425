"""Per-correspondence ICP factor linearization as whitened rows.

Counterpart of :mod:`sycl_points_tpu.registration.factors`: every
correspondence becomes up to three whitened rows ``A [N, 3, 6]``, ``c [N, 3]``
with ``H_i = A_i^T A_i``, ``b_i = A_i^T c_i``, ``err_i = |c_i|^2``, so the
global reduction is two matrix products. J = [R.skew(p) | -R] (rotation-first
twist), residual r = q - T p.

:func:`residual_norms_only` also takes a batch of poses ``T [C, 4, 4]`` and
returns ``[C, N]``: the LM candidate sweep evaluates all its candidates at once.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

from sycl_points_tpu_torch.utils.eigh3 import eigvalsh3, spd_inverse
from sycl_points_tpu_torch.utils.smallmat import (
    cholesky3,
    matmul3,
    matvec3,
    rot_times_skew,
    rotate_mat3,
    solve_lower3,
)


class RegType(enum.Enum):
    POINT_TO_POINT = "point_to_point"
    POINT_TO_PLANE = "point_to_plane"
    POINT_TO_DISTRIBUTION = "point_to_distribution"
    GICP = "gicp"
    GENZ = "genz"


class WhitenedRows(NamedTuple):
    A: torch.Tensor  # [N, 3, 6] whitened Jacobian rows
    c: torch.Tensor  # [N, 3] whitened residual
    residual_norm: torch.Tensor  # [N] (unweighted; robust-weight argument)
    genz_weight: torch.Tensor  # [N] (1.0 for non-GenZ types)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def se3_jacobian(T: torch.Tensor, src_pts: torch.Tensor) -> torch.Tensor:
    """J = [R.skew(p) | -R] per point -> ``[N, 3, 6]``."""
    R = T[:3, :3]
    Rskew = rot_times_skew(R, src_pts)
    return torch.cat([Rskew, (-R).expand(Rskew.shape)], dim=-1)


def genz_planarity(target_covs: torch.Tensor, threshold: float = 0.2) -> torch.Tensor:
    """PCA normalized curvature < threshold => planar (pose-independent)."""
    lam = eigvalsh3(target_covs)
    s = lam.sum(-1)
    curvature = torch.where(s > 1e-12, lam[..., 0] / torch.clamp_min(s, 1e-12), 1.0)
    return curvature < threshold


def _plane_rows(J, r, normals):
    nj = (normals[:, :, None] * J).sum(-2)  # [N, 6]
    s = (normals * r).sum(-1)
    return normals[:, :, None] * nj[:, None, :], normals * s[:, None], torch.abs(s)


def _mahalanobis_rows(J, r, sigma):
    """Whiten with Sigma^-1: A = G^-1 J, c = G^-1 r for Sigma = G G^T."""
    G = cholesky3(sigma)
    c = solve_lower3(G, r)
    return solve_lower3(G, J), c, _norm(c)


def _mahalanobis_rows_from_inverse(J, r, sigma, floor: float = 1e-4):
    """Whiten via the information matrix ``W = Sigma^-1 = Gw Gw^T`` built from
    the eigendecomposition with a (1 cm)^2 eigenvalue floor."""
    Gt = cholesky3(spd_inverse(sigma, floor)).transpose(-1, -2)
    c = matvec3(Gt, r)
    return matmul3(Gt, J), c, _norm(c)


def _moved(T: torch.Tensor, src_pts: torch.Tensor):
    """(rotation with broadcast dims, transformed points) for ``T [..., 4, 4]``."""
    R = T[..., None, :3, :3]
    return R, matvec3(R, src_pts) + T[..., None, :3, 3]


def whitened_rows(
    reg_type: RegType,
    T: torch.Tensor,
    src_pts: torch.Tensor,
    tgt_pts: torch.Tensor,
    src_covs_reg: Optional[torch.Tensor] = None,
    tgt_covs_reg: Optional[torch.Tensor] = None,
    tgt_covs_raw: Optional[torch.Tensor] = None,
    tgt_normals: Optional[torch.Tensor] = None,
    genz_planar: Optional[torch.Tensor] = None,
    genz_alpha: Optional[torch.Tensor] = None,
) -> WhitenedRows:
    """Linearize all correspondences at pose ``T [4, 4]``. ``tgt_*`` are
    already gathered to source order; ``*_covs_reg`` are plane-regularized."""
    R, p_t = _moved(T, src_pts)
    r = tgt_pts - p_t
    J = se3_jacobian(T, src_pts)
    ones = torch.ones(src_pts.shape[0], dtype=src_pts.dtype, device=src_pts.device)

    if reg_type is RegType.POINT_TO_POINT:
        return WhitenedRows(J, r, _norm(r), ones)
    if reg_type is RegType.POINT_TO_PLANE:
        return WhitenedRows(*_plane_rows(J, r, tgt_normals), ones)
    if reg_type is RegType.GICP:
        sigma = rotate_mat3(R, src_covs_reg) + tgt_covs_reg
        return WhitenedRows(*_mahalanobis_rows(J, r, sigma), ones)
    if reg_type is RegType.POINT_TO_DISTRIBUTION:
        return WhitenedRows(*_mahalanobis_rows_from_inverse(J, r, tgt_covs_raw), ones)
    if reg_type is RegType.GENZ:
        A_pl, c_pl, rn_pl = _plane_rows(J, r, tgt_normals)
        gw = torch.where(genz_planar, genz_alpha, 1.0 - genz_alpha)
        A = torch.where(genz_planar[:, None, None], A_pl, J)
        c = torch.where(genz_planar[:, None], c_pl, r)
        rn = torch.where(genz_planar, rn_pl, _norm(r))
        return WhitenedRows(A, c, rn, gw)
    raise ValueError(reg_type)


def residual_norms_only(
    reg_type: RegType,
    T: torch.Tensor,
    src_pts: torch.Tensor,
    tgt_pts: torch.Tensor,
    src_covs_reg: Optional[torch.Tensor] = None,
    tgt_covs_reg: Optional[torch.Tensor] = None,
    tgt_covs_raw: Optional[torch.Tensor] = None,
    tgt_normals: Optional[torch.Tensor] = None,
    genz_planar: Optional[torch.Tensor] = None,
    genz_alpha: Optional[torch.Tensor] = None,
):
    """``(residual_norm, genz_weight)`` without the Jacobian, the error-only
    path of LM/dogleg step acceptance. ``T`` is ``[4, 4]`` (results ``[N]``)
    or ``[C, 4, 4]`` (results ``[C, N]``)."""
    R, p_t = _moved(T, src_pts)
    r = tgt_pts - p_t
    ones = torch.ones(r.shape[:-1], dtype=src_pts.dtype, device=src_pts.device)

    if reg_type is RegType.POINT_TO_POINT:
        return _norm(r), ones
    if reg_type is RegType.POINT_TO_PLANE:
        return torch.abs((tgt_normals * r).sum(-1)), ones
    if reg_type is RegType.GICP:
        G = cholesky3(rotate_mat3(R, src_covs_reg) + tgt_covs_reg)
        return _norm(solve_lower3(G, r)), ones
    if reg_type is RegType.POINT_TO_DISTRIBUTION:
        Gt = cholesky3(spd_inverse(tgt_covs_raw, 1e-4)).transpose(-1, -2)
        return _norm(matvec3(Gt, r)), ones
    if reg_type is RegType.GENZ:
        rn_pl = torch.abs((tgt_normals * r).sum(-1))
        gw = torch.where(genz_planar, genz_alpha, 1.0 - genz_alpha)
        return torch.where(genz_planar, rn_pl, _norm(r)), gw.expand(r.shape[:-1])
    raise ValueError(reg_type)
