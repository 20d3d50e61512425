"""Per-correspondence rotation constraint by the Jensen-Bregman LogDet
divergence (counterpart of
:mod:`sycl_points_tpu.registration.rotation_constraint`).

Residual ``D = max(0, logdet(0.5 (R Cs R^T + Ct)) - 0.5 (logdet Cs + logdet
Ct))`` with the analytic gradient in the rotation twist ``J = -R^T vex([Cs',
M^-1])``; a rank-1 H on the rotation block, robust-weighted and summed beside
the geometric term. The determinants and the inverse are closed-form 3x3
(``eigh3._det3``, ``eigh3.inv3``): elementwise, no library solve on the
card.

Every function takes leading axes: a fleet's poses ``[B, 4, 4]`` with
clouds ``[B, N, ...]``, the LM candidates ``[C, 4, 4]`` (``[B, C, 4, 4]``)
with correspondences broadcast against them. A fleet's stream gets the bits
of a single-stream call: products are broadcast sums, and H and b come from
one matrix product.
"""

from __future__ import annotations

import torch

from sycl_points_tpu_torch.ops.robust import compute_error, compute_weight
from sycl_points_tpu_torch.utils.eigh3 import _det3, inv3
from sycl_points_tpu_torch.utils.smallmat import matmul3, matvec3, rotate_mat3

_SQRT_HALF = 0.5**0.5


def _logdet3(M: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp_min(_det3(M), 1e-10))


def _divergence(R, src_covs, tgt_covs):
    """``(D [..., N], Cs' = R Cs R^T, M = 0.5 (Cs' + Ct))`` for rotations
    ``R [..., 1, 3, 3]`` against covariances ``[..., N, 3, 3]``."""
    Cs_p = rotate_mat3(R, src_covs)
    M = 0.5 * (Cs_p + tgt_covs)
    D = torch.clamp_min(_logdet3(M) - 0.5 * (_logdet3(src_covs) + _logdet3(tgt_covs)), 0.0)
    return D, Cs_p, M


def _divergence_and_grad(src_covs, tgt_covs, T):
    """``(D [..., N], J [..., N, 3])``, the gradient in the local rotation
    frame."""
    R = T[..., None, :3, :3]
    D, Cs_p, M = _divergence(R, src_covs, tgt_covs)
    M_inv = inv3(M)
    comm = matmul3(Cs_p, M_inv) - matmul3(M_inv, Cs_p)
    g_global = -0.5 * torch.stack([
        comm[..., 2, 1] - comm[..., 1, 2],
        comm[..., 0, 2] - comm[..., 2, 0],
        comm[..., 1, 0] - comm[..., 0, 1],
    ], dim=-1)
    return D, matvec3(R.transpose(-1, -2), g_global)  # R^T g per row


def _gathered_tgt_covs(corr):
    # The constraint reads the unregularized target covariances, which the
    # align loop gathers as corr.covs_raw while the constraint is on.
    return corr.covs_raw if corr.covs_raw is not None else corr.covs_reg


def rotation_constraint_linearized(T, src_covs, tgt_covs, mask, loss, rot_scale, weight):
    """``(H [..., 6, 6], b [..., 6], error [...])``: the constraint's
    contribution over all pairs."""
    D, J = _divergence_and_grad(src_covs, tgt_covs, T)
    rn = _SQRT_HALF * torch.abs(D)  # the residual norm of 0.5 D^2
    m = mask.to(D.dtype)
    w = compute_weight(loss, rn, rot_scale) * m * weight
    # H3 = sum w J J^T and b3 = sum w D J from one product
    Hb = (J * w[..., None]).transpose(-1, -2) @ torch.cat([J, D[..., None]], -1)
    err = (m * weight * compute_error(loss, rn, rot_scale)).sum(-1)
    H6 = torch.nn.functional.pad(Hb[..., :3], (0, 3, 0, 3))
    b6 = torch.nn.functional.pad(Hb[..., 3], (0, 3))
    return H6, b6, err


def add_rotation_constraint(params, lin, T, src_covs, corr, rot_scale):
    """The robust-weighted constraint term added to a ``LinearizedResult``."""
    tgt_covs = _gathered_tgt_covs(corr)
    if src_covs is None or tgt_covs is None:
        raise ValueError("rotation constraint requires source and target covariances")
    H6, b6, err = rotation_constraint_linearized(
        T, src_covs, tgt_covs, corr.mask, params.robust.type, rot_scale, params.rotation_constraint.weight)
    return lin._replace(H=lin.H + H6, b=lin.b + b6, error=lin.error + err)


def rotation_constraint_error(params, T, src_covs, corr, rot_scale):
    """The constraint's robust cost at ``T`` over frozen correspondences."""
    D, _, _ = _divergence(T[..., None, :3, :3], src_covs, _gathered_tgt_covs(corr))
    rn = _SQRT_HALF * torch.abs(D)
    return (corr.mask.to(D.dtype) * params.rotation_constraint.weight
            * compute_error(params.robust.type, rn, rot_scale)).sum(-1)
