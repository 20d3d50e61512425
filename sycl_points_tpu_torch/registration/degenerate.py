"""Degeneracy-aware Tikhonov regularization of the ICP normal equations
("nl_reg"; counterpart of :mod:`sycl_points_tpu.registration.degenerate`).

The rotation and translation 3x3 blocks of H are eigendecomposed; every
eigendirection whose eigenvalue per inlier falls below its threshold gets
``lambda * v v^T`` (``lambda = base_factor * inlier``), and ``b`` is pulled
toward the initial guess by ``b += H_penalty * log(T_init^-1 T)``. Branch
free: the thresholds are eigenvalue masks and ``inlier == 0`` a select, so
nothing is read on the host. Every function takes leading stream axes
(``H [..., 6, 6]``, poses ``[..., 4, 4]``), and a fleet's stream gets the
bits of a single-stream call (the products are broadcast sums).
"""

from __future__ import annotations

import dataclasses

import torch

from sycl_points_tpu_torch.utils import lie
from sycl_points_tpu_torch.utils.eigh3 import eigh3
from sycl_points_tpu_torch.utils.smallmat import matmul3


@dataclasses.dataclass(frozen=True)
class DegenerateRegularizationParams:
    type: str = "none"  # "none" | "nl_reg"
    rot_eigenvalue_threshold: float = 10.0
    trans_eigenvalue_threshold: float = 1.0
    base_factor: float = 1.0

    @staticmethod
    def from_string(s: str) -> str:
        u = s.strip().upper().replace("-", "_")
        if u not in ("NONE", "NL_REG"):
            raise ValueError(f"invalid DegenerateRegularizationType '{s}'")
        return u.lower()


def _block_penalty(H_block, threshold, inlier_f, lam, offset):
    """``lam * sum v v^T`` over the eigenpairs of ``H_block [..., 3, 3]``
    whose eigenvalue per inlier is below ``threshold``, embedded in a 6x6 at
    ``offset``."""
    lam_vals, V = eigh3(H_block)
    weak = (lam_vals / torch.clamp_min(inlier_f, 1.0)[..., None]) < threshold
    P3 = matmul3(V * weak.to(H_block.dtype)[..., None, :], V.transpose(-1, -2))  # V diag(weak) V^T
    P6 = torch.nn.functional.pad(P3, (offset, 3 - offset, offset, 3 - offset))
    return lam[..., None, None] * P6


def regularize(params: DegenerateRegularizationParams, lin, current_pose, initial_guess):
    """nl_reg applied to a ``LinearizedResult``: a no-op for type "none"
    (on the host) and for ``inlier == 0`` (a select)."""
    if params is None or params.type == "none":
        return lin
    H, b, inlier = lin.H, lin.b, lin.inlier
    inlier_f = inlier.to(H.dtype)
    lam = params.base_factor * inlier_f

    P = torch.zeros_like(H)
    if params.rot_eigenvalue_threshold > 0.0:
        P = P + _block_penalty(H[..., :3, :3], params.rot_eigenvalue_threshold, inlier_f, lam, 0)
    if params.trans_eigenvalue_threshold > 0.0:
        P = P + _block_penalty(H[..., 3:, 3:], params.trans_eigenvalue_threshold, inlier_f, lam, 3)

    delta_twist = lie.se3_log(lie.compose(lie.transform_inverse(initial_guess), current_pose))
    active = inlier > 0
    H_out = torch.where(active[..., None, None], H + P, H)
    b_out = torch.where(active[..., None], b + (P * delta_twist[..., None, :]).sum(-1), b)
    return lin._replace(H=H_out, b=b_out)
