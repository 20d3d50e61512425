"""Small-matrix batched linear algebra: 3x3 products, analytic 3x3 Cholesky,
triangular solves and the NxN PSD solve of the optimizer step.

Counterpart of :mod:`sycl_points_tpu.utils.smallmat`. The 3x3 helpers are
broadcast-multiply-sum elementwise math (exact f32, no matmul), as there.
"""

from __future__ import annotations

import torch


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched ``A @ B`` for ``[..., 3, 3]`` operands as a broadcast sum."""
    return (A[..., :, :, None] * B.unsqueeze(-3)).sum(-2)


def rotate_mat3(R: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """``R C R^T`` over batched ``C [..., 3, 3]``; ``R`` is ``[3, 3]`` or
    batched ``[..., 3, 3]``."""
    tmp = (R[..., :, :, None] * C.unsqueeze(-3)).sum(-2)
    return (tmp[..., :, None, :] * R.unsqueeze(-3)).sum(-1)


def matvec3(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R v`` for ``R [..., 3, 3]`` over batched ``v [..., 3]``, summed in the
    fixed order ``(r0 v0 + r1 v1) + r2 v2`` that the nn1 kernel's pose fold
    uses, so the plain path and the kernel see the same query coordinates."""
    return (
        R[..., :, 0] * v[..., 0, None]
        + R[..., :, 1] * v[..., 1, None]
        + R[..., :, 2] * v[..., 2, None]
    )


def rot_times_skew(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``R @ skew(p)`` per point -> ``[..., 3, 3]``: column j is a signed
    combination of R's columns."""
    x, y, z = p[..., 0, None], p[..., 1, None], p[..., 2, None]
    c0, c1, c2 = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    col0 = z * c1 - y * c2
    col1 = -z * c0 + x * c2
    col2 = y * c0 - x * c1
    return torch.stack([col0, col1, col2], dim=-1)


def cholesky3(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``[..., 3, 3]`` (analytic, batched)."""
    a00 = A[..., 0, 0] + jitter
    a10, a11 = A[..., 1, 0], A[..., 1, 1] + jitter
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2] + jitter
    eps = 1e-30
    g00 = torch.sqrt(torch.clamp_min(a00, eps))
    g10 = a10 / g00
    g20 = a20 / g00
    g11 = torch.sqrt(torch.clamp_min(a11 - g10 * g10, eps))
    g21 = (a21 - g20 * g10) / g11
    g22 = torch.sqrt(torch.clamp_min(a22 - g20 * g20 - g21 * g21, eps))
    zero = torch.zeros_like(g00)
    return torch.stack(
        [
            torch.stack([g00, zero, zero], dim=-1),
            torch.stack([g10, g11, zero], dim=-1),
            torch.stack([g20, g21, g22], dim=-1),
        ],
        dim=-2,
    )


def solve_lower3(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Forward-substitute ``L y = B`` for lower-triangular ``L [..., 3, 3]``;
    ``B`` is ``[..., 3]`` or ``[..., 3, m]``."""
    vec = B.dim() == L.dim() - 1
    if vec:
        B = B[..., None]
    y0 = B[..., 0, :] / L[..., 0, 0, None]
    y1 = (B[..., 1, :] - L[..., 1, 0, None] * y0) / L[..., 1, 1, None]
    y2 = (B[..., 2, :] - L[..., 2, 0, None] * y0 - L[..., 2, 1, None] * y1) / L[..., 2, 2, None]
    Y = torch.stack([y0, y1, y2], dim=-2)
    return Y[..., 0] if vec else Y


def solve_psd(H: torch.Tensor, b: torch.Tensor):
    """Solve ``H x = b`` for symmetric positive (semi-)definite ``H [..., N, N]``
    by Cholesky; ``b`` is ``[..., N]`` or a matrix ``[..., N, m]`` (an inverse
    for the identity). Returns ``(x, ok)``. Where the factorization finds a
    non-positive pivot or anything is non-finite, ``ok`` is False and ``x`` is
    zero (the zero-step fallback of the reference's LDLT failure)."""
    vec = b.dim() == H.dim() - 1
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(b.unsqueeze(-1) if vec else b, L)
    if vec:
        x = x.squeeze(-1)
    ok = (
        (info == 0)
        & torch.isfinite(L).flatten(-2).all(-1)
        & torch.isfinite(x).flatten(-1 if vec else -2).all(-1)
    )
    ok_b = ok[..., None] if vec else ok[..., None, None]
    return torch.where(ok_b, x, torch.zeros_like(x)), ok
