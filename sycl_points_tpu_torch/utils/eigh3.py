"""Batched closed-form symmetric 3x3 eigendecomposition and SPD functions.

Counterpart of :mod:`sycl_points_tpu.utils.eigh3`: the same trigonometric
eigenvalue formula and cross-product eigenvector construction, elementwise
over leading batch dims. ``torch.linalg.eigh`` is not used: its eigenvector
signs and order differ, and normals and plane regularization depend on them.

All functions accept ``[..., 3, 3]`` symmetric matrices.
"""

from __future__ import annotations

import torch

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of ``[..., 3, 3]`` by cofactor expansion (elementwise)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric ``[..., 3, 3]`` in ascending order ``[..., 3]``."""
    q = A.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * _eye3(A)
    p_sq = (B * B).sum((-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p_sq, 0.0))
    p_safe = torch.clamp_min(p, 1e-30)
    Bn = B / p_safe[..., None, None]
    r = torch.clamp(0.5 * _det3(Bn), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam2 = q + 2.0 * p * torch.cos(phi)
    lam0 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    lam1 = 3.0 * q - lam0 - lam2
    return torch.stack([lam0, lam1, lam2], dim=-1)


def _largest_cross(M: torch.Tensor):
    """Best cross product of row pairs of ``M [..., 3, 3]`` -> (vector, sq_norm)."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = (c01 * c01).sum(-1)
    n02 = (c02 * c02).sum(-1)
    n12 = (c12 * c12).sum(-1)
    best12 = n12 > n02
    c_b = torch.where(best12[..., None], c12, c02)
    n_b = torch.where(best12, n12, n02)
    best01 = n01 > n_b
    return torch.where(best01[..., None], c01, c_b), torch.where(best01, n01, n_b)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-30)


def _orthogonal_complement(w: torch.Tensor):
    """Orthonormal basis {U, V} of the plane orthogonal to unit ``w [..., 3]``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    use_x = torch.abs(wx) > torch.abs(wy)
    inv_a = 1.0 / torch.sqrt(torch.clamp_min(wx * wx + wz * wz, 1e-30))
    u_a = torch.stack([-wz * inv_a, zero, wx * inv_a], dim=-1)
    inv_b = 1.0 / torch.sqrt(torch.clamp_min(wy * wy + wz * wz, 1e-30))
    u_b = torch.stack([zero, wz * inv_b, -wy * inv_b], dim=-1)
    U = torch.where(use_x[..., None], u_a, u_b)
    return U, _cross(w, U)


def eigh3(A: torch.Tensor):
    """Eigendecomposition of symmetric ``[..., 3, 3]``: ``(eigenvalues [..., 3]
    ascending, eigenvectors [..., 3, 3])`` with ``eigenvectors[..., :, i]``
    the unit eigenvector of ``eigenvalues[..., i]``."""
    eye = _eye3(A)
    lam = eigvalsh3(A)
    lam0, lam1, lam2 = lam[..., 0], lam[..., 1], lam[..., 2]

    spread = lam2 - lam0
    scale = torch.clamp_min(torch.abs(lam).amax(-1), 1e-30)
    degenerate = spread <= 1e-6 * scale

    # The extreme eigenvalue with the larger gap has a rank-2 A - lam*I, so
    # its row cross products are well conditioned.
    use_low = (lam1 - lam0) > (lam2 - lam1)
    lam_a = torch.where(use_low, lam0, lam2)
    lam_b = torch.where(use_low, lam2, lam0)

    c_a, _ = _largest_cross(A - lam_a[..., None, None] * eye)
    v_a = _normalize(c_a)
    v_a = torch.where(degenerate[..., None], eye[0].expand(v_a.shape), v_a)

    U, W = _orthogonal_complement(v_a)

    # The other two eigenvectors span {U, W}: null direction of the projected
    # 2x2 problem for lam_b.
    AU = (A * U[..., None, :]).sum(-1)
    AW = (A * W[..., None, :]).sum(-1)
    m00 = (U * AU).sum(-1) - lam_b
    m01 = (U * AW).sum(-1)
    m11 = (W * AW).sum(-1) - lam_b
    row0 = m00 * m00 + m01 * m01
    row1 = m01 * m01 + m11 * m11
    use_r0 = row0 > row1
    p0 = torch.where(use_r0, m01, m11)
    p1 = torch.where(use_r0, -m00, -m01)
    pn = torch.sqrt(torch.clamp_min(p0 * p0 + p1 * p1, 0.0))
    tiny = pn <= 1e-30
    pn_safe = torch.clamp_min(pn, 1e-30)
    p0 = torch.where(tiny, torch.ones_like(p0), p0 / pn_safe)
    p1 = torch.where(tiny, torch.zeros_like(p1), p1 / pn_safe)
    v_b = p0[..., None] * U + p1[..., None] * W
    v_c = _cross(v_a, v_b)

    v0 = torch.where(use_low[..., None], v_a, v_b)
    v2 = torch.where(use_low[..., None], v_b, v_a)
    V = torch.stack([v0, v_c, v2], dim=-1)
    V = torch.where(degenerate[..., None, None], eye.expand(V.shape), V)
    return lam, V


def smallest_eigenvector3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric ``[..., 3, 3]``."""
    _, V = eigh3(A)
    return V[..., :, 0]


def plane_regularize(cov: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """GICP plane regularization, eigenvalues replaced with ``(eps, 1, 1)``:
    ``I - (1 - eps) v0 v0^T`` with v0 the smallest eigenvector."""
    v0 = smallest_eigenvector3(cov)
    return _eye3(cov) - (1.0 - eps) * v0[..., :, None] * v0[..., None, :]


def _reconstruct(V: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``V diag(d) V^T`` as an elementwise sum over the eigen index."""
    return (V[..., :, None, :] * d[..., None, None, :] * V[..., None, :, :]).sum(-1)


def normalize_covariance(cov: torch.Tensor) -> torch.Tensor:
    """Eigenvalues divided by the largest and clamped to ``[1e-3, 1]``
    (computed on ``cov * 1e3`` for stability)."""
    lam, V = eigh3(cov * 1e3)
    lam_max = lam[..., 2]
    bad = lam_max < 1e-37
    lam_max_safe = torch.clamp_min(lam_max, 1e-37)
    l0 = torch.clamp(lam[..., 0] / lam_max_safe, 1e-3, 1.0)
    l1 = torch.clamp(lam[..., 1] / lam_max_safe, 1e-3, 1.0)
    out = _reconstruct(V, torch.stack([l0, l1, torch.ones_like(l0)], dim=-1))
    return torch.where(bad[..., None, None], _eye3(cov).expand(cov.shape), out)


def spd_log(A: torch.Tensor, min_eig: float = 1e-6) -> torch.Tensor:
    """Matrix log of SPD ``[..., 3, 3]``."""
    lam, V = eigh3(A)
    return _reconstruct(V, torch.log(torch.clamp_min(lam, min_eig)))


def spd_exp(A: torch.Tensor, max_log: float = 30.0) -> torch.Tensor:
    """Matrix exp of symmetric ``[..., 3, 3]``."""
    lam, V = eigh3(A)
    return _reconstruct(V, torch.exp(torch.clamp(lam, -max_log, max_log)))


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, torch.inf, det)
    adj = torch.stack(
        [
            torch.stack([A00, A01, A02], dim=-1),
            torch.stack([A10, A11, A12], dim=-1),
            torch.stack([A20, A21, A22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def ensure_symmetric(A: torch.Tensor) -> torch.Tensor:
    return 0.5 * (A + A.transpose(-1, -2))


def floor_eigenvalues(cov: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Clamp eigenvalues of symmetric ``[..., 3, 3]`` to at least ``eps``:
    ``cov + V (max(lam, eps) - lam) V^T``."""
    lam, V = eigh3(cov)
    return ensure_symmetric(cov + _reconstruct(V, torch.clamp_min(lam, eps) - lam))


def spd_inverse(cov: torch.Tensor, min_eig: float = 1e-6) -> torch.Tensor:
    """SPD-by-construction inverse ``V diag(1/max(lam, min_eig)) V^T``."""
    lam, V = eigh3(cov)
    return ensure_symmetric(_reconstruct(V, 1.0 / torch.clamp_min(lam, min_eig)))
