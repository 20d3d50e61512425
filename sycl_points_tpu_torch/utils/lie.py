"""Lie-group operations (SO(3)/SE(3)) over arbitrary leading batch dims.

Counterpart of :mod:`sycl_points_tpu.utils.lie`, with the same conventions
and small-angle thresholds:
  * quaternion layout ``[x, y, z, w]``
  * twist layout ``[rx, ry, rz, tx, ty, tz]`` (rotation first)
  * ``se3_exp(delta)`` gives a 4x4 matrix; poses update as ``T @ se3_exp(delta)``.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-6


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M v`` over batch dims as an elementwise sum (exact f32)."""
    return (M * v[..., None, :]).sum(-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``v[..., 3]`` -> ``[..., 3, 3]``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rotation vector ``[..., 3]`` -> quaternion ``[..., 4]``, with the
    small-angle Taylor branch."""
    theta_sq = (omega * omega).sum(-1)
    theta_quad = theta_sq * theta_sq
    imag_small = 0.5 - theta_sq / 48.0 + theta_quad / 3840.0
    real_small = 1.0 - theta_sq / 8.0 + theta_quad / 384.0
    theta = torch.sqrt(torch.clamp_min(theta_sq, _EPS * _EPS))
    imag_big = torch.sin(0.5 * theta) / theta
    real_big = torch.cos(0.5 * theta)
    small = theta_sq < _EPS
    imag = torch.where(small, imag_small, imag_big)
    real = torch.where(small, real_small, real_big)
    return torch.cat([imag[..., None] * omega, real[..., None]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-30)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion ``[..., 4]`` (xyzw) -> rotation matrix ``[..., 3, 3]``."""
    q = quat_normalize(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        [1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)],
        [2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)],
        [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> quaternion ``[..., 4]`` (xyzw),
    four-branch Shepperd method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], dim=-1)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], dim=-1)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], dim=-1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(
        cond0[..., None],
        q0,
        torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3)),
    )
    return quat_normalize(q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions (xyzw layout)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v[..., 3]`` by quaternions ``q[..., 4]``."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion ``[..., 4]`` -> rotation vector ``[..., 3]``, with
    canonicalization (w >= 0) and the small-angle / near-pi branches."""
    q = quat_normalize(q)
    q = torch.where(q[..., 3:4] < 0.0, -q, q)
    w = q[..., 3]
    xyz = q[..., :3]
    xyz_norm = torch.linalg.vector_norm(xyz, dim=-1)

    w_safe = torch.clamp_min(w, _EPS)
    scale_small = 2.0 / w_safe * (1.0 + xyz_norm * xyz_norm / (6.0 * w_safe * w_safe))
    xyz_norm_safe = torch.clamp_min(xyz_norm, 1e-30)
    theta_general = 2.0 * torch.atan2(xyz_norm, torch.abs(w))
    scale_general = theta_general / xyz_norm_safe
    scale_pi = math.pi / xyz_norm_safe

    scale = torch.where(
        xyz_norm < _EPS,
        scale_small,
        torch.where(torch.abs(w) < _EPS, scale_pi, scale_general),
    )
    return scale[..., None] * xyz


def _omega_sq(omega: torch.Tensor, theta_sq: torch.Tensor) -> torch.Tensor:
    """``skew(w)^2 = w w^T - |w|^2 I``, elementwise."""
    return omega[..., :, None] * omega[..., None, :] - theta_sq[..., None, None] * _eye3(omega)


def _so3_left_jacobian_terms(omega: torch.Tensor):
    """Returns (theta_sq, Omega, Omega_sq, A, B) with V = I + A*Omega + B*Omega^2."""
    theta_sq = (omega * omega).sum(-1)
    theta = torch.sqrt(torch.clamp_min(theta_sq, 1e-30))
    Omega = skew(omega)
    Omega_sq = _omega_sq(omega, theta_sq)
    small = theta_sq < _EPS * _EPS
    A = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / torch.clamp_min(theta_sq, 1e-30)
    )
    B = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / torch.clamp_min(theta_sq * theta, 1e-30),
    )
    return theta_sq, Omega, Omega_sq, A, B


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` for square ``[..., n, n]`` operands as a broadcast sum: the
    same bits for a fleet's stacked poses as for each pose alone (a batched
    matrix product may sum in another order)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble ``[..., 4, 4]`` homogeneous transforms from R ``[..., 3, 3]``, t ``[..., 3]``."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3]
    return torch.cat([top, bottom.expand(top[..., :1, :].shape)], dim=-2)


def se3_exp(twist: torch.Tensor) -> torch.Tensor:
    """Twist ``[..., 6]`` (rotation first) -> matrix ``[..., 4, 4]``."""
    omega = twist[..., :3]
    v = twist[..., 3:6]
    R = quat_to_matrix(so3_exp(omega))
    _, Omega, Omega_sq, A, B = _so3_left_jacobian_terms(omega)
    V = _eye3(twist) + A[..., None, None] * Omega + B[..., None, None] * Omega_sq
    return make_transform(R, _matvec(V, v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Matrix ``[..., 4, 4]`` -> twist ``[..., 6]`` (rotation first)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = so3_log(matrix_to_quat(R))
    theta_sq = (omega * omega).sum(-1)
    theta = torch.sqrt(torch.clamp_min(theta_sq, 1e-30))
    Omega = skew(omega)
    Omega_sq = _omega_sq(omega, theta_sq)
    half = 0.5 * theta
    coeff_general = (
        1.0 - theta * torch.cos(half) / torch.clamp_min(2.0 * torch.sin(half), 1e-30)
    ) / torch.clamp_min(theta_sq, 1e-30)
    coeff = torch.where(theta < _EPS, 1.0 / 12.0, coeff_general)
    V_inv = _eye3(T) - 0.5 * Omega + coeff[..., None, None] * Omega_sq
    return torch.cat([omega, _matvec(V_inv, t)], dim=-1)


def transform_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform ``[..., 4, 4]``."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_transform(Rt, -_matvec(Rt, T[..., :3, 3]))
