"""NumPy Lie-group helpers for host-side bookkeeping.

Own copy of :mod:`sycl_points_tpu.utils.lie_np` (held to the original in
``tests/test_torch_lo_ops.py``). Pipeline host logic (keyframe policy,
velocity update, motion prediction) works on single 4x4 matrices; sending
those through the device would cost a round trip per frame. Same conventions
as :mod:`sycl_points_tpu_torch.utils.lie`: quaternions xyzw, twists
[rot, trans]; float64 inside, float32 out.
"""


from __future__ import annotations

import numpy as np

_EPS = 1e-6


def skew(v):
    x, y, z = v
    return np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], dtype=np.float64)


def so3_exp_matrix(omega):
    omega = np.asarray(omega, np.float64)
    theta = np.linalg.norm(omega)
    S = skew(omega)
    if theta < _EPS:
        return np.eye(3) + S + 0.5 * S @ S
    A = np.sin(theta) / theta
    B = (1.0 - np.cos(theta)) / (theta * theta)
    return np.eye(3) + A * S + B * (S @ S)


def matrix_to_quat(R):
    """Rotation matrix -> quaternion xyzw (Shepperd)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                      (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(max(1.0 + R[0, 0] - R[1, 1] - R[2, 2], 1e-12)) * 2
        q = np.array([0.25 * s, (R[0, 1] + R[1, 0]) / s,
                      (R[0, 2] + R[2, 0]) / s, (R[2, 1] - R[1, 2]) / s])
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(max(1.0 - R[0, 0] + R[1, 1] - R[2, 2], 1e-12)) * 2
        q = np.array([(R[0, 1] + R[1, 0]) / s, 0.25 * s,
                      (R[1, 2] + R[2, 1]) / s, (R[0, 2] - R[2, 0]) / s])
    else:
        s = np.sqrt(max(1.0 - R[0, 0] - R[1, 1] + R[2, 2], 1e-12)) * 2
        q = np.array([(R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s,
                      0.25 * s, (R[1, 0] - R[0, 1]) / s])
    return q / np.linalg.norm(q)


def so3_log(R):
    """Rotation matrix -> rotation vector."""
    q = matrix_to_quat(R)
    if q[3] < 0:
        q = -q
    xyz = q[:3]
    n = np.linalg.norm(xyz)
    w = q[3]
    if n < _EPS:
        return (2.0 / max(w, _EPS)) * xyz
    if abs(w) < _EPS:
        return (np.pi / n) * xyz
    theta = 2.0 * np.arctan2(n, abs(w))
    return (theta / n) * xyz


def se3_exp(twist):
    twist = np.asarray(twist, np.float64)
    omega, v = twist[:3], twist[3:]
    theta = np.linalg.norm(omega)
    R = so3_exp_matrix(omega)
    S = skew(omega)
    if theta < _EPS:
        V = np.eye(3) + 0.5 * S + (1.0 / 6.0) * S @ S
    else:
        A = (1.0 - np.cos(theta)) / theta**2
        B = (theta - np.sin(theta)) / theta**3
        V = np.eye(3) + A * S + B * (S @ S)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T.astype(np.float32)


def se3_log(T):
    T = np.asarray(T, np.float64)
    omega = so3_log(T[:3, :3])
    theta = np.linalg.norm(omega)
    S = skew(omega)
    if theta < _EPS:
        V_inv = np.eye(3) - 0.5 * S
    else:
        half = 0.5 * theta
        coeff = (1.0 - theta * np.cos(half) / (2.0 * np.sin(half))) / theta**2
        V_inv = np.eye(3) - 0.5 * S + coeff * (S @ S)
    return np.concatenate([omega, V_inv @ T[:3, 3]]).astype(np.float32)
