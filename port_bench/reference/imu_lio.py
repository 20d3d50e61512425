"""The LiDAR-inertial registration: the 15-DOF Gauss-Newton solve.

Error state ``[position, rotation (right perturbation), velocity, accel
bias, gyro bias]``. An iteration linearizes GICP at the state's pose (each
source point against its nearest target within the gate), weights it by the
reduced chi-square ``1 / max(2 e / (3 n - 6), 1)``, embeds it in 15
dimensions (the translation block turned into the world frame), attenuates
the pose blocks' weak directions (eigenvalues under ``min_eigenvalue_per_inlier``
times the inliers, scale ``max(ratio, weak_scale)``, applied as ``F H F`` and
``F F b``), adds the IMU prior ``P_pred^-1`` about the prediction, solves
``(H + lambda I) d = -b``, freezes the biases where they are not to be
updated and retracts.

The stage's inputs are the sampled scan, the submap (judged by itself), the
prediction and its covariance. :func:`judge` runs the program's procedure
again in float64: from the prediction, the same iteration budget and
convergence test.
"""

from __future__ import annotations

import torch

from port_bench.reference.common import eigh, plane_regularize, rotation_angle, so3_exp, work
from port_bench.reference.gicp import linearize

POS, ROT, VEL, BA, BG = (slice(i, i + 3) for i in (0, 3, 6, 9, 12))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    c = ((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0).clamp(-1.0, 1.0)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    s = 0.5 * torch.linalg.vector_norm(work(w), dim=-1).to(R.dtype)
    th = torch.atan2(s, c)
    k = torch.where(th < 1e-8, 0.5 + th * th / 12.0, th / (2.0 * torch.sin(th).clamp_min(1e-30)))
    return w * k[..., None]


def residual(pred: dict, x: dict) -> torch.Tensor:
    """``x (-) pred`` on the manifold, ``[15]``."""
    return torch.cat([x["position"] - pred["position"], so3_log(pred["rotation"].T @ x["rotation"]),
                      x["velocity"] - pred["velocity"], x["accel_bias"] - pred["accel_bias"],
                      x["gyro_bias"] - pred["gyro_bias"]])


def retract(x: dict, d: torch.Tensor) -> dict:
    return {"position": x["position"] + d[POS], "rotation": x["rotation"] @ so3_exp(d[ROT]),
            "velocity": x["velocity"] + d[VEL], "accel_bias": x["accel_bias"] + d[BA],
            "gyro_bias": x["gyro_bias"] + d[BG]}


def pose(x: dict) -> torch.Tensor:
    T = torch.eye(4, dtype=x["position"].dtype, device=x["position"].device)
    T[:3, :3], T[:3, 3] = x["rotation"], x["position"]
    return T


def _filter(Hb: torch.Tensor, min_info: float, weak: float) -> torch.Tensor:
    lam, V = eigh(0.5 * (Hb + Hb.T))
    lam = lam.clamp_min(0.0)
    if min_info > 0.0:
        scale = torch.where(lam <= 0.0, torch.zeros_like(lam),
                            torch.maximum((lam / max(min_info, 1e-30)).clamp(0.0, 1.0),
                                          torch.full_like(lam, min(max(weak, 0.0), 1.0))))
    else:
        scale = torch.where(lam <= 0.0, torch.zeros_like(lam), torch.ones_like(lam))
    return (V * torch.sqrt(scale.clamp(0.0, 1.0))[None, :]) @ V.T


def system(x: dict, c: dict, cfg: dict, dtype):
    """``(H [15, 15], b [15])`` of one iteration at state ``x``."""
    T = pose(x)
    src, tgt = c["src"], c["tgt"]
    H6, b6, n, err = linearize(T, src["points"].to(dtype), plane_regularize(src["covs"].to(dtype)),
                               tgt["points"].to(dtype), tgt["mask"].bool(), plane_regularize(tgt["covs"].to(dtype)),
                               src["mask"].bool(), cfg["max_corr_dist"], with_error=True)
    dof = 3.0 * n - 6.0
    e = float(err)
    w = 1.0 / max(2.0 * e / max(dof, 1.0), 1.0) if dof > 0.0 and e >= 0.0 and e == e else 1.0
    R = x["rotation"]
    H = torch.zeros((15, 15), dtype=dtype, device=T.device)
    b = torch.zeros(15, dtype=dtype, device=T.device)
    H[ROT, ROT] = w * H6[:3, :3]
    H[POS, POS] = w * (R @ H6[3:, 3:] @ R.T)
    H[POS, ROT] = w * (R @ H6[3:, :3])
    H[ROT, POS] = w * (H6[:3, 3:] @ R.T)
    b[ROT] = w * b6[:3]
    b[POS] = w * (R @ b6[3:])
    dw = cfg["directional"]
    if dw["enable"] and n > 0:
        Hp = torch.cat([torch.cat([H[POS, POS], H[POS, ROT]], 1), torch.cat([H[ROT, POS], H[ROT, ROT]], 1)])
        Hp = 0.5 * (Hp + Hp.T)
        F = torch.zeros((6, 6), dtype=dtype, device=T.device)
        F[:3, :3] = _filter(Hp[:3, :3], dw["trans_min_eigenvalue_per_inlier"] * n, dw["trans_weak_direction_scale"])
        F[3:, 3:] = _filter(Hp[3:, 3:], dw["rot_min_eigenvalue_per_inlier"] * n, dw["rot_weak_direction_scale"])
        Hf = F @ Hp @ F
        bf = F @ (F @ torch.cat([b[POS], b[ROT]]))
        H[POS, POS], H[POS, ROT], H[ROT, POS], H[ROT, ROT] = Hf[:3, :3], Hf[:3, 3:], Hf[3:, :3], Hf[3:, 3:]
        b[POS], b[ROT] = bf[:3], bf[3:]
    P = c["P_pred"].to(dtype)
    L, info = torch.linalg.cholesky_ex(work(P))
    if int(info) == 0:
        H_imu = torch.cholesky_inverse(L).to(dtype)
        H = H + H_imu
        b = b + H_imu @ residual({k: v.to(dtype) for k, v in c["pred"].items()}, x)
    else:
        reg = torch.zeros(15, dtype=dtype, device=T.device)
        reg[6:] = cfg["invalid_regularization_factor"]
        H = H + torch.diag(reg)
    return H, b


def solve(x0: dict, c: dict, cfg: dict, iterations: int, tol: float, dtype) -> dict:
    x = {k: v.to(dtype) for k, v in x0.items()}
    keep = torch.ones(15, dtype=dtype, device=x["position"].device)
    if not bool(c["update_bias"]):
        keep[9:] = 0.0
    eye = torch.eye(15, dtype=dtype, device=keep.device)
    for _ in range(iterations):
        H, b = system(x, c, cfg, dtype)
        d = torch.linalg.solve(work(H + cfg["gn_lambda"] * eye), -work(b)).to(dtype) * keep
        x = retract(x, d)
        if float(d[ROT].norm()) < tol and float(d[POS].norm()) < tol:
            break
    return x


def judge(T_prog, c: dict, cfg: dict) -> dict:
    """The gaps between the program's solve and the reference's:
    ``lio_trans_gap_m``, ``lio_rot_gap_rad`` (against the pose the program
    logged), ``lio_vel_gap_mps`` and ``lio_bias_gap`` (the larger of the two
    biases' gaps)."""
    prog = {k: v.double() for k, v in c["state"].items()}
    x = solve(c["pred"], c, cfg, cfg["total_iterations"], cfg["criteria"], torch.float64)
    Tp = T_prog.double()
    return {"lio_trans_gap_m": float((x["position"] - Tp[:3, 3]).norm()),
            "lio_rot_gap_rad": rotation_angle(x["rotation"], Tp[:3, :3]),
            "lio_vel_gap_mps": float((x["velocity"] - prog["velocity"]).norm()),
            "lio_bias_gap": max(float((x["accel_bias"] - prog["accel_bias"]).norm()),
                                float((x["gyro_bias"] - prog["gyro_bias"]).norm()))}


def control(c: dict, cfg: dict, dtype=torch.bfloat16) -> dict:
    """The stage in ``dtype`` in the program's place: from the prediction,
    the program's iteration budget and convergence test."""
    x = solve(c["pred"], c, cfg, cfg["total_iterations"], cfg["criteria"], dtype)
    return {k: v.float() for k, v in x.items()}
