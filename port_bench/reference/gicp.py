"""The LiDAR odometry's registration: GICP by Gauss-Newton.

The registration's source (the sampled scan with its covariances), its
target (the submap with its covariances) and its initial guess are the
stage's inputs; the submap is judged by itself (:mod:`.voxel_map`).
:func:`judge` runs the program's procedure again in float64: Gauss-Newton
(``H + I``) from the initial guess, the same iteration budget and the same
convergence test on the step. (The distance to the objective's fixed point
is no judge of it: a loop that stops on a step under 1 mm can stop 1.5 cm
from it, PERF.md.)
"""

from __future__ import annotations

import torch

from port_bench.reference.common import knn, plane_regularize, rotation_angle, se3_exp, skew, work


def linearize(T, src, src_covs_reg, tgt, tgt_valid, tgt_covs_reg, src_valid, max_dist: float,
              with_error: bool = False):
    """``(H [6, 6], b [6], inliers)`` of the whitened GICP rows at ``T``,
    each source point against its nearest target within ``max_dist``; with
    ``with_error`` also the cost, half the inliers' squared whitened
    residuals."""
    R, t = T[:3, :3], T[:3, 3]
    moved = src @ R.T + t
    idx, d2 = knn(tgt, tgt_valid, moved, 1)
    idx, d2 = idx[:, 0], d2[:, 0]
    ok = src_valid & (d2 <= max_dist * max_dist)
    r = tgt[idx] - moved
    J = torch.cat([R @ skew(src), (-R).expand(src.shape[0], 3, 3)], -1)  # [N, 3, 6]
    sigma = R @ src_covs_reg @ R.T + tgt_covs_reg[idx]
    G, info = torch.linalg.cholesky_ex(work(sigma))
    ok = ok & (info == 0)  # a singular row adds nothing
    G = torch.where((info == 0)[:, None, None], G, torch.eye(3, dtype=G.dtype, device=G.device))
    c = torch.linalg.solve_triangular(G, work(r)[..., None], upper=False).to(r.dtype)[..., 0]
    A = torch.linalg.solve_triangular(G, work(J), upper=False).to(J.dtype)
    w = ok.to(A.dtype)
    A = A * w[:, None, None]
    c = c * w[:, None]
    H = torch.einsum("nij,nik->jk", A, A)
    b = torch.einsum("nij,ni->j", A, c)
    if with_error:
        return H, b, int(ok.sum()), 0.5 * (c * c).sum()
    return H, b, int(ok.sum())


def refine(T0, src, src_valid, src_covs, tgt, tgt_valid, tgt_covs, max_dist: float, lam: float = 1.0,
           iterations: int = 50, tol: float = 1e-10, dtype=torch.float64):
    """Gauss-Newton (``H + lam I``) from ``T0`` until a step is under
    ``tol`` in both blocks or ``iterations`` ran; returns the pose."""
    T = T0.to(dtype)
    src, tgt = src.to(dtype), tgt.to(dtype)
    scr = plane_regularize(src_covs.to(dtype))
    tcr = plane_regularize(tgt_covs.to(dtype))
    eye = torch.eye(6, dtype=dtype, device=T.device)
    for _ in range(iterations):
        H, b, _ = linearize(T, src, scr, tgt, tgt_valid, tcr, src_valid, max_dist)
        delta = torch.linalg.solve(work(H + lam * eye), -work(b)).to(dtype)
        T = T @ se3_exp(delta)
        if float(delta[:3].norm()) < tol and float(delta[3:].norm()) < tol:
            break
    return T


def judge(T_prog, T_init, src, src_valid, src_covs, tgt, tgt_valid, tgt_covs, cfg: dict) -> dict:
    """``reg_trans_gap_m`` and ``reg_rot_gap_rad``: the gap between the
    program's pose and the reference's, the same procedure in float64."""
    T = refine(T_init, src, src_valid, src_covs, tgt, tgt_valid, tgt_covs, cfg["max_corr_dist"],
               iterations=cfg["max_iterations"], tol=cfg["criteria"])
    Tp = T_prog.to(torch.float64)
    return {"reg_trans_gap_m": float((T[:3, 3] - Tp[:3, 3]).norm()),
            "reg_rot_gap_rad": rotation_angle(T[:3, :3], Tp[:3, :3])}


def control(T_init, src, src_valid, src_covs, tgt, tgt_valid, tgt_covs, cfg: dict, dtype=torch.bfloat16):
    """The stage in ``dtype`` in the program's place: Gauss-Newton from the
    registration's initial guess, the program's iteration budget and
    convergence test."""
    return refine(T_init, src, src_valid, src_covs, tgt, tgt_valid, tgt_covs, cfg["max_corr_dist"],
                  iterations=cfg["max_iterations"], tol=cfg["criteria"], dtype=dtype).float()
