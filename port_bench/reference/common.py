"""Shared plain operations: k-NN by brute force, neighbourhood covariances
(plain and robust), GICP's plane regularization, SE(3) exp.

Operations that PyTorch has no bfloat16 form of (``eigh``, ``cholesky``,
``solve``) run in float32 on bfloat16-rounded inputs and round their outputs
back, so a bfloat16 control stays bfloat16 between them.
"""

from __future__ import annotations

import math

import torch


def work(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a dtype the linear-algebra routines take."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def eigh(A: torch.Tensor):
    lam, V = torch.linalg.eigh(work(A))
    return lam.to(A.dtype), V.to(A.dtype)


def knn(points: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor, k: int, chunk: int = 2048):
    """Exact k nearest valid ``points [M, 3]`` of ``queries [Q, 3]``:
    ``(idx [Q, k], d2 [Q, k])``, ascending, lower index first on ties; a
    missing neighbour has d2 = inf."""
    inf = torch.tensor(torch.inf, dtype=points.dtype, device=points.device)
    idx_out, d2_out = [], []
    for q0 in range(0, queries.shape[0], chunk):
        q = queries[q0 : q0 + chunk]
        d2 = ((q[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        d2 = torch.where(valid[None], d2, inf)
        kk = min(k, points.shape[0])
        # a stable sort keeps the lower index first among equal distances
        d2s, order = torch.sort(work(d2), dim=1, stable=True)
        idx_out.append(order[:, :kk])
        d2_out.append(d2s[:, :kk].to(points.dtype))
    return torch.cat(idx_out), torch.cat(d2_out)


def boundary_tie(points: torch.Tensor, d2: torch.Tensor, k: int) -> torch.Tensor:
    """Points whose k-th and (k+1)-th nearest neighbours lie closer in
    squared distance than float32 can tell apart (a millionth of the squared
    distance plus the point's squared norm, which a float32 search's
    rounding scales with): either may be the k-th, so the neighbourhood is
    not judged. ``d2 [N, k + 1]`` ascending."""
    if d2.shape[1] <= k:
        return torch.zeros(d2.shape[0], dtype=torch.bool, device=d2.device)
    scale = d2[:, k].abs() + (points.double() ** 2).sum(-1)
    return (d2[:, k] - d2[:, k - 1]).abs() <= 1e-6 * scale


def _moments(nbr: torch.Tensor, ok: torch.Tensor, w: torch.Tensor, min_num: int = 4):
    """Weighted mean and covariance of neighbourhoods ``nbr [N, k, 3]``
    (centred two-pass form); identity where too few or weightless."""
    w = torch.where(ok, w, torch.zeros_like(w))
    tw = w.sum(-1)
    tws = torch.clamp_min(tw, 1e-30)
    mean = (w[..., None] * nbr).sum(-2) / tws[..., None]
    diff = nbr - mean[..., None, :]
    cov = (w[..., None, None] * diff[..., :, None] * diff[..., None, :]).sum(-3) / tws[..., None, None]
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    good = (ok.sum(-1) >= max(min_num, 4)) & (tw > torch.finfo(torch.float32).eps)
    eye = torch.eye(3, dtype=nbr.dtype, device=nbr.device).expand(cov.shape)
    return torch.where(good[..., None, None], cov, eye), mean, good


def covariances(points: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Plain neighbourhood covariance of each point's k neighbours."""
    ok = torch.isfinite(d2)
    cov, _, _ = _moments(points[idx], ok, torch.ones_like(d2))
    return cov


def covariances_geman_mcclure(points, idx, d2, mad_scale: float, min_scale: float, iterations: int):
    """The robust (IRLS) neighbourhood covariance under the Geman-McClure
    weight ``1 / (1 + r^2)^2``, ``r`` a neighbour's squared Mahalanobis distance under
    the current estimate, the scale ``mad_scale`` times the median of those
    (an invalid slot counts 0), floored at ``min_scale``; a failed
    re-estimate keeps the previous one."""
    ok = torch.isfinite(d2)
    nbr = points[idx]
    cov, mean, good0 = _moments(nbr, ok, torch.ones_like(d2))
    running = good0
    for _ in range(iterations):
        inv, info = torch.linalg.inv_ex(work(cov))
        inv = torch.where((info == 0)[..., None, None], inv, torch.nan).to(cov.dtype)  # singular: no number
        diff = nbr - mean[..., None, :]
        m2 = torch.where(ok, (diff * (inv[..., None, :, :] * diff[..., None, :]).sum(-1)).sum(-1),
                         torch.zeros_like(d2))
        s, _ = torch.sort(work(m2), dim=-1)
        k = m2.shape[-1]
        med = (0.5 * (s[..., (k - 1) // 2] + s[..., k // 2])).to(m2.dtype)
        scale = torch.clamp_min(mad_scale * med, min_scale)
        # the weight's argument is the squared distance itself, as upstream's
        r = torch.clamp_min(m2 / scale[..., None], 1e-30)
        w = 1.0 / (1.0 + r * r) ** 2
        w = torch.where(m2 <= 1e-8, torch.ones_like(w), w)
        new_cov, new_mean, good = _moments(nbr, ok, w)
        upd = running & good
        cov = torch.where(upd[..., None, None], new_cov, cov)
        mean = torch.where(upd[..., None], new_mean, mean)
        running = upd
    eye = torch.eye(3, dtype=points.dtype, device=points.device).expand(cov.shape)
    return torch.where(good0[..., None, None], cov, eye)


def smallest_eigenvector(cov: torch.Tensor) -> torch.Tensor:
    _, V = eigh(cov)
    return V[..., :, 0]


def plane_regularize(cov: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """GICP's regularization: eigenvalues ``(eps, 1, 1)``."""
    v0 = smallest_eigenvector(cov)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    return eye - (1.0 - eps) * v0[..., :, None] * v0[..., None, :]


def skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.vector_norm(work(w), dim=-1).to(w.dtype)
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    small = th < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th * th / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th * th / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def se3_exp(x: torch.Tensor) -> torch.Tensor:
    """Twist ``[..., 6]`` (rotation first) -> ``[..., 4, 4]``."""
    w, v = x[..., :3], x[..., 3:]
    th = torch.linalg.vector_norm(work(w), dim=-1).to(x.dtype)
    K = skew(w)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    small = th < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    b = torch.where(small, 0.5 - th * th / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    c = torch.where(small, 1.0 / 6.0 - th * th / 120.0, (ths - torch.sin(ths)) / (ths**3))
    V = eye + b[..., None, None] * K + c[..., None, None] * (K @ K)
    T = torch.zeros(x.shape[:-1] + (4, 4), dtype=x.dtype, device=x.device)
    T[..., :3, :3] = so3_exp(w)
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def rotation_angle(Ra: torch.Tensor, Rb: torch.Tensor) -> float:
    """The angle (rad) of ``Ra^T Rb``."""
    M = (Ra.transpose(-1, -2) @ Rb).double()
    c = ((M.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0).clamp(-1.0, 1.0)
    # acos loses digits near 0: use the skew part as well
    s = 0.5 * torch.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0], M[..., 1, 0] - M[..., 0, 1]],
                          -1).norm(dim=-1)
    return float(torch.atan2(s, c).max()) if M.dim() > 2 else float(math.atan2(float(s), float(c)))
