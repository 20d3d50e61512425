"""The preprocessed scan: box filter, voxel centroids, random subset,
robust covariances and the angle-of-incidence gate.

:func:`judge` reads a preprocessed scan ``[N]`` (the program's, or the
control's) against the raw scan it came from. The random subset is the
program's own choice: it is checked to be distinct voxel centroids of the
raw scan, and its covariances and gate are worked out again on it.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.common import boundary_tie, covariances_geman_mcclure, eigh, knn, smallest_eigenvector


def voxel_centroids(points: torch.Tensor, valid: torch.Tensor, cfg: dict, dtype=torch.float64):
    """``(keys [V, 3] int64, centroids [V, 3])`` of the box-filtered raw
    scan, in ``dtype``; the keys sorted."""
    p = points.to(dtype)
    linf = p.abs().amax(-1)
    keep = valid & torch.isfinite(p).all(-1) & (linf >= cfg["box_min"]) & (linf <= cfg["box_max"])
    p = p[keep]
    keys = torch.floor(p / cfg["voxel"]).long()
    uk, inv = torch.unique(keys, dim=0, return_inverse=True)
    sums = torch.zeros((uk.shape[0], 3), dtype=dtype, device=p.device).index_add_(0, inv, p)
    cnt = torch.zeros(uk.shape[0], dtype=dtype, device=p.device).index_add_(0, inv, torch.ones_like(p[:, 0]))
    return uk, sums / cnt[:, None]


def _lookup(keys: torch.Tensor, table: torch.Tensor):
    """Row of each of ``keys [P, 3]`` in the sorted unique ``table [V, 3]``
    (-1 where absent)."""
    if table.shape[0] == 0:
        return torch.full((keys.shape[0],), -1, dtype=torch.long, device=keys.device)
    lo = table.amin(0)
    span = table.amax(0) - lo + 1
    def code(k):
        return ((k - lo) * torch.stack([span[1] * span[2], span[2], torch.ones_like(span[0])])).sum(-1)
    inside = ((keys >= lo) & (keys < lo + span)).all(-1)
    tc = code(table)
    kc = code(keys)
    pos = torch.searchsorted(tc, kc).clamp_max(tc.shape[0] - 1)
    return torch.where(inside & (tc[pos] == kc), pos, -1)


def gate_cos(points: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """|cos| of the angle between each point's ray and its normal."""
    n = smallest_eigenvector(covs)
    return ((points * n).sum(-1) / torch.clamp_min(points.norm(dim=-1) * n.norm(dim=-1), 1e-30)).abs()


def judge(raw_pts, raw_mask, out_pts, out_mask, out_covs, cfg: dict) -> dict:
    """Readings of one preprocessed scan: ``scan_point_gap_m`` (the widest
    gap from a point to its voxel's centroid; 1 m for a point that is no
    centroid or a voxel taken twice), ``scan_cov_rel_gap`` (the widest
    Frobenius gap of a covariance, over the reference's norm, where its
    condition number is at most ``cov_max_condition``),
    ``scan_normal_gap`` (the widest sine of the angle between the normals,
    times the gap between the two smallest eigenvalues over the largest)
    and ``scan_gate_errors`` (points whose normal is defined, the
    eigenvalues ``gate_min_normal_gap`` apart, kept or dropped against the
    gate outside a margin)."""
    f64 = torch.float64
    keys, cents = voxel_centroids(raw_pts, raw_mask, cfg)
    n_vox = keys.shape[0]
    cap = min(cfg["scan_capacity"], raw_pts.shape[0])
    L = min(cfg["random_num"], n_vox) if cfg["random_num"] < cap else n_vox
    out = {"scan_point_gap_m": 0.0, "scan_cov_rel_gap": 0.0, "scan_normal_gap": 0.0, "scan_gate_errors": 0}
    if n_vox > cap or L == 0:
        out["skipped"] = 1
        return out
    p = out_pts[:L].to(f64)
    row = _lookup(torch.floor(p / cfg["voxel"]).long(), keys)
    gap = torch.where(row >= 0, (p - cents[row.clamp_min(0)]).norm(dim=-1), torch.ones_like(p[:, 0]))
    dup = torch.unique(row[row >= 0]).numel() < int((row >= 0).sum())
    out["scan_point_gap_m"] = 1.0 if dup else float(gap.max())
    if out_mask[L:].any():
        out["scan_gate_errors"] += int(out_mask[L:].sum())

    # covariances of the subset's own neighbourhoods (k with the point itself)
    k = cfg["neighbor_num"]
    valid = torch.ones(L, dtype=torch.bool, device=p.device)
    idx, d2 = knn(p, valid, p, k + 1)
    tie = boundary_tie(p, d2, k)
    ref = covariances_geman_mcclure(p, idx[:, :k], d2[:, :k], cfg["mad_scale"], cfg["min_robust_scale"],
                                    cfg["robust_iterations"])
    m = out_mask[:L].bool()
    # the robust re-estimate divides by the first estimate: a neighbourhood
    # with a condition number of kappa moves by ~kappa float32 roundings, so
    # whole covariances are compared where it is well-conditioned, and
    # everywhere the normal (what the registration and the gate read)
    lam, V = eigh(ref)
    kappa = lam[:, 2] / lam[:, 0].clamp_min(1e-300)
    defined = (lam[:, 1] - lam[:, 0]) >= cfg["gate_min_normal_gap"] * lam[:, 2]
    judged = m & ~tie & (kappa <= cfg["cov_max_condition"])
    if judged.any():
        diff = (out_covs[:L].to(f64) - ref).flatten(-2).norm(dim=-1) / ref.flatten(-2).norm(dim=-1)
        out["scan_cov_rel_gap"] = float(diff[judged].max())
    _, Vp = eigh(out_covs[:L].to(f64))
    # a normal is as well defined as its two smallest eigenvalues lie apart:
    # its angle is weighed by that gap (over the largest eigenvalue)
    cos = (Vp[:, :, 0] * V[:, :, 0]).sum(-1).abs().clamp(max=1.0)
    weighed = torch.sqrt(1.0 - cos * cos) * (lam[:, 1] - lam[:, 0]) / lam[:, 2].clamp_min(1e-300)
    if (m & ~tie).any():
        out["scan_normal_gap"] = float(weighed[m & ~tie].max())
    c = gate_cos(p, ref)
    lo, hi = math.cos(cfg["gate_max_angle"]), math.cos(cfg["gate_min_angle"])
    margin = cfg["gate_margin"]
    inside = (c >= lo + margin) & (c <= hi - margin)
    outside = (c < lo - margin) | (c > hi + margin)
    wrong = defined & ~tie & ((m & outside) | (~m & inside))
    out["scan_gate_errors"] += int(wrong.sum())
    return out


def control(raw_pts, raw_mask, cfg: dict, gen: torch.Generator, dtype=torch.bfloat16):
    """The stage computed in ``dtype`` in the program's place: centroids, a
    uniform random subset (``gen``), robust covariances and the gate, in the
    program's layout ``(points [N, 3], mask [N], covs [N, 3, 3])``."""
    keys, cents = voxel_centroids(raw_pts.to(dtype), raw_mask, cfg, dtype)
    n = cents.shape[0]
    L = min(cfg["random_num"], n)
    pick = torch.randperm(n, generator=gen, device=gen.device)[:L].to(cents.device)
    p = cents[pick]
    k = cfg["neighbor_num"]
    idx, d2 = knn(p, torch.ones(L, dtype=torch.bool, device=p.device), p, k)
    covs = covariances_geman_mcclure(p, idx, d2, cfg["mad_scale"], cfg["min_robust_scale"],
                                     cfg["robust_iterations"])
    c = gate_cos(p, covs)
    keep = (c >= math.cos(cfg["gate_max_angle"])) & (c <= math.cos(cfg["gate_min_angle"]))
    N = cfg["random_num"]
    pts = torch.zeros((N, 3), device=p.device)
    mask = torch.zeros(N, dtype=torch.bool, device=p.device)
    cv = torch.eye(3, device=p.device).repeat(N, 1, 1)
    pts[:L], mask[:L], cv[:L] = p.float(), keep, covs.float()
    return pts, mask, cv
