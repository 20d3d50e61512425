"""Core ICP registration solver: the align loop with GN, LM and dogleg.

Counterpart of :mod:`sycl_points_tpu.registration.registration`, with the
same parameter dataclasses, defaults and semantics. The JAX loop is one
``lax.while_loop``; here it is a Python loop whose tensors stay on the
device. The host reads one small tensor per iteration (the loop's
convergence test and, for LM, the first candidate's accept flag together),
plus one more when the LM candidate sweep runs.

Not ported in this slice (they raise ``NotImplementedError``): degenerate
regularization, the map prior, the rotation constraint and the
coarse-to-fine correspondence schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from sycl_points_tpu_torch.ops.robust import RobustLossType, compute_error, compute_weight
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.registration.factors import (
    RegType,
    genz_planarity,
    residual_norms_only,
    whitened_rows,
)
from sycl_points_tpu_torch.utils import lie
from sycl_points_tpu_torch.utils.eigh3 import plane_regularize
from sycl_points_tpu_torch.utils.smallmat import solve_psd

_F32 = torch.float32


def _scalar(value, dev, dtype=_F32) -> torch.Tensor:
    """A 0-dim device tensor made by a fill kernel: unlike ``torch.tensor``
    from host memory, it costs no host-device copy and no sync."""
    return torch.full((), value, dtype=dtype, device=dev)


@dataclasses.dataclass(frozen=True)
class RobustParams:
    type: RobustLossType = RobustLossType.NONE
    default_scale: float = 10.0


@dataclasses.dataclass(frozen=True)
class RotationConstraintParams:
    enable: bool = False
    weight: float = 1.0
    robust_scale: float = 10.0


@dataclasses.dataclass(frozen=True)
class GaussNewtonParams:
    lambda_: float = 1.0


@dataclasses.dataclass(frozen=True)
class LevenbergMarquardtParams:
    max_inner_iterations: int = 10
    lambda_factor: float = 2.0
    init_lambda: float = 1.0
    max_lambda: float = 1e3
    min_lambda: float = 1e-6


@dataclasses.dataclass(frozen=True)
class DoglegParams:
    initial_trust_region_radius: float = 1.0
    min_trust_region_radius: float = 1e-4
    max_trust_region_radius: float = 10.0
    eta1: float = 0.25
    eta2: float = 0.75
    gamma_decrease: float = 0.25
    gamma_increase: float = 2.0


@dataclasses.dataclass(frozen=True)
class CriteriaParams:
    translation: float = 1e-3  # [m]
    rotation: float = 1e-3  # [rad]


@dataclasses.dataclass(frozen=True)
class RegistrationParams:
    reg_type: RegType = RegType.GICP
    max_correspondence_distance: float = 2.0
    coarse_to_fine_iters: int = 0
    coarse_stride: int = 4
    robust: RobustParams = RobustParams()
    rotation_constraint: RotationConstraintParams = RotationConstraintParams()
    genz_planarity_threshold: float = 0.2
    optimization_method: str = "gauss_newton"  # gauss_newton | levenberg_marquardt | powell_dogleg
    gn: GaussNewtonParams = GaussNewtonParams()
    lm: LevenbergMarquardtParams = LevenbergMarquardtParams()
    dogleg: DoglegParams = DoglegParams()
    max_iterations: int = 20
    criteria: CriteriaParams = CriteriaParams()
    degenerate_reg: Optional[Any] = None
    map_prior_enable: bool = False


class LinearizedResult(NamedTuple):
    H: torch.Tensor  # [6, 6]
    b: torch.Tensor  # [6]
    error: torch.Tensor  # scalar robust cost
    inlier: torch.Tensor  # scalar int32


class RegistrationResult(NamedTuple):
    T: torch.Tensor  # [4, 4]
    converged: torch.Tensor
    iterations: torch.Tensor
    H: torch.Tensor
    b: torch.Tensor
    error: torch.Tensor
    inlier: torch.Tensor
    H_raw: torch.Tensor
    b_raw: torch.Tensor
    error_raw: torch.Tensor


# Columns of the per-iteration trace buffer (align(..., trace=True)); rows
# beyond the executed iteration count stay NaN.
TRACE_COLS = (
    "level",
    "error",
    "inlier",
    "lambda_or_radius",
    "step_rot",
    "step_trans",
    "accepted",
    "converged",
)


class _Targets(NamedTuple):
    """Pose-independent per-alignment target attributes; ``packed`` holds
    them flattened into one [M, F] matrix so the loop does a single gather."""

    points: torch.Tensor
    mask: torch.Tensor
    covs_reg: Optional[torch.Tensor]
    covs_raw: Optional[torch.Tensor]
    normals: Optional[torch.Tensor]
    planar: Optional[torch.Tensor]
    packed: Optional[torch.Tensor] = None
    layout: tuple = ()


def _pack_targets(tgt: _Targets) -> _Targets:
    cols = [tgt.points]
    layout = []
    if tgt.covs_reg is not None:
        cols.append(tgt.covs_reg.reshape(-1, 9))
        layout.append(("covs_reg", 9))
    if tgt.covs_raw is not None:
        cols.append(tgt.covs_raw.reshape(-1, 9))
        layout.append(("covs_raw", 9))
    if tgt.normals is not None:
        cols.append(tgt.normals)
        layout.append(("normals", 3))
    if tgt.planar is not None:
        cols.append(tgt.planar.to(_F32)[:, None])
        layout.append(("planar", 1))
    if not layout:
        return tgt
    return tgt._replace(packed=torch.cat(cols, dim=1), layout=tuple(layout))


def _precompute_targets(params: RegistrationParams, source: PointCloud, target: PointCloud):
    reg = params.reg_type
    src_covs_reg = None
    tgt = _Targets(target.points, target.mask, None, None, None, None)
    if reg is RegType.GICP:
        if source.covs is None or target.covs is None:
            raise ValueError("GICP requires source and target covariances")
        src_covs_reg = plane_regularize(source.covs)
        tgt = tgt._replace(covs_reg=plane_regularize(target.covs))
    elif reg is RegType.POINT_TO_DISTRIBUTION:
        if target.covs is None:
            raise ValueError("POINT_TO_DISTRIBUTION requires target covariances")
        tgt = tgt._replace(covs_raw=target.covs)
    elif reg is RegType.POINT_TO_PLANE:
        if target.normals is None:
            raise ValueError("POINT_TO_PLANE requires target normals")
        tgt = tgt._replace(normals=target.normals)
    elif reg is RegType.GENZ:
        if target.normals is None or target.covs is None:
            raise ValueError("GENZ requires target normals and covariances")
        tgt = tgt._replace(
            normals=target.normals,
            planar=genz_planarity(target.covs, params.genz_planarity_threshold),
        )
    return src_covs_reg, _pack_targets(tgt)


def _gather_correspondences(params, idx, d2, src_mask, tgt: _Targets) -> _Targets:
    """Target rows for the nearest indices, with the correspondence gate."""
    corr_mask = src_mask & (d2 <= params.max_correspondence_distance**2)
    idx = idx.long()
    if tgt.packed is None:
        return _Targets(tgt.points[idx], corr_mask, None, None, None, None)
    flat = tgt.packed[idx]
    out = {}
    col = 3
    for name, width in tgt.layout:
        block = flat[:, col : col + width]
        col += width
        if name == "planar":
            out[name] = block[:, 0] > 0.5
        elif width == 9:
            out[name] = block.reshape(-1, 3, 3)
        else:
            out[name] = block
    return _Targets(
        points=flat[:, 0:3], mask=corr_mask,
        covs_reg=out.get("covs_reg"), covs_raw=out.get("covs_raw"),
        normals=out.get("normals"), planar=out.get("planar"),
    )


def _correspondences(params, knn, src_pts, src_mask, T, tgt: _Targets) -> _Targets:
    """One 1-NN search with the pose folded into the queries."""
    res = knn.search(src_pts, 1, pose=T)
    return _gather_correspondences(params, res.indices[:, 0], res.distances[:, 0], src_mask, tgt)


def _genz_alpha(corr: _Targets) -> torch.Tensor:
    """Planar fraction among inliers."""
    inl = corr.mask.sum()
    pl = (corr.mask & corr.planar).sum()
    return torch.where(inl > 0, pl.to(_F32) / torch.clamp_min(inl, 1).to(_F32), 1.0)


def _linearize(params, T, src_pts, src_covs_reg, corr: _Targets, robust_scale, genz_alpha):
    rows = whitened_rows(
        params.reg_type, T, src_pts, corr.points,
        src_covs_reg=src_covs_reg, tgt_covs_reg=corr.covs_reg,
        tgt_covs_raw=corr.covs_raw, tgt_normals=corr.normals,
        genz_planar=corr.planar, genz_alpha=genz_alpha,
    )
    w_rob = compute_weight(params.robust.type, rows.residual_norm, robust_scale)
    m = corr.mask.to(src_pts.dtype)
    scale = torch.sqrt(w_rob * rows.genz_weight) * m
    A = (rows.A * scale[:, None, None]).reshape(-1, 6)
    c = (rows.c * scale[:, None]).reshape(-1)
    H = A.T @ A
    b = A.T @ c
    err = (m * rows.genz_weight * compute_error(params.robust.type, rows.residual_norm, robust_scale)).sum()
    return LinearizedResult(H, b, err, corr.mask.sum(dtype=torch.int32))


def _error_at(params, T, src_pts, src_covs_reg, corr: _Targets, robust_scale, genz_alpha):
    """Robust error and inliers at pose ``T`` (``[4,4]`` or ``[C,4,4]``)
    over frozen correspondences."""
    rn, gw = residual_norms_only(
        params.reg_type, T, src_pts, corr.points,
        src_covs_reg=src_covs_reg, tgt_covs_reg=corr.covs_reg,
        tgt_covs_raw=corr.covs_raw, tgt_normals=corr.normals,
        genz_planar=corr.planar, genz_alpha=genz_alpha,
    )
    m = corr.mask.to(src_pts.dtype)
    err = (m * gw * compute_error(params.robust.type, rn, robust_scale)).sum(-1)
    return err, corr.mask.sum(dtype=torch.int32)


def _is_converged(params: RegistrationParams, delta: torch.Tensor) -> torch.Tensor:
    """Per-step convergence test; ``delta`` is ``[..., 6]``."""
    dr = torch.linalg.vector_norm(delta[..., :3], dim=-1)
    dt = torch.linalg.vector_norm(delta[..., 3:], dim=-1)
    return (dt < params.criteria.translation) & (dr < params.criteria.rotation)


def compute_dogleg_step(H, g, radius):
    """Powell dogleg step for ``H p = -g`` inside a trust region; returns
    ``(p, step_norm, predicted_reduction)``."""
    eps = torch.finfo(_F32).eps
    p_gn, gn_ok = solve_psd(H, -g)
    norm_gn = torch.linalg.vector_norm(p_gn)
    gn_ok = gn_ok & torch.isfinite(norm_gn)

    g_sq = torch.dot(g, g)
    gHg = torch.dot(g, H @ g)
    alpha = torch.where(gHg > eps, g_sq / torch.clamp_min(gHg, 1e-30), 1.0)
    alpha = torch.where(torch.isfinite(alpha), alpha, 1.0)
    p_sd = -alpha * g
    norm_sd = torch.linalg.vector_norm(p_sd)

    diff = p_gn - p_sd
    a = torch.dot(diff, diff)
    bq = 2.0 * torch.dot(p_sd, diff)
    cq = torch.dot(p_sd, p_sd) - radius * radius
    disc = torch.clamp_min(bq * bq - 4.0 * a * cq, 0.0)
    tau = torch.where(a > eps, (-bq + torch.sqrt(disc)) / torch.clamp_min(2.0 * a, 1e-30), 0.0)
    p_blend = p_sd + torch.clamp(tau, 0.0, 1.0) * diff

    sd_clipped = torch.where(
        norm_sd > 1e-30, (radius / torch.clamp_min(norm_sd, 1e-30)) * p_sd, p_sd * 0.0
    )
    p = torch.where(
        gn_ok & (norm_gn <= radius),
        p_gn,
        torch.where(
            norm_sd >= radius,
            sd_clipped,
            torch.where(gn_ok, p_blend, torch.where(norm_sd > radius, sd_clipped, p_sd)),
        ),
    )
    pred = -(torch.dot(g, p) + 0.5 * torch.dot(p, H @ p))
    return p, torch.linalg.vector_norm(p), pred


class _Step(NamedTuple):
    """What one optimizer iteration decided (tensors on the device, except
    ``conv``, which the loop control reads on the host)."""

    T: torch.Tensor
    conv: bool
    err: torch.Tensor
    inlier: torch.Tensor
    lam: torch.Tensor
    trust: torch.Tensor
    step: torch.Tensor
    accepted: torch.Tensor


def _lm_step(params, T, H, g, cur_err, inlier, lm_lambda, error_fn) -> _Step:
    """Two-stage parallel-candidate LM: candidate 0 (the current lambda)
    alone first; only when it is rejected, all ``max_inner_iterations``
    candidates as one batch, taking the first that improves or plateaus (the
    reference's sequential inner loop, in one pass)."""
    p = params.lm
    C = p.max_inner_iterations
    dev = H.device
    factors = p.lambda_factor ** torch.arange(C, dtype=_F32, device=dev)
    lams = torch.clamp(lm_lambda * factors, p.min_lambda, p.max_lambda)
    eye6 = torch.eye(6, dtype=_F32, device=dev)

    delta0, _ = solve_psd(H + lams[0] * eye6, -g)
    T_c0 = T @ lie.se3_exp(delta0)
    err0, inl0 = error_fn(T_c0)
    accept0, conv0 = torch.stack([err0 <= cur_err, _is_converged(params, delta0)]).tolist()
    if accept0:
        lam_next = torch.clamp(lams[0] / p.lambda_factor, p.min_lambda, p.max_lambda)
        return _Step(T_c0, conv0, err0, inl0, lam_next, None, delta0, _scalar(True, dev, torch.bool))

    deltas, _ = solve_psd(H[None] + lams[:, None, None] * eye6, -g.expand(C, 6))
    T_cands = T @ lie.se3_exp(deltas)
    errs, inl = error_fn(T_cands)
    accept = errs <= cur_err
    prev_errs = torch.cat([torch.full((1,), torch.finfo(_F32).max, device=dev), errs[:-1]])
    take = accept | (torch.abs(errs - prev_errs) <= 1e-6)
    take_h, accept_h, conv_h = torch.stack([take, accept, _is_converged(params, deltas)]).tolist()
    if not any(take_h):
        # Exhausted sweep: the reference's inner loop still records converged
        # from the last trial's delta, so a max-lambda micro-step ends the loop.
        lam_next = torch.clamp(lm_lambda * p.lambda_factor**C, p.min_lambda, p.max_lambda)
        zero = torch.zeros(6, dtype=_F32, device=dev)
        return _Step(T, conv_h[-1], cur_err, inlier, lam_next, None, zero, _scalar(False, dev, torch.bool))
    i = take_h.index(True)
    if accept_h[i]:
        lam_next = torch.clamp(lams[i] / p.lambda_factor, p.min_lambda, p.max_lambda)
    else:
        lam_next = lams[i]
    return _Step(T_cands[i], conv_h[i], errs[i], inl, lam_next, None, deltas[i], _scalar(True, dev, torch.bool))


def _dogleg_step(params, T, H, g, cur_err, inlier, trust_radius, error_fn) -> _Step:
    p = params.dogleg

    def clamp(r):
        return torch.clamp(r, p.min_trust_region_radius, p.max_trust_region_radius)

    radius = clamp(trust_radius)
    step, step_norm, pred = compute_dogleg_step(H, g, radius)
    T_c = T @ lie.se3_exp(step)
    new_err, new_inl = error_fn(T_c)
    rho = (cur_err - new_err) / torch.clamp_min(pred, 1e-30)
    reject = (pred <= 0.0) | (rho < p.eta1)
    grow = (rho > p.eta2) & (step_norm >= radius * 0.99)
    trust_next = clamp(
        torch.where(reject, radius * p.gamma_decrease, torch.where(grow, radius * p.gamma_increase, radius))
    )
    conv = (~reject) & _is_converged(params, step)
    return _Step(
        T=torch.where(reject, T, T_c),
        conv=bool(conv),
        err=torch.where(reject, cur_err, new_err),
        inlier=torch.where(reject, inlier, new_inl),
        lam=None,
        trust=trust_next,
        step=torch.where(reject, torch.zeros_like(step), step),
        accepted=~reject,
    )


def align(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    params: RegistrationParams = RegistrationParams(),
    initial_guess: Optional[torch.Tensor] = None,
    robust_scale: Optional[float] = None,
    map_prior=None,
    robust_schedule: Optional[tuple] = None,
    trace: bool = False,
):
    """Run ICP from ``initial_guess`` (identity by default).

    ``robust_schedule`` (tuple of (geometry_scale, rotation_scale) pairs; the
    rotation scale is unused until the rotation constraint is ported) runs
    the robust-annealing chain in one loop: each level runs at most
    ``max_iterations`` from the previous level's pose with fresh optimizer
    state. ``trace=True`` also returns a ``[max_iterations * n_levels,
    len(TRACE_COLS)]`` per-iteration buffer (unexecuted rows NaN).
    Returns ``RegistrationResult``, or ``(result, trace)`` with ``trace``.
    """
    if params.degenerate_reg is not None:
        raise NotImplementedError("degenerate regularization is not ported yet")
    if map_prior is not None or params.map_prior_enable:
        raise NotImplementedError("the map prior is not ported yet")
    if params.rotation_constraint.enable:
        raise NotImplementedError("the rotation constraint is not ported yet")
    if params.coarse_to_fine_iters > 0:
        raise NotImplementedError("the coarse-to-fine correspondence schedule is not ported yet")
    method = params.optimization_method
    if method not in ("gauss_newton", "levenberg_marquardt", "powell_dogleg"):
        raise ValueError(method)

    dev = source.device
    T = (
        torch.eye(4, dtype=_F32, device=dev)
        if initial_guess is None
        else initial_guess.to(device=dev, dtype=_F32)
    )
    if robust_schedule:
        geo = [g for g, _ in robust_schedule]
    else:
        geo = [params.robust.default_scale if robust_scale is None else robust_scale]
    geo_scales = [_scalar(g, dev) for g in geo]
    n_levels = len(geo)

    src_covs_reg, tgt = _precompute_targets(params, source, target)
    src_pts, src_mask = source.points, source.mask
    if hasattr(target_knn, "prepped"):
        target_knn = target_knn.prepped()

    lm_lambda = _scalar(params.lm.init_lambda, dev)
    trust = _scalar(params.dogleg.initial_trust_region_radius, dev)
    eye6 = torch.eye(6, dtype=_F32, device=dev)
    z6 = torch.zeros(6, dtype=_F32, device=dev)
    z66 = torch.zeros((6, 6), dtype=_F32, device=dev)
    zero_f = torch.zeros((), dtype=_F32, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    H = H_raw = z66
    g = b_raw = z6
    error = error_raw = zero_f
    inlier = zero_i
    conv = False
    it = total_it = level = 0
    rows = []

    while total_it < params.max_iterations * n_levels:
        r_scale = geo_scales[level]
        corr = _correspondences(params, target_knn, src_pts, src_mask, T, tgt)
        alpha = _genz_alpha(corr) if params.reg_type is RegType.GENZ else torch.ones((), dtype=_F32, device=dev)
        lin = _linearize(params, T, src_pts, src_covs_reg, corr, r_scale, alpha)
        H, g, cur_err, cur_inl = lin.H, lin.b, lin.error, lin.inlier
        H_raw, b_raw, error_raw = H, g, cur_err

        def error_fn(T_c, corr=corr, alpha=alpha, r_scale=r_scale):
            return _error_at(params, T_c, src_pts, src_covs_reg, corr, r_scale, alpha)

        if method == "gauss_newton":
            delta, _ = solve_psd(H + params.gn.lambda_ * eye6, -g)
            conv_t = _is_converged(params, delta)
            step = _Step(T @ lie.se3_exp(delta), bool(conv_t), cur_err, cur_inl, None, None, delta,
                         _scalar(True, dev, torch.bool))
            damping = _scalar(params.gn.lambda_, dev)
        elif method == "levenberg_marquardt":
            step = _lm_step(params, T, H, g, cur_err, cur_inl, lm_lambda, error_fn)
            lm_lambda = step.lam
            damping = step.lam
        else:
            step = _dogleg_step(params, T, H, g, cur_err, cur_inl, trust, error_fn)
            trust = step.trust
            damping = step.trust
        T, conv, error, inlier = step.T, step.conv, step.err, step.inlier

        if trace:
            rows.append(torch.stack([
                _scalar(level, dev), error.to(_F32), inlier.to(_F32),
                damping.to(_F32), torch.linalg.vector_norm(step.step[:3]),
                torch.linalg.vector_norm(step.step[3:]), step.accepted.to(_F32),
                _scalar(conv, dev),
            ]))

        # Robust-level transition: a level ends on convergence or after
        # max_iterations; the next level starts with fresh optimizer state.
        it += 1
        total_it += 1
        if conv or it >= params.max_iterations:
            if level >= n_levels - 1:
                break
            level += 1
            it = 0
            lm_lambda = _scalar(params.lm.init_lambda, dev)
            trust = _scalar(params.dogleg.initial_trust_region_radius, dev)

    result = RegistrationResult(
        T=T,
        converged=_scalar(conv, dev, torch.bool),
        iterations=_scalar(total_it, dev, torch.int32),
        H=H, b=g, error=error, inlier=inlier,
        H_raw=H_raw, b_raw=b_raw, error_raw=error_raw,
    )
    if not trace:
        return result
    buf = torch.full((params.max_iterations * n_levels, len(TRACE_COLS)), torch.nan, dtype=_F32, device=dev)
    if rows:
        buf[: len(rows)] = torch.stack(rows)
    return result, buf
