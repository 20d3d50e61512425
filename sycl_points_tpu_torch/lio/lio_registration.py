"""Tightly-coupled 15-DOF LiDAR-inertial registration.

Counterpart of :mod:`sycl_points_tpu.lio.lio_registration`, with the same
parameters and semantics: per iteration a correspondence search (``nn1`` on
the prepared target), the GICP linearization, the reduced-chi-squared ICP
weight, directional information shaping of the pose blocks, the IMU prior,
the 15x15 solve and the manifold retraction, under a robust annealing
schedule.

  * add_icp_factor: the 6x6 ICP system embedded into 15x15, the translation
    block turned into the world frame; the 15x15 solve by Cholesky
    (:func:`..utils.smallmat.solve_psd`, zero step on failure);
  * directional ICP weighting: the pose blocks' eigendecomposition
    (:func:`..utils.eigh3.eigh3`), weak or over-confident directions
    attenuated;
  * the IMU <-> LiDAR 15x15 covariance transforms with lever-arm Jacobians.

The JAX loop is one ``lax.while_loop`` a robust level; here it is a Python
loop whose tensors stay on the device and whose exit test is one counted
host read an iteration (:func:`..utils.sync.to_host`). LM tries its damping
candidates as one batch; where JAX picks a state with
``tree_map(where)``, :func:`..imu.factor.select` does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sycl_points_tpu_torch.imu.factor import (
    DOF,
    IDX_ACC_BIAS,
    IDX_GYR_BIAS,
    IDX_POS,
    IDX_ROT,
    IDX_VEL,
    State,
    compute_imu_gradient,
    compute_imu_hessian_gradient,
    compute_manifold_residual,
    retract,
    select,
)
from sycl_points_tpu_torch.ops.robust import RobustLossType
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.registration import registration as reg_core
from sycl_points_tpu_torch.registration.factors import RegType
from sycl_points_tpu_torch.registration.registration import (
    CriteriaParams,
    DoglegParams,
    GaussNewtonParams,
    LevenbergMarquardtParams,
    RegistrationParams,
    compute_dogleg_step,
)
from sycl_points_tpu_torch.utils import lie
from sycl_points_tpu_torch.utils.eigh3 import eigh3
from sycl_points_tpu_torch.utils.smallmat import solve_psd
from sycl_points_tpu_torch.utils.sync import to_host

_F32 = torch.float32
_POS = slice(IDX_POS, IDX_POS + 3)
_ROT = slice(IDX_ROT, IDX_ROT + 3)


@dataclasses.dataclass(frozen=True)
class LIORobustScheduleParams:
    auto_scale: bool = False
    init_scale: float = 10.0
    min_scale: float = 0.5
    rotation_init_scale: float = 10.0
    rotation_min_scale: float = 0.5
    auto_scaling_iter: int = 4


@dataclasses.dataclass(frozen=True)
class DirectionalIcpWeightingParams:
    enable: bool = True
    trans_min_eigenvalue_per_inlier: float = 10.0
    rot_min_eigenvalue_per_inlier: float = 10.0
    trans_weak_direction_scale: float = 0.2
    rot_weak_direction_scale: float = 0.2


@dataclasses.dataclass(frozen=True)
class LIORegistrationParams:
    total_iterations: int = 10
    criteria: CriteriaParams = CriteriaParams()
    optimization_method: str = "gauss_newton"
    gn: GaussNewtonParams = GaussNewtonParams()
    lm: LevenbergMarquardtParams = LevenbergMarquardtParams()
    dogleg: DoglegParams = DoglegParams()
    robust: LIORobustScheduleParams = LIORobustScheduleParams()
    invalid_regularization_factor: float = 1e4
    directional_icp_weighting: DirectionalIcpWeightingParams = DirectionalIcpWeightingParams()


class LIORegistrationResult(NamedTuple):
    state: State
    posterior_covariance: torch.Tensor  # [15, 15]
    T: torch.Tensor  # [4, 4]
    iterations: torch.Tensor  # the schedule's iteration budget, as in the JAX package
    inlier: torch.Tensor
    error: torch.Tensor
    executed: int = 0  # iterations that ran (known on the host)


# Per-iteration trace columns (align(..., trace=True)).
TRACE_COLS = (
    "level",          # robust annealing level
    "error",          # robust ICP cost at linearization
    "inlier",         # correspondence-gate inliers
    "icp_weight",     # reduced-chi^2 ICP weight this iteration
    "lambda_or_radius",  # LM lambda / dogleg radius after the iteration
    "step_rot",       # |rot| block of the APPLIED 15-DOF step
    "step_trans",     # |pos| block
    "step_vel",       # |vel| block
    "step_bg",        # |gyro bias| block
    "step_ba",        # |accel bias| block
    "accepted",       # 1 if the iteration moved the state
    "converged",      # convergence test on this iteration's step
)


def _set_blocks(M: torch.Tensor, blocks: dict) -> torch.Tensor:
    """A copy of ``M`` with ``{(row slice, col slice): value}`` written."""
    M = M.clone()
    for (r, c), v in blocks.items():
        M[r, c] = v
    return M


def add_icp_factor(H15, b15, icp_H, icp_b, R_world_lidar, weight):
    """Embed the 6x6 ICP system (twist order [rot, trans]) into the 15-D
    error state."""
    R = R_world_lidar
    H = _set_blocks(H15, {
        (_ROT, _ROT): H15[_ROT, _ROT] + weight * icp_H[0:3, 0:3],
        (_POS, _POS): H15[_POS, _POS] + weight * (R @ icp_H[3:6, 3:6] @ R.T),
        (_POS, _ROT): H15[_POS, _ROT] + weight * (R @ icp_H[3:6, 0:3]),
        (_ROT, _POS): H15[_ROT, _POS] + weight * (icp_H[0:3, 3:6] @ R.T),
    })
    b = b15.clone()
    b[_ROT] = b15[_ROT] + weight * icp_b[0:3]
    b[_POS] = b15[_POS] + weight * (R @ icp_b[3:6])
    return H, b


def _block_filters(H_blocks, min_eig_per_inlier, weak_scale, inlier_f):
    """sqrt-scaled eigen filters of 3x3 information blocks ``[B, 3, 3]``, one
    ``eigh3`` for all of them; ``min_eig_per_inlier`` and ``weak_scale``
    hold one value a block."""
    dev = H_blocks.device
    lam, V = eigh3(0.5 * (H_blocks + H_blocks.transpose(-1, -2)))
    lam = torch.clamp_min(lam, 0.0)
    min_info = torch.stack([torch.full((), max(m, 0.0), dtype=_F32, device=dev) for m in min_eig_per_inlier])
    min_info = (min_info * inlier_f)[:, None]
    ws = torch.stack([torch.full((), min(max(w, 0.0), 1.0), dtype=_F32, device=dev) for w in weak_scale])
    ratio = torch.clamp(lam / torch.clamp_min(min_info, 1e-30), 0.0, 1.0)
    scale = torch.where(lam <= 0.0, 0.0, torch.maximum(ratio, ws[:, None]))
    scale = torch.where(min_info > 0.0, scale, torch.where(lam <= 0.0, 0.0, 1.0))
    return (V * torch.sqrt(torch.clamp(scale, 0.0, 1.0))[:, None, :]) @ V.transpose(-1, -2)


def apply_directional_icp_weighting(H15, b15, inlier, params: DirectionalIcpWeightingParams):
    """Attenuate weak pose directions of the ICP-only factor."""
    if not params.enable:
        return H15, b15
    Hp = torch.cat([
        torch.cat([H15[_POS, _POS], H15[_POS, _ROT]], 1),
        torch.cat([H15[_ROT, _POS], H15[_ROT, _ROT]], 1),
    ])
    Hp = 0.5 * (Hp + Hp.T)
    bp = torch.cat([b15[_POS], b15[_ROT]])
    f_t, f_r = _block_filters(
        torch.stack([Hp[0:3, 0:3], Hp[3:6, 3:6]]),
        (params.trans_min_eigenvalue_per_inlier, params.rot_min_eigenvalue_per_inlier),
        (params.trans_weak_direction_scale, params.rot_weak_direction_scale), inlier.to(_F32))
    F = torch.block_diag(f_t, f_r)
    active = inlier > 0
    Hf = torch.where(active, F @ Hp @ F, Hp)
    bf = torch.where(active, F @ (F @ bp), bp)
    H = _set_blocks(H15, {(_POS, _POS): Hf[0:3, 0:3], (_POS, _ROT): Hf[0:3, 3:6],
                          (_ROT, _POS): Hf[3:6, 0:3], (_ROT, _ROT): Hf[3:6, 3:6]})
    b = b15.clone()
    b[_POS] = bf[0:3]
    b[_ROT] = bf[3:6]
    return H, b


def imu_to_lidar_jacobian(T_imu_to_lidar, R_world_lidar):
    """delta_x_lidar = J delta_x_imu."""
    R_li = T_imu_to_lidar[:3, :3]
    t_lidar_in_imu = lie.transform_inverse(T_imu_to_lidar)[:3, 3]
    R_world_imu = R_world_lidar @ R_li
    return _set_blocks(torch.eye(DOF, dtype=_F32, device=R_li.device), {
        (_ROT, _ROT): R_li, (_POS, _ROT): -R_world_imu @ lie.skew(t_lidar_in_imu)})


def transform_covariance_imu_to_lidar(P_imu, T_imu_to_lidar, R_world_lidar):
    J = imu_to_lidar_jacobian(T_imu_to_lidar, R_world_lidar)
    return J @ P_imu @ J.T


def transform_covariance_lidar_to_imu(P_lidar, T_imu_to_lidar, R_world_lidar):
    """Through the analytic block inverse of the Jacobian."""
    R_li = T_imu_to_lidar[:3, :3]
    t_lidar_in_imu = lie.transform_inverse(T_imu_to_lidar)[:3, 3]
    R_world_imu = R_world_lidar @ R_li
    Jinv = _set_blocks(torch.eye(DOF, dtype=_F32, device=R_li.device), {
        (_ROT, _ROT): R_li.T, (_POS, _ROT): R_world_imu @ lie.skew(t_lidar_in_imu) @ R_li.T})
    return Jinv @ P_lidar @ Jinv.T


def _level_schedule(params: LIORegistrationParams, factor: RegistrationParams):
    """(iterations_per_level, geo_scales, rot_scales)."""
    rp = params.robust
    auto = (
        rp.auto_scale
        and params.total_iterations > 0
        and factor.robust.type is not RobustLossType.NONE
        and 0.0 < rp.min_scale < rp.init_scale
        and 0.0 < rp.rotation_min_scale < rp.rotation_init_scale
        and rp.auto_scaling_iter > 0
    )
    levels = min(rp.auto_scaling_iter, params.total_iterations) if auto else 1
    base = params.total_iterations // levels
    extra = params.total_iterations % levels
    iters = [base + (1 if lvl < extra else 0) for lvl in range(levels)]
    if not auto:
        return iters, [factor.robust.default_scale], [factor.rotation_constraint.robust_scale]
    f = (rp.min_scale / rp.init_scale) ** (1.0 / (levels - 1)) if levels > 1 else 1.0
    fr = (rp.rotation_min_scale / rp.rotation_init_scale) ** (1.0 / (levels - 1)) if levels > 1 else 1.0
    return (
        iters,
        [rp.init_scale * f**i for i in range(levels)],
        [rp.rotation_init_scale * fr**i for i in range(levels)],
    )


def align(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    predicted_state: State,
    predicted_covariance: torch.Tensor,
    previous_posterior_covariance: torch.Tensor,
    factor_params: RegistrationParams = RegistrationParams(reg_type=RegType.GICP),
    params: LIORegistrationParams = LIORegistrationParams(),
    update_bias: bool | torch.Tensor = True,
    trace: bool = False,
):
    """The 15-DOF LIO solve from ``predicted_state``.

    ``trace=True`` also returns a ``[total_iterations, len(TRACE_COLS)]``
    per-iteration buffer (NaN rows = not executed): ``(result, trace)``.
    """
    if factor_params.rotation_constraint.enable:
        raise NotImplementedError("the rotation constraint is not ported yet")
    if factor_params.degenerate_reg is not None:
        raise NotImplementedError("degenerate regularization is not ported yet")
    method = params.optimization_method
    if method not in ("gauss_newton", "levenberg_marquardt", "powell_dogleg"):
        raise ValueError(method)

    dev = source.device
    eye15 = torch.eye(DOF, dtype=_F32, device=dev)
    zero15 = torch.zeros(DOF, dtype=_F32, device=dev)
    H_imu, _, imu_valid = compute_imu_hessian_gradient(predicted_state, predicted_state, predicted_covariance)
    icp_residual_dim = 1.0 if factor_params.reg_type in (RegType.POINT_TO_PLANE, RegType.GENZ) else 3.0

    src_covs_reg, tgt = reg_core._precompute_targets(factor_params, source, target)
    src_pts, src_mask = source.points, source.mask
    update_bias = torch.as_tensor(update_bias, device=dev)
    if hasattr(target_knn, "prepped"):
        target_knn = target_knn.prepped()

    bias_keep = torch.ones(DOF, dtype=torch.bool, device=dev)
    bias_keep[IDX_ACC_BIAS : IDX_ACC_BIAS + 3] = False
    bias_keep[IDX_GYR_BIAS : IDX_GYR_BIAS + 3] = False
    bias_keep = bias_keep | update_bias
    reg_diag = torch.zeros(DOF, dtype=_F32, device=dev)
    for idx in (IDX_VEL, IDX_ACC_BIAS, IDX_GYR_BIAS):
        reg_diag[idx : idx + 3] = params.invalid_regularization_factor
    H_extra = torch.where(imu_valid, H_imu, torch.diag(reg_diag))

    def imu_cost(state: State):
        r = compute_manifold_residual(predicted_state, state)
        return torch.where(imu_valid, 0.5 * (r * (H_imu * r[..., None, :]).sum(-1)).sum(-1), 0.0)

    def bias_freeze(delta):
        return torch.where(bias_keep, delta, 0.0)

    def is_converged(delta):
        return ((torch.linalg.vector_norm(delta[..., _ROT], dim=-1) < params.criteria.rotation)
                & (torch.linalg.vector_norm(delta[..., _POS], dim=-1) < params.criteria.translation))

    iters_per_level, geo_scales, rot_scales = _level_schedule(params, factor_params)

    state = predicted_state
    H_undamped = torch.zeros((DOF, DOF), dtype=_F32, device=dev)
    has_H = False
    last_inlier = torch.zeros((), dtype=torch.int32, device=dev)
    last_error = torch.zeros((), dtype=_F32, device=dev)
    rows = []
    it = executed = 0
    for level, (n_iters, geo_scale) in enumerate(zip(iters_per_level, geo_scales)):
        geo_s = torch.full((), geo_scale, dtype=_F32, device=dev)
        limit = it + n_iters
        lm_lambda = torch.full((), params.lm.init_lambda, dtype=_F32, device=dev)
        radius = torch.full((), params.dogleg.initial_trust_region_radius, dtype=_F32, device=dev)
        done = False
        while it < limit and not done:
            pose = state.pose()
            corr = reg_core._correspondences(factor_params, target_knn, src_pts, src_mask, pose, tgt)
            alpha = (reg_core._genz_alpha(corr) if factor_params.reg_type is RegType.GENZ
                     else torch.ones((), dtype=_F32, device=dev))
            lin = reg_core._linearize(factor_params, pose, src_pts, src_covs_reg, corr, geo_s, alpha)
            b_imu = compute_imu_gradient(predicted_state, state, H_imu)

            icp_dof = icp_residual_dim * lin.inlier.to(_F32) - 6.0
            icp_weight = torch.where(
                (icp_dof > 0.0) & torch.isfinite(lin.error) & (lin.error >= 0.0),
                1.0 / torch.clamp_min(2.0 * lin.error / torch.clamp_min(icp_dof, 1.0), 1.0),
                1.0,
            )
            H15, b15 = add_icp_factor(torch.zeros((DOF, DOF), dtype=_F32, device=dev), zero15, lin.H, lin.b,
                                      state.rotation, icp_weight)
            H15, b15 = apply_directional_icp_weighting(H15, b15, lin.inlier, params.directional_icp_weighting)
            H15 = H15 + H_extra
            b15 = torch.where(imu_valid, b15 + b_imu, b15)

            def total_cost(s: State, corr=corr, alpha=alpha, icp_weight=icp_weight):
                err, _ = reg_core._error_at(factor_params, s.pose(), src_pts, src_covs_reg, corr, geo_s, alpha)
                return icp_weight * err + imu_cost(s)

            if method == "gauss_newton":
                delta, ok = solve_psd(H15 + params.gn.lambda_ * eye15, -b15)
                delta = bias_freeze(delta)
                accepted, stop = ok, ~ok
                new_state = retract(state, delta)
                damping = torch.full((), params.gn.lambda_, dtype=_F32, device=dev)
            elif method == "levenberg_marquardt":
                # every damping candidate as one batch, the first that lowers
                # the cost taken
                p = params.lm
                cur_cost = total_cost(state)
                C = p.max_inner_iterations
                lams = torch.clamp(lm_lambda * p.lambda_factor ** torch.arange(C, dtype=_F32, device=dev),
                                   p.min_lambda, p.max_lambda)
                ds, oks = solve_psd(H15[None] + lams[:, None, None] * eye15, -b15.expand(C, DOF))
                ds = bias_freeze(ds)
                costs = total_cost(retract(state, ds))
                acc = oks & (costs <= cur_cost)
                any_acc = acc.any()
                idx = torch.argmax(acc.to(torch.int32))
                delta = torch.where(any_acc, ds[idx], zero15)
                accepted, stop = any_acc, ~any_acc
                new_state = retract(state, delta)
                lam_exhausted = torch.clamp(lm_lambda * p.lambda_factor**C, p.min_lambda, p.max_lambda)
                lm_lambda = torch.where(any_acc, torch.clamp(lams[idx] / p.lambda_factor, p.min_lambda,
                                                             p.max_lambda), lam_exhausted)
                damping = lm_lambda
            else:
                p = params.dogleg
                cur_cost = total_cost(state)
                r = torch.clamp(radius, p.min_trust_region_radius, p.max_trust_region_radius)
                step, step_norm, _ = compute_dogleg_step(H15, b15, r)
                step = bias_freeze(step)
                pred = -(torch.dot(b15, step) + 0.5 * torch.dot(step, H15 @ step))
                trial = retract(state, step)
                rho = (cur_cost - total_cost(trial)) / torch.clamp_min(pred, 1e-30)
                reject = (pred <= 0.0) | (rho < p.eta1)
                grow = (rho > p.eta2) & (step_norm >= r * 0.99)
                radius = torch.clamp(
                    torch.where(reject, r * p.gamma_decrease, torch.where(grow, r * p.gamma_increase, r)),
                    p.min_trust_region_radius, p.max_trust_region_radius)
                delta = torch.where(reject, zero15, step)
                accepted, stop = ~reject, torch.zeros((), dtype=torch.bool, device=dev)
                new_state = select(reject, state, trial)
                damping = radius

            conv = is_converged(delta)
            done_t = torch.where(accepted, conv, torch.zeros((), dtype=torch.bool, device=dev)) | stop
            state = select(accepted, new_state, state)
            H_undamped, has_H = H15, True
            last_inlier, last_error = lin.inlier, lin.error
            if trace:
                applied = torch.where(accepted, delta, zero15)
                nrm = [torch.linalg.vector_norm(applied[i : i + 3]) for i in (IDX_ROT, IDX_POS, IDX_VEL,
                                                                            IDX_GYR_BIAS, IDX_ACC_BIAS)]
                rows.append((it, torch.stack([
                    torch.full((), float(level), dtype=_F32, device=dev), lin.error.to(_F32),
                    lin.inlier.to(_F32), icp_weight.to(_F32), damping.to(_F32), *nrm,
                    accepted.to(_F32), (accepted & conv).to(_F32),
                ])))
            it += 1
            executed += 1
            done = bool(to_host(done_t))
        it = max(it, limit)

    # posterior covariance: H^-1, a damped retry, else the previous one
    if has_H:
        P1, ok1 = solve_psd(H_undamped, eye15)
        P2, ok2 = solve_psd(H_undamped + 1e-4 * eye15, eye15)
        P_post = torch.where(ok1, P1, torch.where(ok2, P2, previous_posterior_covariance))
    else:
        P_post = previous_posterior_covariance

    result = LIORegistrationResult(
        state=state, posterior_covariance=P_post, T=state.pose(),
        iterations=torch.full((), it, dtype=torch.int32, device=dev),
        inlier=last_inlier, error=last_error, executed=executed,
    )
    if not trace:
        return result
    buf = torch.full((max(params.total_iterations, 1), len(TRACE_COLS)), torch.nan, dtype=_F32, device=dev)
    if rows:  # a row sits at its iteration's index; a level that ends early leaves NaN rows
        buf[torch.tensor([i for i, _ in rows], device=dev)] = torch.stack([r for _, r in rows])
    return result, buf
