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

:func:`align_streams` solves B streams at once (the fleet's ``vmap``): one
batched ``nn1`` launch and one host read ("any stream still active") an
iteration, every choice a per-stream select, a stream that is done holding
its state. :func:`align` is it with one stream, so that a cloud alone and
the same cloud as a fleet's stream give the same bits.

The registration options apply as in the JAX package: the rotation
constraint joins the ICP linearization at each level's rotation scale, and
nl_reg pulls the ICP system toward the predicted pose. The coarse-to-fine
schedule (``coarse_to_fine_iters``) is not a branch of the LIO solve: every
iteration searches the full target, as in JAX.
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
from sycl_points_tpu_torch.points.point_cloud import PointCloud, unflatten_streams
from sycl_points_tpu_torch.registration import registration as reg_core
from sycl_points_tpu_torch.registration.degenerate import regularize
from sycl_points_tpu_torch.registration.factors import RegType
from sycl_points_tpu_torch.registration.registration import (
    CriteriaParams,
    DoglegParams,
    GaussNewtonParams,
    LevenbergMarquardtParams,
    RegistrationParams,
    compute_dogleg_step,
)
from sycl_points_tpu_torch.registration.rotation_constraint import add_rotation_constraint
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
    """One cloud's solve, or a fleet's with a leading ``[B]`` on every tensor."""

    state: State
    posterior_covariance: torch.Tensor  # [15, 15]
    T: torch.Tensor  # [4, 4]
    iterations: torch.Tensor  # the schedule's iteration budget, as in the JAX package
    inlier: torch.Tensor
    error: torch.Tensor
    # iterations that ran: a host int for one cloud; a fleet's [B] device
    # tensor, one count a stream
    executed: int | torch.Tensor = 0
    loops: int = 0  # iterations of the loop, each one host read (a fleet's slowest stream)


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
    """A copy of ``M [..., n, n]`` with ``{(row slice, col slice): value}``
    written, the values broadcast over the leading axes."""
    lead = torch.broadcast_shapes(M.shape[:-2], *(v.shape[:-2] for v in blocks.values()))
    M = M.expand(lead + M.shape[-2:]).clone()
    for (r, c), v in blocks.items():
        M[..., r, c] = v
    return M


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M v`` over leading axes, as a product with a one-column matrix."""
    return (M @ v[..., None])[..., 0]


def add_icp_factor(H15, b15, icp_H, icp_b, R_world_lidar, weight):
    """Embed the 6x6 ICP system (twist order [rot, trans]) into the 15-D
    error state; every input may carry leading stream axes."""
    R = R_world_lidar
    Rt = R.transpose(-1, -2)
    w = weight[..., None, None]
    H = _set_blocks(H15, {
        (_ROT, _ROT): H15[..., _ROT, _ROT] + w * icp_H[..., 0:3, 0:3],
        (_POS, _POS): H15[..., _POS, _POS] + w * (R @ icp_H[..., 3:6, 3:6] @ Rt),
        (_POS, _ROT): H15[..., _POS, _ROT] + w * (R @ icp_H[..., 3:6, 0:3]),
        (_ROT, _POS): H15[..., _ROT, _POS] + w * (icp_H[..., 0:3, 3:6] @ Rt),
    })
    b = b15.expand(H.shape[:-1]).clone()
    b[..., _ROT] = b15[..., _ROT] + weight[..., None] * icp_b[..., 0:3]
    b[..., _POS] = b15[..., _POS] + weight[..., None] * _mv(R, icp_b[..., 3:6])
    return H, b


def _block_filters(H_blocks, min_eig_per_inlier, weak_scale, inlier_f):
    """sqrt-scaled eigen filters of 3x3 information blocks ``[..., G, 3, 3]``,
    one ``eigh3`` for all of them; ``min_eig_per_inlier`` and ``weak_scale``
    hold one value a block, ``inlier_f`` one a stream ``[...]``."""
    dev = H_blocks.device
    lam, V = eigh3(0.5 * (H_blocks + H_blocks.transpose(-1, -2)))
    lam = torch.clamp_min(lam, 0.0)
    min_info = torch.stack([torch.full((), max(m, 0.0), dtype=_F32, device=dev) for m in min_eig_per_inlier])
    min_info = (min_info * inlier_f[..., None])[..., None]
    ws = torch.stack([torch.full((), min(max(w, 0.0), 1.0), dtype=_F32, device=dev) for w in weak_scale])
    ratio = torch.clamp(lam / torch.clamp_min(min_info, 1e-30), 0.0, 1.0)
    scale = torch.where(lam <= 0.0, 0.0, torch.maximum(ratio, ws[:, None]))
    scale = torch.where(min_info > 0.0, scale, torch.where(lam <= 0.0, 0.0, 1.0))
    return (V * torch.sqrt(torch.clamp(scale, 0.0, 1.0))[..., None, :]) @ V.transpose(-1, -2)


def apply_directional_icp_weighting(H15, b15, inlier, params: DirectionalIcpWeightingParams):
    """Attenuate weak pose directions of the ICP-only factor (leading stream
    axes allowed)."""
    if not params.enable:
        return H15, b15
    Hp = torch.cat([
        torch.cat([H15[..., _POS, _POS], H15[..., _POS, _ROT]], -1),
        torch.cat([H15[..., _ROT, _POS], H15[..., _ROT, _ROT]], -1),
    ], -2)
    Hp = 0.5 * (Hp + Hp.transpose(-1, -2))
    bp = torch.cat([b15[..., _POS], b15[..., _ROT]], -1)
    f = _block_filters(
        torch.stack([Hp[..., 0:3, 0:3], Hp[..., 3:6, 3:6]], -3),
        (params.trans_min_eigenvalue_per_inlier, params.rot_min_eigenvalue_per_inlier),
        (params.trans_weak_direction_scale, params.rot_weak_direction_scale), inlier.to(_F32))
    z = torch.zeros_like(f[..., 0, :, :])
    F = torch.cat([torch.cat([f[..., 0, :, :], z], -1), torch.cat([z, f[..., 1, :, :]], -1)], -2)
    active = (inlier > 0)[..., None, None]
    Hf = torch.where(active, F @ Hp @ F, Hp)
    bf = torch.where(active[..., 0], _mv(F, _mv(F, bp)), bp)
    H = _set_blocks(H15, {(_POS, _POS): Hf[..., 0:3, 0:3], (_POS, _ROT): Hf[..., 0:3, 3:6],
                          (_ROT, _POS): Hf[..., 3:6, 0:3], (_ROT, _ROT): Hf[..., 3:6, 3:6]})
    b = b15.expand(H.shape[:-1]).clone()
    b[..., _POS] = bf[..., 0:3]
    b[..., _ROT] = bf[..., 3:6]
    return H, b


def imu_to_lidar_jacobian(T_imu_to_lidar, R_world_lidar):
    """delta_x_lidar = J delta_x_imu (``R_world_lidar`` may carry leading
    stream axes)."""
    R_li = T_imu_to_lidar[:3, :3]
    t_lidar_in_imu = lie.transform_inverse(T_imu_to_lidar)[:3, 3]
    R_world_imu = lie.compose(R_world_lidar, R_li)
    return _set_blocks(torch.eye(DOF, dtype=_F32, device=R_li.device), {
        (_ROT, _ROT): R_li, (_POS, _ROT): -lie.compose(R_world_imu, lie.skew(t_lidar_in_imu))})


def transform_covariance_imu_to_lidar(P_imu, T_imu_to_lidar, R_world_lidar):
    J = imu_to_lidar_jacobian(T_imu_to_lidar, R_world_lidar)
    return J @ P_imu @ J.transpose(-1, -2)


def transform_covariance_lidar_to_imu(P_lidar, T_imu_to_lidar, R_world_lidar):
    """Through the analytic block inverse of the Jacobian."""
    R_li = T_imu_to_lidar[:3, :3]
    t_lidar_in_imu = lie.transform_inverse(T_imu_to_lidar)[:3, 3]
    R_world_imu = lie.compose(R_world_lidar, R_li)
    Jinv = _set_blocks(torch.eye(DOF, dtype=_F32, device=R_li.device), {
        (_ROT, _ROT): R_li.T,
        (_POS, _ROT): lie.compose(lie.compose(R_world_imu, lie.skew(t_lidar_in_imu)), R_li.T)})
    return Jinv @ P_lidar @ Jinv.transpose(-1, -2)


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


class OneStreamKNN:
    """A single target's k-NN searched as a one-stream fleet's: the search
    drops the stream axis, so that one cloud runs the single-target kernel."""

    def __init__(self, knn):
        self.knn = knn.prepped() if hasattr(knn, "prepped") else knn

    def prepped(self) -> "OneStreamKNN":
        return self

    def search(self, query_points, k, pose=None):
        r = self.knn.search(query_points[0], k, None if pose is None else pose[0])
        return type(r)(r.indices[None], r.distances[None])


def _one(t):
    return t[None]


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
    """The 15-DOF LIO solve from ``predicted_state``: :func:`align_streams`
    with one stream, so that a cloud alone and the same cloud as a fleet's
    stream give the same bits.

    ``trace=True`` also returns a ``[total_iterations, len(TRACE_COLS)]``
    per-iteration buffer (NaN rows = not executed): ``(result, trace)``.
    """
    out = align_streams(
        unflatten_streams(source, 1), unflatten_streams(target, 1), OneStreamKNN(target_knn),
        State(*(_one(f) for f in predicted_state)), _one(predicted_covariance), _one(previous_posterior_covariance),
        factor_params=factor_params, params=params, update_bias=update_bias, trace=trace)
    result, buf = out if trace else (out, None)
    result = LIORegistrationResult(
        state=State(*(f[0] for f in result.state)), posterior_covariance=result.posterior_covariance[0],
        T=result.T[0], iterations=result.iterations[0], inlier=result.inlier[0], error=result.error[0],
        executed=result.loops, loops=result.loops)
    return (result, buf[0]) if trace else result


def _check_supported(params: LIORegistrationParams) -> None:
    if params.optimization_method not in ("gauss_newton", "levenberg_marquardt", "powell_dogleg"):
        raise ValueError(params.optimization_method)


def align_streams(
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
    """The 15-DOF LIO solve of every stream of a fleet: ``source [B, N]``
    against ``target [B, M]`` (``target_knn`` on the ``[B, M, 3]`` targets)
    from ``predicted_state`` (fields ``[B, ...]``) with ``predicted_covariance``
    and ``previous_posterior_covariance`` ``[B, 15, 15]``; ``update_bias`` one
    flag or one a stream ``[B]``.

    Each iteration runs every stream still active through one batched
    ``nn1`` launch and one linearization; GN, LM and dogleg take their
    choices stream by stream with selects, a stream that is done keeps its
    state, and the iteration ends in one host read of "any stream still
    active". Stream ``b``'s fields equal what a single cloud's solve gives
    for it; ``executed`` counts each stream's iterations ``[B]``, ``loops``
    the loop's. ``trace=True`` also returns ``[B, total_iterations,
    len(TRACE_COLS)]`` (NaN rows = not executed).
    """
    _check_supported(params)
    method = params.optimization_method
    dev = source.device
    B = source.points.shape[0]
    eye15 = torch.eye(DOF, dtype=_F32, device=dev)
    zero15 = torch.zeros((B, DOF), dtype=_F32, device=dev)
    pred_state, P_pred, P_prev = predicted_state, predicted_covariance, previous_posterior_covariance
    H_imu, _, imu_valid = compute_imu_hessian_gradient(pred_state, pred_state, P_pred)
    initial_pose = pred_state.pose()
    icp_residual_dim = 1.0 if factor_params.reg_type in (RegType.POINT_TO_PLANE, RegType.GENZ) else 3.0

    src_covs_reg, tgt = reg_core._precompute_targets(factor_params, source, target)
    src_pts, src_mask = source.points, source.mask
    target_knn = target_knn.prepped()

    def full(value, dtype=_F32):
        return torch.full((B,), value, dtype=dtype, device=dev)

    bias_cols = torch.zeros(DOF, dtype=torch.bool, device=dev)
    bias_cols[IDX_ACC_BIAS : IDX_ACC_BIAS + 3] = True
    bias_cols[IDX_GYR_BIAS : IDX_GYR_BIAS + 3] = True
    bias_keep = ~bias_cols | torch.as_tensor(update_bias, dtype=torch.bool, device=dev).expand(B)[:, None]
    reg_diag = torch.zeros(DOF, dtype=_F32, device=dev)
    for idx in (IDX_VEL, IDX_ACC_BIAS, IDX_GYR_BIAS):
        reg_diag[idx : idx + 3] = params.invalid_regularization_factor
    H_extra = torch.where(imu_valid[:, None, None], H_imu, torch.diag(reg_diag))

    def lead(x, like):  # a [B, ...] value over the LM candidates [B, C, ...]
        return x.reshape(x.shape[:1] + (1,) * (like.dim() - x.dim()) + x.shape[1:])

    def imu_cost(state: State, cand: bool = False):
        r = compute_manifold_residual(pred_state if not cand else State(*(f[:, None] for f in pred_state)), state)
        H = H_imu[:, None] if cand else H_imu
        valid = imu_valid[:, None] if cand else imu_valid
        return torch.where(valid, 0.5 * (r * (H * r[..., None, :]).sum(-1)).sum(-1), 0.0)

    def bias_freeze(delta):
        return torch.where(lead(bias_keep, delta), delta, 0.0)

    def is_converged(delta):
        return ((torch.linalg.vector_norm(delta[..., _ROT], dim=-1) < params.criteria.rotation)
                & (torch.linalg.vector_norm(delta[..., _POS], dim=-1) < params.criteria.translation))

    iters_per_level, geo_scales, rot_scales = _level_schedule(params, factor_params)
    n_levels = len(iters_per_level)
    level_iters = torch.tensor(iters_per_level, dtype=torch.int64, device=dev)
    level_start = torch.tensor([sum(iters_per_level[:i]) for i in range(n_levels)], dtype=torch.int64, device=dev)
    geo_t = torch.tensor(geo_scales, dtype=_F32, device=dev)
    rot_t = torch.tensor(rot_scales, dtype=_F32, device=dev)
    budget = sum(iters_per_level)

    state = pred_state
    H_undamped = torch.zeros((B, DOF, DOF), dtype=_F32, device=dev)
    has_H = full(False, torch.bool)
    last_inlier = full(0, torch.int32)
    last_error = full(0.0)
    lm_lambda = full(params.lm.init_lambda)
    radius = full(params.dogleg.initial_trust_region_radius)
    level = full(0, torch.int64)
    in_level = full(0, torch.int64)
    executed = full(0, torch.int32)
    active = full(budget > 0, torch.bool)
    rows = []
    loops = 0
    while budget > 0:
        lvl = torch.clamp_max(level, n_levels - 1)
        geo_s = geo_t[lvl][:, None]
        pose = state.pose()
        corr = reg_core._correspondences(factor_params, target_knn, src_pts, src_mask, pose, tgt)
        alpha = (reg_core._genz_alpha(corr) if factor_params.reg_type is RegType.GENZ else full(1.0))[:, None]
        lin = reg_core._linearize(factor_params, pose, src_pts, src_covs_reg, corr, geo_s, alpha)
        if factor_params.rotation_constraint.enable:
            lin = add_rotation_constraint(factor_params, lin, pose, source.covs, corr, rot_t[lvl][:, None])
        lin = regularize(factor_params.degenerate_reg, lin, pose, initial_pose)
        b_imu = compute_imu_gradient(pred_state, state, H_imu)

        icp_dof = icp_residual_dim * lin.inlier.to(_F32) - 6.0
        icp_weight = torch.where(
            (icp_dof > 0.0) & torch.isfinite(lin.error) & (lin.error >= 0.0),
            1.0 / torch.clamp_min(2.0 * lin.error / torch.clamp_min(icp_dof, 1.0), 1.0),
            1.0,
        )
        H15, b15 = add_icp_factor(torch.zeros((B, DOF, DOF), dtype=_F32, device=dev), zero15, lin.H, lin.b,
                                  state.rotation, icp_weight)
        H15, b15 = apply_directional_icp_weighting(H15, b15, lin.inlier, params.directional_icp_weighting)
        H15 = H15 + H_extra
        b15 = torch.where(imu_valid[:, None], b15 + b_imu, b15)

        def total_cost(s: State, cand: bool = False, corr=corr, alpha=alpha, icp_weight=icp_weight, geo_s=geo_s):
            if cand:  # the LM candidates: [B, C] poses against [B, 1, N, ...] correspondences
                c = reg_core._Targets(*(None if f is None else f[:, None] for f in corr[:6]))
                err, _ = reg_core._error_at(factor_params, s.pose(), src_pts[:, None],
                                            None if src_covs_reg is None else src_covs_reg[:, None], c,
                                            geo_s[:, None], alpha[:, None])
                return icp_weight[:, None] * err + imu_cost(s, cand=True)
            err, _ = reg_core._error_at(factor_params, s.pose(), src_pts, src_covs_reg, corr, geo_s, alpha)
            return icp_weight * err + imu_cost(s)

        lm_next, radius_next = lm_lambda, radius
        if method == "gauss_newton":
            delta, ok = solve_psd(H15 + params.gn.lambda_ * eye15, -b15)
            delta = bias_freeze(delta)
            accepted, stop = ok, ~ok
            new_state = retract(state, delta)
            damping = full(params.gn.lambda_)
        elif method == "levenberg_marquardt":
            # every damping candidate as one batch, the first that lowers
            # the cost taken, stream by stream
            p = params.lm
            cur_cost = total_cost(state)
            C = p.max_inner_iterations
            lams = torch.clamp(lm_lambda[:, None] * p.lambda_factor ** torch.arange(C, dtype=_F32, device=dev),
                               p.min_lambda, p.max_lambda)  # [B, C]
            ds, oks = solve_psd(H15[:, None] + lams[..., None, None] * eye15, -b15[:, None].expand(B, C, DOF))
            ds = bias_freeze(ds)
            costs = total_cost(retract(State(*(f[:, None] for f in state)), ds), cand=True)
            acc = oks & (costs <= cur_cost[:, None])
            any_acc = acc.any(-1)
            idx = torch.argmax(acc.to(torch.int32), -1)
            rows_b = torch.arange(B, device=dev)
            delta = torch.where(any_acc[:, None], ds[rows_b, idx], zero15)
            accepted, stop = any_acc, ~any_acc
            new_state = retract(state, delta)
            lam_exhausted = torch.clamp(lm_lambda * p.lambda_factor**C, p.min_lambda, p.max_lambda)
            lm_next = torch.where(any_acc, torch.clamp(lams[rows_b, idx] / p.lambda_factor, p.min_lambda,
                                                       p.max_lambda), lam_exhausted)
            damping = lm_next
        else:
            p = params.dogleg
            cur_cost = total_cost(state)
            r = torch.clamp(radius, p.min_trust_region_radius, p.max_trust_region_radius)
            step, step_norm, _ = compute_dogleg_step(H15, b15, r)
            step = bias_freeze(step)
            pred = -((b15 * step).sum(-1) + 0.5 * (step * _mv(H15, step)).sum(-1))
            trial = retract(state, step)
            rho = (cur_cost - total_cost(trial)) / torch.clamp_min(pred, 1e-30)
            reject = (pred <= 0.0) | (rho < p.eta1)
            grow = (rho > p.eta2) & (step_norm >= r * 0.99)
            radius_next = torch.clamp(
                torch.where(reject, r * p.gamma_decrease, torch.where(grow, r * p.gamma_increase, r)),
                p.min_trust_region_radius, p.max_trust_region_radius)
            delta = torch.where(reject[:, None], zero15, step)
            accepted, stop = ~reject, full(False, torch.bool)
            new_state = select(reject, state, trial)
            damping = radius_next

        # commit the active streams; a stream that is done keeps its state
        conv = is_converged(delta)
        done = (accepted & conv) | stop
        state = select(active & accepted, new_state, state)
        H_undamped = torch.where(active[:, None, None], H15, H_undamped)
        has_H = has_H | active
        last_inlier = torch.where(active, lin.inlier, last_inlier)
        last_error = torch.where(active, lin.error, last_error)
        lm_lambda = torch.where(active, lm_next, lm_lambda)
        radius = torch.where(active, radius_next, radius)
        if trace:
            applied = torch.where(accepted[:, None], delta, zero15)
            nrm = [torch.linalg.vector_norm(applied[:, i : i + 3], dim=-1)
                   for i in (IDX_ROT, IDX_POS, IDX_VEL, IDX_GYR_BIAS, IDX_ACC_BIAS)]
            rows.append((level_start[lvl] + in_level, active, torch.stack([
                lvl.to(_F32), lin.error.to(_F32), lin.inlier.to(_F32), icp_weight.to(_F32), damping.to(_F32),
                *nrm, accepted.to(_F32), (accepted & conv).to(_F32),
            ], -1)))

        # robust-level transitions, stream by stream; a new level starts
        # with fresh optimizer state
        executed = executed + active.to(torch.int32)
        in_level = in_level + active.to(torch.int64)
        level_end = active & (done | (in_level >= level_iters[lvl]))
        level = level + level_end.to(torch.int64)
        in_level = torch.where(level_end, 0, in_level)
        lm_lambda = torch.where(level_end, params.lm.init_lambda, lm_lambda)
        radius = torch.where(level_end, params.dogleg.initial_trust_region_radius, radius)
        active = level < n_levels
        loops += 1
        if not to_host(active.any()):
            break

    # posterior covariance: H^-1, a damped retry, else the previous one
    eye_b = eye15.expand(B, DOF, DOF)
    P1, ok1 = solve_psd(H_undamped, eye_b)
    P2, ok2 = solve_psd(H_undamped + 1e-4 * eye15, eye_b)
    P_post = torch.where((has_H & ok1)[:, None, None], P1,
                         torch.where((has_H & ok2)[:, None, None], P2, P_prev))

    result = LIORegistrationResult(
        state=state, posterior_covariance=P_post, T=state.pose(),
        iterations=full(budget, torch.int32), inlier=last_inlier, error=last_error,
        executed=executed, loops=loops,
    )
    if not trace:
        return result
    buf = torch.full((B, max(params.total_iterations, 1), len(TRACE_COLS)), torch.nan, dtype=_F32, device=dev)
    rows_b = torch.arange(B, device=dev)
    for at, on, row in rows:  # a row sits at its iteration's index; a level that ends early leaves NaN rows
        buf[rows_b, at] = torch.where(on[:, None], row, buf[rows_b, at])
    return result, buf
