"""Core ICP registration solver: the align loop with GN, LM and dogleg.

Counterpart of :mod:`sycl_points_tpu.registration.registration`, with the
same parameter dataclasses, defaults and semantics. The JAX loop is one
``lax.while_loop``; here it is a Python loop whose tensors stay on the
device. The host reads one small tensor per iteration (the loop's
convergence test and, for LM, the first candidate's accept flag together),
plus one more when the LM candidate sweep runs; each read is counted
(:mod:`sycl_points_tpu_torch.utils.sync`).

:func:`align_streams` runs the loop for a fleet of ``B`` streams at once
(the counterpart of ``jax.vmap`` over the JAX ``align``): every tensor takes
a leading stream axis, each stream keeps its own iteration count, robust
level, LM lambda / trust radius, convergence flag and pose, and a stream that
is done keeps its carry (a vmapped ``while_loop``'s semantics). The host reads
one flag an iteration for the whole fleet ("any stream still active"), and
one more when any stream rejected LM's first candidate; the step choices the
single-stream loop makes on the host are per-stream selects on the device.

The registration options run in both loops as in the JAX package: the
rotation constraint (:mod:`.rotation_constraint`) in the linearization and
the LM / dogleg error, nl_reg (:mod:`.degenerate`) on the raw linearization
toward the call's initial guess, and the coarse-to-fine schedule, whose
first ``coarse_to_fine_iters`` iterations search every ``coarse_stride``-th
target row and cannot converge. The loop counter is a host int, so the
choice of target is made on the host and reads nothing; a coarse
Gauss-Newton iteration, which cannot end the loop, reads nothing either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from sycl_points_tpu_torch.ops.knn import BruteForceKNN
from sycl_points_tpu_torch.ops.robust import RobustLossType, compute_error, compute_weight
from sycl_points_tpu_torch.points.point_cloud import PointCloud, gather_streams
from sycl_points_tpu_torch.registration.degenerate import regularize
from sycl_points_tpu_torch.registration.factors import (
    RegType,
    genz_planarity,
    residual_norms_only,
    whitened_rows,
)
from sycl_points_tpu_torch.registration.rotation_constraint import add_rotation_constraint, rotation_constraint_error
from sycl_points_tpu_torch.utils import lie
from sycl_points_tpu_torch.utils.eigh3 import plane_regularize
from sycl_points_tpu_torch.utils.smallmat import solve_psd
from sycl_points_tpu_torch.utils.sync import to_host

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
    # The first ``coarse_to_fine_iters`` iterations in all search every
    # ``coarse_stride``-th target row and cannot converge; the later ones
    # search the full target.
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
    degenerate_reg: Optional[Any] = None  # degenerate.DegenerateRegularizationParams
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
    coarse_iterations: int = 0  # iterations that searched the coarse target (a host count)


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
    lead = tgt.points.shape[:-1]
    if tgt.covs_reg is not None:
        cols.append(tgt.covs_reg.reshape(lead + (9,)))
        layout.append(("covs_reg", 9))
    if tgt.covs_raw is not None:
        cols.append(tgt.covs_raw.reshape(lead + (9,)))
        layout.append(("covs_raw", 9))
    if tgt.normals is not None:
        cols.append(tgt.normals)
        layout.append(("normals", 3))
    if tgt.planar is not None:
        cols.append(tgt.planar.to(_F32)[..., None])
        layout.append(("planar", 1))
    if not layout:
        return tgt
    return tgt._replace(packed=torch.cat(cols, dim=-1), layout=tuple(layout))


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
    if params.rotation_constraint.enable:
        # the constraint reads the raw covariances of both clouds
        if source.covs is None or target.covs is None:
            raise ValueError("rotation constraint requires source and target covariances")
        tgt = tgt._replace(covs_raw=target.covs)
    return src_covs_reg, _pack_targets(tgt)


def _gather_correspondences(params, idx, d2, src_mask, tgt: _Targets) -> _Targets:
    """Target rows for the nearest indices, with the correspondence gate."""
    corr_mask = src_mask & (d2 <= params.max_correspondence_distance**2)
    idx = idx.long()

    def take(a):
        return a[idx] if idx.dim() == 1 else gather_streams(a, idx)

    if tgt.packed is None:
        return _Targets(take(tgt.points), corr_mask, None, None, None, None)
    flat = take(tgt.packed)
    out = {}
    col = 3
    for name, width in tgt.layout:
        block = flat[..., col : col + width]
        col += width
        if name == "planar":
            out[name] = block[..., 0] > 0.5
        elif width == 9:
            out[name] = block.reshape(block.shape[:-1] + (3, 3))
        else:
            out[name] = block
    return _Targets(
        points=flat[..., 0:3], mask=corr_mask,
        covs_reg=out.get("covs_reg"), covs_raw=out.get("covs_raw"),
        normals=out.get("normals"), planar=out.get("planar"),
    )


def _correspondences(params, knn, src_pts, src_mask, T, tgt: _Targets) -> _Targets:
    """One 1-NN search with the pose folded into the queries."""
    res = knn.search(src_pts, 1, pose=T)
    return _gather_correspondences(params, res.indices[..., 0], res.distances[..., 0], src_mask, tgt)


def _coarse_knn(params: RegistrationParams, target_knn) -> Optional[BruteForceKNN]:
    """The coarse phase's search: every ``coarse_stride``-th row of the
    unprepared target (of each stream's, for a fleet), made contiguous and
    prepared once; None when the schedule is off. Only a brute-force target
    can be strided: a ``GridKNN`` holds its points in cell order, so strided
    rows would index the sorted layout, and it is refused (JAX's constructor
    call fails on it too)."""
    if params.coarse_to_fine_iters <= 0 or not hasattr(target_knn, "points"):
        return None
    if not isinstance(target_knn, BruteForceKNN):
        raise ValueError(
            f"coarse-to-fine strides the target's rows, which only a BruteForceKNN target keeps in the "
            f"cloud's order; got {type(target_knn).__name__} (set coarse_to_fine_iters=0 to use it)")
    s = params.coarse_stride
    return BruteForceKNN(points=target_knn.points[..., ::s, :].contiguous(),
                         mask=target_knn.mask[..., ::s].contiguous()).prepped()


def _search(params, knn, knn_coarse, coarse: bool, src_pts, src_mask, T, tgt: _Targets) -> _Targets:
    """The correspondences of one iteration: on the coarse target, its
    indices multiplied back to the full target's rows, when ``coarse``."""
    if not coarse:
        return _correspondences(params, knn, src_pts, src_mask, T, tgt)
    res = knn_coarse.search(src_pts, 1, pose=T)
    return _gather_correspondences(params, res.indices[..., 0] * params.coarse_stride, res.distances[..., 0],
                                   src_mask, tgt)


def _genz_alpha(*corrs: _Targets) -> torch.Tensor:
    """Planar fraction among inliers (of all shards' correspondences, on the
    first one's device)."""
    dev = corrs[0].mask.device
    inl = _sum_on(dev, [c.mask.sum(-1) for c in corrs])
    pl = _sum_on(dev, [(c.mask & c.planar).sum(-1) for c in corrs])
    return torch.where(inl > 0, pl.to(_F32) / torch.clamp_min(inl, 1).to(_F32), 1.0)


def _sum_on(dev, parts):
    """The sum of ``parts`` (tensors or tuples of them) on ``dev``, taken in
    order; one part comes back as it is."""
    total = parts[0]
    for p in parts[1:]:
        total = tuple(a + b.to(dev) for a, b in zip(total, p)) if isinstance(total, tuple) else total + p.to(dev)
    return tuple(t.to(dev) for t in total) if isinstance(total, tuple) else total.to(dev)


class Shard(NamedTuple):
    """The part of an align's source that one device holds, with that
    device's copy of the target's search and attributes (see
    :func:`make_shard`). :func:`align` runs one shard; the sharded align
    (``parallel.sharded.sharded_align``) one a device, their partial sums
    added on the first device every iteration."""

    points: torch.Tensor
    mask: torch.Tensor
    covs: Optional[torch.Tensor]
    covs_reg: Optional[torch.Tensor]
    knn: Any
    knn_coarse: Optional[BruteForceKNN]
    tgt: _Targets

    @property
    def device(self) -> torch.device:
        return self.points.device


def make_shard(params: RegistrationParams, source: PointCloud, target: PointCloud, target_knn) -> Shard:
    """``source`` (or its part) against ``target`` on their device: the
    pose-independent target attributes and the prepared search, made once
    an align."""
    src_covs_reg, tgt = _precompute_targets(params, source, target)
    if hasattr(target_knn, "prepped"):
        target_knn = target_knn.prepped()
    return Shard(source.points, source.mask, source.covs, src_covs_reg, target_knn,
                 _coarse_knn(params, target_knn), tgt)


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
    lead = src_pts.shape[:-2]
    A = (rows.A * scale[..., None, None]).reshape(lead + (-1, 6))
    c = (rows.c * scale[..., None]).reshape(lead + (-1,))
    # H and b from one product, which gives a fleet's stream the bits of a
    # single-stream call (a matrix-vector product would not)
    Hb = A.transpose(-1, -2) @ torch.cat([A, c[..., None]], -1)
    H, b = Hb[..., :6], Hb[..., 6]
    err = (m * rows.genz_weight * compute_error(params.robust.type, rows.residual_norm, robust_scale)).sum(-1)
    return LinearizedResult(H, b, err, corr.mask.sum(-1, dtype=torch.int32))


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
    return err, corr.mask.sum(-1, dtype=torch.int32)


def _is_converged(params: RegistrationParams, delta: torch.Tensor) -> torch.Tensor:
    """Per-step convergence test; ``delta`` is ``[..., 6]``."""
    dr = torch.linalg.vector_norm(delta[..., :3], dim=-1)
    dt = torch.linalg.vector_norm(delta[..., 3:], dim=-1)
    return (dt < params.criteria.translation) & (dr < params.criteria.rotation)


# Products as broadcast sums: a fleet's stream gets the bits of a
# single-stream call (a batched matrix product may sum in another order).
def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M * v[..., None, :]).sum(-1)


def _v(x: torch.Tensor) -> torch.Tensor:
    """A per-stream (or 0-dim) value broadcast over a vector's last axis."""
    return x[..., None]


def compute_dogleg_step(H, g, radius):
    """Powell dogleg step for ``H p = -g`` inside a trust region; returns
    ``(p, step_norm, predicted_reduction)``. A fleet's ``H [B, 6, 6]``, ``g
    [B, 6]`` and ``radius [B]`` give one step a stream."""
    eps = torch.finfo(_F32).eps
    p_gn, gn_ok = solve_psd(H, -g)
    norm_gn = torch.linalg.vector_norm(p_gn, dim=-1)
    gn_ok = gn_ok & torch.isfinite(norm_gn)

    g_sq = _dot(g, g)
    gHg = _dot(g, _mv(H, g))
    alpha = torch.where(gHg > eps, g_sq / torch.clamp_min(gHg, 1e-30), 1.0)
    alpha = torch.where(torch.isfinite(alpha), alpha, 1.0)
    p_sd = -_v(alpha) * g
    norm_sd = torch.linalg.vector_norm(p_sd, dim=-1)

    diff = p_gn - p_sd
    a = _dot(diff, diff)
    bq = 2.0 * _dot(p_sd, diff)
    cq = _dot(p_sd, p_sd) - radius * radius
    disc = torch.clamp_min(bq * bq - 4.0 * a * cq, 0.0)
    tau = torch.where(a > eps, (-bq + torch.sqrt(disc)) / torch.clamp_min(2.0 * a, 1e-30), 0.0)
    p_blend = p_sd + _v(torch.clamp(tau, 0.0, 1.0)) * diff

    sd_clipped = torch.where(
        _v(norm_sd > 1e-30), _v(radius / torch.clamp_min(norm_sd, 1e-30)) * p_sd, p_sd * 0.0
    )
    p = torch.where(
        _v(gn_ok & (norm_gn <= radius)),
        p_gn,
        torch.where(
            _v(norm_sd >= radius),
            sd_clipped,
            torch.where(_v(gn_ok), p_blend, torch.where(_v(norm_sd > radius), sd_clipped, p_sd)),
        ),
    )
    pred = -(_dot(g, p) + 0.5 * _dot(p, _mv(H, p)))
    return p, torch.linalg.vector_norm(p, dim=-1), pred


class _Step(NamedTuple):
    """What one optimizer iteration decided, on the device; ``conv`` is a
    host bool where the step read it already (LM), else a device flag."""

    T: torch.Tensor
    conv: bool | torch.Tensor
    err: torch.Tensor
    inlier: torch.Tensor
    lam: torch.Tensor
    trust: torch.Tensor
    step: torch.Tensor
    accepted: torch.Tensor


def _per(flag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``[B]`` (or 0-dim) flag shaped to broadcast over ``x [B, ...]``."""
    return flag.reshape(flag.shape + (1,) * (x.dim() - flag.dim()))


def _pick(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stream by stream: ``a`` where ``flag`` holds, else ``b``."""
    return torch.where(_per(flag, a), a, b)


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
    T_c0 = lie.compose(T, lie.se3_exp(delta0))
    err0, inl0 = error_fn(T_c0)
    accept0, conv0 = to_host(torch.stack([err0 <= cur_err, _is_converged(params, delta0)]))
    if accept0:
        lam_next = torch.clamp(lams[0] / p.lambda_factor, p.min_lambda, p.max_lambda)
        return _Step(T_c0, conv0, err0, inl0, lam_next, None, delta0, _scalar(True, dev, torch.bool))

    deltas, _ = solve_psd(H[None] + lams[:, None, None] * eye6, -g.expand(C, 6))
    T_cands = lie.compose(T, lie.se3_exp(deltas))
    errs, inl = error_fn(T_cands)
    accept = errs <= cur_err
    prev_errs = torch.cat([torch.full((1,), torch.finfo(_F32).max, device=dev), errs[:-1]])
    take = accept | (torch.abs(errs - prev_errs) <= 1e-6)
    take_h, accept_h, conv_h = to_host(torch.stack([take, accept, _is_converged(params, deltas)]))
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
    """One Powell dogleg step, of one stream or of every stream of a fleet
    (its choices are selects); ``conv`` stays on the device."""
    p = params.dogleg

    def clamp(r):
        return torch.clamp(r, p.min_trust_region_radius, p.max_trust_region_radius)

    radius = clamp(trust_radius)
    step, step_norm, pred = compute_dogleg_step(H, g, radius)
    T_c = lie.compose(T, lie.se3_exp(step))
    new_err, new_inl = error_fn(T_c)
    rho = (cur_err - new_err) / torch.clamp_min(pred, 1e-30)
    reject = (pred <= 0.0) | (rho < p.eta1)
    grow = (rho > p.eta2) & (step_norm >= radius * 0.99)
    trust_next = clamp(
        torch.where(reject, radius * p.gamma_decrease, torch.where(grow, radius * p.gamma_increase, radius))
    )
    return _Step(
        T=_pick(reject, T, T_c),
        conv=(~reject) & _is_converged(params, step),
        err=torch.where(reject, cur_err, new_err),
        inlier=torch.where(reject, inlier, new_inl),
        lam=None,
        trust=trust_next,
        step=_pick(reject, torch.zeros_like(step), step),
        accepted=~reject,
    )


def _scales(params: RegistrationParams, robust_schedule, robust_scale, rotation_robust_scale):
    """The robust levels' (geometry scales, rotation-constraint scales)."""
    if robust_schedule:
        return [g for g, _ in robust_schedule], [r for _, r in robust_schedule]
    return ([params.robust.default_scale if robust_scale is None else robust_scale],
            [params.rotation_constraint.robust_scale if rotation_robust_scale is None else rotation_robust_scale])


def align(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    params: RegistrationParams = RegistrationParams(),
    initial_guess: Optional[torch.Tensor] = None,
    robust_scale: Optional[float] = None,
    rotation_robust_scale: Optional[float] = None,
    map_prior=None,
    robust_schedule: Optional[tuple] = None,
    trace: bool = False,
):
    """Run ICP from ``initial_guess`` (identity by default).

    ``map_prior`` (a ``map_prior.MapPriorState``) adds the previous frame's
    information to the normal equations of every iteration and its cost to
    the LM / dogleg error. ``robust_schedule`` (tuple of (geometry_scale,
    rotation_scale) pairs, the second the rotation constraint's) runs the
    robust-annealing chain in one loop: each level runs at most
    ``max_iterations`` from the previous level's pose with fresh optimizer
    state. Without it, ``robust_scale`` and ``rotation_robust_scale`` (the
    parameters' defaults when None) make one level. nl_reg pulls toward
    ``initial_guess``. ``trace=True`` also returns a ``[max_iterations *
    n_levels, len(TRACE_COLS)]`` per-iteration buffer (unexecuted rows NaN).
    Returns ``RegistrationResult``, or ``(result, trace)`` with ``trace``.
    """
    return align_shards([make_shard(params, source, target, target_knn)], params, initial_guess, robust_scale,
                        rotation_robust_scale, map_prior, robust_schedule, trace)


def align_shards(
    shards: list,
    params: RegistrationParams = RegistrationParams(),
    initial_guess: Optional[torch.Tensor] = None,
    robust_scale: Optional[float] = None,
    rotation_robust_scale: Optional[float] = None,
    map_prior=None,
    robust_schedule: Optional[tuple] = None,
    trace: bool = False,
):
    """:func:`align` over a source split into :class:`Shard` s, the loop's
    state on the first shard's device: each iteration, each shard searches
    and linearizes its own points on its own device, and the partial H, b,
    error and inlier counts (and the GenZ counts, and LM / dogleg's trial
    errors) are added on the first device. One shard is :func:`align`."""
    method = params.optimization_method
    if method not in ("gauss_newton", "levenberg_marquardt", "powell_dogleg"):
        raise ValueError(method)
    dev = shards[0].device
    T = (
        torch.eye(4, dtype=_F32, device=dev)
        if initial_guess is None
        else initial_guess.to(device=dev, dtype=_F32)
    )
    T_initial = T
    geo, rot = _scales(params, robust_schedule, robust_scale, rotation_robust_scale)
    geo_scales = [_scalar(g, dev) for g in geo]
    rot_scales = [_scalar(r, dev) for r in rot]
    n_levels = len(geo)
    rotc = params.rotation_constraint.enable
    has_coarse = shards[0].knn_coarse is not None

    def lin_of(sh, corr, T, alpha, r_scale, rot_s):
        T, alpha, r_scale, rot_s = (x.to(sh.device) for x in (T, alpha, r_scale, rot_s))
        lin = _linearize(params, T, sh.points, sh.covs_reg, corr, r_scale, alpha)
        if rotc:
            lin = add_rotation_constraint(params, lin, T, sh.covs, corr, rot_s)
        return lin

    def err_of(sh, corr, T_c, alpha, r_scale, rot_s):
        T_c, alpha, r_scale, rot_s = (x.to(sh.device) for x in (T_c, alpha, r_scale, rot_s))
        err, inl = _error_at(params, T_c, sh.points, sh.covs_reg, corr, r_scale, alpha)
        if rotc:
            err = err + rotation_constraint_error(params, T_c, sh.covs, corr, rot_s)
        return err, inl

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
    it = total_it = level = coarse_its = 0
    rows = []

    while total_it < params.max_iterations * n_levels:
        r_scale, rot_s = geo_scales[level], rot_scales[level]
        coarse = has_coarse and total_it < params.coarse_to_fine_iters
        coarse_its += coarse
        corrs = [_search(params, sh.knn, sh.knn_coarse, coarse, sh.points, sh.mask, T.to(sh.device), sh.tgt)
                 for sh in shards]
        alpha = _genz_alpha(*corrs) if params.reg_type is RegType.GENZ else torch.ones((), dtype=_F32, device=dev)
        lin = LinearizedResult(*_sum_on(dev, [lin_of(sh, c, T, alpha, r_scale, rot_s)
                                             for sh, c in zip(shards, corrs)]))
        H_raw, b_raw, error_raw = lin.H, lin.b, lin.error
        lin = regularize(params.degenerate_reg, lin, T, T_initial)
        if map_prior is not None:
            lin = map_prior.apply(lin, T)
        H, g, cur_err, cur_inl = lin.H, lin.b, lin.error, lin.inlier

        def error_fn(T_c, corrs=corrs, alpha=alpha, r_scale=r_scale, rot_s=rot_s):
            err, inl = _sum_on(dev, [err_of(sh, c, T_c, alpha, r_scale, rot_s) for sh, c in zip(shards, corrs)])
            if map_prior is not None:
                err = err + map_prior.prior_error(T_c)
            return err, inl

        if method == "gauss_newton":
            delta, _ = solve_psd(H + params.gn.lambda_ * eye6, -g)
            step = _Step(lie.compose(T, lie.se3_exp(delta)), _is_converged(params, delta), cur_err, cur_inl, None,
                         None, delta, _scalar(True, dev, torch.bool))
            damping = _scalar(params.gn.lambda_, dev)
        elif method == "levenberg_marquardt":
            step = _lm_step(params, T, H, g, cur_err, cur_inl, lm_lambda, error_fn)
            lm_lambda = step.lam
            damping = step.lam
        else:
            step = _dogleg_step(params, T, H, g, cur_err, cur_inl, trust, error_fn)
            trust = step.trust
            damping = step.trust
        T, error, inlier = step.T, step.err, step.inlier
        # a coarse iteration cannot converge, so its flag needs no read
        conv = False if coarse else to_host(step.conv) if isinstance(step.conv, torch.Tensor) else step.conv

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
        coarse_iterations=coarse_its,
    )
    if not trace:
        return result
    buf = torch.full((params.max_iterations * n_levels, len(TRACE_COLS)), torch.nan, dtype=_F32, device=dev)
    if rows:
        buf[: len(rows)] = torch.stack(rows)
    return result, buf


# -- the fleet's loop ---------------------------------------------------------


def _lm_step_streams(params, T, H, g, cur_err, inlier, lm_lambda, error_fn, active) -> _Step:
    """:func:`_lm_step` of every stream, its host choices made by per-stream
    selects: candidate 0 for all; the sweep of all candidates for all, but
    only when some active stream rejected candidate 0 (one host read); then
    each stream takes what its own single-stream step would take."""
    p = params.lm
    C = p.max_inner_iterations
    dev = H.device
    factors = p.lambda_factor ** torch.arange(C, dtype=_F32, device=dev)
    lams = torch.clamp(lm_lambda[:, None] * factors, p.min_lambda, p.max_lambda)  # [B, C]
    eye6 = torch.eye(6, dtype=_F32, device=dev)

    delta0, _ = solve_psd(H + lams[:, 0, None, None] * eye6, -g)
    T_c0 = lie.compose(T, lie.se3_exp(delta0))
    err0, inl0 = error_fn(T_c0)
    accept0 = err0 <= cur_err
    step0 = _Step(T_c0, _is_converged(params, delta0), err0, inl0,
                  torch.clamp(lams[:, 0] / p.lambda_factor, p.min_lambda, p.max_lambda), None, delta0,
                  torch.ones_like(accept0))
    if not to_host((active & ~accept0).any()):
        return step0

    B = H.shape[0]
    deltas, _ = solve_psd(H[:, None] + lams[..., None, None] * eye6, -g[:, None].expand(B, C, 6))
    T_cands = lie.compose(T[:, None], lie.se3_exp(deltas))
    errs, inl = error_fn(T_cands)  # [B, C], [B]
    accept = errs <= cur_err[:, None]
    prev_errs = torch.cat([torch.full((B, 1), torch.finfo(_F32).max, device=dev), errs[:, :-1]], 1)
    take = accept | (torch.abs(errs - prev_errs) <= 1e-6)
    conv = _is_converged(params, deltas)
    any_take = take.any(-1)
    i = torch.argmax(take.to(torch.int32), -1)  # the first candidate taken
    rows = torch.arange(B, device=dev)
    lam_i = lams[rows, i]
    lam_take = torch.where(accept[rows, i], torch.clamp(lam_i / p.lambda_factor, p.min_lambda, p.max_lambda),
                           lam_i)
    # an exhausted sweep keeps the pose, with the last trial's converged flag
    lam_none = torch.clamp(lm_lambda * p.lambda_factor**C, p.min_lambda, p.max_lambda)
    sweep = _Step(
        T=_pick(any_take, T_cands[rows, i], T),
        conv=torch.where(any_take, conv[rows, i], conv[:, -1]),
        err=torch.where(any_take, errs[rows, i], cur_err),
        inlier=torch.where(any_take, inl, inlier),
        lam=torch.where(any_take, lam_take, lam_none),
        trust=None,
        step=_pick(any_take, deltas[rows, i], torch.zeros_like(delta0)),
        accepted=any_take,
    )
    return _Step(*(None if a is None else _pick(accept0, a, b) for a, b in zip(step0, sweep)))


def align_streams(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    params: RegistrationParams = RegistrationParams(),
    initial_guess: Optional[torch.Tensor] = None,
    map_prior=None,
    robust_schedule: Optional[tuple] = None,
) -> RegistrationResult:
    """:func:`align` of every stream of a fleet: ``source [B, N]`` against
    ``target [B, M]`` (``target_knn`` a :class:`~..ops.knn.BruteForceKNN`
    on the ``[B, M, 3]`` targets), from ``initial_guess [B, 4, 4]``
    (identity by default), with a fleet's ``map_prior`` (``active [B]``) and
    one ``robust_schedule`` for all. Returns a ``RegistrationResult`` whose
    every field has the leading stream axis; stream ``b``'s equal what
    :func:`align` returns for it. Each iteration runs every stream still
    active through one batched ``nn1`` launch and one linearization, and
    ends in one host read of "any stream still active".

    The coarse phase is the loop's first ``coarse_to_fine_iters``
    iterations for every stream: a coarse iteration cannot converge and
    levels change by count, so no stream ends inside it except at the
    iteration budget, and every active stream has run every iteration. The
    host read of a coarse iteration asserts this at no extra cost."""
    method = params.optimization_method
    if method not in ("gauss_newton", "levenberg_marquardt", "powell_dogleg"):
        raise ValueError(method)

    dev = source.device
    B = source.points.shape[0]
    T = (torch.eye(4, dtype=_F32, device=dev).expand(B, 4, 4) if initial_guess is None
         else initial_guess.to(device=dev, dtype=_F32))
    T_initial = T
    geo, rot = _scales(params, robust_schedule, None, None)
    geo_scales = torch.tensor(geo, dtype=_F32, device=dev)
    rot_scales = torch.tensor(rot, dtype=_F32, device=dev)
    n_levels = len(geo)
    max_total = params.max_iterations * n_levels
    rotc = params.rotation_constraint.enable

    src_covs_reg, tgt = _precompute_targets(params, source, target)
    src_pts, src_mask = source.points, source.mask
    target_knn = target_knn.prepped()
    knn_coarse = _coarse_knn(params, target_knn)

    def full(value, dtype=_F32):
        return torch.full((B,), value, dtype=dtype, device=dev)

    lm_lambda = full(params.lm.init_lambda)
    trust = full(params.dogleg.initial_trust_region_radius)
    eye6 = torch.eye(6, dtype=_F32, device=dev)
    H = H_raw = torch.zeros((B, 6, 6), dtype=_F32, device=dev)
    g = b_raw = torch.zeros((B, 6), dtype=_F32, device=dev)
    error = error_raw = full(0.0)
    inlier = full(0, torch.int32)
    conv = full(False, torch.bool)
    it = full(0, torch.int64)
    total_it = full(0, torch.int64)
    level = full(0, torch.int64)
    active = full(max_total > 0, torch.bool)
    loops = 0

    while max_total > 0:
        r_scale, rot_s = geo_scales[level][:, None], rot_scales[level][:, None]
        coarse = knn_coarse is not None and loops < params.coarse_to_fine_iters
        corr = _search(params, target_knn, knn_coarse, coarse, src_pts, src_mask, T, tgt)
        alpha = (_genz_alpha(corr) if params.reg_type is RegType.GENZ else full(1.0))[:, None]
        lin = _linearize(params, T, src_pts, src_covs_reg, corr, r_scale, alpha)
        if rotc:
            lin = add_rotation_constraint(params, lin, T, source.covs, corr, rot_s)
        lin_raw = lin
        lin = regularize(params.degenerate_reg, lin, T, T_initial)
        if map_prior is not None:
            lin = map_prior.apply(lin, T)

        def error_fn(T_c, corr=corr, alpha=alpha, r_scale=r_scale, rot_s=rot_s):
            if T_c.dim() == 4:  # the LM sweep: [B, C, 4, 4] against [B, 1, N, ...]
                c = _Targets(*(None if f is None else f[:, None] for f in corr[:6]))
                err, _ = _error_at(params, T_c, src_pts[:, None], None if src_covs_reg is None
                                   else src_covs_reg[:, None], c, r_scale[:, None], alpha[:, None])
                if rotc:
                    err = err + rotation_constraint_error(params, T_c, source.covs[:, None], c, rot_s[:, None])
            else:
                err, _ = _error_at(params, T_c, src_pts, src_covs_reg, corr, r_scale, alpha)
                if rotc:
                    err = err + rotation_constraint_error(params, T_c, source.covs, corr, rot_s)
            if map_prior is not None:
                err = err + map_prior.prior_error(T_c)
            return err, corr.mask.sum(-1, dtype=torch.int32)

        if method == "gauss_newton":
            delta, _ = solve_psd(lin.H + params.gn.lambda_ * eye6, -lin.b)
            step = _Step(lie.compose(T, lie.se3_exp(delta)), _is_converged(params, delta), lin.error, lin.inlier,
                         None, None, delta, None)
        elif method == "levenberg_marquardt":
            step = _lm_step_streams(params, T, lin.H, lin.b, lin.error, lin.inlier, lm_lambda, error_fn, active)
            lm_lambda = torch.where(active, step.lam, lm_lambda)
        else:
            step = _dogleg_step(params, T, lin.H, lin.b, lin.error, lin.inlier, trust, error_fn)
            trust = torch.where(active, step.trust, trust)

        # commit the active streams; a stream that is done keeps its carry
        T = _pick(active, step.T, T)
        conv = torch.where(active, step.conv & (not coarse), conv)
        error = torch.where(active, step.err, error)
        inlier = torch.where(active, step.inlier, inlier)
        H, g = _pick(active, lin.H, H), _pick(active, lin.b, g)
        H_raw, b_raw = _pick(active, lin_raw.H, H_raw), _pick(active, lin_raw.b, b_raw)
        error_raw = torch.where(active, lin_raw.error, error_raw)

        # robust-level transitions, per stream
        it = it + active
        total_it = total_it + active
        level_end = active & (conv | (it >= params.max_iterations))
        last = level >= n_levels - 1
        advance = level_end & ~last
        level = level + advance
        it = torch.where(advance, 0, it)
        lm_lambda = torch.where(advance, params.lm.init_lambda, lm_lambda)
        trust = torch.where(advance, params.dogleg.initial_trust_region_radius, trust)
        active = active & ~(level_end & last) & (total_it < max_total)
        loops += 1
        if coarse:
            any_active, strays = to_host(torch.stack([active.any(), (active & (total_it != loops)).any()]))
            if strays:
                raise AssertionError("a stream left the coarse phase out of step with the loop")
        else:
            any_active = to_host(active.any())
        if not any_active:
            break

    return RegistrationResult(
        T=T, converged=conv, iterations=total_it.to(torch.int32),
        H=H, b=g, error=error, inlier=inlier,
        H_raw=H_raw, b_raw=b_raw, error_raw=error_raw,
        coarse_iterations=min(loops, params.coarse_to_fine_iters) if knn_coarse is not None else 0,
    )


def _linearization_inputs(params, source, target, target_knn, pose, robust_scale):
    """What one linearization at ``pose`` needs: the robust scale as a device
    scalar, the source's regularized covariances, the correspondences and the
    GenZ planar fraction. One ``nn1`` search on the prepared target."""
    dev = source.device
    r_scale = _scalar(params.robust.default_scale, dev) if robust_scale is None else robust_scale
    src_covs_reg, tgt = _precompute_targets(params, source, target)
    if hasattr(target_knn, "prepped"):
        target_knn = target_knn.prepped()
    corr = _correspondences(params, target_knn, source.points, source.mask, pose, tgt)
    alpha = _genz_alpha(corr) if params.reg_type is RegType.GENZ else torch.ones((), dtype=_F32, device=dev)
    return r_scale, src_covs_reg, corr, alpha


def compute_linearized_result(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    pose: torch.Tensor,
    params: RegistrationParams = RegistrationParams(),
    initial_pose: Optional[torch.Tensor] = None,
    robust_scale=None,
) -> LinearizedResult:
    """One correspondence search and linearization at ``pose``, with nl_reg
    toward ``initial_pose`` when both are given."""
    r_scale, src_covs_reg, corr, alpha = _linearization_inputs(
        params, source, target, target_knn, pose, robust_scale)
    lin = _linearize(params, pose, source.points, src_covs_reg, corr, r_scale, alpha)
    if initial_pose is not None:
        lin = regularize(params.degenerate_reg, lin, pose, initial_pose)
    return lin


def compute_icp_robust_weights(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    pose: torch.Tensor,
    params: RegistrationParams = RegistrationParams(),
    robust_scale=None,
) -> torch.Tensor:
    """Per-source-point robust weights at ``pose``, zero outside the
    correspondence gate; the weights of the submap's mixed sampling."""
    r_scale, src_covs_reg, corr, alpha = _linearization_inputs(
        params, source, target, target_knn, pose, robust_scale)
    rn, _ = residual_norms_only(
        params.reg_type, pose, source.points, corr.points,
        src_covs_reg=src_covs_reg, tgt_covs_reg=corr.covs_reg,
        tgt_covs_raw=corr.covs_raw, tgt_normals=corr.normals,
        genz_planar=corr.planar, genz_alpha=alpha,
    )
    w = compute_weight(params.robust.type, rn, r_scale)
    return torch.where(corr.mask, w, 0.0)
