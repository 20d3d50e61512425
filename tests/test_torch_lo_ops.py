"""The ops, registration helpers and host-side pieces that the LiDAR-odometry
frame adds to the port, against the JAX package on the CPU.

Tolerances:

  * ``voxel_coords_counted`` and ``sort_by_cell``: equal (integers and
    masks);
  * ``weighted_sampling`` / ``mixed_sampling`` fed JAX's own Gumbel noise: the
    taken indices (as points) and masks equal;
  * ``estimate_covariances_robust``: rtol=1e-4, atol=1e-6 on the
    neighbourhoods of a uniform 3-D blob (a 3x3 inverse and weighted sums in
    float32, taken in another order). On a LiDAR scan the neighbourhoods are
    planar: the inverse of a covariance whose eigenvalues span 1e4 turns a
    1-ulp difference of its input into 1e-3 of the Mahalanobis distance and
    so of the weights; there every covariance agrees within 5e-3 of its
    largest entry;
  * ``angle_incidence_filter``: masks equal away from the threshold (points
    whose |cos| lies within 1e-5 of a bound are left out of the comparison);
  * ``compute_icp_robust_weights``: rtol=1e-4, atol=1e-5 point to plane;
    atol=2e-3 for GICP, whose plane-regularised covariances (eigenvalues 1,
    1, 1e-3) make the Mahalanobis residual that ill-conditioned (the weights
    lie in [0, 1]); ``compute_linearized_result``: H within 1e-4 and b (a
    sum of signed terms that cancel) within 5e-3 of their largest entry;
  * ``map_prior.update`` / ``apply`` / ``prior_error``: rtol=1e-4 relative to
    the largest entry; ``align`` with the prior on, GN and LM: every entry
    of the final pose within 1e-4;
  * ``lie_np`` and ``motion_predictor`` (own copies): within 1e-6;
  * ``params_from_reference`` on a full ``LidarOdometryParams`` tree: every
    field equal; ``load_params`` on YAML text: the same values as the JAX
    loader's.
"""

import dataclasses
import enum
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both, clouds, np_, rigid, spd

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
from synthetic_velodyne import World, figure8_trajectory, scan_at  # noqa: E402

from sycl_points_tpu.ops import covariance as j_cov  # noqa: E402
from sycl_points_tpu.ops import filters as j_filters  # noqa: E402
from sycl_points_tpu.ops import sampling as j_sampling  # noqa: E402
from sycl_points_tpu.ops import voxel as j_voxel  # noqa: E402
from sycl_points_tpu.ops.knn import BruteForceKNN as JBruteForceKNN, approx_knn  # noqa: E402
from sycl_points_tpu.ops.robust import RobustLossType as JLoss  # noqa: E402
from sycl_points_tpu.pipeline import motion_predictor as j_mp  # noqa: E402
from sycl_points_tpu.pipeline import params as j_params  # noqa: E402
from sycl_points_tpu.registration import degenerate as j_degen  # noqa: E402
from sycl_points_tpu.registration import map_prior as j_prior  # noqa: E402
from sycl_points_tpu.registration import registration as j_reg  # noqa: E402
from sycl_points_tpu.registration.factors import RegType as JRegType  # noqa: E402
from sycl_points_tpu.utils import lie_np as j_lie_np  # noqa: E402
from sycl_points_tpu_torch.convert import cloud_from_numpy, params_from_reference  # noqa: E402
from sycl_points_tpu_torch.ops import covariance as t_cov  # noqa: E402
from sycl_points_tpu_torch.ops import filters as t_filters  # noqa: E402
from sycl_points_tpu_torch.ops import sampling as t_sampling  # noqa: E402
from sycl_points_tpu_torch.ops import voxel as t_voxel  # noqa: E402
from sycl_points_tpu_torch.ops.knn import BruteForceKNN as TBruteForceKNN, KNNResult as TKNNResult  # noqa: E402
from sycl_points_tpu_torch.ops.robust import RobustLossType as TLoss  # noqa: E402
from sycl_points_tpu_torch.pipeline import motion_predictor as t_mp  # noqa: E402
from sycl_points_tpu_torch.pipeline import params as t_params  # noqa: E402
from sycl_points_tpu_torch.registration import map_prior as t_prior  # noqa: E402
from sycl_points_tpu_torch.registration import registration as t_reg  # noqa: E402
from sycl_points_tpu_torch.utils import lie_np as t_lie_np  # noqa: E402


def _close_rel(b, a, rtol=1e-4):
    """``b`` equals ``a`` within ``rtol`` of ``a``'s largest entry."""
    a, b = np_(a), np_(b)
    np.testing.assert_allclose(b, a, rtol=0, atol=rtol * max(float(np.abs(a).max()), 1e-12))


# --------------------------------------------------------------------------
# voxel keys
# --------------------------------------------------------------------------


def _points_with_outliers(rng, n=600):
    pts = rng.uniform(-30, 30, size=(n, 3)).astype(np.float32)
    pts[3] = np.nan
    pts[4, 1] = np.inf
    pts[5] = 3e6  # beyond the 21-bit range at 1 m voxels
    pts[6] = [2000.0, 0.0, 0.0]  # in range, beyond the sort key's 1024-cell extent
    valid = np.ones(n, bool)
    valid[::11] = False
    return pts, valid


@pytest.mark.parametrize("voxel_size", [0.25, 1.0])
def test_voxel_coords_counted_and_sort_by_cell(voxel_size):
    pts, valid = _points_with_outliers(np.random.default_rng(0))
    (jp, tp), (jv, tv) = both(pts), both(valid)
    jc, jok, jlost = j_voxel.voxel_coords_counted(jp, jv, voxel_size)
    tc, tok, tlost = t_voxel.voxel_coords_counted(tp, tv, voxel_size)
    np.testing.assert_array_equal(np_(tok), np_(jok))
    np.testing.assert_array_equal(np_(tc), np_(jc))
    assert int(tlost) == int(jlost) == 1
    tc2, tok2 = t_voxel.voxel_coords(tp, tv, voxel_size)
    assert torch.equal(tc2, tc) and torch.equal(tok2, tok)

    j_out = j_voxel.sort_by_cell(jc, jok)
    t_out = t_voxel.sort_by_cell(tc, tok)
    names = ("order", "coords_sorted", "ok_sorted", "seg_id", "new_seg", "n_extent_lost")
    n_ok = int(np_(j_out[2]).sum())
    for name, a, b in zip(names, j_out, t_out):
        a, b = np_(a), np_(b)
        if name == "order":  # the invalid tail shares one key: its order is free
            a, b = a[:n_ok], b[:n_ok]
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert int(t_out[5]) == 1


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------


def _sampling_cloud(rng, n=500, cap=512):
    pts = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    jc, tc = clouds(pts, capacity=cap, intensities=rng.uniform(0, 1, n).astype(np.float32))
    w = rng.uniform(0.0, 2.0, size=cap).astype(np.float32)
    w[::5] = 0.0
    w[7] = np.nan
    w[9] = -1.0
    return jc, tc, w


def _assert_same_sample(js, ts):
    jm, tm = np_(js.mask), np_(ts.mask)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(np_(ts.points)[tm], np_(js.points)[jm])
    np.testing.assert_array_equal(np_(ts.intensities)[tm], np_(js.intensities)[jm])


@pytest.mark.parametrize("num", [64, 400, 512])
def test_weighted_sampling_on_shared_noise(num):
    """400 asks for more than the 397 points of positive weight."""
    jc, tc, w = _sampling_cloud(np.random.default_rng(1))
    key = jax.random.key(3)
    noise = np.asarray(jax.random.gumbel(key, (jc.capacity,)))
    js = j_sampling.weighted_sampling(jc, num, both(w)[0], key)
    ts = t_sampling.weighted_sampling(tc, num, both(w)[1], noise=both(noise)[1])
    _assert_same_sample(js, ts)
    if num < 512:
        assert int(ts.count()) == min(num, int(((w > 0) & np.isfinite(w))[:500].sum()))
    else:
        assert ts is tc


@pytest.mark.parametrize("num,ratio", [(100, 0.8), (100, 0.0), (100, 1.0), (480, 0.8)])
def test_mixed_sampling_on_shared_noise(num, ratio):
    jc, tc, w = _sampling_cloud(np.random.default_rng(2))
    key = jax.random.key(5)
    k1, k2 = jax.random.split(key)
    noise = tuple(both(np.asarray(jax.random.gumbel(k, (jc.capacity,))))[1] for k in (k1, k2))
    js = j_sampling.mixed_sampling(jc, num, both(w)[0], key, ratio)
    ts = t_sampling.mixed_sampling(tc, num, both(w)[1], weighted_ratio=ratio, noise=noise)
    _assert_same_sample(js, ts)
    # no point is taken twice
    taken = np_(ts.points)[np_(ts.mask)]
    assert len(np.unique(taken, axis=0)) == len(taken)


def test_samplers_draw_from_their_generator():
    _, tc, w = _sampling_cloud(np.random.default_rng(3))
    g = lambda: torch.Generator().manual_seed(7)
    a = t_sampling.mixed_sampling(tc, 100, torch.from_numpy(w), g())
    b = t_sampling.mixed_sampling(tc, 100, torch.from_numpy(w), g())
    c = t_sampling.weighted_sampling(tc, 100, torch.from_numpy(w), g())
    assert torch.equal(a.points, b.points) and int(a.count()) == int(c.count()) == 100
    ok = (w > 0) & np.isfinite(w)
    assert set(map(tuple, np_(c.points))) <= set(map(tuple, np_(tc.points)[ok]))


# --------------------------------------------------------------------------
# robust covariances, angle filter
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scan():
    """A voxelised 256 x 24 synthetic scan with its k=10 neighbours (from
    JAX), in both packages."""
    world = World()
    pose = figure8_trajectory(1)[0]
    jc, _ = clouds(scan_at(world, pose, n_az=256, n_rings=24))
    jc = j_voxel.voxel_downsample(j_filters.box_filter(jc, 0.5, 50.0), 0.5, out_capacity=2048)
    knn = approx_knn(jc.points, jc.mask, jc.points, 10)
    tc = cloud_from_numpy(jc.to_numpy(compacted=False), device="cpu").replace(mask=both(np_(jc.mask))[1])
    tknn = TKNNResult(both(np_(knn.indices))[1], both(np_(knn.distances))[1])
    return jc, knn, tc, tknn


@pytest.mark.parametrize("loss,mad,floor,iters", [
    ("GEMAN_MCCLURE", 1.0, 5.0, 1),  # the pipeline's defaults
    ("CAUCHY", 1.4826, 1e-4, 3),  # the function's defaults: the median sets the scale
    ("HUBER", 1.0, 0.5, 2),
    ("NONE", 1.0, 1.0, 1),
])
def test_estimate_covariances_robust(scan, loss, mad, floor, iters):
    jc, knn, tc, tknn = scan
    jcov = j_cov.estimate_covariances_robust(jc.points, knn, JLoss[loss], mad, floor, iters)
    tcov = t_cov.estimate_covariances_robust(tc.points, tknn, TLoss[loss], mad, floor, iters)
    m = np_(jc.mask)
    scale = np.abs(np_(jcov)[m]).max(axis=(1, 2), keepdims=True)
    assert (np.abs(np_(tcov)[m] - np_(jcov)[m]) <= 5e-3 * scale).all()
    if loss != "NONE":
        plain = np_(t_cov.estimate_covariances(tc.points, tknn))[m]
        assert np.abs(np_(tcov)[m] - plain).max() > 1e-4  # the weights did something


@pytest.mark.parametrize("loss,mad,floor,iters", [("GEMAN_MCCLURE", 1.0, 5.0, 1), ("CAUCHY", 1.4826, 1e-4, 3)])
def test_estimate_covariances_robust_on_a_blob(loss, mad, floor, iters):
    """Uniform points in a box, some masked, one with too few neighbours."""
    rng = np.random.default_rng(12)
    pts = rng.uniform(-5, 5, size=(600, 3)).astype(np.float32)
    jc, tc = clouds(pts, capacity=640)
    knn = approx_knn(jc.points, jc.mask, jc.points, 10)
    idx, d2 = np_(knn.indices).copy(), np_(knn.distances).copy()
    idx[5, 3:], d2[5, 3:] = -1, np.inf  # 3 valid neighbours: the identity comes out
    idx[6, 8:], d2[6, 8:] = -1, np.inf
    jknn = type(knn)(both(idx)[0], both(d2)[0])
    tknn = TKNNResult(both(idx)[1], both(d2)[1])
    jcov = j_cov.estimate_covariances_robust(jc.points, jknn, JLoss[loss], mad, floor, iters)
    tcov = t_cov.estimate_covariances_robust(tc.points, tknn, TLoss[loss], mad, floor, iters)
    np.testing.assert_allclose(np_(tcov)[:600], np_(jcov)[:600], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(np_(tcov)[5], np.eye(3, dtype=np.float32))


def test_row_median_is_the_mean_of_the_middle_two():
    x = np.random.default_rng(0).normal(size=(50, 10)).astype(np.float32)
    np.testing.assert_allclose(np_(t_cov._row_median(torch.from_numpy(x))), np.asarray(jnp.median(x, axis=1)),
                               rtol=1e-6)
    x9 = x[:, :9]
    np.testing.assert_allclose(np_(t_cov._row_median(torch.from_numpy(x9.copy()))), np.median(x9, axis=1), rtol=1e-6)


@pytest.mark.parametrize("use_normals", [False, True])
def test_angle_incidence_filter(scan, use_normals):
    jc, knn, tc, tknn = scan
    covs = j_cov.estimate_covariances(jc.points, knn)
    jc, tc = jc.replace(covs=covs), tc.replace(covs=both(np_(covs))[1])
    if use_normals:
        nrm = j_cov.extract_normals(jc.points, covs)
        jc, tc = jc.replace(normals=nrm), tc.replace(normals=both(np_(nrm))[1])
    lo, hi = 10.0 * math.pi / 180.0, 80.0 * math.pi / 180.0
    jm = np_(j_filters.angle_incidence_filter(jc, lo, hi).mask)
    tm = np_(t_filters.angle_incidence_filter(tc, lo, hi).mask)
    p = np_(jc.points)
    n = np_(jc.normals) if use_normals else np_(t_filters.smallest_eigenvector3(tc.covs))
    abs_cos = np.abs((p * n).sum(-1)) / np.maximum(np.linalg.norm(p, axis=-1) * np.linalg.norm(n, axis=-1), 1e-30)
    clear = (np.abs(abs_cos - math.cos(lo)) > 1e-5) & (np.abs(abs_cos - math.cos(hi)) > 1e-5)
    np.testing.assert_array_equal(tm[clear], jm[clear])
    assert clear.mean() > 0.99 and 0 < tm.sum() < np_(jc.mask).sum()
    for bad in ((-0.1, 1.0), (0.5, 0.4), (0.0, 2.0)):
        with pytest.raises(ValueError):
            t_filters.angle_incidence_filter(tc, *bad)
    with pytest.raises(ValueError):
        t_filters.angle_incidence_filter(tc.replace(covs=None, normals=None), lo, hi)


# --------------------------------------------------------------------------
# registration helpers and the map prior
# --------------------------------------------------------------------------


def _features(cloud):
    knn = approx_knn(cloud.points, cloud.mask, cloud.points, 10)
    covs = j_cov.estimate_covariances(cloud.points, knn)
    return cloud.replace(covs=covs, normals=j_cov.extract_normals(cloud.points, covs))


@pytest.fixture(scope="module")
def pair():
    world = World()
    pose_tgt, pose_src = figure8_trajectory(2, speed=0.7)
    out = []
    for pose in (pose_src, pose_tgt):
        jc, _ = clouds(scan_at(world, pose, n_az=256, n_rings=24))
        jc = _features(j_voxel.voxel_downsample(j_filters.box_filter(jc, 0.5, 50.0), 0.5, out_capacity=2048))
        tc = cloud_from_numpy(jc.to_numpy(compacted=False), device="cpu").replace(mask=both(np_(jc.mask))[1])
        out.append((jc, tc))
    (js, ts), (jt, tt) = out
    return js, jt, ts, tt, (np.linalg.inv(pose_tgt) @ pose_src).astype(np.float32)


def _reg_params(method="gauss_newton", loss="GEMAN_MCCLURE", reg_type="GICP"):
    return j_reg.RegistrationParams(
        reg_type=JRegType[reg_type], robust=j_reg.RobustParams(type=JLoss[loss], default_scale=2.5),
        optimization_method=method, max_iterations=10,
    )


@pytest.mark.parametrize("reg_type,scale", [("GICP", None), ("GICP", 1.0), ("POINT_TO_PLANE", None)])
def test_compute_icp_robust_weights(pair, reg_type, scale):
    js, jt, ts, tt, T_gt = pair
    params = _reg_params(reg_type=reg_type)
    pose = T_gt @ rigid(np.random.default_rng(0), 0.01, 0.05)
    jw = j_reg.compute_icp_robust_weights(js, jt, JBruteForceKNN.build(jt), both(pose)[0], params, scale)
    tw = t_reg.compute_icp_robust_weights(ts, tt, TBruteForceKNN.build(tt), both(pose)[1],
                                          params_from_reference(params), scale)
    if reg_type == "GICP":
        np.testing.assert_allclose(np_(tw), np_(jw), rtol=0, atol=2e-3)
    else:
        np.testing.assert_allclose(np_(tw), np_(jw), rtol=1e-4, atol=1e-5)
    w = np_(tw)
    assert (w[~np_(ts.mask)] == 0).all() and 0.0 < w[np_(ts.mask)].mean() < 1.0


def test_compute_linearized_result(pair):
    js, jt, ts, tt, T_gt = pair
    params = _reg_params()
    jl = j_reg.compute_linearized_result(js, jt, JBruteForceKNN.build(jt), both(T_gt)[0], params)
    tl = t_reg.compute_linearized_result(ts, tt, TBruteForceKNN.build(tt).prepped(), both(T_gt)[1],
                                         params_from_reference(params))
    _close_rel(tl.H, jl.H)
    _close_rel(tl.b, jl.b, rtol=5e-3)
    np.testing.assert_allclose(float(tl.error), float(jl.error), rtol=1e-4)
    assert int(tl.inlier) == int(jl.inlier)
    # nl_reg toward an initial pose, as in JAX
    nl = dataclasses.replace(params, degenerate_reg=j_degen.DegenerateRegularizationParams(
        type="nl_reg", rot_eigenvalue_threshold=1e4, trans_eigenvalue_threshold=1e3))
    T_init = both(T_gt @ j_lie_np.se3_exp(np.array([0.01, 0, 0, 0.1, 0, 0])).astype(np.float32))
    jn = j_reg.compute_linearized_result(js, jt, JBruteForceKNN.build(jt), both(T_gt)[0], nl, initial_pose=T_init[0])
    tn = t_reg.compute_linearized_result(ts, tt, TBruteForceKNN.build(tt), both(T_gt)[1], params_from_reference(nl),
                                         initial_pose=T_init[1])
    _close_rel(tn.H, jn.H)
    _close_rel(tn.b, jn.b, rtol=5e-3)
    assert not np.allclose(np_(tn.H), np_(tl.H))  # the penalty acted


def _prior_inputs(rng, inlier=800, error_raw=950.0):
    A = rng.normal(size=(40, 6)).astype(np.float32)
    H = (A.T @ A * 30.0).astype(np.float32)
    prev_T = rigid(rng, 0.3, 5.0)
    T_pred = prev_T @ rigid(rng, 0.03, 0.4)
    return prev_T, H, np.float32(error_raw), np.int32(inlier), T_pred.astype(np.float32)


@pytest.mark.parametrize("inlier,error_raw,active", [(800, 950.0, True), (800, 10.0, True), (2, 5.0, False),
                                                     (800, float("nan"), False)])
def test_map_prior_update_and_apply(inlier, error_raw, active):
    rng = np.random.default_rng(7)
    inputs = _prior_inputs(rng, inlier, error_raw)
    jp = j_prior.update(j_prior.MapPriorParams(enabled=True), *(both(x)[0] for x in inputs))
    tp = t_prior.update(t_prior.MapPriorParams(enabled=True), *(both(x)[1] for x in inputs))
    assert bool(tp.active) == bool(jp.active) == active
    _close_rel(tp.omega, jp.omega)
    np.testing.assert_allclose(np_(tp.T_pred_inv), np_(jp.T_pred_inv), atol=1e-5)

    T_est = (inputs[4] @ rigid(rng, 0.02, 0.1)).astype(np.float32)
    H, b = inputs[1], rng.normal(size=6).astype(np.float32)
    jl = jp.apply(j_reg.LinearizedResult(both(H)[0], both(b)[0], jnp.float32(3.0), jnp.int32(5)), both(T_est)[0])
    tl = tp.apply(t_reg.LinearizedResult(both(H)[1], both(b)[1], torch.tensor(3.0), torch.tensor(5)), both(T_est)[1])
    _close_rel(tl.H, jl.H)
    _close_rel(tl.b, jl.b)
    np.testing.assert_allclose(float(tl.error), float(jl.error), rtol=1e-4)
    np.testing.assert_allclose(float(tp.prior_error(both(T_est)[1])), float(jp.prior_error(both(T_est)[0])),
                               rtol=1e-4, atol=1e-7)
    # a batch of poses (the LM sweep) evaluates like each alone
    batch = tp.prior_error(torch.from_numpy(np.stack([T_est, inputs[4]])))
    np.testing.assert_allclose(float(batch[0]), float(tp.prior_error(both(T_est)[1])), rtol=1e-6)
    assert abs(float(batch[1])) < 1e-6


def test_map_prior_disabled_is_inactive():
    inputs = _prior_inputs(np.random.default_rng(8))
    tp = t_prior.update(t_prior.MapPriorParams(), *(both(x)[1] for x in inputs))
    assert not bool(tp.active) and not bool(tp.omega.any())
    assert torch.equal(tp.T_pred_inv, torch.eye(4))


@pytest.mark.parametrize("method", ["gauss_newton", "levenberg_marquardt", "powell_dogleg"])
def test_align_with_the_map_prior(pair, method):
    """The prior pulls toward a prediction 5 cm off the truth; both packages
    land on the same compromise."""
    js, jt, ts, tt, T_gt = pair
    rng = np.random.default_rng(9)
    T_pred = (T_gt @ rigid(rng, 0.002, 0.05)).astype(np.float32)
    prev_T, _, err_raw, inlier, _ = _prior_inputs(rng)
    H_prev = (np.eye(6) * 1e7).astype(np.float32)
    args = (prev_T, H_prev, err_raw, inlier, T_pred)
    tight = dict(enabled=True, rot_vel_sigma=1e-2, trans_vel_sigma=1e-2, rot_base_sigma=1e-3, trans_base_sigma=1e-3)
    jp = j_prior.update(j_prior.MapPriorParams(**tight), *(both(x)[0] for x in args))
    tp = t_prior.update(t_prior.MapPriorParams(**tight), *(both(x)[1] for x in args))
    params = _reg_params(method)
    jres = j_reg.align(js, jt, JBruteForceKNN.build(jt), params, initial_guess=both(T_pred)[0], map_prior=jp)
    tres = t_reg.align(ts, tt, TBruteForceKNN.build(tt), params_from_reference(params),
                       initial_guess=both(T_pred)[1], map_prior=tp)
    np.testing.assert_allclose(np_(tres.T), np_(jres.T), rtol=0, atol=1e-4)
    free = t_reg.align(ts, tt, TBruteForceKNN.build(tt), params_from_reference(params), initial_guess=both(T_pred)[1])
    assert np.abs(np_(tres.T) - np_(free.T)).max() > 1e-3  # the prior moved the answer
    # H_raw leaves the prior out, H carries it
    assert np.abs(np_(tres.H) - np_(tres.H_raw)).max() > 1.0
    _close_rel(tres.H_raw, jres.H_raw, rtol=2e-3)


# --------------------------------------------------------------------------
# host-side copies
# --------------------------------------------------------------------------


def test_lie_np_equals_the_original():
    rng = np.random.default_rng(10)
    twists = [np.zeros(6), np.array([1e-8, 0, 0, 1, 2, 3.0]), np.array([0, 0, math.pi - 1e-7, 0, 0, 0.0])]
    twists += [np.concatenate([rng.normal(scale=s, size=3), rng.normal(size=3)]) for s in (1e-3, 0.1, 1.0, 2.0)]
    for tw in twists:
        T = j_lie_np.se3_exp(tw)
        np.testing.assert_allclose(t_lie_np.se3_exp(tw), T, atol=1e-6)
        np.testing.assert_allclose(t_lie_np.se3_log(T), j_lie_np.se3_log(T), atol=1e-6)
        np.testing.assert_allclose(t_lie_np.so3_exp_matrix(tw[:3]), j_lie_np.so3_exp_matrix(tw[:3]), atol=1e-6)
        np.testing.assert_allclose(t_lie_np.so3_log(T[:3, :3]), j_lie_np.so3_log(T[:3, :3]), atol=1e-6)
        np.testing.assert_allclose(t_lie_np.matrix_to_quat(T[:3, :3]), j_lie_np.matrix_to_quat(T[:3, :3]), atol=1e-6)
    assert t_lie_np.se3_log(np.eye(4)).dtype == np.float32


@pytest.mark.parametrize("mode", ["LIDAR_CV", "GYRO_LIDAR_CV", "IMU_SE3"])
@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_motion_predictor_equals_the_original(mode, alpha):
    rng = np.random.default_rng(11)
    jmp = j_mp.MotionPredictor(j_params.MotionPredictionParams(mode=mode, velocity_ema_alpha=alpha))
    tmp = t_mp.MotionPredictor(t_params.MotionPredictionParams(mode=mode, velocity_ema_alpha=alpha))
    odom = rigid(rng, 0.5, 10.0)
    for step in range(4):
        lin, ang = rng.normal(size=3).astype(np.float32), rng.normal(scale=0.2, size=3).astype(np.float32)
        A = rng.normal(size=(30, 6))
        H = (A.T @ A * (0.5 + 40 * step)).astype(np.float32) if step else None
        gyro = j_lie_np.so3_exp_matrix(rng.normal(scale=0.05, size=3)).astype(np.float32) if step == 2 else None
        imu_pose = rigid(rng) if step == 3 else None
        args = (lin, ang, odom, 0.1, H, 300 * step, step > 0, gyro, imu_pose)
        odom = jmp.predict(*args)
        np.testing.assert_allclose(tmp.predict(*args), odom, atol=1e-6)
    # without an IMU every mode is the constant-velocity predictor
    args = (lin, ang, odom, 0.1, H, 900, True, None, None)
    cv = t_mp.MotionPredictor(t_params.MotionPredictionParams(mode="LIDAR_CV"))
    fresh = t_mp.MotionPredictor(t_params.MotionPredictionParams(mode=mode))
    np.testing.assert_allclose(fresh.predict(*args), cv.predict(*args), atol=1e-7)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


def _assert_mirrors(ref, port, path="params"):
    if isinstance(ref, enum.Enum):
        assert type(port).__name__ == type(ref).__name__ and port.name == ref.name, path
    elif dataclasses.is_dataclass(ref):
        assert type(port).__name__ == type(ref).__name__, path
        assert type(port).__module__.startswith("sycl_points_tpu_torch."), path
        assert {f.name for f in dataclasses.fields(port)} == {f.name for f in dataclasses.fields(ref)}, path
        for f in dataclasses.fields(port):
            _assert_mirrors(getattr(ref, f.name), getattr(port, f.name), f"{path}.{f.name}")
    else:
        assert port == ref, path


def _full_tree():
    P = j_params
    return P.LidarOdometryParams(
        scan=P.ScanParams(
            intensity_correction=P.IntensityCorrectionParams(enable=False, exp=1.5),
            downsampling=P.DownsamplingParams(
                voxel=P.VoxelDownsamplingParams(enable=True, size=0.7), polar=P.PolarDownsamplingParams(enable=False),
                random=P.RandomDownsamplingParams(num=4321)),
            preprocess=P.PreprocessParams(box_filter=P.BoxFilterParams(min=1.0, max=60.0),
                                          angle_incidence_filter=P.AngleIncidenceFilterParams(max_angle=1.2)),
        ),
        submap=P.SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=0.8, keyframe=P.KeyframeParams(distance_threshold=3.0),
                              map_capacity=1 << 12, extract_capacity=1 << 10, extract_capacity_growth=False),
        covariance_estimation=P.CovarianceEstimationParams(
            neighbor_num=12, m_estimation=P.MEstimationParams(type=JLoss.HUBER, max_iterations=2)),
        imu=P.IMUParams(gyro_bias=(0.1, 0.2, 0.3), deskew=P.IMUDeskewParams(gyro_only=True)),
        registration=P.RegistrationBlockParams(
            min_num_points=77,
            factor=j_reg.RegistrationParams(reg_type=JRegType.GENZ, robust=j_reg.RobustParams(type=JLoss.TUKEY),
                                            optimization_method="powell_dogleg", lm=j_reg.LevenbergMarquardtParams(init_lambda=3.0))),
        registration_sampling=P.RandomSamplingParams(num=900),
        pose=P.PoseParams(initial=tuple(rigid(np.random.default_rng(0)).ravel().tolist())),
        scan_capacity=1 << 12,
        motion_prediction=P.MotionPredictionParams(mode="LIDAR_CV", rotation=P.AdaptiveAxisParams(factor_min=0.3)),
        lo_pipeline_robust=P.RobustScheduleParams(auto_scale=True, init_scale=8.0),
    )


@pytest.mark.parametrize("make", [j_params.LidarOdometryParams, _full_tree, j_params.CommonParameters,
                                  j_prior.MapPriorParams, j_params.LidarInertialOdometryParams],
                         ids=lambda f: f.__name__)
def test_params_from_reference_mirrors_the_tree(make):
    ref = make()
    port = params_from_reference(ref)
    _assert_mirrors(ref, port)
    if isinstance(ref, j_params.LidarOdometryParams):
        _assert_mirrors(ref.make_registration_pipeline_params(), port.make_registration_pipeline_params())
        np.testing.assert_array_equal(port.pose.initial_matrix(), ref.pose.initial_matrix())
        np.testing.assert_array_equal(port.imu.T_imu_to_lidar_matrix(), ref.imu.T_imu_to_lidar_matrix())


def test_port_defaults_equal_the_reference_defaults():
    assert params_from_reference(j_params.LidarOdometryParams()) == t_params.LidarOdometryParams()
    assert t_params.PolarDownsamplingParams().enable and t_params.SubmapParams().map_type == "OCCUPANCY_GRID_MAP"


YAML_TEXT = """
scan:
  downsampling:
    voxel: {enable: true, size: 0.5}
    polar: {enable: false}
    random: {enable: true, num: 2000}
submap:
  map_type: VOXEL_HASH_MAP
  voxel_size: 0.75
registration:
  min_num_points: 42
  factor:
    reg_type: point_to_plane
    max_correspondence_distance: 1.5
    robust: {type: huber, default_scale: 3.0}
pose:
  initial: [1, 0, 0, 2, 0, 1, 0, 3, 0, 0, 1, 4, 0, 0, 0, 1]
"""


@pytest.mark.parametrize("as_file", [True, False])
def test_load_params_yaml(tmp_path, as_file):
    source = YAML_TEXT
    if as_file:
        source = str(tmp_path / "params.yaml")
        Path(source).write_text(YAML_TEXT)
    ref = j_params.load_params(source, j_params.LidarOdometryParams)
    port = t_params.load_params(source, t_params.LidarOdometryParams)
    _assert_mirrors(ref, port)
    assert port.scan.downsampling.voxel.size == 0.5 and not port.scan.downsampling.polar.enable
    assert port.registration.factor.reg_type.name == "POINT_TO_PLANE"
    assert port.registration.factor.robust.type is TLoss.HUBER
    assert port.covariance_estimation.neighbor_num == 10  # untouched defaults survive
    assert port.pose.initial_matrix()[2, 3] == 4.0


def test_load_params_rejects_an_unknown_key():
    with pytest.raises(KeyError, match="nonexistent_field"):
        t_params.load_params({"scan": {"nonexistent_field": 1}})
    assert t_params.load_params({"registration": {"factor": {"reg_type": "p2d"}}}).registration.factor.reg_type.name \
        == "POINT_TO_DISTRIBUTION"
    assert t_params.load_params(None) == t_params.LidarOdometryParams()
