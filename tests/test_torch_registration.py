"""Parity of the port's registration (factors, align, align_pipeline) with
the JAX package.

Tolerances:
  * whitened rows and residual norms of all five factor types on the same
    inputs: rtol=1e-4, atol=1e-5 (float32 Cholesky/eigen whitening, sums in
    another order);
  * align with GN, LM and dogleg, and align_pipeline given JAX's own Gumbel
    scores, on a fixed small scan pair: every entry of the final pose within
    1e-4. Near convergence the step tests compare float32 error sums taken in
    another order, so the two loops may stop an iteration apart; the
    iteration counts and the last trace rows are therefore not compared.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_parity import both, clouds, np_, rigid, spd

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
from synthetic_velodyne import World, figure8_trajectory, scan_at  # noqa: E402

from sycl_points_tpu.ops.covariance import estimate_covariances, extract_normals  # noqa: E402
from sycl_points_tpu.ops.filters import box_filter  # noqa: E402
from sycl_points_tpu.ops.knn import BruteForceKNN as JBruteForceKNN, approx_knn  # noqa: E402
from sycl_points_tpu.ops.voxel import voxel_downsample  # noqa: E402
from sycl_points_tpu.registration import factors as j_factors  # noqa: E402
from sycl_points_tpu.registration import pipeline as j_pipeline  # noqa: E402
from sycl_points_tpu.registration import registration as j_reg  # noqa: E402
from sycl_points_tpu_torch.convert import cloud_from_numpy, params_from_reference  # noqa: E402
from sycl_points_tpu_torch.ops.knn import BruteForceKNN as TBruteForceKNN  # noqa: E402
from sycl_points_tpu_torch.registration import factors as t_factors  # noqa: E402
from sycl_points_tpu_torch.registration import pipeline as t_pipeline  # noqa: E402
from sycl_points_tpu_torch.registration import registration as t_reg  # noqa: E402

POSE_ATOL = 1e-4


def _factor_inputs(rng, n=256):
    T = rigid(rng, 0.2, 1.0)
    src = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    tgt = (src @ T[:3, :3].T + T[:3, 3] + rng.normal(scale=0.05, size=(n, 3))).astype(np.float32)
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return dict(
        T=T, src_pts=src, tgt_pts=tgt,
        src_covs_reg=spd(rng, n, (0.01, 1.0)), tgt_covs_reg=spd(rng, n, (0.01, 1.0)),
        tgt_covs_raw=spd(rng, n, (1e-3, 0.1)), tgt_normals=normals,
        genz_planar=rng.uniform(size=n) > 0.4, genz_alpha=np.float32(0.7),
    )


@pytest.mark.parametrize("reg_type", list(j_factors.RegType), ids=lambda r: r.name)
def test_factors_match_jax(reg_type):
    inputs = _factor_inputs(np.random.default_rng(3))
    ji = {k: both(v)[0] for k, v in inputs.items()}
    ti = {k: both(v)[1] for k, v in inputs.items()}
    t_type = t_factors.RegType[reg_type.name]
    jr = j_factors.whitened_rows(reg_type, **ji)
    tr = t_factors.whitened_rows(t_type, **ti)
    for a, b in zip(jr, tr):
        np.testing.assert_allclose(np_(b), np_(a), rtol=1e-4, atol=1e-5)
    jn = j_factors.residual_norms_only(reg_type, **ji)
    tn = t_factors.residual_norms_only(t_type, **ti)
    for a, b in zip(jn, tn):
        np.testing.assert_allclose(np_(b), np_(a), rtol=1e-4, atol=1e-5)

    # A batch of poses evaluates like each pose alone (the LM sweep).
    Ts = np.stack([inputs["T"], rigid(np.random.default_rng(4), 0.1, 0.5)])
    tb = t_factors.residual_norms_only(t_type, **{**ti, "T": both(Ts)[1]})
    for c in range(2):
        one = t_factors.residual_norms_only(t_type, **{**ti, "T": both(Ts[c])[1]})
        for a, b in zip(one, tb):
            np.testing.assert_allclose(np_(b)[c], np_(a), rtol=1e-6, atol=1e-6)


def _features(cloud):
    knn = approx_knn(cloud.points, cloud.mask, cloud.points, 10)
    covs = estimate_covariances(cloud.points, knn)
    return cloud.replace(covs=covs, normals=extract_normals(cloud.points, covs))


@pytest.fixture(scope="module")
def pair():
    """Preprocessed source and target (computed once, in JAX) in both packages."""
    world = World()
    pose_tgt, pose_src = figure8_trajectory(2, speed=0.7)
    out = []
    for pose in (pose_src, pose_tgt):
        jc, _ = clouds(scan_at(world, pose, n_az=256, n_rings=24))
        jc = _features(voxel_downsample(box_filter(jc, 0.5, 50.0), 0.5, out_capacity=2048))
        out.append((jc, cloud_from_numpy(jc.to_numpy(compacted=False), device="cpu")))
    (js, ts), (jt, tt) = out
    ts = ts.replace(mask=both(np_(js.mask))[1])
    tt = tt.replace(mask=both(np_(jt.mask))[1])
    return js, jt, ts, tt, np.linalg.inv(pose_tgt) @ pose_src


def _params(method):
    return j_reg.RegistrationParams(
        reg_type=j_factors.RegType.GICP,
        robust=j_reg.RobustParams(type=j_reg.RobustLossType.GEMAN_MCCLURE, default_scale=2.5),
        optimization_method=method,
        max_iterations=10,
    )


@pytest.mark.parametrize("method", ["levenberg_marquardt", "gauss_newton", "powell_dogleg"])
def test_align_matches_jax(pair, method):
    js, jt, ts, tt, T_gt = pair
    params = _params(method)
    jres = j_reg.align(js, jt, JBruteForceKNN.build(jt), params)
    tres = t_reg.align(ts, tt, TBruteForceKNN.build(tt), params_from_reference(params))
    np.testing.assert_allclose(np_(tres.T), np_(jres.T), rtol=0, atol=POSE_ATOL)
    assert np.abs(np_(tres.T)[:3, 3] - T_gt[:3, 3]).max() < 0.05


def test_align_trace_matches_jax(pair):
    js, jt, ts, tt, _ = pair
    params = _params("levenberg_marquardt")
    schedule = ((10.0, 5.0), (5.0, 3.5), (2.5, 2.5))
    jres, jtr = j_reg.align(js, jt, JBruteForceKNN.build(jt), params, robust_schedule=schedule, trace=True)
    tres, ttr = t_reg.align(ts, tt, TBruteForceKNN.build(tt), params_from_reference(params),
                            robust_schedule=schedule, trace=True)
    jtr, ttr = np_(jtr), np_(ttr)
    assert ttr.shape == jtr.shape == (30, len(j_reg.TRACE_COLS))
    n = int(tres.iterations)
    assert np.isnan(ttr[n:]).all() and not np.isnan(ttr[:n]).any()
    # The first steps are far from any marginal accept decision.
    cols = [j_reg.TRACE_COLS.index(c) for c in ("level", "inlier", "accepted", "converged")]
    np.testing.assert_array_equal(ttr[:5, cols], jtr[:5, cols])
    err = j_reg.TRACE_COLS.index("error")
    np.testing.assert_allclose(ttr[:5, err], jtr[:5, err], rtol=1e-4)
    np.testing.assert_allclose(np_(tres.T), np_(jres.T), rtol=0, atol=POSE_ATOL)


def test_align_pipeline_with_jax_scores(pair):
    js, jt, ts, tt, T_gt = pair
    params = j_pipeline.RegistrationPipelineParams(
        registration=_params("levenberg_marquardt"),
        random_sampling=j_pipeline.RandomSamplingParams(enable=True, num=500),
        robust=j_pipeline.RobustScheduleParams(
            auto_scale=True, init_scale=10.0, min_scale=2.5,
            rotation_init_scale=5.0, rotation_min_scale=2.5, auto_scaling_iter=3,
        ),
    )
    key = jax.random.key(1234)
    jout = j_pipeline.align_pipeline(js, jt, JBruteForceKNN.build(jt), params, key=key)
    scores = np_(jax.random.gumbel(key, (js.capacity,)))
    tout = t_pipeline.align_pipeline(ts, tt, TBruteForceKNN.build(tt), params_from_reference(params),
                                     scores=both(scores)[1])
    np.testing.assert_array_equal(np_(tout.registration_input.points), np_(jout.registration_input.points))
    np.testing.assert_array_equal(np_(tout.registration_input.mask), np_(jout.registration_input.mask))
    np.testing.assert_allclose(np_(tout.result.T), np_(jout.result.T), rtol=0, atol=POSE_ATOL)
    # within two inliers of 500
    assert abs(float(t_pipeline.inlier_ratio(tout)) - float(j_pipeline.inlier_ratio(jout))) <= 2 / 500
    assert np.abs(np_(tout.result.T)[:3, 3] - T_gt[:3, 3]).max() < 0.05


def test_unported_options_raise(pair):
    _, _, ts, tt, _ = pair
    knn = TBruteForceKNN.build(tt)
    base = params_from_reference(_params("gauss_newton"))
    import dataclasses

    for bad in (
        dict(coarse_to_fine_iters=2),
        dict(rotation_constraint=t_reg.RotationConstraintParams(enable=True)),
        dict(degenerate_reg=object()),
    ):
        with pytest.raises(NotImplementedError):
            t_reg.align(ts, tt, knn, dataclasses.replace(base, **bad))
    with pytest.raises(NotImplementedError):
        t_pipeline.align_pipeline(ts, tt, knn, t_pipeline.RegistrationPipelineParams(
            velocity_update=t_pipeline.VelocityUpdateParams(enable=True)))
