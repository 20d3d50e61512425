"""The port's 15-DOF LIO solver against the JAX package, on the CPU.

  * ``add_icp_factor``, ``apply_directional_icp_weighting`` (its ``eigh3``
    block filter on strong, weak, empty and switched-off inputs), the
    IMU <-> LiDAR covariance transforms and ``_level_schedule``: rtol=1e-5,
    atol=1e-5 on the 15x15 systems (1e-3 of the largest entry where an
    eigen-decomposition of float32 sums enters), schedules exactly;
  * ``align`` with Gauss-Newton, LM and dogleg on the fixture of
    ``tests/test_lio_registration.py`` (a three-plane corner, GICP), both
    started from one predicted state and covariance carried over by
    ``convert.lio_state_from_reference``: every state field and the pose
    within 1e-5, ``P_post`` within 1e-4 of its largest entry, inliers and
    iterations equal, the final robust error rtol=1e-3, atol=1e-8 (converged
    residuals of ~4 mm on ~5 m coordinates); also with the bias frozen and over a
    3-level robust schedule;
  * ``convert``: a JAX ``LidarInertialOdometryParams`` (defaults and a
    changed tree, also through ``load_params``) and a JAX ``State`` with its
    ``P_post`` carried over exactly;
  * the trace: the same NaN rows, the level / inlier / accepted / converged
    columns equal, the others rtol=1e-3 (float32 error sums in another
    order), atol=1e-6.
"""

import numpy as np
import pytest
import torch

from _torch_parity import both, np_

from sycl_points_tpu.imu.factor import State as JState
from sycl_points_tpu.pipeline import params as j_params
from sycl_points_tpu.lio import lio_registration as j_lio
from sycl_points_tpu.ops.covariance import estimate_covariances
from sycl_points_tpu.ops.knn import BruteForceKNN as JBruteForceKNN, brute_force_knn
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu.registration.factors import RegType
from sycl_points_tpu.registration.registration import RegistrationParams, RobustLossType, RobustParams
from sycl_points_tpu.utils import lie_np
from sycl_points_tpu_torch.convert import cloud_from_numpy, lio_state_from_reference, params_from_reference
from sycl_points_tpu_torch.lio import lio_registration as t_lio
from sycl_points_tpu_torch.pipeline import params as t_params
from sycl_points_tpu_torch.ops.knn import BruteForceKNN as TBruteForceKNN

T_TRUE = lie_np.se3_exp(np.array([0.03, -0.02, 0.05, 0.2, -0.15, 0.1]))


def corner_scene(rng, n=600):
    """Three orthogonal planes (tests/test_lio_registration.py)."""
    per = n // 3
    u = rng.uniform(0.2, 5, size=(per, 2)).astype(np.float32)
    pts = np.concatenate([
        np.stack([u[:, 0], u[:, 1], np.zeros(per, np.float32)], 1),
        np.stack([np.zeros(per, np.float32), u[:, 0], u[:, 1]], 1),
        np.stack([u[:, 0], np.zeros(per, np.float32), u[:, 1]], 1),
    ])
    return pts + rng.normal(scale=0.004, size=pts.shape).astype(np.float32)


def _cloud(pts):
    jc = JCloud.from_numpy(pts)
    jc = jc.replace(covs=estimate_covariances(jc.points, brute_force_knn(jc.points, jc.mask, jc.points, 10)))
    tc = cloud_from_numpy(jc.to_numpy(compacted=False), device="cpu")
    return jc, tc.replace(mask=both(np_(jc.mask))[1])


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(31)
    tgt = corner_scene(rng)
    src = ((tgt - T_TRUE[:3, 3]) @ T_TRUE[:3, :3]).astype(np.float32)
    (js, ts), (jt, tt) = _cloud(src), _cloud(tgt)
    return js, jt, ts, tt


def _spd(rng, n, diag):
    A = rng.normal(size=(n, n)).astype(np.float32)
    return (A @ A.T * 0.01 + np.eye(n) * diag).astype(np.float32)


def _close(got, ref, rtol=1e-5, atol=1e-5, err_msg=""):
    np.testing.assert_allclose(np_(got), np_(ref), rtol=rtol, atol=atol, err_msg=err_msg)


def test_add_icp_factor_matches_jax():
    rng = np.random.default_rng(0)
    H15, b15 = _spd(rng, 15, 1.0), rng.normal(size=15).astype(np.float32)
    icp_H, icp_b = _spd(rng, 6, 5.0), rng.normal(size=6).astype(np.float32)
    R = lie_np.so3_exp_matrix(rng.normal(size=3)).astype(np.float32)
    args = [both(a) for a in (H15, b15, icp_H, icp_b, R, np.float32(0.3))]
    jH, jb = j_lio.add_icp_factor(*[a[0] for a in args])
    tH, tb = t_lio.add_icp_factor(*[a[1] for a in args])
    _close(tH, jH)
    _close(tb, jb)


@pytest.mark.parametrize("case", ["weak-axis", "random", "no-inliers", "disabled"])
def test_directional_weighting_matches_jax(case):
    rng = np.random.default_rng(1)
    if case == "weak-axis":  # the JAX test's input
        H15 = np.zeros((15, 15), np.float32)
        H15[0, 0], H15[1, 1], H15[2, 2] = 1e4, 1.0, 1.0
        H15[3:6, 3:6] = np.eye(3) * 1e4
        b15 = np.ones(15, np.float32)
    else:
        H15, b15 = _spd(rng, 15, 50.0) * 20, rng.normal(size=15).astype(np.float32)
    inlier = np.int32(0 if case == "no-inliers" else 100)
    jp = j_lio.DirectionalIcpWeightingParams(enable=case != "disabled")
    jH, jb = j_lio.apply_directional_icp_weighting(*both(H15)[:1], both(b15)[0], both(inlier)[0], jp)
    tH, tb = t_lio.apply_directional_icp_weighting(both(H15)[1], both(b15)[1], both(inlier)[1],
                                                   params_from_reference(jp))
    scale = np.abs(np_(jH)).max()
    assert np.abs(np_(tH) - np_(jH)).max() <= 1e-3 * scale + 1e-6
    _close(tb, jb, rtol=1e-3, atol=1e-4)
    if case == "weak-axis":
        np.testing.assert_allclose(np_(tH)[1, 1], 0.2, rtol=1e-3)
        np.testing.assert_allclose(np_(tH)[0, 0], 1e4, rtol=1e-3)


def test_covariance_transforms_match_jax():
    rng = np.random.default_rng(2)
    T_il = lie_np.se3_exp(np.array([0.1, 0.2, -0.1, 0.05, -0.02, 0.3]))
    R_wl = lie_np.so3_exp_matrix(np.array([0.3, -0.1, 0.2])).astype(np.float32)
    P = _spd(rng, 15, 0.1)
    jT, tT = both(T_il)
    jR, tR = both(R_wl)
    jP, tP = both(P)
    _close(t_lio.imu_to_lidar_jacobian(tT, tR), j_lio.imu_to_lidar_jacobian(jT, jR))
    P_l = t_lio.transform_covariance_imu_to_lidar(tP, tT, tR)
    _close(P_l, j_lio.transform_covariance_imu_to_lidar(jP, jT, jR))
    _close(t_lio.transform_covariance_lidar_to_imu(tP, tT, tR), j_lio.transform_covariance_lidar_to_imu(jP, jT, jR))
    _close(t_lio.transform_covariance_lidar_to_imu(P_l, tT, tR), P, rtol=1e-3, atol=1e-4)  # round trip


@pytest.mark.parametrize("robust", [
    j_lio.LIORobustScheduleParams(),
    j_lio.LIORobustScheduleParams(auto_scale=True),
    j_lio.LIORobustScheduleParams(auto_scale=True, auto_scaling_iter=3, min_scale=1.0),
    j_lio.LIORobustScheduleParams(auto_scale=True, auto_scaling_iter=20),
])
def test_level_schedule_equals_the_original(robust):
    factor = RegistrationParams(robust=RobustParams(type=RobustLossType.GEMAN_MCCLURE))
    for total in (0, 1, 7, 10):
        jp = j_lio.LIORegistrationParams(total_iterations=total, robust=robust)
        assert t_lio._level_schedule(params_from_reference(jp), params_from_reference(factor)) == \
            j_lio._level_schedule(jp, factor)


def _start(rng, velocity=(0.3, -0.1, 0.05)):
    T_pred = (T_TRUE @ lie_np.se3_exp(np.array([0.01, 0.0, -0.01, 0.05, -0.03, 0.02]))).astype(np.float32)
    x = JState(position=T_pred[:3, 3], rotation=T_pred[:3, :3], velocity=np.asarray(velocity, np.float32),
               accel_bias=np.array([0.02, 0.0, -0.01], np.float32),
               gyro_bias=np.array([0.001, -0.002, 0.0], np.float32))
    return x, _spd(rng, 15, 0.5), _spd(rng, 15, 1.0)


ALIGN_CASES = {
    "gauss_newton": dict(optimization_method="gauss_newton"),
    "levenberg_marquardt": dict(optimization_method="levenberg_marquardt"),
    "powell_dogleg": dict(optimization_method="powell_dogleg"),
    "robust-levels": dict(optimization_method="gauss_newton", total_iterations=9,
                          robust=j_lio.LIORobustScheduleParams(auto_scale=True, auto_scaling_iter=3)),
}


@pytest.mark.parametrize("update_bias", [True, False], ids=["bias", "bias-frozen"])
@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_align_matches_jax(scene, case, update_bias):
    js, jt, ts, tt = scene
    x, P_pred, P_prev = _start(np.random.default_rng(3))
    kw = {"total_iterations": 15, **ALIGN_CASES[case]}
    jp = j_lio.LIORegistrationParams(**kw)
    factor = RegistrationParams(reg_type=RegType.GICP, robust=RobustParams(
        type=RobustLossType.GEMAN_MCCLURE if case == "robust-levels" else RobustLossType.NONE))
    jx = JState(*(both(a)[0] for a in x))
    tx, tP_pred = lio_state_from_reference(x, P_pred, device="cpu")
    _, tP_prev = lio_state_from_reference(x, P_prev, device="cpu")
    jr, jtr = j_lio.align(js, jt, JBruteForceKNN.build(jt), jx, both(P_pred)[0], both(P_prev)[0],
                          factor_params=factor, params=jp, update_bias=update_bias, trace=True)
    tr, ttr = t_lio.align(ts, tt, TBruteForceKNN.build(tt), tx, tP_pred, tP_prev,
                          factor_params=params_from_reference(factor), params=params_from_reference(jp),
                          update_bias=update_bias, trace=True)
    for name in JState._fields:
        _close(getattr(tr.state, name), getattr(jr.state, name), rtol=0, atol=1e-5, err_msg=name)
    _close(tr.T, jr.T, rtol=0, atol=1e-5)
    P_scale = np.abs(np_(jr.posterior_covariance)).max()
    assert np.abs(np_(tr.posterior_covariance) - np_(jr.posterior_covariance)).max() <= 1e-4 * P_scale
    assert int(tr.inlier) == int(jr.inlier) and int(tr.iterations) == int(jr.iterations)
    # residuals of ~4 mm on ~5 m coordinates keep 1e-4 of their float32 bits
    np.testing.assert_allclose(float(tr.error), float(jr.error), rtol=1e-3, atol=1e-8)
    if not update_bias:
        np.testing.assert_array_equal(np_(tr.state.gyro_bias), x.gyro_bias)
        np.testing.assert_array_equal(np_(tr.state.accel_bias), x.accel_bias)
    err = np.linalg.inv(T_TRUE) @ np_(tr.T)
    assert np.linalg.norm(err[:3, 3]) < 0.02

    jtr, ttr = np_(jtr), np_(ttr)
    assert ttr.shape == jtr.shape == (15 if case != "robust-levels" else 9, len(t_lio.TRACE_COLS))
    np.testing.assert_array_equal(np.isnan(ttr), np.isnan(jtr))
    assert tr.executed == int((~np.isnan(ttr[:, 0])).sum())
    exact = [t_lio.TRACE_COLS.index(c) for c in ("level", "inlier", "accepted", "converged")]
    np.testing.assert_array_equal(ttr[:, exact], jtr[:, exact])
    rest = [i for i in range(len(t_lio.TRACE_COLS)) if i not in exact]
    np.testing.assert_allclose(ttr[:, rest], jtr[:, rest], rtol=1e-3, atol=1e-6)


def test_align_keeps_the_previous_covariance_when_nothing_ran(scene):
    _, _, ts, tt = scene
    x, P_pred, P_prev = _start(np.random.default_rng(4))
    tx, tP_pred = lio_state_from_reference(x, P_pred, device="cpu")
    res = t_lio.align(ts, tt, TBruteForceKNN.build(tt), tx, tP_pred, torch.from_numpy(P_prev),
                      params=t_lio.LIORegistrationParams(total_iterations=0))
    assert res.executed == 0 and int(res.iterations) == 0
    np.testing.assert_array_equal(np_(res.posterior_covariance), P_prev)
    np.testing.assert_array_equal(np_(res.T), np_(tx.pose()))


def test_convert_carries_lio_params_and_state():
    assert params_from_reference(j_params.LidarInertialOdometryParams()) == t_params.LidarInertialOdometryParams()
    yaml = {"imu": {"enable": True, "preintegration": {"gyro_noise_density": 1e-3},
                    "initial_alignment": {"enable": True, "max_wait_sec": 2.0}},
            "lio": {"total_iterations": 7, "optimization_method": "powell_dogleg",
                    "robust": {"auto_scale": True}}, "max_gyro_bias_norm": 0.2}
    ref = j_params.load_params(yaml, j_params.LidarInertialOdometryParams)
    port = t_params.load_params(yaml, t_params.LidarInertialOdometryParams)
    assert params_from_reference(ref) == port
    assert port.imu.preintegration.gyro_noise_density == 1e-3 and port.lio.total_iterations == 7
    assert port.motion_prediction.mode == "IMU_SE3" and port.imu.initial_alignment.max_wait_sec == 2.0

    x, P, _ = _start(np.random.default_rng(5))
    jx = JState(*(both(a)[0] for a in x))
    tx, tP = lio_state_from_reference(jx, both(P)[0], device="cpu")
    for name in JState._fields:
        np.testing.assert_array_equal(np_(getattr(tx, name)), np.asarray(getattr(jx, name)), err_msg=name)
    np.testing.assert_array_equal(np_(tP), P)
    assert all(v.dtype == torch.float32 for v in (*tx, tP))
