"""The port's IMU modules against the JAX package, on the CPU.

  * ``factor``: ``retract``, ``compute_manifold_residual``,
    ``compute_imu_hessian_gradient`` and ``compute_imu_gradient`` on random
    states, rtol=1e-5, atol=1e-6 (float32, the 15x15 inverse to rtol 1e-4);
    a batch of deltas retracts like each one alone; ``select``;
  * preintegration: the port's parallel-prefix form against the JAX
    parallel form, and against the port's own sequential form, with and
    without noise, on a padded window and on one with invalid steps inside:
    every field at rtol=2e-4, atol=2e-5 (the JAX package's own bound between
    its two forms), the covariance within 2e-4 of its largest entry; the
    per-step trajectory outputs too; the doubling scan equals a running
    product;
  * the window helpers (interpolation, window, steps, padding, packing):
    exactly equal;
  * ``IMUPreintegration``: ``get_dt_total``, ``get_corrected``,
    ``predict_transform``, ``predict_relative_transform`` with and without a
    bias change, rtol=2e-4, atol=2e-5;
  * the velocity corrector and the initial alignment (numpy copies): equal
    to the originals, the corrector to 1e-5 (its snapshot comes from each
    package's preintegration).
"""

import numpy as np
import pytest
import torch

from _torch_parity import both, np_

from sycl_points_tpu.imu import factor as j_factor
from sycl_points_tpu.imu import initial_alignment as j_align
from sycl_points_tpu.imu import preintegration as j_pre
from sycl_points_tpu.imu import velocity_corrector as j_vc
from sycl_points_tpu.utils import lie_np
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.imu import factor as t_factor
from sycl_points_tpu_torch.imu import initial_alignment as t_align
from sycl_points_tpu_torch.imu import preintegration as t_pre
from sycl_points_tpu_torch.imu import velocity_corrector as t_vc

RTOL, ATOL = 2e-4, 2e-5  # preintegration
COV_REL = 2e-4  # covariance, relative to its largest entry
NOISE = dict(gyro_noise_density=1e-3, accel_noise_density=1e-2, gyro_bias_rw_density=1e-5,
             accel_bias_rw_density=1e-4)


def _rot(rng, scale=0.5):
    return lie_np.so3_exp_matrix(rng.normal(scale=scale, size=3)).astype(np.float32)


def _states(rng, n=None):
    shape = () if n is None else (n,)
    fields = dict(
        position=rng.normal(size=shape + (3,)), rotation=np.stack([_rot(rng) for _ in range(n or 1)]),
        velocity=rng.normal(size=shape + (3,)), accel_bias=rng.normal(scale=0.1, size=shape + (3,)),
        gyro_bias=rng.normal(scale=0.01, size=shape + (3,)),
    )
    if n is None:
        fields["rotation"] = fields["rotation"][0]
    fields = {k: np.asarray(v, np.float32) for k, v in fields.items()}
    return (j_factor.State(**{k: both(v)[0] for k, v in fields.items()}),
            t_factor.State(**{k: both(v)[1] for k, v in fields.items()}))


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np_(got), np_(ref), rtol=rtol, atol=atol)


def test_factor_matches_jax():
    rng = np.random.default_rng(0)
    (jx, tx), (jy, ty) = _states(rng), _states(rng)
    delta = rng.normal(scale=0.1, size=15).astype(np.float32)
    jd, td = both(delta)
    jr, tr = j_factor.retract(jx, jd), t_factor.retract(tx, td)
    for a, b in zip(jr, tr):
        _close(b, a)
    _close(t_factor.compute_manifold_residual(tx, tr), j_factor.compute_manifold_residual(jx, jr), atol=2e-6)
    _close(t_factor.compute_manifold_residual(tx, ty), j_factor.compute_manifold_residual(jx, jy), atol=2e-6)

    A = rng.normal(size=(15, 15)).astype(np.float32)
    P = (A @ A.T * 0.01 + np.eye(15) * 0.1).astype(np.float32)
    jH, jb, jok = j_factor.compute_imu_hessian_gradient(jx, jy, both(P)[0])
    tH, tb, tok = t_factor.compute_imu_hessian_gradient(tx, ty, both(P)[1])
    assert bool(tok) and bool(jok)
    _close(tH, jH, rtol=1e-4, atol=1e-4)
    _close(tb, jb, rtol=1e-4, atol=1e-4)
    _close(t_factor.compute_imu_gradient(tx, ty, tH), j_factor.compute_imu_gradient(jx, jy, jH), rtol=1e-4,
           atol=1e-4)
    # not positive definite: zero H and b
    _, tb0, tok0 = t_factor.compute_imu_hessian_gradient(tx, ty, both(-P)[1])
    assert not bool(tok0) and not np_(tb0).any()


def test_factor_batches_and_select():
    rng = np.random.default_rng(1)
    _, tx = _states(rng)
    deltas = torch.from_numpy(rng.normal(scale=0.1, size=(4, 15)).astype(np.float32))
    batched = t_factor.retract(tx, deltas)
    for c in range(4):
        one = t_factor.retract(tx, deltas[c])
        for a, b in zip(one, batched):
            np.testing.assert_allclose(np_(b)[c], np_(a), rtol=1e-6, atol=1e-6)
    res = t_factor.compute_manifold_residual(tx, batched)
    assert res.shape == (4, 15)
    np.testing.assert_allclose(np_(res), np_(deltas), atol=1e-5)
    pick = t_factor.select(torch.tensor(True), tx, t_factor.retract(tx, deltas[0]))
    assert all(torch.equal(a, b) for a, b in zip(pick, tx))
    ident = t_factor.State.identity(device="cpu")
    np.testing.assert_array_equal(np_(ident.pose()), np.eye(4))


def _window_arrays(rng, S=48, n_valid=40, holes=()):
    dt = np.full(S, 1.0 / 200, np.float32)
    dt[n_valid:] = 0.0
    valid = dt > 0
    for h in holes:
        valid[h] = False
    w = rng.normal(scale=0.4, size=(S + 1, 3)).astype(np.float32)
    a = (rng.normal(scale=0.8, size=(S + 1, 3)) + [0, 0, 9.8]).astype(np.float32)
    gb = np.array([0.01, -0.02, 0.005], np.float32)
    ab = np.array([-0.03, 0.01, 0.02], np.float32)
    Rw = np.array([[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0], [0.48, 0.64, 0.6]], np.float32)
    return (dt, w[:-1], w[1:], a[:-1], a[1:], valid, gb, ab, Rw)


def _assert_state_close(got, ref, what):
    for name in ref._fields:
        g, r = np_(getattr(got, name)), np_(getattr(ref, name))
        if name == "covariance":
            assert np.abs(g - r).max() <= COV_REL * np.abs(r).max(), f"{what}: covariance"
        else:
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("noise", [True, False], ids=["noise", "no-noise"])
@pytest.mark.parametrize("holes", [(), (3, 17, 18)], ids=["padded", "invalid-steps"])
def test_preintegration_matches_jax(noise, holes):
    rng = np.random.default_rng(11)
    arrays = _window_arrays(rng, holes=holes)
    jp = j_pre.IMUPreintegrationParams(**(NOISE if noise else {}))
    tp = params_from_reference(jp)
    P0 = rng.normal(scale=1e-3, size=(15, 15)).astype(np.float32)
    P0 = P0 @ P0.T
    ja = [both(a)[0] for a in arrays]
    ta = [both(a)[1] for a in arrays]
    jref, jout = j_pre.integrate_steps_with_outputs(jp, j_pre.init_state(both(P0)[0]), *ja, parallel=True)
    par, pout = t_pre.integrate_steps_with_outputs(tp, t_pre.init_state(both(P0)[1]), *ta, parallel=True)
    seq, sout = t_pre.integrate_steps_with_outputs(tp, t_pre.init_state(both(P0)[1]), *ta, parallel=False)
    _assert_state_close(par, jref, "parallel vs JAX")
    _assert_state_close(par, seq, "parallel vs sequential")
    for a, b, c in zip(jout, pout, sout):
        np.testing.assert_allclose(np_(b), np_(a), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np_(b), np_(c), rtol=RTOL, atol=ATOL)


def test_preintegration_from_a_nonempty_state():
    """The parallel form composes onto a window already integrated."""
    rng = np.random.default_rng(5)
    first, second = _window_arrays(rng, S=32, n_valid=32), _window_arrays(rng, S=32, n_valid=20)
    tp = t_pre.IMUPreintegrationParams(**NOISE)
    ta = [both(a)[1] for a in first]
    tb = [both(a)[1] for a in second]
    mid = t_pre.integrate_steps(tp, t_pre.init_state(device="cpu"), *ta)
    par = t_pre.integrate_steps(tp, mid, *tb, parallel=True)
    seq = t_pre.integrate_steps(tp, mid, *tb, parallel=False)
    _assert_state_close(par, seq, "from a non-empty state")


def test_doubling_scan_is_a_running_product():
    rng = np.random.default_rng(2)
    for S in (1, 2, 5, 64):
        R = torch.from_numpy(np.stack([_rot(rng) for _ in range(S)]))
        (M,) = t_pre.inclusive_scan((R,), lambda a, b: (a[0] @ b[0],))
        run = torch.eye(3)
        for k in range(S):
            run = run @ R[k]
            np.testing.assert_allclose(np_(M[k]), np_(run), atol=2e-6)


def _stream(rng, t0=10.0, n=60, hz=200.0, jitter=False):
    ts = t0 + np.arange(n) / hz
    if jitter:
        ts = ts + rng.uniform(-1e-4, 1e-4, size=n)
        ts[7] = ts[6]  # a repeated timestamp
    g = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    a = (rng.normal(scale=0.5, size=(n, 3)) + [0, 0, 9.8]).astype(np.float32)
    return ([j_pre.IMUMeasurement(float(t), g[i], a[i]) for i, t in enumerate(ts)],
            [t_pre.IMUMeasurement(float(t), g[i], a[i]) for i, t in enumerate(ts)])


def _same_window(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.timestamp == y.timestamp
        np.testing.assert_array_equal(x.gyro, y.gyro)
        np.testing.assert_array_equal(x.accel, y.accel)


@pytest.mark.parametrize("start,end", [(10.0, 10.2), (10.0123, 10.2077), (9.9, 10.1), (10.05, 10.05),
                                       (10.1, 11.0), (10.0, 10.0025)])
def test_window_helpers_equal_the_originals(start, end):
    rng = np.random.default_rng(3)
    js, ts = _stream(rng, jitter=True)
    jw = j_pre.build_measurement_window(js, start, end)
    tw = t_pre.build_measurement_window(ts, start, end)
    _same_window(jw, tw)
    for jarr, tarr in zip(j_pre.steps_from_window(jw), t_pre.steps_from_window(tw)):
        np.testing.assert_array_equal(tarr, jarr)
    jpad = j_pre.padded_steps_from_window(jw)
    tpad = t_pre.padded_steps_from_window(tw)
    for jarr, tarr in zip(jpad, tpad):
        np.testing.assert_array_equal(tarr, jarr)
    packed = t_pre.pack_steps(*tpad)
    np.testing.assert_array_equal(packed, j_pre.pack_steps(*jpad))
    for jarr, tarr in zip(j_pre.unpack_steps(packed), t_pre.unpack_steps(torch.from_numpy(packed))):
        np.testing.assert_array_equal(np_(tarr), np.asarray(jarr))
    if len(jw) >= 2:
        _same_window([j_pre.interpolate_measurement(jw[0], jw[1], start + 1e-3)],
                     [t_pre.interpolate_measurement(tw[0], tw[1], start + 1e-3)])


@pytest.mark.parametrize("bias_change", [False, True], ids=["raw", "corrected"])
def test_streaming_preintegration_matches_jax(bias_change):
    rng = np.random.default_rng(4)
    js, ts = _stream(rng, n=41)
    R0 = _rot(rng)
    gb, ab = np.array([0.01, 0.0, -0.01], np.float32), np.array([0.02, -0.01, 0.0], np.float32)
    jp = j_pre.IMUPreintegration(j_pre.IMUPreintegrationParams(**NOISE))
    tp = t_pre.IMUPreintegration(params_from_reference(jp.params), device="cpu")
    jp.reset(gb, ab, R_world_body=R0)
    tp.reset(gb, ab, R_world_body=R0)
    jp.integrate_batch(js)
    tp.integrate_batch(ts)
    tp.integrate(ts[3])  # out of order: dropped
    assert tp.num_measurements == jp.num_measurements == 41
    assert tp.get_dt_total() == pytest.approx(jp.get_dt_total(), rel=1e-6)
    new = dict(gyro_bias=gb + 0.005, accel_bias=ab - 0.02) if bias_change else {}
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3], T0[:3, 3] = R0, [1.0, -2.0, 0.5]
    v0 = np.array([1.0, 0.5, -0.1], np.float32)
    np.testing.assert_allclose(np_(tp.predict_transform(T0, v0, **new)), np_(jp.predict_transform(T0, v0, **new)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(tp.predict_relative_transform(R0, v0, **new)),
                               np_(jp.predict_relative_transform(R0, v0, **new)), rtol=RTOL, atol=ATOL)
    if bias_change:
        _assert_state_close(tp.get_corrected(new["gyro_bias"], new["accel_bias"]),
                            jp.get_corrected(new["gyro_bias"], new["accel_bias"]), "corrected")


def test_velocity_corrector_equals_the_original():
    rng = np.random.default_rng(6)
    js, ts = _stream(rng, n=21)
    jp, tp = j_pre.IMUPreintegration(), t_pre.IMUPreintegration(device="cpu")
    jp.integrate_batch(js)
    tp.integrate_batch(ts)
    jc, tc = j_vc.IMUVelocityCorrector(), t_vc.IMUVelocityCorrector()
    fallback = np.array([1.0, 2.0, 0.0], np.float32)
    gb, ab = np.zeros(3, np.float32), np.zeros(3, np.float32)
    np.testing.assert_array_equal(tc.get_reset_velocity(tp, gb, ab, fallback),
                                  jc.get_reset_velocity(jp, gb, ab, fallback))
    R = _rot(rng)
    g = np.array([0, 0, -9.80665], np.float32)
    for c in (jc, tc):
        c.update(np.array([0.1, 0.2, 0.0], np.float32), R, g)
    np.testing.assert_allclose(tc._corrected_v, jc._corrected_v, rtol=1e-5, atol=1e-5)
    # the stored velocity is returned once, then the fallback again
    np.testing.assert_allclose(tc.get_reset_velocity(tp, gb, ab, fallback),
                               jc.get_reset_velocity(jp, gb, ab, fallback), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tc.get_reset_velocity(tp, gb, ab, fallback), fallback)


def _still_buffer(rng, mod, R_true, n=300, hz=200.0, gyro_bias=(0.01, -0.02, 0.005), noise=0.01):
    f = R_true.T @ np.array([0, 0, 9.80665])
    return [mod.IMUMeasurement(float(10.0 + i / hz),
                               (np.asarray(gyro_bias) + rng.normal(scale=noise, size=3)).astype(np.float32),
                               (f + rng.normal(scale=noise, size=3)).astype(np.float32)) for i in range(n)]


@pytest.mark.parametrize("case", ["tilted", "moving", "short", "timeout"])
def test_initial_alignment_equals_the_original(case):
    R_true = lie_np.so3_exp_matrix(np.array([0.1, -0.05, 0.3]))
    jbuf = _still_buffer(np.random.default_rng(7), j_pre, R_true, n=40 if case == "short" else 300,
                         noise=0.5 if case in ("moving", "timeout") else 0.01)
    tbuf = _still_buffer(np.random.default_rng(7), t_pre, R_true, n=40 if case == "short" else 300,
                         noise=0.5 if case in ("moving", "timeout") else 0.01)
    g = np.array([0, 0, -9.80665], np.float32)
    z = np.zeros(3, np.float32)
    jparams = j_align.InitialAlignmentParams(enable=True, max_wait_sec=0.5)
    tparams = params_from_reference(jparams)
    jr = j_align.estimate_initial_alignment(jbuf, g, jparams, z, z)
    tr = t_align.estimate_initial_alignment(tbuf, g, tparams, z, z)
    assert (tr.success, tr.error_message) == (jr.success, jr.error_message)
    for name in ("R_world_imu", "gyro_bias", "accel_mean", "gyro_std", "accel_std"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name), err_msg=name)
    assert (tr.roll_rad, tr.pitch_rad, tr.accel_norm) == (jr.roll_rad, jr.pitch_rad, jr.accel_norm)

    T_il = np.eye(4, dtype=np.float32)
    T_il[:3, :3] = _rot(np.random.default_rng(8), 0.2)
    je = j_align.InitialAlignmentEstimator(jparams, g, T_il)
    te = t_align.InitialAlignmentEstimator(tparams, g, T_il)
    for t in (10.0, 10.7 if case == "timeout" else 10.1):
        jo, to = je.try_align(t, jbuf, z, z), te.try_align(t, tbuf, z, z)
        assert to[0] == jo[0] and te.is_done() == je.is_done()
        if jo[0]:
            np.testing.assert_array_equal(to[1], jo[1])
            np.testing.assert_array_equal(to[2], jo[2])
