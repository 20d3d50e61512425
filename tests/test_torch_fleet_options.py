"""The registration options in the port's stream forms and its LIO solve,
on the CPU:

  * ``registration.align_streams`` with the rotation constraint, nl_reg,
    coarse-to-fine and all three, under Gauss-Newton, LM and dogleg: each
    stream equal to a single-stream ``align`` bit for bit (pose, iteration
    count, convergence, the raw system), ``coarse_iterations`` equal;
  * ``lio.align_streams`` with the constraint and nl_reg: each stream equal
    to a single-stream ``lio.align`` bit for bit;
  * ``lio.align`` with the constraint and nl_reg against JAX ``lio.align``
    on the LIO solver tests' corner scene, under GN, LM and dogleg: every
    state field and the pose within 1e-5, inliers and iterations equal;
    then both packages' LIO with ``coarse_to_fine_iters=20`` against 0:
    the same pose bit for bit in each (the LIO solve searches the full
    target in every iteration).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import both, np_

from sycl_points_tpu.imu.factor import State as JState
from sycl_points_tpu.lio import lio_registration as j_lio
from sycl_points_tpu.ops.knn import BruteForceKNN as JBruteForceKNN
from sycl_points_tpu.registration import degenerate as j_degen
from sycl_points_tpu.registration.factors import RegType
from sycl_points_tpu.registration.registration import (
    RegistrationParams,
    RobustLossType,
    RobustParams,
    RotationConstraintParams,
)
from sycl_points_tpu_torch.convert import lio_state_from_reference, params_from_reference
from sycl_points_tpu_torch.imu.factor import State
from sycl_points_tpu_torch.lio import lio_registration as t_lio
from sycl_points_tpu_torch.ops.knn import BruteForceKNN
from sycl_points_tpu_torch.registration import registration as t_reg
from sycl_points_tpu_torch.registration.degenerate import DegenerateRegularizationParams

from test_torch_fleet_lio import _stack_clouds, _state_eq, two_scenes  # noqa: E402, F401 (fixture)
from test_torch_fleet_ops import B, _stack, pairs, scans  # noqa: E402, F401 (fixtures)
from test_torch_lio_registration import _spd, _start, scene  # noqa: E402, F401 (fixture)

METHODS = ["gauss_newton", "levenberg_marquardt", "powell_dogleg"]
NL_REG = dict(type="nl_reg", rot_eigenvalue_threshold=3000.0, trans_eigenvalue_threshold=165.0)
OPTIONS = {
    "rotation-constraint": dict(rotation_constraint=t_reg.RotationConstraintParams(enable=True, weight=0.5)),
    "nl-reg": dict(degenerate_reg=DegenerateRegularizationParams(**NL_REG)),
    "coarse-to-fine": dict(coarse_to_fine_iters=4, coarse_stride=4),
}
OPTIONS["all"] = {k: v for kw in OPTIONS.values() for k, v in kw.items()}


def _eq(a, b, err_msg=""):
    np.testing.assert_array_equal(np_(a), np_(b), err_msg=err_msg)


# -- the LO fleet's align ------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("option", list(OPTIONS))
def test_align_streams_with_options_equal_single_aligns(pairs, option, method):
    srcs, tgts, init = pairs
    params = t_reg.RegistrationParams(reg_type=t_reg.RegType.GICP, optimization_method=method, max_iterations=10,
                                      **OPTIONS[option])
    sched = ((2.0, 1.0), (1.0, 0.5))
    src, tgt = _stack(srcs), _stack(tgts)
    res = t_reg.align_streams(src, tgt, BruteForceKNN(points=tgt.points, mask=tgt.mask), params, init,
                              robust_schedule=sched)
    for b in range(B):
        one = t_reg.align(srcs[b], tgts[b], BruteForceKNN.build(tgts[b]), params, init[b], robust_schedule=sched)
        for name in ("T", "iterations", "converged", "H_raw", "b_raw", "error_raw", "H", "b"):
            _eq(getattr(res, name)[b], getattr(one, name), f"stream {b}: {name}")
        if params.coarse_to_fine_iters:
            assert one.coarse_iterations == res.coarse_iterations == params.coarse_to_fine_iters


# -- the LIO solve -------------------------------------------------------------------------


def _lio_factor(**kw):
    return RegistrationParams(reg_type=RegType.GICP,
                              rotation_constraint=RotationConstraintParams(enable=True, weight=0.5),
                              degenerate_reg=j_degen.DegenerateRegularizationParams(**NL_REG), **kw)


@pytest.mark.parametrize("method", METHODS)
def test_lio_align_streams_with_options_equal_single_aligns(two_scenes, method):
    rng = np.random.default_rng(3)
    params = t_lio.LIORegistrationParams(total_iterations=12, optimization_method=method,
                                         robust=t_lio.LIORobustScheduleParams(auto_scale=True, auto_scaling_iter=3))
    factor = params_from_reference(_lio_factor(robust=RobustParams(type=RobustLossType.GEMAN_MCCLURE)))
    starts = []
    for _ in range(2):
        x = State(*(torch.from_numpy(np.asarray(a, np.float32)) for a in (
            rng.normal(scale=0.02, size=3), np.eye(3), rng.normal(size=3), rng.normal(scale=0.01, size=3),
            rng.normal(scale=0.001, size=3))))
        starts.append((x, torch.from_numpy(_spd(rng, 15, 0.5)), torch.from_numpy(_spd(rng, 15, 1.0))))
    singles = [t_lio.align(src, tgt, BruteForceKNN.build(tgt), x, Pp, Pq, factor_params=factor, params=params)
               for (src, tgt), (x, Pp, Pq) in zip(two_scenes, starts)]
    src = _stack_clouds([s for s, _ in two_scenes])
    tgt = _stack_clouds([t for _, t in two_scenes])
    res = t_lio.align_streams(src, tgt, BruteForceKNN.build(tgt),
                              State(*(torch.stack(f) for f in zip(*[x for x, _, _ in starts]))),
                              torch.stack([p for _, p, _ in starts]), torch.stack([q for _, _, q in starts]),
                              factor_params=factor, params=params)
    for b, one in enumerate(singles):
        _state_eq(State(*(f[b] for f in res.state)), one.state, f"stream {b}: ")
        for name in ("posterior_covariance", "T", "inlier", "error"):
            _eq(getattr(res, name)[b], getattr(one, name), f"stream {b}: {name}")
        assert int(res.executed[b]) == one.executed


def _lio_pair(scene, factor, method, coarse=0):
    js, jt, ts, tt = scene
    x, P_pred, P_prev = _start(np.random.default_rng(3))
    factor = dataclasses.replace(factor, coarse_to_fine_iters=coarse)
    jp = j_lio.LIORegistrationParams(total_iterations=15, optimization_method=method)
    jx = JState(*(both(a)[0] for a in x))
    tx, tP_pred = lio_state_from_reference(x, P_pred, device="cpu")
    _, tP_prev = lio_state_from_reference(x, P_prev, device="cpu")
    jr = j_lio.align(js, jt, JBruteForceKNN.build(jt), jx, both(P_pred)[0], both(P_prev)[0],
                     factor_params=factor, params=jp)
    tr = t_lio.align(ts, tt, BruteForceKNN.build(tt), tx, tP_pred, tP_prev,
                     factor_params=params_from_reference(factor), params=params_from_reference(jp))
    return jr, tr


@pytest.mark.parametrize("method", METHODS)
def test_lio_align_with_options_matches_jax(scene, method):
    jr, tr = _lio_pair(scene, _lio_factor(), method)
    for name in JState._fields:
        np.testing.assert_allclose(np_(getattr(tr.state, name)), np_(getattr(jr.state, name)), rtol=0, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(np_(tr.T), np_(jr.T), rtol=0, atol=1e-5)
    assert int(tr.inlier) == int(jr.inlier) and int(tr.iterations) == int(jr.iterations)
    # the options moved the solve
    _, plain = _lio_pair(scene, RegistrationParams(reg_type=RegType.GICP), method)
    assert not torch.equal(tr.T, plain.T)


def test_lio_ignores_coarse_to_fine_as_jax(scene):
    factor = RegistrationParams(reg_type=RegType.GICP)
    j0, t0 = _lio_pair(scene, factor, "gauss_newton")
    j20, t20 = _lio_pair(scene, factor, "gauss_newton", coarse=20)
    _eq(j20.T, j0.T)
    _eq(t20.T, t0.T)
    assert t20.executed == t0.executed
