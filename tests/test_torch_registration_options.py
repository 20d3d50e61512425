"""The registration options of the port against the JAX package, on the CPU:
nl_reg (``registration/degenerate.py``), the rotation constraint
(``registration/rotation_constraint.py``), the coarse-to-fine schedule, and
intensity-weighted registration sampling.

Tolerances:
  * ``regularize`` on random SPD systems, with ``inlier == 0``, on the JAX
    test's rank-deficient H and with type "none": H and b within 1e-5 of
    their largest entry (the float32 eigendecompositions of the 3x3 blocks
    round alike but not identically); the penalty masks are compared
    exactly;
  * ``rotation_constraint_linearized``, ``add_rotation_constraint`` and
    ``rotation_constraint_error`` on random SPD covariances: the divergence
    enters through log-determinants, which the port takes in closed form
    and JAX by LU, so H, b and the errors are held within 1e-3 relative
    (1e-3 of the largest entry for H and b);
  * every function above with a leading stream axis: each stream equal to
    the single call bit for bit;
  * ``align`` with each option and with all three, on the JAX tests'
    corner (``tests/test_registration_extras.py:31``) and floor-and-walls
    (``:128``) scenes under Gauss-Newton, LM and dogleg: the pose within
    1e-5 of JAX's entry by entry, and within 2e-3 for dogleg with
    coarse-to-fine (see DOGLEG_C2F_ATOL); equal iteration counts for GN and
    LM (a dogleg step near convergence is accepted or rejected on float32
    cost differences summed in another order, so its count is not
    compared); with coarse-to-fine, the trace's inlier column equal in
    every coarse iteration (the strided target searched in the same
    iterations; dogleg: the first), no coarse iteration converged,
    ``coarse_iterations`` equal to the coarse part of the count, and a
    fine iteration after them;
  * ``compute_linearized_result`` with nl_reg: H and b as ``regularize``;
  * ``align_pipeline`` with ``use_intensities``, given JAX's two Gumbel
    arrays as the noise pair: the sampled cloud equal, the pose within
    1e-5; ``align_pipeline_streams`` with it: each stream equal to a
    single-stream call bit for bit;
  * ``load_params`` carries ``coarse_to_fine_iters`` / ``coarse_stride``
    and the rotation constraint as JAX's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both, np_, rigid, spd

from sycl_points_tpu.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu.ops.knn import BruteForceKNN as JBruteForceKNN, brute_force_knn
from sycl_points_tpu.ops.robust import RobustLossType as JLoss
from sycl_points_tpu.pipeline import params as j_params
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu.registration import degenerate as j_degen
from sycl_points_tpu.registration import pipeline as j_pipeline
from sycl_points_tpu.registration import registration as j_reg
from sycl_points_tpu.registration import rotation_constraint as j_rotc
from sycl_points_tpu.registration.factors import RegType
from sycl_points_tpu.utils import lie_np
from sycl_points_tpu_torch.convert import cloud_from_numpy, params_from_reference
from sycl_points_tpu_torch.ops.knn import BruteForceKNN as TBruteForceKNN
from sycl_points_tpu_torch.pipeline import params as t_params
from sycl_points_tpu_torch.points.point_cloud import PointCloud as TCloud
from sycl_points_tpu_torch.registration import degenerate as t_degen
from sycl_points_tpu_torch.registration import pipeline as t_pipeline
from sycl_points_tpu_torch.registration import registration as t_reg
from sycl_points_tpu_torch.registration import rotation_constraint as t_rotc
from sycl_points_tpu_torch.registration.registration import LinearizedResult as TLin

POSE_ATOL = 1e-5
# Dogleg in the coarse phase: the costs of the far coarse matches (~105 on
# 1,800 points) are compared against predicted reductions of ~1e-9, so an
# accept is float32 noise; the trust radius then takes another path (on the
# floor-and-walls scene JAX shrinks it to 2.4e-4 and stops on a step clipped
# to it, 1.1 mm short of the port's refined pose).
DOGLEG_C2F_ATOL = 2e-3
METHODS = ["gauss_newton", "levenberg_marquardt", "powell_dogleg"]


def _eq(a, b, err_msg=""):
    np.testing.assert_array_equal(np_(a), np_(b), err_msg=err_msg)


def _close_scaled(got, ref, rel, err_msg=""):
    ref = np_(ref)
    assert np.abs(np_(got) - ref).max() <= rel * max(np.abs(ref).max(), 1e-30), err_msg


# -- nl_reg ------------------------------------------------------------------------


def _lin_pair(H, b, inlier, error=0.0):
    jl = j_reg.LinearizedResult(H=jnp.asarray(H), b=jnp.asarray(b), error=jnp.float32(error),
                                inlier=jnp.int32(inlier))
    tl = TLin(H=torch.from_numpy(np.array(H)), b=torch.from_numpy(np.array(b)),
              error=torch.tensor(error, dtype=torch.float32), inlier=torch.tensor(inlier, dtype=torch.int32))
    return jl, tl


def _reg_cases():
    rng = np.random.default_rng(11)
    A = rng.normal(size=(40, 6)).astype(np.float32)
    H_rand = (A.T @ A * 5.0).astype(np.float32)
    # the JAX test's corridor: no information along x translation
    H_rank = np.diag([100.0, 100.0, 100.0, 0.0, 100.0, 100.0]).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    T_cur = rigid(rng, 0.1, 0.5)
    T_init = rigid(rng, 0.1, 0.5)
    nl = j_degen.DegenerateRegularizationParams(type="nl_reg", rot_eigenvalue_threshold=3.0,
                                                trans_eigenvalue_threshold=3.0, base_factor=2.0)
    corridor = j_degen.DegenerateRegularizationParams(type="nl_reg", trans_eigenvalue_threshold=1.0,
                                                      rot_eigenvalue_threshold=0.0, base_factor=1.0)
    return {
        "random": (nl, H_rand, b, 50, T_cur, T_init),
        "no inliers": (nl, H_rand, b, 0, T_cur, T_init),
        "rank-deficient": (corridor, H_rank, np.zeros(6, np.float32), 50,
                           lie_np.se3_exp(np.array([0, 0, 0, 0.5, 0, 0])).astype(np.float32), np.eye(4, dtype=np.float32)),
        "type none": (j_degen.DegenerateRegularizationParams(), H_rand, b, 50, T_cur, T_init),
    }


@pytest.mark.parametrize("case", list(_reg_cases()))
def test_regularize_matches_jax(case):
    params, H, b, inlier, T_cur, T_init = _reg_cases()[case]
    jl, tl = _lin_pair(H, b, inlier)
    jo = j_degen.regularize(params, jl, jnp.asarray(T_cur), jnp.asarray(T_init))
    to = t_degen.regularize(params_from_reference(params), tl, torch.from_numpy(T_cur), torch.from_numpy(T_init))
    _close_scaled(to.H, jo.H, 1e-5)
    _close_scaled(to.b, jo.b, 1e-5)
    # which entries the penalty touched
    _eq(np_(to.H) != H, np.asarray(jo.H) != H)
    if case in ("no inliers", "type none"):
        _eq(to.H, H)
        _eq(to.b, b)
    if case == "rank-deficient":  # the JAX test's claims, on the port
        assert np_(to.H)[3, 3] > 10.0
        delta = np.linalg.solve(np_(to.H) + 1e-6 * np.eye(6), -np_(to.b))
        assert delta[3] < -0.2


def test_regularize_streams_equal_single_calls():
    cases = [c for k, c in _reg_cases().items() if k != "type none"]
    params = t_degen.DegenerateRegularizationParams(type="nl_reg", rot_eigenvalue_threshold=3.0,
                                                    trans_eigenvalue_threshold=3.0, base_factor=2.0)
    stack = lambda i, dt=None: torch.from_numpy(np.stack([np.asarray(c[i], dt) for c in cases]))
    tl = TLin(H=stack(1), b=stack(2), error=torch.zeros(len(cases)), inlier=stack(3, np.int32))
    out = t_degen.regularize(params, tl, stack(4), stack(5))
    for s, c in enumerate(cases):
        _, one = _lin_pair(c[1], c[2], c[3])
        ref = t_degen.regularize(params, one, torch.from_numpy(c[4]), torch.from_numpy(c[5]))
        _eq(out.H[s], ref.H, f"stream {s}")
        _eq(out.b[s], ref.b, f"stream {s}")


# -- the rotation constraint ----------------------------------------------------------


def _rotc_inputs(seed, n=64):
    rng = np.random.default_rng(seed)
    return (rigid(rng, 0.3, 1.0), spd(rng, n, (1e-3, 1.0)), spd(rng, n, (1e-3, 1.0)), rng.uniform(size=n) > 0.2)


def _rotc_params(loss):
    return j_reg.RegistrationParams(
        robust=j_reg.RobustParams(type=loss),
        rotation_constraint=j_reg.RotationConstraintParams(enable=True, weight=0.5))


class _Corr:
    """The two fields the constraint reads of the gathered correspondences."""

    def __init__(self, covs_raw, mask):
        self.covs_raw, self.covs_reg, self.mask = covs_raw, None, mask


@pytest.mark.parametrize("loss", [JLoss.NONE, JLoss.HUBER, JLoss.GEMAN_MCCLURE], ids=lambda x: x.name)
def test_rotation_constraint_matches_jax(loss):
    T, Cs, Ct, mask = _rotc_inputs(5)
    jp = _rotc_params(loss)
    tp = params_from_reference(jp)
    scale = 0.3
    jH, jb, je = j_rotc.rotation_constraint_linearized(jnp.asarray(T), jnp.asarray(Cs), jnp.asarray(Ct),
                                                       jnp.asarray(mask), loss, scale, 0.5)
    tH, tb, te = t_rotc.rotation_constraint_linearized(torch.from_numpy(T), torch.from_numpy(Cs),
                                                       torch.from_numpy(Ct), torch.from_numpy(mask),
                                                       tp.robust.type, scale, 0.5)
    _close_scaled(tH, jH, 1e-3)
    _close_scaled(tb, jb, 1e-3)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-3)
    assert float(je) > 0.0 and np.abs(np.asarray(jH)).max() > 0.0

    H0, b0 = (np.eye(6) * 3.0).astype(np.float32), np.arange(6, dtype=np.float32)
    jl, tl = _lin_pair(H0, b0, int(mask.sum()), error=2.0)
    jo = j_rotc.add_rotation_constraint(jp, jl, jnp.asarray(T), jnp.asarray(Cs),
                                        _Corr(jnp.asarray(Ct), jnp.asarray(mask)), scale)
    to = t_rotc.add_rotation_constraint(tp, tl, torch.from_numpy(T), torch.from_numpy(Cs),
                                        _Corr(torch.from_numpy(Ct), torch.from_numpy(mask)), scale)
    _close_scaled(to.H, jo.H, 1e-3)
    _close_scaled(to.b, jo.b, 1e-3)
    np.testing.assert_allclose(float(to.error), float(jo.error), rtol=1e-3)
    _eq(to.H[3:, :], H0[3:, :])  # only the rotation block moves
    _eq(to.b[3:], b0[3:])

    for T_at in (T, rigid(np.random.default_rng(6), 0.2, 0.5)):
        je = j_rotc.rotation_constraint_error(jp, jnp.asarray(T_at), jnp.asarray(Cs),
                                              _Corr(jnp.asarray(Ct), jnp.asarray(mask)), scale)
        te = t_rotc.rotation_constraint_error(tp, torch.from_numpy(T_at), torch.from_numpy(Cs),
                                              _Corr(torch.from_numpy(Ct), torch.from_numpy(mask)), scale)
        np.testing.assert_allclose(float(te), float(je), rtol=1e-3)


def test_rotation_constraint_streams_equal_single_calls():
    inputs = [_rotc_inputs(s) for s in (5, 6, 7)]
    tp = params_from_reference(_rotc_params(JLoss.GEMAN_MCCLURE))
    stack = lambda i: torch.from_numpy(np.stack([x[i] for x in inputs]))
    T, Cs, Ct, mask = (stack(i) for i in range(4))
    scale = torch.tensor([0.3, 0.5, 1.0])[:, None]
    H, b, e = t_rotc.rotation_constraint_linearized(T, Cs, Ct, mask, tp.robust.type, scale, 0.5)
    # the LM sweep's shape: candidate poses [B, C, 4, 4] against [B, 1, N] pairs
    cands = torch.stack([T, T @ torch.from_numpy(rigid(np.random.default_rng(9), 0.1, 0.1))], 1)
    ec = t_rotc.rotation_constraint_error(tp, cands, Cs[:, None], _Corr(Ct[:, None], mask[:, None]), scale[:, None])
    for s, (T1, Cs1, Ct1, m1) in enumerate(inputs):
        args = [torch.from_numpy(a) for a in (T1, Cs1, Ct1, m1)]
        rH, rb, re = t_rotc.rotation_constraint_linearized(*args, tp.robust.type, scale[s], 0.5)
        _eq(H[s], rH, f"stream {s}")
        _eq(b[s], rb, f"stream {s}")
        _eq(e[s], re, f"stream {s}")
        for c in range(2):
            _eq(ec[s, c], t_rotc.rotation_constraint_error(tp, cands[s, c], args[1], _Corr(args[2], args[3]),
                                                           scale[s]), f"stream {s}, candidate {c}")


# -- align on the JAX tests' scenes -------------------------------------------------------


def _cloud(pts):
    jc = JCloud.from_numpy(pts.astype(np.float32))
    covs = estimate_covariances(jc.points, brute_force_knn(jc.points, jc.mask, jc.points, 10))
    jc = jc.replace(covs=covs, normals=extract_normals(jc.points, covs))
    tc = cloud_from_numpy(jc.to_numpy(compacted=False), device="cpu")
    return jc, tc.replace(mask=both(np_(jc.mask))[1])


def corner_scene():
    """tests/test_registration_extras.py:31 (three planes, 600 points)."""
    rng = np.random.default_rng(71)
    per = 200
    u = rng.uniform(0.2, 5, size=(per, 2)).astype(np.float32)
    pts = np.concatenate([
        np.stack([u[:, 0], u[:, 1], np.zeros(per, np.float32)], 1),
        np.stack([np.zeros(per, np.float32), u[:, 0], u[:, 1]], 1),
        np.stack([u[:, 0], np.zeros(per, np.float32), u[:, 1]], 1),
    ]) + rng.normal(scale=0.004, size=(3 * per, 3)).astype(np.float32)
    return pts, lie_np.se3_exp(np.array([0.05, -0.03, 0.04, 0.2, -0.1, 0.1]))


def corridor_scene():
    """tests/test_registration_extras.py:128 (a floor and two walls, 1800
    points)."""
    rng = np.random.default_rng(5)
    per = 600
    u = rng.uniform(-6, 6, size=(per, 2)).astype(np.float32)
    pts = np.concatenate([
        np.stack([u[:, 0], u[:, 1], np.zeros(per, np.float32)], 1),
        np.stack([np.full(per, 6.0, np.float32), u[:, 0], u[:, 1] * 0.3], 1),
        np.stack([u[:, 0], np.full(per, 6.0, np.float32), u[:, 1] * 0.3], 1),
    ]) + rng.normal(scale=0.004, size=(3 * per, 3)).astype(np.float32)
    return pts, lie_np.se3_exp(np.array([0.02, -0.01, 0.03, 0.15, -0.1, 0.05]))


SCENES = {"corner": corner_scene, "corridor": corridor_scene}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, make in SCENES.items():
        pts, T = make()
        (jt, tt), (js, ts) = _cloud(pts), _cloud((pts - T[:3, 3]) @ T[:3, :3])
        out[name] = (js, jt, ts, tt, T)
    return out


# nl_reg thresholds between the scenes' eigenvalues per inlier (rotation
# blocks 460-4254, translation 158-183), so that some directions are weak
NL_REG = j_degen.DegenerateRegularizationParams(type="nl_reg", rot_eigenvalue_threshold=3000.0,
                                                trans_eigenvalue_threshold=165.0)
COARSE_ITERS = 8
OPTIONS = {
    "rotation-constraint": dict(rotation_constraint=j_reg.RotationConstraintParams(enable=True, weight=0.5)),
    "nl-reg": dict(degenerate_reg=NL_REG),
    "coarse-to-fine": dict(coarse_to_fine_iters=COARSE_ITERS, coarse_stride=4),
}
OPTIONS["all"] = {k: v for kw in OPTIONS.values() for k, v in kw.items()}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("scene", list(SCENES))
def test_align_options_match_jax(scenes, scene, option, method):
    js, jt, ts, tt, T_true = scenes[scene]
    jp = j_reg.RegistrationParams(reg_type=RegType.GICP, max_iterations=30, optimization_method=method,
                                  **OPTIONS[option])
    jres, jtr = j_reg.align(js, jt, JBruteForceKNN.build(jt), jp, trace=True)
    tres, ttr = t_reg.align(ts, tt, TBruteForceKNN.build(tt), params_from_reference(jp), trace=True)
    cf = jp.coarse_to_fine_iters
    dogleg = method == "powell_dogleg"
    atol = DOGLEG_C2F_ATOL if dogleg and cf else POSE_ATOL
    np.testing.assert_allclose(np_(tres.T), np_(jres.T), rtol=0, atol=atol)
    assert np.abs(np_(tres.T)[:3, 3] - T_true[:3, 3]).max() < 0.01
    n = int(tres.iterations)
    if not dogleg:
        assert n == int(jres.iterations)
    jtr, ttr = np_(jtr), np_(ttr)
    assert tres.coarse_iterations == min(n, cf)
    if cf:
        inl, conv = j_reg.TRACE_COLS.index("inlier"), j_reg.TRACE_COLS.index("converged")
        rows = 1 if dogleg else cf
        _eq(ttr[:rows, inl], jtr[:rows, inl])
        assert not ttr[:cf, conv].any() and not jtr[:cf, conv].any()
        assert n > cf  # the pose is refined on the full target


def test_compute_linearized_result_with_nl_reg(scenes):
    js, jt, ts, tt, T_true = scenes["corner"]
    jp = j_reg.RegistrationParams(reg_type=RegType.GICP, degenerate_reg=NL_REG)
    T_at = (T_true @ lie_np.se3_exp(np.array([0.01, 0, 0, 0.05, 0, 0]))).astype(np.float32)
    jl = j_reg.compute_linearized_result(js, jt, JBruteForceKNN.build(jt), jnp.asarray(T_at), jp,
                                         initial_pose=jnp.eye(4))
    tl = t_reg.compute_linearized_result(ts, tt, TBruteForceKNN.build(tt), torch.from_numpy(T_at),
                                         params_from_reference(jp), initial_pose=torch.eye(4))
    plain = t_reg.compute_linearized_result(ts, tt, TBruteForceKNN.build(tt), torch.from_numpy(T_at),
                                            params_from_reference(jp))
    _close_scaled(tl.H, jl.H, 1e-4)
    _close_scaled(tl.b, jl.b, 1e-3)
    assert int(tl.inlier) == int(jl.inlier)
    assert not torch.equal(tl.H, plain.H)  # the penalty acted


def test_rotation_constraint_needs_covariances(scenes):
    _, _, ts, tt, _ = scenes["corner"]
    params = t_reg.RegistrationParams(reg_type=RegType.POINT_TO_PLANE,
                                      rotation_constraint=t_reg.RotationConstraintParams(enable=True))
    with pytest.raises(ValueError, match="rotation constraint requires source and target covariances"):
        t_reg.align(ts.replace(covs=None), tt, TBruteForceKNN.build(tt), params)


# -- intensity-weighted registration sampling ---------------------------------------------


def _with_intensities(jc, tc, seed):
    inten = np.random.default_rng(seed).uniform(0.0, 1.0, jc.capacity).astype(np.float32)
    inten[::7] = 0.0  # never weighted
    return jc.replace(intensities=jnp.asarray(inten)), tc.replace(intensities=torch.from_numpy(inten))


def _sampling_params():
    return j_pipeline.RegistrationPipelineParams(
        registration=j_reg.RegistrationParams(reg_type=RegType.GICP, max_iterations=20,
                                              optimization_method="levenberg_marquardt"),
        random_sampling=j_pipeline.RandomSamplingParams(enable=True, num=300, use_intensities=True,
                                                        weighted_ratio=0.8))


def test_align_pipeline_intensity_sampling_matches_jax(scenes):
    js, jt, ts, tt, T_true = scenes["corridor"]
    js, ts = _with_intensities(js, ts, 3)
    params = _sampling_params()
    key = jax.random.key(1234)
    jout = j_pipeline.align_pipeline(js, jt, JBruteForceKNN.build(jt), params, key=key)
    k1, k2 = jax.random.split(key)
    pair = tuple(both(jax.random.gumbel(k, (js.capacity,)))[1] for k in (k1, k2))
    tout = t_pipeline.align_pipeline(ts, tt, TBruteForceKNN.build(tt), params_from_reference(params), scores=pair)
    for name in ("points", "mask", "intensities"):
        _eq(getattr(tout.registration_input, name), getattr(jout.registration_input, name), name)
    n_w = round(300 * 0.8)
    assert bool(tout.registration_input.mask[:n_w].all())  # the weighted part is full
    assert bool((tout.registration_input.intensities[:n_w] > 0).all())
    np.testing.assert_allclose(np_(tout.result.T), np_(jout.result.T), rtol=0, atol=POSE_ATOL)
    assert np.abs(np_(tout.result.T)[:3, 3] - T_true[:3, 3]).max() < 0.01

    # no intensities: the uniform draw, as in JAX
    plain = t_pipeline.align_pipeline(ts.replace(intensities=None), tt, TBruteForceKNN.build(tt),
                                      params_from_reference(params),
                                      scores=both(jax.random.gumbel(key, (js.capacity,)))[1])
    jplain = j_pipeline.align_pipeline(js.replace(intensities=None), jt, JBruteForceKNN.build(jt), params, key=key)
    _eq(plain.registration_input.points, jplain.registration_input.points)


def test_align_pipeline_streams_intensity_sampling_equals_single_calls(scenes):
    pairs = []
    for s, name in enumerate(SCENES):
        _, _, ts, tt, _ = scenes[name]
        pairs.append((_with_intensities(scenes[name][0], ts, 10 + s)[1], tt))
    cap = max(max(s.capacity, t.capacity) for s, t in pairs)

    def pad(c):  # to the larger capacity, with masked rows
        extra = cap - c.capacity
        return TCloud(**{k: None if a is None else torch.cat([a, torch.zeros((extra,) + a.shape[1:], dtype=a.dtype)])
                         for k, a in vars(c).items()})

    def stack(cs):
        return TCloud(**{k: None if getattr(cs[0], k) is None else torch.stack([getattr(c, k) for c in cs])
                         for k in vars(cs[0])})

    pairs = [(pad(s), pad(t)) for s, t in pairs]
    src, tgt = stack([s for s, _ in pairs]), stack([t for _, t in pairs])
    params = params_from_reference(_sampling_params())
    init = torch.eye(4).expand(2, 4, 4)
    out = t_pipeline.align_pipeline_streams(src, tgt, TBruteForceKNN(points=tgt.points, mask=tgt.mask), params,
                                            initial_guess=init)
    for s, (ss, tt) in enumerate(pairs):
        one = t_pipeline.align_pipeline(ss, tt, TBruteForceKNN.build(tt), params, initial_guess=init[s])
        for name in ("points", "mask", "intensities"):
            _eq(getattr(out.registration_input, name)[s], getattr(one.registration_input, name), f"{s} {name}")
        _eq(out.result.T[s], one.result.T, f"stream {s}")
        assert int(out.result.iterations[s]) == int(one.result.iterations)


# -- the parameter tree -------------------------------------------------------------------


def test_load_params_carries_the_options():
    tree = {"registration": {"factor": {
        "coarse_to_fine_iters": 20, "coarse_stride": 4,
        "rotation_constraint": {"enable": True, "weight": 0.5, "robust_scale": 2.0}}},
        "registration_sampling": {"use_intensities": True, "weighted_ratio": 0.6}}
    ref = j_params.load_params(tree)
    port = t_params.load_params(tree)
    assert params_from_reference(ref) == port
    f = port.registration.factor
    assert (f.coarse_to_fine_iters, f.coarse_stride) == (20, 4)
    assert f.rotation_constraint == t_reg.RotationConstraintParams(enable=True, weight=0.5, robust_scale=2.0)
    assert port.registration_sampling.use_intensities and port.registration_sampling.weighted_ratio == 0.6
    # the degenerate parameters convert by field names too
    nl = dataclasses.replace(j_reg.RegistrationParams(), degenerate_reg=NL_REG)
    assert params_from_reference(nl).degenerate_reg == t_degen.DegenerateRegularizationParams(
        type="nl_reg", rot_eigenvalue_threshold=3000.0, trans_eigenvalue_threshold=165.0)
    assert t_degen.DegenerateRegularizationParams.from_string(" nl-reg ") == "nl_reg"
    with pytest.raises(ValueError):
        t_degen.DegenerateRegularizationParams.from_string("tikhonov")
