"""Parity of the port's small-matrix, Lie and 3x3-eigen math with the JAX
package on the same seeded numpy inputs.

Tolerance: rtol=1e-5, atol=1e-6 throughout. Both sides run the same
elementwise float32 formulas; what differs is the order of a few sums and the
3x3 determinant (cofactor expansion here, LU in JAX), a few ulps at most.
Eigen inputs have well-separated eigenvalues so that no branch decision sits
on a near-tie.
"""

import numpy as np
import pytest

from _torch_parity import both, np_, rigid

from sycl_points_tpu.utils import eigh3 as j_eigh3
from sycl_points_tpu.utils import lie as j_lie
from sycl_points_tpu.utils import smallmat as j_sm
from sycl_points_tpu_torch.utils import eigh3 as t_eigh3
from sycl_points_tpu_torch.utils import lie as t_lie
from sycl_points_tpu_torch.utils import smallmat as t_sm

RTOL, ATOL = 1e-5, 1e-6
N = 64


def _sep_spd(rng, n=N):
    """SPD matrices with eigenvalues in three separated bands."""
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = np.stack([rng.uniform(0.05, 0.2, n), rng.uniform(0.4, 0.6, n), rng.uniform(0.8, 1.0, n)], 1)
    return np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)


def _rot(rng, n=N):
    return np.stack([rigid(rng, rot_scale=1.0)[:3, :3] for _ in range(n)]).astype(np.float32)


def _vec(rng, *shape, scale=1.0):
    return rng.normal(scale=scale, size=shape).astype(np.float32)


def _lower(rng):
    L = np.tril(rng.normal(size=(N, 3, 3))).astype(np.float32)
    L[:, [0, 1, 2], [0, 1, 2]] = rng.uniform(0.5, 2.0, size=(N, 3))
    return L


def _quat(rng):
    q = rng.normal(size=(N, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _twists(rng):
    """Rotations of order 1, and a quarter below 1e-6 rad (the Taylor
    branches). Between those, both packages evaluate (1 - cos t) / t^2 with
    float32 cancellation and differ by their cos rounding, so that band is
    not a parity case."""
    tw = _vec(rng, N, 6)
    tw[: N // 4, :3] *= 1e-7
    return tw


# (name, function name in both modules, input maker)
CASES = [
    ("smallmat", "matmul3", lambda r: (_vec(r, N, 3, 3), _vec(r, N, 3, 3))),
    ("smallmat", "rotate_mat3", lambda r: (_rot(r), _sep_spd(r))),
    ("smallmat", "matvec3", lambda r: (_rot(r)[0], _vec(r, N, 3, scale=20.0))),
    ("smallmat", "rot_times_skew", lambda r: (_rot(r)[0], _vec(r, N, 3, scale=20.0))),
    ("smallmat", "cholesky3", lambda r: (_sep_spd(r),)),
    ("smallmat", "solve_lower3", lambda r: (_lower(r), _vec(r, N, 3))),
    ("smallmat", "solve_lower3", lambda r: (_lower(r), _vec(r, N, 3, 6))),
    ("lie", "skew", lambda r: (_vec(r, N, 3),)),
    ("lie", "so3_exp", lambda r: (_twists(r)[:, :3],)),
    ("lie", "quat_normalize", lambda r: (_vec(r, N, 4),)),
    ("lie", "quat_to_matrix", lambda r: (_quat(r),)),
    ("lie", "matrix_to_quat", lambda r: (_rot(r),)),
    ("lie", "quat_mul", lambda r: (_quat(r), _quat(r))),
    ("lie", "quat_conj", lambda r: (_quat(r),)),
    ("lie", "quat_rotate", lambda r: (_quat(r), _vec(r, N, 3))),
    ("lie", "so3_log", lambda r: (_quat(r),)),
    ("lie", "se3_exp", lambda r: (_twists(r),)),
    ("lie", "se3_log", lambda r: (np.stack([rigid(r, 0.8, 2.0) for _ in range(N)]),)),
    ("lie", "make_transform", lambda r: (_rot(r), _vec(r, N, 3))),
    ("lie", "transform_inverse", lambda r: (np.stack([rigid(r, 0.8, 2.0) for _ in range(N)]),)),
    ("eigh3", "eigvalsh3", lambda r: (_sep_spd(r),)),
    ("eigh3", "eigh3", lambda r: (_sep_spd(r),)),
    ("eigh3", "smallest_eigenvector3", lambda r: (_sep_spd(r),)),
    ("eigh3", "plane_regularize", lambda r: (_sep_spd(r),)),
    ("eigh3", "normalize_covariance", lambda r: (_sep_spd(r) * 1e-2,)),
    ("eigh3", "spd_log", lambda r: (_sep_spd(r),)),
    ("eigh3", "spd_exp", lambda r: (_sep_spd(r),)),
    ("eigh3", "inv3", lambda r: (_sep_spd(r),)),
    ("eigh3", "ensure_symmetric", lambda r: (_vec(r, N, 3, 3),)),
    ("eigh3", "floor_eigenvalues", lambda r: (_sep_spd(r) - 0.3 * np.eye(3, dtype=np.float32),)),
    ("eigh3", "spd_inverse", lambda r: (_sep_spd(r),)),
]
MODULES = {"smallmat": (j_sm, t_sm), "lie": (j_lie, t_lie), "eigh3": (j_eigh3, t_eigh3)}


@pytest.mark.parametrize("module,fn,make", CASES, ids=[f"{m}.{f}-{i}" for i, (m, f, _) in enumerate(CASES)])
def test_matches_jax(module, fn, make):
    rng = np.random.default_rng(7)
    args = make(rng)
    jm, tm = MODULES[module]
    pairs = [both(a) for a in args]
    out_j = getattr(jm, fn)(*[p[0] for p in pairs])
    out_t = getattr(tm, fn)(*[p[1] for p in pairs])
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    assert len(out_j) == len(out_t)
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(np_(b), np_(a), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pd", [True, False])
def test_solve_psd_matches_jax(pd):
    """The PSD solve and its zero-step fallback on a non-PD matrix."""
    rng = np.random.default_rng(11)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    H = A @ A.T + 6 * np.eye(6, dtype=np.float32) if pd else -np.eye(6, dtype=np.float32)
    b = rng.normal(size=6).astype(np.float32)
    (Hj, Ht), (bj, bt) = both(H), both(b)
    xj, okj = j_sm.solve_psd(Hj, bj)
    xt, okt = t_sm.solve_psd(Ht, bt)
    assert bool(okj) == bool(okt) == pd
    np.testing.assert_allclose(np_(xt), np_(xj), rtol=RTOL, atol=ATOL)
    if not pd:
        assert not np_(xt).any()


def test_solve_psd_batched():
    """A batch of candidate systems solves like each one alone."""
    rng = np.random.default_rng(12)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    H = A @ A.T + np.eye(6, dtype=np.float32)
    lams = np.array([1e-3, 1.0, -50.0], np.float32)  # the last one is not PD
    Hs = H[None] + lams[:, None, None] * np.eye(6, dtype=np.float32)
    b = rng.normal(size=6).astype(np.float32)
    _, Ht = both(Hs)
    _, bt = both(np.broadcast_to(b, (3, 6)))
    xt, okt = t_sm.solve_psd(Ht, bt)
    assert np_(okt).tolist() == [True, True, False]
    for i in range(3):
        xj, _ = j_sm.solve_psd(both(Hs[i])[0], both(b)[0])
        np.testing.assert_allclose(np_(xt[i]), np_(xj), rtol=RTOL, atol=ATOL)
