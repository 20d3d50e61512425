"""Parity of the port's nearest-neighbour search with the JAX package.

nn1 is held against the Pallas kernel run in interpret mode
(``nn1_pallas(..., interpret=True)``), which uses the same exact difference
form: indices equal except ties within 1e-6, distances within atol=1e-5.

The self-k-NN is held against ``approx_knn``, exact on the CPU but computed
in the expanded form |q|^2 + |t|^2 - 2 q.t, which rounds differently: over
valid query rows and finite entries, sorted distances within atol=2e-4 and
index sets equal except members within that atol of the k-th distance.
Clouds span +-10 m, where the expanded form's cancellation stays below that
atol.
"""

import numpy as np
import pytest

from _torch_parity import both, np_, rigid

from sycl_points_tpu.ops import knn as j_knn
from sycl_points_tpu.ops.pallas_knn import nn1_pallas
from sycl_points_tpu.ops.transform import transform_points as j_transform
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops import knn as t_knn

TIE = 1e-6
NN1_ATOL = 1e-5
KNN_ATOL = 2e-4


def _cloud(rng, n, extent, masked_every=0):
    pts = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    if masked_every:
        mask[::masked_every] = False
    return pts, mask


def _check_nn1(ti, td, ji, jd):
    ti, td, ji, jd = (both(x)[1] for x in (np_(ti), np_(td), np_(ji), np_(jd)))
    assert cuda_knn.nn1_mismatches(ti, td, ji, jd, TIE) == 0
    np.testing.assert_allclose(np_(td), np_(jd), rtol=0, atol=NN1_ATOL)


@pytest.mark.parametrize(
    "m,q,masked_every,with_pose",
    [(3000, 500, 5, True), (2048, 300, 0, False), (700, 1024, 3, True)],
)
def test_nn1_matches_pallas_interpret(m, q, masked_every, with_pose):
    rng = np.random.default_rng(m)
    tgt, mask = _cloud(rng, m, 20.0, masked_every)
    qry, _ = _cloud(rng, q, 20.0)
    (tj, tt), (mj, mt), (qj, qt) = both(tgt), both(mask), both(qry)
    pose = rigid(rng, 0.1, 1.0) if with_pose else None
    pj, pt = both(pose) if with_pose else (None, None)

    ji, jd = nn1_pallas(tj, mj, qj if pose is None else j_transform(qj, pj), interpret=True)
    ti, td = cuda_knn.nn1(tt, mt, qt, pt)
    _check_nn1(ti, td, ji, jd)
    assert mask[np_(ti)].all()

    # The search structure of the ICP loop gives the same answer.
    res = t_knn.BruteForceKNN.build(_TCloud(tt, mt)).prepped().search(qt, 1, pose=pt)
    _check_nn1(res.indices[:, 0], res.distances[:, 0], ji, jd)


def test_nn1_all_masked():
    rng = np.random.default_rng(5)
    tgt, _ = _cloud(rng, 64, 5.0)
    mask = np.zeros(64, bool)
    (tj, tt), (mj, mt), (qj, qt) = both(tgt), both(mask), both(tgt[:8])
    ji, jd = nn1_pallas(tj, mj, qj, interpret=True)
    ti, td = cuda_knn.nn1(tt, mt, qt)
    assert np.isinf(np_(jd)).all() and np.isinf(np_(td)).all()
    assert (np_(ti) == 0).all() and (np_(ji) == 0).all()


class _TCloud:
    def __init__(self, points, mask):
        self.points, self.mask = points, mask


def _check_knn(ti, td, ji, jd, rows):
    ti, td, ji, jd = (both(np_(x)[rows])[1] for x in (ti, td, ji, jd))
    assert cuda_knn.knn_mismatches(ti, td, ji, jd, KNN_ATOL) == 0
    fin = np.isfinite(np_(jd))
    assert (np.isfinite(np_(td)) == fin).all()
    np.testing.assert_allclose(np_(td)[fin], np_(jd)[fin], rtol=0, atol=KNN_ATOL)


@pytest.mark.parametrize("n,k,masked_every", [(3000, 10, 7), (1500, 16, 0), (400, 4, 2)])
def test_self_knn_matches_approx_knn(n, k, masked_every):
    rng = np.random.default_rng(n + k)
    pts, mask = _cloud(rng, n, 10.0, masked_every)
    (pj, pt), (mj, mt) = both(pts), both(mask)
    jr = j_knn.approx_knn(pj, mj, pj, k)
    tr = t_knn.self_knn(pt, mt, k)
    assert tuple(tr.indices.shape) == (n, k) and tuple(tr.distances.shape) == (n, k)
    _check_knn(tr.indices, tr.distances, jr.indices, jr.distances, mask)
    # every returned neighbour is a valid target, listed nearest first
    td = np_(tr.distances)
    assert mask[np_(tr.indices)[np.isfinite(td)]].all()
    assert (np.diff(td, axis=1) >= 0).all()


def test_self_knn_fewer_valid_than_k():
    """Slots with no valid neighbour come out as idx 0, d2 = inf."""
    rng = np.random.default_rng(3)
    pts, _ = _cloud(rng, 50, 5.0)
    mask = np.zeros(50, bool)
    mask[:6] = True
    (pj, pt), (mj, mt) = both(pts), both(mask)
    tr = t_knn.self_knn(pt, mt, 10)
    jr = j_knn.approx_knn(pj, mj, pj, 10)
    assert np.isinf(np_(tr.distances)[:, 6:]).all() and (np_(tr.indices)[:, 6:] == 0).all()
    assert np.isinf(np_(jr.distances)[:, 6:]).all()
    _check_knn(tr.indices, tr.distances, jr.indices, jr.distances, mask)


def test_brute_force_and_radius_search_match_jax():
    rng = np.random.default_rng(21)
    tgt, mask = _cloud(rng, 1200, 10.0, 4)
    qry, _ = _cloud(rng, 200, 10.0)
    pose = rigid(rng, 0.05, 0.5)
    (tj, tt), (mj, mt), (qj, qt), (pj, pt) = both(tgt), both(mask), both(qry), both(pose)
    jr = j_knn.brute_force_knn(tj, mj, qj, 5, pose=pj)
    tr = t_knn.brute_force_knn(tt, mt, qt, 5, pose=pt)
    _check_knn(tr.indices, tr.distances, jr.indices, jr.distances, np.ones(200, bool))

    jk = j_knn.BruteForceKNN.build(_JCloud(tj, mj), use_pallas=False)
    tk = t_knn.BruteForceKNN.build(_TCloud(tt, mt))
    jrr = jk.radius_search(qj, 1.0, 6, pose=pj)
    trr = tk.radius_search(qt, 1.0, 6, pose=pt)
    within = np.isfinite(np_(jrr.distances))
    np.testing.assert_array_equal(np.isfinite(np_(trr.distances)), within)
    assert ((np_(trr.indices) == -1) == ~within).all()
    _check_knn(trr.indices, trr.distances, jrr.indices, jrr.distances, np.ones(200, bool))


class _JCloud:
    def __init__(self, points, mask):
        self.points, self.mask = points, mask
