"""``CoarseKNN`` of the port against the JAX package and against brute
force, on the CPU (the plain refine; the kernel is held to it on the card in
``tests/test_torch_cuda_kernels.py``).

  * ``tests/test_coarse_knn.py``'s scenarios: the certified fraction above
    0.9 on a LiDAR-like cloud, every certified query exact against the
    port's brute force on the sorted layout (squared distances equal to
    1e-6 relative; indices equal but for ties within 1e-6), no uncertified
    result nearer than the exact one; the counters (overflow, lost cells)
    fire and void every certificate, equal to JAX's; a pose equals the
    queries moved beforehand;
  * the stable-tie scene: a lattice where most cells' lower bound is 0 for
    every query, so that the P + 1 best cells are decided by the cell index
    alone: indices, distances and certificates equal to JAX's (distances
    within 1e-6 relative, indices but for ties within 1e-6).
"""

import numpy as np
import pytest
import torch

from _torch_parity import both, clouds, np_

from sycl_points_tpu.ops.coarse_knn import CoarseKNN as JCoarse
from sycl_points_tpu_torch.ops.coarse_knn import CoarseKNN as TCoarse
from sycl_points_tpu_torch.ops.knn import brute_force_knn
from sycl_points_tpu_torch.ops.transform import transform_points

TIE = 1e-6


def _pts(m, seed=0, span=40.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-span, span, size=(m, 3)).astype(np.float32)
    pts[:, 2] *= 0.1  # LiDAR-like: mostly planar
    return pts


def _assert_same(ji, jd, ti, td, pts_sorted, queries):
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=TIE, atol=TIE)
    np.testing.assert_array_equal(ti[~fin], ji[~fin])
    for q, s in zip(*np.nonzero((ji != ti) & fin)):
        d = np.sum((pts_sorted[ti[q, s]] - queries[q]) ** 2)
        assert abs(d - jd[q, s]) <= TIE * max(1.0, jd[q, s]), (q, s)


@pytest.mark.parametrize("k", [1, 10])
def test_certified_results_are_exact(k):
    _, tgt = clouds(_pts(20000, seed=1))
    q = torch.from_numpy(_pts(512, seed=2))
    ck = TCoarse.build(tgt, coarse_cell=8.0, max_per_cell=256)
    assert int(ck.cells_lost) == 0 and int(ck.overflow) == 0
    res, cert = ck.search(q, k=k, top_cells=8)
    exact = brute_force_knn(ck.points, ck.mask, q, k)
    cert_np = np_(cert)
    assert cert_np.mean() > 0.9, cert_np.mean()
    ti, td, ei, ed = (np_(x) for x in (res.indices, res.distances, exact.indices, exact.distances))
    _assert_same(ei[cert_np], ed[cert_np], ti[cert_np], td[cert_np], np_(ck.points), np_(q)[cert_np])
    # no uncertified result is nearer than the exact one
    assert (np.sqrt(td) >= np.sqrt(ed) - 1e-6).all()


def test_budget_counters_fire_and_void_certificates():
    (jt, tt), (_, tq) = clouds(_pts(5000, seed=3, span=10.0)), clouds(_pts(64, seed=6, span=10.0))
    ck, jk = TCoarse.build(tt, coarse_cell=10.0, max_per_cell=8), JCoarse.build(jt, coarse_cell=10.0,
                                                                               max_per_cell=8)
    assert int(ck.overflow) == int(jk.overflow) > 0
    _, cert = ck.search(tq.points, k=1)
    assert not np_(cert).any()
    ck2 = TCoarse.build(tt, coarse_cell=0.2, cells_capacity=256)
    jk2 = JCoarse.build(jt, coarse_cell=0.2, cells_capacity=256)
    assert int(ck2.cells_lost) == int(jk2.cells_lost) > 0
    _, cert2 = ck2.search(tq.points, k=1)
    assert not np_(cert2).any()


def test_search_with_pose():
    _, tgt = clouds(_pts(8000, seed=4))
    q = torch.from_numpy(_pts(128, seed=5))
    T = torch.eye(4)
    T[:3, 3] = torch.tensor([1.0, -2.0, 0.3])
    ck = TCoarse.build(tgt, coarse_cell=8.0, max_per_cell=256)
    posed, cert_p = ck.search(q, k=1, pose=T)
    manual, cert_m = ck.search(transform_points(q, T), k=1)
    assert torch.equal(posed.indices, manual.indices) and torch.equal(cert_p, cert_m)


@pytest.mark.parametrize("k", [1, 4])
def test_stable_ties_match_jax(k):
    """A 12 x 12 x 3 lattice of 1 m cells, 27 points each, and queries inside
    it: with a 1 m margin every nearby cell's bound is 0, more of them than
    the 6 selected, so only the tie order picks the cells."""
    rng = np.random.default_rng(9)
    cells = np.stack(np.meshgrid(np.arange(12), np.arange(12), np.arange(3), indexing="ij"), -1).reshape(-1, 3)
    offs = (np.stack(np.meshgrid(*[np.array([0.2, 0.5, 0.8])] * 3, indexing="ij"), -1).reshape(-1, 3))
    pts = (cells[:, None, :] + offs[None]).reshape(-1, 3) + rng.normal(scale=0.01, size=(len(cells) * 27, 3))
    pts = pts[rng.permutation(len(pts))].astype(np.float32)
    qry = rng.uniform([1, 1, 0.5], [11, 11, 2.5], size=(200, 3)).astype(np.float32)
    (jt, tt) = clouds(pts)
    jk = JCoarse.build(jt, coarse_cell=1.0, max_per_cell=32)
    tk = TCoarse.build(tt, coarse_cell=1.0, max_per_cell=32)
    np.testing.assert_array_equal(np_(tk.counts), np_(jk.counts))
    np.testing.assert_array_equal(np_(tk.starts), np_(jk.starts))
    np.testing.assert_allclose(np_(tk.centroids), np_(jk.centroids), rtol=1e-6, atol=1e-6)
    jq, tq = both(qry)
    (jres, jcert), (tres, tcert) = (jk.search(jq, k, top_cells=6, margin=1.0),
                                    tk.search(tq, k, top_cells=6, margin=1.0))
    lb_zero = (tk.select_cells(tq, 6, 1.0)[1] == 0).float().mean()
    assert lb_zero > 0.9  # the 7th cell's bound is 0 too: a tie decides
    _assert_same(np_(jres.indices), np_(jres.distances), np_(tres.indices), np_(tres.distances), np_(tk.points),
                 qry)
    np.testing.assert_array_equal(np_(tcert), np_(jcert))
