"""Ragged targets: the extent of a prepared target, on the CPU.

``cuda_knn.prep_target`` / ``prep_targets`` record each stream's extent, 1 +
the index of its last valid row (0 for a stream with none), made with torch
ops on the target's device; the cluster kernels sweep only ``[0, extent)``.
Held here:

  * the extent of prefix, scattered, all-masked and all-valid masks, and of
    masks whose last valid row sits at 0, 31, 32, 511, 512 and M - 1, alone
    and stacked as the streams of one fleet, with every row from it on +inf;
  * the invariant the kernels rest on: the batched plain versions on each
    stream's target cut at its extent equal the uncut ones bit for bit;
  * the fleet's ``BruteForceKNN`` on ``[B, M, 3]`` targets with ragged masks
    against JAX's brute-force search of each stream (``use_pallas=False``,
    as JAX's fleet runs it under ``vmap``): indices equal except ties within
    1e-6, d2 within 1e-5 (``tests/test_torch_knn.py``'s nn1 tolerances: both
    take the difference form); and ``self_knn_streams`` against JAX's
    ``approx_knn`` of each stream: sets equal beyond members within 2e-4 of
    the k-th distance, d2 within 2e-4 (that file's k-NN tolerances: JAX
    expands ``|q|^2 + |t|^2 - 2 q.t``, which rounds differently at +-10 m).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import np_

from sycl_points_tpu.ops import knn as j_knn
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops import knn as t_knn
from sycl_points_tpu_torch.utils import lie_np

TIE = 1e-6
NN1_ATOL = 1e-5
KNN_ATOL = 2e-4
M = 1000  # prepared to Mp = 1024: M off the kernels' 512-row tile
# The fleet's extents in one launch: none valid, one row, either side of a
# 32-row unit and of the 512-row tile, a submap extraction's ~430, all rows.
RAGGED = (0, 1, 31, 33, 430, 511, 513, 2048)


def _last_at(i):
    m = np.zeros(M, bool)
    m[: i + 1 : 3] = True
    m[i] = True
    return m


MASKS = {
    "prefix 430": lambda rng: np.arange(M) < 430,
    "scattered": lambda rng: rng.uniform(size=M) < 0.05,
    "all masked": lambda rng: np.zeros(M, bool),
    "all valid": lambda rng: np.ones(M, bool),
    **{f"last valid at {i}": (lambda rng, i=i: _last_at(i)) for i in (0, 31, 32, 511, 512, M - 1)},
}


def _extent(mask: np.ndarray) -> int:
    rows = np.flatnonzero(mask)
    return int(rows[-1]) + 1 if rows.size else 0


def _check_prepped(prep, masks):
    ext = np_(prep.extent)
    assert prep.extent.dtype == torch.int32 and ext.shape == (len(masks),)
    xyz = np_(prep.xyz).reshape(len(masks), 3, -1)
    for b, m in enumerate(masks):
        assert ext[b] == _extent(m)
        assert np.isinf(xyz[b, :, ext[b]:]).all() and (xyz[b, :, ext[b]:] > 0).all()


@pytest.mark.parametrize("name", list(MASKS))
def test_prep_target_extent(name):
    rng = np.random.default_rng(7)
    mask = MASKS[name](rng)
    pts = torch.from_numpy(rng.uniform(-10, 10, (M, 3)).astype(np.float32))
    _check_prepped(cuda_knn.prep_target(pts, torch.from_numpy(mask)), [mask])
    # a uint8 mask gives the same extent
    _check_prepped(cuda_knn.prep_target(pts, torch.from_numpy(mask.astype(np.uint8))), [mask])


def test_prep_targets_extent_a_stream():
    rng = np.random.default_rng(8)
    masks = [make(rng) for make in MASKS.values()]
    pts = torch.from_numpy(rng.uniform(-10, 10, (len(masks), M, 3)).astype(np.float32))
    prep = cuda_knn.prep_targets(pts, torch.from_numpy(np.stack(masks)))
    _check_prepped(prep, masks)
    for b, m in enumerate(masks):
        single = cuda_knn.prep_target(pts[b], torch.from_numpy(m))
        assert torch.equal(single.extent, prep.extent[b : b + 1])
    # an empty target has extent 0; a hand-built target has none
    empty = cuda_knn.prep_targets(torch.zeros(3, 0, 3), torch.zeros(3, 0, dtype=torch.bool))
    assert empty.extent.tolist() == [0, 0, 0] and tuple(empty.xyz.shape) == (3, 3, 0)
    assert cuda_knn.PreppedTarget(prep.xyz, prep.M).extent is None


def _ragged(rng, m, scattered: bool):
    """``len(RAGGED)`` streams of ``m`` rows, stream b valid below
    ``min(RAGGED[b], m)`` (about 40% of those rows masked at random when
    ``scattered``)."""
    B = len(RAGGED)
    pts = rng.uniform(-10, 10, (B, m, 3)).astype(np.float32)
    mask = np.arange(m)[None, :] < np.minimum(RAGGED, m)[:, None]
    if scattered:
        mask &= rng.uniform(size=(B, m)) < 0.6
    return pts, mask


@pytest.mark.parametrize("scattered", [False, True])
@pytest.mark.parametrize("k", [1, 10, 20])
def test_plain_cut_at_extent_equals_uncut(k, scattered):
    """Each stream's batched plain search against its target cut at its
    extent equals the search of the whole target, bit for bit."""
    rng = np.random.default_rng(k + 10 * scattered)
    pts, mask = _ragged(rng, 2048, scattered)
    B = pts.shape[0]
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    q = torch.from_numpy(rng.uniform(-10, 10, (B, 60, 3)).astype(np.float32))
    poses = torch.from_numpy(np.stack([lie_np.se3_exp(rng.normal(scale=0.1, size=6)) for _ in range(B)])
                             .astype(np.float32))
    ext = cuda_knn.prep_targets(tp, tm).extent.tolist()
    i1, d1 = cuda_knn.nn1_batched_plain(tp, tm, q, poses)
    ik, dk = cuda_knn.knn_k_batched_plain(tp, tm, q, k)
    for b, e in enumerate(ext):
        ci, cd = cuda_knn.nn1_plain(tp[b, :e], tm[b, :e], q[b], poses[b])
        assert torch.equal(ci, i1[b]) and torch.equal(cd, d1[b])
        ci, cd = cuda_knn.knn_k_plain(tp[b, :e], tm[b, :e], q[b], k)
        assert torch.equal(ci, ik[b]) and torch.equal(cd, dk[b])


def _check_nn1(ti, td, ji, jd):
    assert cuda_knn.nn1_mismatches(torch.from_numpy(ti), torch.from_numpy(td), torch.from_numpy(ji),
                                   torch.from_numpy(jd), TIE) == 0
    np.testing.assert_allclose(td, jd, rtol=0, atol=NN1_ATOL)


@pytest.mark.parametrize("scattered", [False, True])
@pytest.mark.parametrize("with_pose", [False, True])
def test_fleet_brute_force_matches_jax_per_stream(with_pose, scattered):
    rng = np.random.default_rng(30 + 2 * with_pose + scattered)
    pts, mask = _ragged(rng, 2048, scattered)
    B = pts.shape[0]
    q = rng.uniform(-10, 10, (B, 200, 3)).astype(np.float32)
    poses = np.stack([lie_np.se3_exp(rng.normal(scale=0.1, size=6)) for _ in range(B)]).astype(np.float32)
    knn = t_knn.BruteForceKNN(points=torch.from_numpy(pts), mask=torch.from_numpy(mask)).prepped()
    assert knn.target.extent.tolist() == [_extent(m) for m in mask]
    res = knn.search(torch.from_numpy(q), 1, torch.from_numpy(poses) if with_pose else None)

    def j_search(p, m, qq, T):
        return j_knn.BruteForceKNN(points=p, mask=m, use_pallas=False).search(qq, 1, T if with_pose else None)

    jr = jax.vmap(j_search)(pts, mask, q, poses)
    ti, td, ji, jd = (np.array(np_(x)[..., 0]) for x in (res.indices, res.distances, jr.indices, jr.distances))
    for b in range(B):
        _check_nn1(ti[b], td[b], ji[b], jd[b])
    assert np.isinf(td[0]).all() and (ti[0] == 0).all()


@pytest.mark.parametrize("scattered", [False, True])
@pytest.mark.parametrize("k", [10, 20])
def test_self_knn_streams_matches_jax_per_stream(k, scattered):
    rng = np.random.default_rng(50 + k + scattered)
    pts, mask = _ragged(rng, 1100, scattered)
    tr = t_knn.self_knn_streams(torch.from_numpy(pts), torch.from_numpy(mask), k)
    for b in range(pts.shape[0]):
        jr = j_knn.approx_knn(pts[b], mask[b], pts[b], k)
        rows = mask[b]
        ti, td, ji, jd = (torch.from_numpy(np_(x)[rows]) for x in (tr.indices[b], tr.distances[b],
                                                                    jr.indices, jr.distances))
        assert cuda_knn.knn_mismatches(ti, td, ji, jd, KNN_ATOL) == 0
        fin = np.isfinite(np_(jd))
        assert (np.isfinite(np_(td)) == fin).all()
        np.testing.assert_allclose(np_(td)[fin], np_(jd)[fin], rtol=0, atol=KNN_ATOL)
