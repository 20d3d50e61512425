"""The fused pair preprocess of the port against the JAX package and against
two single-cloud preprocesses, on the CPU (``tests/test_pair_preprocess.py``'s
two tests on both packages).

  * ``voxel_downsample_pair``: each cloud's voxels equal the port's
    ``voxel_downsample`` of it bit for bit (the same stable sort order and
    row-order segment sums), and JAX's pair as sorted rows within 1e-5;
  * ``preprocess_pair``: the voxels, covariances and normals equal two
    single-cloud passes (``voxel_downsample``, ``self_knn``,
    ``estimate_covariances``, ``extract_normals``) bit for bit, and JAX's
    fused pair as sorted rows: points 1e-5, covariances 1e-4, normals (up to
    sign) 1e-3, the JAX test's bounds.
"""

import numpy as np
import torch

from _torch_parity import clouds, np_

from sycl_points_tpu.ops import pair_preprocess as j_pair
from sycl_points_tpu_torch.ops import pair_preprocess as t_pair
from sycl_points_tpu_torch.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu_torch.ops.knn import self_knn
from sycl_points_tpu_torch.ops.voxel import voxel_downsample


def _clouds(seed, n=900, cap=1024, lo=-8.0, hi=8.0):
    rng = np.random.default_rng(seed)
    return clouds(rng.uniform(lo, hi, size=(n, 3)).astype(np.float32), capacity=cap)


def _sorted_valid(pts, mask, *cols):
    keep = np.asarray(mask)
    order = np.lexsort(np.asarray(pts)[keep].T)
    return [np.asarray(c)[keep][order] for c in (pts, *cols)]


def test_voxel_downsample_pair_matches_single_and_jax():
    (ja, ta), (jb, tb) = _clouds(0), _clouds(1, lo=-30.0, hi=5.0)
    jad, jbd = j_pair.voxel_downsample_pair(ja, jb, 0.5, 1024)
    tad, tbd = t_pair.voxel_downsample_pair(ta, tb, 0.5, 1024)
    for fused, raw, jf in ((tad, ta, jad), (tbd, tb, jbd)):
        single = voxel_downsample(raw, 0.5, out_capacity=1024)
        assert torch.equal(fused.mask, single.mask)
        assert torch.equal(fused.points[fused.mask], single.points[single.mask])
        np.testing.assert_allclose(_sorted_valid(np_(fused.points), np_(fused.mask))[0],
                                   _sorted_valid(np_(jf.points), np_(jf.mask))[0], atol=1e-5)


def test_preprocess_pair_features_match_single_and_jax():
    (ja, ta), (jb, tb) = _clouds(2), _clouds(3)
    jaf, jbf = j_pair.preprocess_pair(ja, jb, 0.5, 1024, k=8)
    taf, tbf = t_pair.preprocess_pair(ta, tb, 0.5, 1024, k=8)
    for fused, raw, jf in ((taf, ta, jaf), (tbf, tb, jbf)):
        ref = voxel_downsample(raw, 0.5, out_capacity=1024)
        covs = estimate_covariances(ref.points, self_knn(ref.points, ref.mask, 8))
        normals = extract_normals(ref.points, covs)
        m = fused.mask
        assert torch.equal(m, ref.mask)
        assert torch.equal(fused.points[m], ref.points[m])
        assert torch.equal(fused.covs[m], covs[m])
        assert torch.equal(fused.normals[m], normals[m])
        tp, tc, tn = _sorted_valid(np_(fused.points), np_(m), np_(fused.covs), np_(fused.normals))
        jp, jc, jn = _sorted_valid(np_(jf.points), np_(jf.mask), np_(jf.covs), np_(jf.normals))
        np.testing.assert_allclose(tp, jp, atol=1e-5)
        np.testing.assert_allclose(tc, jc, atol=1e-4)
        np.testing.assert_allclose(np.abs(tn), np.abs(jn), atol=1e-3)
