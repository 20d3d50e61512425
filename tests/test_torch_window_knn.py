"""The Morton-window self-k-NN of the port against the JAX package, on the
CPU (the plain window search; the kernel is held to it on the card in
``tests/test_torch_cuda_kernels.py``).

  * ``morton_codes`` bit-equal to JAX's, invalid and non-finite points
    included, in both axis orders;
  * a scene where every Morton code is distinct (so the sort order is the
    same whatever the sort's stability): one window pass and the two-pass
    ``window_self_knn`` equal to JAX's, indices exactly, squared distances
    within 1e-6 relative;
  * the recall envelope of ``tests/test_range_image_knn.py:94`` on the
    synthetic HDL scan: recall against the exact k-NN above 0.70, reported
    distances exact for the reported pairs (1e-4).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import both, np_

from sycl_points_tpu.ops import window_knn as j_win
from sycl_points_tpu_torch.ops import window_knn as t_win
from sycl_points_tpu_torch.ops.knn import self_knn

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
from synthetic_velodyne import World, scan_at  # noqa: E402


@pytest.mark.parametrize("axis_order", [(0, 1, 2), (2, 0, 1)])
def test_morton_codes_bit_equal(axis_order):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-60, 60, size=(3000, 3)).astype(np.float32)
    pts[::97] = np.nan
    pts[5, 1] = np.inf
    mask = rng.uniform(size=3000) > 0.1
    (jp, tp), (jm, tm) = both(pts), both(mask)
    for cell in (0.5, 0.1, 2.0):
        np.testing.assert_array_equal(np_(t_win.morton_codes(tp, tm, cell, axis_order)),
                                      np.asarray(j_win.morton_codes(jp, jm, cell, axis_order)))


def _distinct_scene():
    """1500 points in distinct 0.5 m cells of a 16^3 block, shuffled, some
    masked: every valid point's Morton code is its own."""
    rng = np.random.default_rng(4)
    cells = rng.choice(16**3, size=1500, replace=False)
    ijk = np.stack([cells // 256, (cells // 16) % 16, cells % 16], 1)
    pts = ((ijk + rng.uniform(0.1, 0.9, size=ijk.shape)) * 0.5).astype(np.float32)
    mask = rng.uniform(size=len(pts)) > 0.05
    return pts, mask


def test_window_pass_exact_on_distinct_codes():
    pts, mask = _distinct_scene()
    (jp, tp), (jm, tm) = both(pts), both(mask)
    codes = np_(t_win.morton_codes(tp, tm, 0.5))
    assert len(np.unique(codes[mask])) == mask.sum()
    for order in ((0, 1, 2), (2, 0, 1)):
        ji, jd = j_win._window_pass(jp, jm, 6, 16, 0.5, order)
        ti, td = t_win.window_pass(tp, tm, 6, 16, 0.5, order)
        np.testing.assert_array_equal(np_(ti), np.asarray(ji))
        np.testing.assert_allclose(np_(td), np.asarray(jd), rtol=1e-6, atol=1e-6)
    jr, tr = j_win.window_self_knn(jp, jm, 6, window=16), t_win.window_self_knn(tp, tm, 6, window=16)
    np.testing.assert_array_equal(np_(tr.indices), np.asarray(jr.indices))
    np.testing.assert_allclose(np_(tr.distances), np.asarray(jr.distances), rtol=1e-6, atol=1e-6)


def test_scan_recall_envelope():
    T = np.eye(4)
    T[:3, 3] = [0, 0, 1.8]
    pts = scan_at(World(), T, n_az=1024, n_rings=32, seed=3)[:8192].astype(np.float32)
    p = torch.from_numpy(pts)
    m = torch.ones(len(pts), dtype=torch.bool)
    ref_i = np.sort(np_(self_knn(p, m, 10).indices), axis=1)
    r = t_win.window_self_knn(p, m, 10, window=64, passes=2)
    got, d = np_(r.indices), np_(r.distances)
    hits = np.mean([len(np.intersect1d(ref_i[i], got[i])) / 10.0 for i in range(0, len(pts), 13)])
    assert hits > 0.70, hits
    for i in range(0, len(pts), 991):
        for j, idx in enumerate(got[i]):
            if np.isfinite(d[i, j]):
                assert abs(d[i, j] - np.sum((pts[i] - pts[idx]) ** 2)) < 1e-4
