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
    distances exact for the reported pairs (1e-4);
  * ``morton_codes_passes_plain`` (both axis orders in one call) bit-equal
    to JAX's ``morton_codes`` of each order;
  * at k = 6, 20 and 64, ``window_union_plain`` of JAX's two passes and the
    port's whole ``window_self_knn`` equal to JAX's ``window_self_knn``
    (indices exactly, squared distances within 1e-6 relative and absolute),
    on the distinct-code scene and on a scene where a pass-1 padding entry
    (3e38, the index of the clipped partner at sorted position 0 or N - 1)
    shadows the same index in pass 2: points in cells of 1e19 m, so that
    most window distances overflow to +inf and a pass-2 entry of that index
    with a value other than 3e38 turns into a 3e38 duplicate (the test
    asserts the case occurs).
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

from sycl_points_tpu_torch.scripts.window_scenes import SHADOW_CELL, shadow_scene, shadowed

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


def test_morton_codes_passes_plain_bit_equal():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-80, 80, size=(2500, 3)).astype(np.float32)
    pts[::89] = np.nan
    pts[7, 2] = -np.inf
    mask = rng.uniform(size=2500) > 0.1
    (jp, tp), (jm, tm) = both(pts), both(mask)
    got = np_(t_win.morton_codes_passes_plain(tp, tm, 0.5))
    assert got.shape == (2, 2500)
    for p, order in enumerate(t_win.AXES):
        np.testing.assert_array_equal(got[p], np.asarray(j_win.morton_codes(jp, jm, 0.5, order)))


@pytest.mark.parametrize("k", [6, 20, 64])
@pytest.mark.parametrize("scene", ["distinct", "shadow"])
def test_window_union_and_self_knn_match_jax(scene, k):
    if scene == "distinct":
        (pts, mask), window, cell = _distinct_scene(), max(16, k // 2), 0.5
    else:
        (pts, mask, window), cell = shadow_scene(k), SHADOW_CELL
    (jp, tp), (jm, tm) = both(pts), both(mask)
    j1 = [np.asarray(a) for a in j_win._window_pass(jp, jm, k, window, cell, t_win.AXES[0])]
    j2 = [np.asarray(a) for a in j_win._window_pass(jp, jm, k, window, cell, t_win.AXES[1])]
    if scene == "shadow":
        assert shadowed(*j1, *j2) > 0
    jr = j_win.window_self_knn(jp, jm, k, window=window, cell_size=cell)
    ui, ud = t_win.window_union_plain(*(torch.from_numpy(np.array(a)) for a in (*j1, *j2)), k)
    tr = t_win.window_self_knn(tp, tm, k, window=window, cell_size=cell)
    for i, d in ((ui, ud), (tr.indices, tr.distances)):
        np.testing.assert_array_equal(np_(i), np.asarray(jr.indices))
        np.testing.assert_allclose(np_(d), np.asarray(jr.distances), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [10, 64])
def test_window_smem_and_a_window_above_the_card_limit_on_the_cpu(k):
    """``window_smem`` mirrors the kernels' tile (csrc/window_knn.cu: 128
    positions a block up to k = 16, 64 above, the union form's keys and
    counts a warp), and the CPU's plain path takes a window whose tile would
    not fit the card: on 200 points of the distinct-code scene such a window
    covers the whole cloud, so every valid row is the exact k-NN, the point
    itself left out."""
    K = t_win.cuda_knn.instance_k(k)
    warp = K > 16
    for w in (8, 64, 7000):
        rows = (64 if warp else 128) + 2 * w
        assert t_win.window_smem(w, k) == 16 * rows
        assert t_win.window_smem(w, k, union=True) == 16 * rows + (8 * (16 * K + 4 * (K + 2)) if warp else 0)
    window = next(w for w in range(7000, 8000) if t_win.window_smem(w, k, union=True) > t_win.cuda_knn.SMEM_BYTES)
    pts, mask = (torch.from_numpy(a[:200]) for a in _distinct_scene())
    got = t_win.window_self_knn(pts, mask, k, window=window)
    ref = self_knn(pts, mask, k + 1)  # each point first, at 0
    m = np_(mask)
    assert (np_(ref.indices)[m, 0] == np.flatnonzero(m)).all()
    np.testing.assert_array_equal(np_(got.indices)[m], np_(ref.indices)[m, 1:])
    np.testing.assert_allclose(np_(got.distances)[m], np_(ref.distances)[m, 1:], rtol=1e-6, atol=1e-6)
