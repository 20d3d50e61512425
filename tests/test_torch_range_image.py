"""The range-image k-NN and the raw-features preprocess of the port against
the JAX package, on the CPU.

  * ``range_image_knn`` against JAX's (jitted) on ``tests/test_range_image_knn.py``'s
    scenes: the 1024 x 32 synthetic Velodyne scan (recall scene), mask and
    missing, collision telemetry, a scan whose returns collide in bulk (the
    cell winner is the highest point index on both sides), and a partial fan
    with the elevation bounds given. Indices equal except between distances
    within 1e-6 of each other; distances rtol 1e-6 (XLA may contract the
    distance into fused multiply-adds); ``collisions`` equal;
  * the window search's plain version against a loop over the cells written
    from JAX's roll formulation (the rolls and the stable top-k), bit for bit,
    also at n_az = 1000 (no tile width of the card's kernel divides it) and
    16 / 128 rings; ``range_image_knn`` at n_az = 1000 against JAX's;
  * the tile planner of the card's window kernel (``range_image_tile``) over
    rings and windows, and its refusal when one column and its halo do not
    fit a block; the warp design's (k above 16) and the one-thread tile's
    (``spill_tile``) plans at K = 32 / 64 / 128 for windows up to (8, 4);
    the wrappers of the card's path on the CPU (cells, the gathered window,
    the rows, the first window design, the one-thread tile above 16) equal
    the plain sequence and count no launch;
  * k above 16: ``range_image_knn`` at k = 32 and 64 (window (6, 4)) and 128
    (window (8, 4), 153 candidates) against JAX's, indices exact and
    distances rtol 1e-6; k above the window's candidates refused with a
    ``ValueError`` naming them by every entry and by ``PCProcessor``'s raw
    branch, before any work, where JAX's ``top_k`` raises too;
  * ``PCProcessor`` with ``raw_range_image`` against JAX's, voxel and polar
    grids: points 1e-5, covariances after each grid rtol 1e-5 with the plain
    estimator; with the robust one at least 98% of the voxels within 5e-3 of
    their largest entry (a ring neighbourhood of a raw scan reaches condition
    numbers of 1e9, where the IRLS inverse amplifies float32 rounding), no
    k-NN context on either side;
  * the registration scenario of ``tests/test_raw_features.py:54-116`` on
    both sides: each error under 0.10 m, the raw one within 0.02 m of the
    standard one, and the two packages' errors within 1 mm.

The frames and the fleets at ``raw_range_image=True`` are in
``test_torch_raw_lo.py``, ``test_torch_raw_lio.py`` and
``test_torch_raw_fleet.py``.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import clouds, np_

from sycl_points_tpu.ops.range_image_knn import range_image_knn as j_range_image_knn
from sycl_points_tpu.pipeline import params as P
from sycl_points_tpu.pipeline.pc_processor import PCProcessor as JPCProcessor
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops import range_image_knn as ri
from sycl_points_tpu_torch.pipeline.pc_processor import PCProcessor as TPCProcessor

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import synthetic_velodyne as ref_synth  # noqa: E402

TIE = 1e-6
D_RTOL = 1e-6
COV_RTOL = 1e-5
ROBUST_COV_TOL, ROBUST_COV_SHARE = 5e-3, 0.98


def _jax_knn(pts, mask, k, **kw):
    f = jax.jit(lambda p, m: j_range_image_knn(p, m, k, **kw))
    out = f(jnp.asarray(pts), jnp.asarray(mask))
    return np_(out.knn.indices), np_(out.knn.distances), int(out.collisions)


def _port_knn(pts, mask, k, **kw):
    out = ri.range_image_knn(torch.from_numpy(pts), torch.from_numpy(mask), k, **kw)
    return np_(out.knn.indices), np_(out.knn.distances), int(out.collisions)


def _assert_knn_equal(got, ref, relative_ties=False):
    """``relative_ties``: a tie is within max(TIE, D_RTOL d2), for lists
    that reach tens of m^2, where one ulp is above TIE."""
    (ti, td, tc), (ji, jd, jc) = got, ref
    assert tc == jc
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=D_RTOL)
    differ = ti != ji
    # an index may differ only where its distance ties another within TIE
    sel = differ & fin
    tie = np.maximum(TIE, D_RTOL * np.abs(jd[sel])) if relative_ties else TIE
    assert (np.abs(td[sel] - jd[sel]) <= tie).all()
    assert not (differ & ~fin).any()


@pytest.fixture(scope="module")
def velodyne_scan():
    T = np.eye(4)
    T[:3, 3] = [0, 0, 1.8]
    return ref_synth.scan_at(ref_synth.World(), T, n_az=1024, n_rings=32, seed=3)


def test_recall_scene_matches_jax(velodyne_scan):
    pts = velodyne_scan
    mask = np.ones(len(pts), bool)
    got = _port_knn(pts, mask, 10, n_az=1024, n_rings=32)
    _assert_knn_equal(got, _jax_knn(pts, mask, 10, n_az=1024, n_rings=32))
    assert got[2] == 0


def test_mask_and_missing_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(256, 3)).astype(np.float32) * 10
    mask = np.ones(256, bool)
    mask[100:] = False
    got = _port_knn(pts, mask, 4, n_az=64, n_rings=8)
    _assert_knn_equal(got, _jax_knn(pts, mask, 4, n_az=64, n_rings=8))
    assert (got[0][100:] == np.arange(100, 256)[:, None]).all() and np.isinf(got[1][100:]).all()


def test_collision_telemetry_matches_jax():
    pts = np.asarray([[10.0, 0, 0], [10.0, 0, 0], [0, 10.0, 1.0]], np.float32)
    got = _port_knn(pts, np.ones(3, bool), 2, n_az=32, n_rings=4)
    _assert_knn_equal(got, _jax_knn(pts, np.ones(3, bool), 2, n_az=32, n_rings=4))
    assert got[2] == 1


def test_bulk_collisions_take_the_jax_winner(velodyne_scan):
    """Every 3rd return twice, a block five times, the copies moved by a few
    mm: the cell's point is the highest index on both sides, and every
    colliding point inherits that winner's neighbourhood."""
    base = velodyne_scan[:8000]
    copies = np.concatenate([base[::3], np.tile(base[100:400], (4, 1))])
    pts = np.concatenate([base, copies + 0.003]).astype(np.float32)
    mask = np.ones(len(pts), bool)
    got = _port_knn(pts, mask, 8, n_az=1024, n_rings=32)
    _assert_knn_equal(got, _jax_knn(pts, mask, 8, n_az=1024, n_rings=32))
    assert got[2] > 1000


def test_given_elevation_bounds_match_jax(velodyne_scan):
    """A partial fan (a quarter of the azimuths, the lower rings) with the
    sensor's elevation bounds given."""
    pts = velodyne_scan
    az = np.arctan2(pts[:, 1], pts[:, 0])
    mask = (np.abs(az) < np.pi / 4) & (pts[:, 2] < 0.0)
    kw = dict(n_az=1024, n_rings=32, el_min=-0.4363, el_max=0.0349)
    got = _port_knn(pts, mask, 10, **kw)
    _assert_knn_equal(got, _jax_knn(pts, mask, 10, **kw))


def _window_by_rolls(img_p, img_i, n_az, n_rings, w_az, w_el, k):
    """JAX's formulation in numpy: 2-D rolls of the image, the distances of
    each window column, then a stable ascending sort (``top_k`` of the
    negated distances keeps the lower column first on ties)."""
    IP = img_p.reshape(n_az, n_rings, 3)
    II = img_i.reshape(n_az, n_rings)
    IO = II >= 0
    ring = np.arange(n_rings)
    cols_d, cols_j = [], []
    for da in range(-w_az, w_az + 1):
        for de in range(-w_el, w_el + 1):
            P2 = np.roll(IP, (-da, -de), axis=(0, 1))
            J2 = np.roll(II, (-da, -de), axis=(0, 1))
            el_ok = ((ring + de) >= 0) & ((ring + de) < n_rings)
            diff = IP - P2
            d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
            ok = IO & (J2 >= 0) & el_ok[None, :]
            cols_d.append(np.where(ok, d2, np.float32(ri.BIG)).reshape(-1))
            cols_j.append(J2.reshape(-1))
    D, J = np.stack(cols_d, 1).astype(np.float32), np.stack(cols_j, 1)
    order = np.argsort(D, axis=1, kind="stable")[:, :k]
    d = np.take_along_axis(D, order, 1)
    return np.where(d < ri.BIG, np.take_along_axis(J, order, 1), -1), d


@pytest.mark.parametrize("window", [(6, 4), (2, 1), (8, 4)])
def test_window_plain_equals_the_rolls(velodyne_scan, window):
    pts = torch.from_numpy(velodyne_scan[::2].copy())
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    img_p, img_i, _, _, _ = ri.range_image(pts, mask, 512, 32)
    idx, d2 = ri.range_image_window_plain(img_p, img_i, 512, 32, *window, 10)
    ref_i, ref_d = _window_by_rolls(np_(img_p), np_(img_i), 512, 32, *window, 10)
    np.testing.assert_array_equal(np_(idx), ref_i)
    np.testing.assert_array_equal(np_(d2), ref_d)


@pytest.mark.parametrize("n_az,n_rings,window", [(1000, 32, (6, 4)), (1000, 16, (2, 7)), (602, 128, (0, 0))])
def test_window_plain_equals_the_rolls_off_the_tiles(velodyne_scan, n_az, n_rings, window):
    """An azimuth count no tile width divides, and 16 / 128 rings; k = 10,
    or the window's candidates where it has fewer (the window (0, 0) holds
    the cell alone), and one more than those refused, as JAX's top_k
    refuses it."""
    pts = torch.from_numpy(velodyne_scan[::3].copy())
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    img_p, img_i, _, _, _ = ri.range_image(pts, mask, n_az, n_rings)
    w = (2 * window[0] + 1) * (2 * window[1] + 1)
    k = min(10, w)
    idx, d2 = ri.range_image_window_plain(img_p, img_i, n_az, n_rings, *window, k)
    ref_i, ref_d = _window_by_rolls(np_(img_p), np_(img_i), n_az, n_rings, *window, k)
    np.testing.assert_array_equal(np_(idx), ref_i)
    np.testing.assert_array_equal(np_(d2), ref_d)
    if k < 10:
        with pytest.raises(ValueError, match="candidates"):
            ri.range_image_window_plain(img_p, img_i, n_az, n_rings, *window, 10)
    assert n_az % ri.range_image_tile(n_rings, window[0])


def test_n_az_off_the_tiles_matches_jax(velodyne_scan):
    pts = velodyne_scan
    mask = np.ones(len(pts), bool)
    mask[::13] = False
    got = _port_knn(pts, mask, 10, n_az=1000, n_rings=32)
    _assert_knn_equal(got, _jax_knn(pts, mask, 10, n_az=1000, n_rings=32))


@pytest.mark.parametrize("n_rings,window_az,tile", [(16, 6, 32), (32, 6, 16), (64, 6, 8), (64, 0, 8), (128, 6, 4),
                                                    (128, 40, 2), (256, 6, 2), (512, 6, 1)])
def test_tile_planner(n_rings, window_az, tile):
    """TA: the largest power of two with TA x n_rings <= TILE_CELLS (at
    least 1) whose block (TA + 2 window_az staged columns, 16 B a ring, and
    the block's result rows at k = 16) fits a block's shared memory."""
    assert ri.range_image_tile(n_rings, window_az) == tile
    assert ri.tile_smem(n_rings, window_az, tile) <= ri.SMEM_BYTES
    assert ri.tile_smem(64, 6, 8) == 16 * 64 * 20 + 8 * 16 * 512
    assert tile * n_rings <= ri.TILE_CELLS or tile == 1


@pytest.mark.parametrize("n_rings,window_az", [(128, 60), (2000, 6), (14529, 0)])
def test_tile_planner_refuses_a_column_that_does_not_fit(n_rings, window_az):
    with pytest.raises(ValueError, match="shared memory"):
        ri.range_image_tile(n_rings, window_az)


@pytest.mark.parametrize("window", [(0, 0), (2, 1), (6, 4), (2, 7), (8, 4)])
@pytest.mark.parametrize("K", [32, 64, 128])
def test_warp_tile_planner(K, window):
    """Above 16 a warp a cell: TA x 64 rings within WARP_TILE_CELLS (one
    column), the staged columns at the odd stride 65 and one row of K keys a
    warp within a block's shared memory; the one-thread tile's plan
    (spill_tile) keeps 8 K B of result rows a thread. (The plan does not
    depend on window_el, nor on whether k fits the window.)"""
    ta = ri.range_image_tile(64, window[0], K)
    assert ta == 1 and ta * 64 <= ri.WARP_TILE_CELLS
    smem = ri.warp_tile_smem(64, window[0], ta, K)
    assert smem == 16 * 65 * (ta + 2 * window[0]) + 8 * K * ri.WARP_THREADS // 32 <= ri.SMEM_BYTES
    assert ri.range_image_tile(64, window[0], K - 1) == ta  # a k between instances plans for its instance
    spill = ri.spill_tile(64, window[0], K)
    assert ri.tile_smem(64, window[0], spill, K) <= ri.SMEM_BYTES < ri.tile_smem(64, window[0], 2 * spill, K) \
        or spill * 64 == ri.TILE_CELLS


def test_tile_planner_shrinks_the_tile_to_fit():
    # 32 rings allow 16 columns by the cells; at a halo of 2 x 156 columns
    # 16 take 233,472 B and 8 take 196,608; at 2 x 105, 64 rings fit one
    # column only (224,256 B)
    assert ri.tile_smem(32, 156, 16) > ri.SMEM_BYTES >= ri.tile_smem(32, 156, 8)
    assert ri.range_image_tile(32, 156) == 8
    assert ri.range_image_tile(64, 105) == 1


@pytest.mark.parametrize("el", [{}, {"el_min": -0.4363, "el_max": 0.0349}, {"el_max": 0.0349}])
def test_card_path_wrappers_on_the_cpu_equal_the_plain_sequence(velodyne_scan, el):
    base = velodyne_scan[:12000]
    pts = torch.from_numpy(np.concatenate([base, base[::3] + 0.003]).astype(np.float32))
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    mask[::9] = False
    n_az, n_rings, k = 1000, 32, 10
    before = dict(cuda_knn.launch_counts)
    cell, win1, occ, collisions = ri.range_image_cells(pts, mask, n_az, n_rings, **el)
    img_p, img_i, cell64, ok, ref_coll = ri.range_image(pts, mask, n_az, n_rings, **el)
    assert torch.equal(cell, cell64.to(torch.int32)) and torch.equal(win1, img_i + 1)
    assert int(occ.sum()) == int(ok.sum()) and int(collisions) == int(ref_coll) > 0
    assert torch.equal(occ, torch.bincount(cell64[ok], minlength=n_az * n_rings).to(torch.int32))
    ref = ri.range_image_window_plain(img_p, img_i, n_az, n_rings, 6, 4, k)
    for got in (ri.range_image_window_gather(pts, win1, n_az, n_rings, 6, 4, k),
                ri.range_image_window_simple(img_p, img_i, n_az, n_rings, 6, 4, k)):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    rows, plain = ri.cell_rows(*ref, cell), ri.point_rows(*ref, cell64, ok)
    assert torch.equal(rows.indices, plain.indices) and torch.equal(rows.distances, plain.distances)
    assert cuda_knn.launch_counts == before


def test_large_k_wrappers_on_the_cpu_equal_the_plain_version(velodyne_scan):
    pts = torch.from_numpy(velodyne_scan[::2].copy())
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    before = dict(cuda_knn.launch_counts)
    img_p, img_i, _, _, _ = ri.range_image(pts, mask, 512, 32)
    for k in (17, 32, 64, 100, 117):
        ref = ri.range_image_window_plain(img_p, img_i, 512, 32, 6, 4, k)
        for got in (ri.range_image_window(img_p, img_i, 512, 32, 6, 4, k),
                    ri.range_image_window_spill(img_p, img_i, 512, 32, 6, 4, k),
                    ri.range_image_window_gather(pts, (img_i + 1).contiguous(), 512, 32, 6, 4, k)):
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        full = ri.range_image_window_plain(img_p, img_i, 512, 32, 6, 4, 117)
        assert torch.equal(ref[0], full[0][:, :k]) and torch.equal(ref[1], full[1][:, :k])
    for k in (16, 129):
        with pytest.raises(ValueError, match="range_image_window_spill"):
            ri.range_image_window_spill(img_p, img_i, 512, 32, 8, 4, k)
    assert cuda_knn.launch_counts == before


@pytest.mark.parametrize("k,window", [(32, (6, 4)), (64, (6, 4)), (128, (8, 4))])
def test_large_k_matches_jax(velodyne_scan, k, window):
    """range_image_knn above 16 against JAX's (jitted) on the recall scene
    with every 11th point masked: indices equal except between distances
    tied within max(1e-6, 1e-6 d2) (XLA rounds a distance one ulp away from
    the plain f32 operations now and then: 2 of 1,048,576 entries at k = 32,
    a pair at 0.66343623 m^2 where JAX's has 0.6634363; at k = 128 the lists
    reach ~50 m^2, where one ulp is 3.8e-6), distances rtol 1e-6;
    test_window_plain_equals_the_rolls_above_16 holds the window to JAX's
    formulation in plain f32 bit for bit."""
    mask = np.ones(len(velodyne_scan), bool)
    mask[::11] = False
    kw = dict(n_az=1024, n_rings=32, window_az=window[0], window_el=window[1])
    got, ref = _port_knn(velodyne_scan, mask, k, **kw), _jax_knn(velodyne_scan, mask, k, **kw)
    _assert_knn_equal(got, ref, relative_ties=True)
    assert (got[0] != ref[0]).mean() < 1e-4
    assert np.isfinite(got[1][:, k - 1]).any()  # rows of k finite neighbours


@pytest.mark.parametrize("k,window", [(17, (6, 4)), (32, (6, 4)), (64, (6, 4)), (117, (6, 4)), (128, (8, 4))])
def test_window_plain_equals_the_rolls_above_16(velodyne_scan, k, window):
    """The window search above 16 equals JAX's rolls and stable top-k in
    plain f32 (numpy), indices and distances bit for bit."""
    pts = torch.from_numpy(velodyne_scan[::2].copy())
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    mask[::13] = False
    img_p, img_i, _, _, _ = ri.range_image(pts, mask, 512, 32)
    idx, d2 = ri.range_image_window_plain(img_p, img_i, 512, 32, *window, k)
    ref_i, ref_d = _window_by_rolls(np_(img_p), np_(img_i), 512, 32, *window, k)
    np.testing.assert_array_equal(np_(idx), ref_i)
    np.testing.assert_array_equal(np_(d2), ref_d)


@pytest.mark.parametrize("window", [(6, 4), (8, 4), (2, 1), (0, 0)])
def test_k_above_the_window_candidates_is_refused_as_jax_refuses_it(velodyne_scan, window):
    """k = W + 1 (W the window's candidates): JAX's top_k raises, and so does
    every entry of the port with a ValueError naming the candidates, before
    any launch; k = W runs."""
    W = ri.window_candidates(*window)
    assert W == (2 * window[0] + 1) * (2 * window[1] + 1)
    pts_np = velodyne_scan[::4].copy()
    kw = dict(n_az=256, n_rings=32, window_az=window[0], window_el=window[1])
    with pytest.raises(ValueError, match="top_k"):
        j_range_image_knn(jnp.asarray(pts_np), jnp.asarray(np.ones(len(pts_np), bool)), W + 1, **kw)
    pts, mask = torch.from_numpy(pts_np), torch.ones(len(pts_np), dtype=torch.bool)
    img_p, img_i, _, _, _ = ri.range_image(pts, mask, 256, 32)
    args = (256, 32, *window)
    before = dict(cuda_knn.launch_counts)
    calls = [lambda k: ri.range_image_knn(pts, mask, k, **kw),
             lambda k: ri.range_image_window_plain(img_p, img_i, *args, k),
             lambda k: ri.range_image_window(img_p, img_i, *args, k),
             lambda k: ri.range_image_window_gather(pts, (img_i + 1).contiguous(), *args, k)]
    for call in calls:
        with pytest.raises(ValueError, match="candidates"):
            call(W + 1)
    if W + 1 <= cuda_knn.FAST_MAX_K:
        with pytest.raises(ValueError, match="candidates"):
            ri.range_image_window_simple(img_p, img_i, *args, W + 1)
    elif W + 1 <= cuda_knn.MAX_K:
        with pytest.raises(ValueError, match="candidates"):
            ri.range_image_window_spill(img_p, img_i, *args, W + 1)
    assert calls[0](W).knn.indices.shape[-1] == W
    for call in calls[1:]:
        assert call(W)[0].shape[-1] == W
    assert cuda_knn.launch_counts == before


def test_pc_processor_refuses_neighbors_above_the_window_as_jax_does(velodyne_scan):
    """PCProcessor's raw branch (the prefilter, before the voxel grid) at
    neighbor_num = 118 over the default window's 117 candidates: JAX's raises
    in top_k, the port's with the range-image search's ValueError; at 117
    both run."""
    base = _raw_params()
    jc, tc = clouds(velodyne_scan, capacity=1 << 15)
    for k in (118, 117):
        params = dataclasses.replace(base, covariance_estimation=dataclasses.replace(
            base.covariance_estimation, neighbor_num=k))
        jp, tp = JPCProcessor(params), TPCProcessor(params_from_reference(params), device="cpu")
        if k == 118:
            with pytest.raises(ValueError, match="top_k"):
                jp.prefilter(jc)
            with pytest.raises(ValueError, match="candidates"):
                tp.prefilter(tc)
        else:
            assert tp.prefilter(tc).covs is not None


def test_window_wrapper_counts_no_cpu_launch(velodyne_scan):
    before = dict(cuda_knn.launch_counts)
    _port_knn(velodyne_scan[:4000], np.ones(4000, bool), 10, n_az=1024, n_rings=32)
    assert cuda_knn.launch_counts == before


# -- PCProcessor's raw-features branch ------------------------------------------------


def _raw_params(polar=False, robust=False, n_az=1024, n_rings=32):
    return P.LidarOdometryParams(
        scan=P.ScanParams(downsampling=P.DownsamplingParams(
            voxel=P.VoxelDownsamplingParams(enable=True, size=1.0), polar=P.PolarDownsamplingParams(enable=polar),
            random=P.RandomDownsamplingParams(enable=False))),
        covariance_estimation=P.CovarianceEstimationParams(
            m_estimation=P.MEstimationParams(enable=robust), raw_range_image=True,
            range_image_n_az=n_az, range_image_n_rings=n_rings))


@pytest.mark.parametrize("robust", [False, True], ids=["plain", "robust"])
@pytest.mark.parametrize("polar", [False, True], ids=["voxel", "polar+voxel"])
def test_pc_processor_raw_features_matches_jax(velodyne_scan, polar, robust):
    params = _raw_params(polar, robust)
    jc, tc = clouds(velodyne_scan, capacity=1 << 15)
    jp, tp = JPCProcessor(params), TPCProcessor(params_from_reference(params), device="cpu")
    jo, to = jp.prefilter(jc), tp.prefilter(tc)
    jx, tx = jp.prepare_context(jo), tp.prepare_context(to)
    assert jx.knn is None and tx.knn is None
    jo, to = jp.compute_covariances(jo, jx), tp.compute_covariances(to, tx)
    m = np_(jo.mask)
    np.testing.assert_array_equal(np_(to.mask), m)
    assert m.sum() > 1000
    np.testing.assert_allclose(np_(to.points)[m], np_(jo.points)[m], rtol=1e-5, atol=1e-5)
    got, ref = np_(to.covs)[m], np_(jo.covs)[m]
    if not robust:
        np.testing.assert_allclose(got, ref, rtol=COV_RTOL, atol=1e-8)
        return
    rel = np.abs(got - ref).max(axis=(1, 2)) / np.abs(ref).max(axis=(1, 2))
    assert (rel <= ROBUST_COV_TOL).mean() >= ROBUST_COV_SHARE, (rel > ROBUST_COV_TOL).sum()


def test_raw_features_registration_matches_jax():
    """tests/test_raw_features.py:54-116 through both packages."""
    from sycl_points_tpu.ops.knn import BruteForceKNN as JKNN
    from sycl_points_tpu.points.point_cloud import pad_capacity_for
    from sycl_points_tpu.registration.factors import RegType
    from sycl_points_tpu.registration.registration import RegistrationParams, align
    from sycl_points_tpu_torch.ops.knn import BruteForceKNN as TKNN
    from sycl_points_tpu_torch.registration import registration as t_reg

    w = ref_synth.World()
    T0 = np.eye(4)
    T0[:3, 3] = [0, 0, 1.8]
    T1 = T0.copy()
    yaw = np.deg2rad(2.0)
    T1[:3, :3] = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    T1[:3, 3] = [1.0, 0.1, 1.8]
    tgt_np = ref_synth.scan_at(w, T0, n_az=1024, n_rings=32, seed=0)
    src_np = ref_synth.scan_at(w, T1, n_az=1024, n_rings=32, seed=1)
    T_rel = np.linalg.inv(T0) @ T1
    cap = pad_capacity_for(max(len(src_np), len(tgt_np)))
    reg = RegistrationParams(reg_type=RegType.GICP, max_iterations=20)
    errs = {}
    for tag, raw in (("std", False), ("rimg", True)):
        params = P.LidarOdometryParams(covariance_estimation=P.CovarianceEstimationParams(
            m_estimation=P.MEstimationParams(enable=False), raw_range_image=raw,
            range_image_n_az=1024, range_image_n_rings=32))
        procs = (JPCProcessor(params), TPCProcessor(params_from_reference(params), device="cpu"))
        for side, proc in zip(("jax", "port"), procs):
            prepped = []
            for pts in (src_np, tgt_np):
                c = clouds(pts, capacity=cap)[side == "port"]
                c = proc.prefilter(c)
                c = proc.compute_covariances(c, proc.prepare_context(c))
                assert c.covs is not None
                prepped.append(c)
            s, t = prepped
            if side == "jax":
                res = align(s, t, JKNN.build(t), reg)
            else:
                res = t_reg.align(s, t, TKNN.build(t), params_from_reference(reg))
            errs[side, tag] = float(np.linalg.norm(np_(res.T)[:3, 3] - T_rel[:3, 3].astype(np.float32)))
    for side in ("jax", "port"):
        assert errs[side, "std"] < 0.10 and errs[side, "rimg"] < 0.10, errs
        assert abs(errs[side, "rimg"] - errs[side, "std"]) < 0.02, errs
    for tag in ("std", "rimg"):
        assert abs(errs["port", tag] - errs["jax", tag]) < 1e-3, errs
