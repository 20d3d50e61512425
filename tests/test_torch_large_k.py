"""k above 16 on every k-NN path of the port against the JAX package, on the
CPU (the plain versions; the card's instances at K = 32, 64 and 128 are held
to them in ``tests/test_torch_cuda_kernels.py``).

JAX runs any k; the port's CPU path does too, and the card up to
``cuda_knn.MAX_K`` = 128.

  * ``tests/test_knn.py:57-70``'s radius search at ``max_k=20`` through
    ``BruteForceKNN.radius_search``: the sets within the radius equal
    ``scipy.spatial.cKDTree``'s (all of them up to 20, else 20 of them) and
    JAX's (``test_torch_knn.py``'s bounds: sets but for members within 2e-4
    of the k-th distance, distances within 2e-4, the expanded form JAX
    computes);
  * ``brute_force_knn`` and ``self_knn`` at k = 20 and 64 against JAX's
    ``brute_force_knn`` and ``approx_knn`` (the same bounds);
  * covariances with ``neighbor_num=20`` (``PCProcessor``'s k-NN context and
    covariances on the LO frame test's scan, ``test_torch_lo_frame.py``'s
    bounds: squared distances 1e-4, covariances within 5e-3 of their largest
    entry);
  * ``GridKNN.search``, ``CoarseKNN.search``, ``window_self_knn`` and
    ``range_image_knn`` at k = 20 against JAX's, with the existing tests'
    tie tolerance: indices equal except where two distances tie within 1e-6,
    distances within 1e-6 (relative), padded entries equal index and all;
  * ``LidarOdometry`` with ``neighbor_num: 20`` (the standard covariances and
    the raw range-image ones) over 5 synthetic 512 x 32 scans in both
    packages: every pose within ``test_torch_lo_frame.py``'s 0.1 m / 0.05 rad
    of the truth, the final poses within 0.05 m / 0.02 rad of each other;
  * the CoarseKNN ranking's plain version (``q . c`` elementwise) against
    JAX's (a matrix product and ``lax.top_k``) on ``tests/test_coarse_knn.py``'s
    scenes and the lattice whose bounds tie at 0: the same cells where the
    bounds are not within 1e-4 of a tie, the bounds within 1e-4 (the f32
    cancellation of q2 + c2 - 2 q.c at ranges of 40 m, which the search's
    margin absorbs, rounds the product and the elementwise sum apart by up
    to ~3e-5 relative), and on the lattice every cell, index for index;
  * the refusals: no CPU search refuses k for being above 16; the first
    designs still do; a structured search refuses k above its candidates
    (the range-image window above its (2 window_az + 1)(2 window_el + 1), as
    JAX's top_k does);
  * ``knn_k_spill`` (the one-thread instances above 16, kept for timing) on the
    CPU equal to ``knn_k`` / ``knn_k_batched`` bit for bit, refusing k up
    to 16 and above 128; the warp-a-query instances' slice plan
    (``knn_cluster_slices``); the range-image window's tile plans (a warp a
    cell above 16, and the one-thread tile kept for timing).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from _torch_parity import both, clouds, np_

from sycl_points_tpu.ops import knn as j_knn
from sycl_points_tpu.ops import window_knn as j_win
from sycl_points_tpu.ops.coarse_knn import CoarseKNN as JCoarse
from sycl_points_tpu.pipeline import lidar_odometry as j_lo
from sycl_points_tpu.pipeline import params as P
from sycl_points_tpu.pipeline.pc_processor import PCProcessor as JPCProcessor
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.ops import coarse_knn as t_coarse
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops import grid_knn as t_grid_knn
from sycl_points_tpu_torch.ops import knn as t_knn
from sycl_points_tpu_torch.ops import range_image_knn as ri
from sycl_points_tpu_torch.ops import window_knn as t_win
from sycl_points_tpu_torch.ops.coarse_knn import CoarseKNN as TCoarse
from sycl_points_tpu_torch.pipeline import lidar_odometry as t_lo
from sycl_points_tpu_torch.pipeline.pc_processor import PCProcessor as TPCProcessor

from test_torch_checkpoint import _every_point
from test_torch_coarse_knn import _assert_same, _pts
from test_torch_grid_knn import assert_same_knn, dense_cloud, grids, jsearch
from test_torch_knn import _check_knn, _cloud
from test_torch_lo_frame import _rel_close, make_world, pose_gap, scan_at, stage_params
from test_torch_range_image import _assert_knn_equal, _jax_knn, _port_knn

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import synthetic_velodyne as ref_synth  # noqa: E402

K = 20
RANK_TOL = 1e-4  # the bounds' f32 cancellation at 40 m (see the module note)
N_AZ, N_RINGS = 512, 32
LO_FRAMES = 5


# --------------------------------------------------------------------------
# brute force
# --------------------------------------------------------------------------


def test_radius_search_max_k_20_matches_jax_and_ckdtree():
    """tests/test_knn.py:57-70 through the port's BruteForceKNN."""
    rng = np.random.default_rng(5)
    tgt = rng.normal(size=(1000, 3)).astype(np.float32)
    qry = rng.normal(size=(50, 3)).astype(np.float32)
    r = 0.5
    (tj, tt), (qj, qt) = both(tgt), both(qry)
    jres = j_knn.BruteForceKNN(tj, jnp.ones(1000, bool)).radius_search(qj, r, max_k=K)
    tres = t_knn.BruteForceKNN(tt, torch.ones(1000, dtype=torch.bool)).radius_search(qt, r, max_k=K)
    assert tuple(tres.indices.shape) == (50, K)
    ti = np_(tres.indices)
    for i, lst in enumerate(cKDTree(tgt).query_ball_point(qry, r)):
        got, ref = set(int(x) for x in ti[i] if x >= 0), set(lst)
        if len(ref) <= K:
            assert got == ref, i
        else:
            assert got.issubset(ref) and len(got) == K, i
    within = np.isfinite(np_(jres.distances))
    np.testing.assert_array_equal(np.isfinite(np_(tres.distances)), within)
    assert ((ti == -1) == ~within).all()
    _check_knn(tres.indices, tres.distances, jres.indices, jres.distances, np.ones(50, bool))


@pytest.mark.parametrize("k", [20, 64])
def test_brute_force_and_self_knn_large_k_match_jax(k):
    rng = np.random.default_rng(k)
    pts, mask = _cloud(rng, 2000, 10.0, 7)
    qry, _ = _cloud(rng, 300, 10.0)
    (pj, pt), (mj, mt), (qj, qt) = both(pts), both(mask), both(qry)
    tr = t_knn.self_knn(pt, mt, k)
    assert tuple(tr.indices.shape) == (2000, k)
    jr = j_knn.approx_knn(pj, mj, pj, k)
    _check_knn(tr.indices, tr.distances, jr.indices, jr.distances, mask)
    tb, jb = t_knn.brute_force_knn(pt, mt, qt, k), j_knn.brute_force_knn(pj, mj, qj, k)
    _check_knn(tb.indices, tb.distances, jb.indices, jb.distances, np.ones(300, bool))
    # the first 16 columns are the k = 16 search (the card's FAST_MAX_K)
    t16 = t_knn.brute_force_knn(pt, mt, qt, 16)
    np.testing.assert_array_equal(np_(tb.distances)[:, :16], np_(t16.distances))
    # and the tie-ordered plain version holds the same rows
    si, sd = cuda_knn.knn_k_sorted_plain(pt, mt, qt, k)
    np.testing.assert_array_equal(np_(sd), np_(tb.distances))
    assert cuda_knn.knn_mismatches(si, sd, tb.indices, tb.distances, 1e-6) == 0


def test_covariances_with_neighbor_num_20_match_jax():
    params = stage_params()
    params = dataclasses.replace(params, covariance_estimation=dataclasses.replace(
        params.covariance_estimation, neighbor_num=K))
    pts = scan_at(make_world(), np.eye(4, dtype=np.float32))
    jc, tc = clouds(pts, capacity=4096)
    jpc, tpc = JPCProcessor(params), TPCProcessor(params_from_reference(params), device="cpu")
    jpre, tpre = jpc.prefilter(jc), tpc.prefilter(tc)
    m = np_(jpre.mask)
    jctx, tctx = jpc.prepare_context(jpre), tpc.prepare_context(tpre)
    assert tuple(tctx.knn.indices.shape)[-1] == K
    np.testing.assert_allclose(np_(tctx.knn.distances)[m], np_(jctx.knn.distances)[m], atol=1e-4)
    assert (np_(tctx.knn.indices)[m] == np_(jctx.knn.indices)[m]).mean() > 0.99  # ties aside
    jcov, tcov = jpc.compute_covariances(jpre, jctx), tpc.compute_covariances(tpre, tctx)
    _rel_close(np_(tcov.covs)[m], np_(jcov.covs)[m], 5e-3)


# --------------------------------------------------------------------------
# the structured searches
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dense", "masked, pose"])
def test_grid_search_k_20_matches_jax(case):
    rng = np.random.default_rng(23)
    tgt = dense_cloud(rng, 4000, extent=5.0)
    qry = np.concatenate([tgt[:300], [[50.0, 50.0, 50.0], [3e6, 0.0, 0.0]]]).astype(np.float32)
    mask, pose = None, None
    if case == "masked, pose":
        mask = np.ones(len(tgt), bool)
        mask[::3] = False
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.2, -0.1, 0.05]
    jg, tg = grids(tgt, mask, cell_size=1.0, max_per_cell=32)
    jq, tq = both(qry)
    jp, tp = (None, None) if pose is None else both(pose)
    jres, tres = jsearch(jg, jq, K, jp), tg.search(tq, K, pose=tp)
    moved = qry if pose is None else qry + pose[:3, 3]
    assert_same_knn(jres, tres, tgt, moved)
    assert np.isinf(np_(tres.distances)[-2:]).all()  # JAX's padding for the far and off-range queries


@pytest.mark.parametrize("case", ["lidar-like", "small budget"])
def test_coarse_search_k_20_matches_jax(case):
    budget = 256 if case == "lidar-like" else 8
    (jt, tt), (_, tq) = clouds(_pts(20000, seed=1)), clouds(_pts(256, seed=2))
    qry = np_(tq.points)
    jk = JCoarse.build(jt, coarse_cell=8.0, max_per_cell=budget)
    tk = TCoarse.build(tt, coarse_cell=8.0, max_per_cell=budget)
    (jres, jcert), (tres, tcert) = (jk.search(jnp.asarray(qry), K, top_cells=8),
                                    tk.search(torch.from_numpy(qry), K, top_cells=8))
    assert tuple(tres.indices.shape) == (256, K)
    _assert_same(np_(jres.indices), np_(jres.distances), np_(tres.indices), np_(tres.distances), np_(tk.points), qry)
    np.testing.assert_array_equal(np_(tcert), np_(jcert))
    if case == "lidar-like":
        assert np_(tcert).mean() > 0.5
    else:
        assert not np_(tcert).any()  # the budget overflows


def test_window_self_knn_k_20_matches_jax():
    from test_torch_window_knn import _distinct_scene

    pts, mask = _distinct_scene()
    (jp, tp), (jm, tm) = both(pts), both(mask)
    jr, tr = j_win.window_self_knn(jp, jm, K, window=16), t_win.window_self_knn(tp, tm, K, window=16)
    np.testing.assert_array_equal(np_(tr.indices), np.asarray(jr.indices))
    np.testing.assert_allclose(np_(tr.distances), np.asarray(jr.distances), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_az,n_rings", [(1024, 32), (512, 16)])
def test_range_image_knn_k_20_matches_jax(n_az, n_rings):
    T = np.eye(4)
    T[:3, 3] = [0, 0, 1.8]
    pts = ref_synth.scan_at(ref_synth.World(), T, n_az=n_az, n_rings=n_rings, seed=3)
    mask = np.ones(len(pts), bool)
    mask[::17] = False
    got = _port_knn(pts, mask, K, n_az=n_az, n_rings=n_rings)
    assert got[0].shape == (len(pts), K)
    _assert_knn_equal(got, _jax_knn(pts, mask, K, n_az=n_az, n_rings=n_rings))


# --------------------------------------------------------------------------
# the CoarseKNN ranking
# --------------------------------------------------------------------------


def _jax_ranking(ck: JCoarse, q, P, margin):
    """JAX's ranking as ``CoarseKNN.search`` writes it (``one_chunk``):
    ``(cells [Q, P], lb_unexplored [Q], lb [Q, C])``."""
    q2 = jnp.sum(q * q, axis=1, keepdims=True)
    c2 = jnp.sum(ck.centroids * ck.centroids, axis=1)[None, :]
    d2c = jnp.maximum(q2 + c2 - 2.0 * (q @ ck.centroids.T), 0.0)
    lb = jnp.maximum(jnp.sqrt(d2c) - ck.radii[None, :] - margin, 0.0)
    lb = jnp.where(ck.valid[None, :], lb, jnp.inf)
    neg, cells = jax.lax.top_k(-lb, P + 1)
    return np.asarray(cells[:, :P]), np.asarray(-neg[:, P]), np.asarray(lb)


def _lattice_scene():
    """tests/test_torch_coarse_knn.py's stable-tie lattice."""
    rng = np.random.default_rng(9)
    cells = np.stack(np.meshgrid(np.arange(12), np.arange(12), np.arange(3), indexing="ij"), -1).reshape(-1, 3)
    offs = np.stack(np.meshgrid(*[np.array([0.2, 0.5, 0.8])] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts = (cells[:, None, :] + offs[None]).reshape(-1, 3) + rng.normal(scale=0.01, size=(len(cells) * 27, 3))
    pts = pts[rng.permutation(len(pts))].astype(np.float32)
    qry = rng.uniform([1, 1, 0.5], [11, 11, 2.5], size=(200, 3)).astype(np.float32)
    return pts, qry


@pytest.mark.parametrize("case", ["lidar-like", "lost cells", "lattice ties"])
def test_ranking_plain_selects_jax_cells(case):
    if case == "lattice ties":
        pts, qry = _lattice_scene()
        kw, P, margin = dict(coarse_cell=1.0, max_per_cell=32), 6, 1.0
    else:
        pts, qry = _pts(20000, seed=1), _pts(512, seed=2)
        kw = dict(coarse_cell=8.0, max_per_cell=256) if case == "lidar-like" else \
            dict(coarse_cell=0.2, cells_capacity=256)
        P, margin = 8, 1e-2
    jt, tt = clouds(pts)
    jk, tk = JCoarse.build(jt, **kw), TCoarse.build(tt, **kw)
    assert int(tk.occupied) == int(np_(tk.valid).sum()) and np_(tk.valid)[: int(tk.occupied)].all()
    jq, tq = both(qry)
    jcells, jlb_u, jlb = _jax_ranking(jk, jq, P, margin)
    tcells, tlb_u = (np_(x) for x in tk.select_cells(tq, P, margin))
    assert tcells.dtype == np.int32 and tcells.shape == jcells.shape
    fin = np.isfinite(jlb_u)
    np.testing.assert_array_equal(np.isfinite(tlb_u), fin)
    np.testing.assert_allclose(tlb_u[fin], jlb_u[fin], rtol=RANK_TOL, atol=RANK_TOL)
    if case == "lattice ties":
        assert (jlb_u == 0).mean() > 0.9  # the ties decide
        np.testing.assert_array_equal(tcells, jcells)
        return
    # a differing selection only among bounds within RANK_TOL of each other
    for q in np.nonzero((tcells != jcells).any(1))[0]:
        a, b = np.sort(jlb[q, tcells[q]]), np.sort(jlb[q, jcells[q]])
        np.testing.assert_allclose(a, b, rtol=RANK_TOL, atol=RANK_TOL)
    assert (tcells == jcells).all(1).mean() > 0.99


def test_rank_matmul_first_design_matches_plain_on_the_cpu():
    pts, qry = _pts(20000, seed=1), _pts(512, seed=2)
    _, tt = clouds(pts)
    tk = TCoarse.build(tt, coarse_cell=8.0, max_per_cell=256)
    q = torch.from_numpy(qry)
    a, b = t_coarse.rank_cells_plain(tk, q, 8, 1e-2), t_coarse.rank_cells_matmul(tk, q, 8, 1e-2, chunk=100)
    assert (np_(a[0]) == np_(b[0])).all(1).mean() > 0.99
    np.testing.assert_allclose(np_(b[1]), np_(a[1]), rtol=RANK_TOL, atol=RANK_TOL)
    # every cell selected (P = C): the bound is +inf
    small = TCoarse.build(tt, coarse_cell=8.0, cells_capacity=8)
    cells, lb = small.select_cells(q, 8, 1e-2)
    assert np.isinf(np_(lb)).all() and (np.sort(np_(cells), 1) == np.arange(8)).all()
    with pytest.raises(ValueError, match="top_cells"):
        small.select_cells(q, 9, 1e-2)


# --------------------------------------------------------------------------
# the LiDAR-odometry frame with neighbor_num: 20
# --------------------------------------------------------------------------


def _lo_tree(T0, raw):
    """The replay deployment at 512 x 32 (every point taken) with the
    covariances' neighbor_num at 20, standard or from the range image."""
    params = P.LidarOdometryParams(
        scan=P.ScanParams(downsampling=P.DownsamplingParams(
            voxel=P.VoxelDownsamplingParams(enable=True, size=1.0), polar=P.PolarDownsamplingParams(enable=False),
            random=P.RandomDownsamplingParams(enable=True, num=5000))),
        submap=P.SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0, map_capacity=1 << 12,
                              extract_capacity=1 << 11, point_random_sampling_num=512),
        covariance_estimation=P.CovarianceEstimationParams(
            neighbor_num=K, raw_range_image=raw, range_image_n_az=N_AZ, range_image_n_rings=N_RINGS),
        pose=P.PoseParams(initial=tuple(np.asarray(T0, np.float32).ravel().tolist())),
        scan_capacity=1 << 13,
    )
    return _every_point(params)


@pytest.mark.parametrize("raw", [False, True])
def test_lidar_odometry_with_neighbor_num_20_matches_jax(raw):
    poses = ref_synth.figure8_trajectory(LO_FRAMES, speed=0.35)
    world = ref_synth.World()
    params = _lo_tree(poses[0], raw)
    jlo, tlo = j_lo.LidarOdometry(params), t_lo.LidarOdometry(params_from_reference(params), device="cpu")
    before = dict(cuda_knn.launch_counts)
    for i, T in enumerate(poses):
        pts = ref_synth.scan_at(world, T, n_az=N_AZ, n_rings=N_RINGS, seed=i)
        jc, tc = clouds(pts, capacity=N_AZ * N_RINGS)
        jr, tr = jlo.process(jc, 0.1 * (i + 1)), tlo.process(tc, 0.1 * (i + 1))
        want = "first_frame" if i == 0 else "success"
        assert tr.name == jr.name == want, (i, tr, jr)
        for side, got in (("j", jlo.get_odometry()), ("t", tlo.get_odometry())):
            trans, rot = pose_gap(got, T)
            assert trans < 0.1 and rot < 0.05, (i, side, trans, rot)
    assert tlo.preprocessed.covs is not None
    trans, rot = pose_gap(tlo.get_odometry(), jlo.get_odometry())
    assert trans < 0.05 and rot < 0.02, (trans, rot)
    assert cuda_knn.launch_counts == before  # the CPU runs the plain versions


# --------------------------------------------------------------------------
# the refusals
# --------------------------------------------------------------------------


def test_no_cpu_search_refuses_k_above_16():
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(-5, 5, size=(400, 3)).astype(np.float32))
    mask = torch.ones(400, dtype=torch.bool)
    big = 200  # above the card's MAX_K too: the CPU path is unbounded
    idx, d2 = cuda_knn.knn_k(pts, mask, pts[:10], big)
    assert tuple(idx.shape) == (10, big) and np.isfinite(np_(d2)).all()
    i, d = cuda_knn.knn_k_batched(cuda_knn.prep_targets(pts[None], mask[None]), pts[None, :10].contiguous(), big)
    np.testing.assert_array_equal(np_(d[0]), np_(d2))
    _, tg = grids(np_(pts), cell_size=2.0, max_per_cell=32)
    assert tuple(tg.search(pts[:10], big).indices.shape) == (10, big)
    with pytest.raises(ValueError, match="candidates"):
        tg.search(pts[:10], 27 * 32 + 1)
    order = torch.arange(400, dtype=torch.int32)
    assert tuple(t_win.window_search(pts, mask, order, 64, 100)[0].shape) == (400, 100)
    with pytest.raises(ValueError, match="candidates"):
        t_win.window_search(pts, mask, order, 8, 17)
    img_p = torch.zeros(64 * 8, 3)
    img_i = torch.full((64 * 8,), -1, dtype=torch.int32)
    # the window at (6, 4) has 117 candidates: k = 200 is refused, as JAX's
    # top_k refuses it; a window of 17 x 13 = 221 takes it
    with pytest.raises(ValueError, match="candidates"):
        ri.range_image_window(img_p, img_i, 64, 8, 6, 4, big)
    assert tuple(ri.range_image_window(img_p, img_i, 64, 8, 8, 6, big)[0].shape) == (64 * 8, big)
    # the first designs keep their k <= 16
    for call in (lambda: cuda_knn.knn_k_simple(pts, mask, pts, 17),
                 lambda: t_grid_knn.grid_search_simple(tg, pts[:10], 17),
                 lambda: ri.range_image_window_simple(img_p, img_i, 64, 8, 6, 4, 17)):
        with pytest.raises(ValueError, match="first design"):
            call()
    ck = TCoarse.build(clouds(np_(pts))[1], coarse_cell=2.0, max_per_cell=16)
    cells, lb = ck.select_cells(pts[:10], 4, 1e-2)
    assert tuple(t_coarse.coarse_refine(ck, pts[:10], cells, lb, 64)[0].shape) == (10, 64)
    with pytest.raises(ValueError, match="candidates"):
        t_coarse.coarse_refine(ck, pts[:10], cells, lb, 65)
    with pytest.raises(ValueError, match="first design"):
        t_coarse.coarse_refine_simple(ck, pts[:10], cells, lb, 17)


def test_instances_serve_every_k_up_to_128():
    assert [cuda_knn.instance_k(k) for k in (1, 16, 17, 32, 33, 64, 65, 100, 128)] == \
        [1, 16, 32, 32, 64, 64, 128, 128, 128]
    for k in (0, 129):
        with pytest.raises(ValueError):
            cuda_knn.instance_k(k)
    # the range-image window above 16 runs a warp a cell on 1-column tiles
    # (no result rows a thread); the one-thread tile kept for timing shrinks
    # for its rows of results
    assert [ri.range_image_tile(64, 6, k) for k in (10, 16, 20, 32, 64, 100, 128)] == [8, 8, 1, 1, 1, 1, 1]
    assert [ri.range_image_tile(n, 6, 32) for n in (16, 32, 128)] == [4, 2, 1]
    assert [ri.spill_tile(64, 6, k) for k in (20, 32, 64, 100, 128)] == [8, 8, 4, 2, 2]
    for k in (16, 32, 64, 128):
        assert ri.tile_smem(64, 6, ri.spill_tile(64, 6, k), k) <= ri.SMEM_BYTES
        assert ri.warp_tile_smem(64, 6, ri.range_image_tile(64, 6, k), k) <= ri.SMEM_BYTES
    assert cuda_knn.cluster_shape(1000, (128,), 132, slice_counts=cuda_knn.knn_slices(20))[1] == 8
    assert cuda_knn.cluster_shape(1000, (128,), 132, slice_counts=cuda_knn.knn_slices(16))[1] == 16
    assert [cuda_knn.refine_lanes(c, 10) for c in (2048, 128, 100, 40, 8)] == [32, 32, 16, 8, 8]
    assert [cuda_knn.refine_lanes(2048, k) for k in (16, 17, 128)] == [32, 8, 8]


@pytest.mark.parametrize("k", [17, 20, 64, 128])
def test_knn_k_spill_on_the_cpu_equals_knn_k(k):
    rng = np.random.default_rng(11)
    pts = torch.from_numpy(rng.uniform(-5, 5, size=(300, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=300) > 0.2)
    prep = cuda_knn.prep_target(pts, mask)
    got, ref = cuda_knn.knn_k_spill(prep, pts[:40], k), cuda_knn.knn_k_prepped(prep, pts[:40], k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    bprep = cuda_knn.prep_targets(pts[None], mask[None])
    got, ref = cuda_knn.knn_k_spill(bprep, pts[None, :40], k), cuda_knn.knn_k_batched(bprep, pts[None, :40], k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for bad in (16, 129):
        with pytest.raises(ValueError, match="knn_k_spill"):
            cuda_knn.knn_k_spill(prep, pts[:40], bad)


def test_knn_cluster_slices_plan():
    # above 16 a cluster holds 8 queries (a warp each): the LO scan's 5,000
    # queries fill the H100's 132 SMs with one slice, 1,000 take 8
    assert [cuda_knn.knn_cluster_slices(q, 20, 132) for q in (5000, 1000, 30000)] == [1, 8, 1]
    assert cuda_knn.knn_cluster_slices(5000, 128, 132, streams=8) == 1
    # up to 16 the 128-query tile as before
    for q in (1000, 5000, 24576):
        assert cuda_knn.knn_cluster_slices(q, 10, 132) == cuda_knn.cluster_shape(q, (128,), 132)[1]
