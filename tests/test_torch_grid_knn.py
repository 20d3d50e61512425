"""``GridKNN`` and ``build_target_knn`` of the port against the JAX package,
on the CPU (the plain search; the kernel is held to it on the card in
``tests/test_torch_cuda_kernels.py``).

  * the scenarios of ``tests/test_grid_knn.py`` and ``tests/test_aux.py``
    (``remove_points``) on both packages with the same numpy inputs: indices
    equal, except where two candidates' squared distances lie within 1e-6
    (a tie the two sums may order differently); squared distances within
    1e-6 (relative, at least 1e-6 absolute); padded entries (+inf) equal,
    index and all;
  * a query whose 27 cells hold no point, a query outside the 21-bit
    coordinate range, an all-masked target: JAX's padding, index for index;
  * ``build`` / ``build_auto``'s counters and budgets equal JAX's;
    ``build_target_knn`` picks brute force at the default threshold and the
    grid above a lowered one, and both registrations agree (T within 1e-5,
    inliers equal) and agree with JAX's;
  * ``LidarOdometry`` over 3 frames of 512 x 32 synthetic scans at the
    replay deployment (every point taken) with ``GRID_KNN_TARGET_THRESHOLD``
    lowered to 0 in both packages: every frame a success, the port's target a
    ``GridKNN`` on every frame, each pose within 1 mm / 1e-3 rad of JAX's;
  * coarse-to-fine with a ``GridKNN`` target is refused in both packages
    (the port with a ValueError that says why);
  * the search on a lattice of exact ties (0.5 m spacing in 1 m cells, every
    third point repeated under another index, every 11th masked; queries on
    the lattice's midpoints and nodes, beyond its corner, off the 21-bit
    range and NaN) against JAX's, index for index, at budgets 32 and 4: ties
    go to the earlier (cell offset, lane) slot in both;
  * ``cuda_knn.grid_lanes``, the lane planner of the card's kernel, over
    query counts and SM counts; the CPU wrappers (``grid_search`` with a
    lane count, ``grid_search_simple``) run the plain search.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both, clouds, np_

from sycl_points_tpu.ops import knn as j_knn
from sycl_points_tpu.ops.grid_knn import GridKNN as JGrid
from sycl_points_tpu.ops.grid_knn import _build_jit
from sycl_points_tpu.pipeline import lidar_odometry as j_lo
from sycl_points_tpu.pipeline import params as P
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu.registration import registration as j_reg
from sycl_points_tpu.registration.factors import RegType as JRegType
from sycl_points_tpu.utils import lie_np
from sycl_points_tpu_torch.apps import odometry_replay
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops import grid_knn as t_grid_knn
from sycl_points_tpu_torch.ops import knn as t_knn
from sycl_points_tpu_torch.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu_torch.ops.grid_knn import GridKNN as TGrid
from sycl_points_tpu_torch.pipeline import lidar_odometry as t_lo
from sycl_points_tpu_torch.registration import registration as t_reg
from sycl_points_tpu_torch.registration.factors import RegType

from test_torch_checkpoint import _every_point  # noqa: E402
from test_torch_lo_frame import pose_gap  # noqa: E402

TIE = 1e-6

# JAX's build and search compiled once a shape (eager dispatch of their
# loops costs seconds a call on the CPU)
_jsearch = jax.jit(lambda g, q, p, k: g.search(q, k, pose=p), static_argnames="k")


def jbuild(cloud, cell_size, table_capacity=None, max_probes=16, max_per_cell=32):
    return _build_jit(cloud, cell_size=cell_size, table_capacity=table_capacity, max_probes=max_probes,
                      max_per_cell=max_per_cell)


def jsearch(grid, q, k, pose=None):
    return _jsearch(grid, q, pose, k=k)


def dense_cloud(rng, n, extent=10.0):
    return rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)


def assert_same_knn(jres, tres, target, queries):
    """Indices equal but for ties within TIE; distances within TIE
    (relative); padded (+inf) entries equal, index and all."""
    ji, jd, ti, td = (np_(x) for x in (jres.indices, jres.distances, tres.indices, tres.distances))
    assert ji.shape == ti.shape and ti.dtype == np.int32
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=TIE, atol=TIE)
    np.testing.assert_array_equal(ti[~fin], ji[~fin])
    for q, s in zip(*np.nonzero((ji != ti) & fin)):
        # a tie: the port's neighbour lies as far from the query as JAX's
        d_port = np.sum((target[ti[q, s]] - queries[q]) ** 2)
        assert abs(d_port - jd[q, s]) <= TIE * max(1.0, jd[q, s]), (q, s, d_port, jd[q, s])


def grids(pts, mask=None, **kw):
    jc, tc = clouds(pts)
    if mask is not None:
        full = np.zeros(tc.capacity, bool)
        full[: len(mask)] = mask
        jc, tc = jc.replace(mask=jnp.asarray(full)), tc.replace(mask=torch.from_numpy(full))
    return jbuild(jc, **kw), TGrid.build(tc, **kw)


@pytest.mark.parametrize("case", ["nn", "knn10", "pose", "masked"])
def test_search_matches_jax(case):
    """tests/test_grid_knn.py's search scenarios, both packages."""
    rng = np.random.default_rng(17)
    pose = None
    if case == "nn":
        tgt, qry, kw, k = dense_cloud(rng, 3000), dense_cloud(rng, 500), dict(cell_size=2.0), 1
    elif case == "knn10":
        tgt = dense_cloud(rng, 4000, extent=5.0)
        qry, kw, k = tgt[:300], dict(cell_size=2.0, max_per_cell=128), 10
    elif case == "pose":
        tgt, qry, kw, k = dense_cloud(rng, 2000), dense_cloud(rng, 200), dict(cell_size=3.0), 1
        pose = lie_np.se3_exp(np.array([0.1, -0.1, 0.2, 1.0, 0.5, -0.3])).astype(np.float32)
    else:
        tgt, kw, k = dense_cloud(rng, 500), dict(cell_size=5.0), 3
        qry = tgt[:100]
    mask = None
    if case == "masked":
        mask = np.ones(len(tgt), bool)
        mask[::2] = False
    jg, tg = grids(tgt, mask, **kw)
    jq, tq = both(qry)
    jp, tp = (None, None) if pose is None else both(pose)
    jres, tres = jsearch(jg, jq, k, jp), tg.search(tq, k, pose=tp)
    moved = qry if pose is None else qry @ pose[:3, :3].T + pose[:3, 3]
    assert_same_knn(jres, tres, tgt, moved)
    if mask is not None:  # no masked point is ever a finite neighbour
        fin = np.isfinite(np_(tres.distances))
        assert mask[np_(tres.indices)[fin]].all()


@pytest.mark.parametrize("k", [1, 4])
def test_padding_and_edge_queries_match_jax(k):
    """A query whose 27 cells hold no point, a query outside the 21-bit
    range, NaN, and a query with fewer than k candidates: JAX's padding."""
    rng = np.random.default_rng(5)
    tgt = dense_cloud(rng, 300, extent=3.0)
    qry = np.concatenate([tgt[:5], [[50.0, 50.0, 50.0], [3e6, 0.0, 0.0], [np.nan, 0.0, 0.0],
                                    [3.9, 3.9, 3.9]]]).astype(np.float32)
    jg, tg = grids(tgt, cell_size=0.5, max_per_cell=4)
    jq, tq = both(qry)
    jres, tres = jsearch(jg, jq, k), tg.search(tq, k)
    assert_same_knn(jres, tres, tgt, qry)
    assert np.isinf(np_(tres.distances)[5:7]).all()
    # every point masked: all padding
    jm, tm = grids(tgt, np.zeros(len(tgt), bool), cell_size=0.5)
    jres, tres = jsearch(jm, jq, k), tm.search(tq, k)
    assert np.isinf(np_(tres.distances)).all()
    np.testing.assert_array_equal(np_(tres.indices), np_(jres.indices))


def test_remove_points_matches_jax():
    """tests/test_aux.py:24: removal without a rebuild."""
    rng = np.random.default_rng(42)
    pts = rng.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    jg, tg = grids(pts, cell_size=3.0)
    keep = np.arange(tg.points.shape[0]) % 2 == 0  # over the cloud's capacity
    jk, tk = both(keep)
    jq, tq = both(pts[:50])
    jres, tres = jsearch(jg.remove_points(jk), jq, 1), tg.remove_points(tk).search(tq, 1)
    assert_same_knn(jres, tres, pts, pts[:50])
    fin = np.isfinite(np_(tres.distances[:, 0]))
    assert (np_(tres.indices[:, 0])[fin] % 2 == 0).all()
    # radius search: beyond the radius -1 / inf on both
    jr, tr = jg.radius_search(jq, 0.5, 3), tg.radius_search(tq, 0.5, 3)
    np.testing.assert_array_equal(np_(tr.indices) < 0, np_(jr.indices) < 0)


def test_build_counters_and_build_auto_match_jax():
    """600 points in one cell: the overflow is counted, and build_auto
    doubles the budget until nothing is invisible, as JAX does."""
    pts = np.random.default_rng(17).uniform(0, 4.9, size=(600, 3)).astype(np.float32)
    jc, tc = clouds(pts)
    jg, tg = jbuild(jc, cell_size=5.0, max_per_cell=32), TGrid.build(tc, cell_size=5.0, max_per_cell=32)
    assert int(tg.overflow) == int(jg.overflow) == 600 - 32
    assert int(tg.cells_dropped) == int(jg.cells_dropped) == 0
    ja = JGrid.build_auto(jc, cell_size=5.0, max_per_cell=32, max_per_cell_cap=1024)
    ta = TGrid.build_auto(tc, cell_size=5.0, max_per_cell=32, max_per_cell_cap=1024)
    assert (ta.max_per_cell, ta.cell_coords.shape[0]) == (ja.max_per_cell, ja.cell_coords.shape[0])
    assert int(ta.overflow) == int(ta.cells_dropped) == 0
    qry = np.random.default_rng(3).uniform(0, 4.9, size=(64, 3)).astype(np.float32)
    jq, tq = both(qry)
    assert_same_knn(jsearch(ja, jq, 1), ta.search(tq, 1), pts, qry)
    # a full table: cells lost to probe exhaustion are counted, and build_auto
    # doubles the table until none is
    wide = np.random.default_rng(4).uniform(-40, 40, size=(2000, 3)).astype(np.float32)
    jc, tc = clouds(wide)
    jg, tg = jbuild(jc, 1.0, table_capacity=256, max_probes=2), TGrid.build(tc, 1.0, table_capacity=256,
                                                                             max_probes=2)
    assert int(tg.cells_dropped) > 0 and int(jg.cells_dropped) > 0
    ta, ja = TGrid.build_auto(tc, cell_size=1.0), JGrid.build_auto(jc, cell_size=1.0)
    assert int(ta.cells_dropped) == int(ja.cells_dropped) == 0


def _plane_scene(rng):
    per = 300
    u = rng.uniform(0.2, 5, size=(per, 2)).astype(np.float32)
    z = np.zeros(per, np.float32)
    pts = np.concatenate([np.stack([u[:, 0], u[:, 1], z], 1), np.stack([z, u[:, 0], u[:, 1]], 1),
                          np.stack([u[:, 0], z, u[:, 1]], 1)]) + rng.normal(scale=0.004, size=(900, 3))
    return pts.astype(np.float32)


def test_align_with_grid_matches_jax():
    """tests/test_grid_knn.py's registration scenario: GICP against a grid
    target, both packages (T within 1e-4, inliers equal)."""
    rng = np.random.default_rng(17)
    pts = _plane_scene(rng)
    T_true = lie_np.se3_exp(np.array([0.03, -0.02, 0.04, 0.2, -0.1, 0.1])).astype(np.float32)
    src = ((pts - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)
    out = {}
    for side, (tgt_c, src_c) in (("j", (clouds(pts)[0], clouds(src)[0])), ("t", (clouds(pts)[1], clouds(src)[1]))):
        if side == "j":
            from sycl_points_tpu.ops.covariance import estimate_covariances as jcov, extract_normals as jnrm
            kt = j_knn.brute_force_knn(tgt_c.points, tgt_c.mask, tgt_c.points, 10)
            tgt_c = tgt_c.replace(covs=jcov(tgt_c.points, kt))
            tgt_c = tgt_c.replace(normals=jnrm(tgt_c.points, tgt_c.covs))
            ks = j_knn.brute_force_knn(src_c.points, src_c.mask, src_c.points, 10)
            src_c = src_c.replace(covs=jcov(src_c.points, ks))
            res = jax.jit(lambda s, t, g: j_reg.align(s, t, g, j_reg.RegistrationParams(max_iterations=25)))(
                src_c, tgt_c, jbuild(tgt_c, cell_size=2.0, max_per_cell=64))
        else:
            kt = t_knn.self_knn(tgt_c.points, tgt_c.mask, 10)
            tgt_c = tgt_c.replace(covs=estimate_covariances(tgt_c.points, kt))
            tgt_c = tgt_c.replace(normals=extract_normals(tgt_c.points, tgt_c.covs))
            src_c = src_c.replace(covs=estimate_covariances(src_c.points, t_knn.self_knn(src_c.points, src_c.mask, 10)))
            res = t_reg.align(src_c, tgt_c, TGrid.build(tgt_c, cell_size=2.0, max_per_cell=64),
                              t_reg.RegistrationParams(max_iterations=25))
        out[side] = (np_(res.T), int(res.inlier))
    np.testing.assert_allclose(out["t"][0], out["j"][0], atol=1e-4)
    assert out["t"][1] == out["j"][1]
    err = lie_np.se3_log(np.linalg.inv(T_true) @ out["t"][0])
    assert np.linalg.norm(err) < 0.02


def test_build_target_knn_choice_matches_jax():
    """Brute force at the default threshold, the grid above a lowered one;
    both registrations agree, and agree with JAX's."""
    rng = np.random.default_rng(17)
    tgt = dense_cloud(rng, 4000, extent=8.0)
    src = (dense_cloud(rng, 400, extent=8.0) * 0.98).astype(np.float32)
    (jt, tt), (js, ts) = clouds(tgt), clouds(src)
    t_small = t_knn.build_target_knn(tt, max_correspondence_distance=2.0)
    t_forced = t_knn.build_target_knn(tt, max_correspondence_distance=2.0, threshold=1000)
    assert isinstance(t_small, t_knn.BruteForceKNN) and t_small.target is not None
    assert isinstance(t_forced, TGrid) and t_forced.cell_size == 2.0
    j_forced = j_knn.build_target_knn(jt, max_correspondence_distance=2.0, threshold=1000)
    assert isinstance(j_forced, JGrid)
    params = t_reg.RegistrationParams(reg_type=RegType.POINT_TO_POINT, max_iterations=10)
    res_b, res_g = t_reg.align(ts, tt, t_small, params), t_reg.align(ts, tt, t_forced, params)
    np.testing.assert_allclose(np_(res_g.T), np_(res_b.T), atol=1e-5)
    assert int(res_g.inlier) == int(res_b.inlier)
    jres = j_reg.align(js, jt, j_forced, j_reg.RegistrationParams(reg_type=JRegType.POINT_TO_POINT,
                                                                    max_iterations=10))
    np.testing.assert_allclose(np_(res_g.T), np_(jres.T), atol=1e-5)
    assert int(res_g.inlier) == int(jres.inlier)


def test_coarse_to_fine_with_a_grid_target_is_refused():
    """The coarse phase strides the target's rows; a grid holds them in cell
    order, so both packages refuse it (JAX where it rebuilds the target's
    type for the strided rows)."""
    rng = np.random.default_rng(2)
    (jt, tt), (js, ts) = clouds(dense_cloud(rng, 500)), clouds(dense_cloud(rng, 100))
    with pytest.raises(ValueError, match="coarse-to-fine strides"):
        t_reg.align(ts, tt, TGrid.build(tt, 2.0),
                    t_reg.RegistrationParams(reg_type=RegType.POINT_TO_POINT, coarse_to_fine_iters=2))
    with pytest.raises((TypeError, AttributeError)):
        j_reg.align(js, jt, jbuild(jt, 2.0),
                    j_reg.RegistrationParams(reg_type=JRegType.POINT_TO_POINT, coarse_to_fine_iters=2))


def _replay_tree(T0):
    """``apps.odometry_replay.replay_params`` in the JAX package's tree, on a
    small map, every point taken."""
    return _every_point(P.LidarOdometryParams(
        scan=P.ScanParams(downsampling=P.DownsamplingParams(
            voxel=P.VoxelDownsamplingParams(enable=True, size=1.0), polar=P.PolarDownsamplingParams(enable=False),
            random=P.RandomDownsamplingParams(enable=True, num=5000))),
        submap=P.SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0, map_capacity=1 << 12,
                              extract_capacity=1 << 11, point_random_sampling_num=512),
        scan_capacity=1 << 13,
        pose=P.PoseParams(initial=tuple(np.asarray(T0, np.float32).ravel().tolist()))))


def test_lidar_odometry_on_a_grid_submap_matches_jax(monkeypatch):
    monkeypatch.setattr(j_knn, "GRID_KNN_TARGET_THRESHOLD", 0)
    monkeypatch.setattr(t_knn, "GRID_KNN_TARGET_THRESHOLD", 0)
    poses, scans = odometry_replay.make_scans(3, 512, 32, device="cpu")
    jparams = _replay_tree(poses[0])
    tparams = params_from_reference(jparams)
    assert tparams == _every_point(odometry_replay.replay_params(poses[0], 1 << 12, 1 << 11))
    jlo, tlo = j_lo.LidarOdometry(jparams), t_lo.LidarOdometry(tparams, device="cpu")
    for i, (scan, truth) in enumerate(zip(scans, poses)):
        jr = jlo.process(JCloud.from_numpy(scan.to_numpy()["points"], capacity=scan.capacity), 0.1 * (i + 1))
        assert isinstance(jlo.submap.submap_knn, (JGrid, j_knn.BruteForceKNN))
        tr = tlo.process(scan, 0.1 * (i + 1))
        assert isinstance(tlo.submap.submap_knn, TGrid)
        assert (jr.value, tr.value) == (("first_frame",) * 2 if i == 0 else ("success",) * 2)
        trans, rot = pose_gap(tlo.get_odometry(), np.asarray(jlo.get_odometry()))
        assert trans < 1e-3 and rot < 1e-3, (i, trans, rot)
        trans, rot = pose_gap(tlo.get_odometry(), truth)
        assert trans < 0.1 and rot < 0.05, (i, trans, rot)


def _tie_lattice():
    g = np.arange(-2.0, 2.0, 0.5, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([pts, pts[::3]])
    mask = np.arange(len(pts)) % 11 != 0
    h = np.arange(-2.5, 2.5, 0.5, dtype=np.float32) + np.float32(0.25)
    n = np.arange(-2.0, 2.0, 1.0, dtype=np.float32)
    q = np.concatenate([np.stack(np.meshgrid(h, h, h, indexing="ij"), -1).reshape(-1, 3),
                        np.stack(np.meshgrid(n, n, n, indexing="ij"), -1).reshape(-1, 3),
                        [[2.75, 2.75, 2.75], [500.0, 500.0, 500.0], [4e6, 0.0, 0.0], [np.nan, 0.0, 0.0]]])
    return pts, mask, q.astype(np.float32)


@pytest.mark.parametrize("budget", [32, 4])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_tie_lattice_matches_jax_index_for_index(k, budget):
    """Exact ties across cells and among one cell's lanes, cells over the
    budget, fewer candidates than k: the plain search (what the card's
    kernels are held to bit for bit) equals JAX's, every index and
    distance."""
    pts, mask, qry = _tie_lattice()
    jg, tg = grids(pts, mask, cell_size=1.0, max_per_cell=budget)
    jq, tq = both(qry)
    jres, tres = jsearch(jg, jq, k), tg.search(tq, k)
    np.testing.assert_array_equal(np_(tres.indices), np_(jres.indices))
    np.testing.assert_array_equal(np_(tres.distances), np_(jres.distances))
    d = np_(tres.distances)[:-3]
    if k > 1:
        assert (d[:, 1:] == d[:, :-1]).any()  # the ties are there
    if k == 16:
        assert np.isinf(d[:, -1]).any()  # and rows with fewer candidates than k


@pytest.mark.parametrize("n_sm", [132, 114, 8])
def test_grid_lanes_fill_the_card(n_sm):
    """The lane planner: a lane count of GRID_LANES, never rising with the
    query count; 32 lanes while Q x 32 threads do not fill the card, the
    fewest lanes that fill it beyond; on the H100 (132 SMs) 32 lanes at 1 to
    5,000 queries, 16 at 12,000 and 8 at 30,000."""
    counts = [1, 31, 1000, 5000, 12000, 16384, 30000, 1 << 20]
    lanes = [cuda_knn.grid_lanes(q, n_sm) for q in counts]
    assert set(lanes) <= set(cuda_knn.GRID_LANES)
    assert lanes == sorted(lanes, reverse=True)
    want = cuda_knn.GRID_THREADS_PER_SM * n_sm
    for q, g in zip(counts, lanes):
        assert q * g >= want or g == max(cuda_knn.GRID_LANES)
        assert g == min(cuda_knn.GRID_LANES) or q * (g // 2) < want
    if n_sm == 132:
        assert lanes[:6] + lanes[6:7] == [32, 32, 32, 32, 16, 16, 8]


def test_cpu_wrappers_run_the_plain_search():
    pts, mask, qry = _tie_lattice()
    _, tg = grids(pts, mask, cell_size=1.0, max_per_cell=4)
    q = torch.from_numpy(qry)
    before = dict(cuda_knn.launch_counts)
    ref = t_grid_knn.grid_search_plain(tg, q, 5)
    for got in (t_grid_knn.grid_search(tg, q, 5, lanes=8), t_grid_knn.grid_search_simple(tg, q, 5)):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert cuda_knn.launch_counts == before
    with pytest.raises(ValueError):
        t_grid_knn.grid_search(tg, q, 5, lanes=12)
    with pytest.raises(ValueError):
        t_grid_knn.grid_search_simple(tg, q, 17)
