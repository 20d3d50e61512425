"""The rest of the JAX package's API in the port, against the JAX package on
the CPU, on the JAX tests' own scenarios.

  * ``ops.filters``: statistical and radius outlier removal
    (``test_filters_sampling.py``'s scenes), each side on its own self-k-NN:
    the masks equal, 0 points flipped (a point within float32 rounding of the
    SOR threshold could flip: the global sums run in another order; none
    does on these scenes);
  * ``ops.sampling.farthest_point_sampling``: the JAX first index given to
    the port (its draw comes from another generator), then the selections
    equal exactly, on the JAX test's grid and on a padded cloud;
  * ``ops.prefix_sum``: every helper equal to JAX's, values and dtypes;
    ``scatter_compact`` drops rows past ``out_size`` as ``mode="drop"`` does;
  * ``ops.preprocess_filter.PreprocessFilter``: the JAX facade test's counts;
  * ``PointCloud.has_*`` and ``merge_with_timestamps`` against JAX's;
  * ``points.io`` writers: PLY (binary, ascii) and PCD (binary, ascii,
    binary_compressed) files byte-equal to JAX's for the same dict (non-finite
    points skipped), read back by the port's readers; both LZF compressors
    byte-equal to JAX's, and every stream decodes with every decoder;
  * ``points.native_io``: built into the port's ``_build``, the readers and
    the prefetching loader equal to JAX's native ones and to the numpy
    readers (``test_native_io.py``'s cases but the bundled pair), the codec's
    corrupt-stream and worst-case contracts;
  * ``EnhancedReflectivityCorrector`` equal to JAX's over two scans (its EMA
    state included), ``measure_execution`` / ``StageTimer``,
    ``profiling.trace`` writing a Chrome trace that names the annotated span,
    the covariance markers' mesh against JAX's (vertices within 1e-4 m, faces
    equal), ``RegType.from_string`` and ``RobustLossType.from_string``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import clouds, np_

from sycl_points_tpu.apps import covariance_markers as j_markers
from sycl_points_tpu.ops import filters as j_filters
from sycl_points_tpu.ops import prefix_sum as j_ps
from sycl_points_tpu.ops import sampling as j_sampling
from sycl_points_tpu.ops.covariance import estimate_covariances as j_covs
from sycl_points_tpu.ops.knn import brute_force_knn
from sycl_points_tpu.ops.robust import RobustLossType as JLoss
from sycl_points_tpu.points import conversion as j_conv
from sycl_points_tpu.points import io as j_io
from sycl_points_tpu.points import native_io as j_native
from sycl_points_tpu.points import point_cloud as j_pc
from sycl_points_tpu.registration.factors import RegType as JRegType
from sycl_points_tpu_torch.apps import covariance_markers as t_markers
from sycl_points_tpu_torch.ops import filters as t_filters
from sycl_points_tpu_torch.ops import prefix_sum as t_ps
from sycl_points_tpu_torch.ops import sampling as t_sampling
from sycl_points_tpu_torch.ops.covariance import estimate_covariances as t_covs
from sycl_points_tpu_torch.ops.knn import self_knn
from sycl_points_tpu_torch.ops.preprocess_filter import PreprocessFilter
from sycl_points_tpu_torch.ops.robust import RobustLossType as TLoss
from sycl_points_tpu_torch.points import conversion as t_conv
from sycl_points_tpu_torch.points import io as t_io
from sycl_points_tpu_torch.points import native_io as t_native
from sycl_points_tpu_torch.points import point_cloud as t_pc
from sycl_points_tpu_torch.registration.factors import RegType as TRegType
from sycl_points_tpu_torch.utils import profiling
from sycl_points_tpu_torch.utils.timing import StageTimer, measure_execution


def _knn_both(pts, k):
    jc, tc = clouds(pts)
    jk = brute_force_knn(jc.points, jc.mask, jc.points, k)
    tk = self_knn(tc.points, tc.mask, k)
    return jc, tc, jk, tk


# -- filters and sampling ---------------------------------------------------------


def test_statistical_outlier_removal_matches_jax():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(200, 3)).astype(np.float32)
    pts = np.concatenate([base, base[:5] + 50.0])
    jc, tc, jk, tk = _knn_both(pts, 10)
    for mult in (1.0, 0.5, 2.0):
        jm = np_(j_filters.statistical_outlier_removal(jc, jk, stddev_mul_thresh=mult).mask)
        tm = np_(t_filters.statistical_outlier_removal(tc, tk, stddev_mul_thresh=mult).mask)
        np.testing.assert_array_equal(tm, jm)  # 0 flips
    assert not tm[200:205].any() and tm[:200].mean() > 0.9


def test_radius_outlier_removal_matches_jax():
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.normal(size=(100, 3)) * 0.5, [[30, 30, 30]]]).astype(np.float32)
    jc, tc, jk, tk = _knn_both(pts, 6)
    for radius, min_n in ((1.0, 3), (0.5, 2), (0.3, 5)):
        jm = np_(j_filters.radius_outlier_removal(jc, jk, radius=radius, min_neighbors=min_n).mask)
        tm = np_(t_filters.radius_outlier_removal(tc, tk, radius=radius, min_neighbors=min_n).mask)
        np.testing.assert_array_equal(tm, jm)
    tm = np_(t_filters.radius_outlier_removal(tc, tk, radius=1.0, min_neighbors=3).mask)
    assert not tm[100] and tm[:100].mean() > 0.8


def _jax_first_index(cloud, key):
    n = cloud.capacity
    return int(jnp.argmax(jnp.where(cloud.mask, jax.random.uniform(key, (n,)), -1.0)))


@pytest.mark.parametrize("scene", ["grid", "padded"])
def test_farthest_point_sampling_matches_jax(scene):
    if scene == "grid":
        pts = np.stack(np.meshgrid(np.arange(10), np.arange(10), [0.0]), -1).reshape(-1, 3).astype(np.float32)
        num = 4
    else:
        pts = np.random.default_rng(8).uniform(-20, 20, (700, 3)).astype(np.float32)
        num = 64
    jc, tc = clouds(pts)
    key = jax.random.key(4)
    jout = j_sampling.farthest_point_sampling(jc, num, key)
    first = torch.tensor(_jax_first_index(jc, key))
    tout = t_sampling._farthest_point_sampling(tc, num, first)
    np.testing.assert_array_equal(np_(tout.points), np_(jout.points))
    np.testing.assert_array_equal(np_(tout.mask), np_(jout.mask))
    if scene == "grid":
        sel = np_(tout.points)
        d = np.linalg.norm(sel[:, None] - sel[None], axis=-1)
        d[np.arange(num), np.arange(num)] = np.inf
        assert d.min() > 5.0


def test_farthest_point_sampling_masks_beyond_the_valid_count():
    pts = np.random.default_rng(9).normal(size=(5, 3)).astype(np.float32)
    tc = t_pc.PointCloud.from_numpy(pts, capacity=16, device="cpu")
    out = t_sampling.farthest_point_sampling(tc, 8, torch.Generator().manual_seed(0))
    assert out.capacity == 8 and int(out.count()) == 5
    assert len({tuple(p) for p in np_(out.points)[np_(out.mask)]}) == 5
    assert t_sampling.farthest_point_sampling(tc, 16, torch.Generator()) is tc


def test_prefix_sum_matches_jax():
    x = np.array([1, 2, 3, 4, 0, 7], np.int32)
    for fn in (j_ps.inclusive_scan, j_ps.exclusive_scan):
        got = getattr(t_ps, fn.__name__)(torch.from_numpy(x))
        np.testing.assert_array_equal(np_(got), np.asarray(fn(jnp.asarray(x))))
        assert np_(got).dtype == np.asarray(fn(jnp.asarray(x))).dtype
    xf = np.array([0.5, 1.5, -2.0], np.float32)
    np.testing.assert_array_equal(np_(t_ps.inclusive_scan(torch.from_numpy(xf))),
                                  np.asarray(j_ps.inclusive_scan(jnp.asarray(xf))))
    flags = np.array([True, False, True, True, False, True])
    (jo, jn), (to, tn) = j_ps.compaction_offsets(jnp.asarray(flags)), t_ps.compaction_offsets(torch.from_numpy(flags))
    np.testing.assert_array_equal(np_(to), np.asarray(jo))
    assert int(tn) == int(jn) == 4
    np.testing.assert_array_equal(np_(t_ps.compaction_indices(torch.from_numpy(flags))),
                                  np.asarray(j_ps.compaction_indices(jnp.asarray(flags))))
    vals = np.arange(12.0, dtype=np.float32).reshape(6, 2)
    for out_size in (6, 3):  # 3: the kept rows past it are dropped
        got = t_ps.scatter_compact(torch.from_numpy(vals), torch.from_numpy(flags), out_size)
        np.testing.assert_array_equal(np_(got), np.asarray(j_ps.scatter_compact(jnp.asarray(vals),
                                                                                 jnp.asarray(flags), out_size)))


def test_preprocess_filter_facade():
    """tests/test_conversion_apps.py's facade test on the port."""
    rng = np.random.default_rng(42)
    pf = PreprocessFilter(seed=7, device="cpu")
    pts = rng.normal(size=(300, 3)).astype(np.float32) * 10
    c = t_pc.PointCloud.from_numpy(pts, device="cpu")
    assert int(pf.box_filter(c, 0.5, 15.0).count()) < 300
    samp = pf.random_sampling(c, 50)
    assert samp.capacity == 50 and int(samp.count()) == 50
    w = torch.ones(c.capacity)
    assert int(pf.weighted_random_sampling(c, w, 40).count()) == 40
    assert int(pf.mixed_random_sampling(c, w, 40).count()) == 40
    assert int(pf.farthest_point_sampling(c, 10).count()) == 10
    pf.set_random_seed(7)
    again = pf.random_sampling(c, 50)
    assert torch.equal(again.points, PreprocessFilter(seed=7, device="cpu").random_sampling(c, 50).points)


# -- the point cloud ----------------------------------------------------------------


def test_has_accessors_match_jax():
    pts = np.zeros((4, 3), np.float32)
    for kw in ({}, {"intensities": np.ones(4, np.float32)}, {"normals": np.ones((4, 3), np.float32),
                                                             "timestamp_offsets": np.ones(4, np.float32)}):
        jc, tc = clouds(pts, **kw)
        for name in ("has_cov", "has_normal", "has_rgb", "has_intensity", "has_timestamps"):
            assert getattr(tc, name)() == getattr(jc, name)(), (name, kw)


def test_merge_with_timestamps_matches_jax():
    """tests/test_point_cloud_io.py's base shift, and a side without
    timestamps."""
    def pair(pts, ts):
        jc, tc = clouds(pts, capacity=2)
        if ts is None:
            return jc, tc
        return jc.replace(timestamp_offsets=jnp.asarray(ts)), tc.replace(timestamp_offsets=torch.tensor(ts))

    ja, ta = pair(np.zeros((2, 3), np.float32), [0.0, 10.0])
    jb, tb = pair(np.ones((2, 3), np.float32), [0.0, 5.0])
    jm, js = j_pc.merge_with_timestamps(ja, jb, a_start_ms=100.0, b_start_ms=95.0)
    tm, ts = t_pc.merge_with_timestamps(ta, tb, a_start_ms=100.0, b_start_ms=95.0)
    assert float(ts) == float(js) == 95.0
    np.testing.assert_array_equal(np_(tm.timestamp_offsets), np_(jm.timestamp_offsets))
    np.testing.assert_array_equal(np_(tm.points), np_(jm.points))
    jb2, tb2 = pair(np.ones((2, 3), np.float32), None)
    jm2, js2 = j_pc.merge_with_timestamps(ja, jb2, a_start_ms=100.0)
    tm2, ts2 = t_pc.merge_with_timestamps(ta, tb2, a_start_ms=100.0)
    assert tm2.timestamp_offsets is None and jm2.timestamp_offsets is None and ts2 == js2 == 100.0


# -- the writers and the native library -------------------------------------------------


def _cloud_dict(n=100, seed=11):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    return {
        "points": rng.normal(size=(n, 3)).astype(np.float32) * 10.0,
        "rgb": rng.uniform(size=(n, 4)).astype(np.float32),
        "intensities": rng.uniform(size=(n,)).astype(np.float32) * 100.0,
        "normals": (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32),
    }


WRITERS = {
    "binary.ply": lambda io, p, c: io.write_ply(p, c, binary=True),
    "ascii.ply": lambda io, p, c: io.write_ply(p, c, binary=False),
    "binary.pcd": lambda io, p, c: io.write_pcd(p, c, binary=True),
    "ascii.pcd": lambda io, p, c: io.write_pcd(p, c, binary=False),
    "compressed.pcd": lambda io, p, c: io.write_pcd(p, c, compressed=True),
    "file.ply": lambda io, p, c: io.write_file(p, c),
    "file.pcd": lambda io, p, c: io.write_file(p, c, binary=False),
}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_writers_write_the_jax_bytes(tmp_path, name):
    cloud = _cloud_dict()
    cloud["points"][3] = np.nan
    cloud["points"][7, 0] = np.inf
    ours, theirs = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
    WRITERS[name](t_io, ours, cloud)
    WRITERS[name](j_io, theirs, cloud)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back = t_io.read_file(ours)
    keep = np.isfinite(cloud["points"]).all(1)
    assert back["points"].shape[0] == keep.sum() == 98
    np.testing.assert_allclose(back["points"], cloud["points"][keep], atol=1e-4)
    np.testing.assert_allclose(back["intensities"], cloud["intensities"][keep], atol=1e-3)
    np.testing.assert_allclose(back["normals"], cloud["normals"][keep], atol=1e-4)
    np.testing.assert_allclose(back["rgb"][:, :3], cloud["rgb"][keep, :3], atol=1.5 / 255)


def test_write_file_refuses_other_extensions(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        t_io.write_file(str(tmp_path / "c.xyz"), _cloud_dict(5))


def _lzf_cases():
    rng = np.random.default_rng(7)
    runs = np.zeros((4000, 4), np.float32).tobytes()
    noise = rng.integers(0, 256, size=5000, dtype=np.uint8).tobytes()
    structured = (np.arange(30000, dtype=np.float32) % 256).tobytes()
    return [runs + noise + structured + runs[:1000], b"abcabcabcabc" * 400, (b"x" * 300 + b"pattern" * 100) * 5,
            b"", b"a", rng.integers(0, 256, size=100_000, dtype=np.uint8).tobytes()]


def test_lzf_codecs_match_jax():
    assert t_native.available() and j_native.available()
    for data in _lzf_cases():
        assert t_io._lzf_compress_py(data) == j_io._lzf_compress_py(data)
        assert t_io._lzf_compress(data) == j_io._lzf_compress(data)
        for comp in (t_io._lzf_compress(data), t_io._lzf_compress_py(data)):
            assert t_io._lzf_decompress(comp, len(data)) == data
            assert t_io._lzf_decompress_py(comp, len(data)) == data
            assert j_io._lzf_decompress(comp, len(data)) == data
        assert len(t_native.lzf_compress(data)) <= len(data) + len(data) // 32 + 64


def test_native_lzf_rejects_corrupt_streams():
    data = _lzf_cases()[0]
    c = t_native.lzf_compress(data)
    with pytest.raises(ValueError):
        t_native.lzf_decompress(c[: len(c) // 2], len(data))
    with pytest.raises(ValueError):
        t_native.lzf_decompress(bytes([0x20 | 0x1F, 0xFF]), 2)  # a back-reference before the start


def test_native_library_builds_into_the_port():
    """Compiled from native/sycl_points_io.cpp into the port's own _build,
    never into native/."""
    path = t_native.build_library()
    assert path is not None and os.path.dirname(path) == t_native.BUILD_DIR
    assert os.path.basename(os.path.dirname(t_native.BUILD_DIR)) == "sycl_points_tpu_torch"
    assert os.path.basename(os.path.dirname(t_native.SOURCE)) == "native"


def test_native_readers_match_jax(tmp_path):
    rng = np.random.default_rng(23)
    cloud = {"points": rng.normal(size=(40, 3)).astype(np.float32),
             "intensities": rng.uniform(size=40).astype(np.float32),
             "normals": rng.normal(size=(40, 3)).astype(np.float32)}
    for binary in (False, True):
        p = str(tmp_path / f"a{int(binary)}.ply")
        t_io.write_ply(p, cloud, binary=binary)
        got, want = t_native.read_ply(p), j_native.read_ply(p)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_allclose(got["points"], t_io.read_ply(p)["points"], atol=1e-5)
    raw = rng.normal(size=(128, 4)).astype(np.float32)
    p = str(tmp_path / "0.bin")
    raw.tofile(p)
    got = t_native.read_kitti_bin(p)
    np.testing.assert_array_equal(got["points"], t_conv.read_kitti_bin(p)["points"])
    np.testing.assert_array_equal(got["intensities"], j_native.read_kitti_bin(p)["intensities"])


def test_prefetch_loader(tmp_path):
    """Every scan comes back, in order, the last one too: the library's
    next() returns null while its reader still parses the last path, and the
    port's loader waits for it (repeated, so that the race shows)."""
    paths = []
    for i in range(5):
        p = str(tmp_path / f"{i}.bin")
        np.full((10, 4), float(i), np.float32).tofile(p)
        paths.append(p)
    ply = str(tmp_path / "5.ply")
    t_io.write_ply(ply, {"points": np.full((3, 3), 5.0, np.float32)})
    for _ in range(20):
        with t_native.PrefetchLoader(paths + [ply], prefetch=3) as loader:
            scans = list(loader)
        assert len(scans) == 6
        for i, s in enumerate(scans):
            np.testing.assert_array_equal(s["points"], np.full((10 if i < 5 else 3, 3), float(i), np.float32))


# -- conversion, timing, profiling, markers, enums ------------------------------------


def test_enhanced_reflectivity_matches_jax():
    rng = np.random.default_rng(42)
    n = 200
    pts = rng.uniform(1, 10, size=(n, 3)).astype(np.float32)
    inten = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    ring = (np.arange(n) % 8).astype(np.uint16)
    ambient = rng.uniform(10, 100, size=n).astype(np.float32)
    ring[::17] = 300  # off the ring table
    ours, theirs = t_conv.EnhancedReflectivityCorrector(0.5), j_conv.EnhancedReflectivityCorrector(0.5)
    for scale in (1.0, 1.7):
        got = ours.apply(pts * scale, inten, ring, ambient, clip_max=5.0)
        np.testing.assert_array_equal(got, theirs.apply(pts * scale, inten, ring, ambient, clip_max=5.0))
        assert got.dtype == np.float32 and np.all((got >= 0) & (got <= 5.0)) and (got[::17] == 0).all()
    np.testing.assert_array_equal(ours.ring_mean_ref, theirs.ring_mean_ref)


def test_stage_timer():
    t = StageTimer()
    r, us = measure_execution(lambda: torch.ones(10).sum())
    assert float(r) == 10.0 and us > 0
    t.measure("a", lambda: 1 + 1)
    t.measure("a", lambda: {"x": (torch.zeros(3), [torch.ones(2)])})
    t.add("b", 0.002)
    assert t.count["a"] == 2 and t.averages_us()["b"] == pytest.approx(2000.0)
    assert "TOTAL" in t.report() and "a:" in t.report()


def test_profiling_trace_names_the_span(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("raw.frame"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "raw.frame" for e in events)
    assert any(e.key == "raw.frame" for e in prof.key_averages())


def test_covariance_markers_match_jax(tmp_path):
    """tests/test_aux.py's markers on both packages' covariances of one
    cloud: the same mesh (vertices within 1e-4 m, faces equal)."""
    rng = np.random.default_rng(42)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    jc, tc, jk, tk = _knn_both(pts, 10)
    jc = jc.replace(covs=j_covs(jc.points, jk))
    tc = tc.replace(covs=t_covs(tc.points, tk))
    jv, jf = j_markers.covariance_ellipsoid_mesh(jc, max_markers=10)
    tv, tf = t_markers.covariance_ellipsoid_mesh(tc, max_markers=10)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, atol=1e-4)
    ours, theirs = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    t_markers.write_ellipsoid_ply(ours, tc, max_markers=10)
    j_markers.write_ellipsoid_ply(theirs, jc, max_markers=10)
    head = open(ours, "rb").read(200).decode("ascii", errors="replace")
    assert "element face 800" in head and "element vertex 420" in head
    assert os.path.getsize(ours) == os.path.getsize(theirs)
    with pytest.raises(ValueError, match="no covariances"):
        t_markers.covariance_ellipsoid_mesh(t_pc.PointCloud.from_numpy(pts, device="cpu"))


@pytest.mark.parametrize("name", ["gicp", " GICP ", "p2d", "point_to_plane", "Point_To_Point", "genz",
                                  "point_to_distribution"])
def test_reg_type_from_string_matches_jax(name):
    assert TRegType.from_string(name).name == JRegType.from_string(name).name


@pytest.mark.parametrize("name", ["none", "huber", " Tukey", "CAUCHY", "geman_mcclure"])
def test_robust_loss_from_string_matches_jax(name):
    assert TLoss.from_string(name).name == JLoss.from_string(name).name


def test_from_string_refuses_unknown_names():
    with pytest.raises(KeyError):
        TRegType.from_string("icp")
    with pytest.raises(KeyError):
        TLoss.from_string("l1")
