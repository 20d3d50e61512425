"""Parity of the port's preprocessing (box filter, voxel downsample,
covariances, normals) with the JAX package on a synthetic LiDAR scan.

Tolerances:
  * box filter: masks equal;
  * voxel downsample: masks and voxel order equal, means within atol=2e-5
    (float32 sums of up to ~50 m coordinates, taken in another order),
    intensity medians equal;
  * covariances from the same neighbour indices: rtol=1e-4, atol=1e-6;
  * normals from the same covariances: dot >= 1 - 1e-5 (same sign).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_parity import both, clouds, np_

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
from synthetic_velodyne import World, figure8_trajectory, scan_at  # noqa: E402

from sycl_points_tpu.ops import covariance as j_cov  # noqa: E402
from sycl_points_tpu.ops import filters as j_filters  # noqa: E402
from sycl_points_tpu.ops import voxel as j_voxel  # noqa: E402
from sycl_points_tpu.ops.knn import KNNResult as JKNN, approx_knn  # noqa: E402
from sycl_points_tpu_torch.ops import covariance as t_cov  # noqa: E402
from sycl_points_tpu_torch.ops import filters as t_filters  # noqa: E402
from sycl_points_tpu_torch.ops import voxel as t_voxel  # noqa: E402
from sycl_points_tpu_torch.ops.knn import KNNResult as TKNN  # noqa: E402


@pytest.fixture(scope="module")
def scan():
    pose = figure8_trajectory(3, speed=0.7)[2]
    return scan_at(World(), pose, n_az=256, n_rings=24)


def test_box_filter_matches_jax(scan):
    rng = np.random.default_rng(0)
    pts = scan.copy()
    pts[::97] = np.nan
    pts[1::89] = [0.3, -0.2, 0.1]  # inside the 0.5 m box
    pts[2::83] *= 3.0  # some beyond 50 m
    jc, tc = clouds(pts, capacity=len(pts) + 100)
    tc = tc.replace(mask=both(rng.uniform(size=tc.capacity) > 0.1)[1])
    jc = jc.replace(mask=both(np_(tc.mask))[0])
    jm = np_(j_filters.box_filter(jc, 0.5, 50.0).mask)
    tm = np_(t_filters.box_filter(tc, 0.5, 50.0).mask)
    np.testing.assert_array_equal(tm, jm)
    assert 0 < tm.sum() < len(pts)


def _attrs(n, rng):
    return dict(
        intensities=rng.integers(0, 20, size=n).astype(np.float32),
        rgb=rng.uniform(size=(n, 4)).astype(np.float32),
        timestamp_offsets=rng.uniform(0, 100, size=n).astype(np.float32),
    )


@pytest.mark.parametrize("voxel,out_capacity", [(0.25, None), (0.5, 512), (1.0, None)])
def test_voxel_downsample_matches_jax(scan, voxel, out_capacity):
    rng = np.random.default_rng(1)
    jc, tc = clouds(scan, capacity=len(scan) + 37, **_attrs(len(scan), rng))
    jc = j_filters.box_filter(jc, 0.5, 50.0)
    tc = t_filters.box_filter(tc, 0.5, 50.0)
    jv, jlost = j_voxel.voxel_downsample(jc, voxel, out_capacity=out_capacity, return_lost=True)
    tv, tlost = t_voxel.voxel_downsample(tc, voxel, out_capacity=out_capacity, return_lost=True)
    assert int(jlost) == int(tlost)
    mask = np_(jv.mask)
    np.testing.assert_array_equal(np_(tv.mask), mask)
    if out_capacity is not None:
        assert mask.all(), "the voxel count should exceed out_capacity (truncation case)"
    else:
        assert 0 < mask.sum() < len(mask) and not mask[mask.sum():].any()
    for name in ("points", "rgb", "timestamp_offsets"):
        np.testing.assert_allclose(np_(getattr(tv, name))[mask], np_(getattr(jv, name))[mask], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(np_(tv.intensities)[mask], np_(jv.intensities)[mask])


def test_voxel_downsample_carries_covs_and_normals():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-4, 4, size=(2000, 3)).astype(np.float32)
    covs = rng.normal(size=(2000, 3, 3)).astype(np.float32)
    covs = covs @ covs.transpose(0, 2, 1)
    normals = rng.normal(size=(2000, 3)).astype(np.float32)
    jc, tc = clouds(pts, covs=covs, normals=normals)
    jv = j_voxel.voxel_downsample(jc, 1.0, min_voxel_count=3)
    tv = t_voxel.voxel_downsample(tc, 1.0, min_voxel_count=3)
    mask = np_(jv.mask)
    np.testing.assert_array_equal(np_(tv.mask), mask)
    assert 0 < mask.sum() < len(mask)
    for name in ("points", "covs", "normals"):
        np.testing.assert_allclose(np_(getattr(tv, name))[mask], np_(getattr(jv, name))[mask], rtol=1e-5, atol=2e-5)


@pytest.fixture(scope="module")
def voxels_with_knn(scan):
    jc, tc = clouds(scan)
    jv = j_voxel.voxel_downsample(j_filters.box_filter(jc, 0.5, 50.0), 0.25, out_capacity=4096)
    knn = approx_knn(jv.points, jv.mask, jv.points, 10)
    return jv, knn


def test_estimate_covariances_matches_jax(voxels_with_knn):
    jv, knn = voxels_with_knn
    pts = np_(jv.points)
    idx, d2 = np_(knn.indices), np_(knn.distances).copy()
    d2[::11, -3:] = np.inf  # some neighbourhoods short of valid neighbours
    d2[::13, :] = np.inf
    jcov = j_cov.estimate_covariances(both(pts)[0], JKNN(both(idx)[0], both(d2)[0]))
    tcov = t_cov.estimate_covariances(both(pts)[1], TKNN(both(idx)[1], both(d2)[1]))
    np.testing.assert_allclose(np_(tcov), np_(jcov), rtol=1e-4, atol=1e-6)


def test_extract_normals_matches_jax(voxels_with_knn):
    jv, knn = voxels_with_knn
    mask = np_(jv.mask)
    pts = np_(jv.points)
    covs = np_(j_cov.estimate_covariances(jv.points, knn))
    jn = np_(j_cov.extract_normals(both(pts)[0], both(covs)[0]))[mask]
    tn = np_(t_cov.extract_normals(both(pts)[1], both(covs)[1]))[mask]
    dot = np.sum(jn * tn, axis=1)
    assert dot.min() >= 1 - 1e-5, f"{np.sum(dot < 1 - 1e-5)} of {len(dot)} normals differ"


def test_point_cloud_ops_match_jax():
    """compact_device (with truncation), merge, filter_by_mask, transform."""
    from sycl_points_tpu.ops import transform as j_tf
    from sycl_points_tpu.points import point_cloud as j_pc
    from sycl_points_tpu_torch.ops import transform as t_tf
    from sycl_points_tpu_torch.points import point_cloud as t_pc

    rng = np.random.default_rng(4)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    normals = rng.normal(size=(300, 3)).astype(np.float32)
    jc, tc = clouds(pts, capacity=512, normals=normals, intensities=rng.uniform(size=300).astype(np.float32))
    keep = rng.uniform(size=512) > 0.3
    jc, tc = j_pc.filter_by_mask(jc, both(keep)[0]), t_pc.filter_by_mask(tc, both(keep)[1])
    for cap in (None, 100):
        ja, ta = j_pc.compact_device(jc, cap), t_pc.compact_device(tc, cap)
        for name in ("points", "mask", "normals", "intensities"):
            np.testing.assert_array_equal(np_(getattr(ta, name)), np_(getattr(ja, name)))
    jm, tm = j_pc.merge(jc, ja), t_pc.merge(tc, ta)
    for name in ("points", "mask", "normals", "intensities"):
        np.testing.assert_array_equal(np_(getattr(tm, name)), np_(getattr(jm, name)))
    for n in (1, 256, 257, 700, 1000, 5000, 24000, 131072):
        assert t_pc.pad_capacity_for(n) == j_pc.pad_capacity_for(n)

    covs = rng.normal(size=(512, 3, 3)).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    T[:3, 3] = [1.0, -2.0, 0.5]
    ja = j_tf.transform_cloud(jc.replace(covs=both(covs)[0]), both(T)[0])
    ta = t_tf.transform_cloud(tc.replace(covs=both(covs)[1]), both(T)[1])
    for name in ("points", "normals", "covs"):
        np.testing.assert_allclose(np_(getattr(ta, name)), np_(getattr(ja, name)), rtol=1e-5, atol=1e-6)
