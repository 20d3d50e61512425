"""The port's polar downsampling and intensity ops against the JAX package,
on the CPU.

  * ``polar_coords`` in both coordinate systems: the integer bins and the
    validity mask equal exactly, on points kept 1e-4 of a bin away from
    every bin edge (``atan2`` rounds differently in the two packages, so a
    point on an edge may fall either way), with invalid, non-finite, zero and
    on-axis points among them;
  * ``polar_downsample``: the clouds as sets (rows sorted by position),
    points atol 1e-5, the attribute means and the intensity median rtol 1e-5;
  * every intensity op on one JAX k-NN result fed to both sides (some
    neighbours missing): rtol 1e-5, atol 1e-6;
  * the argument errors, by message, on both sides.
"""

import numpy as np
import pytest
import torch

from _torch_parity import both, clouds, np_

from sycl_points_tpu.ops import intensity as j_int
from sycl_points_tpu.ops import polar as j_polar
from sycl_points_tpu.ops.knn import KNNResult as JKNN
from sycl_points_tpu.ops.knn import brute_force_knn
from sycl_points_tpu_torch.ops import intensity as t_int
from sycl_points_tpu_torch.ops import polar as t_polar
from sycl_points_tpu_torch.ops.knn import KNNResult as TKNN

from test_torch_hash_map import _sorted_cloud

DEG = np.pi / 180.0
SIZES = (1.0, 3.0 * DEG, 3.0 * DEG)  # the parameter tree's defaults


def _polar64(p, system):
    x, y, z = (p[:, i].astype(np.float64) for i in range(3))
    r = np.sqrt(x * x + y * y + z * z)
    if system == "LIDAR":
        return r, np.arctan2(z, np.hypot(x, y)), np.arctan2(y, x)
    return r, np.arctan2(-y, np.hypot(x, z)), np.arctan2(x, z)


def _scan(rng, n, system, margin=1e-4):
    """Points of a LiDAR-like shell, kept ``margin`` of a bin from every
    edge, then a few invalid ones."""
    d = rng.normal(size=(4 * n, 3))
    d[:, 2] *= 0.2
    p = (d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(2, 40, (4 * n, 1))).astype(np.float32)
    frac = [np.abs(v / s - np.round(v / s)) for v, s in zip(_polar64(p, system), SIZES)]
    p = p[np.all([f > margin for f in frac], axis=0)][:n]
    assert len(p) == n
    p[:4] = [[0, 0, 0], [np.nan, 1, 1], [0, 0, 5], [0, 5, 0]]  # zero, non-finite, on the two polar axes
    return p


@pytest.mark.parametrize("system", ["LIDAR", "CAMERA"])
def test_polar_coords(system):
    rng = np.random.default_rng(3)
    pts = _scan(rng, 3000, system)
    valid = np.ones(len(pts), bool)
    valid[10::50] = False
    (jp, tp), (jv, tv) = both(pts), both(valid)
    jc, jok = j_polar.polar_coords(jp, jv, *SIZES, j_polar.CoordinateSystem[system])
    tc, tok = t_polar.polar_coords(tp, tv, *SIZES, t_polar.CoordinateSystem.from_string(system.lower()))
    np.testing.assert_array_equal(np_(tok), np_(jok))
    np.testing.assert_array_equal(np_(tc), np_(jc))
    assert tc.dtype == torch.int32 and 2500 < int(tok.sum()) < 3000


@pytest.mark.parametrize("system", ["LIDAR", "CAMERA"])
@pytest.mark.parametrize("out_capacity", [None, 1024], ids=["input-capacity", "scan-capacity"])
def test_polar_downsample(system, out_capacity):
    rng = np.random.default_rng(5)
    pts = _scan(rng, 3000, system)
    n = len(pts)
    attrs = dict(intensities=rng.uniform(0, 100, n).astype(np.float32),
                 rgb=rng.uniform(0, 1, (n, 4)).astype(np.float32),
                 timestamp_offsets=rng.uniform(0, 100, n).astype(np.float32))
    jc, tc = clouds(pts, capacity=4096, **attrs)
    jo = j_polar.polar_downsample(jc, *SIZES, j_polar.CoordinateSystem[system], out_capacity=out_capacity)
    to = t_polar.polar_downsample(tc, *SIZES, t_polar.CoordinateSystem[system], out_capacity=out_capacity)
    assert to.capacity == jo.capacity == (out_capacity or 4096)
    a, b = _sorted_cloud(jo), _sorted_cloud(to)
    assert len(b["points"]) == int(jo.count()) and 200 < len(b["points"]) < n
    np.testing.assert_allclose(b["points"], a["points"], atol=1e-5)
    for name in ("rgb", "intensities"):
        np.testing.assert_allclose(b[name], a[name], rtol=1e-5, atol=1e-6, err_msg=name)


# --------------------------------------------------------------------------
# intensity ops
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def neighbourhoods():
    """A cloud with normals and intensities (near-zenith and at-sensor points
    among them) and its JAX k=10 self-k-NN, some neighbours knocked out."""
    rng = np.random.default_rng(9)
    n = 600
    pts = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    pts[0] = [0, 0, 0]
    pts[1] = [0, 0, 3.0]
    pts[2] = [1e-8, 0, -2.0]
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[5] = 0.0  # no normal: the angle factor is 1
    inten = rng.uniform(0, 200, n).astype(np.float32)
    jc, tc = clouds(pts, capacity=640, normals=nrm, intensities=inten)
    knn = brute_force_knn(jc.points, jc.mask, jc.points, 10)
    idx, d2 = np.array(knn.indices), np.array(knn.distances)
    idx[7, 3:] = -1
    d2[8, 5:] = np.inf
    (ji, ti), (jd, td) = both(idx), both(d2)
    return jc, tc, JKNN(ji, jd), TKNN(ti, td)


def _close(tc, jc):
    m = np_(jc.mask)
    np.testing.assert_allclose(np_(tc.intensities)[m], np_(jc.intensities)[m], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(exponent=1.5, scale=1e-3, max_intensity=1.0, ref_distance=2.0),
                                dict(angle_exponent=0.5, max_intensity=1e6)], ids=["defaults", "scaled", "angle"])
def test_correct_intensity(neighbourhoods, kw):
    jc, tc, _, _ = neighbourhoods
    _close(t_int.correct_intensity(tc, **kw), j_int.correct_intensity(jc, **kw))


@pytest.mark.parametrize("k_limit", [0, 6])
def test_smooth_intensity(neighbourhoods, k_limit):
    jc, tc, jk, tk = neighbourhoods
    args = (0.3, 0.5, 0.05)
    jo, to = j_int.smooth_intensity(jc, jk, *args, k_limit=k_limit), t_int.smooth_intensity(tc, tk, *args,
                                                                                          k_limit=k_limit)
    _close(to, jo)
    assert not np.allclose(np_(to.intensities), np_(tc.intensities))


def test_local_mean_normalize(neighbourhoods):
    jc, tc, jk, tk = neighbourhoods
    args = (0.3, 0.5, 0.5, 1e-3)
    _close(t_int.local_mean_normalize(tc, tk, *args, k_limit=8), j_int.local_mean_normalize(jc, jk, *args, k_limit=8))


@pytest.mark.parametrize("sigma_min", [0.01, 50.0])
def test_intensity_zscore(neighbourhoods, sigma_min):
    jc, tc, jk, tk = neighbourhoods
    to = t_int.intensity_zscore(tc, tk, sigma_min)
    _close(to, j_int.intensity_zscore(jc, jk, sigma_min))
    assert (np_(to.intensities) == 0).any() == (sigma_min == 50.0)


def _no_intensity(c):
    return c.replace(intensities=None)


@pytest.mark.parametrize("call,message", [
    (lambda m, c, k: m.correct_intensity(_no_intensity(c)), "intensity field not found"),
    (lambda m, c, k: m.correct_intensity(c, exponent=-1.0), "exponent must be non-negative"),
    (lambda m, c, k: m.correct_intensity(c, ref_distance=0.0), "ref_distance must be positive"),
    (lambda m, c, k: m.smooth_intensity(_no_intensity(c), k, 0.3, 0.5), "intensity field not found"),
    (lambda m, c, k: m.smooth_intensity(c, k, 0.0, 0.5), "all sigma values must be positive"),
    (lambda m, c, k: m.local_mean_normalize(c, k, 0.3, 0.5, mean_min=0.0), "mean_min must be positive"),
    (lambda m, c, k: m.local_mean_normalize(c, k, 0.3, -0.5), "all sigma values must be positive"),
    (lambda m, c, k: m.intensity_zscore(_no_intensity(c), k), "intensity field not found"),
    (lambda m, c, k: m.intensity_zscore(c, k._replace(indices=k.indices[:, :2], distances=k.distances[:, :2])),
     "neighbors.k must be >= 3"),
], ids=["correct-none", "exponent", "ref-distance", "smooth-none", "sigma", "mean-min", "normalize-sigma",
        "zscore-none", "zscore-k"])
def test_argument_errors(neighbourhoods, call, message):
    jc, tc, jk, tk = neighbourhoods
    for module, cloud, knn in ((j_int, jc, jk), (t_int, tc, tk)):
        with pytest.raises(ValueError, match=message):
            call(module, cloud, knn)


def test_polar_coordinate_system_errors():
    assert t_polar.CoordinateSystem.from_string(" camera ") is t_polar.CoordinateSystem.CAMERA
    with pytest.raises(KeyError):
        t_polar.CoordinateSystem.from_string("ENU")
    with pytest.raises(ValueError):
        t_polar.polar_coords(torch.zeros(4, 3), torch.ones(4, dtype=torch.bool), *SIZES, "lidar")
