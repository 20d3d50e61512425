"""The port's work split over devices (``parallel/sharded.py``) and its
device helper (``utils/device.py``), on the CPU with meshes of CPU entries.

  * ``sharded_align`` on a one-entry mesh equals ``align`` bit for bit; on a
    two-entry mesh (two shards, their partial sums added) it matches
    ``align`` and JAX's ``sharded_align`` on its 8-device CPU mesh within
    ``tests/test_multichip.py``'s bounds: T within 1e-4, inliers equal;
  * ``shard_cloud`` / ``replicate`` / ``stack_clouds`` place what they say;
  * ``sharded_knn`` equals ``brute_force_knn`` bit for bit;
  * ``align_pairs_batched`` over two entries: each pair equals
    ``align_streams`` of that pair alone bit for bit, and the sequential
    ``align`` within 5e-3 (``tests/test_multichip.py``'s bound), as JAX's
    batched align does;
  * ``select_device`` and ``device_info`` on a machine without a card.
"""

import numpy as np
import pytest
import torch

from _torch_parity import np_

import __graft_entry__ as ge
from sycl_points_tpu.parallel import sharded as j_sharded
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu.registration.factors import RegType as JRegType
from sycl_points_tpu.registration.registration import RegistrationParams as JParams
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.ops.knn import BruteForceKNN, brute_force_knn
from sycl_points_tpu_torch.parallel import sharded
from sycl_points_tpu_torch.points.point_cloud import PointCloud
from sycl_points_tpu_torch.registration.factors import RegType
from sycl_points_tpu_torch.registration.registration import RegistrationParams, align, align_streams
from sycl_points_tpu_torch.utils import device as t_device

CPU = torch.device("cpu")


def _port(jc) -> PointCloud:
    return PointCloud(**{f: None if getattr(jc, f) is None else torch.from_numpy(np.array(getattr(jc, f)))
                         for f in PointCloud.__dataclass_fields__})


def test_sharded_align_matches_align_and_jax():
    jsrc, jtgt = ge._make_pair(n_src=512, n_tgt=768)
    src, tgt = _port(jsrc), _port(jtgt)
    params = RegistrationParams(max_iterations=5)
    ref = align(src, tgt, BruteForceKNN.build(tgt), params)
    one = sharded.sharded_align([CPU], src, tgt, params)
    for a, b in zip(one, ref):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    two = sharded.sharded_align([CPU, CPU], src, tgt, params)
    np.testing.assert_allclose(np_(two.T), np_(ref.T), atol=1e-4)
    assert int(two.inlier) == int(ref.inlier)
    jgot = j_sharded.sharded_align(j_sharded.make_mesh(8), jsrc, jtgt, JParams(max_iterations=5))
    np.testing.assert_allclose(np_(two.T), np.asarray(jgot.T), atol=1e-4)
    assert int(two.inlier) == int(jgot.inlier)


def test_placement_helpers():
    rng = np.random.default_rng(0)
    cloud = PointCloud.from_numpy(rng.normal(size=(10, 3)).astype(np.float32), capacity=16, device="cpu")
    parts = sharded.shard_cloud(cloud, [CPU, CPU, CPU])
    assert [p.capacity for p in parts] == [6, 5, 5]
    assert torch.equal(torch.cat([p.points for p in parts]), cloud.points)
    assert all(torch.equal(r.points, cloud.points) for r in sharded.replicate(cloud, [CPU, CPU]))
    stacked = sharded.stack_clouds([cloud, cloud])
    assert stacked.points.shape == (2, 16, 3) and stacked.covs is None


def test_sharded_knn_equals_brute_force():
    rng = np.random.default_rng(1)
    tgt = PointCloud.from_numpy(rng.uniform(-5, 5, size=(700, 3)).astype(np.float32), device="cpu")
    q = torch.from_numpy(rng.uniform(-5, 5, size=(301, 3)).astype(np.float32))
    got = sharded.sharded_knn([CPU, CPU], tgt, q, 4)
    ref = brute_force_knn(tgt.points, tgt.mask, q, 4)
    assert torch.equal(got.indices, ref.indices) and torch.equal(got.distances, ref.distances)


def test_align_pairs_batched_matches_streams_and_sequential():
    rng = np.random.default_rng(5)
    pairs = []
    for b in range(8):
        tgt_pts = rng.uniform(-5, 5, size=(200, 3)).astype(np.float32)
        t = np.array([0.08 + 0.01 * b, -0.05, 0.02], np.float32)
        pairs.append((PointCloud.from_numpy(tgt_pts - t, capacity=256, device="cpu"),
                      PointCloud.from_numpy(tgt_pts, capacity=256, device="cpu")))
    jparams = JParams(reg_type=JRegType.POINT_TO_POINT, optimization_method="gauss_newton", max_iterations=15)
    params = params_from_reference(jparams)
    assert params.reg_type is RegType.POINT_TO_POINT
    srcs, tgts = sharded.stack_clouds([p[0] for p in pairs]), sharded.stack_clouds([p[1] for p in pairs])
    batched = sharded.align_pairs_batched([CPU, CPU], srcs, tgts, params)
    assert batched.T.shape == (8, 4, 4)
    for half in range(2):
        sl = slice(4 * half, 4 * half + 4)
        s, t = sharded.stack_clouds([p[0] for p in pairs[sl]]), sharded.stack_clouds([p[1] for p in pairs[sl]])
        alone = align_streams(s, t, BruteForceKNN(points=t.points, mask=t.mask), params)
        assert torch.equal(batched.T[sl], alone.T)
    jbatched = j_sharded.align_pairs_batched(
        j_sharded.make_mesh(8), j_sharded.stack_clouds([ge_cloud(p[0]) for p in pairs]),
        j_sharded.stack_clouds([ge_cloud(p[1]) for p in pairs]), jparams)
    for b, (s, t) in enumerate(pairs):
        ref = align(s, t, BruteForceKNN.build(t), params)
        np.testing.assert_allclose(np_(batched.T[b]), np_(ref.T), atol=5e-3)
        np.testing.assert_allclose(np_(batched.T[b]), np.asarray(jbatched.T)[b], atol=5e-3)


def ge_cloud(c: PointCloud):
    return JCloud.from_numpy(c.points.numpy()[c.mask.numpy()], capacity=c.capacity)


def test_device_helpers_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = t_device.select_device()
    assert d.type == "cpu"
    assert t_device.select_device("nvidia", "gpu").type == "cpu"  # nothing matches: the first device
    info = t_device.device_info(d)
    assert info["platform"] == "cpu" and info["count"] == 1
    t_device.print_device_info()
    with pytest.raises(RuntimeError, match="is_available"):
        sharded.make_mesh()
