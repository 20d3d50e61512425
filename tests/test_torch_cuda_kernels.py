"""CUDA kNN kernels against their plain PyTorch versions, on the card.

Needs a CUDA card and nvcc; skips elsewhere. Imports no jax, so it runs on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

Tolerances: indices equal except distance ties within 1e-6; distances within
1e-5 absolute (the kernel and the plain version use the same operation order,
the remaining slack covers the [Q,M] reduction order of the plain version).
The study kernels (nn1_tiled, nn1_bias, nn1_lanes, nn1_unroll2) must equal
nn1_plain exactly: indices and distances, bit for bit.
"""

import numpy as np
import pytest
import torch

import sycl_points_tpu_torch  # noqa: F401  (float32 settings)
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.scripts import bench_nn1_tiles, bench_nn1_variants
from sycl_points_tpu_torch.utils.lie import se3_exp

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]

TIE = 1e-6
D_ATOL = 1e-5

# Every study kernel instance of the two study entry points: label ->
# (launch-count key, call on (t, m, q)); the production nn1 is tested above.
STUDY = {
    label: inst
    for study in (bench_nn1_tiles, bench_nn1_variants)
    for label, inst in study.INSTANCES.items()
    if inst[0] != "nn1"
}


def _cloud(n, seed, extent=50.0, masked_every=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    if masked_every:
        mask[::masked_every] = False
    return torch.from_numpy(pts).cuda(), torch.from_numpy(mask).cuda()


def _pose():
    twist = torch.tensor([0.02, -0.01, 0.05, 0.7, 0.4, -0.1], dtype=torch.float32)
    return se3_exp(twist).cuda().contiguous()


@pytest.mark.parametrize(
    "m,q,masked_every,with_pose",
    [(300, 70, 0, False), (5000, 1000, 7, True), (25000, 1000, 5, True), (2049, 129, 3, False)],
)
def test_nn1_matches_plain(m, q, masked_every, with_pose):
    tgt, mask = _cloud(m, 1, masked_every=masked_every)
    qry, _ = _cloud(q, 2)
    pose = _pose() if with_pose else None
    before = cuda_knn.launch_counts["nn1"]
    i, d = cuda_knn.nn1(tgt, mask.to(torch.uint8), qry, pose)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["nn1"] == before + 1
    ri, rd = cuda_knn.nn1_plain(tgt, mask, qry, pose)
    assert cuda_knn.nn1_mismatches(i, d, ri, rd, TIE) == 0
    torch.testing.assert_close(d, rd, rtol=0, atol=D_ATOL)
    assert bool(mask[i.long()].all())


def test_nn1_all_masked():
    tgt, mask = _cloud(3000, 3)
    qry, _ = _cloud(100, 4)
    i, d = cuda_knn.nn1(tgt, torch.zeros_like(mask), qry, _pose())
    torch.cuda.synchronize()
    assert bool(torch.isinf(d).all()) and bool((i == 0).all())


@pytest.mark.parametrize("m,q,masked_every", [(1, 33, 0), (300, 70, 0), (2049, 129, 3), (25000, 1000, 37)])
@pytest.mark.parametrize("label", sorted(STUDY))
def test_study_kernels_equal_plain(label, m, q, masked_every):
    key, fn = STUDY[label]
    tgt, mask = _cloud(m, 11, masked_every=masked_every)
    qry = _cloud(q, 12)[0]
    before = cuda_knn.launch_counts[key]
    i, d = fn(tgt, mask.to(torch.uint8), qry)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts[key] == before + 1
    ri, rd = cuda_knn.nn1_plain(tgt, mask, qry)
    assert torch.equal(i, ri) and torch.equal(d, rd)


@pytest.mark.parametrize("label", sorted(STUDY))
def test_study_kernels_all_masked(label):
    tgt, mask = _cloud(3000, 13)
    i, d = STUDY[label][1](tgt, torch.zeros_like(mask), _cloud(100, 14)[0])
    torch.cuda.synchronize()
    assert bool(torch.isinf(d).all()) and bool((i == 0).all())


@pytest.mark.parametrize("k", [1, 4, 10, 16])
@pytest.mark.parametrize("m,masked_every", [(500, 0), (25000, 6)])
def test_knn_k_matches_plain(k, m, masked_every):
    tgt, mask = _cloud(m, 5, masked_every=masked_every)
    before = cuda_knn.launch_counts["knn_k"]
    i, d = cuda_knn.knn_k(tgt, mask, tgt, k)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["knn_k"] == before + 1
    ri, rd = cuda_knn.knn_k_plain(tgt, mask, tgt, k)
    assert cuda_knn.knn_mismatches(i, d, ri, rd, TIE) == 0
    torch.testing.assert_close(d, rd, rtol=0, atol=D_ATOL)
    assert bool((d[:, 1:] >= d[:, :-1]).all())


def test_knn_k_fewer_valid_than_k():
    tgt, mask = _cloud(40, 7)
    mask[6:] = False
    i, d = cuda_knn.knn_k(tgt, mask, tgt, 10)
    torch.cuda.synchronize()
    assert bool(torch.isinf(d[:, 6:]).all()) and bool((i[:, 6:] == 0).all())
    assert bool(torch.isfinite(d[:, :6]).all())


def test_wrapper_rejects_bad_inputs():
    tgt, mask = _cloud(100, 8)
    with pytest.raises(ValueError):
        cuda_knn.nn1(tgt[:, :2], mask, tgt)
    with pytest.raises(ValueError):
        cuda_knn.nn1(tgt.t().contiguous().t(), mask, tgt)
    with pytest.raises(TypeError):
        cuda_knn.knn_k(tgt.double(), mask, tgt.double(), 4)
    with pytest.raises(ValueError):
        cuda_knn.knn_k(tgt, mask, tgt, 17)
    with pytest.raises(ValueError):
        cuda_knn.nn1(tgt, mask.cpu(), tgt)
