"""The split-target k-NN of the cluster kernels (``csrc/knn_cluster.cu``),
modelled in plain torch on the CPU, and the prepared target they read.

* ``_kernel_model`` follows the kernel step by step for one query: the
  target cut into S slices of whole tiles, each tile cut among G warp groups,
  a partial best-k per (slice, group) scanned in index order with the
  kernel's insertion rule (strict ``<``, after entries <= d), the optional
  pruning pass (best-k of every ``stride``-th target, the least k-th
  distance over the cluster as the cap, ``nextafter`` so equal distances
  stay), then the lexicographic merge with its early break. It must equal
  the k smallest (d, idx) of a stable sort, bit for bit.
* ``_split_merge`` is the same split-and-merge vectorised over queries, for
  larger clouds and every slice count.
* Both are held to ``knn_k_plain``: equal sets (``knn_mismatches`` with no
  tie tolerance) and equal distances.
* ``prep_target`` keeps its contract, and the CPU wrappers give the same
  answer from a prepared target as from the raw target and mask.

Every comparison is exact: the models compute the kernels' distances
(``e0*e0 + e1*e1 + e2*e2`` in float32) and only reorder them.
"""

import math

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)

from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.ops.knn import BruteForceKNN
from sycl_points_tpu_torch.utils.lie import se3_exp

INF = math.inf


def _cloud(n, seed, extent=5.0, dup=1, masked_every=0):
    """``n`` points uniform in +-extent, repeated ``dup`` times one after the
    other (exact ties across slices); every ``masked_every``-th masked."""
    rng = np.random.default_rng(seed)
    pts = np.tile(rng.uniform(-extent, extent, (n, 3)).astype(np.float32), (dup, 1))
    mask = np.ones(len(pts), bool)
    if masked_every:
        mask[::masked_every] = False
    return torch.from_numpy(pts), torch.from_numpy(mask)


def _sqdist(q, t):
    """``[Q, M]`` distances in the kernels' operation order."""
    e = q[:, None, :] - t[None, :, :]
    return e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]


def _lex_reference(d, k):
    """The k smallest (d, idx) of every row: a stable sort by distance keeps
    the lower index first; missing slots (inf, 0)."""
    ds, order = torch.sort(d, dim=1, stable=True)
    ds, order = ds[:, :k], order[:, :k].to(torch.int32)
    fin = torch.isfinite(ds)
    idx = torch.where(fin, order, 0)
    d2 = torch.where(fin, ds, INF)
    if d.shape[1] < k:
        pad = k - d.shape[1]
        idx = torch.cat([idx, torch.zeros((d.shape[0], pad), dtype=torch.int32)], 1)
        d2 = torch.cat([d2, torch.full((d.shape[0], pad), INF)], 1)
    return idx, d2


# --------------------------------------------------------------------------
# The kernel, step by step
# --------------------------------------------------------------------------


def _insert_sorted(bd, bi, d, idx):
    """csrc/knn_cluster.cuh insert_sorted: after every entry <= d."""
    K = len(bd)
    for s in range(K - 1, 0, -1):
        if bd[s] > d:
            if bd[s - 1] > d:
                bd[s], bi[s] = bd[s - 1], bi[s - 1]
            else:
                bd[s], bi[s] = d, idx
    if bd[0] > d:
        bd[0], bi[0] = d, idx


def _lex_less(d0, i0, d1, i1):
    return d0 < d1 or (d0 == d1 and i0 < i1)


def _insert_lex(bd, bi, d, idx):
    """csrc/knn_cluster.cuh insert_lex."""
    K = len(bd)
    for s in range(K - 1, 0, -1):
        if _lex_less(d, idx, bd[s], bi[s]):
            if _lex_less(d, idx, bd[s - 1], bi[s - 1]):
                bd[s], bi[s] = bd[s - 1], bi[s - 1]
            else:
                bd[s], bi[s] = d, idx
    if _lex_less(d, idx, bd[0], bi[0]):
        bd[0], bi[0] = d, idx


def _scan(dist, ids, K, bd, bi, cap):
    """scan_span: targets in the given order, lim = min(bd[K-1], cap)."""
    lim = min(bd[K - 1], cap)
    for d, i in zip(dist, ids):
        if d < lim:
            _insert_sorted(bd, bi, d, i)
            lim = min(bd[K - 1], cap)


def _kernel_model(dq, K, S, G, tile, stride=0):
    """One query's k-NN as the cluster kernel computes it, from its distances
    ``dq`` to a prepared target (a multiple of ``tile`` long, +inf on masked
    and padded rows); ``stride`` > 0 prunes with that sample."""
    dq = [float(x) for x in dq]
    n_tiles = len(dq) // tile
    chunk = tile // G
    slices = [(r * n_tiles // S, (r + 1) * n_tiles // S) for r in range(S)]
    cap = INF
    if stride:
        kth = []
        for t0, t1 in slices:
            # every stride-th target of the slice, staged tile by tile, each
            # staged chunk cut among the G groups; one list a group
            sample = list(range(t0 * tile, t1 * tile, stride))
            for g in range(G):
                bd, bi = [INF] * K, [0] * K
                for c0 in range(0, len(sample), tile):
                    part = sample[c0:c0 + tile]
                    span = len(part) // G
                    ids = part[g * span:(g + 1) * span]
                    _scan([dq[i] for i in ids], ids, K, bd, bi, INF)
                kth.append(bd[K - 1])
        cap = float(np.nextafter(np.float32(min(kth)), np.float32(np.inf))) if kth else INF
    lists = []
    for t0, t1 in slices:
        for g in range(G):
            bd, bi = [INF] * K, [0] * K
            for t in range(t0, t1):
                ids = list(range(t * tile + g * chunk, t * tile + (g + 1) * chunk))
                _scan([dq[i] for i in ids], ids, K, bd, bi, cap)
            lists.append((bd, bi))
    md, mi = [INF] * K, [0] * K
    for bd, bi in lists:
        for d, i in zip(bd, bi):
            if not _lex_less(d, i, md[K - 1], mi[K - 1]):
                break
            _insert_lex(md, mi, d, i)
    return mi, md


def _prepped_dist(t, mask, q, tile):
    """Distances from ``q`` to the target prepared with a ``tile``-sized
    padding: +inf rows for masked and padded targets."""
    Mp = -(-t.shape[0] // tile) * tile
    xyz = torch.full((Mp, 3), INF)
    xyz[: t.shape[0]] = torch.where(mask[:, None], t, INF)
    return _sqdist(q, xyz)


MODEL_CASES = [
    # (M, dup, masked_every, slice_mask)
    (150, 1, 0, False),
    (60, 3, 0, False),    # exact ties across slices
    (150, 1, 4, False),
    (150, 1, 0, True),    # one slice with every target masked
    (5, 1, 0, False),     # fewer valid targets than k; empty slices
]


@pytest.mark.parametrize("S,G,stride", [(1, 1, 0), (2, 1, 4), (4, 2, 0), (8, 1, 4), (16, 4, 0), (3, 2, 4)])
@pytest.mark.parametrize("case", range(len(MODEL_CASES)))
def test_kernel_model_equals_stable_lexicographic(case, S, G, stride):
    M, dup, masked_every, slice_mask = MODEL_CASES[case]
    t, mask = _cloud(M, 40 + case, extent=2.0, dup=dup, masked_every=masked_every)
    tile = 16
    if slice_mask:
        mask[32:64] = False
    q = torch.cat([t[::17][:5], _cloud(3, 50 + case, extent=2.0)[0]])
    K = 6
    d = _prepped_dist(t, mask, q, tile)
    ref_i, ref_d = _lex_reference(torch.where(mask[None, :], _sqdist(q, t), INF), K)
    for row in range(q.shape[0]):
        mi, md = _kernel_model(d[row], K, S, G, tile, stride)
        assert mi == ref_i[row].tolist()
        assert torch.equal(torch.tensor(md, dtype=torch.float32), ref_d[row])


# --------------------------------------------------------------------------
# Split and merge, vectorised
# --------------------------------------------------------------------------


def _split_merge(d, k, S, tile):
    """Per-slice k smallest (d, idx) over S slices of whole tiles, then the
    k smallest of their union by (d, idx)."""
    Q, Mp = d.shape
    n_tiles = Mp // tile
    cand_d, cand_i = [], []
    for r in range(S):
        lo, hi = r * n_tiles // S * tile, (r + 1) * n_tiles // S * tile
        i, dd = _lex_reference(d[:, lo:hi], k)
        cand_d.append(dd)
        cand_i.append(torch.where(torch.isfinite(dd), i + lo, 0))
    cd, ci = torch.cat(cand_d, 1), torch.cat(cand_i, 1)
    by_idx = torch.argsort(ci.long(), dim=1, stable=True)
    cd, ci = cd.gather(1, by_idx), ci.gather(1, by_idx)
    by_d = torch.argsort(cd, dim=1, stable=True)[:, :k]
    return ci.gather(1, by_d), cd.gather(1, by_d)


SPLIT_CASES = {
    "plain": dict(n=900, dup=1, masked_every=0),
    "ties": dict(n=150, dup=6, masked_every=0),
    "masked": dict(n=900, dup=1, masked_every=3),
    "slice masked": dict(n=900, dup=1, masked_every=0, lo=128, hi=512),
    "fewer than k": dict(n=7, dup=1, masked_every=0),
    "all masked": dict(n=300, dup=1, masked_every=1),
}


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("S", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_merge_equals_reference_and_plain(name, S, k):
    c = SPLIT_CASES[name]
    t, mask = _cloud(c["n"], 7, dup=c["dup"], masked_every=c["masked_every"])
    if "lo" in c:
        mask[c["lo"]:c["hi"]] = False
    q = torch.cat([t[::11][:40], _cloud(24, 8)[0]])
    tile = 32
    i, d = _split_merge(_prepped_dist(t, mask, q, tile), k, S, tile)
    ref_i, ref_d = _lex_reference(torch.where(mask[None, :], _sqdist(q, t), INF), k)
    assert torch.equal(i.to(torch.int32), ref_i) and torch.equal(d, ref_d)
    pi, pd = cuda_knn.knn_k_plain(t, mask, q, k)
    assert cuda_knn.knn_mismatches(i, d, pi, pd, tie_tol=0.0) == 0
    assert torch.equal(d, pd)


# --------------------------------------------------------------------------
# The prepared target and the CPU wrappers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("M", [0, 1, 511, 512, 513, 3000])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8])
def test_prep_target_contract(M, mask_dtype):
    t, mask = _cloud(M, 9, masked_every=3) if M else (torch.zeros((0, 3)), torch.zeros(0, dtype=torch.bool))
    prep = cuda_knn.prep_target(t, mask.to(mask_dtype))
    Mp = prep.xyz.shape[1]
    assert prep.M == M and Mp % cuda_knn.TARGET_TILE == 0 and M <= Mp < M + cuda_knn.TARGET_TILE
    assert prep.xyz.shape == (3, Mp) and prep.xyz.dtype == torch.float32 and prep.xyz.is_contiguous()
    assert bool(torch.isinf(prep.xyz[:, M:]).all()) and bool((prep.xyz[:, M:] > 0).all())
    assert torch.equal(prep.xyz[:, :M].T[mask], t[mask])
    assert bool((prep.xyz[:, :M].T[~mask] == INF).all())
    assert torch.equal(prep.points(), prep.xyz[:, :M].T)


def test_prep_target_rejects_bad_inputs():
    t, mask = _cloud(10, 1)
    with pytest.raises(ValueError):
        cuda_knn.prep_target(t[:, :2], mask)
    with pytest.raises(ValueError):
        cuda_knn.prep_target(t, mask[:9])
    with pytest.raises(TypeError):
        cuda_knn.prep_target(t.double(), mask)
    with pytest.raises(TypeError):
        cuda_knn.prep_target(t, mask.float())
    with pytest.raises(ValueError):
        cuda_knn.nn1_prepped(cuda_knn.PreppedTarget(t.T.contiguous(), 10), t)


def _pose():
    return se3_exp(torch.tensor([0.02, -0.01, 0.05, 0.7, 0.4, -0.1], dtype=torch.float32))


@pytest.mark.parametrize("with_pose", [False, True])
@pytest.mark.parametrize("M,dup,masked_every", [(700, 1, 3), (100, 5, 0), (1, 1, 0), (300, 1, 1)])
def test_cpu_wrappers_prepared_equal_raw(M, dup, masked_every, with_pose):
    t, mask = _cloud(M, 12, dup=dup, masked_every=masked_every)
    q = torch.cat([t[::5][:50], _cloud(30, 13)[0]])
    pose = _pose() if with_pose else None
    prep = cuda_knn.prep_target(t, mask)
    ref = cuda_knn.nn1_plain(t, mask, q, pose)
    for got in (cuda_knn.nn1_prepped(prep, q, pose), cuda_knn.nn1(t, mask, q, pose)):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for k in (1, 10, 16):
        ref = cuda_knn.knn_k_plain(t, mask, q, k)
        for got in (cuda_knn.knn_k_prepped(prep, q, k), cuda_knn.knn_k(t, mask, q, k),
                    cuda_knn.knn_k_simple(t, mask, q, k)):
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_search_structure_prepares_once():
    t, mask = _cloud(400, 14, masked_every=7)
    q = _cloud(50, 15)[0]
    knn = BruteForceKNN(points=t, mask=mask).prepped()
    assert knn.prepped() is knn and knn.target.M == 400
    pose = _pose()
    for k in (1, 5):
        res = knn.search(q, k, pose)
        ri, rd = cuda_knn.knn_k_plain(t, mask, q @ pose[:3, :3].T + pose[:3, 3], k)
        if k == 1:
            ri, rd = cuda_knn.nn1_plain(t, mask, q, pose)
            ri, rd = ri[:, None], rd[:, None]
        assert torch.equal(res.indices, ri)
        assert torch.allclose(res.distances, rd, rtol=0, atol=1e-4)


@pytest.mark.parametrize(
    "Q,query_tiles,expected",
    [(1000, cuda_knn.NN1_QUERY_TILES, (32, 16)), (22528, cuda_knn.NN1_QUERY_TILES, (128, 4)),
     (3000, cuda_knn.NN1_QUERY_TILES, (64, 16)), (24576, (cuda_knn.KNN_QUERY_TILE,), (128, 4)),
     (200000, (cuda_knn.KNN_QUERY_TILE,), (128, 1)), (1, cuda_knn.NN1_QUERY_TILES, (32, 16))],
)
def test_cluster_shape(Q, query_tiles, expected):
    """On 132 SMs: the grid reaches 4 blocks an SM where it can, with the
    largest query tile and then the fewest slices."""
    qt, slices = cuda_knn.cluster_shape(Q, query_tiles, 132)
    assert (qt, slices) == expected
    assert slices in cuda_knn.CLUSTER_SLICES and qt % slices == 0
