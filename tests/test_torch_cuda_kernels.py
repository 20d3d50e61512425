"""CUDA kNN kernels against their plain PyTorch versions, on the card.

Needs a CUDA card and nvcc; skips elsewhere. Imports no jax, so it runs on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

Tolerances: the production ``nn1`` (the split-target cluster kernel) must
equal ``nn1_plain`` bit for bit, indices and distances; the production
``knn_k`` must equal ``knn_k_simple`` (the first design, one thread a query)
bit for bit, ties included, and ``knn_k_plain`` in its sets beyond ties
within 1e-6 (``knn_mismatches``; ``topk`` on the card orders ties in no
stated way), with distances within 1e-5 absolute (the remaining slack covers
the [Q,M] reduction order of the plain version). The study kernels
(nn1_tiled at every query tile x chunk, its first design nn1_tiled_simple,
nn1_bias, nn1_lanes at 8 and 32 lanes and nn1_unroll2 in nn1_tiled's ring at
every query tile x chunk and their first designs) equal ``nn1_plain`` bit
for bit, with Q off every query tile, M off every chunk, an odd M, every
target masked, exact ties across the ring's splits, equal adjacent rows
(ties inside nn1_unroll2's pairs, across nn1_lanes' lanes) and masked rows
on the queries; the ring's kernels also equal their plain models at the
card's split; ``knn_k_simple`` against ``knn_k_plain`` as before.

The batched instances (``nn1_prepped_batched``, ``knn_k_batched``: a
fleet's streams on the grid's z axis) must equal one single-stream launch
a stream and their plain versions bit for bit, at the fleet's shapes (8
streams of 1,000 queries against 16,384-row targets of different valid
counts, one stream every target masked; 8 x 5,000 and 8 x 16,384 rows
searched in themselves), on an odd target count, and with exact ties.
The coarse-to-fine schedule's strided target (every 4th row, a partial
tail tile) goes through both entries bit-equal to the plain versions.

The range-image window kernel (a shared-memory tile of azimuth columns)
and its first design (one thread a cell) must equal the plain window search
bit for bit on n_az off every tile width, 16 / 32 / 64 / 128 rings, windows
(0, 0), (6, 4), (2, 7), (8, 4) and an empty image, and refuse k above the
window's candidates before any launch; above 16 the warp kernel (a warp a
cell) equals the plain search and the one-thread tile kept for timing
(``range_image_window_spill``) at k = 17, 20, 32, 64, 100 and 117 on every
case (all empty, collisions, the gather form through ``range_image_knn``); ``range_image_knn`` on the card (a memset and four kernels: 5
device launches under the profiler, 4 with both bounds given) must equal
the plain sequence (``range_image`` + ``range_image_window_plain`` +
``point_rows``) in every
cell, winner, occupancy, index, distance and ``collisions``, with the
elevation bounds given and not. The grid search (one lane group a query, G
in 8 / 16 / 32, and its first design, one thread a query) must equal
``grid_search_plain`` bit for bit on a lattice of exact ties across cells and
within one, cells over the budget, fewer candidates than k, queries off the
21-bit range and NaN, an all-masked target, and Q = 1 to 30,000.

Above k = 16 (``cuda_knn.FAST_MAX_K``) every production search runs its
instance at K = 32, 64 or 128 and writes the first k entries: at k = 17, 20,
32, 64, 100 and 128 ``knn_k`` (single and batched) equals
``knn_k_sorted_plain`` (the plain distances sorted stably, ties by index: the
first design stops at 16) bit for bit and its first 16 columns the k = 16
search; ``grid_knn`` at every lane count, the range-image window (and
``range_image_knn`` on the card), ``morton_window`` and the lane-group
``coarse_refine`` equal their plain versions bit for bit, and each search
refuses k above its candidates. ``coarse_rank`` (a warp a query over the
occupied cells) equals ``rank_cells_plain`` bit for bit: a LiDAR-like scene,
a lattice whose bounds tie at 0, every cell selected (P = C), every target
masked, lost cells, the whole capacity ranked (``occupied`` at C), and 33 and
100 cells kept a query; the lane-group refine at 8, 16 and 32 lanes and k =
1, 10, 20 and 128 equals the plain refine, certificates included.

Ragged fleets: each stream's prepared target carries its extent (1 + its
last valid row), and the cluster kernels sweep only the rows below it. In
one launch, extents 0, 1, 31, 33, 430, 511, 513 and Mp (valid prefixes, a
scattered mask, the duplicated-halves ties): ``nn1_batched`` with and
without poses and ``knn_k_batched`` at k = 1, 10, 16, 20, 32 and 128 equal
their plain versions (``knn_k_sorted_plain``, and ``knn_k_simple`` up to 16),
B single launches and a hand-built target without an extent (the full
sweep) bit for bit, at every query tile and slice count.

The cluster kernels split each target's extent into 1 to 16 slices of
whole 32-row units, the count chosen from Q; the cases below put M off the
512-row tile, run every slice count, Q below one query tile, a slice with
every target masked, every target masked, fewer valid targets than k,
duplicated points whose exact ties span the slices, and the odometry
frame's shapes (1,000 queries against a 16,384-row target with a masked
tail; the self-search of a 5,000-row scan and of a 16,384-row submap).
"""

import dataclasses

import numpy as np
import pytest
import torch

import sycl_points_tpu_torch  # noqa: F401  (float32 settings)
from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.scripts import bench_nn1_tiles, bench_nn1_variants
from sycl_points_tpu_torch.scripts.window_scenes import SHADOW, SHADOW_CELL, shadow_scene, shadowed
from sycl_points_tpu_torch.utils.lie import se3_exp

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]

TIE = 1e-6
D_ATOL = 1e-5

# Every study kernel instance of the two study entry points: label ->
# (launch-count key, the target's preparation on (t, m), call on (prepared
# target, q)); the production nn1 is tested above.
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


def _dup_cloud(n, copies, seed):
    """``copies`` copies of one cloud of ``n`` points, one after the other:
    every point has exact ties in every slice."""
    pts, _ = _cloud(n, seed)
    return pts.repeat(copies, 1).contiguous(), torch.ones(n * copies, dtype=torch.bool, device="cuda")


def _slice_masked(m):
    """A mask with targets [1024, 2048) masked (and every 5th elsewhere):
    whole slices of the cluster kernels at 8 and 16 slices."""
    mask = torch.arange(m, device="cuda") % 5 != 0
    mask[2 * cuda_knn.TARGET_TILE:4 * cuda_knn.TARGET_TILE] = False
    return mask


# (targets, queries, mask) makers for nn1 and knn_k: name -> callable
def _case(name):
    if name.startswith("dup"):
        tgt, mask = _dup_cloud(1000, 9, 21)
        return tgt, tgt[::7].contiguous(), mask
    if name == "slice masked":
        tgt, _ = _cloud(8192, 22)
        return tgt, _cloud(700, 23)[0], _slice_masked(8192)
    if name == "all masked":
        tgt, mask = _cloud(3000, 24)
        return tgt, _cloud(100, 25)[0], torch.zeros_like(mask)
    if name.startswith("tail"):
        # the odometry frame's shapes: a target of static capacity whose
        # valid rows sit at the front, the tail masked; q == m searches the
        # cloud in itself (the preprocessed scan, the extracted submap)
        m, valid, q = (int(x) for x in name.split(",")[1:])
        tgt, _ = _cloud(m, 28)
        qry = tgt if q == m else _cloud(q, 29)[0]
        return tgt, qry, torch.arange(m, device="cuda") < valid
    m, q, masked_every = (int(x) for x in name.split(","))
    tgt, mask = _cloud(m, 26, masked_every=masked_every)
    return tgt, _cloud(q, 27)[0], mask


# M off the tile and the slices; Q below one query tile (32 for nn1), at
# each of nn1's query tiles (32, 64, 128 queries a cluster) and at 16, 4, 2
# and 1 slices a cluster (cuda_knn.cluster_shape)
NN1_CASES = ["300,70,0", "5000,1000,7", "25000,1000,5", "2049,129,3", "1,5,0", "513,31,0",
             "24575,3000,11", "24576,6000,0", "22528,22528,37", "2049,50000,3", "1000,70000,0",
             "tail,16384,5000,1000", "tail,16384,13000,1000", "tail,16384,0,1000",
             "dup", "slice masked", "all masked"]


@pytest.mark.parametrize("with_pose", [False, True])
@pytest.mark.parametrize("case", NN1_CASES)
def test_nn1_matches_plain(case, with_pose):
    tgt, qry, mask = _case(case)
    pose = _pose() if with_pose else None
    before = cuda_knn.launch_counts["nn1"]
    i, d = cuda_knn.nn1(tgt, mask.to(torch.uint8), qry, pose)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["nn1"] == before + 1
    ri, rd = cuda_knn.nn1_plain(tgt, mask, qry, pose)
    assert torch.equal(i, ri) and torch.equal(d, rd)
    assert bool(mask[i.long()][torch.isfinite(d)].all())


def test_nn1_all_masked():
    tgt, mask = _cloud(3000, 3)
    qry, _ = _cloud(100, 4)
    i, d = cuda_knn.nn1(tgt, torch.zeros_like(mask), qry, _pose())
    torch.cuda.synchronize()
    assert bool(torch.isinf(d).all()) and bool((i == 0).all())


def test_nn1_prepped_equals_nn1():
    tgt, mask = _cloud(5000, 31, masked_every=4)
    qry, _ = _cloud(1000, 32)
    pose = _pose()
    prep = cuda_knn.prep_target(tgt, mask)
    assert prep.xyz.shape == (3, 5120) and prep.M == 5000
    a = cuda_knn.nn1_prepped(prep, qry, pose)
    b = cuda_knn.nn1(tgt, mask, qry, pose)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("m", [16384, 10001, 4099])
def test_nn1_on_the_coarse_target_matches_plain(m):
    """The coarse-to-fine schedule's target: every 4th row of the target,
    made contiguous (ceil(m / 4) rows: 4,096, whole tiles, at the odometry
    frame's 16,384; 2,501 and 1,025, a partial tail tile, otherwise)."""
    tgt, mask = _cloud(m, 35, masked_every=3)
    coarse, cmask = tgt[::4].contiguous(), mask[::4].contiguous()
    assert coarse.shape[0] == -(-m // 4)
    qry, _ = _cloud(30000, 36)
    pose = _pose()
    i, d = cuda_knn.nn1_prepped(cuda_knn.prep_target(coarse, cmask), qry, pose)
    ri, rd = cuda_knn.nn1_plain(coarse, cmask, qry, pose)
    torch.cuda.synchronize()
    assert torch.equal(i, ri) and torch.equal(d, rd)
    # an index times the stride is the full target's row of that point
    assert torch.equal(tgt[i.long() * 4], coarse[i.long()])
    B = 4
    pts, bmask = _fleet_targets(B, m, 37)
    bc, bcm = pts[:, ::4].contiguous(), bmask[:, ::4].contiguous()
    qb = torch.stack([_cloud(1000, 70 + b)[0] for b in range(B)])
    poses = _pose().expand(B, 4, 4).contiguous()
    bi, bd = cuda_knn.nn1_prepped_batched(cuda_knn.prep_targets(bc, bcm), qb, poses)
    ri, rd = cuda_knn.nn1_batched_plain(bc, bcm, qb, poses)
    torch.cuda.synchronize()
    assert torch.equal(bi, ri) and torch.equal(bd, rd)


def test_nn1_empty():
    tgt, mask = _cloud(100, 33)
    i, d = cuda_knn.nn1(tgt, mask, tgt[:0].contiguous())
    assert i.shape == (0,) and d.shape == (0,)
    i, d = cuda_knn.nn1(tgt[:0].contiguous(), mask[:0], tgt)
    torch.cuda.synchronize()
    assert bool(torch.isinf(d).all()) and bool((i == 0).all())


@pytest.mark.parametrize("m,q,masked_every", [(1, 33, 0), (300, 70, 0), (2049, 129, 3), (25000, 1000, 37)])
@pytest.mark.parametrize("label", sorted(STUDY))
def test_study_kernels_equal_plain(label, m, q, masked_every):
    key, prepare, fn = STUDY[label]
    tgt, mask = _cloud(m, 11, masked_every=masked_every)
    qry = _cloud(q, 12)[0]
    target = prepare(tgt, mask.to(torch.uint8))
    before = cuda_knn.launch_counts[key]
    i, d = fn(target, qry)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts[key] == before + 1
    ri, rd = cuda_knn.nn1_plain(tgt, mask, qry)
    assert torch.equal(i, ri) and torch.equal(d, rd)


@pytest.mark.parametrize("label", sorted(STUDY))
def test_study_kernels_all_masked(label):
    tgt, mask = _cloud(3000, 13)
    _, prepare, fn = STUDY[label]
    i, d = fn(prepare(tgt, torch.zeros_like(mask)), _cloud(100, 14)[0])
    torch.cuda.synchronize()
    assert bool(torch.isinf(d).all()) and bool((i == 0).all())


@pytest.mark.parametrize("query_tile", cuda_knn.NN1_QUERY_TILES_STUDY)
@pytest.mark.parametrize("case", ["dup", "M off the chunks", "pair", "empty target", "no queries"])
def test_nn1_tiled_ties_chunks_and_splits(case, query_tile):
    """nn1_tiled at every chunk: exact ties whose twins lie in other splits
    (the lower index wins), a target streamed in several chunks a split with
    its last chunk partial (12,345 rows, 30,000 queries: 10 splits of 1,235
    rows at 64 queries a block, 3 chunks of 512 a split), the pair's 1,000 queries against 24,576
    rows, an empty target and no queries; bit-equal to nn1_plain and to its
    plain model at the card's split."""
    if case == "dup":
        tgt, mask = _dup_cloud(1000, 9, 40)
        qry = torch.cat([tgt[::7], _cloud(300, 41)[0]]).contiguous()
    elif case == "M off the chunks":
        (tgt, mask), qry = _cloud(12345, 42, masked_every=5), _cloud(30000, 43)[0]
    elif case == "pair":
        (tgt, mask), qry = _cloud(24576, 44, masked_every=37), _cloud(1000, 45)[0]
    elif case == "empty target":
        tgt, mask, qry = torch.zeros(0, 3, device="cuda"), torch.zeros(0, dtype=torch.bool, device="cuda"), \
            _cloud(70, 46)[0]
    else:
        (tgt, mask), qry = _cloud(500, 47), torch.zeros(0, 3, device="cuda")
    packed = cuda_knn.pack_target(tgt, mask)
    ref = cuda_knn.nn1_plain(tgt, mask, qry)
    span = cuda_knn.nn1_tiled_span(qry.shape[0], tgt.shape[0], query_tile, cuda_knn._sm_count(0))
    model = cuda_knn.nn1_tiled_plain(packed, qry, span)
    assert torch.equal(model[0], ref[0]) and torch.equal(model[1], ref[1])
    for chunk in cuda_knn.NN1_TILES:
        got = cuda_knn.nn1_tiled_prepped(packed, qry, query_tile, chunk)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), chunk
    if case == "dup":
        assert bool((ref[0][: -300] < 1000).all()) and bool((ref[1][: -300] == 0).all())
    if case == "M off the chunks" and query_tile == 64:
        assert span == 1235 and -(-span // 512) == 3


def _lane_form(lanes):
    return (
        "nn1_lanes",
        lambda packed, q, qt, tc: cuda_knn.nn1_lanes_prepped(packed, q, lanes, qt, tc),
        lambda packed, q, span: cuda_knn.nn1_lanes_plain(packed, q, span, lanes),
        lambda t, m, q: cuda_knn.nn1_lanes(t, m, q, lanes),
        lambda Q, M, qt, n_sm: cuda_knn.nn1_tiled_span(Q, M, qt, n_sm, lanes),
    )


# The variant study's v1 / v2 / v3 in nn1_tiled's ring: (launch-count key, the
# prepped wrapper, its plain model, the wrapper on the raw target, its split)
RING_FORMS = {
    "nn1_bias": ("nn1_bias", cuda_knn.nn1_bias_prepped, cuda_knn.nn1_bias_plain, cuda_knn.nn1_bias,
                 cuda_knn.nn1_even_span),
    "nn1_lanes 8": _lane_form(8),
    "nn1_lanes 32": _lane_form(32),
    "nn1_unroll2": ("nn1_unroll2", cuda_knn.nn1_unroll2_prepped, cuda_knn.nn1_unroll2_plain, cuda_knn.nn1_unroll2,
                    cuda_knn.nn1_even_span),
}
RING_CASES = ["dup", "equal adjacent rows", "masked rows on the queries", "odd M", "M off the chunks", "pair",
              "empty target", "no queries"]


@pytest.mark.parametrize("form", sorted(RING_FORMS))
@pytest.mark.parametrize("query_tile", cuda_knn.NN1_QUERY_TILES_STUDY)
@pytest.mark.parametrize("case", RING_CASES)
def test_nn1_bias_forms_ties_chunks_and_splits(case, query_tile, form):
    """nn1_bias, nn1_lanes (8 and 32 lanes; the query tile counts (query,
    lane) slots) and nn1_unroll2 at every chunk, on a target made by
    pack_bias_target: exact ties whose twins lie in other splits, equal
    adjacent rows (a tie inside each of nn1_unroll2's pairs and across two
    of nn1_lanes' lanes: the even row wins), the queries as masked rows ahead of the target (at d = 0 they must
    lose to far valid rows), an odd M (a masked pad row), a target streamed
    in several chunks a split with its last chunk partial (12,345 rows,
    30,000 queries), the pair's 1,000 queries against 24,576 rows, an empty
    target and no queries; bit-equal to nn1_plain, to the plain model at the
    card's split and through the wrapper on the raw target; one launch a
    call."""
    key, prepped, plain, wrapper, span_of = RING_FORMS[form]
    if case == "dup":
        tgt, mask = _dup_cloud(1000, 9, 40)
        qry = torch.cat([tgt[::7], _cloud(300, 41)[0]]).contiguous()
    elif case == "equal adjacent rows":
        pts, m0 = _cloud(3000, 48, masked_every=7)
        tgt, mask = pts.repeat_interleave(2, 0).contiguous(), m0.repeat_interleave(2)
        qry = torch.cat([pts[::5], _cloud(500, 49)[0]]).contiguous()
    elif case == "masked rows on the queries":
        (pts, m0), qry = _cloud(4000, 50, masked_every=37), _cloud(2000, 51)[0]
        tgt = torch.cat([qry, pts]).contiguous()
        mask = torch.cat([torch.zeros(2000, dtype=torch.bool, device="cuda"), m0])
    elif case == "odd M":
        (tgt, mask), qry = _cloud(4099, 52, masked_every=3), _cloud(1500, 53)[0]
    elif case == "M off the chunks":
        (tgt, mask), qry = _cloud(12345, 42, masked_every=5), _cloud(30000, 43)[0]
    elif case == "pair":
        (tgt, mask), qry = _cloud(24576, 44, masked_every=37), _cloud(1000, 45)[0]
    elif case == "empty target":
        tgt, mask, qry = torch.zeros(0, 3, device="cuda"), torch.zeros(0, dtype=torch.bool, device="cuda"), \
            _cloud(70, 46)[0]
    else:
        (tgt, mask), qry = _cloud(500, 47), torch.zeros(0, 3, device="cuda")
    packed = cuda_knn.pack_bias_target(tgt, mask)
    Q = qry.shape[0]
    ref = cuda_knn.nn1_plain(tgt, mask, qry)
    span = span_of(Q, packed.shape[0], query_tile, cuda_knn._sm_count(0))
    model = plain(packed, qry, span)
    assert torch.equal(model[0], ref[0]) and torch.equal(model[1], ref[1])
    for chunk in cuda_knn.NN1_TILES:
        before = cuda_knn.launch_counts[key]
        got = prepped(packed, qry, query_tile, chunk)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), chunk
        assert cuda_knn.launch_counts[key] == before + (1 if Q else 0)
    got = wrapper(tgt, mask, qry)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    if case == "dup":
        assert bool((ref[0][: -300] < 1000).all()) and bool((ref[1][: -300] == 0).all())
    elif case == "equal adjacent rows":
        assert bool((ref[0] % 2 == 0).all())
    elif case == "masked rows on the queries":
        assert bool((ref[0] >= 2000).all())
    elif case == "empty target":
        assert bool((ref[0] == 0).all()) and bool(torch.isinf(ref[1]).all())


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
    si, sd = cuda_knn.knn_k_simple(tgt, mask, tgt, k)
    torch.cuda.synchronize()
    assert torch.equal(i, si) and torch.equal(d, sd)


KNN_CASES = ["300,70,0", "2049,129,3", "1,5,0", "24575,2000,37", "25000,25000,6", "2049,50000,3",
             "1000,70000,0", "tail,5000,4300,5000", "tail,16384,5000,16384", "tail,16384,13000,16384",
             "dup", "slice masked", "all masked"]


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("case", KNN_CASES)
def test_knn_k_equals_simple(case, k):
    """Bit for bit against the first design, ties included; the sets against
    the plain version."""
    tgt, qry, mask = _case(case)
    i, d = cuda_knn.knn_k(tgt, mask, qry, k)
    before = cuda_knn.launch_counts["knn_k_simple"]
    si, sd = cuda_knn.knn_k_simple(tgt, mask, qry, k)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["knn_k_simple"] == before + 1
    assert torch.equal(i, si) and torch.equal(d, sd)
    ri, rd = cuda_knn.knn_k_plain(tgt, mask, qry, k)
    assert cuda_knn.knn_mismatches(i, d, ri, rd, TIE) == 0


def test_knn_k_fewer_valid_than_k():
    tgt, mask = _cloud(40, 7)
    mask[6:] = False
    i, d = cuda_knn.knn_k(tgt, mask, tgt, 10)
    torch.cuda.synchronize()
    assert bool(torch.isinf(d[:, 6:]).all()) and bool((i[:, 6:] == 0).all())
    assert bool(torch.isfinite(d[:, :6]).all())
    si, sd = cuda_knn.knn_k_simple(tgt, mask, tgt, 10)
    assert torch.equal(i, si) and torch.equal(d, sd)


def test_knn_k_prepped_equals_knn_k():
    tgt, mask = _cloud(3000, 34, masked_every=3)
    prep = cuda_knn.prep_target(tgt, mask)
    a = cuda_knn.knn_k_prepped(prep, tgt, 10)
    b = cuda_knn.knn_k(tgt, mask, tgt, 10)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_wrapper_rejects_bad_inputs():
    tgt, mask = _cloud(100, 8)
    with pytest.raises(ValueError):
        cuda_knn.nn1(tgt[:, :2], mask, tgt)
    with pytest.raises(ValueError):
        cuda_knn.nn1(tgt, mask, tgt.t().contiguous().t())
    with pytest.raises(TypeError):
        cuda_knn.knn_k(tgt.double(), mask, tgt.double(), 4)
    with pytest.raises(ValueError):
        cuda_knn.knn_k(tgt, mask, tgt, cuda_knn.MAX_K + 1)
    with pytest.raises(ValueError):
        cuda_knn.knn_k_simple(tgt, mask, tgt, cuda_knn.FAST_MAX_K + 1)
    with pytest.raises(ValueError):
        cuda_knn.nn1(tgt, mask.cpu(), tgt)
    with pytest.raises(ValueError):
        cuda_knn.nn1_prepped(cuda_knn.PreppedTarget(tgt.T.contiguous(), 100), tgt)


# ---- the fleet's batched instances ------------------------------------------

K = 10  # the fleet's self-k-NN (covariance_estimation.neighbor_num)


def _fleet_targets(B, m, seed):
    """``B`` streams' targets [B, m, 3] with their valid rows in front, of
    different counts; stream 1 has every target masked."""
    pts = torch.stack([_cloud(m, seed + b)[0] for b in range(B)])
    valid = torch.tensor([m - 997 * b for b in range(B)], device="cuda")
    valid[1] = 0
    return pts, torch.arange(m, device="cuda")[None, :] < valid[:, None]


def _ties(pts, mask):
    """Each stream's first half twice over: every point has an exact tie,
    in another slice of the cluster."""
    h = pts.shape[1] // 2
    return (torch.cat([pts[:, :h], pts[:, :h]], 1).contiguous(),
            torch.cat([mask[:, :h], mask[:, :h]], 1).contiguous())


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("m", [16384, 4099])
def test_nn1_batched_equals_single_launches_and_plain(m, ties):
    B = 8
    pts, mask = _fleet_targets(B, m, 40)
    if ties:
        pts, mask = _ties(pts, mask)
    qry = torch.stack([_cloud(1000, 60 + b)[0] for b in range(B)])
    poses = torch.stack([se3_exp(torch.tensor([0.01 * b, 0.0, 0.02, 0.3, -0.1 * b, 0.0])) for b in range(B)]).cuda()
    prep = cuda_knn.prep_targets(pts, mask)
    before = cuda_knn.launch_counts["nn1_batched"]
    i, d = cuda_knn.nn1_prepped_batched(prep, qry, poses)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["nn1_batched"] == before + 1
    ri, rd = cuda_knn.nn1_batched_plain(pts, mask, qry, poses)
    assert torch.equal(i, ri) and torch.equal(d, rd)
    for b in range(B):
        si, sd = cuda_knn.nn1_prepped(cuda_knn.prep_target(pts[b], mask[b]), qry[b], poses[b])
        assert torch.equal(i[b], si) and torch.equal(d[b], sd)
    assert bool(torch.isinf(d[1]).all()) and bool((i[1] == 0).all())


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("m,q_self", [(5000, True), (16384, True), (4099, False)])
def test_knn_k_batched_equals_single_launches_and_plain(m, q_self, ties):
    B = 8
    pts, mask = _fleet_targets(B, m, 80)
    if ties:
        pts, mask = _ties(pts, mask)
    qry = pts if q_self else torch.stack([_cloud(700, 90 + b)[0] for b in range(B)])
    prep = cuda_knn.prep_targets(pts, mask)
    before = cuda_knn.launch_counts["knn_k_batched"]
    i, d = cuda_knn.knn_k_batched(prep, qry.contiguous(), K)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["knn_k_batched"] == before + 1
    for b in range(B):
        si, sd = cuda_knn.knn_k_prepped(cuda_knn.prep_target(pts[b], mask[b]), qry[b].contiguous(), K)
        assert torch.equal(i[b], si) and torch.equal(d[b], sd)
        ref = cuda_knn.knn_k_simple(pts[b], mask[b], qry[b].contiguous(), K)
        assert torch.equal(i[b], ref[0]) and torch.equal(d[b], ref[1])
    ri, rd = cuda_knn.knn_k_batched_plain(pts, mask, qry, K)
    assert cuda_knn.knn_mismatches(i.reshape(-1, K), d.reshape(-1, K), ri.reshape(-1, K), rd.reshape(-1, K),
                                   TIE) == 0


# ---- the range-image window search (csrc/range_image.cu) ----------------------


def _raw_scan(n_az, n_rings, seed=0):
    """A synthetic sensor-frame scan of ``n_az x n_rings`` rays, on the card."""
    from sycl_points_tpu_torch.utils.synthetic import World, scan_at

    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.0, 0.0, 1.8]
    pts = torch.from_numpy(scan_at(World(), T, n_az=n_az, n_rings=n_rings, seed=seed)).cuda()
    return pts, torch.ones(pts.shape[0], dtype=torch.bool, device="cuda")


def _range_image_case(name):
    """(points, mask, range_image_knn keywords) of a range-image case."""
    if name == "full width":
        return (*_raw_scan(2048, 64), {})
    if name == "collisions":
        # every 3rd return twice, and a block of returns five times over
        pts, mask = _raw_scan(1024, 32, seed=4)
        pts = torch.cat([pts, pts[::3], pts[100:400].repeat(4, 1)]).contiguous()
        return pts, torch.ones(pts.shape[0], dtype=torch.bool, device="cuda"), {"n_az": 1024, "n_rings": 32}
    if name == "all masked":
        pts, mask = _raw_scan(1024, 32, seed=5)
        return pts, torch.zeros_like(mask), {"n_az": 1024, "n_rings": 32}
    if name == "partial fan":
        # a 90-degree sector and every other ring, with the sensor's fan given
        pts, mask = _raw_scan(2048, 64, seed=6)
        az = torch.atan2(pts[:, 1], pts[:, 0])
        el = torch.asin(pts[:, 2] / torch.linalg.vector_norm(pts, dim=1))
        keep = (az.abs() < np.pi / 4) & (torch.remainder(torch.round(el * 100), 2) == 0)
        return pts, mask & keep, {"el_min": -0.4363, "el_max": 0.0349}
    if name == "masked, window (8, 4)":
        pts, mask = _raw_scan(1024, 32, seed=7)
        mask[::7] = False
        return pts, mask, {"n_az": 1024, "n_rings": 32, "window_az": 8}
    if name == "n_az 1000":
        # no tile width divides 1000 columns: the last tile is partial, and
        # both of its edges wrap
        pts, mask = _raw_scan(1000, 64, seed=10)
        return pts, mask, {"n_az": 1000}
    if name.endswith(" rings"):
        n_rings = int(name.split()[0])
        pts, mask = _raw_scan(1024, n_rings, seed=n_rings)
        return pts, mask, {"n_az": 1024, "n_rings": n_rings}
    raise ValueError(name)


RANGE_IMAGE_CASES = ["full width", "collisions", "all masked", "partial fan", "masked, window (8, 4)", "n_az 1000",
                     "16 rings", "128 rings"]


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("case", RANGE_IMAGE_CASES)
def test_range_image_window_matches_plain(case, k):
    """The window kernel equals its plain version bit for bit on the image
    (indices and distances, unfilled slots included), and so does the
    per-point result after the self-substitution."""
    from sycl_points_tpu_torch.ops import range_image_knn as ri

    pts, mask, kw = _range_image_case(case)
    n_az, n_rings = kw.get("n_az", 2048), kw.get("n_rings", 64)
    w_az, w_el = kw.get("window_az", 6), kw.get("window_el", 4)
    img_p, img_i, cell, ok, collisions = ri.range_image(pts, mask, n_az, n_rings, kw.get("el_min"),
                                                        kw.get("el_max"))
    before = dict(cuda_knn.launch_counts)
    got = ri.range_image_window(img_p, img_i, n_az, n_rings, w_az, w_el, k)
    simple = ri.range_image_window_simple(img_p, img_i, n_az, n_rings, w_az, w_el, k)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["range_image"] == before["range_image"] + 1
    assert cuda_knn.launch_counts["range_image_simple"] == before["range_image_simple"] + 1
    ref = ri.range_image_window_plain(img_p, img_i, n_az, n_rings, w_az, w_el, k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(simple[0], ref[0]) and torch.equal(simple[1], ref[1])
    res, plain = ri.point_rows(*got, cell, ok), ri.point_rows(*ref, cell, ok)
    assert torch.equal(res.indices, plain.indices) and torch.equal(res.distances, plain.distances)
    if case == "collisions":
        assert int(collisions) > 0
    if case == "all masked":
        assert bool(torch.isinf(res.distances).all())
        assert torch.equal(res.indices[:, 0].long(), torch.arange(pts.shape[0], device="cuda"))


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("window", [(0, 0), (6, 4), (2, 7)])
@pytest.mark.parametrize("case", ["full width", "n_az 1000", "16 rings", "128 rings", "all masked"])
def test_range_image_window_kernels_over_windows(case, window, k):
    """The tiled window kernel and the first design equal the plain window
    search bit for bit at each window; k above the window's candidates (at
    (0, 0) one candidate, the cell itself) is refused before any launch, as
    JAX's top_k refuses it."""
    from sycl_points_tpu_torch.ops import range_image_knn as ri

    pts, mask, kw = _range_image_case(case)
    n_az, n_rings = kw.get("n_az", 2048), kw.get("n_rings", 64)
    img_p, img_i, _, _, _ = ri.range_image(pts, mask, n_az, n_rings)
    if k > ri.window_candidates(*window):
        before = dict(cuda_knn.launch_counts)
        for fn in (ri.range_image_window_plain, ri.range_image_window, ri.range_image_window_simple):
            with pytest.raises(ValueError, match="candidates"):
                fn(img_p, img_i, n_az, n_rings, *window, k)
        assert cuda_knn.launch_counts == before
        return
    ref = ri.range_image_window_plain(img_p, img_i, n_az, n_rings, *window, k)
    for fn in (ri.range_image_window, ri.range_image_window_simple):
        got = fn(img_p, img_i, n_az, n_rings, *window, k)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), fn.__name__


def _device_launches(fn) -> int:
    """Kernels and memsets the card ran for ``fn()``, under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.parametrize("bounds", ["from the scan", "given", "el_min given"])
@pytest.mark.parametrize("case", ["full width", "collisions", "all masked", "partial fan", "n_az 1000", "16 rings"])
def test_range_image_knn_on_the_card_matches_the_plain_sequence(case, bounds):
    """range_image_knn on a CUDA tensor (a memset, then the elevation, cells,
    window and rows kernels) equals the plain sequence bit for bit: every
    cell, winner and occupancy, the per-point indices and distances, and
    collisions; 5 device launches (4 with both bounds given), within the 6
    the design allows."""
    from sycl_points_tpu_torch.ops import range_image_knn as ri

    pts, mask, kw = _range_image_case(case)
    n_az, n_rings = kw.get("n_az", 2048), kw.get("n_rings", 64)
    given = {"el_min": kw.get("el_min", -0.4363), "el_max": kw.get("el_max", 0.0349)}
    el = {"from the scan": {}, "given": given, "el_min given": {"el_min": given["el_min"]}}[bounds]
    k = 10
    cells = ri.range_image_cells(pts, mask, n_az, n_rings, **el)
    ref_cells = ri.range_image_cells_plain(pts, mask, n_az, n_rings, **el)
    torch.cuda.synchronize()
    for name, a, b in zip(("cell", "winner", "occupancy", "collisions"), cells, ref_cells):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    before = dict(cuda_knn.launch_counts)
    got = ri.range_image_knn(pts, mask, k, n_az, n_rings, **el)
    torch.cuda.synchronize()
    counted = {name: cuda_knn.launch_counts[name] - before[name] for name in before}
    assert counted["range_image_elevation"] == (0 if bounds == "given" else 1)
    assert counted["range_image_cells"] == counted["range_image"] == counted["range_image_rows"] == 1
    img_p, img_i, cell, ok, collisions = ri.range_image(pts, mask, n_az, n_rings, **el)
    ref = ri.point_rows(*ri.range_image_window_plain(img_p, img_i, n_az, n_rings, 6, 4, k), cell, ok)
    assert torch.equal(got.knn.indices, ref.indices) and torch.equal(got.knn.distances, ref.distances)
    assert got.collisions.dtype == torch.int32 and int(got.collisions) == int(collisions)
    if case == "collisions":
        assert int(collisions) > 0
    launches = _device_launches(lambda: ri.range_image_knn(pts, mask, k, n_az, n_rings, **el))
    assert launches <= (4 if bounds == "given" else 5), launches


def test_range_image_knn_on_the_card_with_no_points():
    from sycl_points_tpu_torch.ops import range_image_knn as ri

    pts = torch.zeros(0, 3, device="cuda")
    got = ri.range_image_knn(pts, torch.zeros(0, dtype=torch.bool, device="cuda"), 10)
    assert got.knn.indices.shape == (0, 10) and got.knn.distances.shape == (0, 10) and int(got.collisions) == 0


def test_range_image_window_rejects_bad_inputs():
    from sycl_points_tpu_torch.ops import range_image_knn as ri

    img_p = torch.zeros(64 * 8, 3, device="cuda")
    img_i = torch.full((64 * 8,), -1, dtype=torch.int32, device="cuda")
    for fn in (ri.range_image_window, ri.range_image_window_simple):
        with pytest.raises(ValueError):  # the first design keeps k <= 16
            fn(img_p, img_i, 64, 8, 6, 4, cuda_knn.MAX_K + 1 if fn is ri.range_image_window else 17)
        with pytest.raises(ValueError):
            fn(img_p[:-1], img_i, 64, 8, 6, 4, 10)
        with pytest.raises(TypeError):
            fn(img_p, img_i.long(), 64, 8, 6, 4, 10)
        with pytest.raises(ValueError):
            fn(img_p, img_i.cpu(), 64, 8, 6, 4, 10)
    # one column of 128 rings and a halo of 2 x 60 columns do not fit a block
    before = dict(cuda_knn.launch_counts)
    pts, mask = _raw_scan(256, 128)
    with pytest.raises(ValueError):
        ri.range_image_knn(pts, mask, 10, n_az=256, n_rings=128, window_az=60)
    assert cuda_knn.launch_counts == before


# -- the structured searches: grid_knn (A), coarse_refine (B), morton_window (C) --


def _cloud_on_card(pts, mask=None):
    from sycl_points_tpu_torch.points.point_cloud import PointCloud

    c = PointCloud.from_numpy(np.asarray(pts, np.float32), device="cuda")
    if mask is not None:
        full = torch.zeros(c.capacity, dtype=torch.bool, device="cuda")
        full[: len(mask)] = torch.from_numpy(np.asarray(mask)).cuda()
        c = c.replace(mask=full)
    return c


def _grid_case(name):
    """(grid, queries, pose) of a grid-search case: a scan's voxels against
    a submap-like target, queries with no neighbour in their 27 cells,
    outside the 21-bit range and NaN, an overflowing budget, every target
    masked."""
    from sycl_points_tpu_torch.ops.grid_knn import GridKNN

    pts, _ = _raw_scan(1024, 32, seed=8)
    rng = np.random.default_rng(11)
    tgt = pts[::2]
    q = torch.cat([pts[1::2][:3000] + torch.from_numpy(rng.normal(scale=0.05, size=(3000, 3)).astype(np.float32))
                   .cuda(), torch.tensor([[500.0, 500.0, 500.0], [4e6, 0.0, 0.0], [float("nan"), 0.0, 0.0]],
                                         device="cuda")]).contiguous()
    pose = se3_exp(torch.tensor([0.01, -0.02, 0.03, 0.2, -0.1, 0.05])).cuda().contiguous()
    mask = rng.uniform(size=tgt.shape[0]) > 0.1
    if name.startswith("lattice"):
        pts, mask, q = _lattice()
        budget = 4 if name.endswith("budget 4") else 32
        return GridKNN.build(_cloud_on_card(pts, mask), cell_size=1.0, max_per_cell=budget), q, None
    if name == "submap, pose":
        return GridKNN.build_auto(_cloud_on_card(tgt.cpu().numpy(), mask), cell_size=1.0), q, pose
    if name == "small budget":
        return GridKNN.build(_cloud_on_card(tgt.cpu().numpy()), cell_size=2.0, max_per_cell=4), q, None
    if name == "all masked":
        return GridKNN.build(_cloud_on_card(tgt.cpu().numpy(), np.zeros(tgt.shape[0], bool)), cell_size=1.0), q, pose
    raise ValueError(name)


def _lattice():
    """A lattice of 0.5 m spacing in 1 m cells (8 points a cell), every third
    point repeated under another index and every 11th masked, and queries on
    the lattice's exact midpoints and nodes (exact distances: ties across
    cells and among the lanes of one cell), beyond its corner (fewer
    candidates than k), off the 21-bit range and NaN."""
    g = np.arange(-2.0, 2.0, 0.5, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([pts, pts[::3]])
    mask = np.arange(len(pts)) % 11 != 0
    h = np.arange(-2.5, 2.5, 0.25, dtype=np.float32)
    q = np.stack(np.meshgrid(h, h, h, indexing="ij"), -1).reshape(-1, 3)
    q = np.concatenate([q, [[2.9, 2.9, 2.9], [-2.9, 2.6, 2.9], [500.0, 500.0, 500.0], [4e6, 0.0, 0.0],
                            [np.nan, 0.0, 0.0]]]).astype(np.float32)
    return pts, mask, torch.from_numpy(q).cuda().contiguous()


GRID_CASES = ["submap, pose", "small budget", "all masked", "lattice", "lattice, budget 4"]


@pytest.mark.parametrize("k", [1, 4, 5, 16])
@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_knn_kernel_matches_plain(case, k):
    """Kernel A (at its chosen lanes and at 8, 16 and 32 lanes a query) and
    its first design equal the plain search bit for bit, ties in slot order
    and padded entries included."""
    from sycl_points_tpu_torch.ops import grid_knn as gk

    grid, q, pose = _grid_case(case)
    ref = gk.grid_search_plain(grid, q, k, pose)
    before = dict(cuda_knn.launch_counts)
    for lanes in (None, *cuda_knn.GRID_LANES):
        got = gk.grid_search(grid, q, k, pose, lanes=lanes)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), lanes
    simple = gk.grid_search_simple(grid, q, k, pose)
    torch.cuda.synchronize()
    assert torch.equal(simple[0], ref[0]) and torch.equal(simple[1], ref[1])
    assert cuda_knn.launch_counts["grid_knn"] == before["grid_knn"] + 1 + len(cuda_knn.GRID_LANES)
    assert cuda_knn.launch_counts["grid_knn_simple"] == before["grid_knn_simple"] + 1
    assert bool(torch.isinf(ref[1][-3:]).all())
    if case == "all masked":
        assert bool(torch.isinf(ref[1]).all())
    if case.startswith("lattice") and k > 1:
        d = ref[1][:-3]
        assert bool((d[:, 1:] == d[:, :-1]).any())  # ties held in order
        if k == 16:
            assert bool(torch.isinf(d[:, -1]).any())  # rows with fewer candidates than k


@pytest.mark.parametrize("n_queries", [1, 31, 1000, 12000, 30000])
def test_grid_knn_query_counts(n_queries):
    """Every query count at the lanes grid_lanes picks for it (32 up to a few
    thousand queries on the H100, 16 at 12,000, 8 at 30,000) equals the
    plain search and the first design bit for bit."""
    from sycl_points_tpu_torch.ops import grid_knn as gk

    grid, q, _ = _grid_case("lattice, budget 4")
    q = torch.cat([q[:-5].repeat(-(-n_queries // (q.shape[0] - 5)), 1)[: max(n_queries - 5, 0)],
                   q[-5:][: n_queries]]).contiguous()
    assert q.shape[0] == n_queries
    for k in (1, 10):
        ref = gk.grid_search_plain(grid, q, k)
        for got in (gk.grid_search(grid, q, k), gk.grid_search_simple(grid, q, k)):
            torch.cuda.synchronize()
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _coarse_case(name):
    from sycl_points_tpu_torch.ops.coarse_knn import CoarseKNN

    rng = np.random.default_rng(12)
    pts = rng.uniform(-40, 40, size=(40000, 3)).astype(np.float32)
    pts[:, 2] *= 0.1
    q = torch.from_numpy(rng.uniform(-40, 40, size=(3001, 3)).astype(np.float32) * [1, 1, 0.1]).float().cuda()
    if name == "lidar-like":
        return CoarseKNN.build(_cloud_on_card(pts), coarse_cell=8.0, max_per_cell=256), q.contiguous()
    if name == "small budget":
        return CoarseKNN.build(_cloud_on_card(pts), coarse_cell=8.0, max_per_cell=8), q.contiguous()
    if name == "masked, lost cells":
        mask = rng.uniform(size=len(pts)) > 0.3
        return CoarseKNN.build(_cloud_on_card(pts, mask), coarse_cell=1.0, cells_capacity=512,
                               max_per_cell=16), q.contiguous()
    if name == "all masked":
        return CoarseKNN.build(_cloud_on_card(pts, np.zeros(len(pts), bool)), coarse_cell=8.0), q.contiguous()
    raise ValueError(name)


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("case", ["lidar-like", "small budget", "masked, lost cells", "all masked"])
def test_coarse_refine_kernel_matches_plain(case, k):
    """Kernel B (the lane-group refine) and its first design equal the
    plain refine bit for bit (indices into the sorted layout, distances,
    certificates), on the same selected cells."""
    from sycl_points_tpu_torch.ops import coarse_knn as ckm

    ck, q = _coarse_case(case)
    cells, lb = ck.select_cells(q, 8, 1e-2)
    before = dict(cuda_knn.launch_counts)
    got = ckm.coarse_refine(ck, q, cells.contiguous(), lb.contiguous(), k)
    simple = ckm.coarse_refine_simple(ck, q, cells.contiguous(), lb.contiguous(), k)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["coarse_refine"] == before["coarse_refine"] + 1
    assert cuda_knn.launch_counts["coarse_refine_simple"] == before["coarse_refine_simple"] + 1
    ref = ckm.coarse_refine_plain(ck, q, cells, lb, k)
    for a, b, c in zip(got, ref, simple):
        assert torch.equal(a, b) and torch.equal(c, b)
    if case == "lidar-like":
        assert float(got[2].float().mean()) > 0.5
    if case in ("small budget", "masked, lost cells"):
        assert not bool(got[2].any())
    if case == "all masked":  # nothing to find: every result padding, vacuously certified as in JAX
        assert bool(torch.isinf(got[1]).all()) and bool(got[2].all())


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("window", [8, 64])
def test_morton_window_kernel_matches_plain(window, k):
    """Kernel C equals the plain window search bit for bit on a scan with
    repeated Morton codes and masked points, written in the original order."""
    from sycl_points_tpu_torch.ops import window_knn as wk

    pts, mask = _raw_scan(1024, 32, seed=9)
    mask[::11] = False
    for order in ((0, 1, 2), (2, 0, 1)):
        code = wk.morton_codes(pts, mask, 0.5, order)
        perm = torch.sort(code, stable=True)[1]
        args = (pts[perm].contiguous(), mask[perm].contiguous(), perm.to(torch.int32), window, k)
        before = cuda_knn.launch_counts["morton_window"]
        got = wk.window_search(*args)
        torch.cuda.synchronize()
        assert cuda_knn.launch_counts["morton_window"] == before + 1
        ref = wk.window_search_plain(*args)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    a, b = wk.window_self_knn(pts, mask, 10), wk.window_self_knn(pts.cpu(), mask.cpu(), 10)
    assert torch.equal(a.indices.cpu(), b.indices) and torch.equal(a.distances.cpu(), b.distances)


# -- k above 16: the instances at K = 32, 64 and 128 ------------------------------

LARGE_K = [17, 20, 32, 64, 100, 128]
LARGE_KNN_CASES = ["2049,129,3", "25000,1000,5", "40,300,0", "tail,16384,5000,16384", "dup", "slice masked",
                   "all masked"]


@pytest.mark.parametrize("k", LARGE_K)
@pytest.mark.parametrize("case", LARGE_KNN_CASES)
def test_knn_k_large_k_equals_sorted_plain(case, k):
    """knn_k above 16 equals the tie-ordered plain version bit for bit
    (fewer targets than k and every target masked included), and its first
    16 columns equal the k = 16 search."""
    tgt, qry, mask = _case(case)
    before = cuda_knn.launch_counts["knn_k"]
    i, d = cuda_knn.knn_k(tgt, mask, qry, k)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["knn_k"] == before + 1
    assert tuple(i.shape) == (qry.shape[0], k)
    ri, rd = cuda_knn.knn_k_sorted_plain(tgt, mask, qry, k)
    assert torch.equal(i, ri) and torch.equal(d, rd)
    i16, d16 = cuda_knn.knn_k(tgt, mask, qry, 16)
    assert torch.equal(i[:, :16], i16) and torch.equal(d[:, :16], d16)
    before = cuda_knn.launch_counts["knn_k_spill"]
    si, sd = cuda_knn.knn_k_spill(cuda_knn.prep_target(tgt, mask), qry, k)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["knn_k_spill"] == before + 1
    assert torch.equal(i, si) and torch.equal(d, sd)


@pytest.mark.parametrize("k", LARGE_K)
@pytest.mark.parametrize("case", LARGE_KNN_CASES)
def test_knn_k_batched_large_k_cases(case, k):
    """knn_k_batched above 16 on three streams of each case's target
    (stream b masks every third row from b as well) equals B single launches,
    the tie-ordered plain version and the one-thread instances (knn_k_spill) bit for
    bit, in one launch."""
    tgt, qry, mask = _case(case)
    B, m = 3, tgt.shape[0]
    rows = torch.arange(m, device="cuda")
    bmask = torch.stack([mask & (rows % 3 != b) for b in range(B)]).contiguous()
    bpts = tgt.expand(B, m, 3).contiguous()
    bqry = qry.expand(B, *qry.shape).contiguous()
    prep = cuda_knn.prep_targets(bpts, bmask)
    before = dict(cuda_knn.launch_counts)
    i, d = cuda_knn.knn_k_batched(prep, bqry, k)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["knn_k_batched"] == before["knn_k_batched"] + 1
    assert cuda_knn.launch_counts["knn_k_spill"] == before["knn_k_spill"]
    si, sd = cuda_knn.knn_k_spill(prep, bqry, k)
    assert torch.equal(i, si) and torch.equal(d, sd)
    for b in range(B):
        oi, od = cuda_knn.knn_k_prepped(cuda_knn.prep_target(bpts[b], bmask[b]), qry, k)
        assert torch.equal(i[b], oi) and torch.equal(d[b], od)
        ri, rd = cuda_knn.knn_k_sorted_plain(bpts[b], bmask[b], qry, k)
        assert torch.equal(i[b], ri) and torch.equal(d[b], rd)


@pytest.mark.parametrize("k", LARGE_K)
def test_knn_k_batched_large_k(k):
    """The batched instances above 16 equal a single launch a stream and the
    tie-ordered plain version bit for bit (a stream all masked, exact ties
    across slices)."""
    B = 4
    pts, mask = _ties(*_fleet_targets(B, 4099, 81))
    prep = cuda_knn.prep_targets(pts, mask)
    before = cuda_knn.launch_counts["knn_k_batched"]
    i, d = cuda_knn.knn_k_batched(prep, pts, k)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["knn_k_batched"] == before + 1
    for b in range(B):
        si, sd = cuda_knn.knn_k_prepped(cuda_knn.prep_target(pts[b], mask[b]), pts[b].contiguous(), k)
        assert torch.equal(i[b], si) and torch.equal(d[b], sd)
        ri, rd = cuda_knn.knn_k_sorted_plain(pts[b], mask[b], pts[b], k)
        assert torch.equal(i[b], ri) and torch.equal(d[b], rd)


# ---- ragged fleets: each stream sweeps [0, extent) ---------------------------

# The extents of one 8-stream launch on 16,384-row targets: none valid, one
# row, either side of a 32-row unit and of the 512-row tile, a submap
# extraction's ~430, and Mp itself.
RAGGED = (0, 1, 31, 33, 430, 511, 513, 16384)
RAGGED_CASES = ["prefix", "scattered", "ties"]
RAGGED_K = [1, 10, 16, 20, 32, 128]


def _ragged_targets(case):
    """Targets [8, 16384, 3] whose extents are RAGGED ("prefix": valid
    prefixes; "scattered": ~30% of each prefix valid, its last row kept;
    "ties": the prefixes' first halves twice over, extents 8,192 + RAGGED
    below 8,192) and 1,012 queries a stream, 512 of them on target rows."""
    B, m = len(RAGGED), 16384
    pts = torch.stack([_cloud(m, 140 + b)[0] for b in range(B)])
    rows = torch.arange(m, device="cuda")[None, :]
    ext = torch.tensor(RAGGED, device="cuda")[:, None]
    mask = rows < ext
    if case == "scattered":
        keep = torch.rand((B, m), generator=torch.Generator(device="cuda").manual_seed(3), device="cuda") < 0.3
        mask &= keep | (rows == ext - 1)
    if case == "ties":
        pts, mask = _ties(pts, mask)
    qry = torch.cat([torch.stack([_cloud(500, 160 + b)[0] for b in range(B)]), pts[:, ::32]], 1).contiguous()
    return pts, mask, qry


def _check_extents(prep, mask):
    last = [int(torch.nonzero(mb).max()) + 1 if bool(mb.any()) else 0 for mb in mask]
    assert prep.extent.tolist() == last


@pytest.mark.parametrize("with_pose", [False, True])
@pytest.mark.parametrize("case", RAGGED_CASES)
def test_nn1_batched_ragged_extents(case, with_pose):
    """nn1_batched on ragged targets equals its plain version, B single
    launches and the full sweep of a hand-built target without an extent,
    bit for bit."""
    pts, mask, qry = _ragged_targets(case)
    B = pts.shape[0]
    poses = torch.stack([se3_exp(torch.tensor([0.01 * b, 0.0, 0.02, 0.3, -0.1 * b, 0.0]))
                         for b in range(B)]).cuda() if with_pose else None
    prep = cuda_knn.prep_targets(pts, mask)
    _check_extents(prep, mask)
    before = cuda_knn.launch_counts["nn1_batched"]
    i, d = cuda_knn.nn1_prepped_batched(prep, qry, poses)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["nn1_batched"] == before + 1
    ri, rd = cuda_knn.nn1_batched_plain(pts, mask, qry, poses)
    assert torch.equal(i, ri) and torch.equal(d, rd)
    fi, fd = cuda_knn.nn1_prepped_batched(cuda_knn.PreppedTarget(prep.xyz, prep.M), qry, poses)
    assert torch.equal(i, fi) and torch.equal(d, fd)
    for b in range(B):
        si, sd = cuda_knn.nn1_prepped(cuda_knn.prep_target(pts[b], mask[b]), qry[b],
                                      None if poses is None else poses[b])
        assert torch.equal(i[b], si) and torch.equal(d[b], sd)
    assert bool(torch.isinf(d[0]).all()) and bool((i[0] == 0).all())


@pytest.mark.parametrize("k", RAGGED_K)
@pytest.mark.parametrize("case", RAGGED_CASES)
def test_knn_k_batched_ragged_extents(case, k):
    """knn_k_batched on ragged targets equals the tie-ordered plain version
    (and knn_k_simple up to 16), B single launches and the full sweep of a
    hand-built target without an extent, bit for bit."""
    pts, mask, qry = _ragged_targets(case)
    prep = cuda_knn.prep_targets(pts, mask)
    _check_extents(prep, mask)
    before = cuda_knn.launch_counts["knn_k_batched"]
    i, d = cuda_knn.knn_k_batched(prep, qry, k)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["knn_k_batched"] == before + 1
    fi, fd = cuda_knn.knn_k_batched(cuda_knn.PreppedTarget(prep.xyz, prep.M), qry, k)
    assert torch.equal(i, fi) and torch.equal(d, fd)
    for b in range(pts.shape[0]):
        si, sd = cuda_knn.knn_k_prepped(cuda_knn.prep_target(pts[b], mask[b]), qry[b], k)
        assert torch.equal(i[b], si) and torch.equal(d[b], sd)
        ri, rd = cuda_knn.knn_k_sorted_plain(pts[b], mask[b], qry[b], k)
        assert torch.equal(i[b], ri) and torch.equal(d[b], rd)
        if k <= cuda_knn.FAST_MAX_K:
            ri, rd = cuda_knn.knn_k_simple(pts[b], mask[b], qry[b], k)
            assert torch.equal(i[b], ri) and torch.equal(d[b], rd)
    assert bool(torch.isinf(d[0]).all()) and bool((i[0] == 0).all())


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ragged_extents_every_slice_count(case):
    """Every query tile and slice count cuts the extents into disjoint
    slices: nn1 at 32 / 64 / 128 queries x 1..16 slices and knn_k at k = 10
    (1..16 slices) and 20 (1..8) equal their plain versions bit for bit."""
    pts, mask, qry = _ragged_targets(case)
    prep = cuda_knn.prep_targets(pts, mask)
    ri, rd = cuda_knn.nn1_batched_plain(pts, mask, qry)
    for qt in cuda_knn.NN1_QUERY_TILES:
        for s in cuda_knn.CLUSTER_SLICES:
            i, d = cuda_knn._nn1_cluster("nn1_batched", prep, qry, None, qt, s)
            torch.cuda.synchronize()
            assert torch.equal(i, ri) and torch.equal(d, rd), (qt, s)
    for k in (10, 20):
        refs = [cuda_knn.knn_k_sorted_plain(pts[b], mask[b], qry[b], k) for b in range(pts.shape[0])]
        for s in cuda_knn.knn_slices(k):
            i, d = cuda_knn._knn_k_cluster("knn_k_batched", prep, qry, k, s)
            torch.cuda.synchronize()
            for b, (ri_b, rd_b) in enumerate(refs):
                assert torch.equal(i[b], ri_b) and torch.equal(d[b], rd_b), (k, s, b)


def test_prepped_target_extent_checked():
    pts, mask, qry = _ragged_targets("prefix")
    prep = cuda_knn.prep_targets(pts, mask)
    with pytest.raises(ValueError, match="extent"):
        cuda_knn.nn1_prepped_batched(prep._replace(extent=prep.extent[:3]), qry)
    with pytest.raises(ValueError, match="extent"):
        cuda_knn.knn_k_batched(prep._replace(extent=prep.extent.long()), qry, 10)


@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_knn_large_k_matches_plain(case):
    """grid_knn above 16 at each lane count equals the plain search bit for
    bit; k above the 27 cells' slots is refused."""
    from sycl_points_tpu_torch.ops import grid_knn as gk

    grid, q, pose = _grid_case(case)
    cap = 27 * grid.max_per_cell
    for k in LARGE_K:
        if k > cap:
            with pytest.raises(ValueError):
                gk.grid_search(grid, q, k, pose)
            continue
        ref = gk.grid_search_plain(grid, q, k, pose)
        for lanes in (None, *cuda_knn.GRID_LANES):
            got = gk.grid_search(grid, q, k, pose, lanes=lanes)
            torch.cuda.synchronize()
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (k, lanes)


@pytest.mark.parametrize("k", LARGE_K)
@pytest.mark.parametrize("case", ["full width", "collisions", "all masked", "masked, window (8, 4)", "n_az 1000",
                                  "128 rings"])
def test_range_image_window_large_k_matches_plain(case, k):
    """The window kernel above 16 (a warp a cell, a tile planned for its K)
    equals the plain window search bit for bit, and range_image_knn on the
    card the plain sequence; k above the window's candidates (128 at the
    default window's 117) is refused by both before any launch."""
    from sycl_points_tpu_torch.ops import range_image_knn as ri

    pts, mask, kw = _range_image_case(case)
    n_az, n_rings = kw.get("n_az", 2048), kw.get("n_rings", 64)
    w_az, w_el = kw.get("window_az", 6), kw.get("window_el", 4)
    if k > ri.window_candidates(w_az, w_el):
        before = dict(cuda_knn.launch_counts)
        with pytest.raises(ValueError, match="candidates"):
            ri.range_image_knn(pts, mask, k, n_az, n_rings, w_az, w_el)
        assert cuda_knn.launch_counts == before
        k = ri.window_candidates(w_az, w_el)
    img_p, img_i, cell, ok, _ = ri.range_image(pts, mask, n_az, n_rings)
    got = ri.range_image_window(img_p, img_i, n_az, n_rings, w_az, w_el, k)
    torch.cuda.synchronize()
    ref = ri.range_image_window_plain(img_p, img_i, n_az, n_rings, w_az, w_el, k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    res = ri.range_image_knn(pts, mask, k, n_az, n_rings, w_az, w_el)
    plain = ri.point_rows(*ref, cell, ok)
    assert torch.equal(res.knn.indices, plain.indices) and torch.equal(res.knn.distances, plain.distances)


@pytest.mark.parametrize("window", [(6, 4), (8, 4), (2, 7)])
@pytest.mark.parametrize("k", [17, 20, 32, 64, 100, 117])
@pytest.mark.parametrize("case", ["full width", "collisions", "all masked", "partial fan", "n_az 1000", "16 rings",
                                  "128 rings"])
def test_range_image_warp_kernel_matches_plain(case, k, window):
    """The warp kernel (k above 16) bit-equal to the plain window search and
    to the one-thread tile (range_image_window_spill) on the image, and in
    the gather form (range_image_knn on the card) to the plain sequence;
    (2, 7) has 75 candidates, so k = 100 and 117 are refused there."""
    from sycl_points_tpu_torch.ops import range_image_knn as ri

    pts, mask, kw = _range_image_case(case)
    n_az, n_rings = kw.get("n_az", 2048), kw.get("n_rings", 64)
    el = {b: kw[b] for b in ("el_min", "el_max") if b in kw}
    if k > ri.window_candidates(*window):
        with pytest.raises(ValueError, match="candidates"):
            ri.range_image_window_gather(pts, torch.zeros(n_az * n_rings, dtype=torch.int32, device="cuda"),
                                         n_az, n_rings, *window, k)
        return
    img_p, img_i, cell, ok, _ = ri.range_image(pts, mask, n_az, n_rings, **el)
    ref = ri.range_image_window_plain(img_p, img_i, n_az, n_rings, *window, k)
    before = dict(cuda_knn.launch_counts)
    got = ri.range_image_window(img_p, img_i, n_az, n_rings, *window, k)
    spill = ri.range_image_window_spill(img_p, img_i, n_az, n_rings, *window, k)
    res = ri.range_image_knn(pts, mask, k, n_az, n_rings, *window, **el)
    torch.cuda.synchronize()
    counted = {name: cuda_knn.launch_counts[name] - before[name] for name in before}
    assert counted["range_image"] == 2 and counted["range_image_spill"] == 1
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(spill[0], ref[0]) and torch.equal(spill[1], ref[1])
    plain = ri.point_rows(*ref, cell, ok)
    assert torch.equal(res.knn.indices, plain.indices) and torch.equal(res.knn.distances, plain.distances)
    if case == "all masked":
        assert bool((got[0] == -1).all())


@pytest.mark.parametrize("k", LARGE_K)
def test_morton_window_large_k_matches_plain(k):
    from sycl_points_tpu_torch.ops import window_knn as wk

    pts, mask = _raw_scan(1024, 32, seed=9)
    mask[::11] = False
    for order in ((0, 1, 2), (2, 0, 1)):
        perm = torch.sort(wk.morton_codes(pts, mask, 0.5, order), stable=True)[1]
        args = (pts[perm].contiguous(), mask[perm].contiguous(), perm.to(torch.int32), 64, k)
        got = wk.window_search(*args)
        torch.cuda.synchronize()
        ref = wk.window_search_plain(*args)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError):
        wk.window_search(*args[:3], 8, k)  # 2 W = 16 candidates


# -- the Morton window in a few launches: codes, the gather-form passes, the union --

WINDOW_K = [1, 10, 16, 20, 64, 128]


def _window_case(name, window):
    pts, mask = _raw_scan(1024, 32, seed=9)
    mask[::11] = False
    if name == "all masked":
        mask = torch.zeros_like(mask)
    if name == "N < 2W":
        pts, mask = pts[: 2 * window - 5].contiguous(), mask[: 2 * window - 5].contiguous()
    return pts, mask


def _equal(got, ref, what):
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), what


def _check_window_kernels(pts, mask, window, k, cell):
    """Every window kernel against its plain version bit for bit, and
    window_self_knn (a memset and four kernels) against the plain two-pass
    version, with its launches."""
    from sycl_points_tpu_torch.ops import window_knn as wk

    codes = wk.morton_codes_passes(pts, mask, cell)
    assert torch.equal(codes, wk.morton_codes_passes_plain(pts, mask, cell))
    for p, order in enumerate(wk.AXES):
        assert torch.equal(wk.morton_codes_passes(pts, mask, cell, (order,))[0], codes[p])
    order = torch.sort(codes, dim=1, stable=True)[1]
    p1 = wk.window_gather(pts, mask, order[0], window, k)
    ref1 = wk.window_gather_plain(pts, mask, order[0], window, k)
    _equal(p1, ref1, "pass 1")
    _equal(wk.window_gather(pts, mask, order[0], window, k, final=True),
           wk.window_gather_plain(pts, mask, order[0], window, k, final=True), "pass 1, final")
    p2 = wk.window_gather(pts, mask, order[1], window, k)
    _equal(p2, wk.window_gather_plain(pts, mask, order[1], window, k), "pass 2")
    _equal(wk.window_gather(pts, mask, order[1], window, k, prev=p1),
           wk.window_gather_plain(pts, mask, order[1], window, k, prev=ref1), "the union pass")
    args = (pts[order[0]].contiguous(), mask[order[0]].contiguous(), order[0].to(torch.int32), window, k)
    ref = wk.window_search_plain(*args)
    _equal(wk.window_search(*args), ref, "the sorted form")
    _equal(wk.morton_window_simple(*args), ref, "the first design")
    torch.cuda.synchronize()
    before = dict(cuda_knn.launch_counts)
    got = wk.window_self_knn(pts, mask, k, window=window, cell_size=cell)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in cuda_knn.launch_counts.items() if c != before[n]}
    want = {"morton_min": 1, "morton_codes": 1, "morton_window": 1, "morton_window_union": 1}
    assert moved == (want if pts.shape[0] else {}), moved
    ref = wk.window_self_knn_plain(pts, mask, k, window, cell)
    _equal((got.indices, got.distances), (ref.indices, ref.distances), "window_self_knn")
    one = wk.window_self_knn(pts, mask, k, window=window, cell_size=cell, passes=1)
    ref = wk.window_self_knn_plain(pts, mask, k, window, cell, passes=1)
    _equal((one.indices, one.distances), (ref.indices, ref.distances), "one pass")
    return p1, p2


@pytest.mark.parametrize("k", WINDOW_K)
@pytest.mark.parametrize("window", [8, 64])
@pytest.mark.parametrize("case", ["scan", "all masked", "N < 2W"])
def test_morton_window_kernels_match_plain(case, window, k):
    """The codes kernels, the gather-form passes (3e38 kept, and +inf), the
    union pass, the sorted form and the first design equal their plain
    versions bit for bit on a scan with repeated Morton codes and masked
    points, every point masked, and fewer points than 2 W; window_self_knn
    is a launch of each of morton_min, morton_codes, morton_window and
    morton_window_union; k above 2 W is refused."""
    from sycl_points_tpu_torch.ops import window_knn as wk

    pts, mask = _window_case(case, window)
    if k > 2 * window:
        with pytest.raises(ValueError, match="candidates"):
            wk.window_self_knn(pts, mask, k, window=window)
        return
    _check_window_kernels(pts, mask, window, k, 0.5)


@pytest.mark.parametrize("k", sorted(SHADOW))
def test_morton_window_kernels_on_the_shadowing_scene(k):
    """The same on scenes where a pass-1 padding entry shadows the same index
    in pass 2 (the union keeps JAX's rule: that entry turns into a 3e38
    duplicate), at k = 6, 20 and 64 and, on the k = 64 scene, at every
    window instance up to 2 W."""
    pts, mask, window = shadow_scene(k)
    pts, mask = torch.from_numpy(pts).cuda(), torch.from_numpy(mask).cuda()
    p1, p2 = _check_window_kernels(pts, mask, window, k, SHADOW_CELL)
    assert shadowed(*p1, *p2) > 0
    if k == 64:
        for kk in (kk for kk in WINDOW_K if kk <= 2 * window):
            _check_window_kernels(pts, mask, window, kk, SHADOW_CELL)


def test_morton_window_empty_cloud():
    from sycl_points_tpu_torch.ops import window_knn as wk

    pts, mask = torch.zeros((0, 3), device="cuda"), torch.zeros(0, dtype=torch.bool, device="cuda")
    r = wk.window_self_knn(pts, mask, 10, window=8)
    assert tuple(r.indices.shape) == (0, 10) and tuple(r.distances.shape) == (0, 10)


@pytest.mark.parametrize("k", [10, 64])
def test_morton_window_refuses_a_tile_beyond_shared_memory(k):
    """The widest window whose staged tile fits a block's shared memory runs
    and equals the plain version (both passes and the union); one more
    position a side raises a ValueError naming the limit before any launch."""
    from sycl_points_tpu_torch.ops import window_knn as wk

    fits = lambda w, union: wk.window_smem(w, k, union) <= cuda_knn.SMEM_BYTES
    widest = max(w for w in range(1, 8000) if fits(w, True))
    pts, mask = _raw_scan(64, 8, seed=3)
    _check_window_kernels(pts, mask, widest, k, 0.5)
    order = torch.sort(wk.morton_codes_passes(pts, mask, 0.5), dim=1, stable=True)[1]
    p1 = wk.window_gather(pts, mask, order[0], widest, k)
    torch.cuda.synchronize()
    before = dict(cuda_knn.launch_counts)
    for call in (lambda: wk.window_self_knn(pts, mask, k, window=widest + 1),
                 lambda: wk.window_gather(pts, mask, order[1], widest + 1, k, prev=p1)):
        with pytest.raises(ValueError, match="shared memory"):
            call()
    assert cuda_knn.launch_counts == before
    widest_pass = max(w for w in range(1, 8000) if fits(w, False))
    args = (pts[order[0]].contiguous(), mask[order[0]].contiguous(), order[0].to(torch.int32))
    _equal(wk.window_search(*args, widest_pass, k), wk.window_search_plain(*args, widest_pass, k), "widest pass")
    with pytest.raises(ValueError, match="shared memory"):
        wk.window_search(*args, widest_pass + 1, k)


REFINE_K = [1, 10, 20, 128, 17, 32, 64, 100]


@pytest.mark.parametrize("k", REFINE_K)
@pytest.mark.parametrize("case", ["lidar-like", "small budget", "masked, lost cells", "all masked"])
def test_coarse_refine_lanes_match_plain(case, k):
    """The lane-group refine at 8, 16 and 32 lanes (and the planned count)
    equals the plain refine bit for bit; k above P L is refused."""
    from sycl_points_tpu_torch.ops import coarse_knn as ckm

    ck, q = _coarse_case(case)
    cells, lb = ck.select_cells(q, 8, 1e-2)
    if k > 8 * ck.max_per_cell:
        with pytest.raises(ValueError):
            ckm.coarse_refine(ck, q, cells, lb, k)
        return
    ref = ckm.coarse_refine_plain(ck, q, cells, lb, k)
    for lanes in (None, *cuda_knn.GRID_LANES):
        got = ckm.coarse_refine(ck, q, cells, lb, k, lanes=lanes)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b), (lanes, a.dtype)


def _rank_case(name):
    """(CoarseKNN, queries, P, margin) of a ranking case."""
    from sycl_points_tpu_torch.ops.coarse_knn import CoarseKNN

    if name == "lattice ties":
        rng = np.random.default_rng(9)
        cells = np.stack(np.meshgrid(np.arange(12), np.arange(12), np.arange(3), indexing="ij"), -1).reshape(-1, 3)
        offs = np.stack(np.meshgrid(*[np.array([0.2, 0.5, 0.8])] * 3, indexing="ij"), -1).reshape(-1, 3)
        pts = (cells[:, None, :] + offs[None]).reshape(-1, 3) + rng.normal(scale=0.01, size=(len(cells) * 27, 3))
        q = rng.uniform([1, 1, 0.5], [11, 11, 2.5], size=(2000, 3)).astype(np.float32)
        ck = CoarseKNN.build(_cloud_on_card(pts[rng.permutation(len(pts))]), coarse_cell=1.0, max_per_cell=32)
        return ck, torch.from_numpy(q).cuda(), 6, 1.0
    base = "lidar-like" if name in ("P = C", "whole capacity", "keep 33", "keep 100") else name
    ck, q = _coarse_case(base)
    if name == "P = C":
        pts = ck.points[ck.mask].cpu().numpy()
        return CoarseKNN.build(_cloud_on_card(pts), coarse_cell=8.0, cells_capacity=16), q, 16, 1e-2
    if name == "whole capacity":  # every cell ranked, the empty ones by their flags
        C = ck.centroids.shape[0]
        return dataclasses.replace(ck, occupied=torch.tensor(C, dtype=torch.int32, device="cuda")), q, 8, 1e-2
    if name.startswith("keep"):
        return ck, q, int(name.split()[1]) - 1, 1e-2
    return ck, q, 8, 1e-2


@pytest.mark.parametrize("case", ["lidar-like", "lattice ties", "P = C", "all masked", "masked, lost cells",
                                  "whole capacity", "keep 33", "keep 100"])
def test_coarse_rank_matches_plain(case):
    """coarse_rank equals the plain ranking bit for bit: the cells in order
    (ties to the lower cell) and the unexplored bound."""
    from sycl_points_tpu_torch.ops import coarse_knn as ckm

    ck, q, P, margin = _rank_case(case)
    before = cuda_knn.launch_counts["coarse_rank"]
    cells, lb = ckm.coarse_rank(ck, q, P, margin)
    torch.cuda.synchronize()
    assert cuda_knn.launch_counts["coarse_rank"] == before + 1
    ref = ckm.rank_cells_plain(ck, q, P, margin)
    assert torch.equal(cells, ref[0]) and torch.equal(lb, ref[1])
    if case == "lattice ties":
        assert float((lb == 0).float().mean()) > 0.9
    if case in ("P = C", "all masked"):
        assert bool(torch.isinf(lb).all())
    if case == "all masked":
        assert bool((cells == torch.arange(P, device="cuda", dtype=torch.int32)).all())
    with pytest.raises(ValueError):
        ckm.coarse_rank(ck, q, ckm.RANK_MAX_TAKE, margin) if ck.centroids.shape[0] > ckm.RANK_MAX_TAKE else \
            ckm.coarse_rank(ck, q, ck.centroids.shape[0] + 1, margin)
