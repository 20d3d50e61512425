"""The study kernels' counterparts against the TPU studies, on the CPU.

The TPU tile sweep (``scripts/bench_pallas_tiles.py``, ``make_nn1``) and the
variant study (``scripts/bench_nn1_variants.py``, v0-v3) are loaded from
their files; on the loaded module objects only, ``pl`` is replaced by a
namespace whose ``pallas_call`` runs in interpret mode. The same seeded
numpy inputs (M=3000 targets with every 37th masked, Q=700 queries, uniform
+-50 m) go through each Pallas kernel and the port's wrapper, which runs
``nn1_plain`` for CPU tensors (``nn1_tiled``, ``nn1_bias``, ``nn1_lanes``,
``nn1_unroll2``: ``nn1_tiled_plain``, ``nn1_bias_plain``,
``nn1_lanes_plain``, ``nn1_unroll2_plain``, the plain models of the ring's
split merge, at the split an H100 takes).

``nn1_tiled_plain`` (the least ``(d2 bits << 32) | index`` over the target's
splits) is held bit for bit to ``nn1_plain`` and to ``make_nn1`` at spans of
1 row to more than the target, on exact ties across splits, masked rows and
every row masked; ``nn1_tiled_span``'s plan on the H100's 132 SMs. So are
``nn1_bias_plain`` (v1's biased distance) and ``nn1_unroll2_plain`` (v3's
fold of adjacent rows) on the bias-packed target (``pack_bias_target``: x,
y, z, b, masked rows keeping their coordinates, an even row count) at the
same spans rounded up to even, with the queries as masked rows of the
target and an odd M besides, against ``nn1_plain`` bit for bit and JAX's
v1 / v3 as below; ties inside a pair; the packing's layout; the refusals
before any launch. ``nn1_lanes_plain`` (v2's lanes, each with its own
running best over rows ``l, l + L, ...`` of a split, reduced to the least
distance and then the least index) at L = 8 and 32 likewise, at the spans as
they are, against JAX's v2; twins ``L - 1``, ``L`` and ``L + 1`` rows apart;
the lane-aware split plan (``nn1_tiled_span`` with ``lanes``).

Tolerances: indices equal except where the two distances are tied within
1e-6; distances within atol=1e-5 (both sides are exact f32 difference-form
distances; a probe measured 7.6e-6 at this size: XLA's CPU sum is not the
plain version's operation order, so about a fifth of JAX's distances differ
from it in the last bits).

With every target masked the port keeps ``pallas_knn.nn1_pallas``'s
semantics (idx 0, d2 = +inf). The TPU studies do not: they lack its mapping
of d >= 3e38 to inf and return d = 3e38, and v2 also returns idx 2**31 - 1.
``test_all_masked`` states both.
"""

import functools
import importlib.util
import types
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_parity import np_

from sycl_points_tpu_torch.ops import cuda_knn
from sycl_points_tpu_torch.scripts import bench_nn1_tiles, bench_nn1_variants

ROOT = Path(__file__).resolve().parents[1]
M, Q, MASK_EVERY = 3000, 700, 37
TIE = 1e-6
D_ATOL = 1e-5
BIG = 3.0e38


def _load_study(name: str):
    spec = importlib.util.spec_from_file_location(f"tpu_study_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(**{**vars(pl), "pallas_call": functools.partial(pl.pallas_call, interpret=True)})
    return mod


@pytest.fixture(scope="module")
def studies():
    return types.SimpleNamespace(tiles=_load_study("bench_pallas_tiles"), variants=_load_study("bench_nn1_variants"))


def _inputs(seed: int, mask_every: int = MASK_EVERY):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-50, 50, (M, 3)).astype(np.float32)
    mask = np.ones(M, bool)
    if mask_every:
        mask[::mask_every] = False
    q = rng.uniform(-50, 50, (Q, 3)).astype(np.float32)
    return t, mask, q


# (TPU kernel on the loaded studies, the port's wrapper)
CASES = {
    "v0(1024,2048) / nn1": (lambda s: s.variants.make_v0(1024, 2048), cuda_knn.nn1),
    "v1(1024,2048) / nn1_bias": (lambda s: s.variants.make_v1(1024, 2048), cuda_knn.nn1_bias),
    "v2(512,1024) / nn1_lanes 8": (lambda s: s.variants.make_v2(512, 1024),
                                   functools.partial(cuda_knn.nn1_lanes, lanes=8)),
    "v2(512,1024) / nn1_lanes 32": (lambda s: s.variants.make_v2(512, 1024),
                                    functools.partial(cuda_knn.nn1_lanes, lanes=32)),
    "v3(512,1024) / nn1_unroll2": (lambda s: s.variants.make_v3(512, 1024), cuda_knn.nn1_unroll2),
    # the first designs of v1 and v3, kept for timing
    "v1(1024,2048) / nn1_bias_simple": (lambda s: s.variants.make_v1(1024, 2048), cuda_knn.nn1_bias_simple),
    "v3(512,1024) / nn1_unroll2_simple": (lambda s: s.variants.make_v3(512, 1024), cuda_knn.nn1_unroll2_simple),
    "v2(512,1024) / nn1_lanes_simple 8": (lambda s: s.variants.make_v2(512, 1024),
                                          functools.partial(cuda_knn.nn1_lanes_simple, lanes=8)),
    "v2(512,1024) / nn1_lanes_simple 32": (lambda s: s.variants.make_v2(512, 1024),
                                           functools.partial(cuda_knn.nn1_lanes_simple, lanes=32)),
    # the first design, nn1_tiled_simple (threads x tile)
    "make_nn1(1024,512) / nn1_tiled 128x2048": (lambda s: s.tiles.make_nn1(1024, 512),
                                                functools.partial(cuda_knn.nn1_tiled_simple, threads=128, tile=2048)),
    "make_nn1(1024,512) / nn1_tiled 64x512": (lambda s: s.tiles.make_nn1(1024, 512),
                                              functools.partial(cuda_knn.nn1_tiled_simple, threads=64, tile=512)),
    "make_nn1(1024,512) / nn1_tiled 512x4096": (lambda s: s.tiles.make_nn1(1024, 512),
                                                functools.partial(cuda_knn.nn1_tiled_simple, threads=512, tile=4096)),
    # the design for the card, nn1_tiled (query tile x chunk)
    "make_nn1(1024,512) / nn1_tiled queries 64 chunk 512": (
        lambda s: s.tiles.make_nn1(1024, 512), functools.partial(cuda_knn.nn1_tiled, query_tile=64, chunk=512)),
    "make_nn1(256,2048) / nn1_tiled queries 256 chunk 2048": (
        lambda s: s.tiles.make_nn1(256, 2048), functools.partial(cuda_knn.nn1_tiled, query_tile=256, chunk=2048)),
    "make_nn1(512,4096) / nn1_tiled queries 512 chunk 4096": (
        lambda s: s.tiles.make_nn1(512, 4096), functools.partial(cuda_knn.nn1_tiled, query_tile=512, chunk=4096)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_tpu_study(studies, case):
    make_tpu, port = CASES[case]
    t, mask, q = _inputs(seed=len(case))
    ji, jd = make_tpu(studies)(jnp.asarray(t), jnp.asarray(mask), jnp.asarray(q))
    ti, td = port(torch.from_numpy(t), torch.from_numpy(mask), torch.from_numpy(q))
    ji, jd = torch.from_numpy(np.array(ji)), torch.from_numpy(np.array(jd))
    assert cuda_knn.nn1_mismatches(ti, td, ji, jd, TIE) == 0
    np.testing.assert_allclose(np_(td), np_(jd), rtol=0, atol=D_ATOL)
    assert bool(torch.from_numpy(mask)[ti.long()].all())


ALL_MASKED = {  # TPU kernel, the index it returns when no target is valid
    "v0": (lambda s: s.variants.make_v0(1024, 2048), 0),
    "v1": (lambda s: s.variants.make_v1(1024, 2048), 0),
    "v2": (lambda s: s.variants.make_v2(512, 1024), 2**31 - 1),
    "v3": (lambda s: s.variants.make_v3(512, 1024), 0),
    "make_nn1": (lambda s: s.tiles.make_nn1(1024, 512), 0),
}


@pytest.mark.parametrize("kernel", sorted(ALL_MASKED))
def test_all_masked(studies, kernel):
    make_tpu, tpu_idx = ALL_MASKED[kernel]
    t, _, q = _inputs(seed=5)
    none = np.zeros(M, bool)
    ji, jd = make_tpu(studies)(jnp.asarray(t), jnp.asarray(none), jnp.asarray(q))
    # the TPU studies' traits: d = 3e38, not inf; v2 also idx 2**31 - 1
    assert np.all(np.asarray(jd) == np.float32(BIG)) and np.all(np.asarray(ji) == tpu_idx)
    # the port keeps nn1_pallas's semantics for every wrapper
    args = (torch.from_numpy(t), torch.from_numpy(none), torch.from_numpy(q))
    for port in (cuda_knn.nn1, cuda_knn.nn1_bias, cuda_knn.nn1_unroll2, cuda_knn.nn1_bias_simple,
                 cuda_knn.nn1_unroll2_simple,
                 lambda t, m, q: cuda_knn.nn1_bias_prepped(cuda_knn.pack_bias_target(t, m), q, 64, 512),
                 lambda t, m, q: cuda_knn.nn1_unroll2_prepped(cuda_knn.pack_bias_target(t, m), q, 512, 4096),
                 functools.partial(cuda_knn.nn1_lanes, lanes=8), functools.partial(cuda_knn.nn1_lanes, lanes=32),
                 functools.partial(cuda_knn.nn1_lanes_simple, lanes=8),
                 functools.partial(cuda_knn.nn1_lanes_simple, lanes=32),
                 lambda t, m, q: cuda_knn.nn1_lanes_prepped(cuda_knn.pack_bias_target(t, m), q, 8, 64, 512),
                 lambda t, m, q: cuda_knn.nn1_lanes_prepped(cuda_knn.pack_bias_target(t, m), q, 32, 512, 4096),
                 functools.partial(cuda_knn.nn1_tiled_simple, threads=256, tile=1024),
                 functools.partial(cuda_knn.nn1_tiled, query_tile=128, chunk=1024)):
        ti, td = port(*args)
        assert bool((ti == 0).all()) and bool(torch.isinf(td).all())


def test_wrappers_reject_instances_not_built():
    t, mask, q = (torch.from_numpy(a) for a in _inputs(seed=6))
    with pytest.raises(ValueError):
        cuda_knn.nn1_tiled_simple(t, mask, q, threads=96, tile=2048)
    with pytest.raises(ValueError):
        cuda_knn.nn1_tiled_simple(t, mask, q, threads=128, tile=8192)
    for lanes in (1, 16, 64):
        with pytest.raises(ValueError, match="lanes"):
            cuda_knn.nn1_lanes(t, mask, q, lanes=lanes)
        with pytest.raises(ValueError, match="lanes"):
            cuda_knn.nn1_lanes_simple(t, mask, q, lanes=lanes)
        with pytest.raises(ValueError, match="lanes"):
            cuda_knn.nn1_lanes_prepped(cuda_knn.pack_bias_target(t, mask), q, lanes)
        with pytest.raises(ValueError, match="lanes"):
            cuda_knn.nn1_lanes_plain(cuda_knn.pack_bias_target(t, mask), q, 256, lanes)
    with pytest.raises(ValueError):
        cuda_knn.nn1_bias(t[:, :2].contiguous(), mask, q)


@pytest.mark.parametrize("study,n_instances", [(bench_nn1_tiles, 16), (bench_nn1_variants, 9)])
def test_study_entry_points_on_the_cpu(study, n_instances):
    """``n_instances`` a design: the tile sweep runs both of its designs'
    16 instances and the cluster nn1 at each shape."""
    shapes = ((70, 300), (33, 1100))
    rows = study.main(shapes=shapes, device="cpu")
    per_shape = len(study.INSTANCES)
    if study is bench_nn1_tiles:
        assert Counter(name for name, _, _ in study.INSTANCES.values()) == {
            "nn1_tiled_simple": n_instances, "nn1_tiled": n_instances, "nn1": 1}
    else:
        assert per_shape == n_instances
    assert len(rows) == per_shape * len(shapes)
    assert all(r["agree"] == 1.0 and r["dmax"] == 0.0 and r["agree_v0"] == 1.0 for r in rows)
    assert [(r["Q"], r["M"]) for r in rows[::per_shape]] == list(shapes)


def test_study_inputs_follow_the_tpu_scripts():
    """Targets, then queries, from default_rng(0), uniform +-50 m."""
    rng = np.random.default_rng(0)
    t, m, q = bench_nn1_variants.study_inputs(np.random.default_rng(0), 40, 100, MASK_EVERY, torch.device("cpu"))
    np.testing.assert_array_equal(np_(t), rng.uniform(-50, 50, (100, 3)).astype(np.float32))
    np.testing.assert_array_equal(np_(q), rng.uniform(-50, 50, (40, 3)).astype(np.float32))
    assert np_(m).tolist() == [0 if i % MASK_EVERY == 0 else 1 for i in range(100)]


# -- nn1_tiled: the split merge's plain model, its plan, its refusals ---------


SPANS = [1, 7, 256, 1500, 2999, 3000, 5000]
MERGE_CASES = ["every 37th masked", "exact ties across splits", "masked head and tail", "every row masked"]


def _merge_case(case):
    t, mask, q = _inputs(seed=8)
    if case == "exact ties across splits":  # the target twice: each point's twin in a later split
        half = M // 2
        t = np.concatenate([t[:half], t[:half]])
        mask = np.concatenate([mask[:half], mask[:half]])
        q = np.concatenate([q[:100], t[:50], t[::97]])  # queries on target points: d2 = 0, tied
    elif case == "masked head and tail":
        mask[:1000] = False
        mask[2500:] = False
    elif case == "every row masked":
        mask[:] = False
    return t, mask, q


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("case", MERGE_CASES)
def test_split_merge_model_equals_nn1_plain_and_the_tpu_study(studies, case, span):
    """The least packed word over the splits is nn1_plain bit for bit, the
    lower index on ties, idx 0 and d2 = +inf where no row is valid; and it
    agrees with the TPU study's make_nn1 as test_port_matches_tpu_study holds
    the other ports (the study's own all-masked traits apart)."""
    t, mask, q = _merge_case(case)
    tt, tm, tq = (torch.from_numpy(a) for a in (t, mask, q))
    got = cuda_knn.nn1_tiled_plain(cuda_knn.pack_target(tt, tm), tq, span)
    ref = cuda_knn.nn1_plain(tt, tm, tq)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    ji, jd = studies.tiles.make_nn1(1024, 512)(jnp.asarray(t), jnp.asarray(mask), jnp.asarray(q))
    ji, jd = torch.from_numpy(np.array(ji)), torch.from_numpy(np.array(jd))
    if case == "every row masked":
        assert bool((got[0] == 0).all()) and bool(torch.isinf(got[1]).all())
        assert bool((ji == 0).all()) and bool((jd == np.float32(BIG)).all())
        return
    assert cuda_knn.nn1_mismatches(got[0], got[1], ji, jd, TIE) == 0
    np.testing.assert_allclose(np_(got[1]), np_(jd), rtol=0, atol=D_ATOL)
    if case == "exact ties across splits":
        assert bool((got[0] < M // 2).all())  # the first of two equal points
        assert int((got[1] == 0).sum()) >= 50 + len(range(0, M // 2, 97))


def test_nn1_tiled_span_plan():
    # 1,000 queries against the pair's 24,576 rows: 96 splits of 256 rows
    # (the least span) at every query tile
    assert [cuda_knn.nn1_tiled_span(1000, 24576, qt, 132) for qt in cuda_knn.NN1_QUERY_TILES_STUDY] == [256] * 4
    # the study's shapes: as many splits as give 32 warps an SM (4,224 warps:
    # 12 splits of 352 one-warp tiles; 33 of 128; 33 of 16 eight-warp tiles)
    assert cuda_knn.nn1_tiled_span(22528, 22528, 64, 132) == 1878
    assert cuda_knn.nn1_tiled_span(8192, 131072, 64, 132) == 3972
    assert cuda_knn.nn1_tiled_span(8192, 22528, 512, 132) == 683
    for Q, Mt, qt in ((1, 1, 64), (70, 300, 512), (50000, 2049, 64)):
        span = cuda_knn.nn1_tiled_span(Q, Mt, qt, 132)
        assert 1 <= span <= Mt and -(-Mt // span) <= max(1, -(-Mt // cuda_knn.NN1_TILED_MIN_SPAN))


def test_nn1_tiled_refuses_instances_not_built_before_any_launch():
    t, mask, q = (torch.from_numpy(a) for a in _inputs(seed=9))
    before = dict(cuda_knn.launch_counts)
    for qt, tc in ((96, 2048), (32, 512), (1024, 512), (128, 256), (128, 8192), (128, 3000)):
        with pytest.raises(ValueError, match="nn1_tiled"):
            cuda_knn.nn1_tiled(t, mask, q, query_tile=qt, chunk=tc)
    packed = cuda_knn.pack_target(t, mask)
    assert packed.shape == (M, 4) and bool(torch.isinf(packed[~mask, :3]).all())
    with pytest.raises(ValueError):
        cuda_knn.nn1_tiled_prepped(packed[:, :3].contiguous(), q, 128, 2048)
    with pytest.raises(ValueError):
        cuda_knn.nn1_tiled_prepped(packed, q[:, :2].contiguous(), 128, 2048)
    assert cuda_knn.launch_counts == before


# -- nn1_bias / nn1_unroll2 in the ring: the plain models, the packing, the refusals


TPU_BIAS = {  # the TPU study's kernels on the loaded studies
    "v1": lambda s: s.variants.make_v1(1024, 2048),
    "v2": lambda s: s.variants.make_v2(512, 1024),
    "v3": lambda s: s.variants.make_v3(512, 1024),
}
BIAS_FORMS = {  # TPU kernel, the port's plain model, whether its wrapper rounds the span up to even
    "v1 / nn1_bias_plain": ("v1", cuda_knn.nn1_bias_plain, True),
    "v2 / nn1_lanes_plain 8": ("v2", functools.partial(cuda_knn.nn1_lanes_plain, lanes=8), False),
    "v2 / nn1_lanes_plain 32": ("v2", functools.partial(cuda_knn.nn1_lanes_plain, lanes=32), False),
    "v3 / nn1_unroll2_plain": ("v3", cuda_knn.nn1_unroll2_plain, True),
}
BIAS_CASES = MERGE_CASES + ["masked rows on the queries", "odd M"]
N_ON_QUERIES = 300


def _bias_case(case):
    if case in MERGE_CASES:
        return _merge_case(case)
    t, mask, q = _inputs(seed=10)
    if case == "masked rows on the queries":  # a masked row at d = 0 from each of the first queries
        t = np.concatenate([q[:N_ON_QUERIES], t])
        mask = np.concatenate([np.zeros(N_ON_QUERIES, bool), mask])
    else:  # "odd M": a masked pad row follows
        t, mask = t[:-1], mask[:-1]
    return t, mask, q


@pytest.fixture(scope="module")
def tpu_bias_forms(studies):
    """JAX's v1 / v2 / v3 on each case, run once: (kernel, case) -> (idx, d2)."""
    cache = {}

    def get(kernel, case):
        if (kernel, case) not in cache:
            t, mask, q = _bias_case(case)
            ji, jd = TPU_BIAS[kernel](studies)(jnp.asarray(t), jnp.asarray(mask), jnp.asarray(q))
            cache[kernel, case] = torch.from_numpy(np.array(ji)), torch.from_numpy(np.array(jd))
        return cache[kernel, case]

    return get


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("case", BIAS_CASES)
@pytest.mark.parametrize("form", sorted(BIAS_FORMS))
def test_bias_forms_plain_equal_nn1_plain_and_the_tpu_study(tpu_bias_forms, form, case, span):
    """The biased distance (v1), v2's lanes and the fold of adjacent rows
    (v3), split and merged at the span (rounded up to even for v1 / v3, as
    the wrappers' nn1_even_span does), are nn1_plain bit for bit: the lower
    index on ties, idx 0 and d2 = +inf where no row is valid, masked rows at
    d = 0 losing to far valid rows; and they agree with JAX's v1 / v2 / v3 as
    test_port_matches_tpu_study holds the other ports (the study's
    all-masked traits apart: v2 returns idx 2**31 - 1 there)."""
    kernel, plain, even = BIAS_FORMS[form]
    t, mask, q = _bias_case(case)
    tt, tm, tq = (torch.from_numpy(a) for a in (t, mask, q))
    packed = cuda_knn.pack_bias_target(tt, tm)
    got = plain(packed, tq, span + span % 2 if even else span)
    ref = cuda_knn.nn1_plain(tt, tm, tq)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    ji, jd = tpu_bias_forms(kernel, case)
    if case == "every row masked":
        assert bool((got[0] == 0).all()) and bool(torch.isinf(got[1]).all())
        assert bool((ji == ALL_MASKED[kernel][1]).all()) and bool((jd == np.float32(BIG)).all())
        return
    assert cuda_knn.nn1_mismatches(got[0], got[1], ji, jd, TIE) == 0
    np.testing.assert_allclose(np_(got[1]), np_(jd), rtol=0, atol=D_ATOL)
    if case == "exact ties across splits":
        assert bool((got[0] < M // 2).all())
    elif case == "masked rows on the queries":
        assert bool((got[0] >= N_ON_QUERIES).all()) and bool((got[1][:N_ON_QUERIES] > 0).all())


@pytest.mark.parametrize("span", [2, 8, 256, 3000, 6000])
@pytest.mark.parametrize("offset", [0, 1])
def test_ties_inside_a_pair(offset, span):
    """Every row doubled, so rows 2i and 2i + 1 are equal (offset 0: a tie
    inside each of v3's pairs) or, after one far row, 2i + 1 and 2i + 2
    (offset 1: twins in adjacent pairs): the lower index wins in both plain
    models, as in nn1_plain."""
    t, mask, q = _inputs(seed=11)
    t2 = np.concatenate([np.full((offset, 3), 1e4, np.float32), np.repeat(t[: M // 2], 2, axis=0)])
    m2 = np.concatenate([np.ones(offset, bool), np.repeat(mask[: M // 2], 2)])
    q2 = np.concatenate([t2[offset::14], q])  # queries on the points: d2 = 0, tied
    tt, tm, tq = (torch.from_numpy(a) for a in (t2, m2, q2))
    ref = cuda_knn.nn1_plain(tt, tm, tq)
    assert bool(((ref[0] - offset) % 2 == 0).all())  # the first of each equal pair
    packed = cuda_knn.pack_bias_target(tt, tm)
    for plain in (cuda_knn.nn1_bias_plain, cuda_knn.nn1_unroll2_plain):
        got = plain(packed, tq, span)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), plain.__name__


@pytest.mark.parametrize("n", [3000, 2999, 1, 0])
def test_pack_bias_target_layout_and_even_padding(n):
    """x, y, z, b a row: masked rows keep their coordinates, b is 0 / 3e38
    (float32), and an odd count gets one masked pad row (0, 0, 0, 3e38)."""
    t, mask, _ = _inputs(seed=12)
    tt, tm = torch.from_numpy(t[:n]), torch.from_numpy(mask[:n])
    for m in (tm, tm.to(torch.uint8)):
        packed = cuda_knn.pack_bias_target(tt, m)
        assert packed.shape == (n + n % 2, 4) and packed.dtype == torch.float32 and packed.is_contiguous()
        assert packed.data_ptr() % 16 == 0
        assert torch.equal(packed[:n, :3], tt)
        assert torch.equal(packed[:n, 3], torch.where(tm, 0.0, float(np.float32(BIG))))
        if n % 2:
            assert packed[n].tolist() == [0.0, 0.0, 0.0, float(np.float32(BIG))]
    with pytest.raises(ValueError):
        cuda_knn.pack_bias_target(tt[:, :2], tm)


@pytest.mark.parametrize("name", ["nn1_bias_prepped", "nn1_unroll2_prepped"])
def test_bias_forms_refuse_bad_targets_before_any_launch(name):
    """A packed target of the wrong shape (three columns, an odd row count, a
    batch axis), type or alignment (not on 16 bytes), an instance not built
    and queries of the wrong shape raise before any launch; so does an odd
    span in v3's plain model."""
    fn = getattr(cuda_knn, name)
    t, mask, q = (torch.from_numpy(a) for a in _inputs(seed=13))
    packed = cuda_knn.pack_bias_target(t, mask)
    buf = torch.empty(packed.numel() + 1)
    buf[1:] = packed.flatten()
    unaligned = buf[1:].view(M, 4)
    assert unaligned.data_ptr() % 16 and torch.equal(unaligned, packed)
    before = dict(cuda_knn.launch_counts)
    for bad in (packed[:, :3].contiguous(), packed[:-1], packed[None], packed.double()):
        with pytest.raises(ValueError, match="packed|pairs"):
            fn(bad, q)
    with pytest.raises(ValueError, match="16-byte"):
        fn(unaligned, q)
    for qt, tc in ((96, 1024), (128, 8192), (1024, 512)):
        with pytest.raises(ValueError, match=name.removesuffix("_prepped")):
            fn(packed, q, qt, tc)
    with pytest.raises(ValueError):
        fn(packed, q[:, :2].contiguous())
    with pytest.raises(ValueError, match="pairs"):
        cuda_knn.nn1_unroll2_plain(packed, q, 7)
    assert cuda_knn.launch_counts == before


def test_nn1_even_span_plan():
    """nn1_tiled_span rounded up to even: the pair's 256, the study's 1,878
    and 3,972 as they are; an odd plan one row longer."""
    for Q, Mt, qt in ((1000, 24576, 128), (22528, 22528, 64), (8192, 131072, 64), (50000, 2049, 64), (1, 1, 64),
                      (70, 301, 512)):
        span = cuda_knn.nn1_tiled_span(Q, Mt, qt, 132)
        assert cuda_knn.nn1_even_span(Q, Mt, qt, 132) == span + span % 2
    assert cuda_knn.nn1_even_span(1000, 24576, 128, 132) == 256
    assert cuda_knn.nn1_even_span(1, 1, 64, 132) == 2


# -- nn1_lanes: v2's lanes in the ring -----------------------------------------


@pytest.mark.parametrize("span", ["the twins' distance", 256, 6000])
@pytest.mark.parametrize("apart", [-1, 0, 1])
@pytest.mark.parametrize("lanes", cuda_knn.NN1_LANES)
def test_lanes_ties_across_lanes_and_splits(lanes, apart, span):
    """Twins ``lanes + apart`` rows apart (each block of 2 d rows holds d
    points twice): in one lane for ``apart`` = 0, in two lanes otherwise, and
    in two splits where the span is their distance. Queries on the valid
    points (d2 = 0, tied) and off them: the lower index wins, bit for bit
    nn1_plain."""
    d = lanes + apart
    t, mask, q = _inputs(seed=14)
    n = (M // 2) // d * d
    blocks = t[:n].reshape(-1, d, 3)
    t2 = np.concatenate([blocks, blocks], axis=1).reshape(-1, 3)
    m2 = np.concatenate([mask[:n].reshape(-1, d)] * 2, axis=1).reshape(-1)
    on = t2[::5][m2[::5]]  # valid points
    q2 = np.concatenate([on, q])
    tt, tm, tq = (torch.from_numpy(a) for a in (t2, m2, q2))
    ref = cuda_knn.nn1_plain(tt, tm, tq)
    on_points = on.shape[0]
    assert bool((ref[0][:on_points] % (2 * d) < d).all()) and bool((ref[1][:on_points] == 0).all())
    got = cuda_knn.nn1_lanes_plain(cuda_knn.pack_bias_target(tt, tm), tq, d if isinstance(span, str) else span,
                                   lanes)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_nn1_lanes_refuses_before_any_launch():
    """A packed target of the wrong shape (three columns, a batch axis), type
    or alignment, lanes not built, an instance not built and queries of the
    wrong shape raise before any launch; an odd row count is taken (v2 reads
    a row a step) and equals nn1_plain."""
    t, mask, q = (torch.from_numpy(a) for a in _inputs(seed=15))
    packed = cuda_knn.pack_bias_target(t, mask)
    buf = torch.empty(packed.numel() + 1)
    buf[1:] = packed.flatten()
    unaligned = buf[1:].view(M, 4)
    assert unaligned.data_ptr() % 16 and torch.equal(unaligned, packed)
    before = dict(cuda_knn.launch_counts)
    for lanes in cuda_knn.NN1_LANES:
        for bad in (packed[:, :3].contiguous(), packed[None], packed.double()):
            with pytest.raises(ValueError, match="packed"):
                cuda_knn.nn1_lanes_prepped(bad, q, lanes)
        with pytest.raises(ValueError, match="16-byte"):
            cuda_knn.nn1_lanes_prepped(unaligned, q, lanes)
        for qt, tc in ((96, 1024), (128, 8192), (1024, 512), (32, 512)):
            with pytest.raises(ValueError, match="nn1_lanes"):
                cuda_knn.nn1_lanes_prepped(packed, q, lanes, qt, tc)
        with pytest.raises(ValueError):
            cuda_knn.nn1_lanes_prepped(packed, q[:, :2].contiguous(), lanes)
    for lanes in (0, 4, 16):
        with pytest.raises(ValueError, match="lanes"):
            cuda_knn.nn1_lanes_prepped(packed, q, lanes)
    assert cuda_knn.launch_counts == before
    odd = torch.cat([packed, packed[:1]])
    ref = cuda_knn.nn1_plain(torch.cat([t, t[:1]]), torch.cat([mask, mask[:1]]), q)
    for lanes in cuda_knn.NN1_LANES:
        got = cuda_knn.nn1_lanes_prepped(odd, q, lanes)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_nn1_lanes_span_plan():
    """The split of a lane form counts the query blocks it launches, ceil(Q /
    (query_tile / lanes)): at the pair's shape 32 lanes take 9 spans of
    2,731 rows at every slot count (500 one-warp blocks of 2 queries to 63
    eight-warp blocks of 16), 8 lanes 34 spans of 723 (125 and 63 blocks) or
    33 of 745 (32 and 16 blocks), where one lane takes 96 of 256; lanes = 1 is
    nn1_tiled's plan."""
    qts = cuda_knn.NN1_QUERY_TILES_STUDY
    assert [cuda_knn.nn1_tiled_span(1000, 24576, qt, 132, 32) for qt in qts] == [2731] * 4
    assert [cuda_knn.nn1_tiled_span(1000, 24576, qt, 132, 8) for qt in qts] == [723, 723, 745, 745]
    for Q, Mt in ((1000, 24576), (22528, 22528), (8192, 131072), (1024, 6144), (1, 1), (70, 300), (50000, 2049)):
        for qt in qts:
            assert cuda_knn.nn1_tiled_span(Q, Mt, qt, 132, 1) == cuda_knn.nn1_tiled_span(Q, Mt, qt, 132)
            for lanes in cuda_knn.NN1_LANES:
                span = cuda_knn.nn1_tiled_span(Q, Mt, qt, 132, lanes)
                blocks = -(-Q // (qt // lanes))
                splits = -(-Mt // span)
                assert 1 <= span <= Mt and splits <= max(1, -(-Mt // cuda_knn.NN1_TILED_MIN_SPAN))
                # as many splits as give 32 warps an SM over the blocks, or the fewest above it
                want = -(-cuda_knn.NN1_TILED_WARPS_PER_SM * 132 // (qt // 64))
                assert splits == 1 or (splits - 1) * blocks < want or span <= cuda_knn.NN1_TILED_MIN_SPAN + 1
