"""The port's hash table and voxel hash map against the JAX package, on the CPU.

The same numpy inputs go to both packages. Tolerances:

  * ``hash_coords``, ``_pack2`` / ``_unpack2``: equal bit for bit (uint32
    values), negative and 21-bit-edge coordinates included;
  * ``compact_indices`` / ``compact_indices_ranked``: indices and masks equal
    on the valid entries, overflow counts equal;
  * ``resolve_slots`` / ``lookup_slots``: *which slot* a key lands in is left
    open by the JAX scatter (colliding claims have no specified winner), so
    the tables are compared as sets of keys, and every key must be found
    again where it was put;
  * the map (``add_point_cloud`` over 3 frames, ``grow``,
    ``remove_old_data``): compared as a set, sorted by packed voxel key: the
    used voxel coordinates, ``count`` and ``last_update`` exactly, the float
    sums with rtol=1e-5, atol=2e-5 (the two packages rotate the points and
    covariances with sums in another order, one ulp apart at 10 m, and
    ``index_add_`` sums in no fixed order), the scalars ``frame``,
    ``dropped``, ``budget_lost`` exactly;
  * ``extract``: the clouds as sets (rows sorted by position), points and
    covariances with rtol=1e-5, atol=2e-5, overflow counts equal;
  * ``compute_overlap_ratio``: atol=1e-6;
  * probe exhaustion at a capacity no larger than ``max_probes`` (every key
    then probes every slot, so the count does not depend on who wins a
    claim): ``dropped`` equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both, clouds, np_, rigid, spd

from sycl_points_tpu.mapping import hash_table as j_ht
from sycl_points_tpu.mapping import voxel_hash_map as j_vhm
from sycl_points_tpu_torch.convert import map_state_from_reference, params_from_reference
from sycl_points_tpu_torch.mapping import hash_table as t_ht
from sycl_points_tpu_torch.mapping import voxel_hash_map as t_vhm
from sycl_points_tpu_torch.utils import sync

RTOL, ATOL = 1e-5, 2e-5
EDGE = 2**21 - 1
SUMS = ("sum_pos", "sum_logcov", "sum_rgba", "sum_intensity")


def _coords(rng, n):
    c = rng.integers(-5, EDGE + 5, size=(n, 3)).astype(np.int32)
    c[:6] = [[0, 0, 0], [EDGE] * 3, [-1, -1, -1], [2**31 - 1] * 3, [2**20, 2**20 - 1, 2**20 + 1], [EDGE, 0, EDGE]]
    return c


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("capacity", [1 << 4, 1 << 10, 1 << 17])
def test_hash_coords_bit_for_bit(capacity):
    jc, tc = both(_coords(np.random.default_rng(0), 2000))
    (jh1, jh2), (th1, th2) = j_ht.hash_coords(jc, capacity), t_ht.hash_coords(tc, capacity)
    np.testing.assert_array_equal(_u32(jh1), np_(th1))
    np.testing.assert_array_equal(_u32(jh2), np_(th2))
    for probe in (0, 1, 31):
        np.testing.assert_array_equal(np.asarray(j_ht.probe_slots(jh1, jh2, probe, capacity)),
                                      np_(t_ht.probe_slots(th1, th2, probe, capacity)))


def test_pack_unpack_bit_for_bit():
    c = _coords(np.random.default_rng(1), 2000)
    jc, tc = both(c)
    (jhi, jlo), (thi, tlo) = j_ht._pack2(jc), t_ht._pack2(tc)
    np.testing.assert_array_equal(_u32(jhi), np_(thi))
    np.testing.assert_array_equal(_u32(jlo), np_(tlo))
    np.testing.assert_array_equal(np.asarray(j_ht._unpack2(jhi, jlo)), np_(t_ht._unpack2(thi, tlo)))
    in_range = ((c >= 0) & (c <= EDGE)).all(-1)
    np.testing.assert_array_equal(np_(t_ht._unpack2(thi, tlo))[in_range], c[in_range])


@pytest.mark.parametrize("n_keep,out_capacity", [(0, 16), (10, 16), (16, 16), (40, 16), (40, 64)])
def test_compact_indices(n_keep, out_capacity):
    rng = np.random.default_rng(n_keep)
    keep = np.zeros(64, bool)
    keep[rng.choice(64, n_keep, replace=False)] = True
    jk, tk = both(keep)
    ji, jm = j_ht.compact_indices(jk, out_capacity)
    ti, tm = t_ht.compact_indices(tk, out_capacity)
    np.testing.assert_array_equal(np.asarray(jm), np_(tm))
    np.testing.assert_array_equal(np.asarray(ji)[np.asarray(jm)], np_(ti)[np_(tm)])


@pytest.mark.parametrize("n_keep,out_capacity", [(10, 16), (40, 16), (64, 16), (40, 64), (40, 128)])
def test_compact_indices_ranked(n_keep, out_capacity):
    """Slot order when the kept slots fit, the smallest ranks when they
    overflow (40 or 64 kept into 16)."""
    rng = np.random.default_rng(100 + n_keep)
    keep = np.zeros(64, bool)
    keep[rng.choice(64, n_keep, replace=False)] = True
    rank = rng.permutation(64).astype(np.float32)
    (jk, tk), (jr, tr) = both(keep), both(rank)
    ji, jm, jo = j_ht.compact_indices_ranked(jk, jr, out_capacity)
    ti, tm, to = t_ht.compact_indices_ranked(tk, tr, out_capacity)
    assert int(jo) == int(to) == max(n_keep - out_capacity, 0)
    np.testing.assert_array_equal(np.asarray(jm), np_(tm))
    np.testing.assert_array_equal(np.asarray(ji)[np.asarray(jm)], np_(ti)[np_(tm)])


def _table_keys(coords, used):
    c = np_(coords)[np_(used)].astype(np.int64)
    return np.sort((c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2])


def _unique_keys(rng, n, lo=2**20 - 40, hi=2**20 + 40):
    c = rng.integers(lo, hi, size=(4 * n, 3)).astype(np.int32)
    return np.unique(c, axis=0)[rng.permutation(len(np.unique(c, axis=0)))][:n]


@pytest.mark.parametrize("capacity,n", [(1 << 10, 300), (1 << 9, 150), (1 << 5, 60)])
def test_resolve_and_lookup_slots(capacity, n):
    """Two batches into one table (the second half known, half new), then a
    lookup of known and unknown keys. At capacity 32 (= max_probes) the table
    fills and the rest is unresolved: as many on both sides, though not the
    same keys (who wins a contested slot is left open)."""
    rng = np.random.default_rng(capacity)
    keys = _unique_keys(rng, 2 * n)
    first, second, unknown = keys[:n], keys[n // 2: n + n // 2], keys[n + n // 2:]
    valid = np.ones(n, bool)
    valid[::7] = False
    jt = (jnp.full((capacity, 3), 2**31 - 1, jnp.int32), jnp.zeros(capacity, bool))
    tt = (torch.full((capacity, 3), 2**31 - 1, dtype=torch.int32), torch.zeros(capacity, dtype=torch.bool))
    for batch in (first, second):
        (jk, tk), (jv, tv) = both(batch), both(valid)
        jc, ju, js, jr = j_ht.resolve_slots(*jt, jk, jv, capacity, 32)
        tc, tu, ts, tr = t_ht.resolve_slots(*tt, tk, tv, capacity, 32)
        assert int(np.asarray(jr).sum()) == int(np_(tr).sum())
        assert not np_(tr)[~valid].any()
        if capacity > 32:
            np.testing.assert_array_equal(_table_keys(jc, ju), _table_keys(tc, tu))
        else:
            assert int(np_(tu).sum()) == int(np.asarray(ju).sum()) == 32
        # every resolved key sits in the slot it was given, and no two share one
        slots = np_(ts)[np_(tr)]
        assert len(np.unique(slots)) == len(slots)
        np.testing.assert_array_equal(np_(tc)[slots], batch[np_(tr)])
        assert np_(tu)[slots].all() and (np_(ts)[~np_(tr)] == -1).all()
        jt, tt = (jc, ju), (tc, tu)
        if capacity <= 32:
            break  # a second batch would find other keys there on each side
    probe = np.concatenate([first[:40], unknown[:20]])
    (jk, tk), (jv, tv) = both(probe), both(np.ones(len(probe), bool))
    jslot, jfound = j_ht.lookup_slots(*jt, jk, jv, capacity, 32)
    tslot, tfound = t_ht.lookup_slots(*tt, tk, tv, capacity, 32)
    if capacity > 32:
        np.testing.assert_array_equal(np.asarray(jfound), np_(tfound))
    np.testing.assert_array_equal(np_(tt[0])[np_(tslot)[np_(tfound)]], probe[np_(tfound)])
    assert (np_(tslot)[~np_(tfound)] == -1).all()
    if capacity > 32:
        assert not np_(tfound)[40:].any() and np_(tfound)[:40].sum() == valid[:40].sum()


def test_lookup_rounds_cost_one_host_read_for_two():
    """A warm map: every key is found in the first rounds, so resolve_slots
    reads the host twice (the lookup's exit test after two rounds, the claim
    loop's entry test) and changes nothing."""
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(_unique_keys(rng, 64))
    valid = torch.ones(64, dtype=torch.bool)
    cap = 1 << 12
    empty = (torch.full((cap, 3), 2**31 - 1, dtype=torch.int32), torch.zeros(cap, dtype=torch.bool))
    coords, used, slot, _ = t_ht.resolve_slots(*empty, keys, valid, cap, 32)
    sync.reset_sync_count()
    coords2, used2, slot2, resolved2 = t_ht.resolve_slots(coords, used, keys, valid, cap, 32)
    assert sync.counts["host_syncs"] <= 3
    assert torch.equal(coords, coords2) and torch.equal(used, used2) and torch.equal(slot, slot2)
    assert bool(resolved2.all())


# --------------------------------------------------------------------------
# the map
# --------------------------------------------------------------------------


def _as_set(state):
    """The used voxels' fields, sorted by packed voxel key."""
    used = np_(state.used)
    c = np_(state.coords)[used].astype(np.int64)
    order = np.argsort((c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2])
    return {f.name: np_(getattr(state, f.name))[used][order]
            for f in dataclasses.fields(t_vhm.VoxelHashMapState) if np_(getattr(state, f.name)).ndim > 0}


def _assert_same_map(js, ts):
    a, b = _as_set(js), _as_set(ts)
    for name in ("coords", "used", "count", "last_update"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    for name in SUMS:
        np.testing.assert_allclose(b[name], a[name], rtol=RTOL, atol=ATOL, err_msg=name)
    for name in ("frame", "dropped", "budget_lost"):
        assert int(getattr(js, name)) == int(getattr(ts, name)), name
    # empty slots carry nothing
    free = ~np_(ts.used)
    assert (np_(ts.coords)[free] == 2**31 - 1).all() and (np_(ts.count)[free] == 0).all()


def _frame(rng, n=700, cap=768, spread=6.0, far=0):
    pts = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    if far:
        pts[:far] *= 1e6  # beyond the sort key's extent, and the 21-bit range
    attrs = dict(covs=spd(rng, n, (0.05, 1.0)),
                 rgb=rng.uniform(0, 1, (n, 4)).astype(np.float32),
                 intensities=rng.uniform(0, 1, n).astype(np.float32))
    return clouds(pts, capacity=cap, **attrs), both(rigid(rng))


def _configs(**kw):
    jcfg = j_vhm.VoxelHashMapConfig(**kw)
    return jcfg, params_from_reference(jcfg)


@pytest.fixture(scope="module")
def filled():
    """Both packages' maps after the same 3 frames (the last with points
    beyond the budgets), checked after every insert."""
    rng = np.random.default_rng(11)
    jcfg, tcfg = _configs(voxel_size=0.5, capacity=1 << 12, max_staleness=1)
    js, ts = j_vhm.create(jcfg), t_vhm.create(tcfg, device="cpu")
    for f in range(3):
        (jc, tc), (jT, tT) = _frame(rng, far=5 if f == 2 else 0)
        js, ts = j_vhm.add_point_cloud(js, jcfg, jc, jT), t_vhm.add_point_cloud(ts, tcfg, tc, tT)
        _assert_same_map(js, ts)
    assert int(ts.budget_lost) == 5 and int(ts.dropped) == 0 and int(ts.frame) == 3
    return jcfg, tcfg, js, ts


def test_add_point_cloud_three_frames(filled):
    _, tcfg, js, ts = filled
    assert int(t_vhm.voxel_count(ts)) == int(j_vhm.voxel_count(js)) > 1500
    np.testing.assert_allclose(float(t_vhm.load_factor(ts, tcfg)), float(j_vhm.load_factor(js, filled[0])), atol=1e-7)


def test_add_point_cloud_leaves_its_input_state(filled):
    _, tcfg, _, ts = filled
    before = {f.name: getattr(ts, f.name).clone() for f in dataclasses.fields(ts)}
    (_, tc), (_, tT) = _frame(np.random.default_rng(3))
    t_vhm.add_point_cloud(ts, tcfg, tc, tT)
    for name, value in before.items():
        assert torch.equal(value, getattr(ts, name)), name


def test_grow(filled):
    jcfg, tcfg, js, ts = filled
    (jg, jcfg2), (tg, tcfg2) = j_vhm.grow(js, jcfg), t_vhm.grow(ts, tcfg)
    assert tcfg2.capacity == jcfg2.capacity == 2 * tcfg.capacity == tg.used.shape[0]
    _assert_same_map(jg, tg)
    _assert_same_map(js, tg)  # growing moves every voxel and changes none


def test_remove_old_data(filled):
    jcfg, tcfg, js, ts = filled
    jp, tp = j_vhm.remove_old_data(js, jcfg), t_vhm.remove_old_data(ts, tcfg)
    assert 0 < int(t_vhm.voxel_count(tp)) < int(t_vhm.voxel_count(ts))
    _assert_same_map(jp, tp)


def _sorted_cloud(cloud):
    pts, mask = np_(cloud.points)[np_(cloud.mask)], np_(cloud.mask)
    order = np.lexsort(pts.T)
    out = {"points": pts[order]}
    for name in ("covs", "rgb", "intensities"):
        if getattr(cloud, name) is not None:
            out[name] = np_(getattr(cloud, name))[mask][order]
    return out


def _assert_same_cloud(jc, tc):
    a, b = _sorted_cloud(jc), _sorted_cloud(tc)
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_allclose(b[name], a[name], rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("out_capacity,distance", [(4096, 100.0), (2048, 4.0), (256, 5.0)])
def test_extract(filled, out_capacity, distance):
    """In slot order when the in-range voxels fit, the nearest to the centre
    when they overflow (256)."""
    jcfg, tcfg, js, ts = filled
    center = np.array([0.5, -0.25, 0.1], np.float32)
    jcen, tcen = both(center)
    kw = dict(distance=distance, out_capacity=out_capacity, with_rgb=True, with_intensity=True, with_overflow=True)
    (jcl, jo), (tcl, to) = j_vhm.extract(js, jcfg, jcen, **kw), t_vhm.extract(ts, tcfg, tcen, **kw)
    assert int(jo) == int(to) and (int(to) > 0) == (out_capacity == 256)
    assert tcl.capacity == out_capacity and int(tcl.count()) == int(jcl.count()) > 0
    _assert_same_cloud(jcl, tcl)
    assert not isinstance(t_vhm.extract(ts, tcfg, tcen, distance, out_capacity), tuple)


def test_compute_overlap_ratio(filled):
    jcfg, tcfg, js, ts = filled
    rng = np.random.default_rng(4)
    for spread in (5.0, 12.0):
        (jc, tc), (jT, tT) = _frame(rng, spread=spread)
        jr, tr = j_vhm.compute_overlap_ratio(js, jcfg, jc, jT), t_vhm.compute_overlap_ratio(ts, tcfg, tc, tT)
        np.testing.assert_allclose(float(tr), float(jr), atol=1e-6)
    assert 0.0 < float(tr) < 1.0


def test_map_state_from_reference(filled):
    """Insert with the JAX package, carry the state across, extract and
    insert further with the port."""
    jcfg, tcfg, js, ts = filled
    carried = map_state_from_reference(js, device="cpu")
    for f in dataclasses.fields(carried):
        np.testing.assert_array_equal(np_(getattr(carried, f.name)), np.asarray(getattr(js, f.name)))
        assert getattr(carried, f.name).dtype == getattr(ts, f.name).dtype, f.name
    jcen, tcen = both(np.zeros(3, np.float32))
    jcl = j_vhm.extract(js, jcfg, jcen, 6.0, 4096)
    tcl = t_vhm.extract(carried, tcfg, tcen, 6.0, 4096)
    # the same table read by both: the same rows in the same order
    np.testing.assert_array_equal(np_(tcl.mask), np.asarray(jcl.mask))
    np.testing.assert_allclose(np_(tcl.points), np.asarray(jcl.points), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(tcl.covs)[np_(tcl.mask)], np.asarray(jcl.covs)[np_(tcl.mask)], rtol=RTOL, atol=ATOL)
    (jc, tc), (jT, tT) = _frame(np.random.default_rng(8))
    _assert_same_map(j_vhm.add_point_cloud(js, jcfg, jc, jT), t_vhm.add_point_cloud(carried, tcfg, tc, tT))


def test_probe_exhaustion_counts_dropped():
    """32 slots, 32 probes: every voxel probes every slot, the table fills and
    exactly the voxels beyond it are dropped."""
    rng = np.random.default_rng(21)
    jcfg, tcfg = _configs(voxel_size=0.5, capacity=32, max_probes=32)
    js, ts = j_vhm.create(jcfg), t_vhm.create(tcfg, device="cpu")
    for _ in range(2):
        (jc, tc), (jT, tT) = _frame(rng, n=200, cap=256)
        js, ts = j_vhm.add_point_cloud(js, jcfg, jc, jT), t_vhm.add_point_cloud(ts, tcfg, tc, tT)
        assert int(ts.dropped) == int(js.dropped) > 0
        assert int(t_vhm.voxel_count(ts)) == int(j_vhm.voxel_count(js)) == 32


def test_add_point_cloud_auto_grows_and_loses_nothing():
    rng = np.random.default_rng(22)
    jcfg, tcfg = _configs(voxel_size=0.5, capacity=64, max_probes=8)
    js, ts = j_vhm.create(jcfg), t_vhm.create(tcfg, device="cpu")
    for _ in range(2):
        (jc, tc), (jT, tT) = _frame(rng, n=300, cap=320)
        js, jcfg = j_vhm.add_point_cloud_auto(js, jcfg, jc, jT)
        ts, tcfg = t_vhm.add_point_cloud_auto(ts, tcfg, tc, tT)
    assert int(ts.dropped) == 0 and tcfg.capacity > 64 and ts.used.shape[0] == tcfg.capacity
    # the two may have grown a different number of times; the voxels agree
    a, b = _as_set(js), _as_set(ts)
    np.testing.assert_array_equal(a["coords"], b["coords"])
    np.testing.assert_array_equal(a["count"], b["count"])
    np.testing.assert_allclose(b["sum_pos"], a["sum_pos"], rtol=RTOL, atol=ATOL)
