"""The port's occupancy-grid map against the JAX package, on the CPU.

The same numpy inputs go to both packages. Tolerances:

  * the closed-form carve (``_ray_carve_keys``) on random rays from a seed
    and on the edge rays (axis-aligned, diagonal through voxel corners, zero
    length, longer than ``max_ray_distance``, origin on a voxel boundary):
    each ray's keys equal as a multiset, the origin row, the window and the
    counters (clamped, range-lost, truncated) exactly; the sorted DDA
    (``_dda_ray_coords``) equal in walk order, ties included;
  * the three miss merges: keys, counts and losses equal, to JAX's and to
    each other, in and out of the budget;
  * the map (``add_point_cloud`` over three frames into a 2^12 table, carve
    cycles 1 and 2): compared as a set, sorted by packed voxel key: voxel
    coordinates, hit counts and ``last_update`` exactly, log-odds atol 1e-6,
    position sums rtol 1e-5 / atol 2e-5, log-covariance sums rtol 5e-3 /
    atol 1e-3 (a planar neighbourhood's smallest eigenvalue, as in
    ``test_torch_hash_map.py``), the counters exactly;
  * pruning, ``grow`` and ``add_point_cloud_auto`` as sets; the tiered
    resolve against the plain one and against JAX's;
  * ``voxel_probability`` and ``compute_overlap_ratio`` atol 1e-6;
    ``extract_occupied_points`` (fitting, overflowing, with covariances) and
    ``extract_visible_points`` as sets of rows, atol 2e-5;
  * the nine cases of ``tests/test_occupancy_grid.py``, run on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both, clouds, np_, rigid, spd

from sycl_points_tpu.mapping import hash_table as j_ht
from sycl_points_tpu.mapping import occupancy_grid as j_og
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu_torch.convert import og_state_from_reference, params_from_reference
from sycl_points_tpu_torch.mapping import hash_table as t_ht
from sycl_points_tpu_torch.mapping import occupancy_grid as t_og
from sycl_points_tpu_torch.points.point_cloud import PointCloud as TCloud
from sycl_points_tpu_torch.utils import sync

from test_torch_hash_map import _sorted_cloud

SENT = 2**31 - 1
# The JAX inserts, jitted once per config and shape (eager, each costs seconds).
j_add = jax.jit(j_og.add_point_cloud, static_argnums=1)


def _configs(**kw):
    jcfg = j_og.OccupancyGridConfig(**kw)
    return jcfg, params_from_reference(jcfg)


# --------------------------------------------------------------------------
# the carve
# --------------------------------------------------------------------------


def _edge_rays():
    """Axis-aligned, diagonal (exact ties between axes), zero length, longer
    than max_ray_distance, backwards, a return on a voxel boundary."""
    t = np.array([
        [5.5, 0.5, 0.5], [0.5, -6.5, 0.5], [0.5, 0.5, 4.5], [5.5, 5.5, 5.5], [-3.5, 3.5, 0.5],
        [0.5, 0.5, 0.5], [30.0, 0.2, 0.2], [-0.5, -0.5, -0.5], [3.0, 2.0, 1.0], [7.25, -2.0, 4.0],
    ], np.float32)
    return t


@pytest.mark.parametrize("case", ["random", "edges", "boundary-origin", "step-limit"])
def test_carve_keys(case):
    rng = np.random.default_rng(7)
    voxel, axis_budget, max_len, step_limit = 0.5, 24, 10.0, 0
    if case == "random":
        origin = rng.uniform(-3, 3, 3).astype(np.float32)
        targets = rng.uniform(-12, 12, (200, 3)).astype(np.float32)
    elif case == "step-limit":
        origin = rng.uniform(-3, 3, 3).astype(np.float32)
        targets = rng.uniform(-12, 12, (200, 3)).astype(np.float32)
        step_limit = 15
    else:
        voxel, axis_budget, max_len = 1.0, 12, 10.0
        origin = np.array([0.5, 0.5, 0.5] if case == "edges" else [1.0, 2.0, 0.0], np.float32)
        targets = _edge_rays()
    valid = np.ones(len(targets), bool)
    valid[3::17] = False
    (jo, to), (jt, tt), (jv, tv) = both(origin), both(targets), both(valid)
    j = j_og._ray_carve_keys(jo, jt, jv, voxel, axis_budget, max_len, step_limit=step_limit)
    t = t_og._ray_carve_keys(to, tt, tv, voxel, axis_budget, max_len, step_limit=step_limit)
    jk, tk = np_(j[0]), np_(t[0])
    assert tk.dtype == np.int32
    np.testing.assert_array_equal(np.sort(tk, axis=1), np.sort(jk, axis=1))
    for a, b in zip(j[1:4], t[1:4]):
        np.testing.assert_array_equal(np_(b), np_(a))
    assert t[4] == j[4]
    assert [int(x) for x in t[5:]] == [int(x) for x in j[5:]]
    assert (tk != SENT).sum() > 30
    if case == "step-limit":
        assert int(t[7]) > 0
    if case == "random":
        assert int(t[5]) > 0  # some rays clamped


@pytest.mark.parametrize("case", ["random", "edges"])
def test_dda_ray_coords(case):
    rng = np.random.default_rng(8)
    if case == "random":
        origin = rng.uniform(-3, 3, 3).astype(np.float32)
        targets, voxel, S = rng.uniform(-8, 8, (64, 3)).astype(np.float32), 0.5, 30
    else:
        origin, targets, voxel, S = np.array([0.5, 0.5, 0.5], np.float32), _edge_rays(), 1.0, 40
    valid = np.ones(len(targets), bool)
    valid[5] = False
    j = j_og._dda_ray_coords(jnp.asarray(origin), jnp.asarray(targets), jnp.asarray(valid), voxel, S)
    t = t_og._dda_ray_coords(torch.from_numpy(origin), torch.from_numpy(targets), torch.from_numpy(valid), voxel, S)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np_(b), np_(a))
    assert np_(t[4]).any() == (case == "random")  # rays longer than S crossings are truncated


def _carve_set(t, B):
    keys, base = np_(t[0]).reshape(-1), np_(t[3])
    keys = keys[keys != SENT].astype(np.int64)
    return {(int(k // (B * B) + base[0]), int(k // B % B + base[1]), int(k % B + base[2])) for k in keys}


def test_carve_matches_the_sorted_dda():
    """The closed-form carve and the sorted DDA visit the same voxels (the
    port's own pair, as ``tests/test_round3_fixes.py`` pins JAX's)."""
    rng = np.random.default_rng(7)
    origin = torch.from_numpy(rng.uniform(-3, 3, 3).astype(np.float32))
    targets = torch.from_numpy(rng.uniform(-20, 20, (64, 3)).astype(np.float32))
    valid = torch.ones(64, dtype=torch.bool)
    cfg = t_og.OccupancyGridConfig(voxel_size=0.5, max_ray_distance=50.0)
    c, emit, *_ = t_og._dda_ray_coords(origin, targets, valid, 0.5, cfg.ray_step_budget)
    legacy = {tuple(int(v) for v in row) for row in np_(c)[np_(emit)]}
    carve = t_og._ray_carve_keys(origin, targets, valid, 0.5, cfg.ray_axis_budget, 50.0)
    assert _carve_set(carve, carve[4]) == legacy and len(legacy) > 1000


def test_ray_axis_budget_error():
    with pytest.raises(ValueError, match="int32 packed-key budget"):
        _ = t_og.OccupancyGridConfig(voxel_size=0.05, max_ray_distance=50.0).ray_axis_budget
    assert t_og.OccupancyGridConfig(voxel_size=0.05, max_ray_distance=50.0, max_ray_steps=100).ray_axis_budget == 101
    for kw in ({}, {"voxel_size": 0.25}, {"max_ray_steps": 7}, {"miss_budget": 8, "capacity": 1 << 10}):
        jcfg, tcfg = _configs(**kw)
        assert (tcfg.ray_step_budget, tcfg.ray_axis_budget, tcfg.miss_merge_budget) == \
            (jcfg.ray_step_budget, jcfg.ray_axis_budget, jcfg.miss_merge_budget)


# --------------------------------------------------------------------------
# the three miss merges
# --------------------------------------------------------------------------

MERGES = {"rle": t_og._merge_miss_keys_rle, "sort": t_og._merge_miss_keys_sort,
          "dense": t_og._merge_miss_keys_dense}


def _merge_inputs():
    rng = np.random.default_rng(11)
    B = 23
    keys = rng.integers(0, B**3, size=4096).astype(np.int32)
    keys[rng.random(4096) < 0.6] = SENT
    out = [(keys, B, 4096), (keys, B, 64), (np.full(256, SENT, np.int32), B, 32)]
    B2 = 40
    vocab = rng.choice(B2**3, size=20000, replace=False).astype(np.int32)
    keys2 = vocab[rng.integers(0, 20000, size=65536)]
    keys2[rng.random(65536) < 0.3] = SENT
    out.append((keys2, B2, 1 << 15))
    return out


@pytest.mark.parametrize("impl", list(MERGES))
@pytest.mark.parametrize("which", range(4))
def test_miss_merges(impl, which):
    keys, B, cap = _merge_inputs()[which]
    base = np.array([100, 200, 300], np.int32)
    jk, jc, jl = j_og._merge_miss_keys_rle(jnp.asarray(keys), cap, B, jnp.asarray(base))
    tk, tc, tl = MERGES[impl](torch.from_numpy(keys), cap, B, torch.from_numpy(base))
    np.testing.assert_array_equal(np_(tk), np_(jk))
    np.testing.assert_array_equal(np_(tc), np_(jc))
    assert int(tl) == int(jl)
    assert tk.dtype == torch.int32 and tc.shape == (cap,)
    if which == 1:
        assert int(tl) > 0  # the budget overflowed


# --------------------------------------------------------------------------
# the map
# --------------------------------------------------------------------------


def _as_set(state):
    """The used voxels' fields, sorted by packed voxel key."""
    used = np_(state.used)
    c = np_(state.coords)[used].astype(np.int64)
    order = np.argsort((c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2])
    return {f.name: np_(getattr(state, f.name))[used][order]
            for f in dataclasses.fields(t_og.OccupancyGridState) if np_(getattr(state, f.name)).ndim > 0}


SCALARS = ("frame", "dropped", "truncated_rays", "budget_lost", "clamped_rays")


def _assert_same_map(js, ts):
    a, b = _as_set(js), _as_set(ts)
    for name in ("coords", "used", "hit_count", "last_update"):
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    np.testing.assert_allclose(b["log_odds"], a["log_odds"], rtol=0, atol=1e-6)
    for name in ("sum_pos", "sum_rgba", "sum_intensity"):
        np.testing.assert_allclose(b[name], a[name], rtol=1e-5, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(b["sum_logcov"], a["sum_logcov"], rtol=5e-3, atol=1e-3)
    for name in SCALARS:
        assert int(getattr(js, name)) == int(getattr(ts, name)), name
    free = ~np_(ts.used)
    assert (np_(ts.coords)[free] == SENT).all() and (np_(ts.log_odds)[free] == 0).all()


def _frame(rng, n=400, cap=512, radius=6.0):
    """``n`` points within ``radius`` of the sensor (some beyond the 5 m
    carve clamp), with covariances, colours and intensities, and a pose."""
    d = rng.normal(size=(n, 3))
    pts = (d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(1.0, radius, (n, 1))).astype(np.float32)
    attrs = dict(covs=spd(rng, n, (0.05, 1.0)), rgb=rng.uniform(0, 1, (n, 4)).astype(np.float32),
                 intensities=rng.uniform(0, 1, n).astype(np.float32))
    return clouds(pts, capacity=cap, **attrs), both(rigid(rng, trans_scale=1.0))


MAP_KW = dict(voxel_size=1.0, capacity=1 << 12, max_ray_distance=5.0)


@pytest.fixture(scope="module", params=[1, 2], ids=["cycle1", "cycle2"])
def filled(request):
    """Both packages' maps after the same 3 frames, checked after each."""
    rng = np.random.default_rng(21)
    jcfg, tcfg = _configs(free_space_update_cycle=request.param, **MAP_KW)
    js, ts = j_og.create(jcfg), t_og.create(tcfg, device="cpu")
    for _ in range(3):
        (jc, tc), (jT, tT) = _frame(rng)
        js, ts = j_add(js, jcfg, jc, jT), t_og.add_point_cloud(ts, tcfg, tc, tT)
        _assert_same_map(js, ts)
    return jcfg, tcfg, js, ts


def test_add_point_cloud_three_frames(filled):
    jcfg, tcfg, js, ts = filled
    n = int(t_og.voxel_count(ts))
    assert n == int(j_og.voxel_count(js)) and 400 < n < 0.7 * tcfg.capacity
    assert int(ts.clamped_rays) > 0 and int(ts.dropped) == 0 and int(ts.frame) == 3
    lo = np_(ts.log_odds)[np_(ts.used)]
    assert (lo < 0).any() and (lo > 0).any()  # carved and hit voxels
    np.testing.assert_allclose(float(t_og.load_factor(ts, tcfg)), float(j_og.load_factor(js, jcfg)), atol=1e-7)


def test_add_point_cloud_leaves_its_input_state(filled):
    _, tcfg, _, ts = filled
    before = {f.name: getattr(ts, f.name).clone() for f in dataclasses.fields(ts)}
    (_, tc), (_, tT) = _frame(np.random.default_rng(3))
    t_og.add_point_cloud(ts, tcfg, tc, tT)
    for name, value in before.items():
        assert torch.equal(value, getattr(ts, name)), name


def test_carve_cycle_host_read(filled):
    """An insert off the carve cycle skips the carve for one counted host
    read of the frame counter; cycle 1 reads nothing for it."""
    _, tcfg, _, ts = filled  # after 3 inserts: frame 3 is off a cycle of 2
    (_, tc), (_, tT) = _frame(np.random.default_rng(4))

    def syncs(**kw):
        before = sync.counts["host_syncs"]
        t_og.add_point_cloud(ts, dataclasses.replace(tcfg, **kw), tc, tT)
        return sync.counts["host_syncs"] - before

    no_carve = syncs(free_space_updates_enabled=False)
    assert syncs(free_space_update_cycle=2) == no_carve + 1
    assert syncs(free_space_update_cycle=3) > no_carve + 1  # frame 3 is on a cycle of 3


def test_prune_stale_voxels(filled):
    jcfg, tcfg, js, ts = filled
    jcfg, tcfg = (dataclasses.replace(c, stale_frame_threshold=1) for c in (jcfg, tcfg))
    jp, tp = j_og.prune_stale_voxels(js, jcfg), t_og.prune_stale_voxels(ts, tcfg)
    assert 0 < int(t_og.voxel_count(tp)) < int(t_og.voxel_count(ts))
    _assert_same_map(jp, tp)


def test_grow(filled):
    jcfg, tcfg, js, ts = filled
    (jg, jcfg2), (tg, tcfg2) = j_og.grow(js, jcfg), t_og.grow(ts, tcfg)
    assert tcfg2.capacity == jcfg2.capacity == 2 * tcfg.capacity == tg.used.shape[0]
    _assert_same_map(jg, tg)
    _assert_same_map(js, tg)  # growing moves every voxel and changes none


def test_og_state_from_reference(filled):
    """The JAX map carried over: equal as a set, and an insert into it on
    both sides stays equal."""
    jcfg, tcfg, js, _ = filled
    ts = og_state_from_reference(js, device="cpu")
    _assert_same_map(js, ts)
    np.testing.assert_array_equal(np_(ts.coords), np_(js.coords))  # slots keep their places
    (jc, tc), (jT, tT) = _frame(np.random.default_rng(5))
    _assert_same_map(j_add(js, jcfg, jc, jT), t_og.add_point_cloud(ts, tcfg, tc, tT))


def test_voxel_probability_and_overlap(filled):
    jcfg, tcfg, js, ts = filled
    rng = np.random.default_rng(6)
    for p in rng.uniform(-6, 6, (12, 3)).astype(np.float32):
        jp, tp = both(p)
        np.testing.assert_allclose(float(t_og.voxel_probability(ts, tcfg, tp)),
                                   float(j_og.voxel_probability(js, jcfg, jp)), atol=1e-6)
    (jc, tc), (jT, tT) = _frame(np.random.default_rng(21))  # the first frame again
    r = float(t_og.compute_overlap_ratio(ts, tcfg, tc, tT))
    np.testing.assert_allclose(r, float(j_og.compute_overlap_ratio(js, jcfg, jc, jT)), atol=1e-6)
    assert r > 0.3


@pytest.mark.parametrize("out_capacity,with_covs", [(4096, False), (64, False), (4096, True)],
                         ids=["fits", "overflow", "with-covs"])
def test_extract_occupied_points(filled, out_capacity, with_covs):
    jcfg, tcfg, js, ts = filled
    centre = np.array([0.5, -0.3, 0.2], np.float32)
    kw = dict(max_distance=4.0, out_capacity=out_capacity, with_covs=with_covs, with_rgb=True,
              with_intensity=True, with_overflow=True)
    jo, jn = j_og.extract_occupied_points(js, jcfg, jnp.asarray(centre), **kw)
    to, tn = t_og.extract_occupied_points(ts, tcfg, torch.from_numpy(centre), **kw)
    assert int(tn) == int(jn) and (int(tn) > 0) == (out_capacity == 64)
    a, b = _sorted_cloud(jo), _sorted_cloud(to)
    assert sorted(a) == sorted(b) and len(b["points"]) == int(to.count()) > 20
    for name in a:
        np.testing.assert_allclose(b[name], a[name], rtol=1e-4 if name == "covs" else 1e-5, atol=2e-5,
                                   err_msg=name)


def test_extract_visible_points(filled):
    jcfg, tcfg, js, ts = filled
    (jT, tT) = both(rigid(np.random.default_rng(9), trans_scale=0.5))
    kw = dict(max_distance=8.0, horizontal_fov=2.0, vertical_fov=1.5, out_capacity=512)
    jo = j_og.extract_visible_points(js, jcfg, jT, **kw)
    to = t_og.extract_visible_points(ts, tcfg, tT, **kw)
    a, b = _sorted_cloud(jo), _sorted_cloud(to)
    np.testing.assert_allclose(b["points"], a["points"], atol=2e-5)
    assert 0 < len(b["points"]) < int(t_og.voxel_count(ts))


# --------------------------------------------------------------------------
# growth and the tiered resolve
# --------------------------------------------------------------------------


def test_add_point_cloud_auto_grows_without_loss():
    """From 2^8 slots, the growth policy ends with every voxel: the map that
    JAX builds in a table large enough from the start."""
    rng = np.random.default_rng(31)
    frames = [_frame(rng) for _ in range(2)]
    tcfg = params_from_reference(j_og.OccupancyGridConfig(voxel_size=1.0, capacity=1 << 8, max_ray_distance=5.0))
    ts = t_og.create(tcfg, device="cpu")
    for (_, tc), (_, tT) in frames:
        ts, tcfg = t_og.add_point_cloud_auto(ts, tcfg, tc, tT)
    assert tcfg.capacity >= 1 << 10 and int(ts.dropped) == 0 and t_og.load_factor(ts, tcfg) <= 0.7 + 1e-6
    jcfg = j_og.OccupancyGridConfig(voxel_size=1.0, capacity=tcfg.capacity, max_ray_distance=5.0)
    js = j_og.create(jcfg)
    for (jc, _), (jT, _) in frames:
        js = j_add(js, jcfg, jc, jT)
    _assert_same_map(js, ts)


@pytest.mark.parametrize("n_valid", [40, 150], ids=["empty-tail", "tail"])
def test_resolve_slots_tiered(n_valid):
    """Valid keys first: the tiered resolve gives the plain resolve's table
    and JAX's resolved flags, and an empty tail costs no host read."""
    rng = np.random.default_rng(41)
    keys = np.unique(rng.integers(1 << 20, (1 << 20) + 40, (400, 3)).astype(np.int32), axis=0)[:200]
    valid = np.arange(200) < n_valid
    cap, probes, tier = 1 << 9, 32, 64
    coords0 = np.full((cap, 3), SENT, np.int32)
    used0 = np.zeros(cap, bool)
    jk, tk = both(keys)
    jv, tv = both(valid)
    j = j_ht.resolve_slots_tiered(jnp.asarray(coords0), jnp.asarray(used0), jk, jv, cap, probes, tier=tier)
    before = sync.counts["host_syncs"]
    t = t_ht.resolve_slots_tiered(torch.from_numpy(coords0), torch.from_numpy(used0), tk, tv, cap, probes, tier=tier)
    tiered_syncs = sync.counts["host_syncs"] - before
    before = sync.counts["host_syncs"]
    p = t_ht.resolve_slots(torch.from_numpy(coords0), torch.from_numpy(used0), tk, tv, cap, probes)
    np.testing.assert_array_equal(np_(t[3]), np_(j[3]))
    np.testing.assert_array_equal(np_(t[3]), valid)
    assert torch.equal(t[1], p[1]) and torch.equal(t[0], p[0])
    slots = np_(t[2])
    np.testing.assert_array_equal(np_(t[0])[slots[valid]], keys[valid])
    assert (slots[~valid] == -1).all()
    if n_valid < tier:  # the front alone: the tail test rode along
        before = sync.counts["host_syncs"]
        t_ht.resolve_slots(torch.from_numpy(coords0), torch.from_numpy(used0), tk[:tier], tv[:tier], cap, probes)
        assert tiered_syncs == sync.counts["host_syncs"] - before


# --------------------------------------------------------------------------
# the JAX package's own cases (tests/test_occupancy_grid.py), on both sides
# --------------------------------------------------------------------------


class _Side:
    """What a case needs of one package."""

    def __init__(self, jax_side: bool):
        self.og = j_og if jax_side else t_og
        self.add = j_add if jax_side else t_og.add_point_cloud
        self.jax = jax_side

    def cloud(self, pts):
        pts = np.asarray(pts, np.float32)
        return JCloud.from_numpy(pts) if self.jax else TCloud.from_numpy(pts, device="cpu")

    def arr(self, x):
        x = np.asarray(x, np.float32)
        return jnp.asarray(x) if self.jax else torch.from_numpy(x)

    def create(self, cfg):
        return self.og.create(cfg) if self.jax else self.og.create(params_from_reference(cfg), device="cpu")

    def cfg(self, cfg):
        return cfg if self.jax else params_from_reference(cfg)


CFG = j_og.OccupancyGridConfig(voxel_size=1.0, capacity=1 << 12, max_ray_steps=64)
EYE = np.eye(4, dtype=np.float32)


def _case_hit(s):
    st = s.add(s.create(CFG), s.cfg(CFG), s.cloud([[5.5, 0.5, 0.5]]), s.arr(EYE))
    assert float(s.og.voxel_probability(st, s.cfg(CFG), s.arr([5.5, 0.5, 0.5]))) > 0.6
    assert abs(float(s.og.voxel_probability(st, s.cfg(CFG), s.arr([50.0, 50.0, 50.0]))) - 0.5) < 1e-6


def _case_carve(s):
    st = s.create(CFG)
    for _ in range(5):
        st = s.add(st, s.cfg(CFG), s.cloud([[5.5, 0.5, 0.5]]), s.arr(EYE))
    assert float(s.og.voxel_probability(st, s.cfg(CFG), s.arr([5.5, 0.5, 0.5]))) > 0.9
    assert float(s.og.voxel_probability(st, s.cfg(CFG), s.arr([2.5, 0.5, 0.5]))) < 0.2


def _case_clamp(s):
    st = s.create(CFG)
    for _ in range(30):
        st = s.add(st, s.cfg(CFG), s.cloud([[5.5, 0.5, 0.5]]), s.arr(EYE))
    lo = np_(st.log_odds)
    assert lo.max() <= CFG.max_log_odds + 1e-5 and lo.min() >= CFG.min_log_odds - 1e-5


def _case_extract(s):
    st = s.create(CFG)
    for _ in range(3):
        st = s.add(st, s.cfg(CFG), s.cloud([[5.5, 0.5, 0.5], [0.5, 7.5, 0.5]]), s.arr(EYE))
    got = s.og.extract_occupied_points(st, s.cfg(CFG), s.arr(np.zeros(3)), 100.0, out_capacity=64).to_numpy()["points"]
    got = got[np.argsort(got[:, 0])]
    assert got.shape[0] == 2
    np.testing.assert_allclose(got, [[0.5, 7.5, 0.5], [5.5, 0.5, 0.5]], atol=1e-5)


def _case_range(s):
    st = s.add(s.create(CFG), s.cfg(CFG), s.cloud([[5.5, 0.5, 0.5], [60.5, 0.5, 0.5]]), s.arr(EYE))
    assert int(s.og.extract_occupied_points(st, s.cfg(CFG), s.arr(np.zeros(3)), 20.0, out_capacity=64).count()) == 1


def _case_miss_only(s):
    st = s.add(s.create(CFG), s.cfg(CFG), s.cloud([[9.5, 0.5, 0.5]]), s.arr(EYE))
    assert int(s.og.extract_occupied_points(st, s.cfg(CFG), s.arr(np.zeros(3)), 100.0, out_capacity=64).count()) == 1


def _case_overlap(s):
    cfg = j_og.OccupancyGridConfig(voxel_size=1.0, capacity=1 << 12, free_space_updates_enabled=False)
    st = s.create(cfg)
    pts = np.random.default_rng(1).uniform(2, 8, size=(100, 3)).astype(np.float32)
    for _ in range(2):
        st = s.add(st, s.cfg(cfg), s.cloud(pts), s.arr(EYE))
    assert float(s.og.compute_overlap_ratio(st, s.cfg(cfg), s.cloud(pts), s.arr(EYE))) > 0.9
    assert float(s.og.compute_overlap_ratio(st, s.cfg(cfg), s.cloud(pts + 100), s.arr(EYE))) < 0.05


def _case_stale(s):
    cfg = j_og.OccupancyGridConfig(voxel_size=1.0, capacity=1 << 12, stale_frame_threshold=2,
                                   free_space_updates_enabled=False)
    st = s.add(s.create(cfg), s.cfg(cfg), s.cloud([[5.5, 0.5, 0.5]]), s.arr(EYE))
    for _ in range(5):
        st = s.add(st, s.cfg(cfg), s.cloud([[0.5, 5.5, 0.5]]), s.arr(EYE))
    assert int(s.og.voxel_count(st)) == 1


def _case_visible(s):
    cfg = j_og.OccupancyGridConfig(voxel_size=1.0, capacity=1 << 12, free_space_updates_enabled=False,
                                   max_ray_steps=64)
    st = s.create(CFG)
    for _ in range(3):
        st = s.add(st, s.cfg(cfg), s.cloud([[5.5, 0.5, 0.5], [9.5, 0.5, 0.5]]), s.arr(EYE))
    out = s.og.extract_visible_points(st, s.cfg(cfg), s.arr(EYE), max_distance=50.0, horizontal_fov=np.pi * 0.9,
                                      vertical_fov=np.pi * 0.9, out_capacity=32)
    pts = out.to_numpy()["points"]
    assert pts.shape[0] == 1
    np.testing.assert_allclose(pts[0], [5.5, 0.5, 0.5], atol=1e-5)


CASES = {"hit": _case_hit, "carve": _case_carve, "clamp": _case_clamp, "extract": _case_extract,
         "range": _case_range, "miss-only": _case_miss_only, "overlap": _case_overlap, "stale": _case_stale,
         "visible": _case_visible}


@pytest.mark.parametrize("side", ["jax", "torch"])
@pytest.mark.parametrize("case", list(CASES))
def test_reference_cases(case, side):
    CASES[case](_Side(side == "jax"))
