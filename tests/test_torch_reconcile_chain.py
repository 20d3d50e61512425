"""The pipelined frames' drop-retry reconcile, ``Submap.reconcile_chain``,
against the port's sequential ``retry_insert_after_drop`` and against the
JAX package's chain, on both map backends, on the CPU.

The setup of ``tests/test_pipelined_odometry.py::test_reconcile_chain_matches_sequential_retry``:
a 128-slot table and three inserts of 600 uniform points each, so that probes
run out and the retry grows the table; the points lie within 40 m on the
voxel-hash map and within 4 m on the occupancy grid (whose rays carve every
voxel on their way: 40 m rays grow the table to 2^16 slots, minutes on a
CPU). Tolerances:

  * chain against the sequential retry (the same package): nothing dropped
    on either side, equal ``budget_lost``, the table grown, every point
    counted, the target set;
  * the port's chain against the JAX chain on the same numpy clouds, the
    ``frame`` counters equal;
  * in both, the maps equal as sets: hit counts exactly, summed positions
    rtol 1e-5 / atol 1e-4 (sums of the same points, perhaps in another
    order), log-odds to 1e-5;
  * a window padded past its real inserts advances ``frame`` once a real
    insert, an all-padding window leaves the state as it was, and a frame
    that inserted nothing (a ``None`` stash) takes a padding slot.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import np_

from sycl_points_tpu.pipeline.submap import Submap as JSubmap
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.pipeline.submap import Submap as TSubmap
from sycl_points_tpu_torch.points.point_cloud import PointCloud as TCloud

from test_torch_lo_frame import small_params

BACKENDS = ["VOXEL_HASH_MAP", "OCCUPANCY_GRID_MAP"]
EXTENT_M = {"VOXEL_HASH_MAP": 40.0, "OCCUPANCY_GRID_MAP": 4.0}
N_INSERTS, N_POINTS = 3, 600


def _params(map_type):
    p = small_params(map_capacity=128)
    return dataclasses.replace(p, submap=dataclasses.replace(p.submap, map_type=map_type))


def _inputs(map_type="VOXEL_HASH_MAP"):
    rng = np.random.default_rng(99)
    ext = EXTENT_M[map_type]
    pts, poses = [], []
    for i in range(N_INSERTS):
        # hundreds of distinct voxels an insert: probes run out at 128 slots
        pts.append(rng.uniform(-ext, ext, size=(N_POINTS, 3)).astype(np.float32))
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.5 * i
        poses.append(T)
    return pts, poses


def _contents(state):
    """The used slots as a set: ``{voxel: (hits, summed position, log-odds)}``
    (log-odds 0 on the voxel-hash map, which has none)."""
    used = np_(state.used)
    hits = np_(state.count if hasattr(state, "count") else state.hit_count)[used]
    log_odds = np_(state.log_odds)[used] if hasattr(state, "log_odds") else np.zeros_like(hits)
    return dict(zip(map(tuple, np_(state.coords)[used]), zip(hits, np_(state.sum_pos)[used], log_odds)))


def _assert_same_contents(a, b):
    assert a.keys() == b.keys()
    keys = list(a)
    np.testing.assert_array_equal([b[v][0] for v in keys], [a[v][0] for v in keys])
    np.testing.assert_allclose([b[v][1] for v in keys], [a[v][1] for v in keys], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose([b[v][2] for v in keys], [a[v][2] for v in keys], atol=1e-5)


def _port_submaps(map_type):
    p = params_from_reference(_params(map_type))
    return TSubmap(p, device="cpu"), TSubmap(p, device="cpu")


@pytest.mark.parametrize("map_type", BACKENDS)
def test_chain_matches_the_sequential_retry(map_type):
    pts, poses = _inputs(map_type)
    clouds = [TCloud.from_numpy(x, capacity=1024, device="cpu") for x in pts]
    seq, chain = _port_submaps(map_type)
    seq.retry_insert_after_drop(clouds[0], poses[0])
    for c, T in zip(clouds[1:], poses[1:]):
        seq.retry_insert_after_drop(c, T, grow_first=False)
    chain.reconcile_chain(clouds, [torch.from_numpy(T) for T in poses], window=6)

    for sm in (seq, chain):
        assert int(sm.map_state.dropped) == 0
        hits = sm.map_state.count if not sm.is_occupancy else sm.map_state.hit_count
        assert float(hits.sum()) == N_INSERTS * N_POINTS
    assert int(chain.map_state.budget_lost) == int(seq.map_state.budget_lost)
    assert chain.map_capacity >= 512  # the table grew
    _assert_same_contents(_contents(seq.map_state), _contents(chain.map_state))
    # the chain set the target as the sequential path does
    assert chain.submap_cloud is not None and int(chain.submap_cloud.count()) > 0
    assert chain.submap_knn.target is not None


@pytest.mark.parametrize("map_type", BACKENDS)
def test_chain_matches_jax(map_type):
    pts, poses = _inputs(map_type)
    jsm = JSubmap(_params(map_type))
    jsm.reconcile_chain([JCloud.from_numpy(x, capacity=1024) for x in pts], poses, window=6)
    _, tsm = _port_submaps(map_type)
    tsm.reconcile_chain([TCloud.from_numpy(x, capacity=1024, device="cpu") for x in pts], poses, window=6)

    assert int(tsm.map_state.dropped) == int(jsm.map_state.dropped) == 0
    assert int(tsm.map_state.frame) == int(jsm.map_state.frame)
    _assert_same_contents(_contents(jsm.map_state), _contents(tsm.map_state))


@pytest.mark.parametrize("map_type", BACKENDS)
def test_padding_inserts_nothing(map_type):
    pts, poses = _inputs(map_type)
    sm, _ = _port_submaps(map_type)
    sm._grow_map(reextract=False)
    sm._grow_map(reextract=False)  # 512 slots: one insert fits without a retry
    cloud = TCloud.from_numpy(pts[0][:100], capacity=128, device="cpu")
    T = torch.from_numpy(poses[0])
    st = sm.map_state
    chain = sm.make_reapply_chain(sm.map_config, window=4)

    ns, extracted, load, overflow = chain(st, [cloud, None, None, None], [T] * 4, [True, False, False, False])
    assert int(ns.frame) == int(st.frame) + 1
    assert int(ns.used.sum()) > 0 and int(extracted.count()) > 0 and 0.0 < float(load) < 1.0

    ns, extracted, _, _ = chain(st, [None] * 4, [T] * 4, [False] * 4)
    assert int(ns.frame) == int(st.frame)
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(ns, f.name), getattr(st, f.name)), f.name
    with pytest.raises(ValueError, match="4 slots"):
        chain(st, [cloud], [T], [True])


def test_a_frame_without_an_insert_takes_a_padding_slot():
    """A frame off a keyframe stashes None: the chain inserts the others,
    as the sequential retry of the others does."""
    pts, poses = _inputs()
    clouds = [TCloud.from_numpy(x, capacity=1024, device="cpu") for x in pts]
    seq, chain = _port_submaps("VOXEL_HASH_MAP")
    seq.retry_insert_after_drop(clouds[0], poses[0])
    seq.retry_insert_after_drop(clouds[2], poses[2], grow_first=False)
    chain.reconcile_chain([clouds[0], None, clouds[2]], poses, window=4)
    assert int(chain.map_state.frame) == int(seq.map_state.frame) == 2  # two inserts
    assert int(chain.map_state.dropped) == 0
    _assert_same_contents(_contents(seq.map_state), _contents(chain.map_state))


def test_window_smaller_than_the_stash_is_refused():
    sm, _ = _port_submaps("VOXEL_HASH_MAP")
    pts, poses = _inputs()
    clouds = [TCloud.from_numpy(x, capacity=1024, device="cpu") for x in pts]
    with pytest.raises(ValueError, match="window"):
        sm.reconcile_chain(clouds, poses, window=2)
