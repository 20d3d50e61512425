"""The fleet's batched ops of the port against ``B`` single-stream calls, on
the CPU.

Every op takes a leading stream axis and must give stream ``b`` what the
single-stream op gives it alone, bit for bit (``assert_array_equal``) unless
a tolerance is stated:

  * the batched ``nn1`` / ``knn_k`` wrappers (their plain versions here),
    with streams of different valid counts, a stream with every target
    masked and an odd target count;
  * the voxel downsample (one sort with the stream above the cell key), the
    compaction, the samplers with one generator a stream, the self-k-NN and
    the covariances (plain and robust);
  * ``align_streams`` with Gauss-Newton, Levenberg-Marquardt and dogleg,
    alone and through a robust schedule, with and without the MAP prior:
    poses within 1e-6 m (float32 round-off of the pose entries; the CPU
    gives equal bits), equal iteration counts and convergence flags;
  * the hash table's resolve (tiered too) and ranked compaction on stacked
    tables; the insert, extraction, growth and pruning of both map backends
    on stacked states, with a stream that does not insert;
  * the fleet's submap step with some streams off a keyframe, against the
    single-stream step of each keyframe stream;
  * ``utils.synthetic.fleet_trajectories`` against the JAX fleet benchmark's
    per-stream starts (``benchmarks/bench_fleet.py:73-86``).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import np_

from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.mapping import hash_table as ht
from sycl_points_tpu_torch.mapping import occupancy_grid as t_og
from sycl_points_tpu_torch.mapping import voxel_hash_map as t_vhm
from sycl_points_tpu_torch.ops import cuda_knn, sampling
from sycl_points_tpu_torch.ops.covariance import estimate_covariances, estimate_covariances_robust
from sycl_points_tpu_torch.ops.knn import BruteForceKNN, self_knn, self_knn_streams
from sycl_points_tpu_torch.ops.robust import RobustLossType
from sycl_points_tpu_torch.ops.voxel import voxel_downsample
from sycl_points_tpu_torch.pipeline.fused_submap import make_submap_step, make_submap_step_streams
from sycl_points_tpu_torch.pipeline.submap import Submap
from sycl_points_tpu_torch.points.point_cloud import PointCloud, compact_device
from sycl_points_tpu_torch.registration import map_prior as t_prior
from sycl_points_tpu_torch.registration.factors import RegType
from sycl_points_tpu_torch.registration.registration import RegistrationParams, RobustParams, align, align_streams
from sycl_points_tpu_torch.utils import lie_np, synthetic

from test_torch_lo_frame import make_world, scan_at, small_params

ROOT = Path(__file__).resolve().parents[1]
B = 3
POSE_ATOL = 1e-6


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _stream(cloud: PointCloud, b: int) -> PointCloud:
    return PointCloud(**{f: None if v is None else v[b] for f, v in vars(cloud).items()})


def _stack(clouds) -> PointCloud:
    return PointCloud(**{f: None if getattr(clouds[0], f) is None else torch.stack([getattr(c, f) for c in clouds])
                         for f in vars(clouds[0])})


def _assert_valid_rows_equal(single: PointCloud, fleet_row: PointCloud):
    """Masks equal, and every attribute equal on the valid rows (a masked
    row holds whatever its gather left there)."""
    m = single.mask
    np.testing.assert_array_equal(np_(m), np_(fleet_row.mask))
    for f, v in vars(single).items():
        if v is not None and f != "mask":
            np.testing.assert_array_equal(np_(v[m]), np_(getattr(fleet_row, f)[m]), err_msg=f)


@pytest.fixture(scope="module")
def scans():
    """Three streams' scans of the test world from different poses."""
    world = make_world()
    poses = [lie_np.se3_exp(np.array([0, 0, 0.4 * b, 0.6 * b, 0.3, 0])).astype(np.float32) for b in range(B)]
    return world, poses, [scan_at(world, T) for T in poses]


def _cloud_stack(pts_list, cap, rng=None, attrs=False):
    clouds = []
    for i, p in enumerate(pts_list):
        kw = {}
        if attrs:
            n = len(p)
            kw = {"intensities": rng.uniform(0, 255, n).astype(np.float32),
                  "timestamp_offsets": rng.uniform(0, 100, n).astype(np.float32)}
        clouds.append(PointCloud.from_numpy(p[:cap], capacity=cap, device="cpu",
                                            **{k: v[:cap] for k, v in kw.items()}))
    return clouds


# ---- kernels (plain versions on the CPU) -----------------------------------


def test_batched_kernel_wrappers_equal_single_streams():
    rng = np.random.default_rng(0)
    M, Q = 777, 90  # M off the 512-target tile
    pts = torch.from_numpy(rng.uniform(-20, 20, (B, M, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(B, M)) > 0.3)
    mask[1] = False  # a stream with every target masked
    mask[2, 5:] = False  # fewer valid targets than k
    q = torch.from_numpy(rng.uniform(-20, 20, (B, Q, 3)).astype(np.float32))
    poses = torch.from_numpy(np.stack([lie_np.se3_exp(rng.normal(scale=0.2, size=6)) for _ in range(B)])
                             .astype(np.float32))
    prep = cuda_knn.prep_targets(pts, mask)
    assert prep.xyz.shape == (B, 3, 1024)
    i1, d1 = cuda_knn.nn1_prepped_batched(prep, q, poses)
    ik, dk = cuda_knn.knn_k_batched(prep, q, 10)
    for b in range(B):
        pb = cuda_knn.prep_target(pts[b], mask[b])
        np.testing.assert_array_equal(np_(pb.xyz), np_(prep.xyz[b]))
        for got, ref in zip((i1[b], d1[b], ik[b], dk[b]),
                            (*cuda_knn.nn1_prepped(pb, q[b], poses[b]), *cuda_knn.knn_k_prepped(pb, q[b], 10))):
            np.testing.assert_array_equal(np_(got), np_(ref))
    assert torch.isinf(d1[1]).all() and (i1[1] == 0).all()
    assert cuda_knn.launch_counts["nn1_batched"] == 0  # the plain versions count nothing
    with pytest.raises(ValueError, match="poses"):
        cuda_knn.nn1_prepped_batched(prep, q, poses[:2])


def test_cluster_shape_counts_every_stream():
    # a fleet of 8 x 1000 queries fills the card with larger query tiles than one stream
    assert cuda_knn.cluster_shape(1000, cuda_knn.NN1_QUERY_TILES, 132) == (32, 16)
    assert cuda_knn.cluster_shape(1000, cuda_knn.NN1_QUERY_TILES, 132, streams=8) == (128, 16)
    assert cuda_knn.cluster_shape(5000, (cuda_knn.KNN_QUERY_TILE,), 132, streams=8) == (128, 2)


# ---- preprocess ops --------------------------------------------------------


def test_voxel_downsample_and_compaction_equal_single_streams(scans):
    _, _, pts = scans
    rng = np.random.default_rng(1)
    clouds = _cloud_stack(pts, 2048, rng, attrs=True)
    clouds[2] = clouds[2].replace(mask=torch.zeros_like(clouds[2].mask))
    fleet = _stack(clouds)
    for cap in (300, 2048):
        vd = voxel_downsample(fleet, 0.4, out_capacity=cap)
        cd = compact_device(fleet, out_capacity=cap)
        for b in range(B):
            _assert_valid_rows_equal(voxel_downsample(clouds[b], 0.4, out_capacity=cap), _stream(vd, b))
            single = compact_device(clouds[b], out_capacity=cap)
            for f, v in vars(single).items():
                if v is not None:
                    np.testing.assert_array_equal(np_(v), np_(getattr(cd, f)[b]), err_msg=f)


def test_samplers_draw_per_stream(scans):
    _, _, pts = scans
    clouds = _cloud_stack(pts, 2048)
    fleet = _stack(clouds)
    out = sampling.random_sampling_streams(fleet, 500, [_gen(10 + b) for b in range(B)])
    w = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (B, 2048)).astype(np.float32))
    n0 = sampling.stream_noise([_gen(20 + b) for b in range(B)], 2048, "cpu")
    n1 = sampling.stream_noise([_gen(30 + b) for b in range(B)], 2048, "cpu", draw=[True, False, True])
    assert not n1[1].any()  # a stream that draws nothing moves nothing
    mixed = sampling.mixed_sampling(fleet, 500, w, noise=(n0, n1))
    for b in range(B):
        _assert_valid_rows_equal(sampling.random_sampling(clouds[b], 500, _gen(10 + b)), _stream(out, b))
        _assert_valid_rows_equal(sampling.mixed_sampling(clouds[b], 500, w[b], noise=(n0[b], n1[b])),
                                 _stream(mixed, b))


def test_self_knn_and_covariances_equal_single_streams(scans):
    _, _, pts = scans
    fleet = voxel_downsample(_stack(_cloud_stack(pts, 2048)), 0.4, out_capacity=1500)
    knn = self_knn_streams(fleet.points, fleet.mask, 10)
    plain = estimate_covariances(fleet.points, knn)
    robust = estimate_covariances_robust(fleet.points, knn, RobustLossType.GEMAN_MCCLURE, 1.0, 5.0, 1)
    for b in range(B):
        k1 = self_knn(fleet.points[b].contiguous(), fleet.mask[b], 10)
        np.testing.assert_array_equal(np_(k1.indices), np_(knn.indices[b]))
        np.testing.assert_array_equal(np_(k1.distances), np_(knn.distances[b]))
        np.testing.assert_array_equal(np_(estimate_covariances(fleet.points[b], k1)), np_(plain[b]))
        np.testing.assert_array_equal(
            np_(estimate_covariances_robust(fleet.points[b], k1, RobustLossType.GEMAN_MCCLURE, 1.0, 5.0, 1)),
            np_(robust[b]))


# ---- the align loop --------------------------------------------------------


@pytest.fixture(scope="module")
def pairs(scans):
    """Per stream: a source (moved 0.3 m on) and a target cloud with
    covariances, and a perturbed initial guess."""
    world, poses, _ = scans
    srcs, tgts, inits = [], [], []
    for b, T0 in enumerate(poses):
        T1 = (T0 @ lie_np.se3_exp(np.array([0.01, 0, 0.03, 0.3, 0.05, 0]))).astype(np.float32)
        noise = lie_np.se3_exp(np.array([0.005, 0, -0.01, 0.05, -0.03, 0.02]) * (b + 1))
        inits.append((np.linalg.inv(T0) @ T1 @ noise).astype(np.float32))
        for pts, out in ((scan_at(world, T1), srcs), (scan_at(world, T0), tgts)):
            c = voxel_downsample(PointCloud.from_numpy(pts, capacity=4096, device="cpu"), 0.4, out_capacity=1500)
            out.append(c.replace(covs=estimate_covariances(c.points, self_knn(c.points.contiguous(), c.mask, 10))))
    return srcs, tgts, torch.from_numpy(np.stack(inits))


@pytest.mark.parametrize("method", ["gauss_newton", "levenberg_marquardt", "powell_dogleg"])
@pytest.mark.parametrize("schedule", [False, True], ids=["one level", "robust schedule"])
@pytest.mark.parametrize("with_prior", [False, True], ids=["", "prior"])
def test_align_streams_equal_single_streams(pairs, method, schedule, with_prior):
    srcs, tgts, init = pairs
    robust = RobustLossType.GEMAN_MCCLURE if schedule else RobustLossType.NONE
    sched = ((2.0, 1.0), (1.0, 1.0), (0.5, 1.0)) if schedule else None
    params = RegistrationParams(reg_type=RegType.GICP, optimization_method=method, max_iterations=10,
                                robust=RobustParams(type=robust))
    pp = t_prior.MapPriorParams(enabled=True)
    A = torch.randn(B, 6, 6, generator=_gen(1))
    H_prev = A @ A.transpose(-1, -2) * 50
    prev_T = init @ torch.from_numpy(lie_np.se3_exp(np.array([0.01, 0, 0, 0.1, 0, 0])).astype(np.float32))
    err_prev, inl_prev = torch.full((B,), 30.0), torch.full((B,), 200, dtype=torch.int32)
    prior = t_prior.update(pp, prev_T, H_prev, err_prev, inl_prev, init) if with_prior else None
    src, tgt = _stack(srcs), _stack(tgts)
    res = align_streams(src, tgt, BruteForceKNN(points=tgt.points, mask=tgt.mask), params, init, map_prior=prior,
                        robust_schedule=sched)
    for b in range(B):
        p1 = t_prior.update(pp, prev_T[b], H_prev[b], err_prev[b], inl_prev[b], init[b]) if with_prior else None
        if with_prior:
            for got, ref in zip(prior, p1):
                np.testing.assert_array_equal(np_(got[b]), np_(ref))
        r1 = align(srcs[b], tgts[b], BruteForceKNN.build(tgts[b]), params, init[b], map_prior=p1,
                   robust_schedule=sched)
        np.testing.assert_allclose(np_(res.T[b]), np_(r1.T), atol=POSE_ATOL)
        assert int(res.iterations[b]) == int(r1.iterations) and bool(res.converged[b]) == bool(r1.converged)
        np.testing.assert_allclose(np_(res.H_raw[b]), np_(r1.H_raw), rtol=1e-5, atol=1e-3)


# ---- the maps --------------------------------------------------------------


def test_hash_resolve_and_ranked_compaction_on_stacked_tables():
    rng = np.random.default_rng(3)
    C, M = 256, 300
    keys = torch.from_numpy(rng.integers(0, 40, (B, M, 3)).astype(np.int32))
    valid = torch.from_numpy(rng.uniform(size=(B, M)) > 0.2)
    for b in range(B):  # unique keys within a stream
        _, first = np.unique(np_(keys[b]), axis=0, return_index=True)
        keep = np.zeros(M, bool)
        keep[first] = True
        valid[b] &= torch.from_numpy(keep)
    tbl = torch.full((B, C, 3), ht._SENTINEL, dtype=torch.int32)
    used = torch.zeros((B, C), dtype=torch.bool)
    c1, u1, s1, r1 = ht.resolve_slots(tbl, used, keys[:, :150], valid[:, :150], C, 8)
    c2, u2, s2, r2 = ht.resolve_slots_tiered(c1, u1, keys, valid, C, 8, tier=128)
    keep = torch.from_numpy(rng.uniform(size=(B, C)) > 0.5)
    keep[1] = torch.from_numpy(rng.uniform(size=C) > 0.9)
    rank = torch.from_numpy(rng.uniform(size=(B, C)).astype(np.float32))
    for b in range(B):
        a1 = ht.resolve_slots(tbl[b], used[b], keys[b, :150], valid[b, :150], C, 8)
        a2 = ht.resolve_slots_tiered(a1[0], a1[1], keys[b], valid[b], C, 8, tier=128)
        for got, ref in zip((c1[b], u1[b], s1[b], r1[b], c2[b], u2[b], s2[b], r2[b]), (*a1, *a2)):
            np.testing.assert_array_equal(np_(got), np_(ref))
    for out_cap in (40, 200, 300):
        idx, mask, over = ht.compact_indices_ranked(keep, rank, out_cap)
        for b in range(B):
            for got, ref in zip((idx[b], mask[b], over[b]), ht.compact_indices_ranked(keep[b], rank[b], out_cap)):
                np.testing.assert_array_equal(np_(got), np_(ref))


def _assert_state_row(single, stacked, b):
    for f in dataclasses.fields(single):
        np.testing.assert_array_equal(np_(getattr(single, f.name)), np_(getattr(stacked, f.name)[b]), err_msg=f.name)


@pytest.mark.parametrize("backend", ["voxel_hash_map", "occupancy_grid"])
def test_stacked_maps_equal_single_maps(scans, backend):
    world, _, _ = scans
    if backend == "voxel_hash_map":
        mod, cfg = t_vhm, t_vhm.VoxelHashMapConfig(voxel_size=0.5, capacity=1 << 12, max_probes=16)
    else:
        mod, cfg = t_og, t_og.OccupancyGridConfig(voxel_size=0.5, capacity=1 << 12, max_probes=16,
                                                  max_ray_distance=20.0, free_space_update_cycle=2)
    stacked = t_vhm.stack_streams(mod.create(cfg, "cpu"), B)
    singles = [mod.create(cfg, "cpu") for _ in range(B)]
    rng = np.random.default_rng(4)
    for fr in range(3):
        poses = [lie_np.se3_exp(np.array([0, 0, 0.2 * b + 0.05 * fr, 0.3 * fr + b, 0.1 * b, 0])).astype(np.float32)
                 for b in range(B)]
        clouds = [PointCloud.from_numpy(p[rng.permutation(len(p))[:700]], capacity=1024, device="cpu")
                  for p in (scan_at(world, T) for T in poses)]
        clouds = [c.replace(covs=(torch.eye(3) * 0.01 * (b + 1)).expand(1024, 3, 3).clone())
                  for b, c in enumerate(clouds)]
        active = torch.tensor([True, fr != 1, True])  # stream 1 skips a frame
        fleet = _stack(clouds)
        fleet = fleet.replace(mask=fleet.mask & active[:, None])
        P = torch.from_numpy(np.stack(poses))
        stacked = t_vhm.select_streams(active, mod.add_point_cloud(stacked, cfg, fleet, P), stacked)
        if backend == "voxel_hash_map":
            ex, over = mod.extract(stacked, cfg, P[:, :3, 3], 10.0, out_capacity=300, with_overflow=True)
        else:
            ex, over = mod.extract_occupied_points(stacked, cfg, P[:, :3, 3], 10.0, out_capacity=300,
                                                   with_overflow=True)
        np.testing.assert_allclose(np_(mod.load_factor(stacked, cfg)),
                                   [float(mod.load_factor(s, cfg)) for s in singles] if False else
                                   np_(stacked.used.sum(-1)) / cfg.capacity)
        for b in range(B):
            if active[b]:
                singles[b] = mod.add_point_cloud(singles[b], cfg, clouds[b], torch.from_numpy(poses[b]))
            _assert_state_row(singles[b], stacked, b)
            if backend == "voxel_hash_map":
                e1, o1 = mod.extract(singles[b], cfg, P[b, :3, 3], 10.0, out_capacity=300, with_overflow=True)
            else:
                e1, o1 = mod.extract_occupied_points(singles[b], cfg, P[b, :3, 3], 10.0, out_capacity=300,
                                                     with_overflow=True)
            _assert_valid_rows_equal(e1, _stream(ex, b))
            assert int(o1) == int(over[b])
    grown, gcfg = mod.grow(stacked, cfg)
    for b in range(B):
        _assert_state_row(mod.grow(singles[b], cfg)[0], grown, b)
    if backend == "voxel_hash_map":
        cfg0 = dataclasses.replace(gcfg, max_staleness=0)
        pruned = mod.remove_old_data(grown, cfg0)
        for b in range(B):
            _assert_state_row(mod.remove_old_data(mod.grow(singles[b], cfg)[0], cfg0), pruned, b)


@pytest.mark.parametrize("map_type", ["VOXEL_HASH_MAP", "OCCUPANCY_GRID_MAP"])
def test_fleet_submap_step_equals_single_steps(pairs, map_type):
    """Streams 0 and 2 keyframes (stream 2 below the sample size, so it
    samples uniformly), stream 1 not: the fleet's step against the
    single-stream step of each stream, with the same generator."""
    srcs, tgts, init = pairs
    p = params_from_reference(small_params())
    p = dataclasses.replace(p, submap=dataclasses.replace(p.submap, map_type=map_type, extract_capacity=1500,
                                                          point_random_sampling_num=600))
    sm = Submap(p, device="cpu")
    step_b = make_submap_step_streams(p, sm, 0.5)
    step_1 = make_submap_step(p, sm, 0.5)
    srcs = [srcs[0], srcs[1], srcs[2].replace(mask=srcs[2].mask & (torch.arange(1500) < 500))]
    n_desk = np.array([int(c.count()) for c in srcs])
    is_kf = np.array([True, False, True])
    assert n_desk[0] > 600 and n_desk[2] < 600
    state0 = t_vhm.stack_streams(sm.map_module.create(sm.map_config, "cpu"), B)
    tgt = _stack([t.replace(normals=None) for t in tgts])
    knn = BruteForceKNN(points=tgt.points, mask=tgt.mask).prepped()
    new, target, sampled, s2 = step_b(state0, tgt, knn, _stack(srcs), init, is_kf, n_desk,
                                      [_gen(40 + b) for b in range(B)])
    for b in range(B):
        n1, t1, smp1, s21 = step_1(sm.map_module.create(sm.map_config, "cpu"), tgts[b], srcs[b], init[b],
                                   bool(is_kf[b]), _gen(40 + b), n_desk=int(n_desk[b]))
        _assert_state_row(n1, new, b)
        np.testing.assert_array_equal(np_(s21), np_(s2[b]))
        _assert_valid_rows_equal(t1, _stream(target, b))
        if is_kf[b]:
            _assert_valid_rows_equal(smp1, _stream(sampled, b))
        else:
            assert not sampled.mask[b].any()


def test_fleet_trajectories_equal_the_bench():
    """benchmarks/bench_fleet.py:73-86: the reference figure-8, turned by
    yaw 2 pi s / B and moved 3.0 (s mod 4) m along x."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    import synthetic_velodyne as ref

    n, speed = 6, 0.35
    trajs, starts = synthetic.fleet_trajectories(8, n, speed=speed)
    base = ref.figure8_trajectory(n, speed=speed)
    for s in range(8):
        yaw = 2.0 * np.pi * s / 8
        c, si = np.cos(yaw), np.sin(yaw)
        R = np.eye(4, dtype=np.float32)
        R[:3, :3] = np.array([[c, -si, 0], [si, c, 0], [0, 0, 1]], np.float32)
        R[0, 3] = 3.0 * (s % 4)
        np.testing.assert_array_equal(starts[s], R)
        for i in range(n):
            np.testing.assert_array_equal(trajs[s][i], (R @ base[i]).astype(np.float32))
