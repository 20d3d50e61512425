"""The port's ``FleetOdometry`` at ``raw_range_image=True`` against the JAX
package's, on the CPU.

  * ``tests/test_torch_fleet.py``'s scenario (two streams of the test world,
    ``small_params()``, every point taken) with the flag on, 3 frames: the
    same result types and every pose within 1 mm / 1e-3 rad of JAX's. Both
    fleets estimate the covariances anew after the prefilter (the JAX fleet
    overwrites its range-image ones), so the port's fleet skips that pass;
  * without a covariance refit (point-to-point, no angle filter) the
    fleet's prefilter keeps the range-image covariances, as JAX's does, one
    stream at a time; with one, it runs no range-image pass.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from sycl_points_tpu.parallel.fleet import FleetOdometry as JFleet
from sycl_points_tpu.points.point_cloud import PointCloud as JCloud
from sycl_points_tpu_torch.convert import params_from_reference
from sycl_points_tpu_torch.parallel.fleet import FleetOdometry
from sycl_points_tpu_torch.pipeline.pc_processor import PCProcessor as TPCProcessor
from sycl_points_tpu_torch.points.point_cloud import PointCloud as TCloud

from test_torch_checkpoint import _every_point
from test_torch_fleet import B, ROT_RAD, TRANS_M, run_port, stacked_frame, stream_trajectories
from test_torch_lio_frame import pose_gap
from test_torch_lo_frame import make_world, scan_at, small_params


def _raw(p, **kw):
    return dataclasses.replace(p, covariance_estimation=dataclasses.replace(
        p.covariance_estimation, raw_range_image=True, **kw))


def test_raw_fleet_matches_jax():
    """tests/test_torch_fleet.py's scenario with the raw-features flag: the
    JAX fleet's range-image covariances are overwritten by its post-prefilter
    estimate, which the port's fleet makes alone."""
    world = make_world()
    n_frames = 3
    trajs = stream_trajectories(B, n_frames)
    scans = [[scan_at(world, trajs[s][i]) for s in range(B)] for i in range(n_frames)]
    jp = _raw(_every_point(small_params()))
    init = np.stack([t[0] for t in trajs])
    jf = JFleet(jp, n_streams=B, initial_poses=init)
    for i, frame in enumerate(scans):
        pts, mask = stacked_frame(frame)
        jf.process_batch(JCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask)), 0.1 * i)
    jf.flush()
    tf = run_port(FleetOdometry(params_from_reference(jp), n_streams=B, initial_poses=init, device="cpu"), scans)
    for s in range(B):
        assert [(i, rt.value) for i, rt in tf.deferred_results[s]] == \
            [(i, rt.value) for i, rt in jf.deferred_results[s]]
        for (i, _, T, _), (_, _, jT, _) in zip(tf.pose_log[s], jf.pose_log[s], strict=True):
            gap_t, gap_r = pose_gap(T, np.asarray(jT))
            assert gap_t < TRANS_M and gap_r < ROT_RAD, (s, i, gap_t, gap_r)


def test_raw_fleets_keep_the_raw_covariances_only_without_a_refit():
    """Without a covariance refit (point-to-point, no angle filter) both
    fleets keep the range-image covariances of the prefilter; with one, the
    port's fleet skips the discarded pass."""
    from sycl_points_tpu_torch.registration.factors import RegType

    tp = params_from_reference(_raw(small_params()))
    factor = dataclasses.replace(tp.registration.factor, reg_type=RegType.POINT_TO_POINT)
    no_refit = dataclasses.replace(
        tp, registration=dataclasses.replace(tp.registration, factor=factor),
        scan=dataclasses.replace(tp.scan, preprocess=dataclasses.replace(
            tp.scan.preprocess, angle_incidence_filter=dataclasses.replace(
                tp.scan.preprocess.angle_incidence_filter, enable=False))))
    pts, mask = stacked_frame([scan_at(make_world(), np.eye(4, dtype=np.float32))] * B)
    cloud = TCloud(points=torch.from_numpy(pts), mask=torch.from_numpy(mask))
    gens = [torch.Generator().manual_seed(s) for s in range(B)]
    calls = []
    for params, need in ((no_refit, False), (tp, True)):
        pc = TPCProcessor(params, device="cpu")
        real = pc._range_image_covariances
        pc._range_image_covariances = lambda c, real=real: calls.append(c.points.dim()) or real(c)
        out = pc.preprocess_streams(cloud, gens, need_covs=need)
        assert out.covs is not None and out.covs.shape[:2] == (B, out.capacity)
    assert calls == [3, B, B]  # one batched pass, a stream at a time, for the fleet without a refit
