"""Scan preprocessing (PCProcessor).

Counterpart of :mod:`sycl_points_tpu.pipeline.pc_processor`: the prefilter
chain (box -> raw-features covariances -> polar grid -> voxel grid -> random
sampling), the k-NN context, the covariance estimation (robust or plain), the
refine filter (angle of incidence, intensity correction, directional Gaussian
smoothing, local-mean normalization; the last two reuse the k-NN context),
and the IMU deskew of the raw scan. Every stage runs on the processor's device and none waits on
the host. ``prepare_context`` is the ``knn_k`` kernel on the card.

With ``covariance_estimation.raw_range_image`` the covariances come from the
raw scan, after the box filter: its range-image neighbourhoods
(:func:`..ops.range_image_knn.range_image_knn`, the ``range_image`` kernel on
the card) feed the plain or robust estimator, the polar and voxel stages
carry them as the mean of their members' covariances, ``prepare_context``
searches no k-NN unless a refine op needs one, and ``compute_covariances``
passes the cloud through.

:meth:`PCProcessor.preprocess_streams` is the fleet's preprocess (the
JAX fleet's vmapped ``_pre_fn``): the prefilter (the polar grid included),
the k-NN context, covariances and the refine filter (the intensity ops
included) for a fleet's clouds ``[B, N]`` in one pass, stream ``b``'s random
stage drawing from its own generator. The JAX fleet recomputes the
covariances after its prefilter whenever it needs them, which overwrites the
raw-features ones; the fleet here skips that discarded range-image pass.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.deskew.imu_deskew import deskew_point_cloud_imu
from sycl_points_tpu_torch.ops import intensity as intensity_ops
from sycl_points_tpu_torch.ops.covariance import estimate_covariances, estimate_covariances_robust
from sycl_points_tpu_torch.ops.filters import angle_incidence_filter, box_filter
from sycl_points_tpu_torch.ops.knn import KNNResult, self_knn, self_knn_streams
from sycl_points_tpu_torch.ops.polar import CoordinateSystem, polar_downsample
from sycl_points_tpu_torch.ops.range_image_knn import range_image_knn
from sycl_points_tpu_torch.ops.sampling import random_sampling, random_sampling_streams
from sycl_points_tpu_torch.ops.voxel import voxel_downsample
from sycl_points_tpu_torch.pipeline.params import CommonParameters
from sycl_points_tpu_torch.points.point_cloud import PointCloud, compact_device

SEED = 1234


class ProcessingContext(NamedTuple):
    """The k-NN result shared by the covariance and refine stages."""

    knn: Optional[KNNResult]


class PCProcessor:
    def __init__(self, params: CommonParameters, device: torch.device | str = "cuda"):
        self.params = params
        self.device = require_device(device)
        self._generator = torch.Generator(device=self.device).manual_seed(SEED)

    # -- the fleet ----------------------------------------------------------
    def preprocess_streams(self, clouds: PointCloud, generators, need_covs: bool = True) -> PointCloud:
        """The prefilter, then (``need_covs``) the k-NN context, covariances
        and refine filter, for a fleet's clouds ``[B, N]``; stream ``b``'s
        random stage draws from ``generators[b]``."""
        # with need_covs the covariances are estimated anew after the
        # prefilter, as in the JAX fleet: a raw-features pass would be discarded
        c = self.prefilter(clouds, generators, raw_covariances=not need_covs)
        if need_covs:
            ctx = self.prepare_context(c)
            c = self.refine_filter(self.compute_covariances(c, ctx), ctx)
        return c

    # -- prefilter ----------------------------------------------------------
    def prefilter(self, cloud: PointCloud, generators=None, raw_covariances: bool = True) -> PointCloud:
        """The prefilter chain; a fleet's clouds ``[B, N]`` take one
        generator a stream for the random stage. ``raw_covariances=False``
        skips the raw-features covariances."""
        p = self.params.scan
        c = cloud
        if p.preprocess.box_filter.enable:
            c = box_filter(c, p.preprocess.box_filter.min, p.preprocess.box_filter.max)
        if self.params.covariance_estimation.raw_range_image and raw_covariances:
            c = c.replace(covs=self._range_image_covariances(c))
        cap = min(self.params.scan_capacity, c.capacity)
        polar = p.downsampling.polar
        if polar.enable:
            # The last grid stage emits its bins from slot 0 on, so it writes
            # straight into the scan capacity: no compaction pass.
            c = polar_downsample(
                c, polar.distance_size, polar.elevation_size, polar.azimuth_size,
                CoordinateSystem.from_string(polar.coord_system),
                out_capacity=None if p.downsampling.voxel.enable else cap,
            )
        if p.downsampling.voxel.enable:
            c = voxel_downsample(c, p.downsampling.voxel.size, out_capacity=cap)
        elif not polar.enable:
            c = compact_device(c, out_capacity=cap)
        if p.downsampling.random.enable and p.downsampling.random.num < c.capacity:
            if generators is not None:
                c = random_sampling_streams(c, p.downsampling.random.num, generators)
            else:
                c = random_sampling(c, p.downsampling.random.num, self._generator)
        return c

    def _range_image_covariances(self, cloud: PointCloud) -> torch.Tensor:
        """The covariances of the raw scan from its range-image
        neighbourhoods, one stream at a time for a fleet's clouds."""
        if cloud.points.dim() == 3:
            return torch.stack([self._range_image_covariances(PointCloud(points=p, mask=m))
                                for p, m in zip(cloud.points, cloud.mask)])
        ce = self.params.covariance_estimation
        rr = range_image_knn(cloud.points, cloud.mask, ce.neighbor_num, n_az=ce.range_image_n_az,
                             n_rings=ce.range_image_n_rings, window_az=ce.range_image_window_az,
                             window_el=ce.range_image_window_el)
        return self._covariances(cloud.points, rr.knn)

    def _covariances(self, points: torch.Tensor, knn: KNNResult) -> torch.Tensor:
        me = self.params.covariance_estimation.m_estimation
        if me.enable:
            return estimate_covariances_robust(points, knn, me.type, me.mad_scale, me.min_robust_scale,
                                               me.max_iterations)
        return estimate_covariances(points, knn)

    # -- covariance context --------------------------------------------------
    def prepare_context(self, cloud: PointCloud) -> ProcessingContext:
        """The exact self-k-NN of the preprocessed cloud; none when the
        covariances are there and no refine op needs neighbours."""
        if cloud.covs is not None and not self._refine_needs_knn():
            return ProcessingContext(knn=None)
        k = self.params.covariance_estimation.neighbor_num
        knn = self_knn_streams if cloud.points.dim() == 3 else self_knn
        return ProcessingContext(knn=knn(cloud.points.contiguous(), cloud.mask, k))

    def _refine_needs_knn(self) -> bool:
        p = self.params.scan
        return p.intensity_gaussian.enable or p.intensity_local_mean_norm.enable

    def compute_covariances(self, cloud: PointCloud, ctx: ProcessingContext) -> PointCloud:
        if cloud.covs is not None:
            return cloud  # the raw-features path: estimated and carried already
        return cloud.replace(covs=self._covariances(cloud.points, ctx.knn))

    # -- refine filter -------------------------------------------------------
    def refine_filter(self, cloud: PointCloud, ctx: ProcessingContext) -> PointCloud:
        p = self.params.scan
        c = cloud
        if p.preprocess.angle_incidence_filter.enable and (c.normals is not None or c.covs is not None):
            c = angle_incidence_filter(
                c, p.preprocess.angle_incidence_filter.min_angle,
                p.preprocess.angle_incidence_filter.max_angle,
            )
        if c.intensities is None:
            return c
        if p.intensity_correction.enable and not p.enhanced_reflectivity.enable:
            ic = p.intensity_correction
            c = intensity_ops.correct_intensity(c, ic.exp, ic.scale, ic.min_intensity, ic.max_intensity,
                                                ic.ref_distance, ic.angle_exponent)
        if p.intensity_gaussian.enable:
            g, knn = p.intensity_gaussian, ctx.knn
            c = intensity_ops.smooth_intensity(c, knn, g.sigma_azimuth, g.sigma_elevation, g.sigma_range,
                                               k_limit=min(g.neighbor_num, knn.indices.shape[-1]))
        if p.intensity_local_mean_norm.enable:
            m, knn = p.intensity_local_mean_norm, ctx.knn
            c = intensity_ops.local_mean_normalize(c, knn, m.sigma_azimuth, m.sigma_elevation, m.sigma_range,
                                                   m.mean_min, k_limit=min(m.neighbor_num, knn.indices.shape[-1]))
        return c

    # -- IMU deskew ----------------------------------------------------------
    def deskew_with_imu(self, cloud: PointCloud, imu_buffer, current_pose: np.ndarray, scan_start_time_sec: float,
                        scan_duration_sec: float, gyro_bias=None, accel_bias=None, v_world_body=None,
                        R_world_imu=None):
        """IMU deskew of the raw scan; returns ``(cloud, IMUDeskewStatus)``.
        ``R_world_imu`` overrides the rotation taken from ``current_pose``:
        pipelines pass the rotation propagated to scan start (``current_pose``
        is one frame old)."""
        imu_p = self.params.imu
        T_il = imu_p.T_imu_to_lidar_matrix()
        if R_world_imu is None:
            R_world_imu = np.asarray(current_pose)[:3, :3] @ T_il[:3, :3]
        return deskew_point_cloud_imu(
            cloud, imu_buffer, scan_start_time_sec, scan_duration_sec, T_il,
            np.asarray(imu_p.gyro_bias, np.float32) if gyro_bias is None else gyro_bias,
            np.asarray(imu_p.accel_bias, np.float32) if accel_bias is None else accel_bias,
            imu_p.preintegration, R_world_imu,
            np.zeros(3, np.float32) if v_world_body is None else v_world_body,
            gyro_only=imu_p.deskew.gyro_only,
        )
