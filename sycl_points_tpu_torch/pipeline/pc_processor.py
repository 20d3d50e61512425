"""Scan preprocessing (PCProcessor).

Counterpart of :mod:`sycl_points_tpu.pipeline.pc_processor`: the prefilter
chain (box -> voxel grid -> random sampling), the k-NN context, the
covariance estimation (robust or plain) and the refine filter (angle of
incidence). Every stage runs on the processor's device and none waits on the
host. ``prepare_context`` is the ``knn_k`` kernel on the card.

Not ported yet; each raises ``NotImplementedError`` when its flag asks for
it: polar downsampling and the raw range-image covariances (ROADMAP Queue 1
item 10), the intensity ops when the cloud carries intensities (item 10),
IMU deskew (item 8). ``PolarDownsamplingParams.enable`` defaults to True, as
in the JAX package, so a default parameter tree raises until polar
downsampling is ported or switched off.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sycl_points_tpu_torch import require_device
from sycl_points_tpu_torch.ops.covariance import estimate_covariances, estimate_covariances_robust
from sycl_points_tpu_torch.ops.filters import angle_incidence_filter, box_filter
from sycl_points_tpu_torch.ops.knn import KNNResult, self_knn
from sycl_points_tpu_torch.ops.sampling import random_sampling
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
        p = params.scan
        if p.downsampling.polar.enable:
            raise NotImplementedError(
                "polar downsampling is not ported yet (ROADMAP Queue 1 item 10); it is on by default "
                "(PolarDownsamplingParams.enable): pass PolarDownsamplingParams(enable=False)")
        if params.covariance_estimation.raw_range_image:
            raise NotImplementedError(
                "the raw range-image covariance path is not ported yet (ROADMAP Queue 1 item 10)")
        if p.intensity_gaussian.enable or p.intensity_local_mean_norm.enable:
            raise NotImplementedError("the intensity ops are not ported yet (ROADMAP Queue 1 item 10)")

    # -- prefilter ----------------------------------------------------------
    def prefilter(self, cloud: PointCloud) -> PointCloud:
        p = self.params.scan
        c = cloud
        if p.preprocess.box_filter.enable:
            c = box_filter(c, p.preprocess.box_filter.min, p.preprocess.box_filter.max)
        cap = min(self.params.scan_capacity, c.capacity)
        if p.downsampling.voxel.enable:
            c = voxel_downsample(c, p.downsampling.voxel.size, out_capacity=cap)
        else:
            c = compact_device(c, out_capacity=cap)
        if p.downsampling.random.enable and p.downsampling.random.num < c.capacity:
            c = random_sampling(c, p.downsampling.random.num, self._generator)
        return c

    # -- covariance context --------------------------------------------------
    def prepare_context(self, cloud: PointCloud) -> ProcessingContext:
        """The exact self-k-NN of the preprocessed cloud."""
        if cloud.covs is not None:
            return ProcessingContext(knn=None)
        k = self.params.covariance_estimation.neighbor_num
        return ProcessingContext(knn=self_knn(cloud.points.contiguous(), cloud.mask, k))

    def compute_covariances(self, cloud: PointCloud, ctx: ProcessingContext) -> PointCloud:
        if cloud.covs is not None:
            return cloud
        me = self.params.covariance_estimation.m_estimation
        if me.enable:
            covs = estimate_covariances_robust(
                cloud.points, ctx.knn, me.type, me.mad_scale, me.min_robust_scale, me.max_iterations
            )
        else:
            covs = estimate_covariances(cloud.points, ctx.knn)
        return cloud.replace(covs=covs)

    # -- refine filter -------------------------------------------------------
    def refine_filter(self, cloud: PointCloud, ctx: ProcessingContext) -> PointCloud:
        p = self.params.scan
        c = cloud
        if p.preprocess.angle_incidence_filter.enable and (c.normals is not None or c.covs is not None):
            c = angle_incidence_filter(
                c, p.preprocess.angle_incidence_filter.min_angle,
                p.preprocess.angle_incidence_filter.max_angle,
            )
        if (c.intensities is not None and p.intensity_correction.enable
                and not p.enhanced_reflectivity.enable):
            raise NotImplementedError(
                "intensity correction of a cloud with intensities is not ported yet "
                "(ROADMAP Queue 1 item 10): pass IntensityCorrectionParams(enable=False)")
        return c

    # -- IMU deskew ----------------------------------------------------------
    def deskew_with_imu(self, *args, **kwargs):
        raise NotImplementedError("IMU deskew is not ported yet (ROADMAP Queue 1 item 8)")
