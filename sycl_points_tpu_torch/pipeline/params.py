"""Odometry parameter tree (dataclasses) and its YAML loader.

Counterpart of :mod:`sycl_points_tpu.pipeline.params`: the same names and
defaults, loadable from a nested dict or YAML with :func:`load_params`
(``cls=LidarInertialOdometryParams`` for the LiDAR-inertial tree).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from sycl_points_tpu_torch.imu.initial_alignment import InitialAlignmentParams
from sycl_points_tpu_torch.imu.preintegration import IMUPreintegrationParams
from sycl_points_tpu_torch.lio.lio_registration import LIORegistrationParams
from sycl_points_tpu_torch.ops.robust import RobustLossType
from sycl_points_tpu_torch.registration.factors import RegType
from sycl_points_tpu_torch.registration.map_prior import MapPriorParams  # noqa: F401 (re-export)
from sycl_points_tpu_torch.registration.pipeline import (
    RandomSamplingParams,
    RegistrationPipelineParams,
    RobustScheduleParams,
    VelocityUpdateParams,
)
from sycl_points_tpu_torch.registration.registration import RegistrationParams

_DEG = math.pi / 180.0


# --- scan preprocessing ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IntensityCorrectionParams:
    enable: bool = True
    exp: float = 2.0
    scale: float = 1e-3
    min_intensity: float = 0.0
    max_intensity: float = 1.0
    ref_distance: float = 1.0
    angle_exponent: float = 0.0


@dataclasses.dataclass(frozen=True)
class VoxelDownsamplingParams:
    enable: bool = False
    size: float = 1.0


@dataclasses.dataclass(frozen=True)
class PolarDownsamplingParams:
    enable: bool = True
    distance_size: float = 1.0
    elevation_size: float = 3.0 * _DEG
    azimuth_size: float = 3.0 * _DEG
    coord_system: str = "CAMERA"


@dataclasses.dataclass(frozen=True)
class RandomDownsamplingParams:
    enable: bool = True
    num: int = 5000


@dataclasses.dataclass(frozen=True)
class DownsamplingParams:
    voxel: VoxelDownsamplingParams = VoxelDownsamplingParams()
    polar: PolarDownsamplingParams = PolarDownsamplingParams()
    random: RandomDownsamplingParams = RandomDownsamplingParams()


@dataclasses.dataclass(frozen=True)
class BoxFilterParams:
    enable: bool = True
    min: float = 2.0
    max: float = 50.0


@dataclasses.dataclass(frozen=True)
class AngleIncidenceFilterParams:
    enable: bool = True
    min_angle: float = 0.0
    max_angle: float = 80.0 * _DEG


@dataclasses.dataclass(frozen=True)
class PreprocessParams:
    box_filter: BoxFilterParams = BoxFilterParams()
    angle_incidence_filter: AngleIncidenceFilterParams = AngleIncidenceFilterParams()


@dataclasses.dataclass(frozen=True)
class IntensityGaussianParams:
    enable: bool = False
    neighbor_num: int = 10
    sigma_azimuth: float = 0.3
    sigma_elevation: float = 0.5
    sigma_range: float = 0.05


@dataclasses.dataclass(frozen=True)
class IntensityLocalMeanNormParams:
    enable: bool = False
    neighbor_num: int = 10
    sigma_azimuth: float = 0.3
    sigma_elevation: float = 0.5
    sigma_range: float = 0.05
    mean_min: float = 1e-3


@dataclasses.dataclass(frozen=True)
class EnhancedReflectivityParams:
    enable: bool = False
    clip_max: float = 5.0
    ring_mean_ema_alpha: float = 0.5


@dataclasses.dataclass(frozen=True)
class ScanParams:
    intensity_correction: IntensityCorrectionParams = IntensityCorrectionParams()
    intensity_gaussian: IntensityGaussianParams = IntensityGaussianParams()
    intensity_local_mean_norm: IntensityLocalMeanNormParams = IntensityLocalMeanNormParams()
    enhanced_reflectivity: EnhancedReflectivityParams = EnhancedReflectivityParams()
    downsampling: DownsamplingParams = DownsamplingParams()
    preprocess: PreprocessParams = PreprocessParams()


# --- submap ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KeyframeParams:
    inlier_ratio_threshold: float = 0.7
    distance_threshold: float = 2.0
    angle_threshold_degrees: float = 20.0
    time_threshold_seconds: float = 1.0


@dataclasses.dataclass(frozen=True)
class SubmapOccupancyGridParams:
    log_odds_hit: float = 0.8
    log_odds_miss: float = -0.05
    log_odds_limits_min: float = -1.0
    log_odds_limits_max: float = 4.0
    occupied_threshold: float = 0.5
    enable_free_space_updates: bool = True
    # Carve free space every k-th frame, hits every frame.
    free_space_update_cycle: int = 1
    enable_pruning: bool = True
    stale_frame_threshold: int = 100


@dataclasses.dataclass(frozen=True)
class SubmapParams:
    map_type: str = "OCCUPANCY_GRID_MAP"  # OCCUPANCY_GRID_MAP | VOXEL_HASH_MAP
    voxel_size: float = 1.0
    max_distance_range: float = 30.0
    point_random_sampling_num: int = 512
    weighted_sampling_ratio: float = 0.8
    keyframe: KeyframeParams = KeyframeParams()
    occupancy_grid_map: SubmapOccupancyGridParams = SubmapOccupancyGridParams()
    # voxel-hash staleness pruning
    max_staleness: int = 100
    remove_old_data_cycle: int = 10
    # static capacities of the map table and of the extracted target:
    map_capacity: int = 1 << 17
    extract_capacity: int = 1 << 14
    # Tier the extraction budget with map growth (and on observed overflow):
    # ``extract_capacity`` is then the BASE tier, and the in-range submap
    # target is never silently truncated (Submap.extract_tier_for /
    # resolve_extract_overflow).
    extract_capacity_growth: bool = True


# --- covariance estimation ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MEstimationParams:
    enable: bool = True
    type: RobustLossType = RobustLossType.GEMAN_MCCLURE
    mad_scale: float = 1.0
    min_robust_scale: float = 5.0
    max_iterations: int = 1


@dataclasses.dataclass(frozen=True)
class CovarianceEstimationParams:
    neighbor_num: int = 10
    m_estimation: MEstimationParams = MEstimationParams()
    # Raw-features path: covariances estimated on the raw sensor-frame scan
    # with a range-image neighbourhood search (ops/range_image_knn.py) and
    # carried through the polar and voxel downsampling.
    raw_range_image: bool = False
    range_image_n_az: int = 2048
    range_image_n_rings: int = 64
    range_image_window_az: int = 6
    range_image_window_el: int = 4


# --- IMU ---------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IMUDeskewParams:
    enable: bool = False
    gyro_only: bool = False


@dataclasses.dataclass(frozen=True)
class IMUParams:
    enable: bool = False
    T_imu_to_lidar: Tuple[float, ...] = tuple(np.eye(4, dtype=np.float32).ravel().tolist())
    preintegration: IMUPreintegrationParams = IMUPreintegrationParams()
    gyro_bias: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    accel_bias: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    buffer_duration_sec: float = 1.0
    deskew: IMUDeskewParams = IMUDeskewParams()
    initial_alignment: InitialAlignmentParams = InitialAlignmentParams()

    def T_imu_to_lidar_matrix(self) -> np.ndarray:
        return np.asarray(self.T_imu_to_lidar, np.float32).reshape(4, 4)


# --- registration / motion prediction ---------------------------------------


@dataclasses.dataclass(frozen=True)
class RegistrationBlockParams:
    min_num_points: int = 100
    factor: RegistrationParams = RegistrationParams()


@dataclasses.dataclass(frozen=True)
class AdaptiveAxisParams:
    factor_min: float = 0.2
    factor_max: float = 1.0
    min_eigenvalue_low: float = 1.0
    min_eigenvalue_high: float = 10.0


@dataclasses.dataclass(frozen=True)
class MotionPredictionParams:
    mode: str = "GYRO_LIDAR_CV"  # LIDAR_CV | GYRO_LIDAR_CV | IMU_SE3
    velocity_ema_alpha: float = 1.0
    rotation: AdaptiveAxisParams = AdaptiveAxisParams(
        factor_min=0.2, factor_max=1.0, min_eigenvalue_low=5.0, min_eigenvalue_high=10.0
    )
    translation: AdaptiveAxisParams = AdaptiveAxisParams()


@dataclasses.dataclass(frozen=True)
class PoseParams:
    initial: Tuple[float, ...] = tuple(np.eye(4, dtype=np.float32).ravel().tolist())

    def initial_matrix(self) -> np.ndarray:
        return np.asarray(self.initial, np.float32).reshape(4, 4)


# --- top-level trees ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CommonParameters:
    scan: ScanParams = ScanParams()
    submap: SubmapParams = SubmapParams()
    covariance_estimation: CovarianceEstimationParams = CovarianceEstimationParams()
    imu: IMUParams = IMUParams()
    registration: RegistrationBlockParams = RegistrationBlockParams()
    registration_sampling: RandomSamplingParams = RandomSamplingParams()
    pose: PoseParams = PoseParams()
    # static capacity of the preprocessed cloud
    scan_capacity: int = 1 << 13


@dataclasses.dataclass(frozen=True)
class LidarOdometryParams(CommonParameters):
    motion_prediction: MotionPredictionParams = MotionPredictionParams()
    lo_pipeline_robust: RobustScheduleParams = RobustScheduleParams()
    lo_velocity_update: VelocityUpdateParams = VelocityUpdateParams()

    def make_registration_pipeline_params(self) -> RegistrationPipelineParams:
        """The registration pipeline's parameters, gathered from the tree."""
        return RegistrationPipelineParams(
            registration=self.registration.factor,
            random_sampling=self.registration_sampling,
            robust=self.lo_pipeline_robust,
            velocity_update=self.lo_velocity_update,
        )


@dataclasses.dataclass(frozen=True)
class LidarInertialOdometryParams(CommonParameters):
    motion_prediction: MotionPredictionParams = MotionPredictionParams(mode="IMU_SE3")
    lio: LIORegistrationParams = LIORegistrationParams()
    # preintegration reset floors
    fd_velocity_sigma: float = 0.1
    icp_rotation_sigma: float = 0.01
    bias_update_min_dt: float = 0.05
    max_accel_bias_norm: float = 0.5
    max_gyro_bias_norm: float = 0.1
    # initial bias standard deviations, put into P_post once at filter start
    # so that the bias states can be corrected
    initial_gyro_bias_sigma: float = 0.02  # [rad/s]
    initial_accel_bias_sigma: float = 0.1  # [m/s^2]


# --- YAML loading ------------------------------------------------------------

def _reg_type(s: str) -> RegType:
    u = s.strip().upper()
    return RegType.POINT_TO_DISTRIBUTION if u == "P2D" else RegType[u]


_ENUM_FIELDS = {
    "reg_type": _reg_type,
    "type": lambda s: RobustLossType[s.strip().upper()],
}


def _build(cls, data: dict):
    if not dataclasses.is_dataclass(cls):
        return data
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"unknown parameter '{key}' for {cls.__name__}")
        f = fields[key]
        if dataclasses.is_dataclass(f.type) or (
            isinstance(f.default, object) and dataclasses.is_dataclass(type(f.default))
        ):
            sub_cls = type(f.default) if f.default is not dataclasses.MISSING else f.type
            kwargs[key] = _build(sub_cls, value) if isinstance(value, dict) else value
        elif key in _ENUM_FIELDS and isinstance(value, str):
            kwargs[key] = _ENUM_FIELDS[key](value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def load_params(source, cls=LidarOdometryParams):
    """Build a parameter tree from a nested dict or from a YAML file path or
    string. An unknown key raises ``KeyError``."""
    if isinstance(source, str):
        import yaml

        try:
            with open(source) as f:
                data = yaml.safe_load(f)
        except (OSError, FileNotFoundError):
            data = yaml.safe_load(source)
    else:
        data = source
    return _build(cls, data or {})
