"""Configuration of the ported stages.

Field names and defaults are those of the reference's `lv_slam_tpu.config`
(the `dlo_lfa_ggo_kitti.launch` parameter surface), which explains each
field; `tests/test_torch_io.py` holds the two equal. The port keeps its own
copy, of the fields its stages read, so that it and `chip_smoke.py` import
nothing of the JAX package.

The `*_cap` fields are static capacities: every cloud and map is a
fixed-capacity tensor with a validity mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PrefilterConfig:
    """Scan prefiltering (reference `prefiltering_nodelet.cpp:39-89`)."""

    use_distance_filter: bool = True
    distance_near_thresh: float = 0.5
    distance_far_thresh: float = 100.0
    downsample_method: str = "VOXELGRID"  # NONE | VOXELGRID | APPROX_VOXELGRID | DEDUP
    downsample_resolution: float = 0.1
    outlier_removal_method: str = "NONE"  # NONE | RADIUS | STATISTICAL (the latter two: ROADMAP item 6)
    statistical_mean_k: int = 30
    statistical_stddev: float = 1.2
    radius_radius: float = 0.5
    radius_min_neighbors: int = 5
    use_angle_calibration: bool = False  # ROADMAP item 6
    angle_base: float = 0.11  # degrees, vertical-angle calibration rotation
    voxel_reduce: str = "scatter"  # scatter | scan: two TPU forms of one centroid, kernel 1 serves both
    raw_cap: int = 131072  # raw points per scan (KITTI HDL-64 ~130k)
    out_cap: int = 131072  # points after filtering


@dataclasses.dataclass(frozen=True)
class NDTConfig:
    """NDT registration (reference `ndt_omp_impl2.hpp:53-83`, odometry
    overrides `scan_matching_odom_nodelet.cpp:108-119`)."""

    resolution: float = 1.0
    step_size: float = 0.1
    outlier_ratio: float = 0.55
    transformation_epsilon: float = 0.01
    max_iterations: int = 64
    neighborhood: str = "DIRECT1"  # DIRECT1 | DIRECT7 | DIRECT26
    weighted: bool = True  # PCA-weighted NDT (pclpca) vs classical (pclomp)
    retry_deviation_thresh: float = 0.15  # m; 0 disables the DIRECT7 retry
    retry_neighborhood: str = "DIRECT7"
    coarse_subsample: int = 2  # Newton approach phase on every k-th lane
    min_points_per_voxel: int = 6
    min_covar_eigvalue_mult: float = 0.01
    table: str = "hash"  # hash | lut: the bucket-pair hash table or the dense voxel->leaf LUT
    hash_buckets_per_leaf: int = 4
    leaf_cap: int = 32768  # occupied voxels per map
    lut_extent: int = 256  # cells per axis of the flat voxel key


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-keyframe DLO frontend (`scan_matching_odom_nodelet.cpp:65-138`)."""

    keyframe_delta_trans: float = 10.0
    keyframe_delta_angle: float = 0.17
    keyframe_delta_time: float = 1.0
    initial_guess_x: float = 1.5
    scan_matching_cap: int = 65536  # lanes NDT matches; 0 disables
    subsample_method: str = "stride"  # stride | gather
    ndt: NDTConfig = dataclasses.field(default_factory=NDTConfig)


@dataclasses.dataclass(frozen=True)
class LfaConfig:
    """LOAM-style feature mapping stage (the reference launches the external
    A-LOAM package; params `launch/dlo_lfa_ggo_kitti.launch:56-61`). Every
    field of the reference's `LfaConfig`, including those of the standalone
    feature odometry."""

    scan_line: int = 64
    minimum_range: float = 5.0
    mapping_line_resolution: float = 0.4
    mapping_plane_resolution: float = 0.8
    mapping_skip_frame: int = 1  # A-LOAM's skipFrameNum: map every N-th scan
    min_elev_deg: float = -24.8  # HDL-64 vertical field of view
    max_elev_deg: float = 2.0
    n_sectors: int = 6  # feature picks per ring sector
    sharp_per_sector: int = 2
    less_sharp_per_sector: int = 20
    flat_per_sector: int = 4
    odom_corr_rounds: int = 2
    mapping_corr_rounds: int = 1
    knn_slots: int = 6  # cell-table slots per bucket
    knn_k: int = 5  # points a line / plane fit needs within 1 m
    knn_table_density: float = 0.5  # buckets ~ density * map capacity
    crop_radius: float = 150.0  # world maps are cropped to this radius
    crop_interval: float = 10.0  # m the pose moves between crops; 0 crops every scan
    edge_cap: int = 4096
    planar_cap: int = 8192
    map_edge_cap: int = 32768
    map_planar_cap: int = 65536
    odom_max_iterations: int = 8
    mapping_max_iterations: int = 8


@dataclasses.dataclass(frozen=True)
class LoopDetectorConfig:
    """Loop detection gates and NDT verification
    (`include/global_graph/loop_detector.hpp:51-71`,
    `launch/dlo_lfa_ggo_kitti.launch:104-113`). The ladder `multiscale` +
    `ndt_resolution` runs 8/8/16 Newton iterations, the coarse rungs on at
    most `verify_coarse_points` strided lanes. Without descriptors
    candidates are ranked by order; with them by a BoW vocabulary (given, or
    trained on `vocab_min_keyframes` keyframes when `auto_train_vocab`), or
    by raw matching of up to `descriptor_cap` descriptors before one exists."""

    distance_thresh: float = 20.0
    accum_distance_thresh: float = 100.0
    min_edge_interval: float = 50.0
    fitness_score_thresh: float = 2.0
    bow_score_thresh: float = 0.04
    registration_method: str = "NDT_OMP"
    ndt_resolution: float = 1.0
    ndt_neighborhood: str = "DIRECT7"
    multiscale: Tuple[float, ...] = (4.0, 2.0)
    multiscale_max_iterations: int = 8
    verify_max_iterations: int = 16
    verify_coarse_points: int = 32768
    max_guess_correction_trans: float = 5.0
    max_guess_correction_rot: float = 0.5
    candidates_cap: int = 8
    descriptor_cap: int = 512
    auto_train_vocab: bool = True
    vocab_min_keyframes: int = 10
    vocab_words: int = 512


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Pose-graph backend (`global_graph_nodelet.cpp:72-146`,
    `launch/dlo_lfa_ggo_kitti.launch:95-146`). The information matrix is
    `information_matrix_calculator.cpp:9-21`'s: constant (the flagship) or
    fitness-adaptive."""

    solver_num_iterations: int = 1024
    keyframe_delta_trans: float = 10.0
    keyframe_delta_angle: float = 0.17
    max_keyframes_per_update: int = 20
    graph_update_interval: float = 10.0
    map_cloud_resolution: float = 0.5
    use_const_inf_matrix: bool = True
    const_stddev_x: float = 0.5
    const_stddev_q: float = 0.1
    var_gain_a: float = 20.0
    min_stddev_x: float = 0.1
    max_stddev_x: float = 5.0
    min_stddev_q: float = 0.05
    max_stddev_q: float = 0.2
    fitness_score_max_range: float = float("inf")
    odometry_edge_robust_kernel: str = "Huber"
    odometry_edge_robust_kernel_size: float = 1.0
    loop_closure_edge_robust_kernel: str = "Huber"
    loop_closure_edge_robust_kernel_size: float = 1.0
    floor_edge_robust_kernel: str = "NONE"
    floor_edge_robust_kernel_size: float = 1.0
    fix_first_node: bool = False  # anchor keyframe 0 through a fixed helper node
    enable_gps: bool = False  # the priors below wait for their factors
    enable_imu_acceleration: bool = False
    enable_imu_orientation: bool = False
    gps_edge_stddev_xy: float = 20.0
    gps_edge_stddev_z: float = 5.0
    imu_orientation_edge_stddev: float = 1.0
    imu_acceleration_edge_stddev: float = 1.0
    floor_edge_stddev: float = 100.0
    keyframe_cap: int = 1024
    edge_cap: int = 4096
    prior_cap: int = 256
    plane_cap: int = 8
    sp_edge_cap: int = 64
    plane_edge_cap: int = 16


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The `dlo_lfa_ggo` pipeline's stages (`lfa=None` runs without the LFA
    stage), and the camera->lidar calibration: KITTI calib.txt's 3x4
    row-major "Tr", identity when absent."""

    prefilter: PrefilterConfig = dataclasses.field(default_factory=PrefilterConfig)
    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)
    lfa: Optional[LfaConfig] = dataclasses.field(default_factory=LfaConfig)
    loop: LoopDetectorConfig = dataclasses.field(default_factory=LoopDetectorConfig)
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    calib_tr: Optional[Tuple[float, ...]] = None


def kitti_flagship_config() -> PipelineConfig:
    """The `dlo_lfa_ggo_kitti.launch` configuration."""
    return PipelineConfig()
