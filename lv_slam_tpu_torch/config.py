"""Configuration of the ported stages: the scan prefilter and the DLO odometry.

Field names and defaults are those of the reference's `lv_slam_tpu.config`
(the `dlo_lfa_ggo_kitti.launch` parameter surface), which explains each
field; `tests/test_torch_io.py` holds the two equal. The port keeps its own
copy, of the fields its stages read, so that it and `chip_smoke.py` import
nothing of the JAX package. The LFA, loop-detector and pose-graph
configurations come with their stages.

The `*_cap` fields are static capacities: every cloud and map is a
fixed-capacity tensor with a validity mask.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PrefilterConfig:
    """Scan prefiltering (reference `prefiltering_nodelet.cpp:39-89`)."""

    use_distance_filter: bool = True
    distance_near_thresh: float = 0.5
    distance_far_thresh: float = 100.0
    downsample_method: str = "VOXELGRID"  # NONE | VOXELGRID | APPROX_VOXELGRID (DEDUP not ported)
    downsample_resolution: float = 0.1
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
    table: str = "hash"  # the port has the hash table only
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
class PipelineConfig:
    """The ported stages of the `dlo_lfa_ggo` pipeline."""

    prefilter: PrefilterConfig = dataclasses.field(default_factory=PrefilterConfig)
    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)


def kitti_flagship_config() -> PipelineConfig:
    """The `dlo_lfa_ggo_kitti.launch` configuration."""
    return PipelineConfig()
