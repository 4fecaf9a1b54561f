"""Direct LiDAR odometry ("dlo"), the host driver: scan-to-keyframe
weighted-NDT tracking (port of `lv_slam_tpu.odometry.dlo`).

Behavioural rebuild of `ScanMatchingOdomNodelet::matching_s2k`
(`src/lidar_odometry/scan_matching_odom_nodelet.cpp:192-261`), as the
reference's host driver runs it:

- scan 0 becomes the first keyframe; the next guess is identity with
  x = `initial_guess_x`; scan 1 is aligned twice, the second pass seeded with
  the first result;
- constant-velocity warm start: `guess = tf_s2k @ tf_s2s` with
  `tf_s2s = pre_tf_s2k^-1 @ tf_s2k`, taken before a keyframe switch resets
  `tf_s2k`;
- a keyframe switch when `|t| > delta_trans`, `2 acos(q_w) > delta_angle` or
  `dt > delta_time`: the new keyframe map is built from the current scan;
- a deviation-triggered retry with `retry_neighborhood`, kept when the
  generic pass (kernel K6G) scores it above the align's own score.

The keyframe map lives on the run's device as a `VoxelMap` with its dense
LUT (kernels 2 and K3L) and packed rows; each align is `ndt_align_soa`
(kernel K6L in the Newton loop), single-phase as in the reference's host
path. The host state (poses, guesses, the keyframe gate) is float64 numpy,
as in the reference; each align reads its transform and iteration count
back in one copy (and its score where the retry runs).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.config import OdometryConfig, PrefilterConfig
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.ops.ndt import make_gauss_params, ndt_derivatives
from lv_slam_tpu_torch.ops.ndt_soa import ndt_align_soa_table, to_soa
from lv_slam_tpu_torch.ops.prefilter import prefilter, uniform_subsample
from lv_slam_tpu_torch.ops.voxel_map import LutMap, build_lut, build_voxel_map, neighborhood_offsets


@functools.lru_cache(maxsize=16)
def _prefilter_cache(prefilter_cfg: PrefilterConfig):
    return functools.partial(prefilter, cfg=prefilter_cfg)


@functools.lru_cache(maxsize=16)
def _subsample_cache(out_cap: int):
    return functools.partial(uniform_subsample, out_cap=out_cap)


@dataclasses.dataclass
class OdometryStats:
    scan_count: int = 0
    keyframe_count: int = 0
    total_align_time: float = 0.0
    total_iterations: int = 0
    retries: int = 0

    @property
    def mean_align_time(self) -> float:
        n = max(self.scan_count - 1, 1)
        return self.total_align_time / n


def _read_align(result) -> Tuple[np.ndarray, int]:
    """An align's transform (float64) and Newton iteration count, read back
    in one copy (the count, a small integer, rides along in float32)."""
    packed = torch.cat([result.transform.reshape(16), result.iterations.to(torch.float32).reshape(1)])
    host = packed.cpu().numpy()
    return host[:16].reshape(4, 4).astype(np.float64), int(host[16])


class DirectLidarOdometry:
    """Host driver around the keyframe map build and the LUT align."""

    def __init__(
        self,
        cfg: Optional[OdometryConfig] = None,
        prefilter_cfg: Optional[PrefilterConfig] = None,
        device="cuda",
    ):
        self.cfg = cfg or OdometryConfig()
        self.prefilter_cfg = prefilter_cfg
        self.device = torch.device(device)
        ndt = self.cfg.ndt
        align_kw = dict(
            resolution=ndt.resolution, outlier_ratio=ndt.outlier_ratio, step_size=ndt.step_size,
            transformation_epsilon=ndt.transformation_epsilon, max_iterations=ndt.max_iterations,
            weighted=ndt.weighted,
        )
        self._align = functools.partial(ndt_align_soa_table, neighborhood=ndt.neighborhood, **align_kw)
        if ndt.retry_deviation_thresh > 0:
            self._align_retry = functools.partial(
                ndt_align_soa_table, neighborhood=ndt.retry_neighborhood, **align_kw
            )
            # the reference's retry arbiter: the generic pass with the align's
            # neighbourhood and the default outlier ratio (jit_cache.ndt_score_fn)
            self._score_gauss = make_gauss_params(ndt.resolution)
            self._score_offsets = neighborhood_offsets(ndt.neighborhood, self.device)
        else:
            self._align_retry = None
        self._prefilter = _prefilter_cache(prefilter_cfg) if prefilter_cfg is not None else None
        sm = self.cfg.scan_matching_cap
        if prefilter_cfg is not None and sm and sm < prefilter_cfg.out_cap:
            self._subsample = _subsample_cache(sm)
            # `uniform_subsample` needs a front-compacted cloud; an outlier
            # removal re-holes the mask after `prefilter`'s compaction
            self._compact_before_subsample = prefilter_cfg.outlier_removal_method.upper() != "NONE"
        else:
            self._subsample = None
            self._compact_before_subsample = False
        self.reset()

    def reset(self):
        self.stats = OdometryStats()
        self._key_map: Optional[LutMap] = None
        self._key_soa = None
        self._key_pose = np.eye(4, dtype=np.float64)
        self._tf_s2k = np.eye(4, dtype=np.float64)
        self._pre_tf_s2k = np.eye(4, dtype=np.float64)
        self._guess = np.eye(4, dtype=np.float64)
        self._keyframe_stamp = 0.0
        self.filtered: Optional[PointCloud] = None
        self.poses: List[np.ndarray] = []
        self.keyframe_indices: List[int] = []

    def _build(self, cloud: PointCloud) -> None:
        ndt = self.cfg.ndt
        vmap_ = build_voxel_map(
            cloud, ndt.resolution, leaf_cap=ndt.leaf_cap, lut_extent=ndt.lut_extent,
            min_points_per_voxel=ndt.min_points_per_voxel,
            min_covar_eigvalue_mult=ndt.min_covar_eigvalue_mult, weighted=ndt.weighted,
        )
        self._key_map = LutMap(vmap_, build_lut(vmap_))
        self._key_soa = to_soa(vmap_, self._key_map.lut)

    def _score(self, cloud: PointCloud, transform: torch.Tensor) -> float:
        vmap_, lut = self._key_map
        s, _, _ = ndt_derivatives(
            vmap_, lut, cloud.masked_xyz().contiguous(), cloud.mask.contiguous(), transform.contiguous(),
            self._score_gauss, self._score_offsets, self.cfg.ndt.weighted,
        )
        return float(s)

    def _to_device(self, transform: np.ndarray) -> torch.Tensor:
        return torch.tensor(transform, dtype=torch.float32).to(self.device)

    # -- per-scan entry -------------------------------------------------------
    def process(self, cloud: PointCloud, stamp: float) -> np.ndarray:
        """Track one scan (a cloud on the run's device); returns the odometry
        pose (sensor in the frame of keyframe 0) as a float64 (4, 4). The
        prefiltered cloud, before the scan-matching subsample, stays in
        `filtered` until the next scan."""
        cfg = self.cfg
        if self._prefilter is not None:
            cloud = self._prefilter(cloud)
        self.filtered = cloud
        if self._subsample is not None:
            if self._compact_before_subsample:
                cloud = cloud.compact(cloud.cap)
            cloud = self._subsample(cloud)

        if self.stats.scan_count == 0:
            self._build(cloud)
            self._guess = np.eye(4)
            self._guess[0, 3] = cfg.initial_guess_x
            self._keyframe_stamp = stamp
            self.stats.scan_count = 1
            self.stats.keyframe_count = 1
            self.keyframe_indices.append(0)
            self.poses.append(np.eye(4))
            return np.eye(4)

        t0 = time.perf_counter()
        guess_t = self._to_device(self._guess)
        result = self._align(self._key_soa, cloud, guess_t)
        tf_s2k, iterations = _read_align(result)
        if self.stats.scan_count == 1:
            # the reference aligns scan 1 twice
            result = self._align(self._key_soa, cloud, self._to_device(tf_s2k))
            tf_s2k, iterations = _read_align(result)
        # deviation-triggered wide-basin retry (NDTConfig.retry_*)
        if (
            self._align_retry is not None
            and np.linalg.norm(tf_s2k[:3, 3] - self._guess[:3, 3]) > cfg.ndt.retry_deviation_thresh
        ):
            retry = self._align_retry(self._key_soa, cloud, guess_t)
            if self._score(cloud, retry.transform) > float(result.score):
                result = retry
                tf_s2k, iterations = _read_align(retry)
                self.stats.retries += 1
        self.stats.total_align_time += time.perf_counter() - t0
        self.stats.total_iterations += iterations

        tf_s2s = np.linalg.inv(self._pre_tf_s2k) @ tf_s2k
        odom = self._key_pose @ tf_s2k

        # keyframe gate (scan_matching_odom_nodelet.cpp:240-248)
        dx = np.linalg.norm(tf_s2k[:3, 3])
        qw = np.clip(_rot_qw(tf_s2k[:3, :3]), -1.0, 1.0)
        da = 2.0 * np.arccos(qw)
        dt = stamp - self._keyframe_stamp
        if dx > cfg.keyframe_delta_trans or da > cfg.keyframe_delta_angle or dt > cfg.keyframe_delta_time:
            self._build(cloud)
            self._key_pose = odom
            tf_s2k = np.eye(4)
            self._keyframe_stamp = stamp
            self.stats.keyframe_count += 1
            self.keyframe_indices.append(self.stats.scan_count)

        self._pre_tf_s2k = tf_s2k
        self._guess = tf_s2k @ tf_s2s
        self.stats.scan_count += 1
        self.poses.append(odom)
        return odom

    def process_numpy(self, scan: np.ndarray, stamp: float, cap: int = 131072) -> np.ndarray:
        return self.process(PointCloud.from_numpy(scan, cap=cap, device=self.device), stamp)


def _rot_qw(rot: np.ndarray) -> float:
    """|w| of the quaternion of a rotation matrix (for the 2 acos(w) gate)."""
    tr = np.trace(rot)
    return float(np.sqrt(max(0.0, 1.0 + tr)) / 2.0)


def run_sequence(
    scans,
    stamps=None,
    cfg: Optional[OdometryConfig] = None,
    prefilter_cfg: Optional[PrefilterConfig] = None,
    cap: int = 131072,
    device="cuda",
):
    """Run the DLO over a list of (M, 3|4) numpy scans on `device` (the card
    unless the caller asks for the CPU): ((N, 4, 4) float64 poses, stats)."""
    odo = DirectLidarOdometry(cfg, prefilter_cfg, device=device)
    if stamps is None:
        stamps = [i * 0.1 for i in range(len(scans))]
    poses = [odo.process_numpy(s, t, cap=cap) for s, t in zip(scans, stamps)]
    return np.stack(poses), odo.stats
