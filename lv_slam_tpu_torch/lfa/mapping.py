"""LFA scan-to-map feature refinement, the host driver (alaserMapping
equivalent; port of `lv_slam_tpu.lfa.mapping`).

The world edge/surf feature maps are fixed-capacity point buffers
(`map_edge_cap`, `map_planar_cap`). Each mapped scan rebuilds both maps'
hashed cell tables from the buffers (kernel 9c), registers this scan's
less-sharp/less-flat features against them with `mapping_corr_rounds` rounds
of (radius-gated line/plane fits, kernel 10 -> Gauss-Newton, kernel 11),
seeded by the scan-to-scan odometry increment; every scan then merges its
world-frame features into the buffers (dedup-first at the mapping
resolutions, kernel 1b) and crops them to a radius around the pose. Scans
between `mapping_skip_frame` strides take the odometry increment on the
last refined pose. This is the reference's host algorithm: whole-map
rebuilds and merges every scan, where the device-resident step
(`lfa/fused.py`) inserts incrementally.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lv_slam_tpu_torch.config import LfaConfig
from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
from lv_slam_tpu_torch.lfa import registration as reg
from lv_slam_tpu_torch.lfa.features import FeatureClouds
from lv_slam_tpu_torch.lfa.fused import _GRID_CELL, _n_buckets
from lv_slam_tpu_torch.ops.knn import build_cell_table
from lv_slam_tpu_torch.ops.linalg3 import dot3_fma, sqrt32
from lv_slam_tpu_torch.ops.prefilter import voxel_dedup_first


def _map_step(guess, edges, edges_mask, surfs, surfs_mask, edge_grid, surf_grid, rounds: int, iters: int):
    t = guess
    lines = planes = None
    for _ in range(rounds):
        lines = reg.lines_from_fit(se3.transform_points(t, edges), edges_mask, edge_grid)
        planes = reg.planes_from_fit(se3.transform_points(t, surfs), surfs_mask, surf_grid)
        t = reg.gn_solve(t, edges, lines, surfs, planes, iters)
    n_e, n_s = reg.match_counts(lines, planes)
    return t, n_e, n_s


def _merge_map(map_xyz, map_mask, new_xyz, new_mask, resolution: float):
    """Concatenate and voxel-dedup back into the fixed-capacity buffer
    (dedup-first: the map wins over the new scan)."""
    xyz = torch.cat([map_xyz, new_xyz])
    mask = torch.cat([map_mask, new_mask])
    cloud = PointCloud(torch.where(mask[:, None], xyz, SENTINEL), torch.zeros_like(xyz[:, 0]), mask)
    out = voxel_dedup_first(cloud, resolution, map_xyz.shape[0])
    return out.xyz, out.mask


def _crop_map(map_xyz, map_mask, center, radius: float):
    """Keep the points within `radius` of `center` (the distance rounded as
    XLA's CPU fma chain rounds the reference's `jnp.linalg.norm`)."""
    d = map_xyz - center
    keep = map_mask & (sqrt32(dot3_fma(d, d)) < radius)
    return torch.where(keep[:, None], map_xyz, SENTINEL), keep


class FeatureMapping:
    """Host driver holding the persistent feature maps on `device`."""

    def __init__(self, cfg: Optional[LfaConfig] = None, crop_radius: Optional[float] = None, device="cuda"):
        self.cfg = c = cfg or LfaConfig()
        self.crop_radius = crop_radius if crop_radius is not None else c.crop_radius
        self.device = dev = torch.device(device)
        self._edge_map = torch.full((c.map_edge_cap, 3), SENTINEL, dtype=torch.float32, device=dev)
        self._edge_mask = torch.zeros((c.map_edge_cap,), dtype=torch.bool, device=dev)
        self._surf_map = torch.full((c.map_planar_cap, 3), SENTINEL, dtype=torch.float32, device=dev)
        self._surf_mask = torch.zeros((c.map_planar_cap,), dtype=torch.bool, device=dev)
        self._pose = np.eye(4)
        self._last_odom = np.eye(4)
        self._initialized = False
        # the cell tables' sizes: those of the device-resident step
        self._edge_buckets = _n_buckets(c, c.map_edge_cap)
        self._surf_buckets = _n_buckets(c, c.map_planar_cap)
        self._count = 0

    @property
    def pose(self) -> np.ndarray:
        return self._pose.copy()

    def process(self, feats: FeatureClouds, odom: np.ndarray) -> np.ndarray:
        """feats: this scan's features (sensor frame); odom: the scan-to-scan
        odometry pose. Returns the refined world pose (the reference's
        /aft_mapped_to_init equivalent)."""
        cfg = self.cfg
        # seed: the previous refined pose composed with the odometry increment
        # (A-LOAM's transformAssociateToMap)
        guess = self._pose @ (np.linalg.inv(self._last_odom) @ odom)
        self._last_odom = odom.copy()

        if self._initialized and self._count % max(cfg.mapping_skip_frame, 1) == 0:
            edge_grid = build_cell_table(self._edge_map, self._edge_mask, _GRID_CELL, self._edge_buckets,
                                         cfg.knn_slots)
            surf_grid = build_cell_table(self._surf_map, self._surf_mask, _GRID_CELL, self._surf_buckets,
                                         cfg.knn_slots)
            refined, _, _ = _map_step(
                torch.from_numpy(guess.astype(np.float32)).to(self.device),
                feats.less_sharp, feats.less_sharp_mask, feats.less_flat, feats.less_flat_mask,
                edge_grid, surf_grid, cfg.mapping_corr_rounds, cfg.mapping_max_iterations,
            )
            self._pose = refined.cpu().numpy().astype(np.float64)
        else:
            self._pose = guess

        # merge this scan's world-frame features into the maps, then crop
        t = torch.from_numpy(self._pose.astype(np.float32)).to(self.device)
        self._edge_map, self._edge_mask = _merge_map(
            self._edge_map, self._edge_mask, se3.transform_points_fma(t, feats.less_sharp),
            feats.less_sharp_mask, cfg.mapping_line_resolution,
        )
        self._surf_map, self._surf_mask = _merge_map(
            self._surf_map, self._surf_mask, se3.transform_points_fma(t, feats.less_flat),
            feats.less_flat_mask, cfg.mapping_plane_resolution,
        )
        center = t[:3, 3]
        self._edge_map, self._edge_mask = _crop_map(self._edge_map, self._edge_mask, center, self.crop_radius)
        self._surf_map, self._surf_mask = _crop_map(self._surf_map, self._surf_mask, center, self.crop_radius)
        self._initialized = True
        self._count += 1
        return self._pose.copy()
