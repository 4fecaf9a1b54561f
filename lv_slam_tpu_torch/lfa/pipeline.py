"""LFA pipeline: feature extraction -> scan-to-scan odometry -> scan-to-map
(port of `lv_slam_tpu.lfa.pipeline`).

The reference's "lfa" stage is the external A-LOAM process chain
`ascanRegistration -> alaserOdometry -> alaserMapping`
(`launch/dlo_lfa_ggo_kitti.launch:55-81`), whose `/aft_mapped_to_init`
output feeds the global graph. Here the three processes collapse into one
host driver over the device: kernel 8 per scan, then `FeatureOdometry` and
`FeatureMapping`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from lv_slam_tpu_torch.config import LfaConfig
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.lfa.features import extract_features
from lv_slam_tpu_torch.lfa.mapping import FeatureMapping
from lv_slam_tpu_torch.lfa.odometry import FeatureOdometry


class LfaPipeline:
    """One scan in, one refined world pose out; the maps and grids live on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: Optional[LfaConfig] = None, device="cuda"):
        self.cfg = cfg or LfaConfig()
        self.device = torch.device(device)
        self.odometry = FeatureOdometry(self.cfg, device=self.device)
        self.mapping = FeatureMapping(self.cfg, device=self.device)
        self.poses: List[np.ndarray] = []

    def process(self, cloud: PointCloud) -> np.ndarray:
        """One scan in (sensor frame) -> refined world pose out."""
        feats = extract_features(cloud, self.cfg)
        odom = self.odometry.process(feats)
        pose = self.mapping.process(feats, odom)
        self.poses.append(pose)
        return pose

    def process_numpy(self, scan: np.ndarray, cap: int = 131072) -> np.ndarray:
        return self.process(PointCloud.from_numpy(scan, cap=cap, device=self.device))
