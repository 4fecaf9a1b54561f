"""Keyframe registry and the backend's keyframe gate (port of
`lv_slam_tpu.graph.keyframe`, host-side numpy as in the reference).

`KeyFrame` mirrors the reference payload (`include/global_graph/keyframe.hpp:
25-83`), the sensor readings the backend turned into priors included; its
cloud is a port `PointCloud` on the card. The loop detector caches
a keyframe's BoW vector on it as the attribute `bow_vector`. `KeyframeUpdater`
(`include/global_graph/keyframe_updater.hpp:37-61`) registers a frame when
`|dt| >= delta_trans` or `acos(q_w) >= delta_angle` (acos, not 2 acos: the
backend gate differs from the odometry's) and tracks the travelled distance.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from lv_slam_tpu_torch.core.cloud import PointCloud


@dataclasses.dataclass
class KeyFrame:
    stamp: float
    seq: int
    odom: np.ndarray                 # (4,4) odometry pose at creation
    accum_distance: float
    cloud: PointCloud                # windowed, deduplicated cloud
    descriptor: Optional[np.ndarray] = None   # (D,32) uint8 ORB descriptors
    keypoints: Optional[np.ndarray] = None    # (D,2) pixel coords
    node_id: int = -1                # index into the PoseGraph
    estimate: Optional[np.ndarray] = None     # optimized pose (4,4)
    utm_coord: Optional[np.ndarray] = None
    acceleration: Optional[np.ndarray] = None
    orientation: Optional[np.ndarray] = None
    floor_coeffs: Optional[np.ndarray] = None


class KeyframeUpdater:
    def __init__(self, delta_trans: float = 10.0, delta_angle: float = 0.17):
        self.delta_trans = delta_trans
        self.delta_angle = delta_angle
        self.is_first = True
        self.prev_keypose = np.eye(4)
        self.accum_distance = 0.0

    def update(self, pose: np.ndarray) -> bool:
        if self.is_first:
            self.is_first = False
            self.prev_keypose = pose.copy()
            return True
        delta = np.linalg.inv(self.prev_keypose) @ pose
        dx = float(np.linalg.norm(delta[:3, 3]))
        tr = np.trace(delta[:3, :3])
        qw = np.sqrt(max(0.0, 1.0 + tr)) / 2.0
        da = float(np.arccos(np.clip(qw, -1.0, 1.0)))
        if dx < self.delta_trans and da < self.delta_angle:
            return False
        self.accum_distance += dx
        self.prev_keypose = pose.copy()
        return True
