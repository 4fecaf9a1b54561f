"""The per-scan SLAM orchestrator (port of `lv_slam_tpu.pipeline.slam`).

`LvSlam(use_dlo=False)` is the reference's pure `lfa` stack: each raw scan
goes through the LFA (feature extraction, the scan-to-scan feature odometry
and the scan-to-map refinement, `lfa/{odometry,mapping}.py`), and the
refined pose with the raw cloud (and the camera image, when one comes) feeds
`GlobalGraph.add_scan`, which runs loop closure and the pose-graph LM every
`optimize_every` scans. With `use_lfa=False` too, the backend receives
identity odometry, as in the reference.

Not ported yet: the host DLO frontend (`use_dlo=True`, the reference's
default, `odometry/dlo.py` over the LUT NDT path; the next slice), and the
GPS / IMU / floor priors (ROADMAP item 9): they raise `NotImplementedError`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from lv_slam_tpu_torch.config import PipelineConfig
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.lfa.features import extract_features
from lv_slam_tpu_torch.lfa.mapping import FeatureMapping
from lv_slam_tpu_torch.lfa.odometry import FeatureOdometry
from lv_slam_tpu_torch.pipeline.backend import GlobalGraph


class LvSlam:
    def __init__(
        self,
        cfg: Optional[PipelineConfig] = None,
        use_dlo: bool = True,
        use_lfa: bool = True,
        optimize_every: int = 100,
        scan_cap: int = 131072,
        vocabulary=None,
        device="cuda",
    ):
        if use_dlo:
            raise NotImplementedError(
                "the host DLO frontend (odometry/dlo.py over the LUT NDT path) is the next slice of the "
                "port; pass use_dlo=False for the pure LFA stack"
            )
        self.cfg = cfg or PipelineConfig()
        self.device = torch.device(device)
        self.use_dlo = use_dlo
        self.use_lfa = use_lfa and self.cfg.lfa is not None
        self.optimize_every = optimize_every
        self.scan_cap = scan_cap

        if self.use_lfa:
            self.feature_odometry = FeatureOdometry(self.cfg.lfa, device=self.device)
            self.mapping = FeatureMapping(self.cfg.lfa, device=self.device)
        tr = None
        if self.cfg.calib_tr is not None:
            tr = np.eye(4)
            tr[:3, :4] = np.asarray(self.cfg.calib_tr, np.float64).reshape(3, 4)
        self.backend = GlobalGraph(self.cfg.graph, self.cfg.loop, calib_tr=tr, vocabulary=vocabulary,
                                   device=self.device)

        self._seq = 0
        self.dlo_poses: List[np.ndarray] = []
        self.lfa_poses: List[np.ndarray] = []

    def process(
        self,
        scan: np.ndarray,
        stamp: float,
        image: Optional[np.ndarray] = None,
        gps_xyz: Optional[np.ndarray] = None,
        imu_quat_wxyz: Optional[np.ndarray] = None,
        imu_acceleration: Optional[np.ndarray] = None,
        detect_floor: bool = False,
    ) -> np.ndarray:
        """One raw (M,3|4) scan in -> current odometry pose out. `image` is
        the scan's camera image (H, W) in [0, 255]; a keyframe's descriptors
        come from the image of the scan that opens its window."""
        if detect_floor or gps_xyz is not None or imu_quat_wxyz is not None or imu_acceleration is not None:
            raise NotImplementedError("the GPS / IMU / floor priors of the backend are ROADMAP item 9")
        cloud = PointCloud.from_numpy(scan, cap=self.scan_cap, device=self.device)

        odom = np.eye(4)
        if self.use_lfa:
            feats = extract_features(cloud, self.cfg.lfa)
            odom = self.feature_odometry.process(feats)
            refined = self.mapping.process(feats, odom)
            self.lfa_poses.append(refined)
            odom = refined

        # without the DLO prefilter the backend receives the raw cloud
        self.backend.add_scan(self._seq, stamp, odom, cloud, image=image)
        self._seq += 1
        if self._seq % self.optimize_every == 0:
            self.backend.optimize()
        return odom

    def finalize(self):
        """Flush the trailing keyframe window and run a final optimization."""
        self.backend.finish()
        result = None
        while self.backend.keyframe_queue or self.backend.pending_loops:
            out = self.backend.optimize()
            result = out if out is not None else result
        return result

    def trajectory(self) -> np.ndarray:
        """Optimized keyframe trajectory (K,4,4)."""
        return np.stack([
            kf.estimate if kf.estimate is not None else kf.odom
            for kf in self.backend.keyframes
        ]) if self.backend.keyframes else np.zeros((0, 4, 4))
