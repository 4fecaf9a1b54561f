"""The per-scan SLAM orchestrator (port of `lv_slam_tpu.pipeline.slam`), the
reference's `dlo_lfa_ggo` stack.

By default (`use_dlo=True`) each raw scan goes through the host DLO frontend
(`odometry/dlo.DirectLidarOdometry`: prefilter, LUT NDT scan-to-keyframe
align), whose pose seeds the LFA's scan-to-map refinement
(`lfa/mapping.py`), and the refined pose with the prefiltered cloud (and the
camera image, when one comes) feeds `GlobalGraph.add_scan`, which runs loop
closure and the pose-graph LM every `optimize_every` scans.
`use_dlo=False` is the pure `lfa` stack: the LFA's own scan-to-scan feature
odometry seeds the mapping, and the backend receives the raw cloud. With
`use_lfa=False` the backend receives the DLO pose (or, without the DLO
too, identity odometry), as in the reference. GPS, IMU and floor readings
(`detect_floor=True` fits the floor on the cloud the backend receives,
kernel 16) go with the scan to the backend, which turns them into priors of
the keyframe the scan belongs to.
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
from lv_slam_tpu_torch.odometry.dlo import DirectLidarOdometry
from lv_slam_tpu_torch.ops import floor
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
        self.cfg = cfg or PipelineConfig()
        self.device = torch.device(device)
        self.use_dlo = use_dlo
        self.use_lfa = use_lfa and self.cfg.lfa is not None
        self.optimize_every = optimize_every
        self.scan_cap = scan_cap

        self.dlo = (
            DirectLidarOdometry(self.cfg.odometry, self.cfg.prefilter, device=self.device) if use_dlo else None
        )
        if self.use_lfa:
            self.feature_odometry = None if use_dlo else FeatureOdometry(self.cfg.lfa, device=self.device)
            self.mapping = FeatureMapping(self.cfg.lfa, device=self.device)
        tr = None
        if self.cfg.calib_tr is not None:
            tr = np.eye(4)
            tr[:3, :4] = np.asarray(self.cfg.calib_tr, np.float64).reshape(3, 4)
        self.backend = GlobalGraph(self.cfg.graph, self.cfg.loop, calib_tr=tr, vocabulary=vocabulary,
                                   device=self.device)

        self._seq = 0
        self.last_floor: Optional[floor.FloorResult] = None  # the last scan's floor fit, with `detect_floor`
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
        come from the image of the scan that opens its window. The sensor
        readings (`global_graph_nodelet.cpp:314-627`) and, with
        `detect_floor`, the floor found on the backend's cloud become priors
        of the keyframe this scan belongs to."""
        cloud = PointCloud.from_numpy(scan, cap=self.scan_cap, device=self.device)

        odom = np.eye(4)
        if self.dlo is not None:
            odom = self.dlo.process(cloud, stamp)
            self.dlo_poses.append(odom)

        if self.use_lfa:
            feats = extract_features(cloud, self.cfg.lfa)
            if self.feature_odometry is not None:
                odom = self.feature_odometry.process(feats)
            refined = self.mapping.process(feats, odom)
            self.lfa_poses.append(refined)
            odom = refined

        # the backend receives the prefiltered cloud, like /filtered_points
        # (the reference prefilters the raw cloud once more here; the DLO's
        # product of this scan is the same tensor content, `prefilter` being
        # deterministic, so it is reused), else the raw cloud
        filtered = self.dlo.filtered if (self.dlo is not None and self.dlo._prefilter is not None) else cloud
        floor_coeffs = None
        if detect_floor:
            self.last_floor = floor.detect_floor(filtered)
            if bool(self.last_floor.found):
                floor_coeffs = self.last_floor.coeffs.cpu().numpy()
        self.backend.add_scan(self._seq, stamp, odom, filtered, image=image, gps_xyz=gps_xyz,
                              imu_quat_wxyz=imu_quat_wxyz, imu_acceleration=imu_acceleration,
                              floor_coeffs=floor_coeffs)
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
