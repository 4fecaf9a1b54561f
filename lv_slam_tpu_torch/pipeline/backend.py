"""Global graph backend: keyframe windows -> loops -> pose-graph LM (port of
`lv_slam_tpu.pipeline.backend.GlobalGraph`, the rebuild of
`GlobalGraphNodelet`, `src/global_graph/global_graph_nodelet.cpp`).

- `add_scan` / `add_scan_batch` = `cloud_callback` (:154-245): every scan's
  odometry is recorded; scans between keyframe triggers are moved into the
  open window's frame and deduplicated at 0.1 m (`pipeline/window.py`:
  kernels 2 and 1b over filtered scans; kernel 2r, the distance band and
  kernel 1's voxel centroid, over a raw chunk); a trigger flushes the window
  into a queued KeyFrame, with the ORB descriptors of the window's first
  image when images come (kernel 12: per keyframe from a host image, or for
  every keyframe a chunk opens in one batched call on a device image
  stack). GPS / IMU / floor readings ride with the scans; the latest one of
  a window goes to its keyframe.
- `optimize` = `optimization_timer_callback` (:670-764): harvest the loop
  verifications dispatched earlier, flush queued keyframes into the graph
  (node + odometry edge + the keyframe's sensor priors), dispatch their
  verifications, add the accepted loop edges, run the LM (kernel 15),
  re-anchor to keyframe 0 and refresh `trans_odom2map`.
- `dump` / `save_map` / `save_pose` = the ROS services (:979-1149), and
  `load_dump` rebuilds a backend from a dump; the files are the
  reference's (`graph/g2o_io.py`, `io/pcd.py`, `io/kitti.py`).

Everything the reference keeps on the host stays on the host (descriptors,
BoW vectors, the graph's arrays); clouds, images and verifications live on
`device`.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from lv_slam_tpu_torch.config import GraphConfig, LoopDetectorConfig, PrefilterConfig
from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.graph import g2o_io, pose_graph as pg
from lv_slam_tpu_torch.graph.information_matrix import calc_information_matrix
from lv_slam_tpu_torch.graph.keyframe import KeyFrame, KeyframeUpdater
from lv_slam_tpu_torch.graph.loop_detector import Loop, LoopDetector
from lv_slam_tpu_torch.graph.map_cloud import generate_map_cloud
from lv_slam_tpu_torch.io import kitti, pcd
from lv_slam_tpu_torch.ops.orb import OrbExtractor
from lv_slam_tpu_torch.pipeline.window import merge_partials, window_flush, window_group, window_group_filtered

_GROUP_CAP = 16  # scans per window group (bounds the group's L * cap rows)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _huber_size(kind: str, size: float) -> float:
    return size if (kind or "NONE").upper() == "HUBER" else 0.0


class GlobalGraph:
    def __init__(
        self,
        cfg: Optional[GraphConfig] = None,
        loop_cfg: Optional[LoopDetectorConfig] = None,
        keyframe_cloud_cap: int = 131072,
        vocabulary=None,
        prefilter_cfg: Optional[PrefilterConfig] = None,
        device="cuda",
        calib_tr: Optional[np.ndarray] = None,
    ):
        self.cfg = cfg or GraphConfig()
        self.loop_cfg = loop_cfg or LoopDetectorConfig()
        # velo->cam calibration Tr (4,4): the dump / save_pose services write
        # camera-frame pose files
        self.tr = np.eye(4) if calib_tr is None else np.asarray(calib_tr, np.float64)
        self.keyframe_cloud_cap = keyframe_cloud_cap
        self.prefilter_cfg = prefilter_cfg or PrefilterConfig()
        self.device = torch.device(device)
        c = self.cfg
        self.graph = pg.empty_graph(c.keyframe_cap, c.edge_cap, c.prior_cap, c.plane_cap, c.sp_edge_cap,
                                    c.plane_edge_cap)
        self.updater = KeyframeUpdater(c.keyframe_delta_trans, c.keyframe_delta_angle)
        self.loop_detector = LoopDetector(self.loop_cfg, vocabulary=vocabulary)

        self.keyframes: List[KeyFrame] = []
        self.new_keyframes: List[KeyFrame] = []
        self.keyframe_queue: List[KeyFrame] = []
        self.loops: List[Loop] = []
        self.pending_loops: List = []  # verifications dispatched, harvested next cycle
        self._graph_dirty = False      # nodes or edges added since the last solve
        self.odoms: Dict[int, np.ndarray] = {}
        self.trans_odom2map = np.eye(4)
        self.zero_utm: Optional[np.ndarray] = None
        self._n_nodes = 0
        self._n_edges = 0
        self._n_priors = 0
        self._n_planes = 0
        self._n_sp_edges = 0
        self._n_plane_edges = 0
        self.floor_plane_node_id: Optional[int] = None
        self.anchor_node_id: Optional[int] = None
        self.anchor_edge_id: Optional[int] = None
        # cumulative host seconds per backend phase ("feed_*", "opt_*"); a
        # phase that reads from the device includes the device work it waits on
        self.timings: Dict[str, float] = {}
        # the last LM's input graph (a copy), iteration cap and result, for
        # re-solving it elsewhere
        self.last_solve: Optional[tuple] = None
        self._orb = OrbExtractor(max_features=self.loop_cfg.descriptor_cap, device=self.device)

        self._w_parts: List[tuple] = []       # per-scan path: (PointCloud, (4,4) rel)
        self._w_partials: List[PointCloud] = []  # batch path: deduplicated groups
        self._w_odom: Optional[np.ndarray] = None
        self._w_seq = -1
        self._w_stamp = 0.0
        self._w_accum = 0.0
        self._w_image: Optional[np.ndarray] = None  # per-scan path: the window's first image
        self._w_orb: Optional[tuple] = None         # batch path: its (descriptors, keypoints)
        self._w_sensors: dict = {}                  # the window's latest GPS / IMU / floor readings

    def _resolution(self) -> float:
        pf = self.prefilter_cfg
        return pf.downsample_resolution if pf.downsample_method.upper() != "NONE" else 0.1

    def _tick(self, key: str, t0: float) -> float:
        now = time.perf_counter()
        self.timings[key] = self.timings.get(key, 0.0) + now - t0
        return now

    # ------------------------------------------------------------------ scans
    def _open_window(self, seq: int, stamp: float, odom: np.ndarray, accum: float, image=None,
                     orb=None) -> None:
        if self._w_odom is not None:
            self._flush_window()
        self._w_parts, self._w_partials = [], []
        self._w_odom = odom
        self._w_seq = seq
        self._w_stamp = float(stamp)
        self._w_accum = accum
        self._w_image = image
        self._w_orb = orb
        self._w_sensors = {}

    def _note_sensors(self, sensors) -> None:
        """The latest reading within a window wins (the JAX reference's rule;
        its ROS original takes the message nearest the keyframe's stamp)."""
        for key, v in (sensors or {}).items():
            if v is not None:
                self._w_sensors[key] = v

    def add_scan(self, seq: int, stamp: float, odom: np.ndarray, cloud: PointCloud,
                 image: Optional[np.ndarray] = None, gps_xyz: Optional[np.ndarray] = None,
                 imu_quat_wxyz: Optional[np.ndarray] = None, imu_acceleration: Optional[np.ndarray] = None,
                 floor_coeffs: Optional[np.ndarray] = None) -> None:
        """One filtered scan with its odometry pose and, optionally, its
        camera image (H, W) in [0, 255] (a keyframe's descriptors come from
        the image of the scan that opens its window) and its sensor readings:
        a GPS position (UTM), an IMU orientation (w, x, y, z) and local
        acceleration, floor coefficients [nx, ny, nz, d]."""
        odom = np.asarray(odom, np.float64)
        self.odoms[seq] = odom
        if self.updater.update(odom):
            self._open_window(seq, stamp, odom, self.updater.accum_distance, image=image)
            self._w_parts = [(cloud, np.eye(4))]
        elif self._w_odom is not None:
            self._w_parts.append((cloud, np.linalg.inv(self._w_odom) @ odom))
        else:
            return
        self._note_sensors(dict(gps=gps_xyz, imu_quat=imu_quat_wxyz, imu_acc=imu_acceleration,
                                floor=floor_coeffs))

    def _window_cloud(self) -> PointCloud:
        """The open window as one deduplicated cloud: the single partial of
        the batch path, or the merge of its partials; the per-scan path's
        parts padded to a power of two (empty masks) and flushed at once."""
        res = self._resolution()
        if self._w_partials:
            parts = self._w_partials
            if len(parts) == 1:
                return parts[0]
            # pad with repeats of the first: dedup-first keeps the earliest
            # point per voxel, so trailing duplicates change nothing
            pad = parts + [parts[0]] * (_pow2(len(parts)) - len(parts))
            return merge_partials(pad, res, self.keyframe_cloud_cap)
        w = len(self._w_parts)
        target = _pow2(w)
        first = self._w_parts[0][0]
        clouds = [c for c, _ in self._w_parts] + [first] * (target - w)
        masks = [c.mask for c, _ in self._w_parts] + [torch.zeros_like(first.mask)] * (target - w)
        rels = np.stack([rel for _, rel in self._w_parts] + [np.eye(4)] * (target - w)).astype(np.float32)
        return window_flush(
            [c.xyz for c in clouds], [c.intensity for c in clouds], masks,
            torch.from_numpy(rels).to(first.xyz.device), res, self.keyframe_cloud_cap,
        )

    def _flush_window(self) -> None:
        cloud = self._window_cloud()
        descriptor = keypoints = None
        if self._w_orb is not None:
            descriptor, keypoints = self._w_orb
        elif self._w_image is not None:
            descriptor, keypoints = self._orb.detect_and_compute(self._w_image)
        kf = KeyFrame(stamp=self._w_stamp, seq=self._w_seq, odom=self._w_odom, accum_distance=self._w_accum,
                      cloud=cloud, descriptor=descriptor, keypoints=keypoints)
        kf.pending_sensors = dict(self._w_sensors)  # become priors when the keyframe enters the graph
        self._w_sensors = {}
        self.keyframe_queue.append(kf)

    def add_scan_batch(self, seq0: int, stamps: np.ndarray, odoms: np.ndarray, chunk: PointCloud,
                       images=None, sensors=None, filtered: bool = False) -> None:
        """C scans as a stacked chunk with host odometry poses (C, 4, 4):
        equivalent to C `add_scan` calls. By default `chunk` holds the raw
        scans, xyz (C, cap, 3), intensity and mask (C, cap): each window
        group is one kernel 2r call (the prefilter's distance band and voxel
        centroid folded into the window; like the reference, the angle
        calibration and the outlier removals are not applied, with a
        warning). With `filtered=True` it is the odometry's filtered product
        (`return_filtered=True`): xyz transposed (C, 3, cap), and each group
        is one kernel 2 call. A window spanning chunks keeps one partial per
        chunk and merges them at its flush.

        `images` is a host list (one optional (H, W) image per scan) or a
        (C, H, W) tensor stack, uint8 on the device in the main path: a
        stack runs ORB for every window-opening scan of the chunk in one
        kernel 12 call, the batch padded to a power of two with repeats.
        `sensors` is one optional dict per scan with the keys `gps`,
        `imu_quat`, `imu_acc` and `floor` (`add_scan`'s readings)."""
        pf = self.prefilter_cfg
        if not filtered and (pf.use_angle_calibration or pf.outlier_removal_method.upper() != "NONE"):
            warnings.warn(
                "add_scan_batch raw-chunk path applies only the distance band + voxel centroid; "
                "use_angle_calibration/outlier_removal_method are dropped - use per-scan add_scan for full "
                "prefiltering",
                stacklevel=2,
            )
        odoms = np.asarray(odoms, np.float64)
        stamps = np.asarray(stamps, np.float64)
        c = odoms.shape[0]
        triggers, accums = [], []
        for i in range(c):
            self.odoms[seq0 + i] = odoms[i]
            triggers.append(self.updater.update(odoms[i]))
            accums.append(self.updater.accum_distance)

        stack = isinstance(images, torch.Tensor)
        orb_batch = {}
        opened = [i for i in range(c) if triggers[i]]
        if stack and opened:
            t0 = time.perf_counter()
            idx = opened + [opened[0]] * (_pow2(len(opened)) - len(opened))
            results = self._orb.detect_and_compute_batch(images[idx])
            orb_batch = dict(zip(opened, results))
            self._tick("feed_orb", t0)

        t0 = time.perf_counter()
        i = 0
        while i < c:
            if triggers[i]:
                image = None if stack or images is None else images[i]
                self._open_window(seq0 + i, stamps[i], odoms[i], accums[i], image=image, orb=orb_batch.get(i))
            j = i + 1
            while j < c and not triggers[j] and j - i < _GROUP_CAP:
                j += 1
            self._append_group(chunk, odoms, i, j, filtered)
            if sensors is not None:
                for k in range(i, j):
                    self._note_sensors(sensors[k])
            i = j
        self._tick("feed_window", t0)
        # this chunk's new keyframes enter the graph now and their
        # verifications are dispatched, to overlap the next chunk's odometry
        self._ingest("feed")

    def _append_group(self, chunk: PointCloud, odoms: np.ndarray, i: int, j: int, filtered: bool) -> None:
        """One window group over chunk scans [i, j), appended to the window."""
        length = j - i
        l2 = _pow2(length)
        rels = np.stack([np.linalg.inv(self._w_odom) @ odoms[k] for k in range(i, j)]
                        + [np.eye(4)] * (l2 - length)).astype(np.float32)
        valid = np.zeros(l2, bool)
        valid[:length] = True
        dev = chunk.xyz.device
        rels_d, valid_d = torch.from_numpy(rels).to(dev), torch.from_numpy(valid).to(dev)
        if filtered:
            part = window_group_filtered(chunk.xyz, chunk.intensity, chunk.mask, i, rels_d, valid_d,
                                         self._resolution(), self.keyframe_cloud_cap)
        else:
            pf = self.prefilter_cfg
            near, far = ((pf.distance_near_thresh, pf.distance_far_thresh) if pf.use_distance_filter
                         else (0.0, float("inf")))
            part = window_group(chunk.xyz, chunk.intensity, chunk.mask, i, rels_d, valid_d, near, far,
                                self._resolution(), self.keyframe_cloud_cap)
        self._w_partials.append(part)

    def finish(self) -> None:
        """Flush the trailing window (the reference's nodelet drops it; the
        port, as its JAX rebuild, keeps it)."""
        if self._w_odom is not None and (self._w_parts or self._w_partials):
            self._flush_window()
            self._w_parts, self._w_partials, self._w_odom = [], [], None

    def drain(self) -> None:
        """Optimize cycles until the keyframe queue is empty and every
        dispatched verification is harvested; only the last cycle solves."""
        while self.keyframe_queue or self.pending_loops:
            self.optimize(lm=not self.keyframe_queue)
        if self._graph_dirty:
            self.optimize()

    # --------------------------------------------------------------- optimize
    def _ingest(self, prefix: str = "opt") -> bool:
        """Flush queued keyframes into the graph and dispatch their loop
        verifications (read back at a later cycle)."""
        t0 = time.perf_counter()
        updated = self._flush_keyframe_queue()
        t0 = self._tick(prefix + "_flush", t0)
        if not updated:
            return False
        self.pending_loops += self.loop_detector.dispatch_verifications(self.keyframes, self.new_keyframes)
        self.keyframes.extend(self.new_keyframes)
        self.new_keyframes = []
        self._graph_dirty = True
        self._tick(prefix + "_dispatch", t0)
        return True

    def optimize(self, num_iterations: Optional[int] = None, lm: bool = True):
        """One `optimization_timer_callback` cycle; returns the LM result, or
        None when nothing changed since the last solve. `lm=False` does all
        but the solve (drain's intermediate cycles)."""
        cfg = self.cfg
        t0 = time.perf_counter()
        loops = self.loop_detector.harvest(self.pending_loops)
        t0 = self._tick("opt_harvest", t0)
        self.pending_loops = []
        self._ingest()
        if loops:
            self._graph_dirty = True
        if not self._graph_dirty:
            return None
        t0 = time.perf_counter()
        for loop in loops:
            info = calc_information_matrix(loop.key1.cloud, loop.key2.cloud, loop.relative_pose, cfg)
            pg.add_se3_edge(self.graph, self._n_edges, loop.key1.node_id, loop.key2.node_id,
                            loop.relative_pose, info,
                            huber=_huber_size(cfg.loop_closure_edge_robust_kernel,
                                              cfg.loop_closure_edge_robust_kernel_size))
            self._n_edges += 1
            self.loops.append(loop)
        t0 = self._tick("opt_loop_edges", t0)
        if not lm:
            return None
        active, k2 = self._active_graph()
        iterations = num_iterations or cfg.solver_num_iterations
        result = pg.optimize_pose_graph(active, iterations, device=self.device)
        self.last_solve = (pg.PoseGraph(*(np.array(a) for a in active)), iterations, result)
        t0 = self._tick("opt_lm_dispatch", t0)
        poses = result.poses.cpu().numpy().astype(np.float64)
        self._tick("opt_lm_fetch", t0)
        self.timings["opt_cycles"] = self.timings.get("opt_cycles", 0.0) + 1.0
        self._graph_dirty = False
        self.graph.poses[:k2] = poses.astype(np.float32)
        if self._n_planes:
            self.graph.planes[:] = result.planes.cpu().numpy()
        for kf in self.keyframes:
            kf.estimate = poses[kf.node_id]
        last = self.keyframes[-1]
        self.trans_odom2map = last.estimate @ np.linalg.inv(last.odom)
        return result

    def _active_graph(self):
        """The graph sliced to power-of-two buckets (at least 8) over the
        active prefix; ids are sequential, so the slice is exact. Plane and
        plane-edge arrays stay whole."""

        def bucket(n: int, cap: int) -> int:
            return min(max(8, _pow2(n)), cap)

        g, c = self.graph, self.cfg
        k2 = bucket(self._n_nodes, c.keyframe_cap)
        e2 = bucket(self._n_edges, c.edge_cap)
        p2 = bucket(self._n_priors, c.prior_cap)
        s2 = bucket(self._n_sp_edges, c.sp_edge_cap)
        active = g._replace(
            poses=g.poses[:k2], node_valid=g.node_valid[:k2], node_fixed=g.node_fixed[:k2],
            e_i=g.e_i[:e2], e_j=g.e_j[:e2], e_meas=g.e_meas[:e2], e_info=g.e_info[:e2],
            e_huber=g.e_huber[:e2], e_valid=g.e_valid[:e2],
            p_node=g.p_node[:p2], p_type=g.p_type[:p2], p_meas=g.p_meas[:p2], p_info=g.p_info[:p2],
            p_huber=g.p_huber[:p2], p_valid=g.p_valid[:p2],
            sp_i=g.sp_i[:s2], sp_plane=g.sp_plane[:s2], sp_meas=g.sp_meas[:s2], sp_info=g.sp_info[:s2],
            sp_huber=g.sp_huber[:s2], sp_valid=g.sp_valid[:s2],
        )
        return active, k2

    def _flush_keyframe_queue(self) -> bool:
        if not self.keyframe_queue:
            return False
        cfg = self.cfg
        odom2map = self.trans_odom2map
        n = min(len(self.keyframe_queue), cfg.max_keyframes_per_update)
        for i in range(n):
            kf = self.keyframe_queue[i]
            kf.node_id = self._n_nodes
            self._n_nodes += 1
            self.new_keyframes.append(kf)
            pose0 = odom2map @ kf.odom
            pg.add_node(self.graph, kf.node_id, pose0)
            kf.estimate = pose0
            if not self.keyframes and len(self.new_keyframes) == 1:
                if cfg.fix_first_node:  # anchor (`global_graph_nodelet.cpp:279-287`)
                    self.anchor_node_id = self._n_nodes
                    self._n_nodes += 1
                    pg.add_node(self.graph, self.anchor_node_id, np.eye(4))
                    pg.set_node_fixed(self.graph, self.anchor_node_id)
                    self.anchor_edge_id = self._n_edges
                    pg.add_se3_edge(self.graph, self._n_edges, self.anchor_node_id, kf.node_id,
                                    np.eye(4), np.eye(6))
                    self._n_edges += 1
                continue
            prev = self.keyframes[-1] if i == 0 and self.keyframes else self.new_keyframes[-2]
            relative = np.linalg.inv(kf.odom) @ prev.odom
            info = calc_information_matrix(prev.cloud, kf.cloud, relative, cfg)
            pg.add_se3_edge(self.graph, self._n_edges, kf.node_id, prev.node_id, relative, info,
                            huber=_huber_size(cfg.odometry_edge_robust_kernel,
                                              cfg.odometry_edge_robust_kernel_size))
            self._n_edges += 1
        for kf in self.new_keyframes[-n:]:  # the priors, now that the nodes exist
            pending = getattr(kf, "pending_sensors", None) or {}
            if "gps" in pending and cfg.enable_gps:
                self.add_gps_prior(kf, np.asarray(pending["gps"]))
            if "imu_quat" in pending and cfg.enable_imu_orientation:
                self.add_imu_orientation_prior(kf, np.asarray(pending["imu_quat"]))
            if "imu_acc" in pending and cfg.enable_imu_acceleration:
                self.add_imu_acceleration_prior(kf, np.asarray(pending["imu_acc"]))
            if "floor" in pending:
                self.add_floor_prior(kf, np.asarray(pending["floor"]))
        del self.keyframe_queue[:n]
        return True

    # ----------------------------------------------------------------- priors
    def add_gps_prior(self, kf: KeyFrame, xyz: np.ndarray) -> None:
        """GPS position prior; the first fix becomes `zero_utm` and every
        measurement is taken relative to it (`global_graph_nodelet.cpp:407-441`)."""
        cfg = self.cfg
        xyz = np.asarray(xyz, np.float64)
        if self.zero_utm is None:
            self.zero_utm = xyz.copy()
        info = np.diag([1.0 / cfg.gps_edge_stddev_xy, 1.0 / cfg.gps_edge_stddev_xy, 1.0 / cfg.gps_edge_stddev_z])
        pg.add_prior(self.graph, self._n_priors, kf.node_id, pg.PRIOR_XYZ, xyz - self.zero_utm, info, huber=1.0)
        self._n_priors += 1
        kf.utm_coord = xyz

    def add_imu_orientation_prior(self, kf: KeyFrame, quat_wxyz: np.ndarray) -> None:
        info = np.eye(3) / self.cfg.imu_orientation_edge_stddev
        pg.add_prior(self.graph, self._n_priors, kf.node_id, pg.PRIOR_QUAT, quat_wxyz, info, huber=1.0)
        self._n_priors += 1
        kf.orientation = np.asarray(quat_wxyz)

    def add_imu_acceleration_prior(self, kf: KeyFrame, acc_local: np.ndarray) -> None:
        """Gravity direction: the world's +z against the measured local
        acceleration's direction."""
        info = np.eye(3) / self.cfg.imu_acceleration_edge_stddev
        meas = np.concatenate([[0.0, 0.0, 1.0], acc_local / max(np.linalg.norm(acc_local), 1e-9)])
        pg.add_prior(self.graph, self._n_priors, kf.node_id, pg.PRIOR_VEC, meas, info, huber=1.0)
        self._n_priors += 1
        kf.acceleration = np.asarray(acc_local)

    def add_floor_prior(self, kf: KeyFrame, coeffs: np.ndarray) -> None:
        """An SE3-plane edge to the one shared, fixed z = 0 floor plane
        (`global_graph_nodelet.cpp:598-612`)."""
        cfg = self.cfg
        if self.floor_plane_node_id is None:
            self.floor_plane_node_id = self._n_planes
            pg.add_plane_node(self.graph, self.floor_plane_node_id, [0.0, 0.0, 1.0, 0.0], fixed=True)
            self._n_planes += 1
        pg.add_se3_plane_edge(self.graph, self._n_sp_edges, kf.node_id, self.floor_plane_node_id, coeffs,
                              np.eye(3) / cfg.floor_edge_stddev,
                              huber=_huber_size(cfg.floor_edge_robust_kernel, cfg.floor_edge_robust_kernel_size))
        self._n_sp_edges += 1
        kf.floor_coeffs = np.asarray(coeffs)

    # --------------------------------------------------------------- services
    def dump(self, directory: str) -> bool:
        """`/global_graph/dump` (:979-1027): graph.g2o and its .kernels,
        one `%06d/` directory per keyframe (data, cloud.pcd), zero_utm,
        special_nodes.csv and the pose files."""
        os.makedirs(directory, exist_ok=True)
        g2o_io.save_graph(os.path.join(directory, "graph.g2o"), self.graph)
        for i, kf in enumerate(self.keyframes):
            kf_dir = os.path.join(directory, f"{i:06d}")
            os.makedirs(kf_dir, exist_ok=True)
            with open(os.path.join(kf_dir, "data"), "w") as f:
                f.write(f"stamp {kf.stamp:.9f}\n")
                f.write(f"seq {kf.seq}\n")
                f.write("odom\n")
                for row in kf.odom:
                    f.write(" ".join(f"{v:.9g}" for v in row) + "\n")
                f.write(f"accum_distance {kf.accum_distance:.9g}\n")
                # the optional sensor lines of the reference's layout (`keyframe.cpp:66-85`)
                for name in ("floor_coeffs", "utm_coord", "acceleration", "orientation"):
                    value = getattr(kf, name)
                    if value is not None:
                        f.write(name + " " + " ".join(f"{v:.9g}" for v in value) + "\n")
                if kf.estimate is not None:
                    f.write("estimate\n")
                    for row in kf.estimate:
                        f.write(" ".join(f"{v:.9g}" for v in row) + "\n")
                f.write(f"id {kf.node_id}\n")
            pcd.write_pcd(os.path.join(kf_dir, "cloud.pcd"), kf.cloud.to_numpy())
        if self.zero_utm is not None:
            with open(os.path.join(directory, "zero_utm"), "w") as f:
                f.write(" ".join(f"{v:.9f}" for v in self.zero_utm) + "\n")
        # real ids (`global_graph_nodelet.cpp:1018-1021`); plane vertices sit
        # at PLANE_ID_OFFSET + index in the g2o file
        anchor_node = -1 if self.anchor_node_id is None else self.anchor_node_id
        anchor_edge = -1 if self.anchor_edge_id is None else self.anchor_edge_id
        floor_node = -1 if self.floor_plane_node_id is None else g2o_io.PLANE_ID_OFFSET + self.floor_plane_node_id
        with open(os.path.join(directory, "special_nodes.csv"), "w") as f:
            f.write(f"anchor_node {anchor_node}\n")
            f.write(f"anchor_edge {anchor_edge}\n")
            f.write(f"floor_node {floor_node}\n")
        self.save_pose(directory)
        return True

    def save_map(self, destination: str, resolution: float = 0.05, utm: bool = False) -> bool:
        """`/global_graph/save_map` (:1035-1070): the map cloud as a PCD;
        `utm=True` offsets it by `zero_utm`, and a `.utm` sidecar holds
        `zero_utm` whenever there is one."""
        if not self.keyframes:
            return False
        poses = [kf.estimate if kf.estimate is not None else kf.odom for kf in self.keyframes]
        points = generate_map_cloud([kf.cloud for kf in self.keyframes], poses, resolution)
        if points.shape[0] == 0:
            return False
        if utm and self.zero_utm is not None:
            points = points.copy()
            points[:, :3] += self.zero_utm
        if self.zero_utm is not None:
            with open(destination + ".utm", "w") as f:
                f.write(" ".join(f"{v:.9f}" for v in self.zero_utm) + "\n")
        pcd.write_pcd(destination, points)
        return True

    def save_pose(self, directory: str) -> None:
        """ggo_kf_odom.txt and ggo_wf_odom.txt (:1077-1149), camera frame.
        The wf file spreads each keyframe's optimization residual over its
        scans by the per-scan fraction of its log (the reference's slerp
        parameter is out of range there, :1131; its JAX rebuild applies the
        intended fraction, and so does the port)."""
        kf_poses = np.stack([kf.estimate if kf.estimate is not None else kf.odom for kf in self.keyframes])
        kitti.write_pose_file(os.path.join(directory, "ggo_kf_odom.txt"), kitti.velo_to_cam_poses(kf_poses, self.tr))
        align = np.linalg.inv(kf_poses[0])
        wf = []
        for i, kf in enumerate(self.keyframes):
            kf_pose = align @ kf_poses[i]
            seq0 = kf.seq
            if seq0 not in self.odoms:
                continue
            odom0 = self.odoms[seq0]
            if i < len(self.keyframes) - 1:
                seq1 = self.keyframes[i + 1].seq
                if seq1 not in self.odoms:
                    continue
                d_pose = np.linalg.inv(kf_pose) @ (align @ kf_poses[i + 1])
                d_odom = np.linalg.inv(odom0) @ self.odoms[seq1]
                resid = np.linalg.inv(d_odom) @ d_pose
            else:
                seq1 = max(self.odoms.keys()) + 1
                resid = np.eye(4)
            span = max(seq1 - seq0, 1)
            resid_log = se3.log_se3(se3.orthonormalize(torch.from_numpy(resid.astype(np.float32))))
            resid_log = np.nan_to_num(resid_log.double().numpy())
            for j in range(seq0, seq1):
                if j not in self.odoms:
                    continue
                pose_s2k = np.linalg.inv(odom0) @ self.odoms[j]
                corr = se3.exp_se3(torch.from_numpy(((j - seq0) / span * resid_log).astype(np.float32)))
                wf.append(kf_pose @ pose_s2k @ corr.double().numpy())
        if wf:
            kitti.write_pose_file(os.path.join(directory, "ggo_wf_odom.txt"),
                                  kitti.velo_to_cam_poses(np.stack(wf), self.tr))


def load_dump(directory: str, cfg: Optional[GraphConfig] = None, loop_cfg: Optional[LoopDetectorConfig] = None,
              keyframe_cloud_cap: int = 131072, device="cuda") -> GlobalGraph:
    """A GlobalGraph rebuilt from a dump directory (the reference's
    `KeyFrame::load` + `GraphSLAM::load` path, `keyframe.cpp:94-201`):
    graph.g2o (+ .kernels) and the `%06d/` keyframe directories, keyframes
    bound to their graph nodes by id, ready for offline re-optimization."""
    backend = GlobalGraph(cfg, loop_cfg, keyframe_cloud_cap=keyframe_cloud_cap, device=device)
    g = backend.cfg
    backend.graph = g2o_io.load_graph(os.path.join(directory, "graph.g2o"), g.keyframe_cap, g.edge_cap,
                                      g.prior_cap, g.plane_cap, g.sp_edge_cap, g.plane_edge_cap)
    gr = backend.graph
    backend._n_edges = int(gr.e_valid.sum())
    backend._n_nodes = int(gr.node_valid.sum())
    backend._n_priors = int(gr.p_valid.sum())
    backend._n_planes = int(gr.plane_valid.sum())
    backend._n_sp_edges = int(gr.sp_valid.sum())
    backend._n_plane_edges = int(gr.q_valid.sum())
    special = os.path.join(directory, "special_nodes.csv")
    if os.path.exists(special):
        with open(special) as f:
            vals = dict(line.split() for line in f if line.strip())
        if int(vals.get("anchor_node", -1)) >= 0:
            backend.anchor_node_id = int(vals["anchor_node"])
        if int(vals.get("anchor_edge", -1)) >= 0:
            backend.anchor_edge_id = int(vals["anchor_edge"])
        if int(vals.get("floor_node", -1)) >= 0:
            backend.floor_plane_node_id = int(vals["floor_node"]) - g2o_io.PLANE_ID_OFFSET
    i = 0
    while os.path.isdir(kf_dir := os.path.join(directory, f"{i:06d}")):
        meta = {}
        with open(os.path.join(kf_dir, "data")) as f:
            lines = [line.rstrip("\n") for line in f]
        j = 0
        while j < len(lines):
            parts = lines[j].split()
            if parts[0] in ("odom", "estimate"):
                meta[parts[0]] = np.asarray([list(map(float, lines[j + k + 1].split())) for k in range(4)])
                j += 5
            else:
                meta[parts[0]] = parts[1:] if len(parts) > 2 else (parts[1] if len(parts) > 1 else None)
                j += 1
        points = pcd.read_pcd(os.path.join(kf_dir, "cloud.pcd"))
        kf = KeyFrame(
            stamp=float(meta.get("stamp", 0.0)), seq=int(meta.get("seq", i)), odom=meta.get("odom", np.eye(4)),
            accum_distance=float(meta.get("accum_distance", 0.0)),
            cloud=PointCloud.from_numpy(points, cap=keyframe_cloud_cap, device=backend.device),
            node_id=int(meta.get("id", i)), estimate=meta.get("estimate"),
        )
        for field in ("floor_coeffs", "utm_coord", "acceleration", "orientation"):
            if meta.get(field) is not None:
                setattr(kf, field, np.asarray([float(v) for v in meta[field]]))
        backend.keyframes.append(kf)
        i += 1
    utm_path = os.path.join(directory, "zero_utm")
    if os.path.exists(utm_path):
        backend.zero_utm = np.loadtxt(utm_path)
    return backend
