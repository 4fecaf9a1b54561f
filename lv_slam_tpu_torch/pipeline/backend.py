"""Global graph backend: keyframe windows -> loops -> pose-graph LM (port of
`lv_slam_tpu.pipeline.backend.GlobalGraph`, the rebuild of
`GlobalGraphNodelet`, `src/global_graph/global_graph_nodelet.cpp`).

- `add_scan` / `add_scan_batch` = `cloud_callback` (:154-245): every scan's
  odometry is recorded; scans between keyframe triggers are moved into the
  open window's frame and deduplicated at 0.1 m (`pipeline/window.py`,
  kernels 2 and 1b); a trigger flushes the window into a queued KeyFrame.
- `optimize` = `optimization_timer_callback` (:670-764): harvest the loop
  verifications dispatched earlier, flush queued keyframes into the graph
  (node + odometry edge), dispatch their verifications, add the accepted
  loop edges, run the LM (kernel 15), re-anchor to keyframe 0 and refresh
  `trans_odom2map`.

This slice is the pure-lidar configuration: `images` must be None (ORB and
BoW are the next slice), and the dump / save_map / sensor-prior services
wait for ROADMAP item 9. Everything the reference keeps on the host stays on
the host; clouds and verifications live on `device`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lv_slam_tpu_torch.config import GraphConfig, LoopDetectorConfig, PrefilterConfig
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.graph import pose_graph as pg
from lv_slam_tpu_torch.graph.information_matrix import calc_information_matrix
from lv_slam_tpu_torch.graph.keyframe import KeyFrame, KeyframeUpdater
from lv_slam_tpu_torch.graph.loop_detector import Loop, LoopDetector
from lv_slam_tpu_torch.pipeline.window import merge_partials, window_flush, window_group_filtered

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
    ):
        self.cfg = cfg or GraphConfig()
        self.loop_cfg = loop_cfg or LoopDetectorConfig()
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
        self._n_nodes = 0
        self._n_edges = 0
        self.anchor_node_id: Optional[int] = None
        self.anchor_edge_id: Optional[int] = None
        # cumulative host seconds per backend phase ("feed_*", "opt_*"); a
        # phase that reads from the device includes the device work it waits on
        self.timings: Dict[str, float] = {}

        self._w_parts: List[tuple] = []       # per-scan path: (PointCloud, (4,4) rel)
        self._w_partials: List[PointCloud] = []  # batch path: deduplicated groups
        self._w_odom: Optional[np.ndarray] = None
        self._w_seq = -1
        self._w_stamp = 0.0
        self._w_accum = 0.0

    def _resolution(self) -> float:
        pf = self.prefilter_cfg
        return pf.downsample_resolution if pf.downsample_method.upper() != "NONE" else 0.1

    def _tick(self, key: str, t0: float) -> float:
        now = time.perf_counter()
        self.timings[key] = self.timings.get(key, 0.0) + now - t0
        return now

    # ------------------------------------------------------------------ scans
    def _open_window(self, seq: int, stamp: float, odom: np.ndarray, accum: float) -> None:
        if self._w_odom is not None:
            self._flush_window()
        self._w_parts, self._w_partials = [], []
        self._w_odom = odom
        self._w_seq = seq
        self._w_stamp = float(stamp)
        self._w_accum = accum

    def add_scan(self, seq: int, stamp: float, odom: np.ndarray, cloud: PointCloud,
                 image: Optional[np.ndarray] = None) -> None:
        """One filtered scan with its odometry pose."""
        if image is not None:
            raise NotImplementedError("camera images (ORB, BoW) come with the ORB slice")
        odom = np.asarray(odom, np.float64)
        self.odoms[seq] = odom
        if self.updater.update(odom):
            self._open_window(seq, stamp, odom, self.updater.accum_distance)
            self._w_parts = [(cloud, np.eye(4))]
        elif self._w_odom is not None:
            self._w_parts.append((cloud, np.linalg.inv(self._w_odom) @ odom))

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
        kf = KeyFrame(stamp=self._w_stamp, seq=self._w_seq, odom=self._w_odom,
                      accum_distance=self._w_accum, cloud=self._window_cloud())
        self.keyframe_queue.append(kf)

    def add_scan_batch(self, seq0: int, stamps: np.ndarray, odoms: np.ndarray, chunk: PointCloud,
                       images=None, sensors=None, filtered: bool = False) -> None:
        """C scans as a stacked chunk with host odometry poses (C, 4, 4):
        equivalent to C `add_scan` calls. `chunk` is the odometry's filtered
        product (`return_filtered=True`): xyz transposed (C, 3, cap),
        intensity and mask (C, cap). Each window group is one kernel 2 call;
        a window spanning chunks keeps one partial per chunk and merges them
        at its flush."""
        if not filtered:
            raise NotImplementedError("add_scan_batch takes the filtered chunk (filtered=True)")
        if images is not None or sensors is not None:
            raise NotImplementedError("images (ORB) and sensor priors come with later slices")
        odoms = np.asarray(odoms, np.float64)
        stamps = np.asarray(stamps, np.float64)
        c = odoms.shape[0]
        triggers, accums = [], []
        for i in range(c):
            self.odoms[seq0 + i] = odoms[i]
            triggers.append(self.updater.update(odoms[i]))
            accums.append(self.updater.accum_distance)

        t0 = time.perf_counter()
        i = 0
        while i < c:
            if triggers[i]:
                self._open_window(seq0 + i, stamps[i], odoms[i], accums[i])
            j = i + 1
            while j < c and not triggers[j] and j - i < _GROUP_CAP:
                j += 1
            self._append_group(chunk, odoms, i, j)
            i = j
        self._tick("feed_window", t0)
        # this chunk's new keyframes enter the graph now and their
        # verifications are dispatched, to overlap the next chunk's odometry
        self._ingest("feed")

    def _append_group(self, chunk: PointCloud, odoms: np.ndarray, i: int, j: int) -> None:
        """One window group over chunk scans [i, j), appended to the window."""
        length = j - i
        l2 = _pow2(length)
        rels = np.stack([np.linalg.inv(self._w_odom) @ odoms[k] for k in range(i, j)]
                        + [np.eye(4)] * (l2 - length)).astype(np.float32)
        valid = np.zeros(l2, bool)
        valid[:length] = True
        dev = chunk.xyz.device
        self._w_partials.append(window_group_filtered(
            chunk.xyz, chunk.intensity, chunk.mask, i, torch.from_numpy(rels).to(dev),
            torch.from_numpy(valid).to(dev), self._resolution(), self.keyframe_cloud_cap,
        ))

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
        result = pg.optimize_pose_graph(active, num_iterations or cfg.solver_num_iterations,
                                        device=self.device)
        t0 = self._tick("opt_lm_dispatch", t0)
        poses = result.poses.cpu().numpy().astype(np.float64)
        self._tick("opt_lm_fetch", t0)
        self.timings["opt_cycles"] = self.timings.get("opt_cycles", 0.0) + 1.0
        self._graph_dirty = False
        self.graph.poses[:k2] = poses.astype(np.float32)
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
        p2 = bucket(0, c.prior_cap)
        s2 = bucket(0, c.sp_edge_cap)
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
        del self.keyframe_queue[:n]
        return True

    def dump(self, directory: str) -> bool:
        raise NotImplementedError("the dump service (g2o, keyframe dirs) is ROADMAP item 9")

    def save_map(self, destination: str, resolution: float = 0.05, utm: bool = False) -> bool:
        raise NotImplementedError("the save_map service is ROADMAP item 9")
