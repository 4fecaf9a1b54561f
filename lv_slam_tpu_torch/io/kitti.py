"""KITTI pose files and the odometry devkit's relative translation/rotation
error (`evaluate_odometry_seq`), as `lv_slam_tpu.io.kitti` writes and
computes them (numpy).

Pose files hold 12-value rows written with `%le` formatting, like the
backend's kf/wf dumps (`global_graph_nodelet.cpp:1089-1148`); odometry poses
are conjugated into the camera frame with the calibration `Tr` (velo->cam):
`pose_cam = Tr @ pose_velo @ Tr^-1`.
"""

from __future__ import annotations

import os

import numpy as np


def write_pose_file(path: str, poses: np.ndarray) -> None:
    """Write (N,4,4) poses as KITTI rows with `%le` formatting."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for pose in poses:
            row = pose[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:e}" for v in row) + "\n")


def read_pose_file(path: str) -> np.ndarray:
    """Read a KITTI pose file -> (N,4,4)."""
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    out = np.tile(np.eye(4, dtype=np.float64), (rows.shape[0], 1, 1))
    out[:, :3, :4] = rows
    return out


def velo_to_cam_poses(poses_velo: np.ndarray, tr: np.ndarray) -> np.ndarray:
    """pose_cam = Tr @ pose_velo @ Tr^-1 (scan_matching_odom_nodelet.cpp:156-160)."""
    tr_inv = np.linalg.inv(tr)
    return np.einsum("ij,njk,kl->nil", tr, poses_velo, tr_inv)

_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def _trajectory_distances(poses: np.ndarray) -> np.ndarray:
    d = np.zeros(len(poses))
    d[1:] = np.cumsum(np.linalg.norm(poses[1:, :3, 3] - poses[:-1, :3, 3], axis=1))
    return d


def kitti_seq_error(gt: np.ndarray, est: np.ndarray, step: int = 10, lengths=None):
    """(t_err, r_err) averaged over every subsequence of the devkit lengths;
    `lengths` replaces the 100-800 m segments for short runs."""
    assert len(gt) == len(est)
    dist = _trajectory_distances(gt)
    errs_t, errs_r = [], []
    for first in range(0, len(gt), step):
        for seg_len in lengths or _LENGTHS:
            last = int(np.searchsorted(dist, dist[first] + seg_len))
            if last >= len(gt):
                continue
            pose_delta_gt = np.linalg.inv(gt[first]) @ gt[last]
            pose_delta_est = np.linalg.inv(est[first]) @ est[last]
            pose_error = np.linalg.inv(pose_delta_est) @ pose_delta_gt
            r_err = np.arccos(np.clip((np.trace(pose_error[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))
            errs_t.append(np.linalg.norm(pose_error[:3, 3]) / seg_len)
            errs_r.append(r_err / seg_len)
    if not errs_t:
        return float("nan"), float("nan")
    return float(np.mean(errs_t)), float(np.mean(errs_r))
