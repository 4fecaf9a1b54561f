"""The KITTI odometry devkit's relative translation/rotation error
(`evaluate_odometry_seq`), as `lv_slam_tpu.io.kitti.kitti_seq_error`
computes it (numpy)."""

from __future__ import annotations

import numpy as np

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
