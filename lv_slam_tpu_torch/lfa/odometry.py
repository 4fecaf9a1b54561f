"""LFA scan-to-scan feature odometry, the host driver (alaserOdometry
equivalent; port of `lv_slam_tpu.lfa.odometry`).

Per scan: register the current sharp/flat features against the previous
scan's less-sharp/less-flat grids (kernel 9g) with 2 rounds of
(2-point lines / 3-point planes, kernel 9k -> 4 Gauss-Newton iterations,
kernel 11), warm-started by the previous relative motion (A-LOAM's
constant-velocity assumption). The rounds and iterations are the
reference's fixed 2 x 4, not the `LfaConfig` fields the device-resident
step reads, and the relative motion is not re-orthonormalized: the host
driver is its own algorithm, as in the reference. The pose accumulates on
the host in float64, so each scan reads its relative motion back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lv_slam_tpu_torch.config import LfaConfig
from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.lfa import registration as reg
from lv_slam_tpu_torch.lfa.features import FeatureClouds
from lv_slam_tpu_torch.ops.knn import build_grid

_GRID_CELL = 2.0  # m: the grids' cell, and the cell tables' (the 8-cell probe covers the 1 m fit gates)


def odom_step(guess: torch.Tensor, feats: FeatureClouds, prev_edge_grid, prev_surf_grid, rounds: int,
              iters: int) -> torch.Tensor:
    """The scan-to-scan solve from `guess`: `rounds` times, the 2-point
    lines and 3-point planes of this scan's sharp / flat features against
    the previous scan's grids, then `iters` Gauss-Newton iterations."""
    t = guess
    for _ in range(rounds):
        lines = reg.lines_from_2nn(se3.transform_points(t, feats.sharp), feats.sharp_mask, prev_edge_grid)
        planes = reg.planes_from_3nn(se3.transform_points(t, feats.flat), feats.flat_mask, prev_surf_grid)
        t = reg.gn_solve(t, feats.sharp, lines, feats.flat, planes, iters)
    return t


def feature_grids(feats: FeatureClouds):
    """(less-sharp grid, less-flat grid): the next scan's solve targets."""
    return (
        build_grid(feats.less_sharp, feats.less_sharp_mask, _GRID_CELL),
        build_grid(feats.less_flat, feats.less_flat_mask, _GRID_CELL),
    )


class FeatureOdometry:
    """Host driver holding the previous scan's feature grids on `device`."""

    def __init__(self, cfg: Optional[LfaConfig] = None, device="cuda"):
        self.cfg = cfg or LfaConfig()
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        self._prev_edge_grid = None
        self._prev_surf_grid = None
        self._pose = np.eye(4)
        self._last_rel = np.eye(4)

    def process(self, feats: FeatureClouds) -> np.ndarray:
        """Returns the accumulated odometry pose (4,4) after this scan."""
        if self._prev_edge_grid is None:
            self._prev_edge_grid, self._prev_surf_grid = feature_grids(feats)
            return self._pose.copy()
        guess = torch.from_numpy(self._last_rel.astype(np.float32)).to(self.device)
        rel = odom_step(guess, feats, self._prev_edge_grid, self._prev_surf_grid, 2, 4)
        rel_np = rel.cpu().numpy().astype(np.float64)
        self._pose = self._pose @ rel_np
        self._last_rel = rel_np
        self._prev_edge_grid, self._prev_surf_grid = feature_grids(feats)
        return self._pose.copy()
