"""Edge information matrices (port of `lv_slam_tpu.graph.information_matrix`,
`information_matrix_calculator.cpp:27-87`).

- constant mode (the flagship): info = diag(1/sx I3, 1/sq I3), dividing by
  the stddev as the reference does;
- fitness mode: the fitness of cloud2 moved by relpose onto cloud1
  (kernel 14's `fitness_score`) through the saturating exponential
  `w(x) = min + (max-min) (1 - e^{-a x}) / (1 - e^{-a x_max})` applied to
  the variances, info = diag(1/w_x I3, 1/w_q I3).
"""

from __future__ import annotations

import numpy as np
import torch

from lv_slam_tpu_torch.config import GraphConfig
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.ops.nn import fitness_score


def _weight(a, max_x, min_y, max_y, x):
    x = min(x, max_x)
    y = (1.0 - np.exp(-a * x)) / (1.0 - np.exp(-a * max_x))
    return min_y + (max_y - min_y) * y


def constant_information(cfg: GraphConfig) -> np.ndarray:
    info = np.eye(6, dtype=np.float32)
    info[:3, :3] /= cfg.const_stddev_x
    info[3:, 3:] /= cfg.const_stddev_q
    return info


def calc_information_matrix(cloud1: PointCloud, cloud2: PointCloud, relpose, cfg: GraphConfig) -> np.ndarray:
    if cfg.use_const_inf_matrix:
        return constant_information(cfg)
    rel = torch.as_tensor(np.asarray(relpose, np.float32)).to(cloud1.xyz.device)
    fitness = float(fitness_score(cloud1, cloud2, rel))
    max_x = cfg.fitness_score_max_range if np.isfinite(cfg.fitness_score_max_range) else 2.5
    a = cfg.var_gain_a
    w_x = _weight(a, max_x, cfg.min_stddev_x**2, cfg.max_stddev_x**2, fitness)
    w_q = _weight(a, max_x, cfg.min_stddev_q**2, cfg.max_stddev_q**2, fitness)
    info = np.eye(6, dtype=np.float32)
    info[:3, :3] /= w_x
    info[3:, 3:] /= w_q
    return info
