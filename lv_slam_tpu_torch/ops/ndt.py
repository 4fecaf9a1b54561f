"""NDT constants and result type (port of `lv_slam_tpu.ops.ndt`, the parts
the hash-table path uses)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GaussParams(NamedTuple):
    d1: float
    d2: float
    d3: float


def make_gauss_params(resolution: float, outlier_ratio: float = 0.55) -> GaussParams:
    """Magnusson eq. 6.8 mixture constants, rounded through float32 at the
    same steps as the reference. They are host floats: the kernel takes them
    by value, so reading them costs no device round trip."""

    def f32(x) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32)

    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / resolution**3
    d3 = -torch.log(f32(c2))
    d1 = -torch.log(f32(c1 + c2)) - d3
    d2 = -2.0 * torch.log((-torch.log(f32(c1) * f32(math.exp(-0.5)) + c2) - d3) / d1)
    return GaussParams(float(d1), float(d2), float(d3))


class NDTResult(NamedTuple):
    transform: torch.Tensor          # (4,4) final source->target transform
    score: torch.Tensor              # () summed mixture score at the final pose
    iterations: int                  # Newton iterations, coarse phase included
    converged: bool
    hessian: torch.Tensor            # (6,6) at the final pose
    trans_probability: torch.Tensor  # () score / n_points
