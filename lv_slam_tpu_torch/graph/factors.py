"""Pose-graph factor residuals (port of `lv_slam_tpu.graph.factors`: the SE3
edge and the robust weights; the prior and plane factors come with ROADMAP
item 9).

The SE3 edge follows `g2o::EdgeSE3` (`graph_slam.cpp:136-147`): error =
[t, 2 q_xyz] of delta = Z^-1 (Ti^-1 Tj), with the unit quaternion's w >= 0.
The factor 2 makes the rotation block approximate the rotation vector, so
the reference's sigma_q keeps its published meaning.
"""

from __future__ import annotations

import torch

from lv_slam_tpu_torch.core import se3


def se3_edge_residual(t_i: torch.Tensor, t_j: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """(..., 6) EdgeSE3 error of poses (..., 4, 4) under measurement (..., 4, 4)."""
    delta = se3.inverse(meas) @ se3.inverse(t_i) @ t_j
    q = se3.quat_from_matrix(delta[..., :3, :3])
    return torch.cat([delta[..., :3, 3], 2.0 * q[..., 1:]], dim=-1)


def huber_weight(chi: torch.Tensor, delta) -> torch.Tensor:
    """Huber IRLS weight on chi = sqrt(r^T Omega r): 1 inside, delta/chi
    outside (g2o RobustKernelHuber)."""
    return torch.where(chi <= delta, 1.0, delta / torch.clamp(chi, min=1e-12))


def robust_weight(kind: str, chi: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights of the robust kernels the reference exposes
    (`launch/dlo_lfa_ggo_kitti.launch:129`; only Huber is used)."""
    kind = (kind or "NONE").upper()
    d = torch.tensor(delta, dtype=torch.float32, device=chi.device)
    safe = torch.clamp(chi, min=1e-12)
    if kind == "NONE":
        return torch.ones_like(chi)
    if kind == "HUBER":
        return huber_weight(chi, d)
    if kind == "CAUCHY":
        return 1.0 / (1.0 + (safe / d) ** 2)
    if kind in ("PSEUDOHUBER", "PSEUDO_HUBER"):
        return 1.0 / torch.sqrt(1.0 + (safe / d) ** 2)
    if kind == "FAIR":
        return 1.0 / (1.0 + safe / d)
    if kind in ("GEMANMCCLURE", "GM"):
        return 1.0 / (1.0 + (safe / d) ** 2) ** 2
    if kind == "WELSCH":
        return torch.exp(-((safe / d) ** 2))
    if kind == "TUKEY":
        return torch.where(safe <= d, (1.0 - (safe / d) ** 2) ** 2, 0.0)
    if kind == "SATURATED":
        return torch.clamp((d / safe) ** 2, max=1.0)
    if kind == "DCS":
        return torch.clamp(2.0 * d / (d + safe**2), max=1.0)
    raise ValueError(f"unknown robust kernel {kind!r}")
