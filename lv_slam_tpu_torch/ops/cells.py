"""Voxel cell coordinates, shared by every module that keys points by cell
(the prefilter, the voxel maps, the grids)."""

from __future__ import annotations

import numpy as np
import torch


def inv_resolution(resolution: float) -> float:
    """The float32 reciprocal that cell keys multiply by.

    The reference's compiled programs hold the resolution as a constant, and
    XLA rewrites `x / const` into `x * (1/const)` with the reciprocal rounded
    to float32 (10.0 for 0.1). `floor(x * 10.0)` and `floor(x / 0.1)` differ
    for points within an ulp of a cell face, so the port multiplies by the
    same reciprocal to put every point in the reference's voxel."""
    return float(np.float32(1.0) / np.float32(resolution))


def cell_coords(xyz: torch.Tensor, resolution: float) -> torch.Tensor:
    """int32 voxel coordinates `floor(xyz * (1/res))`."""
    inv = torch.full((1,), inv_resolution(resolution), dtype=xyz.dtype, device=xyz.device)
    return torch.floor(xyz * inv).to(torch.int32)
