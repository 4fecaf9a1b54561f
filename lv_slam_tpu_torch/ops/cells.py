"""Voxel cell coordinates, shared by every module that keys points by cell
(the prefilter, the voxel maps, the grids, the cell tables, the probes).

The cell rule: a cell coordinate is `floor(ftz(ftz(x) * inv))`, or
`floor(ftz(ftz(x) / d))` where the reference divides truly, with `ftz(v)` 0
where |v| < FLT_MIN and `v` otherwise. The reference's compiled programs
flush subnormal inputs and results to zero (XLA's CPU code and the TPU
alike), so a negative subnormal coordinate, or a normal one whose product
with a reciprocal below 1 is subnormal, lies in cell 0 there and would lie
in cell -1 without the flushes. The port flushes explicitly, here and in
the kernels (`csrc/common.cuh` `lvs::cell_floor`), and nowhere else: no
global flush-to-zero flag or mode, which would move other bits."""

from __future__ import annotations

import numpy as np
import torch

FLT_MIN = float(np.finfo(np.float32).tiny)  # the least normal float32


def inv_resolution(resolution: float) -> float:
    """The float32 reciprocal that cell keys multiply by.

    The reference's compiled programs hold the resolution as a constant, and
    XLA rewrites `x / const` into `x * (1/const)` with the reciprocal rounded
    to float32 (10.0 for 0.1). `floor(x * 10.0)` and `floor(x / 0.1)` differ
    for points within an ulp of a cell face, so the port multiplies by the
    same reciprocal to put every point in the reference's voxel."""
    return float(np.float32(1.0) / np.float32(resolution))


def ftz(v: torch.Tensor) -> torch.Tensor:
    """`v` with its subnormal entries flushed to +0 (NaN and infinities kept)."""
    return torch.where(v.abs() < FLT_MIN, torch.zeros_like(v), v)


def floor_cells(xyz: torch.Tensor, inv) -> torch.Tensor:
    """float32 `floor(ftz(ftz(xyz) * inv))` (`inv` a tensor or a float)."""
    return torch.floor(ftz(ftz(xyz) * inv))


def floor_cells_div(xyz: torch.Tensor, d: float) -> torch.Tensor:
    """float32 `floor(ftz(ftz(xyz) / d))`, a true float32 division on every
    device (`linalg3._div`)."""
    return torch.floor(ftz(ftz(xyz) / xyz.new_full((), d)))


def cell_coords(xyz: torch.Tensor, resolution: float) -> torch.Tensor:
    """int32 voxel coordinates `floor(ftz(ftz(xyz) * (1/res)))`."""
    inv = torch.full((1,), inv_resolution(resolution), dtype=xyz.dtype, device=xyz.device)
    return floor_cells(xyz, inv).to(torch.int32)
