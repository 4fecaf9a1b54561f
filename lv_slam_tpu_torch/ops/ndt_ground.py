"""Ground-constrained NDT, the reference's `pclomp_ground` elevation refiner
(port of `lv_slam_tpu.ops.ndt_ground`).

`NormalDistributionsTransformGround` registers only ground-plane voxels
(voxel normal within 10 degrees of +z) and solves only the (z, roll, pitch)
sub-problem. The port filters the map's leaves and LUT to the ground leaves
(kernel 20, `csrc/ndt_ground.cu`, on CUDA tensors; `filter_ground_leaves_ref`
on CPU tensors), then runs the generic `ndt_align` (kernel K6G in the Newton
loop) with DIRECT1, unweighted, and a (tz, roll, pitch) DOF mask.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.kernels._build import F32, I32, PTR, Kernel, check_cuda, check_dtype, ptr
from lv_slam_tpu_torch.ops.ndt import NDTResult, ndt_align
from lv_slam_tpu_torch.ops.voxel_map import VoxelMap

# free (tz, roll, pitch); frozen (tx, ty, yaw), the reference's flag-1 semantics
GROUND_DOF = (False, False, True, True, True, False)

KERNEL = Kernel(
    "filter_ground_leaves",
    source="lv_slam_tpu_torch/csrc/ndt_ground.cu",
    replaces="lv_slam_tpu/ops/ndt_ground.py:29",
    entries={"lvs_ground_filter": [PTR, ctypes.c_longlong, PTR, PTR, I32, F32, PTR, PTR]},
)


def _cos_thresh(max_angle_deg: float) -> float:
    """cos(deg2rad(float32(max_angle))) as the reference rounds it: the
    float32 angle, its correctly rounded float32 cosine."""
    angle = np.float32(max_angle_deg) * np.float32(np.pi / 180.0)
    return float(np.float32(np.cos(np.float64(angle))))


def filter_ground_leaves(vmap_: VoxelMap, lut: torch.Tensor, max_angle_deg: float = 10.0
                         ) -> Tuple[VoxelMap, torch.Tensor]:
    """The map with only the leaves whose normal is within `max_angle_deg`
    of +z left valid, and its LUT with every other entry set to -1. Kernel
    20 on CUDA, the plain version on CPU."""
    if lut.device.type == "cpu":
        return filter_ground_leaves_ref(vmap_, lut, max_angle_deg)
    leaf_cap, e3 = vmap_.leaf_cap, vmap_.extent ** 3
    lut = lut.contiguous()
    check_cuda("filter_ground_leaves", lut, vmap_.valid, vmap_.normals)
    check_dtype("filter_ground_leaves", lut, torch.int32, (e3,))
    check_dtype("filter_ground_leaves", vmap_.valid, torch.bool, (leaf_cap,))
    check_dtype("filter_ground_leaves", vmap_.normals, torch.float32, (leaf_cap, 3))
    lut_out = torch.empty_like(lut)
    valid_out = torch.empty_like(vmap_.valid)
    KERNEL.call(
        "lvs_ground_filter", ptr(lut), e3, ptr(vmap_.valid), ptr(vmap_.normals), leaf_cap,
        _cos_thresh(max_angle_deg), ptr(lut_out), ptr(valid_out),
    )
    KERNEL.launches += 1
    return vmap_._replace(valid=valid_out), lut_out


def filter_ground_leaves_ref(vmap_: VoxelMap, lut: torch.Tensor, max_angle_deg: float = 10.0
                             ) -> Tuple[VoxelMap, torch.Tensor]:
    """Plain PyTorch version of `filter_ground_leaves`, line for line with
    the reference."""
    ground = vmap_.valid & (torch.abs(vmap_.normals[:, 2]) >= _cos_thresh(max_angle_deg))
    leaf = torch.clamp(lut, min=0).to(torch.int64)
    keep = (lut >= 0) & ground[leaf]
    return vmap_._replace(valid=ground), torch.where(keep, lut, -1)


def ndt_ground_align(
    vmap_: VoxelMap,
    lut: torch.Tensor,
    source: PointCloud,
    guess: torch.Tensor,
    *,
    resolution: float = 10.0,
    transformation_epsilon: float = 0.01,
    max_iterations: int = 64,
    max_ground_angle_deg: float = 10.0,
) -> NDTResult:
    """Register `source` onto the map's ground leaves, moving only (tz,
    roll, pitch)."""
    ground_map, ground_lut = filter_ground_leaves(vmap_, lut, max_ground_angle_deg)
    return ndt_align(
        ground_map, ground_lut, source, guess, resolution=resolution,
        transformation_epsilon=transformation_epsilon, max_iterations=max_iterations, neighborhood="DIRECT1",
        weighted=False, dof_mask=GROUND_DOF,
    )
