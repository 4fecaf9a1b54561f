"""Global map cloud generation (port of `lv_slam_tpu.graph.map_cloud`, the
rebuild of `MapCloudGenerator`, `src/global_graph/map_cloud_generator.cpp:
16-55`): every keyframe cloud moved by its optimized pose, concatenated, then
reduced to one centroid per occupied voxel at `resolution` (kernel 1 at the
map's shape, over the union padded to a power of two).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
from lv_slam_tpu_torch.ops.prefilter import voxel_downsample


def map_union(keyframe_clouds: Sequence[PointCloud], poses: Sequence[np.ndarray]) -> Optional[PointCloud]:
    """Every keyframe cloud moved by its float32 pose (the fma chain of the
    reference's compiled transform, on the cloud's device), the valid rows
    in keyframe order as the reference's host concatenation keeps them,
    padded to a power of two; None when there are none."""
    xyzs, intens = [], []
    for cloud, pose in zip(keyframe_clouds, poses):
        moved = cloud.transformed(torch.as_tensor(np.asarray(pose, np.float32), device=cloud.xyz.device))
        xyzs.append(moved.xyz[moved.mask])
        intens.append(moved.intensity[moved.mask])
    if not xyzs:
        return None
    xyz, inten = torch.cat(xyzs), torch.cat(intens)
    n = xyz.shape[0]
    if n == 0:
        return None
    cap = 1
    while cap < n:
        cap *= 2
    pad = cap - n
    return PointCloud(
        torch.cat([xyz, xyz.new_full((pad, 3), SENTINEL)]),
        torch.cat([inten, inten.new_zeros(pad)]),
        torch.arange(cap, device=xyz.device) < n,
    )


def generate_map_cloud(
    keyframe_clouds: Sequence[PointCloud],
    poses: Sequence[np.ndarray],
    resolution: float = 0.5,
    out_cap: int = 1 << 20,
) -> np.ndarray:
    """Returns an (M,4) numpy array [x y z intensity] of the map's voxels."""
    cloud = map_union(keyframe_clouds, poses)
    if cloud is None:
        return np.zeros((0, 4), np.float32)
    return voxel_downsample(cloud, float(resolution), min(out_cap, cloud.cap)).to_numpy()
