"""The backend's keyframe-window programs (port of the window programs of
`lv_slam_tpu.utils.jit_cache`: `window_group_fn` :78,
`window_group_filtered_fn` :127, `window_flush_fn` :44 and
`merge_partials_fn` :185). The reference caches them per shape for TPU
compiles; here they are plain functions.

A filtered window group gathers up to 16 scans of a filtered chunk, moves
each into the window's frame and keeps the first point of each voxel
(kernel 2, `csrc/voxel_dedup.cu`: the move, then kernel 1b's key sort and
run compaction, in one C call); the flush does the same over a list of
scans, and the merge is kernel 1b over the concatenation of a window's
partials. A raw window group (kernel 2r) takes
up to 16 raw scans, applies the prefilter's distance band, moves them and
reduces the union to voxel centroids (kernel 1's reduction). CPU tensors
take the plain twins.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
from lv_slam_tpu_torch.kernels._build import (
    F32, I32, MAX_SORT_LANES, PTR, Kernel, check_cuda, check_dtype, ptr, scratch_bytes,
)
from lv_slam_tpu_torch.ops.cells import inv_resolution
from lv_slam_tpu_torch.ops.linalg3 import dot3_fma, sqrt32
from lv_slam_tpu_torch.ops.prefilter import (
    reduce_runs,
    voxel_dedup_first,
    voxel_dedup_first_ref,
    voxel_downsample_ref,
)

KERNEL = Kernel(
    "window_group_filtered_fn",
    source="lv_slam_tpu_torch/csrc/voxel_dedup.cu",
    replaces="lv_slam_tpu/utils/jit_cache.py:127",
    entries={
        "lvs_window_dedup": [
            PTR, PTR, PTR, I32, I32, I32, I32, PTR, PTR, F32, I32, PTR, ctypes.c_longlong, PTR, PTR, PTR,
        ],
    },
)


RAW_KERNEL = Kernel(
    "window_group_fn",
    source="lv_slam_tpu_torch/csrc/voxel_dedup.cu",
    replaces="lv_slam_tpu/utils/jit_cache.py:78",
    entries={
        "lvs_window_raw_keys": [PTR, PTR, PTR, I32, I32, I32, I32, PTR, PTR, F32, F32, F32, PTR, PTR, PTR],
        "lvs_voxel_mark_runs": [PTR, I32, PTR],
        "lvs_voxel_reduce_runs": [PTR, PTR, PTR, PTR, I32, PTR, PTR, I32, PTR, PTR, PTR],
    },
)


def window_group(
    chunk_xyz: torch.Tensor,     # (C, cap, 3) raw scans
    chunk_inten: torch.Tensor,   # (C, cap)
    chunk_mask: torch.Tensor,    # (C, cap)
    start: int,
    rels: torch.Tensor,          # (L, 4, 4) window-relative transforms
    valid: torch.Tensor,         # (L,) bool: rows past the group are padding
    near: float,
    far: float,
    resolution: float,
    out_cap: int,
) -> PointCloud:
    """Raw scans start .. start+L-1 of the chunk (rows clipped to the chunk),
    kept within near < |p| < far, each moved by its transform, reduced to
    voxel centroids (VOXELGRID) into `out_cap` lanes in key order. Kernel 2r
    on CUDA, the plain version on CPU."""
    if chunk_xyz.device.type == "cpu":
        return window_group_ref(chunk_xyz, chunk_inten, chunk_mask, start, rels, valid, near, far, resolution,
                                out_cap)
    n_rows, cap, _ = chunk_xyz.shape
    length = rels.shape[0]
    check_cuda("window_group", chunk_xyz, chunk_inten, chunk_mask, rels, valid)
    check_dtype("window_group", chunk_xyz, torch.float32, (n_rows, cap, 3))
    check_dtype("window_group", chunk_inten, torch.float32, (n_rows, cap))
    check_dtype("window_group", chunk_mask, torch.bool, (n_rows, cap))
    check_dtype("window_group", rels, torch.float32, (length, 4, 4))
    check_dtype("window_group", valid, torch.bool, (length,))
    n = length * cap
    dev = chunk_xyz.device
    xyz = torch.empty((n, 3), dtype=torch.float32, device=dev)
    inten = torch.empty((n,), dtype=torch.float32, device=dev)
    key = torch.empty((n,), dtype=torch.int64, device=dev)
    RAW_KERNEL.call(
        "lvs_window_raw_keys", ptr(chunk_xyz), ptr(chunk_inten), ptr(chunk_mask), n_rows, cap, int(start), length,
        ptr(rels), ptr(valid), float(near), float(far), inv_resolution(resolution), ptr(xyz), ptr(inten), ptr(key),
    )
    skey, order = torch.sort(key, stable=True)
    out = reduce_runs(RAW_KERNEL, skey, order, xyz, inten, out_cap)
    RAW_KERNEL.launches += 1
    return out


def window_group_ref(chunk_xyz, chunk_inten, chunk_mask, start, rels, valid, near, far, resolution,
                     out_cap) -> PointCloud:
    """Plain PyTorch version of `window_group`, line for line with the
    reference's program."""
    n_rows = chunk_xyz.shape[0]
    length = rels.shape[0]
    idx = torch.clamp(start + torch.arange(length, device=chunk_xyz.device), 0, n_rows - 1)
    xyz = chunk_xyz[idx]  # (L, cap, 3)
    inten = chunk_inten[idx]
    mask = chunk_mask[idx] & valid[:, None]
    masked = torch.where(mask[..., None], xyz, 0.0)
    dist = sqrt32(dot3_fma(masked, masked))
    mask = mask & (dist > near) & (dist < far)
    moved = torch.where(mask[..., None], se3.transform_points_fma(rels, xyz), SENTINEL)
    cloud = PointCloud(moved.reshape(-1, 3), inten.reshape(-1), mask.reshape(-1))
    return voxel_downsample_ref(cloud, resolution, out_cap)


def window_group_filtered(
    chunk_xyz_t: torch.Tensor,   # (C, 3, cap) filtered scans, transposed
    chunk_inten: torch.Tensor,   # (C, cap)
    chunk_mask: torch.Tensor,    # (C, cap)
    start: int,
    rels: torch.Tensor,          # (L, 4, 4) window-relative transforms
    valid: torch.Tensor,         # (L,) bool: rows past the group are padding
    resolution: float,
    out_cap: int,
) -> PointCloud:
    """Scans start .. start+L-1 of the chunk (rows clipped to the chunk), each
    moved by its transform, deduplicated to the first point per voxel into
    min(L * cap, out_cap) lanes. Kernel 2 on CUDA, the plain version on CPU."""
    if chunk_xyz_t.device.type == "cpu":
        return window_group_filtered_ref(
            chunk_xyz_t, chunk_inten, chunk_mask, start, rels, valid, resolution, out_cap
        )
    n_rows, _, cap = chunk_xyz_t.shape
    length = rels.shape[0]
    check_cuda("window_group_filtered", chunk_xyz_t, chunk_inten, chunk_mask, rels, valid)
    check_dtype("window_group_filtered", chunk_xyz_t, torch.float32, (n_rows, 3, cap))
    check_dtype("window_group_filtered", chunk_inten, torch.float32, (n_rows, cap))
    check_dtype("window_group_filtered", chunk_mask, torch.bool, (n_rows, cap))
    check_dtype("window_group_filtered", rels, torch.float32, (length, 4, 4))
    check_dtype("window_group_filtered", valid, torch.bool, (length,))
    n = length * cap
    if n > MAX_SORT_LANES:
        raise ValueError(f"window_group_filtered: {n} lanes exceed the key sort's {MAX_SORT_LANES}")
    out_cap = min(n, out_cap)
    dev = chunk_xyz_t.device
    scratch = torch.empty((scratch_bytes("lvs_window_scratch_bytes", n),), dtype=torch.uint8, device=dev)
    out_xyz = torch.empty((out_cap, 3), dtype=torch.float32, device=dev)
    out_int = torch.empty((out_cap,), dtype=torch.float32, device=dev)
    out_mask = torch.empty((out_cap,), dtype=torch.bool, device=dev)
    KERNEL.call(
        "lvs_window_dedup", ptr(chunk_xyz_t), ptr(chunk_inten), ptr(chunk_mask), n_rows, cap, int(start), length,
        ptr(rels), ptr(valid), inv_resolution(resolution), out_cap, ptr(scratch), scratch.numel(), ptr(out_xyz),
        ptr(out_int), ptr(out_mask),
    )
    KERNEL.launches += 1
    return PointCloud(out_xyz, out_int, out_mask)


def window_group_filtered_ref(chunk_xyz_t, chunk_inten, chunk_mask, start, rels, valid, resolution,
                              out_cap) -> PointCloud:
    """Plain PyTorch version of `window_group_filtered`, line for line with
    the reference's program."""
    n_rows = chunk_xyz_t.shape[0]
    length = rels.shape[0]
    idx = torch.clamp(start + torch.arange(length, device=chunk_xyz_t.device), 0, n_rows - 1)
    xyz = chunk_xyz_t[idx].transpose(1, 2)  # (L, cap, 3)
    inten = chunk_inten[idx]
    mask = chunk_mask[idx] & valid[:, None]
    moved = torch.where(mask[..., None], se3.transform_points_fma(rels, xyz), SENTINEL)
    cloud = PointCloud(moved.reshape(-1, 3), inten.reshape(-1), mask.reshape(-1))
    return voxel_dedup_first_ref(cloud, resolution, out_cap)


def window_flush(
    xyzs: Sequence[torch.Tensor], intens: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
    rels: torch.Tensor, resolution: float, out_cap: int,
) -> PointCloud:
    """A whole per-scan window (W scans of (cap, 3), with (W, 4, 4)
    window-relative transforms) moved and deduplicated: the window group
    over the stacked scans."""
    xyz_t = torch.stack(list(xyzs)).transpose(1, 2).contiguous()
    valid = torch.ones((len(xyzs),), dtype=torch.bool, device=xyz_t.device)
    return window_group_filtered(
        xyz_t, torch.stack(list(intens)), torch.stack(list(masks)), 0, rels, valid, resolution, out_cap
    )


def merge_partials(parts: Sequence[PointCloud], resolution: float, out_cap: int) -> PointCloud:
    """A window's partial clouds (one per chunk it spans), concatenated and
    deduplicated to the first point per voxel (kernel 1b)."""
    cloud = PointCloud(
        torch.cat([p.xyz for p in parts]), torch.cat([p.intensity for p in parts]),
        torch.cat([p.mask for p in parts]),
    )
    return voxel_dedup_first(cloud, resolution, out_cap)

