"""Nearest-centroid queries on a fine centroid grid (port of
`lv_slam_tpu.ops.nn`: `build_centroid_grid` :42, `nn_sq_dists` :86,
`fitness_score` :129).

The reference scores a loop alignment with the mean squared distance of
the moved candidate cloud to the new keyframe's cloud; the nearest point is
approximated by the nearest centroid among the 27 cells (0.25 m) around the
query, found by binary search over the sorted cell keys. Kernel 14
(`csrc/centroid_grid.cu`) builds the grid and answers the queries on CUDA
tensors; `*_ref` are the plain twins, which CPU tensors take.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
from lv_slam_tpu_torch.kernels._build import F32, I32, PTR, Kernel, check_cuda, check_dtype, ptr
from lv_slam_tpu_torch.ops.prefilter import cell_coords, inv_resolution

_EXTENT = 1024       # cells per axis: 1024^3 flat keys fit int32
_KEY_MAX = 2**31 - 1  # key of cells out of the extent and of empty leaves
_BIG = 1 << 30
_BLOCK = 256         # grid_query's threads per block

BUILD_KERNEL = Kernel(
    "build_centroid_grid",
    source="lv_slam_tpu_torch/csrc/centroid_grid.cu",
    replaces="lv_slam_tpu/ops/nn.py:42",
    entries={
        "lvs_grid_mark": [PTR, I32, PTR],
        "lvs_grid_reduce": [PTR, PTR, PTR, PTR, I32, PTR, I32, PTR, PTR, PTR],
    },
)
QUERY_KERNEL = Kernel(
    "nn_sq_dists",
    source="lv_slam_tpu_torch/csrc/centroid_grid.cu",
    replaces="lv_slam_tpu/ops/nn.py:86",
    entries={
        "lvs_grid_query": [PTR, PTR, I32, PTR, F32, I32, PTR, PTR, I32, I32, PTR, F32, PTR, PTR, I32, PTR],
    },
)


class CentroidGrid(NamedTuple):
    keys: torch.Tensor         # (L,) ascending flat cell keys, INT32_MAX past the last leaf
    centroids: torch.Tensor    # (L, 3), SENTINEL past the last leaf
    counts: torch.Tensor       # (L,) points per cell
    origin_cell: torch.Tensor  # (3,) int32
    resolution: float


def _grid_keys(cloud: PointCloud, resolution: float):
    """(int32 flat keys, INT32_MAX out of the extent or masked; origin cell)."""
    xyz = cloud.masked_xyz()
    coords = cell_coords(xyz, resolution)
    origin = torch.where(cloud.mask[:, None], coords, _BIG).amin(dim=0)
    origin = torch.where(origin == _BIG, 0, origin)
    rel = coords - origin
    e = _EXTENT
    in_extent = torch.all((rel >= 0) & (rel < e), dim=1) & cloud.mask
    flat = (rel[:, 0] * e + rel[:, 1]) * e + rel[:, 2]
    keys = torch.where(in_extent, flat, _KEY_MAX).to(torch.int32)
    return keys, origin.to(torch.int32), xyz


def build_centroid_grid(cloud: PointCloud, resolution: float, leaf_cap: int = 65536) -> CentroidGrid:
    """Cell centroids of a cloud, leaves in ascending key order; cells past
    the first `leaf_cap` in key order are dropped. Kernel 14 on CUDA, the
    plain version on CPU."""
    if cloud.xyz.device.type == "cpu":
        return build_centroid_grid_ref(cloud, resolution, leaf_cap)
    keys, origin, xyz = _grid_keys(cloud, resolution)
    skeys, order = torch.sort(keys, stable=True)
    check_cuda("build_centroid_grid", skeys, order, xyz)
    n = keys.shape[0]
    dev = xyz.device
    flag = torch.empty((n,), dtype=torch.int32, device=dev)
    out_keys = torch.empty((leaf_cap,), dtype=torch.int32, device=dev)
    centroids = torch.empty((leaf_cap, 3), dtype=torch.float32, device=dev)
    counts = torch.empty((leaf_cap,), dtype=torch.float32, device=dev)
    BUILD_KERNEL.call("lvs_grid_mark", ptr(skeys), n, ptr(flag))
    cum = torch.cumsum(flag, dim=0, dtype=torch.int32)  # leaf index + 1 at each run start
    BUILD_KERNEL.call(
        "lvs_grid_reduce", ptr(skeys), ptr(order), ptr(flag), ptr(cum), n, ptr(xyz), leaf_cap,
        ptr(out_keys), ptr(centroids), ptr(counts),
    )
    BUILD_KERNEL.launches += 1
    return CentroidGrid(out_keys, centroids, counts, origin, float(resolution))


def build_centroid_grid_ref(cloud: PointCloud, resolution: float, leaf_cap: int = 65536) -> CentroidGrid:
    """Plain PyTorch version of `build_centroid_grid`: stable key sort, run
    starts, in-order segment sums."""
    keys, origin, xyz = _grid_keys(cloud, resolution)
    n = keys.shape[0]
    dev = xyz.device
    skeys, order = torch.sort(keys, stable=True)
    svalid = skeys != _KEY_MAX
    new_seg = torch.ones((n,), dtype=torch.bool, device=dev)
    new_seg[1:] = skeys[1:] != skeys[:-1]
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1
    seg_id = torch.where(svalid & (seg_id < leaf_cap), seg_id, leaf_cap)
    seg_in = torch.cat([torch.where(svalid[:, None], xyz[order], 0.0), svalid.to(torch.float32)[:, None]], 1)
    lengths = torch.bincount(seg_id, minlength=leaf_cap + 1)
    sums = torch.segment_reduce(seg_in, "sum", lengths=lengths, axis=0, unsafe=True)[:leaf_cap]
    counts = sums[:, 3]
    seg_key = torch.full((leaf_cap + 1,), -1, dtype=torch.int32, device=dev)
    seg_key.scatter_reduce_(0, seg_id, torch.where(svalid, skeys, -1), "amax")
    seg_key = seg_key[:leaf_cap]
    valid = (seg_key >= 0) & (counts > 0)
    centroids = sums[:, :3] / torch.clamp(counts, min=1.0)[:, None]
    return CentroidGrid(
        keys=torch.where(valid, seg_key, _KEY_MAX),
        centroids=torch.where(valid[:, None], centroids, SENTINEL),
        counts=torch.where(valid, counts, 0.0),
        origin_cell=origin,
        resolution=float(resolution),
    )


def _query(grid: CentroidGrid, points: torch.Tensor, mask: torch.Tensor,
           transforms: Optional[torch.Tensor], max_range: float, want_d2: bool):
    """Kernel 14's query over k point sets (k, N, 3): (d2 (k, N) or None,
    masked mean (k,))."""
    k, n = mask.shape
    leaf_cap = grid.keys.shape[0]
    check_cuda("nn_sq_dists", grid.keys, grid.centroids, grid.origin_cell, points, mask)
    check_dtype("nn_sq_dists", grid.keys, torch.int32, (leaf_cap,))
    check_dtype("nn_sq_dists", grid.centroids, torch.float32, (leaf_cap, 3))
    check_dtype("nn_sq_dists", points, torch.float32, (k, n, 3))
    check_dtype("nn_sq_dists", mask, torch.bool, (k, n))
    if transforms is not None:
        check_cuda("nn_sq_dists", transforms)
        check_dtype("nn_sq_dists", transforms, torch.float32, (k, 4, 4))
    dev = points.device
    n_blocks = max(1, -(-n // _BLOCK))
    d2 = torch.empty((k, n), dtype=torch.float32, device=dev) if want_d2 else None
    partials = torch.empty((k, n_blocks, 2), dtype=torch.float32, device=dev)
    out = torch.empty((k,), dtype=torch.float32, device=dev)
    QUERY_KERNEL.call(
        "lvs_grid_query", ptr(grid.keys), ptr(grid.centroids), leaf_cap, ptr(grid.origin_cell),
        inv_resolution(grid.resolution), _EXTENT, ptr(points), ptr(mask), n, k,
        ctypes.c_void_p(None) if transforms is None else ptr(transforms),
        float(np.float32(max_range) ** 2), ctypes.c_void_p(None) if d2 is None else ptr(d2),
        ptr(partials), n_blocks, ptr(out),
    )
    QUERY_KERNEL.launches += 1
    return d2, out


def nn_sq_dists(grid: CentroidGrid, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N,) squared distance of each point to the nearest centroid in its 27
    cells; +inf on a miss or a masked lane. Kernel 14 on CUDA, the plain
    version on CPU."""
    if points.device.type == "cpu":
        return nn_sq_dists_ref(grid, points, mask)
    d2, _ = _query(grid, points.contiguous()[None], mask.contiguous()[None], None, float("inf"), True)
    return d2[0]


_OFF27 = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


def nn_sq_dists_ref(grid: CentroidGrid, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `nn_sq_dists`, line for line with the reference."""
    e = _EXTENT
    off = torch.tensor(_OFF27, dtype=torch.int32, device=points.device)
    rel = cell_coords(points, grid.resolution)[:, None, :] - grid.origin_cell + off[None]
    in_extent = torch.all((rel >= 0) & (rel < e), dim=-1)
    flat = (rel[..., 0] * e + rel[..., 1]) * e + rel[..., 2]
    query = torch.where(in_extent, flat, _KEY_MAX).to(torch.int32)
    idx = torch.searchsorted(grid.keys, query.reshape(-1)).reshape(query.shape)
    idx = torch.clamp(idx, max=grid.keys.shape[0] - 1)
    hit = in_extent & (grid.keys[idx] == query)
    cent = grid.centroids[torch.where(hit, idx, 0)]  # (N, 27, 3)
    diff = points[:, None, :] - cent
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    d2 = torch.where(hit, d2, torch.inf).amin(dim=1)
    return torch.where(mask, d2, torch.inf)


def _masked_mean(d2: torch.Tensor, max_range: float) -> torch.Tensor:
    ok = torch.isfinite(d2) & (d2 <= np.float32(max_range) ** 2)
    n = torch.sum(ok.to(torch.float32), dim=-1)
    total = torch.sum(torch.where(ok, d2, 0.0), dim=-1)
    return torch.where(n > 0, total / torch.clamp(n, min=1.0), torch.inf)


def fitness_batch(grid: CentroidGrid, clouds: PointCloud, transforms: torch.Tensor,
                  max_range: float = float("inf")) -> torch.Tensor:
    """(k,) fitness of k clouds (xyz (k, N, 3), masks (k, N)), each moved by
    its (4, 4) transform: the mean squared nearest-centroid distance over the
    lanes within `max_range`, +inf when none is. One kernel 14 query for all
    k on CUDA, the plain version on CPU."""
    if clouds.xyz.device.type == "cpu":
        return fitness_batch_ref(grid, clouds, transforms, max_range)
    _, out = _query(grid, clouds.xyz.contiguous(), clouds.mask.contiguous(), transforms.contiguous(),
                    max_range, False)
    return out


def fitness_batch_ref(grid: CentroidGrid, clouds: PointCloud, transforms: torch.Tensor,
                      max_range: float = float("inf")) -> torch.Tensor:
    """Plain PyTorch version of `fitness_batch`: each cloud moved, queried and
    averaged on its own, as the reference's vmapped `fit_one`."""
    d2 = torch.stack([
        nn_sq_dists_ref(grid, PointCloud(x, i, m).transformed(t).masked_xyz(), m)
        for x, i, m, t in zip(clouds.xyz, clouds.intensity, clouds.mask, transforms)
    ])
    return _masked_mean(d2, max_range)


def fitness_score(target: PointCloud, source: PointCloud, transform: torch.Tensor,
                  max_range: float = float("inf"), grid_resolution: float = 0.25) -> torch.Tensor:
    """Mean squared nearest-centroid distance of `transform @ source` to
    `target` (`pcl::Registration::getFitnessScore` semantics): pairs beyond
    `max_range` are left out, +inf when none is left."""
    grid = build_centroid_grid(target, grid_resolution)
    batch = PointCloud(source.xyz[None], source.intensity[None], source.mask[None])
    return fitness_batch(grid, batch, transform[None], max_range)[0]
