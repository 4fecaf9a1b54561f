"""Nearest-centroid queries on a fine centroid grid (port of
`lv_slam_tpu.ops.nn`: `build_centroid_grid` :42, `nn_sq_dists` :86,
`nn_points` :107, `fitness_score` :129, `radius_outlier_removal` :151,
`statistical_outlier_removal` :174).

The reference scores a loop alignment with the mean squared distance of
the moved candidate cloud to the new keyframe's cloud; the nearest point is
approximated by the nearest centroid among the 27 cells (0.25 m) around the
query, found by binary search over the sorted cell keys. Kernel 14
(`csrc/centroid_grid.cu`) builds the grid (one C call over the repo's own
key sort) and answers the queries (one search per (x, y) column of three
cells) on CUDA tensors; `*_ref` are the plain twins, which CPU tensors
take. The same probe serves kernel 17 (`nn_points`: the matched centroid
itself, ICP's correspondences) and kernel 18 (the outlier removals: the sum
of the point counts of the 27 cells, on a grid at the removal's radius).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
from lv_slam_tpu_torch.kernels._build import (
    F32, I32, MAX_SORT_LANES, PTR, Kernel, check_cuda, check_dtype, ptr, scratch_bytes,
)
from lv_slam_tpu_torch.ops.linalg3 import dot3_fma, sqrt32
from lv_slam_tpu_torch.ops.cells import cell_coords, inv_resolution

_EXTENT = 1024       # cells per axis: 1024^3 flat keys fit int32
_KEY_MAX = 2**31 - 1  # key of cells out of the extent and of empty leaves
_BIG = 1 << 30
_BLOCK = 256         # grid_query's threads per block

BUILD_KERNEL = Kernel(
    "build_centroid_grid",
    source="lv_slam_tpu_torch/csrc/centroid_grid.cu",
    replaces="lv_slam_tpu/ops/nn.py:42",
    # xyz, mask, n, 1/res, leaf_cap, scratch, its bytes -> keys, centroids, counts, origin
    entries={"lvs_centroid_grid": [PTR, PTR, I32, F32, I32, PTR, ctypes.c_longlong, PTR, PTR, PTR, PTR]},
)
QUERY_KERNEL = Kernel(
    "nn_sq_dists",
    source="lv_slam_tpu_torch/csrc/centroid_grid.cu",
    replaces="lv_slam_tpu/ops/nn.py:86",
    entries={
        "lvs_grid_query": [PTR, PTR, I32, PTR, F32, I32, PTR, PTR, I32, I32, PTR, F32, PTR, PTR, I32, PTR],
    },
)
# grid: keys, centroids or counts, leaf_cap, origin, 1/res, extent
_GRID_ARGS = [PTR, PTR, I32, PTR, F32, I32]
NN_POINTS_KERNEL = Kernel(
    "nn_points",
    source="lv_slam_tpu_torch/csrc/centroid_grid.cu",
    replaces="lv_slam_tpu/ops/nn.py:107",
    entries={
        # grid, points, mask, n -> d2, nn, valid
        "lvs_nn_points": [*_GRID_ARGS, PTR, PTR, I32, PTR, PTR, PTR],
        # grid, src, mask, n, T, max_d2 -> y, nn, w, partials, n_blocks, stats (ops/icp.py)
        "lvs_icp_match": [*_GRID_ARGS, PTR, PTR, I32, PTR, F32, PTR, PTR, PTR, PTR, I32, PTR],
        # y, nn, w, n, stats, partials, n_blocks, T -> T_out
        "lvs_icp_update": [PTR, PTR, PTR, I32, PTR, PTR, I32, PTR, PTR],
    },
)
RADIUS_KERNEL = Kernel(
    "radius_outlier_removal",
    source="lv_slam_tpu_torch/csrc/centroid_grid.cu",
    replaces="lv_slam_tpu/ops/nn.py:151",
    entries={"lvs_outlier_radius": [*_GRID_ARGS, PTR, PTR, I32, F32, PTR, PTR]},
)
STATISTICAL_KERNEL = Kernel(
    "statistical_outlier_removal",
    source="lv_slam_tpu_torch/csrc/centroid_grid.cu",
    replaces="lv_slam_tpu/ops/nn.py:174",
    entries={"lvs_outlier_statistical": [*_GRID_ARGS, PTR, PTR, I32, F32, F32, PTR, PTR, I32, PTR, PTR, PTR]},
)
_STAT_RADIUS = 0.5  # the statistical removal's density cells (m)


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
    the first `leaf_cap` in key order are dropped. Kernel 14 on CUDA (one C
    call: keys, the repo's stable key sort, the runs' in-order sums), the
    plain version on CPU."""
    if cloud.xyz.device.type == "cpu":
        return build_centroid_grid_ref(cloud, resolution, leaf_cap)
    xyz, mask = cloud.xyz.contiguous(), cloud.mask.contiguous()
    n = cloud.cap
    if n > MAX_SORT_LANES:
        raise ValueError(f"build_centroid_grid: {n} lanes exceed the key sort's {MAX_SORT_LANES}")
    check_cuda("build_centroid_grid", xyz, mask)
    check_dtype("build_centroid_grid", xyz, torch.float32, (n, 3))
    check_dtype("build_centroid_grid", mask, torch.bool, (n,))
    dev = xyz.device
    scratch = torch.empty((scratch_bytes("lvs_centroid_grid_scratch_bytes", n),), dtype=torch.uint8, device=dev)
    keys = torch.empty((leaf_cap,), dtype=torch.int32, device=dev)
    centroids = torch.empty((leaf_cap, 3), dtype=torch.float32, device=dev)
    counts = torch.empty((leaf_cap,), dtype=torch.float32, device=dev)
    origin = torch.empty((3,), dtype=torch.int32, device=dev)
    BUILD_KERNEL.call(
        "lvs_centroid_grid", ptr(xyz), ptr(mask), n, inv_resolution(resolution), leaf_cap, ptr(scratch),
        scratch.numel(), ptr(keys), ptr(centroids), ptr(counts), ptr(origin),
    )
    BUILD_KERNEL.launches += 1
    return CentroidGrid(keys, centroids, counts, origin, float(resolution))


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


def _probe27(grid: CentroidGrid, points: torch.Tensor):
    """(hit (N, 27), leaf (N, 27)): the 27 cells around each point looked up
    by binary search over the sorted keys, in `_OFF27` order; a miss reads
    leaf 0, as the reference's `where(hit, idx, 0)` gather."""
    e = _EXTENT
    off = torch.tensor(_OFF27, dtype=torch.int32, device=points.device)
    rel = cell_coords(points, grid.resolution)[:, None, :] - grid.origin_cell + off[None]
    in_extent = torch.all((rel >= 0) & (rel < e), dim=-1)
    flat = (rel[..., 0] * e + rel[..., 1]) * e + rel[..., 2]
    query = torch.where(in_extent, flat, _KEY_MAX).to(torch.int32)
    idx = torch.searchsorted(grid.keys, query.reshape(-1)).reshape(query.shape)
    idx = torch.clamp(idx, max=grid.keys.shape[0] - 1)
    hit = in_extent & (grid.keys[idx] == query)
    return hit, torch.where(hit, idx, 0)


def nn_sq_dists_ref(grid: CentroidGrid, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `nn_sq_dists`, line for line with the reference."""
    hit, leaf = _probe27(grid, points)
    cent = grid.centroids[leaf]  # (N, 27, 3)
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


def _check_grid(name: str, grid: CentroidGrid, values: torch.Tensor, *tensors: torch.Tensor) -> int:
    """The grid (keys and `values`, its centroids or counts) and the point
    tensors are contiguous CUDA tensors of the kernels' types; returns leaf_cap."""
    leaf_cap = grid.keys.shape[0]
    check_cuda(name, grid.keys, values, grid.origin_cell, *tensors)
    check_dtype(name, grid.keys, torch.int32, (leaf_cap,))
    check_dtype(name, grid.origin_cell, torch.int32, (3,))
    if values.dtype != torch.float32 or values.shape[0] != leaf_cap:
        raise ValueError(f"{name}: expected float32 grid values of {leaf_cap} leaves, got {values.dtype} {values.shape}")
    return leaf_cap


def _grid_args(grid: CentroidGrid, values: torch.Tensor, leaf_cap: int) -> tuple:
    return (ptr(grid.keys), ptr(values), leaf_cap, ptr(grid.origin_cell), inv_resolution(grid.resolution), _EXTENT)


def nn_points(grid: CentroidGrid, points: torch.Tensor, mask: torch.Tensor):
    """(d2 (N,), nn (N, 3), valid (N,)): each point's nearest hit centroid
    among its 27 cells (the first in `_OFF27` order on a tie), its squared
    distance (+inf where not valid) and whether the lane is valid (masked
    in and hit). A miss returns leaf 0's centroid. Kernel 17 on CUDA, the
    plain version on CPU."""
    if points.device.type == "cpu":
        return nn_points_ref(grid, points, mask)
    n = points.shape[0]
    points, mask = points.contiguous(), mask.contiguous()
    leaf_cap = _check_grid("nn_points", grid, grid.centroids, points, mask)
    check_dtype("nn_points", points, torch.float32, (n, 3))
    check_dtype("nn_points", mask, torch.bool, (n,))
    dev = points.device
    d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    nn = torch.empty((n, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    NN_POINTS_KERNEL.call(
        "lvs_nn_points", *_grid_args(grid, grid.centroids, leaf_cap), ptr(points), ptr(mask), n,
        ptr(d2), ptr(nn), ptr(valid),
    )
    NN_POINTS_KERNEL.launches += 1
    return d2, nn, valid


def nn_points_ref(grid: CentroidGrid, points: torch.Tensor, mask: torch.Tensor):
    """Plain PyTorch version of `nn_points`, line for line with the
    reference; the squared distances are XLA's CPU fma chain."""
    hit, leaf = _probe27(grid, points)
    cent = grid.centroids[leaf]  # (N, 27, 3)
    d = points[:, None, :] - cent
    d2 = torch.where(hit, dot3_fma(d, d), torch.inf)
    best = torch.argmin(d2, dim=1)  # the first of equal minima
    rows = torch.arange(points.shape[0], device=points.device)
    d2_best = d2[rows, best]
    valid = mask & torch.isfinite(d2_best)
    return torch.where(valid, d2_best, torch.inf), cent[rows, best], valid


def neighbour_counts_ref(grid: CentroidGrid, points: torch.Tensor) -> torch.Tensor:
    """(N,) the sum of the point counts of the hit cells among each point's 27."""
    hit, leaf = _probe27(grid, points)
    return torch.sum(torch.where(hit, grid.counts[leaf], 0.0), dim=1)


def _kept(cloud: PointCloud, keep: torch.Tensor) -> PointCloud:
    return PointCloud(torch.where(keep[:, None], cloud.xyz, SENTINEL), cloud.intensity, keep)


def _removal_out(name: str, grid: CentroidGrid, cloud: PointCloud):
    """(leaf_cap, xyz, mask, out xyz, out mask) of a removal's launch."""
    xyz, mask = cloud.xyz.contiguous(), cloud.mask.contiguous()
    leaf_cap = _check_grid(name, grid, grid.counts, xyz, mask)
    check_dtype(name, xyz, torch.float32, (cloud.cap, 3))
    check_dtype(name, mask, torch.bool, (cloud.cap,))
    return leaf_cap, xyz, mask, torch.empty_like(xyz), torch.empty_like(mask)


def radius_outlier_removal(cloud: PointCloud, radius: float, min_neighbors: int) -> PointCloud:
    """Keep the points whose 27 cells (cell size `radius`) hold at least
    `min_neighbors` other points; dropped lanes take the sentinel, nothing is
    compacted. The grid is kernel 14's build (one leaf per lane), the count
    and the keep kernel 18, on CUDA; the plain version on CPU."""
    if cloud.xyz.device.type == "cpu":
        return radius_outlier_removal_ref(cloud, radius, min_neighbors)
    grid = build_centroid_grid(cloud, radius, leaf_cap=cloud.cap)
    leaf_cap, xyz, mask, out_xyz, out_mask = _removal_out("radius_outlier_removal", grid, cloud)
    RADIUS_KERNEL.call(
        "lvs_outlier_radius", *_grid_args(grid, grid.counts, leaf_cap), ptr(xyz), ptr(mask), cloud.cap,
        float(min_neighbors), ptr(out_xyz), ptr(out_mask),
    )
    RADIUS_KERNEL.launches += 1
    return PointCloud(out_xyz, cloud.intensity, out_mask)


def radius_outlier_removal_ref(cloud: PointCloud, radius: float, min_neighbors: int) -> PointCloud:
    """Plain PyTorch version of `radius_outlier_removal`."""
    grid = build_centroid_grid_ref(cloud, radius, leaf_cap=cloud.cap)
    count = neighbour_counts_ref(grid, cloud.masked_xyz())
    return _kept(cloud, cloud.mask & (count - 1 >= min_neighbors))


def _k_vol(mean_k: int) -> float:
    """float32(mean_k) * (3 * 0.5 m)^3, as the reference rounds it."""
    return float(np.float32(mean_k) * np.float32((3.0 * _STAT_RADIUS) ** 3))


def statistical_outlier_removal(cloud: PointCloud, mean_k: int = 30, stddev_mult: float = 1.2) -> PointCloud:
    """Keep the points whose isolation distance cbrt(mean_k (1.5 m)^3 /
    max(density, 1)), the density summed over the 27 cells of a 0.5 m grid,
    is at most mean + stddev_mult * std over the masked lanes. The cube root
    is taken in float64 and rounded (the reference's float32 `cbrt` is off
    by up to 1.5 ulp), and the two sums are float64 sums rounded once, so
    the kernel and its twin agree on the threshold whatever their order.
    Kernel 14's build and kernel 18 on CUDA, the plain version on CPU."""
    if cloud.xyz.device.type == "cpu":
        return statistical_outlier_removal_ref(cloud, mean_k, stddev_mult)
    grid = build_centroid_grid(cloud, _STAT_RADIUS, leaf_cap=cloud.cap)
    leaf_cap, xyz, mask, out_xyz, out_mask = _removal_out("statistical_outlier_removal", grid, cloud)
    n = cloud.cap
    n_blocks = max(1, -(-n // _BLOCK))
    dev = xyz.device
    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64, device=dev)
    stats = torch.empty((3,), dtype=torch.float32, device=dev)
    STATISTICAL_KERNEL.call(
        "lvs_outlier_statistical", *_grid_args(grid, grid.counts, leaf_cap), ptr(xyz), ptr(mask), n,
        _k_vol(mean_k), float(np.float32(stddev_mult)), ptr(dist), ptr(partials), n_blocks, ptr(stats),
        ptr(out_xyz), ptr(out_mask),
    )
    STATISTICAL_KERNEL.launches += 1
    return PointCloud(out_xyz, cloud.intensity, out_mask)


def statistical_outlier_removal_ref(cloud: PointCloud, mean_k: int = 30, stddev_mult: float = 1.2) -> PointCloud:
    """Plain PyTorch version of `statistical_outlier_removal`."""
    grid = build_centroid_grid_ref(cloud, _STAT_RADIUS, leaf_cap=cloud.cap)
    density = neighbour_counts_ref(grid, cloud.masked_xyz())
    # a tensor numerator: a Python one would multiply by the reciprocal on the card
    q = torch.full_like(density, _k_vol(mean_k)) / torch.clamp(density, min=1.0)
    knn_dist = torch.pow(q.double(), 1.0 / 3.0).to(torch.float32)
    mask = cloud.mask

    def sum32(x):  # a float64 sum rounded once
        return torch.sum(torch.where(mask, x, 0.0).double()).to(torch.float32)

    n = torch.clamp(sum32(torch.ones_like(knn_dist)), min=1.0)
    mean = sum32(knn_dist) / n
    var = sum32((knn_dist - mean) ** 2) / n
    thresh = mean + stddev_mult * sqrt32(var)
    return _kept(cloud, mask & (knn_dist <= thresh))
