"""Point-to-point ICP, the registration factory's ICP option (port of
`lv_slam_tpu.ops.icp`, the reference's `pcl::IterativeClosestPoint`).

Correspondences come from the target's fine centroid grid (kernel 14's
build; the nearest centroid of kernel 17's probe), pairs beyond the
correspondence distance are rejected, and each iteration applies the
closed-form weighted Kabsch update, over a fixed number of iterations.

On CUDA tensors an iteration is kernel 17's two entries
(`csrc/centroid_grid.cu`): `lvs_icp_match` moves the source, matches it and
sums the weights, the matched points and the squared distances in block
partials; `lvs_icp_update` forms the centred cross-covariance in a second
pass and takes the Kabsch rotation from its SVD in float64 on the device, so
the loop never reads the host. `icp_step_ref` / `icp_fitness_ref` are the
plain versions (float32 sums and `torch.linalg.svd`, as the reference),
which CPU tensors take.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.kernels._build import check_dtype, ptr
from lv_slam_tpu_torch.ops.nn import (
    _BLOCK, NN_POINTS_KERNEL, CentroidGrid, _check_grid, _grid_args, build_centroid_grid, nn_points_ref,
)


class ICPResult(NamedTuple):
    transform: torch.Tensor  # (4, 4)
    fitness: torch.Tensor    # () mean squared correspondence distance
    n_matches: torch.Tensor  # () int32


def _sq32(x: float) -> float:
    """float32(x ** 2): the reference squares the Python float, then rounds."""
    return float(np.float32(x * x))


def _match(grid: CentroidGrid, src: torch.Tensor, mask: torch.Tensor, transform: torch.Tensor, max_d2: float):
    """Kernel 17's match pass: (stats [count, mu_y, mu_n, fitness], y, nn, w,
    partials scratch, n_blocks)."""
    n = src.shape[0]
    leaf_cap = _check_grid("icp_align", grid, grid.centroids, src, mask, transform)
    check_dtype("icp_align", src, torch.float32, (n, 3))
    check_dtype("icp_align", mask, torch.bool, (n,))
    check_dtype("icp_align", transform, torch.float32, (4, 4))
    dev = src.device
    n_blocks = max(1, -(-n // _BLOCK))
    y = torch.empty((n, 3), dtype=torch.float32, device=dev)
    nn = torch.empty((n, 3), dtype=torch.float32, device=dev)
    w = torch.empty((n,), dtype=torch.float32, device=dev)
    partials = torch.empty((n_blocks, 9), dtype=torch.float32, device=dev)
    stats = torch.empty((8,), dtype=torch.float32, device=dev)
    NN_POINTS_KERNEL.call(
        "lvs_icp_match", *_grid_args(grid, grid.centroids, leaf_cap), ptr(src), ptr(mask), n, ptr(transform),
        max_d2, ptr(y), ptr(nn), ptr(w), ptr(partials), n_blocks, ptr(stats),
    )
    return stats, y, nn, w, partials, n_blocks


def icp_step(grid: CentroidGrid, src: torch.Tensor, mask: torch.Tensor, transform: torch.Tensor,
             max_d2: float) -> torch.Tensor:
    """One ICP iteration (the reference's fori_loop body): the (4, 4)
    transform after the Kabsch update of `transform`. `src` is the source's
    masked xyz, `max_d2` the float32 squared correspondence distance.
    Kernel 17 on CUDA, the plain version on CPU."""
    if src.device.type == "cpu":
        return icp_step_ref(grid, src, mask, transform, max_d2)
    src, mask, transform = src.contiguous(), mask.contiguous(), transform.contiguous()
    stats, y, nn, w, partials, n_blocks = _match(grid, src, mask, transform, max_d2)
    out = torch.empty((4, 4), dtype=torch.float32, device=src.device)
    NN_POINTS_KERNEL.call(
        "lvs_icp_update", ptr(y), ptr(nn), ptr(w), src.shape[0], ptr(stats), ptr(partials), n_blocks,
        ptr(transform), ptr(out),
    )
    NN_POINTS_KERNEL.launches += 1
    return out


def _weights(grid, src, mask, transform, max_d2):
    y = se3.transform_points_fma(transform, src)
    d2, nn, valid = nn_points_ref(grid, y, mask)
    return y, d2, nn, valid & (d2 < max_d2)


def icp_step_ref(grid: CentroidGrid, src: torch.Tensor, mask: torch.Tensor, transform: torch.Tensor,
                 max_d2: float) -> torch.Tensor:
    """Plain PyTorch version of `icp_step`, line for line with the reference."""
    y, _, nn, ok = _weights(grid, src, mask, transform, max_d2)
    w = ok.to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mu_y = torch.sum(y * w[:, None], 0) / wsum
    mu_n = torch.sum(nn * w[:, None], 0) / wsum
    yc = (y - mu_y) * w[:, None]
    nc = nn - mu_n
    cov = yc.T @ nc
    u, _, vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(vt.T @ u.T))
    corr = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    rot = vt.T @ corr @ u.T
    t = mu_n - rot @ mu_y
    return se3.make_transform(rot, t) @ transform


def icp_fitness(grid: CentroidGrid, src: torch.Tensor, mask: torch.Tensor, transform: torch.Tensor,
                max_d2: float):
    """(fitness, n_matches): the mean squared distance of the pairs within
    the correspondence distance at `transform`, and their count (int32).
    Kernel 17's match pass on CUDA, the plain version on CPU."""
    if src.device.type == "cpu":
        return icp_fitness_ref(grid, src, mask, transform, max_d2)
    stats, *_ = _match(grid, src.contiguous(), mask.contiguous(), transform.contiguous(), max_d2)
    NN_POINTS_KERNEL.launches += 1
    return stats[7], stats[0].to(torch.int32)


def icp_fitness_ref(grid, src, mask, transform, max_d2):
    """Plain PyTorch version of `icp_fitness`."""
    _, d2, _, ok = _weights(grid, src, mask, transform, max_d2)
    n = torch.sum(ok.to(torch.float32))
    return torch.sum(torch.where(ok, d2, 0.0)) / torch.clamp(n, min=1.0), n.to(torch.int32)


def icp_align(
    target: PointCloud,
    source: PointCloud,
    guess: torch.Tensor,
    *,
    max_correspondence_distance: float = 2.0,
    max_iterations: int = 30,
    grid_cell: float = 0.25,
) -> ICPResult:
    """Align `source` onto `target` from `guess` by `max_iterations` ICP
    iterations (no early stop, as the reference's fori_loop)."""
    grid = build_centroid_grid(target, grid_cell)
    src, mask = source.masked_xyz().contiguous(), source.mask.contiguous()
    max_d2 = _sq32(max_correspondence_distance)
    transform = guess
    for _ in range(max_iterations):
        transform = icp_step(grid, src, mask, transform, max_d2)
    fitness, n = icp_fitness(grid, src, mask, transform, max_d2)
    return ICPResult(transform=transform, fitness=fitness, n_matches=n)
