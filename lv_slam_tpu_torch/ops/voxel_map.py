"""Voxel-Gaussian NDT map build, its dense voxel->leaf LUT and the DIRECT
neighbourhood lookup (port of `lv_slam_tpu.ops.voxel_map`).

`build_voxel_map` is kernel 3 (`csrc/voxel_map.cu`, with the 3x3 eigh of
`csrc/linalg3.cuh`) on CUDA tensors and `build_voxel_map_ref`, its plain
twin, on CPU tensors. The twin sorts the flat voxel key with `torch.sort`;
the hand kernel sorts the same order in a key of the fewest bits with its
own radix passes (`csrc/key_sort.cuh`) and builds the leaves, one C call
with no torch op between its launches.

The reference builds the dense LUT inside every map build. The port's
`VoxelMap` carries each leaf's flat key instead, and `build_lut` (kernel
K3L, same file) scatters the E^3 table only for the callers that probe it
(the host DLO and the fused odometry's `table="lut"`): the hash-table path
and the loop detector's per-candidate maps never read a LUT, and at the
flagship's E = 256 it is 64 MiB. `lookup_leaves` is the LUT probe of the
generic derivative pass, in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.kernels._build import (
    F32, I32, MAX_SORT_LANES, PTR, Kernel, check_cuda, check_dtype, ptr, scratch_bytes,
)
from lv_slam_tpu_torch.ops.linalg3 import eigh3x3
from lv_slam_tpu_torch.ops.cells import cell_coords, floor_cells, floor_cells_div, inv_resolution

_BIG = 1 << 30
_MAX_EXTENT = 1290  # the kernel's flat key (rel0 * e + rel1) * e + rel2 is an int32

LUT_KERNEL = Kernel(
    "build_lut",
    source="lv_slam_tpu_torch/csrc/voxel_map.cu",
    replaces="lv_slam_tpu/ops/voxel_map.py:177",
    entries={"lvs_voxel_map_lut": [PTR, PTR, I32, I32, PTR]},
)
KERNEL = Kernel(
    "build_voxel_map",
    source="lv_slam_tpu_torch/csrc/voxel_map.cu",
    replaces="lv_slam_tpu/ops/voxel_map.py:66",
    entries={
        "lvs_voxel_map": [
            PTR, I32, PTR, I32, I32, F32, F32, I32, I32, I32, F32, I32, PTR, ctypes.c_longlong,
            PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR,
        ],
    },
)


class VoxelMap(NamedTuple):
    """Fixed-capacity voxel-Gaussian map; leaves in ascending flat-key order."""

    means: torch.Tensor        # (L, 3) voxel Gaussian means
    icovs: torch.Tensor        # (L, 3, 3) inflated inverse covariances
    weights: torch.Tensor      # (L,) PCA dimension weight (1.0 if unweighted)
    normals: torch.Tensor      # (L, 3) min-eigenvalue direction
    valid: torch.Tensor        # (L,) bool
    keys: torch.Tensor         # (L,) int32 flat key of each leaf's voxel, -1 where no voxel reached the leaf
    origin_cell: torch.Tensor  # (3,) int32 cell of key (0,0,0)
    resolution: float
    n_leaves: torch.Tensor     # () int32
    extent: int                # flat key = (rel0 * e + rel1) * e + rel2

    @property
    def leaf_cap(self) -> int:
        return self.means.shape[0]


class LutMap(NamedTuple):
    """A map with its dense LUT, as the LUT paths carry a keyframe map."""

    vmap: VoxelMap
    lut: torch.Tensor  # (E^3,) int32


@functools.lru_cache(maxsize=None)
def _offsets(name: str, device: str) -> torch.Tensor:
    name = name.upper()
    if name == "DIRECT1":
        off = [(0, 0, 0)]
    elif name == "DIRECT7":
        off = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    elif name == "DIRECT26":
        off = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]
    else:
        raise ValueError(f"unknown neighborhood {name!r} (KDTREE is subsumed by DIRECT modes)")
    return torch.tensor(off, dtype=torch.int32, device=device)


def neighborhood_offsets(name: str, device) -> torch.Tensor:
    """DIRECT1 / DIRECT7 / DIRECT26 cell offsets, (K,3) int32, in the
    reference's order. Cached per device: the odometry asks for them every
    align, and a fresh host-to-device copy would wait for the stream."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # one cache entry for "cuda" and "cuda:<current>"
        dev = torch.device("cuda", torch.cuda.current_device())
    return _offsets(name, str(dev))


def _leaf_sort(cloud: PointCloud, resolution: float, e: int):
    """Sort lanes by flat voxel key relative to the masked min cell; lanes
    out of the extent (or masked) carry the overflow key e^3."""
    xyz = cloud.masked_xyz()
    mask = cloud.mask
    coords = cell_coords(xyz, resolution)
    origin = torch.where(mask[:, None], coords, _BIG).amin(dim=0)
    origin = torch.where(origin == _BIG, 0, origin)
    rel = coords - origin
    in_extent = torch.all((rel >= 0) & (rel < e), dim=1) & mask
    flat = (rel[:, 0] * e + rel[:, 1]) * e + rel[:, 2]
    keys = torch.where(in_extent, flat, e * e * e)
    skeys, order = torch.sort(keys, stable=True)
    return skeys, order, xyz, origin.to(torch.int32)


def build_voxel_map(
    cloud: PointCloud,
    resolution: float,
    leaf_cap: int = 32768,
    lut_extent: int = 256,
    min_points_per_voxel: int = 6,
    min_covar_eigvalue_mult: float = 0.01,
    weighted: bool = False,
) -> VoxelMap:
    """Build the NDT map from a padded, masked cloud. Kernel 2 on CUDA, the
    plain version on CPU."""
    if cloud.xyz.device.type == "cpu":
        return build_voxel_map_ref(
            cloud, resolution, leaf_cap, lut_extent, min_points_per_voxel,
            min_covar_eigvalue_mult, weighted,
        )
    if cloud.xyz.dtype != torch.float32:
        raise ValueError("build_voxel_map: expected float32 xyz")
    e = lut_extent
    n = cloud.cap
    if n > MAX_SORT_LANES:
        raise ValueError(f"build_voxel_map: {n} lanes exceed the key sort's {MAX_SORT_LANES}")
    if not 1 <= e <= _MAX_EXTENT:
        raise ValueError(f"build_voxel_map: lut_extent {e} outside [1, {_MAX_EXTENT}]")
    xyz, mask = cloud.xyz, cloud.mask  # a lane-strided subsample is read in place
    if xyz.dim() != 2 or xyz.stride(1) != 1 or xyz.stride(0) < 3:
        xyz = xyz.contiguous()
    if mask.dim() != 1 or mask.stride(0) < 1:
        mask = mask.contiguous()
    check_cuda("build_voxel_map", xyz, mask, lane_strided=True)
    check_dtype("build_voxel_map", xyz, torch.float32, (n, 3))
    check_dtype("build_voxel_map", mask, torch.bool, (n,))
    dev = xyz.device
    scratch = torch.empty((scratch_bytes("lvs_voxel_map_scratch_bytes", n),), dtype=torch.uint8, device=dev)
    means = torch.empty((leaf_cap, 3), dtype=torch.float32, device=dev)
    icovs = torch.empty((leaf_cap, 3, 3), dtype=torch.float32, device=dev)
    weights = torch.empty((leaf_cap,), dtype=torch.float32, device=dev)
    normals = torch.empty((leaf_cap, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((leaf_cap,), dtype=torch.bool, device=dev)
    keys = torch.empty((leaf_cap,), dtype=torch.int32, device=dev)
    origin = torch.empty((3,), dtype=torch.int32, device=dev)
    n_leaves = torch.empty((), dtype=torch.int32, device=dev)
    KERNEL.call(
        "lvs_voxel_map", ptr(xyz), xyz.stride(0), ptr(mask), mask.stride(0), n, float(np.float32(resolution)),
        inv_resolution(resolution), e, leaf_cap, min_points_per_voxel, float(np.float32(min_covar_eigvalue_mult)),
        int(weighted), ptr(scratch), scratch.numel(), ptr(means), ptr(icovs), ptr(weights), ptr(normals), ptr(valid),
        ptr(keys), ptr(origin), ptr(n_leaves),
    )
    KERNEL.launches += 1
    return VoxelMap(
        means=means, icovs=icovs, weights=weights, normals=normals, valid=valid, keys=keys,
        origin_cell=origin, resolution=float(resolution), n_leaves=n_leaves, extent=e,
    )


def build_voxel_map_ref(
    cloud: PointCloud,
    resolution: float,
    leaf_cap: int = 32768,
    lut_extent: int = 256,
    min_points_per_voxel: int = 6,
    min_covar_eigvalue_mult: float = 0.01,
    weighted: bool = False,
) -> VoxelMap:
    """Plain PyTorch version of `build_voxel_map` (sort, segment sums,
    vectorized eigh), line for line with the reference."""
    e = lut_extent
    n = cloud.cap
    dev = cloud.xyz.device
    skeys, order, xyz, origin = _leaf_sort(cloud, resolution, e)
    svalid = skeys < e * e * e
    new_seg = torch.ones((n,), dtype=torch.bool, device=dev)
    new_seg[1:] = skeys[1:] != skeys[:-1]
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1
    seg_id = torch.where(svalid & (seg_id < leaf_cap), seg_id, leaf_cap)

    sxyz = xyz[order]
    res = torch.full((1,), resolution, dtype=torch.float32, device=dev)
    inv = torch.full((1,), inv_resolution(resolution), dtype=torch.float32, device=dev)
    cell_center = (floor_cells(sxyz, inv) + 0.5) * res
    centered = torch.where(svalid[:, None], sxyz - cell_center, 0.0)
    outer = centered[:, :, None] * centered[:, None, :]
    seg_in = torch.cat([svalid.to(torch.float32)[:, None], centered, outer.reshape(n, 9)], dim=1)
    # seg_id never decreases, so the runs are segments of the sorted lanes;
    # segment_reduce sums each in lane order on CPU and card alike (the
    # reference's and the kernel's order), where index_add_ on the card adds
    # with atomics in no fixed order.
    lengths = torch.bincount(seg_id, minlength=leaf_cap + 1)
    sums = torch.segment_reduce(seg_in, "sum", lengths=lengths, axis=0, unsafe=True)[:leaf_cap]
    counts = sums[:, 0]
    sum_c = sums[:, 1:4]
    sum_cc = sums[:, 4:13].reshape(leaf_cap, 3, 3)
    seg_key = torch.full((leaf_cap + 1,), -1, dtype=torch.int32, device=dev)
    seg_key.scatter_reduce_(0, seg_id, torch.where(svalid, skeys, -1).to(torch.int32), "amax")
    seg_key = seg_key[:leaf_cap]

    cnt = torch.clamp(counts, min=1.0)
    mean_c = sum_c / cnt[:, None]
    cov = sum_cc / cnt[:, None, None] - mean_c[:, :, None] * mean_c[:, None, :]
    cov = cov * ((cnt - 1.0) / cnt)[:, None, None]

    kz = seg_key % e
    ky = (seg_key // e) % e
    kx = seg_key // (e * e)
    leaf_cell = torch.stack([kx, ky, kz], dim=1) + origin
    means = (leaf_cell.to(torch.float32) + 0.5) * res + mean_c

    leaf_occupied = (seg_key >= 0) & (counts >= min_points_per_voxel)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    evals, evecs = eigh3x3(torch.where(leaf_occupied[:, None, None], cov, eye))
    tol = 1e-5 * torch.abs(evals[:, 2])
    pos_def = (evals[:, 0] >= -tol) & (evals[:, 1] >= -tol) & (evals[:, 2] > 0)
    min_ev = min_covar_eigvalue_mult * evals[:, 2]
    evals_inf = torch.maximum(evals, min_ev[:, None])
    inv_evals = 1.0 / torch.clamp(evals_inf, min=1e-30)
    icovs = torch.einsum("lij,lj,lkj->lik", evecs, inv_evals, evecs)
    finite = torch.all(torch.isfinite(icovs.reshape(leaf_cap, 9)), dim=1)
    valid = leaf_occupied & pos_def & finite

    if weighted:
        sigma = torch.sqrt(torch.clamp(evals_inf, min=0.0))
        s_max = torch.clamp(sigma[:, 2], min=1e-30)
        feats = torch.stack(
            [
                (sigma[:, 2] - sigma[:, 1]) / s_max,   # linear-ness
                (sigma[:, 1] - sigma[:, 0]) / s_max,   # planar-ness
                sigma[:, 0] / s_max,                   # spherical-ness
            ],
            dim=1,
        )
        label = torch.argmax(feats, dim=1)
        scales = torch.tensor([0.75, 1.25, 1.0], dtype=torch.float32).to(dev)
        weights = scales[label] * torch.sqrt(torch.sum(means * means, dim=1))
    else:
        weights = torch.ones((leaf_cap,), dtype=torch.float32, device=dev)
    weights = torch.where(valid, weights, 0.0)

    return VoxelMap(
        means=torch.where(valid[:, None], means, 0.0),
        icovs=torch.where(valid[:, None, None], icovs, 0.0),
        weights=weights,
        normals=torch.where(valid[:, None], evecs[:, :, 0], 0.0),
        valid=valid,
        keys=seg_key,
        origin_cell=origin,
        resolution=float(resolution),
        n_leaves=torch.sum(valid.to(torch.int32)),
        extent=e,
    )


def build_lut(vmap_: VoxelMap) -> torch.Tensor:
    """The dense (E^3,) int32 voxel->leaf table: -1 everywhere, the row of
    each valid leaf at its flat key (the reference's scatter inside
    `build_voxel_map`). Keys are unique, so the table is deterministic.
    Kernel K3L on CUDA, the plain version on CPU."""
    if vmap_.keys.device.type == "cpu":
        return build_lut_ref(vmap_)
    e3 = vmap_.extent ** 3
    check_cuda("build_lut", vmap_.keys, vmap_.valid)
    check_dtype("build_lut", vmap_.keys, torch.int32, (vmap_.leaf_cap,))
    check_dtype("build_lut", vmap_.valid, torch.bool, (vmap_.leaf_cap,))
    lut = torch.empty((e3,), dtype=torch.int32, device=vmap_.keys.device)
    LUT_KERNEL.call("lvs_voxel_map_lut", ptr(vmap_.keys), ptr(vmap_.valid), vmap_.leaf_cap, e3, ptr(lut))
    LUT_KERNEL.launches += 1
    return lut


def build_lut_ref(vmap_: VoxelMap) -> torch.Tensor:
    """Plain PyTorch version of `build_lut`."""
    dev = vmap_.keys.device
    lut = torch.full((vmap_.extent ** 3,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(vmap_.leaf_cap, dtype=torch.int32, device=dev)
    lut[vmap_.keys[vmap_.valid].to(torch.int64)] = rows[vmap_.valid]
    return lut


def probe_cells(points: torch.Tensor, origin_cell: torch.Tensor, resolution: float) -> torch.Tensor:
    """(..., 3) int32 cells of `points` relative to the map origin, as the
    reference's LUT probes compute them: `floor(points / res)` by a true
    float32 division, since the resolution is an array there (the map build
    multiplies by the reciprocal; at a non-power-of-two resolution the two
    differ within an ulp of a cell face), subnormals flushed as `ops/cells`
    sets out."""
    return floor_cells_div(points, resolution).to(torch.int32) - origin_cell


def lookup_leaves(vmap_: VoxelMap, lut: torch.Tensor, points: torch.Tensor, offsets: torch.Tensor):
    """Leaf Gaussians at each point's DIRECT-K neighbourhood through the LUT:
    points (N, 3), offsets (K, 3) int32 -> (means (N, K, 3), icovs
    (N, K, 3, 3), weights (N, K), hit (N, K)); a miss reads leaf 0."""
    e = vmap_.extent
    rel = probe_cells(points, vmap_.origin_cell, vmap_.resolution)[:, None, :] + offsets[None, :, :]
    in_extent = torch.all((rel >= 0) & (rel < e), dim=-1)
    flat = (rel[..., 0] * e + rel[..., 1]) * e + rel[..., 2]
    leaf = lut[torch.where(in_extent, flat, 0).to(torch.int64)]
    hit = in_extent & (leaf >= 0)
    leaf = torch.where(hit, leaf, 0).to(torch.int64)
    return vmap_.means[leaf], vmap_.icovs[leaf], vmap_.weights[leaf], hit


def leaf_eigen_ratio(
    cloud: PointCloud, resolution: float, leaf_cap: int = 32768, lut_extent: int = 256
) -> torch.Tensor:
    """(leaf_cap,) float64 lambda0 / lambda2 of each leaf's covariance,
    computed in float64 from the lanes the map build puts in that leaf (leaf
    indices as in `build_voxel_map`); inf for a leaf with no spread.

    A float32 build decides `pos_def` on its Cardano lambda0, whose rounding
    noise for flat leaves reaches the -1e-5 * lambda2 threshold, so two
    float32 builds that round differently may disagree on the validity of
    leaves with a small ratio, and only there."""
    e = lut_extent
    skeys, order, xyz, _ = _leaf_sort(cloud.to("cpu"), resolution, e)
    start = torch.ones_like(skeys, dtype=torch.bool)
    start[1:] = skeys[1:] != skeys[:-1]
    seg = torch.cumsum(start.to(torch.int64), 0) - 1
    seg = torch.where((skeys < e**3) & (seg < leaf_cap), seg, leaf_cap)
    p = xyz[order].double()
    cnt = torch.zeros(leaf_cap + 1, dtype=torch.float64).index_add_(0, seg, torch.ones_like(p[:, 0]))
    mean = torch.zeros(leaf_cap + 1, 3, dtype=torch.float64).index_add_(0, seg, p)
    mean = mean / cnt.clamp(min=1.0)[:, None]
    c = p - mean[seg]
    cov = torch.zeros(leaf_cap + 1, 3, 3, dtype=torch.float64)
    cov.index_add_(0, seg, c[:, :, None] * c[:, None, :])
    ev = torch.linalg.eigvalsh((cov / cnt.clamp(min=1.0)[:, None, None])[:leaf_cap])
    ratio = torch.where(ev[:, 2] > 0, ev[:, 0] / ev[:, 2].clamp(min=1e-300), torch.inf)
    return ratio.to(cloud.xyz.device)
