"""Scan prefiltering: distance band, voxel downsampling, lane subsampling
and the `prefilter` chain (port of `lv_slam_tpu.ops.prefilter`; the outlier
removals and the vertical-angle calibration are not ported yet).

`voxel_downsample` is kernel 1 (`csrc/voxel_downsample.cu`) on CUDA tensors
and `voxel_downsample_ref`, its plain twin, on CPU tensors. Both sort the
same 64-bit voxel key with `torch.sort`; the hand kernel does everything
after the sort: run detection and the per-voxel reduction.
`voxel_dedup_first` is kernel 1b (`csrc/voxel_dedup.cu`) and
`voxel_dedup_first_ref` likewise: the same key and sort, then the first lane
of each voxel, compacted in key order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.config import PrefilterConfig
from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
from lv_slam_tpu_torch.kernels._build import F32, I32, PTR, Kernel, check_cuda, ptr
from lv_slam_tpu_torch.ops.linalg3 import dot3_fma, sqrt32

_BIG = 1 << 30  # kx of invalid lanes: sorts them behind every voxel
_YZ_OFF = 1 << 14
_YZ_LIM = (1 << 15) - 1

KERNEL = Kernel(
    "voxel_downsample",
    source="lv_slam_tpu_torch/csrc/voxel_downsample.cu",
    replaces="lv_slam_tpu/ops/prefilter.py:74",
    entries={
        "lvs_voxel_mark_runs": [PTR, I32, PTR],
        "lvs_voxel_reduce_runs": [PTR, PTR, PTR, PTR, I32, PTR, PTR, F32, I32, I32, PTR, PTR, PTR],
    },
)


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


def distance_filter(cloud: PointCloud, near: float, far: float) -> PointCloud:
    """Keep `near < |p| < far`. |p| rounds as the reference's compiled
    `jnp.linalg.norm` on the CPU: the fma chain fma(z, z, fma(y, y, x * x))
    under a correctly rounded root (a separately rounded sum, or torch's CPU
    float32 `sqrt`, flips lanes within an ulp of either band edge)."""
    dist = sqrt32(dot3_fma(cloud.xyz, cloud.xyz))
    keep = cloud.mask & (dist > near) & (dist < far)
    xyz = torch.where(keep[:, None], cloud.xyz, SENTINEL)
    return PointCloud(xyz, cloud.intensity, keep)


def _pack_yz(cy: torch.Tensor, cz: torch.Tensor) -> torch.Tensor:
    """Order-preserving pack of (cy, cz) into one key in [0, 2^30), coords
    clipped to [-16384, 16383] (the reference's limits)."""
    cy = torch.clamp(cy + _YZ_OFF, 0, _YZ_LIM)
    cz = torch.clamp(cz + _YZ_OFF, 0, _YZ_LIM)
    return cy * (1 << 15) + cz


def _unpack_yz(kyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return kyz // (1 << 15) - _YZ_OFF, kyz % (1 << 15) - _YZ_OFF


def _voxel_sort(cloud: PointCloud, resolution: float):
    """Sort lanes by voxel key: returns (sorted int64 keys, permutation,
    masked xyz). The key `kx * 2^31 + kyz` orders lanes exactly as the
    reference's two-key sort on (kx, packed kyz); invalid lanes carry
    kx = 2^30 and sort behind every voxel."""
    xyz = cloud.masked_xyz()
    coords = cell_coords(xyz, resolution)
    kx = torch.where(cloud.mask, coords[:, 0], _BIG)
    kyz = _pack_yz(coords[:, 1], coords[:, 2])
    key = kx.to(torch.int64) * (1 << 31) + kyz.to(torch.int64)
    skey, order = torch.sort(key, stable=True)
    return skey, order, xyz


DEDUP_KERNEL = Kernel(
    "voxel_dedup_first",
    source="lv_slam_tpu_torch/csrc/voxel_dedup.cu",
    replaces="lv_slam_tpu/ops/prefilter.py:203",
    entries={
        "lvs_dedup_keys": [PTR, PTR, I32, F32, PTR],
        "lvs_dedup_mark": [PTR, I32, PTR],
        "lvs_dedup_compact": [PTR, PTR, PTR, I32, PTR, PTR, I32, PTR, PTR, PTR],
    },
)


def _is_approx(method: str) -> bool:
    m = method.upper()
    if m not in ("VOXELGRID", "APPROX_VOXELGRID"):
        raise ValueError(f"voxel_downsample: unknown method {method!r}")
    return m == "APPROX_VOXELGRID"


def voxel_downsample(
    cloud: PointCloud, resolution: float, out_cap: int, method: str = "VOXELGRID"
) -> PointCloud:
    """Centroid (VOXELGRID) or cell-center (APPROX_VOXELGRID) downsampling,
    front-compacted into `out_cap` lanes in voxel-key order (the order that
    `stride_subsample` then slices). Kernel 1 on CUDA, the plain version on CPU."""
    approx = _is_approx(method)
    if cloud.xyz.device.type == "cpu":
        return voxel_downsample_ref(cloud, resolution, out_cap, method)
    if cloud.xyz.dtype != torch.float32 or cloud.intensity.dtype != torch.float32:
        raise ValueError("voxel_downsample: expected float32 xyz and intensity")
    skey, order, xyz = _voxel_sort(cloud, resolution)
    check_cuda("voxel_downsample", skey, order, xyz, cloud.intensity)
    out = reduce_runs(KERNEL, skey, order, xyz, cloud.intensity, resolution, approx, out_cap)
    KERNEL.launches += 1
    return out


def reduce_runs(kernel: Kernel, skey: torch.Tensor, order: torch.Tensor, xyz: torch.Tensor, inten: torch.Tensor,
                resolution: float, approx: bool, out_cap: int) -> PointCloud:
    """Kernel 1's part after the key sort (`csrc/voxel_downsample.cu`): run
    starts, their prefix sum (torch glue) and one centroid (or cell center)
    per run into `out_cap` lanes in key order, launched for `kernel` (K1, or
    K2r after its gather + band + transform pass)."""
    n = skey.shape[0]
    dev = skey.device
    flag = torch.empty((n,), dtype=torch.int32, device=dev)
    out_xyz = torch.empty((out_cap, 3), dtype=torch.float32, device=dev)
    out_int = torch.empty((out_cap,), dtype=torch.float32, device=dev)
    out_mask = torch.empty((out_cap,), dtype=torch.bool, device=dev)
    kernel.call("lvs_voxel_mark_runs", ptr(skey), n, ptr(flag))
    cum = torch.cumsum(flag, dim=0, dtype=torch.int32)  # run index + 1 at each run start
    kernel.call(
        "lvs_voxel_reduce_runs",
        ptr(skey), ptr(order), ptr(flag), ptr(cum), n, ptr(xyz), ptr(inten),
        float(np.float32(resolution)), int(approx), out_cap,
        ptr(out_xyz), ptr(out_int), ptr(out_mask),
    )
    return PointCloud(out_xyz, out_int, out_mask)


def voxel_downsample_ref(
    cloud: PointCloud, resolution: float, out_cap: int, method: str = "VOXELGRID"
) -> PointCloud:
    """Plain PyTorch version of `voxel_downsample` (the reference's
    `reduce="scatter"` path: sort, run starts, segment sums)."""
    approx = _is_approx(method)
    n = cloud.cap
    skey, order, xyz = _voxel_sort(cloud, resolution)
    skx = skey // (1 << 31)
    smask = skx < _BIG
    sxyz = xyz[order]
    sint = cloud.intensity[order]
    new_seg = torch.ones((n,), dtype=torch.bool, device=skey.device)
    new_seg[1:] = skey[1:] != skey[:-1]
    new_seg &= smask
    seg_in = torch.cat(
        [
            torch.where(smask[:, None], sxyz, 0.0),
            torch.where(smask, sint, 0.0)[:, None],
            smask.to(torch.float32)[:, None],
        ],
        dim=1,
    )
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1
    seg_id = torch.where(smask, seg_id, n)  # invalid lanes -> scratch row n
    sums = torch.zeros((n + 1, 5), dtype=torch.float32, device=skey.device)
    sums.index_add_(0, seg_id, seg_in)
    sums = sums[:out_cap]
    counts = sums[:, 4]
    cnt = torch.clamp(counts, min=1.0)
    if approx:
        sky, skz = _unpack_yz(skey % (1 << 31))
        sc = torch.stack([skx, sky, skz], dim=1)
        cell = torch.full((n + 1, 3), -_BIG, dtype=torch.int64, device=skey.device)
        cell.scatter_reduce_(
            0, seg_id[:, None].expand(n, 3), torch.where(smask[:, None], sc, -_BIG), "amax"
        )
        res = torch.full((1,), resolution, dtype=torch.float32, device=skey.device)
        pts = (cell[:out_cap].to(torch.float32) + 0.5) * res
    else:
        pts = sums[:, 0:3] / cnt[:, None]
    inten = sums[:, 3] / cnt
    valid = counts > 0
    out = PointCloud(
        torch.where(valid[:, None], pts, SENTINEL), torch.where(valid, inten, 0.0), valid
    )
    if out.cap < out_cap:
        pad = out_cap - out.cap
        out = PointCloud(
            torch.cat([out.xyz, out.xyz.new_full((pad, 3), SENTINEL)]),
            torch.cat([out.intensity, out.intensity.new_zeros(pad)]),
            torch.cat([out.mask, out.mask.new_zeros(pad)]),
        )
    return out


def voxel_dedup_first(cloud: PointCloud, resolution: float, out_cap: int) -> PointCloud:
    """The first input lane of each occupied voxel, front-compacted in
    voxel-key order into min(cap, out_cap) lanes (the reference's slice).
    Ties in the stable key sort keep the lower input index. Kernel 1b on
    CUDA, the plain version on CPU."""
    if cloud.xyz.device.type == "cpu":
        return voxel_dedup_first_ref(cloud, resolution, out_cap)
    if cloud.xyz.dtype != torch.float32 or cloud.intensity.dtype != torch.float32:
        raise ValueError("voxel_dedup_first: expected float32 xyz and intensity")
    n = cloud.cap
    xyz, inten, mask = cloud.xyz.contiguous(), cloud.intensity.contiguous(), cloud.mask.contiguous()
    check_cuda("voxel_dedup_first", xyz, inten, mask)
    key = torch.empty((n,), dtype=torch.int64, device=xyz.device)
    DEDUP_KERNEL.call("lvs_dedup_keys", ptr(xyz), ptr(mask), n, inv_resolution(resolution), ptr(key))
    out = dedup_compact(DEDUP_KERNEL, key, xyz, inten, out_cap)
    DEDUP_KERNEL.launches += 1
    return out


def dedup_compact(kernel: Kernel, key: torch.Tensor, xyz: torch.Tensor, inten: torch.Tensor,
                  out_cap: int) -> PointCloud:
    """The stable key sort (torch glue) and the run-start compaction of
    `csrc/voxel_dedup.cu`, launched for `kernel` (K1b, or K2 after its
    gather + transform pass)."""
    n = key.shape[0]
    out_cap = min(n, out_cap)
    dev = key.device
    skey, order = torch.sort(key, stable=True)
    flag = torch.empty((n,), dtype=torch.int32, device=dev)
    out_xyz = torch.empty((out_cap, 3), dtype=torch.float32, device=dev)
    out_int = torch.empty((out_cap,), dtype=torch.float32, device=dev)
    out_mask = torch.empty((out_cap,), dtype=torch.bool, device=dev)
    kernel.call("lvs_dedup_mark", ptr(skey), n, ptr(flag))
    cum = torch.cumsum(flag, dim=0, dtype=torch.int32)  # run index + 1 at each run start
    kernel.call(
        "lvs_dedup_compact", ptr(order), ptr(flag), ptr(cum), n, ptr(xyz), ptr(inten), out_cap,
        ptr(out_xyz), ptr(out_int), ptr(out_mask),
    )
    return PointCloud(out_xyz, out_int, out_mask)


def voxel_dedup_first_ref(cloud: PointCloud, resolution: float, out_cap: int) -> PointCloud:
    """Plain PyTorch version of `voxel_dedup_first`, line for line with the
    reference: stable key sort, run starts, a stable argsort that moves the
    winners to the front."""
    skey, order, xyz = _voxel_sort(cloud, resolution)
    new_seg = torch.ones_like(skey, dtype=torch.bool)
    new_seg[1:] = skey[1:] != skey[:-1]
    winner = new_seg & (skey // (1 << 31) < _BIG)
    sel = torch.argsort((~winner).to(torch.uint8), stable=True)[:out_cap]
    src = order[sel]
    ok = winner[sel]
    return PointCloud(
        torch.where(ok[:, None], xyz[src], SENTINEL), torch.where(ok, cloud.intensity[src], 0.0), ok
    )


def stride_subsample(cloud: PointCloud, out_cap: int) -> PointCloud:
    """Every (cap/out_cap)-th lane, mask holes and all (no compaction)."""
    n = cloud.cap
    if out_cap >= n:
        return cloud
    if n % out_cap != 0:
        raise ValueError(f"stride_subsample needs cap % out_cap == 0, got {n} % {out_cap}")
    k = n // out_cap
    return PointCloud(cloud.xyz[::k], cloud.intensity[::k], cloud.mask[::k])


def uniform_subsample(cloud: PointCloud, out_cap: int) -> PointCloud:
    """Evenly-strided subsample of a front-compacted cloud to `out_cap` lanes
    (`OdometryConfig.subsample_method="gather"`); the stride is float32 as
    in the reference, since `i * count` overflows int32 at KITTI density."""
    n = cloud.cap
    if out_cap >= n:
        return cloud
    cnt = torch.sum(cloud.mask.to(torch.int32))
    take = torch.clamp(cnt, max=out_cap)
    i = torch.arange(out_cap, dtype=torch.int32, device=cloud.xyz.device)
    step = cnt.to(torch.float32) / torch.clamp(take, min=1).to(torch.float32)
    idx = torch.floor(i.to(torch.float32) * step).to(torch.int64)
    ok = i < take
    idx = torch.where(ok, torch.clamp(idx, 0, n - 1), 0)
    return PointCloud(
        torch.where(ok[:, None], cloud.xyz[idx], SENTINEL),
        torch.where(ok, cloud.intensity[idx], 0.0),
        ok & cloud.mask[idx],
    )


def prefilter(cloud: PointCloud, cfg: PrefilterConfig) -> PointCloud:
    """The prefiltering chain (`prefiltering_nodelet.cpp:92-135`): the
    distance band, then VOXELGRID / APPROX_VOXELGRID (kernel 1), DEDUP
    (kernel 1b) or, for NONE, a front compaction to `out_cap` lanes.
    `voxel_reduce` picks between two TPU implementations of the same
    centroid ("scatter", "scan"), so kernel 1 serves both."""
    if cfg.use_angle_calibration:
        raise NotImplementedError("the vertical-angle calibration is ROADMAP item 6")
    if cfg.outlier_removal_method.upper() != "NONE":
        raise NotImplementedError(
            f"outlier_removal_method={cfg.outlier_removal_method!r}: the outlier removals are ROADMAP item 6"
        )
    if cfg.voxel_reduce not in ("scatter", "scan"):
        raise ValueError(f"voxel_reduce must be 'scatter' or 'scan', got {cfg.voxel_reduce!r}")
    out = cloud
    if cfg.use_distance_filter:
        out = distance_filter(out, cfg.distance_near_thresh, cfg.distance_far_thresh)
    method = cfg.downsample_method.upper()
    if method in ("VOXELGRID", "APPROX_VOXELGRID"):
        return voxel_downsample(out, cfg.downsample_resolution, cfg.out_cap, method)
    if method == "DEDUP":
        return voxel_dedup_first(out, cfg.downsample_resolution, cfg.out_cap)
    return out.compact(cfg.out_cap)
