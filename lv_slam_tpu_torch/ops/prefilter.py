"""Scan prefiltering: the vertical-angle calibration, distance band, voxel
downsampling, lane subsampling and the `prefilter` chain with its outlier
removals (port of `lv_slam_tpu.ops.prefilter`).

`voxel_downsample` is kernel 1 (`csrc/voxel_downsample.cu`, with the key
sort of `csrc/key_sort.cuh`) on CUDA tensors and `voxel_downsample_ref`, its
plain twin, on CPU tensors. The twin sorts the 64-bit voxel key with
`torch.sort`; the hand kernel sorts a key rebased into the fewest bits with
its own radix passes and reduces the runs, with no torch op between its
launches.
`voxel_dedup_first` is kernel 1b (`csrc/voxel_dedup.cu`, over kernel 1's key
front end and sort) and `voxel_dedup_first_ref` likewise: the same key and
sort, then the first lane of each voxel, compacted in key order.
`vertical_angle_calibration` is kernel 0a (`csrc/angle_calibration.cu`,
`prefilter_front`) and `vertical_angle_calibration_ref` likewise; the same
kernel is the distance band (`distance_filter` / `distance_filter_ref`) and
the two in one pass (`calibrated_band`, which `prefilter` calls when both
stages are on, and `calibrated_band_ref`, the twins composed);
`uniform_subsample` is kernel 21
(`csrc/subsample.cu`, one launch: the mask's count and the gather) and
`uniform_subsample_ref` likewise. The outlier removals are `ops.nn`'s
kernel 18.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.config import PrefilterConfig
from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
from lv_slam_tpu_torch.kernels._build import F32, I32, MAX_SORT_LANES, PTR, Kernel, check_cuda, ptr, scratch_bytes
from lv_slam_tpu_torch.ops import nn
from lv_slam_tpu_torch.ops.cells import cell_coords, inv_resolution
from lv_slam_tpu_torch.ops.linalg3 import dot3_fma, fma32, sqrt32

_BIG = 1 << 30  # kx of invalid lanes: sorts them behind every voxel
_YZ_OFF = 1 << 14
_YZ_LIM = (1 << 15) - 1

KERNEL = Kernel(
    "voxel_downsample",
    source="lv_slam_tpu_torch/csrc/voxel_downsample.cu",
    replaces="lv_slam_tpu/ops/prefilter.py:74",
    entries={
        "lvs_voxel_downsample": [PTR, PTR, PTR, I32, F32, F32, I32, I32, PTR, ctypes.c_longlong, PTR, PTR, PTR],
    },
)


_FRONT_ENTRY = {"lvs_prefilter_front": [PTR, PTR, I32, I32, F32, I32, F32, F32, PTR, PTR]}
CALIBRATION_KERNEL = Kernel(
    "vertical_angle_calibration",
    source="lv_slam_tpu_torch/csrc/angle_calibration.cu",
    replaces="lv_slam_tpu/ops/prefilter.py:33",
    entries=_FRONT_ENTRY,
)
BAND_KERNEL = Kernel(
    "distance_filter",
    source="lv_slam_tpu_torch/csrc/angle_calibration.cu",
    replaces="lv_slam_tpu/ops/prefilter.py:26",
    entries=_FRONT_ENTRY,
)


def _deg2rad32(angle_deg: float) -> float:
    """float32(angle) * float32(pi / 180), as `jnp.deg2rad` rounds it."""
    return float(np.float32(angle_deg) * np.float32(np.pi / 180.0))


def _front(kernel: Kernel, name: str, cloud: PointCloud, angle_deg: Optional[float],
           band: Optional[Tuple[float, float]]) -> PointCloud:
    """One launch of `prefilter_front` on a CUDA cloud: the calibration by
    `angle_deg` and / or the band (near, far)."""
    if cloud.xyz.dtype != torch.float32 or cloud.mask.dtype != torch.bool:
        raise ValueError(f"{name}: expected float32 xyz and a bool mask")
    xyz, mask = cloud.xyz.contiguous(), cloud.mask.contiguous()
    check_cuda(name, xyz, mask)
    out = torch.empty_like(xyz)
    keep = None if band is None else torch.empty_like(mask)
    near, far = (float(np.float32(v)) for v in band) if band is not None else (0.0, 0.0)
    kernel.call(
        "lvs_prefilter_front", ptr(xyz), ptr(mask), cloud.cap, int(angle_deg is not None),
        0.0 if angle_deg is None else _deg2rad32(angle_deg), int(band is not None), near, far, ptr(out),
        None if keep is None else ptr(keep),
    )
    kernel.launches += 1
    return PointCloud(out, cloud.intensity, cloud.mask if keep is None else keep)


def vertical_angle_calibration(cloud: PointCloud, angle_base_deg: float) -> PointCloud:
    """Rotate each point `angle_base_deg` degrees about the unit axis p x z
    (the reference's per-point HDL-64 elevation fix,
    `prefiltering_nodelet.cpp:183-220`); masked lanes take the sentinel.
    Kernel 0a on CUDA, the plain version on CPU."""
    if cloud.xyz.device.type == "cpu":
        return vertical_angle_calibration_ref(cloud, angle_base_deg)
    return _front(CALIBRATION_KERNEL, "vertical_angle_calibration", cloud, angle_base_deg, None)


def vertical_angle_calibration_ref(cloud: PointCloud, angle_base_deg: float) -> PointCloud:
    """Plain PyTorch version of `vertical_angle_calibration`: the
    reference's cross product, norm, `exp_so3` and einsum, each contraction
    the fma chain XLA makes of it on the CPU (0 coordinates differ from JAX
    on 800k points at 0.11, 1.7 and 45 degrees)."""
    p = cloud.xyz
    px, py = p[:, 0], p[:, 1]
    den = torch.clamp(sqrt32(fma32(px, px, py * py)), min=1e-12)  # |p x z|, p x z = (y, -x, 0)
    angle = torch.full((), _deg2rad32(angle_base_deg), dtype=p.dtype, device=p.device)
    x, y = (py / den) * angle, (-px / den) * angle
    zero = torch.zeros_like(x)
    tsq = fma32(y, y, x * x)
    small = tsq < 1e-8
    safe_tsq = torch.where(small, 1.0, tsq)
    t = sqrt32(safe_tsq)
    a = torch.where(small, 1.0 - tsq / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - tsq / 24.0, (1.0 - torch.cos(t)) / safe_tsq)
    k = torch.stack([torch.stack([zero, -zero, y], -1), torch.stack([zero, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    kk = fma32(k[:, :, 2, None], k[:, None, 2, :], fma32(k[:, :, 1, None], k[:, None, 1, :],
                                                         k[:, :, 0, None] * k[:, None, 0, :]))
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand_as(k)
    rot = fma32(b[:, None, None].expand_as(k), kk, fma32(a[:, None, None].expand_as(k), k, eye))
    xyz = dot3_fma(rot, p[:, None, :].expand_as(rot))
    return PointCloud(torch.where(cloud.mask[:, None], xyz, SENTINEL), cloud.intensity, cloud.mask)


def distance_filter(cloud: PointCloud, near: float, far: float) -> PointCloud:
    """Keep `near < |p| < far`; the other lanes take the sentinel. |p|
    rounds as the reference's compiled `jnp.linalg.norm` on the CPU (see
    `distance_filter_ref`). Kernel 0a's band on CUDA (one launch), the plain
    version on CPU."""
    if cloud.xyz.device.type == "cpu":
        return distance_filter_ref(cloud, near, far)
    return _front(BAND_KERNEL, "distance_filter", cloud, None, (near, far))


def distance_filter_ref(cloud: PointCloud, near: float, far: float) -> PointCloud:
    """Plain PyTorch version of `distance_filter`. |p| is the fma chain
    fma(z, z, fma(y, y, x * x)) under a correctly rounded root (a separately
    rounded sum, or torch's CPU float32 `sqrt`, flips lanes within an ulp of
    either band edge)."""
    dist = sqrt32(dot3_fma(cloud.xyz, cloud.xyz))
    keep = cloud.mask & (dist > near) & (dist < far)
    xyz = torch.where(keep[:, None], cloud.xyz, SENTINEL)
    return PointCloud(xyz, cloud.intensity, keep)


def calibrated_band(cloud: PointCloud, angle_base_deg: float, near: float, far: float) -> PointCloud:
    """`distance_filter(vertical_angle_calibration(cloud, angle_base_deg),
    near, far)` in one launch of kernel 0a on CUDA (the band tests the
    calibrated point in registers), the twins composed on CPU."""
    if cloud.xyz.device.type == "cpu":
        return calibrated_band_ref(cloud, angle_base_deg, near, far)
    return _front(CALIBRATION_KERNEL, "vertical_angle_calibration", cloud, angle_base_deg, (near, far))


def calibrated_band_ref(cloud: PointCloud, angle_base_deg: float, near: float, far: float) -> PointCloud:
    """Plain PyTorch version of `calibrated_band`: the two twins composed."""
    return distance_filter_ref(vertical_angle_calibration_ref(cloud, angle_base_deg), near, far)


def _pack_yz(cy: torch.Tensor, cz: torch.Tensor) -> torch.Tensor:
    """Order-preserving pack of (cy, cz) into one key in [0, 2^30), coords
    clipped to [-16384, 16383] (the reference's limits)."""
    cy = torch.clamp(cy + _YZ_OFF, 0, _YZ_LIM)
    cz = torch.clamp(cz + _YZ_OFF, 0, _YZ_LIM)
    return cy * (1 << 15) + cz


def _unpack_yz(kyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return kyz // (1 << 15) - _YZ_OFF, kyz % (1 << 15) - _YZ_OFF


def _voxel_key(cloud: PointCloud, resolution: float):
    """(int64 voxel key, masked xyz). The key `kx * 2^31 + kyz` orders lanes
    exactly as the reference's two-key sort on (kx, packed kyz); invalid
    lanes carry kx = 2^30 and sort behind every voxel."""
    xyz = cloud.masked_xyz()
    coords = cell_coords(xyz, resolution)
    kx = torch.where(cloud.mask, coords[:, 0], _BIG)
    kyz = _pack_yz(coords[:, 1], coords[:, 2])
    return kx.to(torch.int64) * (1 << 31) + kyz.to(torch.int64), xyz


def _voxel_sort(cloud: PointCloud, resolution: float):
    """Sort lanes by voxel key: returns (sorted int64 keys, permutation,
    masked xyz)."""
    key, xyz = _voxel_key(cloud, resolution)
    skey, order = torch.sort(key, stable=True)
    return skey, order, xyz


DEDUP_KERNEL = Kernel(
    "voxel_dedup_first",
    source="lv_slam_tpu_torch/csrc/voxel_dedup.cu",
    replaces="lv_slam_tpu/ops/prefilter.py:203",
    entries={"lvs_voxel_dedup": [PTR, PTR, PTR, I32, F32, I32, PTR, ctypes.c_longlong, PTR, PTR, PTR]},
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
    n = cloud.cap
    if n > MAX_SORT_LANES:
        raise ValueError(f"voxel_downsample: {n} lanes exceed the key sort's {MAX_SORT_LANES}")
    xyz, inten, mask = cloud.xyz.contiguous(), cloud.intensity.contiguous(), cloud.mask.contiguous()
    check_cuda("voxel_downsample", xyz, inten, mask)
    dev = xyz.device
    scratch = torch.empty((scratch_bytes("lvs_voxel_scratch_bytes", n),), dtype=torch.uint8, device=dev)
    out_xyz = torch.empty((out_cap, 3), dtype=torch.float32, device=dev)
    out_int = torch.empty((out_cap,), dtype=torch.float32, device=dev)
    out_mask = torch.empty((out_cap,), dtype=torch.bool, device=dev)
    KERNEL.call(
        "lvs_voxel_downsample", ptr(xyz), ptr(inten), ptr(mask), n, inv_resolution(resolution),
        float(np.float32(resolution)), int(approx), out_cap, ptr(scratch), scratch.numel(),
        ptr(out_xyz), ptr(out_int), ptr(out_mask),
    )
    KERNEL.launches += 1
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
    if n > MAX_SORT_LANES:
        raise ValueError(f"voxel_dedup_first: {n} lanes exceed the key sort's {MAX_SORT_LANES}")
    out_cap = min(n, out_cap)
    xyz, inten, mask = cloud.xyz.contiguous(), cloud.intensity.contiguous(), cloud.mask.contiguous()
    check_cuda("voxel_dedup_first", xyz, inten, mask)
    dev = xyz.device
    scratch = torch.empty((scratch_bytes("lvs_voxel_scratch_bytes", n),), dtype=torch.uint8, device=dev)
    out_xyz = torch.empty((out_cap, 3), dtype=torch.float32, device=dev)
    out_int = torch.empty((out_cap,), dtype=torch.float32, device=dev)
    out_mask = torch.empty((out_cap,), dtype=torch.bool, device=dev)
    DEDUP_KERNEL.call(
        "lvs_voxel_dedup", ptr(xyz), ptr(inten), ptr(mask), n, inv_resolution(resolution), out_cap, ptr(scratch),
        scratch.numel(), ptr(out_xyz), ptr(out_int), ptr(out_mask),
    )
    DEDUP_KERNEL.launches += 1
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


SUBSAMPLE_KERNEL = Kernel(
    "uniform_subsample",
    source="lv_slam_tpu_torch/csrc/subsample.cu",
    replaces="lv_slam_tpu/ops/prefilter.py:254",
    entries={"lvs_uniform_subsample": [PTR, PTR, PTR, I32, I32, PTR, PTR, PTR]},
)


def uniform_subsample(cloud: PointCloud, out_cap: int) -> PointCloud:
    """Evenly-strided subsample of a front-compacted cloud to `out_cap` lanes
    (`OdometryConfig.subsample_method="gather"`); the stride is float32 as
    in the reference, since `i * count` overflows int32 at KITTI density.
    `out_cap >= cap` returns the cloud itself. Kernel 21 on CUDA, the plain
    version on CPU."""
    n = cloud.cap
    if out_cap >= n:
        return cloud
    if cloud.xyz.device.type == "cpu":
        return uniform_subsample_ref(cloud, out_cap)
    if cloud.xyz.dtype != torch.float32 or cloud.intensity.dtype != torch.float32 or cloud.mask.dtype != torch.bool:
        raise ValueError("uniform_subsample: expected float32 xyz and intensity and a bool mask")
    xyz, inten, mask = cloud.xyz.contiguous(), cloud.intensity.contiguous(), cloud.mask.contiguous()
    check_cuda("uniform_subsample", xyz, inten, mask)
    dev = xyz.device
    out_xyz = torch.empty((out_cap, 3), dtype=torch.float32, device=dev)
    out_int = torch.empty((out_cap,), dtype=torch.float32, device=dev)
    out_mask = torch.empty((out_cap,), dtype=torch.bool, device=dev)
    SUBSAMPLE_KERNEL.call(
        "lvs_uniform_subsample", ptr(xyz), ptr(inten), ptr(mask), n, out_cap, ptr(out_xyz), ptr(out_int),
        ptr(out_mask),
    )
    SUBSAMPLE_KERNEL.launches += 1
    return PointCloud(out_xyz, out_int, out_mask)


def uniform_subsample_ref(cloud: PointCloud, out_cap: int) -> PointCloud:
    """Plain PyTorch version of `uniform_subsample`, line for line with the
    reference: the count of set mask lanes, the float32 stride, the gather."""
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
    """The prefiltering chain (`prefiltering_nodelet.cpp:92-135`), in the
    reference's order: the vertical-angle calibration and the distance band
    (kernel 0a: one launch for the two), then VOXELGRID / APPROX_VOXELGRID (kernel 1), DEDUP
    (kernel 1b) or, for NONE, a front compaction to `out_cap` lanes, then
    the STATISTICAL or RADIUS outlier removal (kernel 18), which clears mask
    bits without compacting. `voxel_reduce` picks between two TPU
    implementations of the same centroid ("scatter", "scan"), so kernel 1
    serves both."""
    if cfg.voxel_reduce not in ("scatter", "scan"):
        raise ValueError(f"voxel_reduce must be 'scatter' or 'scan', got {cfg.voxel_reduce!r}")
    out = cloud
    if cfg.use_angle_calibration and cfg.use_distance_filter:
        out = calibrated_band(out, cfg.angle_base, cfg.distance_near_thresh, cfg.distance_far_thresh)
    elif cfg.use_angle_calibration:
        out = vertical_angle_calibration(out, cfg.angle_base)
    elif cfg.use_distance_filter:
        out = distance_filter(out, cfg.distance_near_thresh, cfg.distance_far_thresh)
    method = cfg.downsample_method.upper()
    if method in ("VOXELGRID", "APPROX_VOXELGRID"):
        out = voxel_downsample(out, cfg.downsample_resolution, cfg.out_cap, method)
    elif method == "DEDUP":
        out = voxel_dedup_first(out, cfg.downsample_resolution, cfg.out_cap)
    else:
        out = out.compact(cfg.out_cap)
    removal = cfg.outlier_removal_method.upper()
    if removal == "STATISTICAL":
        out = nn.statistical_outlier_removal(out, cfg.statistical_mean_k, cfg.statistical_stddev)
    elif removal == "RADIUS":
        out = nn.radius_outlier_removal(out, cfg.radius_radius, cfg.radius_min_neighbors)
    return out
