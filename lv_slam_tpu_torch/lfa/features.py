"""LOAM-style edge/planar feature extraction (port of `lv_slam_tpu.lfa.features`).

The scan is projected to a (rings, azimuth) range image (nearest return
wins each cell), each ring's returns are compacted to the front of its row,
LOAM curvature is a shifted sum over the row, and the picks are the top-k per
(ring, sector) of local curvature maxima (edges) and of low-curvature cells
(surfs), with the reference's prefix rule: sharp = the first 2 less-sharp
picks, flat = the first 4 less-flat picks.

`extract_features` is kernel 8 (`csrc/lfa_features.cu`) on CUDA tensors and
`extract_features_ref`, its plain twin, on CPU tensors. The plain twin rounds
as the kernel does: the same summation order, and division by a constant as
a multiply by the float32 reciprocal folded with the next constant factor,
which is how XLA compiles the reference (`range_image_scales`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.config import LfaConfig
from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
from lv_slam_tpu_torch.kernels._build import F32, I32, PTR, Kernel, check_cuda, ptr

N_AZIMUTH = 1800  # the reference's range-image width
_INVALID = 1 << 30
_LANE_BITS = 17
_EDGE_THRESH = 0.1
_SURF_THRESH = 0.1
_MAX_SECTOR_WIDTH = 1024  # kernel 8 sorts a sector's columns in shared memory

KERNEL = Kernel(
    "extract_features",
    source="lv_slam_tpu_torch/csrc/lfa_features.cu",
    replaces="lv_slam_tpu/lfa/features.py:176",
    entries={
        "lvs_extract_features": [
            PTR, PTR, I32, I32, I32, I32, F32, F32, F32, F32, F32, F32, I32, I32, I32, I32,
            PTR, PTR,
            PTR, PTR, I32, PTR, PTR, I32, PTR, PTR, I32, PTR, PTR, I32,
        ],
    },
)


class FeatureClouds(NamedTuple):
    sharp: torch.Tensor        # (Cs,3)
    sharp_mask: torch.Tensor
    less_sharp: torch.Tensor   # (Cl,3)
    less_sharp_mask: torch.Tensor
    flat: torch.Tensor         # (Cf,3)
    flat_mask: torch.Tensor
    less_flat: torch.Tensor    # (Cg,3)
    less_flat_mask: torch.Tensor


def _f32(x: float) -> float:
    return float(np.float32(x))


def range_image_scales(
    n_rings: int, n_azimuth: int, min_elev_deg: float, max_elev_deg: float
) -> Tuple[float, float, float, float]:
    """(rad2deg, ring_scale, pi, col_scale) as float32 values.

    The reference's `(max_elev - elev) / span * (n_rings - 1)` and
    `(azim + pi) / (2 pi) * n_azimuth` compile (XLA, jit) to one multiply
    each by `float32(1/span) * (n_rings - 1)` and `float32(1/(2 pi)) *
    n_azimuth`, rounded to float32; the port multiplies by the same."""
    one = np.float32(1.0)
    ring_scale = one / np.float32(max_elev_deg - min_elev_deg) * np.float32(n_rings - 1)
    col_scale = one / np.float32(2 * math.pi) * np.float32(n_azimuth)
    return _f32(180.0 / math.pi), float(ring_scale), _f32(math.pi), float(col_scale)


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """v[..., 0] + v[..., 1] + v[..., 2] in that order (a reduction's order
    is the backend's)."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2 through float64: the correctly rounded float32 value on
    every device but for a double result within a few double ulps of a
    float32 rounding boundary, so the CPU and the card put each point in the
    same ring and column (float32 atan2 implementations differ by an ulp)."""
    return torch.atan2(y.double(), x.double()).float()


def project_range_image(
    cloud: PointCloud,
    n_rings: int = 64,
    n_azimuth: int = N_AZIMUTH,
    min_elev_deg: float = -24.8,
    max_elev_deg: float = 2.0,
    minimum_range: float = 5.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (image (R,A,3), valid (R,A)). Nearest return wins bin collisions:
    one scatter-min of the int32 pack (range_cm << 17 | lane)."""
    n = cloud.cap
    if n > (1 << _LANE_BITS):
        raise ValueError(f"point capacity {n} exceeds the 17-bit winner-index pack")
    rad2deg, ring_scale, pi, col_scale = range_image_scales(
        n_rings, n_azimuth, min_elev_deg, max_elev_deg
    )
    dev = cloud.xyz.device
    xyz = cloud.masked_xyz()
    sq = xyz * xyz
    rng = torch.sqrt(_sum3(sq))
    mask = cloud.mask & (rng > minimum_range)
    elev = _atan2(xyz[:, 2], torch.sqrt(sq[:, 0] + sq[:, 1])) * rad2deg
    ring = torch.round((_f32(max_elev_deg) - elev) * ring_scale).to(torch.int32)
    col = torch.floor((_atan2(xyz[:, 1], xyz[:, 0]) + pi) * col_scale).to(torch.int32)
    col = torch.clamp(col, 0, n_azimuth - 1)
    ok = mask & (ring >= 0) & (ring < n_rings)
    flat_idx = torch.where(ok, ring * n_azimuth + col, n_rings * n_azimuth).to(torch.int64)
    # ranges beyond 81.91 m saturate at rq = 8191 and stay valid winners
    rq = torch.clamp((rng * 100.0).to(torch.int32), 0, (1 << 13) - 1)
    lanes = torch.arange(n, dtype=torch.int32, device=dev)
    packed = torch.where(ok, (rq << _LANE_BITS) | lanes, _INVALID)
    best = torch.full((n_rings * n_azimuth + 1,), _INVALID, dtype=torch.int32, device=dev)
    best.scatter_reduce_(0, flat_idx, packed, "amin")
    best = best[:-1]
    valid = best < _INVALID
    win = torch.where(valid, best & ((1 << _LANE_BITS) - 1), 0).to(torch.int64)
    img = torch.where(valid[:, None], xyz[win], SENTINEL)
    return img.reshape(n_rings, n_azimuth, 3), valid.reshape(n_rings, n_azimuth)


def compact_rows(image: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-move each ring's valid cells to the front of its row."""
    _, idx = torch.sort((~valid).to(torch.uint8), dim=1, stable=True)
    img = torch.gather(image, 1, idx[..., None].expand(image.shape))
    return img, torch.gather(valid, 1, idx)


def _window_sum(x: torch.Tensor, half: int) -> torch.Tensor:
    """Sum over columns j in [-half, half], j != 0, wrapping around the row."""
    total = torch.zeros_like(x)
    for j in range(1, half + 1):
        total = total + torch.roll(x, j, dims=1) + torch.roll(x, -j, dims=1)
    return total


def curvature(image: torch.Tensor, valid: torch.Tensor, half: int = 5):
    """LOAM curvature per range-image cell + validity of the full window."""
    pts = torch.where(valid[..., None], image, 0.0)
    nbr_sum = _window_sum(pts, half)
    nbr_cnt = _window_sum(valid[..., None].to(torch.float32), half)
    diff = nbr_sum - (2.0 * half) * pts
    c = _sum3(diff * diff)
    window_full = nbr_cnt[..., 0] >= 2 * half
    ok = valid & window_full
    return torch.where(ok, c, torch.nan), ok


def _local_extrema(c: torch.Tensor, win: int, maxima: bool) -> torch.Tensor:
    """Boolean mask of local maxima (or minima) along the wrapped row; NaN
    cells never win."""
    fill = -torch.inf if maxima else torch.inf
    c = torch.nan_to_num(c, nan=fill, posinf=torch.inf, neginf=-torch.inf)
    best = c
    for j in range(1, win + 1):
        left, right = torch.roll(c, j, dims=1), torch.roll(c, -j, dims=1)
        if maxima:
            best = torch.maximum(best, torch.maximum(left, right))
        else:
            best = torch.minimum(best, torch.minimum(left, right))
    return c == best


def _sector_topk(image, c, ok, per_sector: int, n_sectors: int, largest: bool):
    """Top-k picks per (ring, sector): (r, s, k, 3) points + (r, s, k) good.
    A stable descending sort orders equal scores by column, lax.top_k's
    tie rule (torch.topk promises no tie order)."""
    r, a, _ = image.shape
    w = a // n_sectors
    c_sect = c[:, : w * n_sectors].reshape(r, n_sectors, w)
    ok_sect = ok[:, : w * n_sectors].reshape(r, n_sectors, w)
    img_sect = image[:, : w * n_sectors].reshape(r, n_sectors, w, 3)
    base = c_sect if largest else -c_sect
    score = torch.where(ok_sect & torch.isfinite(base), base, -torch.inf)
    _, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    idx = idx[..., :per_sector]
    pts = torch.gather(img_sect, 2, idx[..., None].expand(idx.shape + (3,)))
    return pts, torch.gather(ok_sect, 2, idx)


def _compact(pts: torch.Tensor, good: torch.Tensor, cap: int):
    """Flatten picks in (ring, sector, rank) order and stable-compact the good
    ones into min(picks, cap) lanes (the reference's slice)."""
    pts = pts.reshape(-1, 3)
    good = good.reshape(-1)
    _, idx = torch.sort((~good).to(torch.uint8), stable=True)
    idx = idx[:cap]
    m = good[idx]
    return torch.where(m[:, None], pts[idx], SENTINEL), m


def _picks(cfg: LfaConfig) -> Tuple[int, int]:
    """(less-sharp, less-flat) picks per (ring, sector)."""
    if cfg.sharp_per_sector > cfg.less_sharp_per_sector:
        raise ValueError(
            f"sharp_per_sector ({cfg.sharp_per_sector}) must be <= "
            f"less_sharp_per_sector ({cfg.less_sharp_per_sector})"
        )
    k_less_flat = max(cfg.flat_per_sector, cfg.planar_cap // (cfg.n_sectors * cfg.scan_line))
    return cfg.less_sharp_per_sector, k_less_flat


def feature_caps(cfg: LfaConfig) -> Tuple[int, int, int, int]:
    """Lanes of the (sharp, less-sharp, flat, less-flat) clouds: each cap,
    or the number of picks where that is smaller (the reference's
    `sorted[:cap]` slice is then shorter than the cap)."""
    k_less_sharp, k_less_flat = _picks(cfg)
    cells = cfg.scan_line * cfg.n_sectors
    return (
        min(cells * cfg.sharp_per_sector, cfg.edge_cap // 4),
        min(cells * k_less_sharp, cfg.edge_cap),
        min(cells * cfg.flat_per_sector, cfg.planar_cap // 4),
        min(cells * k_less_flat, cfg.planar_cap),
    )


def extract_features_ref(cloud: PointCloud, cfg: LfaConfig) -> FeatureClouds:
    """Plain PyTorch version of `extract_features`, step for step with the
    reference."""
    k_less_sharp, k_less_flat = _picks(cfg)
    image, valid = project_range_image(
        cloud, n_rings=cfg.scan_line, minimum_range=cfg.minimum_range,
        min_elev_deg=cfg.min_elev_deg, max_elev_deg=cfg.max_elev_deg,
    )
    image, valid = compact_rows(image, valid)
    c, cok = curvature(image, valid)
    is_max = _local_extrema(c, 2, maxima=True)
    edge_ok = cok & is_max & (c > _EDGE_THRESH)
    surf_ok = cok & (c < _SURF_THRESH)

    e_pts, e_good = _sector_topk(image, c, edge_ok, k_less_sharp, cfg.n_sectors, largest=True)
    ks = cfg.sharp_per_sector
    sharp, sharp_m = _compact(e_pts[:, :, :ks], e_good[:, :, :ks], cfg.edge_cap // 4)
    less_sharp, less_sharp_m = _compact(e_pts, e_good, cfg.edge_cap)
    g_pts, g_good = _sector_topk(image, c, surf_ok, k_less_flat, cfg.n_sectors, largest=False)
    kf = cfg.flat_per_sector
    flat, flat_m = _compact(g_pts[:, :, :kf], g_good[:, :, :kf], cfg.planar_cap // 4)
    less_flat, less_flat_m = _compact(g_pts, g_good, cfg.planar_cap)
    return FeatureClouds(sharp, sharp_m, less_sharp, less_sharp_m, flat, flat_m, less_flat, less_flat_m)


def extract_features(cloud: PointCloud, cfg: LfaConfig) -> FeatureClouds:
    """Range image -> curvature -> picks. Kernel 8 on CUDA, the plain
    version on CPU."""
    if cloud.xyz.device.type == "cpu":
        return extract_features_ref(cloud, cfg)
    k_less_sharp, k_less_flat = _picks(cfg)
    n = cloud.cap
    if n > (1 << _LANE_BITS):
        raise ValueError(f"point capacity {n} exceeds the 17-bit winner-index pack")
    if cloud.xyz.dtype != torch.float32 or tuple(cloud.xyz.shape) != (n, 3):
        raise ValueError("extract_features: expected float32 xyz of shape (cap, 3)")
    if not 1 <= N_AZIMUTH // cfg.n_sectors <= _MAX_SECTOR_WIDTH:
        raise ValueError(f"extract_features: the kernel sorts sectors of 1 to {_MAX_SECTOR_WIDTH} columns, "
                         f"not {N_AZIMUTH // cfg.n_sectors}")
    xyz, mask = cloud.xyz.contiguous(), cloud.mask.contiguous()
    check_cuda("extract_features", xyz, mask)
    dev = xyz.device
    r, s = cfg.scan_line, cfg.n_sectors
    best = torch.empty((r * N_AZIMUTH,), dtype=torch.int32, device=dev)
    status = torch.empty((1 + 4 * r * s,), dtype=torch.int32, device=dev)  # a ticket, 4 look-back words a sector
    caps = feature_caps(cfg)
    outs = []
    for cap in caps:
        outs += [
            torch.empty((cap, 3), dtype=torch.float32, device=dev),
            torch.empty((cap,), dtype=torch.bool, device=dev),
        ]
    rad2deg, ring_scale, pi, col_scale = range_image_scales(
        r, N_AZIMUTH, cfg.min_elev_deg, cfg.max_elev_deg
    )
    clouds = []
    for (pts, m), cap in zip(zip(outs[::2], outs[1::2]), caps):
        clouds += [ptr(pts), ptr(m), cap]
    KERNEL.call(
        "lvs_extract_features",
        ptr(xyz), ptr(mask), n, r, N_AZIMUTH, s, _f32(cfg.minimum_range), _f32(cfg.max_elev_deg),
        ring_scale, col_scale, rad2deg, pi, k_less_sharp, k_less_flat,
        cfg.sharp_per_sector, cfg.flat_per_sector,
        ptr(best), ptr(status), *clouds,
    )
    KERNEL.launches += 1
    return FeatureClouds(*outs)
