"""Floor plane detection (port of `lv_slam_tpu.ops.floor`, the producer of
`/floor_detection/floor_coeffs` that the reference's backend consumes,
`global_graph_nodelet.cpp:576-627`): RANSAC over H point triples of a
z-banded slice of the scan, all hypotheses scored in one pass, a normal gate,
then a least-squares refit on the best hypothesis's inliers.

`detect_floor` is kernel 16 (`csrc/floor.cu`) on CUDA tensors and
`detect_floor_ref`, its plain twin, on CPU tensors. Both draw the triples
the reference draws: `jax.random.randint(PRNGKey(seed), (H, 3), 0, n)` under
threefry2x32 with `jax_threefry_partitionable` (JAX's default), replayed in
numpy on the host (`randint_triples`) and cached per (seed, n, H). The
inlier distance |x n0 + y n1 + z n2 + d| rounds as the reference's compiled
`xyz @ n^T + d` on the CPU: the dot an fma chain fma(z, n2, fma(y, n1,
x n0)), the offset added after it.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.kernels._build import F32, I32, PTR, Kernel, check_cuda, ptr, scratch_bytes
from lv_slam_tpu_torch.lfa.registration import _cross_fma
from lv_slam_tpu_torch.ops.linalg3 import dot3_fma, eigh3x3, fma32, sqrt32

KERNEL = Kernel(
    "detect_floor",
    source="lv_slam_tpu_torch/csrc/floor.cu",
    replaces="lv_slam_tpu/ops/floor.py:27",
    entries={
        # xyz, mask, n, triples, H, height, clip, thresh, cos, fraction -> planes, counts, scratch, coeffs, stats, found
        "lvs_floor": [PTR, PTR, I32, PTR, I32, F32, F32, F32, F32, F32, PTR, PTR, PTR, PTR, PTR, PTR],
    },
)


class FloorResult(NamedTuple):
    coeffs: torch.Tensor     # (4,) [nx, ny, nz, d] with n.p + d = 0, nz > 0
    n_inliers: torch.Tensor  # the best hypothesis's inlier count (int32)
    found: torch.Tensor      # bool
    best: torch.Tensor       # the best hypothesis's index (int32)


# ---------------------------------------------------------------- the triples

def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(np.uint32)


def _threefry2x32(k1, k2, x0: np.ndarray, x1: np.ndarray):
    """JAX's threefry2x32 hash (`jax/_src/prng.py`, 20 rounds) of the count
    pairs (x0, x1) under key (k1, k2), in uint32 arithmetic."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0 = (x0 + ks[0]).astype(np.uint32)
        x1 = (x1 + ks[1]).astype(np.uint32)
        for i in range(5):
            for r in rotations[i % 2]:
                x0 = (x0 + x1).astype(np.uint32)
                x1 = _rotl(x1, r) ^ x0
            x0 = (x0 + ks[(i + 1) % 3]).astype(np.uint32)
            x1 = (x1 + ks[(i + 2) % 3] + np.uint32(i + 1)).astype(np.uint32)
    return x0, x1


def _random_bits(key, count: int) -> np.ndarray:
    """`jax.random.bits(key, (count,))` for 32-bit words, partitionable
    threefry: the hash of the 64-bit iota (high word 0 here) as two words,
    XORed."""
    lo = np.arange(count, dtype=np.uint32)
    b0, b1 = _threefry2x32(key[0], key[1], np.zeros_like(lo), lo)
    return b0 ^ b1


@functools.lru_cache(maxsize=64)
def randint_triples(seed: int, n: int, n_hypotheses: int) -> np.ndarray:
    """`jax.random.randint(jax.random.PRNGKey(seed), (H, 3), 0, n)` as int32
    (H, 3): the key split in two, 32 random bits from each, and randint's
    reduction of the 64-bit pair modulo the span in uint32 arithmetic."""
    key = (np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF))
    s0, s1 = _threefry2x32(key[0], key[1], np.zeros(2, np.uint32), np.arange(2, dtype=np.uint32))
    k1, k2 = (s0[0], s1[0]), (s0[1], s1[1])
    count = 3 * n_hypotheses
    higher, lower = _random_bits(k1, count), _random_bits(k2, count)
    span = np.uint32(max(n, 1))
    with np.errstate(over="ignore"):
        multiplier = np.uint32(np.uint32(2**16) % span)
        multiplier = np.uint32((multiplier * multiplier) % span)
        offset = ((higher % span) * multiplier + (lower % span)).astype(np.uint32) % span
    out = offset.astype(np.int32).reshape(n_hypotheses, 3)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=64)
def _triples_on(seed: int, n: int, n_hypotheses: int, device: str) -> torch.Tensor:
    """The triples as an int32 tensor on `device`, uploaded once."""
    return torch.from_numpy(randint_triples(seed, n, n_hypotheses).copy()).to(device)


def _triples(seed: int, n: int, n_hypotheses: int, device) -> torch.Tensor:
    return _triples_on(seed, n, n_hypotheses, str(device))


def _cos_thresh(normal_thresh_deg: float) -> float:
    """cos(deg2rad(t)) in float32, as the reference's weakly typed jnp takes it."""
    rad = np.float32(normal_thresh_deg) * np.float32(math.pi / 180.0)
    return float(np.cos(np.float32(rad), dtype=np.float32))


# ---------------------------------------------------------------- detection


def detect_floor(
    cloud: PointCloud,
    sensor_height: float = 1.73,
    height_clip: float = 1.0,
    distance_thresh: float = 0.1,
    normal_thresh_deg: float = 10.0,
    n_hypotheses: int = 256,
    min_inlier_fraction: float = 0.1,
    seed: int = 0,
) -> FloorResult:
    """RANSAC floor fit on the points within +-height_clip of the expected
    floor (z = -sensor_height). Kernel 16 on CUDA, the plain version on CPU.
    An empty cloud has no triple to draw (the reference's gather fails on
    it): it raises on either device."""
    n = cloud.cap
    if n == 0:
        raise ValueError("detect_floor: empty cloud")
    if cloud.xyz.device.type == "cpu":
        return detect_floor_ref(cloud, sensor_height, height_clip, distance_thresh, normal_thresh_deg,
                                n_hypotheses, min_inlier_fraction, seed)
    if not 0 < n_hypotheses <= 1024:
        raise ValueError(f"detect_floor: n_hypotheses must be in 1..1024, got {n_hypotheses}")
    xyz, mask = cloud.xyz.contiguous(), cloud.mask.contiguous()
    idx = _triples(seed, n, n_hypotheses, xyz.device)
    check_cuda("detect_floor", xyz, mask, idx)
    if xyz.dtype != torch.float32:
        raise ValueError("detect_floor: expected float32 xyz")
    dev = xyz.device
    counts = torch.empty((n_hypotheses,), dtype=torch.int32, device=dev)
    planes = torch.empty((n_hypotheses, 4), dtype=torch.float32, device=dev)
    coeffs = torch.empty((4,), dtype=torch.float32, device=dev)
    stats = torch.empty((2,), dtype=torch.int32, device=dev)  # n_inliers, best
    found = torch.empty((), dtype=torch.bool, device=dev)
    scratch = torch.empty((scratch_bytes("lvs_floor_scratch_bytes", n, n_hypotheses),), dtype=torch.uint8, device=dev)
    KERNEL.call(
        "lvs_floor", ptr(xyz), ptr(mask), n, ptr(idx), n_hypotheses, float(sensor_height), float(height_clip),
        float(distance_thresh), _cos_thresh(normal_thresh_deg), float(min_inlier_fraction), ptr(planes),
        ptr(counts), ptr(scratch), ptr(coeffs), ptr(stats), ptr(found),
    )
    KERNEL.launches += 1
    return FloorResult(coeffs, stats[0], found, stats[1])


def detect_floor_ref(cloud: PointCloud, sensor_height: float = 1.73, height_clip: float = 1.0,
                     distance_thresh: float = 0.1, normal_thresh_deg: float = 10.0, n_hypotheses: int = 256,
                     min_inlier_fraction: float = 0.1, seed: int = 0) -> FloorResult:
    """Plain PyTorch version of `detect_floor`, line for line with the
    reference (its products and sums rounded as XLA rounds them on the CPU)."""
    xyz = cloud.masked_xyz()
    dev = xyz.device
    band = cloud.mask & (torch.abs(xyz[:, 2] + sensor_height) < height_clip)
    n = xyz.shape[0]
    idx = _triples(seed, n, n_hypotheses, dev).long()
    tri_ok = band[idx].all(dim=1)
    p = xyz[idx]  # (H, 3, 3)
    norm_vec = _cross_fma(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    nn = sqrt32(dot3_fma(norm_vec, norm_vec))
    unit = norm_vec / torch.clamp(nn, min=1e-9)[:, None]
    unit = unit * torch.where(unit[:, 2:3] < 0, -1.0, 1.0)
    cos_thresh = _cos_thresh(normal_thresh_deg)
    hyp_ok = tri_ok & (nn > 1e-6) & (unit[:, 2] > cos_thresh)
    d = -dot3_fma(unit, p[:, 0])  # (H,)

    def inliers(h: slice) -> torch.Tensor:  # (N, h) inlier flags of hypotheses h
        u = unit[h]
        dot = fma32(xyz[:, 2:3], u[None, :, 2], fma32(xyz[:, 1:2], u[None, :, 1], xyz[:, 0:1] * u[None, :, 0]))
        return (torch.abs(dot + d[None, h]) < distance_thresh) & band[:, None]

    step = 16  # hypotheses per slice: bounds the (N, step) float64 intermediates
    counts = torch.cat([inliers(slice(s, s + step)).sum(dim=0, dtype=torch.int32)
                        for s in range(0, n_hypotheses, step)])
    counts = torch.where(hyp_ok, counts, -1)
    best = torch.argmax(counts)
    w = inliers(slice(int(best), int(best) + 1))[:, 0].to(torch.float32)
    cnt = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(xyz * w[:, None], dim=0) / cnt
    centered = (xyz - mu) * w[:, None]
    cov = centered.T @ centered / cnt
    _, evecs = eigh3x3(cov[None])
    normal = evecs[0][:, 0]
    normal = normal * torch.where(normal[2] < 0, -1.0, 1.0)
    d_fit = -dot3_fma(normal, mu)
    band_count = torch.sum(band.to(torch.float32))
    found = (counts[best] > 0) & (torch.sum(w) >= min_inlier_fraction * torch.clamp(band_count, min=1.0)) & (
        normal[2] > cos_thresh)
    return FloorResult(torch.cat([normal, d_fit[None]]), counts[best], found, best.to(torch.int32))
