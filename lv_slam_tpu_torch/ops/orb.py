"""ORB features and descriptor matching (port of `lv_slam_tpu.ops.orb`).

The reference extracts ORB descriptors per keyframe image
(`global_graph_nodelet.cpp:212-236`) and ranks loop candidates by
descriptor similarity (`loop_detector.hpp:231-240`). Per image and per level
of a 3-level 2x2-mean pyramid:

- FAST-9 on the radius-3 circle (a run of 9 contiguous brighter or darker
  neighbours, 20 grey levels apart) and its score, the sum of the
  differences past the threshold on the winning side;
- 3x3 non-max suppression, a 16-pixel border, the top-K by score (ties to
  the lower flat index, as `lax.top_k` breaks them);
- the intensity-centroid angle over the radius-15 disc;
- steered BRIEF-256 on the 3x3 box-blurred image, bits packed as
  `np.packbits` (bit j in byte j // 8 at bit 7 - j % 8).

FAST, the suppression and the blur wrap around the image (`torch.roll`, as
the reference's `jnp.roll`); the orientation patch and the BRIEF samples are
clipped to it. `detect_pyramid_batch` returns one (B, K, 37) uint8 buffer:
descriptor bytes, the keypoint scaled to level 0 as little-endian int16
(y, x), the valid flag. Kernel 12 (`csrc/orb.cu`) computes it on CUDA
tensors; `detect_pyramid_batch_ref` is the plain twin, which CPU tensors
take.

Exactness. The images are 8-bit, so every level is a multiple of 1/16 and
every FAST score, blur sum and orientation moment below is exact in any
summation order. The top-K ranks unique int64 keys (the score's float32
bits above the complement of the flat index), so any exact top-K gives
`lax.top_k`'s order. The angle is `atan2` of the exact moments in float64,
rounded to float32, and its cos / sin likewise; the rotated sample
positions are formed in float64, where they are exact, and rounded half to
even. The twin and the kernel therefore agree to the bit; the reference's
float32 arithmetic differs from them only where a rotated sample lies
within an ulp of a half-integer.

`match_scores_batch` scores a keyframe's descriptors against many
candidates at once: the Hamming matrix, the masked mutual-best match and
its fraction under `max_dist` (kernel 12b, `csrc/orb_match.cu`; the plain
twin `match_scores_masked_ref` uses the reference's +-1 float matmul).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.kernels._build import F32, I32, PTR, Kernel, check_cuda, check_dtype, ptr, scratch_bytes

# FAST radius-3 Bresenham circle, clockwise from 12 o'clock: (row, col)
_FAST_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    np.int32,
)

_PATCH_R = 15  # orientation / BRIEF patch radius
_BORDER = _PATCH_R + 1
ROW_BYTES = 37  # descriptor (32) | y int16 LE (2) | x int16 LE (2) | valid (1)
_LOW32 = 0xFFFFFFFF


def _disc_offsets(radius: int) -> np.ndarray:
    out = [
        (dy, dx)
        for dy in range(-radius, radius + 1)
        for dx in range(-radius, radius + 1)
        if dy * dy + dx * dx <= radius * radius
    ]
    return np.asarray(out, np.int32)


_DISC = _disc_offsets(_PATCH_R)  # (709, 2) dy, dx


def _brief_pattern(n_pairs: int = 256, seed: int = 1234) -> np.ndarray:
    """(n_pairs, 4) offsets (y1, x1, y2, x2), Gaussian like BRIEF."""
    rng = np.random.default_rng(seed)
    sigma = _PATCH_R / 2.5
    pat = np.clip(rng.normal(0, sigma, size=(n_pairs, 4)), -_PATCH_R + 1, _PATCH_R - 1)
    return np.round(pat).astype(np.int32)


_PATTERN = _brief_pattern()

ORB_KERNEL = Kernel(
    "_detect_pyramid_batch",
    source="lv_slam_tpu_torch/csrc/orb.cu",
    replaces="lv_slam_tpu/ops/orb.py:200",
    entries={
        "lvs_orb_detect": [
            PTR, I32, I32, I32, I32, PTR, I32, F32, I32, PTR, I32, PTR, PTR, ctypes.c_longlong, PTR,
        ],
    },
)
MAX_LEVELS = 8  # csrc/orb.cu's scratch layout
MATCH_KERNEL = Kernel(
    "match_scores_batch",
    source="lv_slam_tpu_torch/csrc/orb_match.cu",
    replaces="lv_slam_tpu/ops/orb.py:274",
    entries={"lvs_orb_match": [PTR, PTR, PTR, PTR, I32, I32, F32, PTR]},
)

_TABLES: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _device_tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The disc offsets (709, 2) and the BRIEF pattern (256, 4) as int8 on `device`."""
    if device not in _TABLES:
        _TABLES[device] = (
            torch.from_numpy(_DISC.astype(np.int8)).to(device),
            torch.from_numpy(_PATTERN.astype(np.int8)).to(device),
        )
    return _TABLES[device]


# ------------------------------------------------------------ plain twins


def _roll(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """`jnp.roll(jnp.roll(x, dy, 0), dx, 1)` over the last two axes."""
    return torch.roll(x, shifts=(dy, dx), dims=(-2, -1))


def _halve(img: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool downsample over the last two axes (the pyramid step)."""
    h, w = img.shape[-2:]
    h2, w2 = (h // 2) * 2, (w // 2) * 2
    x = img[..., :h2, :w2].reshape(*img.shape[:-2], h2 // 2, 2, w2 // 2, 2)
    return x.mean(dim=(-3, -1))


def _blur9(img: torch.Tensor) -> torch.Tensor:
    """The 3x3 box sum with wrap (the reference's `_box_blur` times 9: BRIEF
    compares blurred values, and the exact sums order as their ninths do)."""
    out = torch.zeros_like(img)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out + _roll(img, dy, dx)
    return out


def _fast_scores(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 score of every pixel of (B, H, W) float32, 0 off corners."""
    nbrs = torch.stack([_roll(img, -dy, -dx) for dy, dx in _FAST_CIRCLE.tolist()], dim=-1)
    center = img[..., None]
    bright = nbrs > center + threshold
    dark = nbrs < center - threshold

    def run9(mask):
        m2 = torch.cat([mask, mask[..., :8]], dim=-1)
        return m2.unfold(-1, 9, 1).all(dim=-1).any(dim=-1)

    corner = run9(bright) | run9(dark)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    score = torch.maximum(
        torch.where(bright, nbrs - center - threshold, zero).sum(dim=-1),
        torch.where(dark, center - nbrs - threshold, zero).sum(dim=-1),
    )
    return torch.where(corner, score, zero)


def _keys(score: torch.Tensor) -> torch.Tensor:
    """(B, H*W) int64 ranking keys: a local maximum with a positive score
    inside the border ranks by (score, lower flat index first) above every
    other pixel, which ranks by lower flat index first."""
    b, h, w = score.shape
    neigh = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                neigh = torch.maximum(neigh, _roll(score, dy, dx))
    yy = torch.arange(h, device=score.device)[:, None]
    xx = torch.arange(w, device=score.device)[None, :]
    inside = (yy >= _BORDER) & (yy < h - _BORDER) & (xx >= _BORDER) & (xx < w - _BORDER)
    keep = ((score >= neigh) & (score > 0) & inside).reshape(b, -1)
    low = _LOW32 - torch.arange(h * w, device=score.device, dtype=torch.int64)
    high = score.reshape(b, -1).contiguous().view(torch.int32).to(torch.int64)
    return torch.where(keep, (high << 32) | low, low)


def _describe(img: torch.Tensor, blur9: torch.Tensor, top: torch.Tensor):
    """Keypoints, BRIEF bits, scores and valid flags from the ranked keys
    `top` (B, K): (kpts (B, K, 2) int64 yx, bits (B, K, 256), scores, valid)."""
    b, h, w = img.shape
    dev = img.device
    idx = _LOW32 - (top & _LOW32)
    high = top >> 32
    valid = high > 0
    scores = torch.where(valid, high.to(torch.int32).view(torch.float32), -1.0)
    ky, kx = idx // w, idx % w
    bi = torch.arange(b, device=dev)[:, None, None]

    disc = torch.from_numpy(_DISC).to(dev, torch.int64)
    py = torch.clamp(ky[..., None] + disc[:, 0], 0, h - 1)
    px = torch.clamp(kx[..., None] + disc[:, 1], 0, w - 1)
    patch = img[bi, py, px].double()  # (B, K, 709), exact moments in float64
    m10 = (patch * disc[:, 1].double()).sum(dim=-1)
    m01 = (patch * disc[:, 0].double()).sum(dim=-1)
    theta = torch.atan2(m01, m10).float()
    cos_t = torch.cos(theta.double()).float().double()[..., None]
    sin_t = torch.sin(theta.double()).float().double()[..., None]

    pat = torch.from_numpy(_PATTERN).to(dev, torch.float64)
    fy, fx = ky.double()[..., None], kx.double()[..., None]

    def sample(y, x):
        # rotate (x, y) by theta: x' = x cos - y sin, y' = x sin + y cos
        ry = x * sin_t + y * cos_t
        rx = x * cos_t - y * sin_t
        sy = torch.clamp(torch.round(fy + ry).long(), 0, h - 1)
        sx = torch.clamp(torch.round(fx + rx).long(), 0, w - 1)
        return blur9[bi, sy, sx]

    bits = sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])
    return torch.stack([ky, kx], dim=-1), bits, scores, valid


def _detect_level(img: torch.Tensor, k: int, threshold: float):
    """One pyramid level of a (B, H, W) float32 stack: (kpts, bits, scores, valid)."""
    top = torch.topk(_keys(_fast_scores(img, threshold)), k, dim=1).values
    return _describe(img, _blur9(img), top)


def detect_and_compute(image: torch.Tensor, max_features: int, threshold: float = 20.0):
    """Plain version of the reference's one-level `detect_and_compute`: image
    (H, W) [0, 255] -> (keypoints (K, 2) yx, descriptors (K, 256) bool,
    scores (K,), valid (K,))."""
    kpts, bits, scores, valid = _detect_level(image.to(torch.float32)[None], max_features, threshold)
    return kpts[0], bits[0], scores[0], valid[0]


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 32) uint8 in `np.packbits` order."""
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=bits.device)
    grouped = bits.reshape(*bits.shape[:-1], 32, 8).to(torch.int32)
    return (grouped * weights).sum(dim=-1).to(torch.uint8)


def _unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 256) bool in `np.unpackbits` order."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=desc.device)
    return ((desc[..., None] >> shifts) & 1).bool().reshape(*desc.shape[:-1], 256)


def detect_pyramid_batch_ref(images: torch.Tensor, k_levels: tuple, threshold: float = 20.0) -> torch.Tensor:
    """Plain version of `detect_pyramid_batch`."""
    img = images.to(torch.float32)
    rows = []
    for level, k in enumerate(k_levels):
        kpts, bits, _, valid = _detect_level(img, k, threshold)
        kp16 = (kpts * 2**level).to(torch.int16).contiguous().view(torch.uint8)
        rows.append(torch.cat([_pack_bits(bits), kp16, valid[..., None].to(torch.uint8)], dim=-1))
        img = _halve(img)
    return torch.cat(rows, dim=1)


def detect_pyramid_batch(images: torch.Tensor, k_levels: tuple, threshold: float = 20.0) -> torch.Tensor:
    """(B, H, W) uint8 (or float32 in [0, 255]) images -> (B, sum(k_levels),
    37) uint8 packed rows, level by level (the reference's
    `_detect_pyramid_batch`). Kernel 12 on CUDA, the plain version on CPU."""
    if images.device.type == "cpu":
        return detect_pyramid_batch_ref(images, k_levels, threshold)
    name = "_detect_pyramid_batch"
    check_cuda(name, images)
    if images.dim() != 3 or images.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"{name}: expected (B, H, W) uint8 or float32 images, got {images.dtype} "
                         f"{tuple(images.shape)}")
    b, h, w = images.shape
    if not 0 < len(k_levels) <= MAX_LEVELS:
        raise ValueError(f"{name}: {len(k_levels)} levels, expected 1 to {MAX_LEVELS}")
    for level, k in enumerate(k_levels):
        hl, wl = h >> level, w >> level
        if not 0 < k <= hl * wl:
            raise ValueError(f"{name}: level {level} of {hl} x {wl} cannot give {k} keypoints")
    dev = images.device
    disc, pattern = _device_tables(dev)
    out = torch.empty((b, sum(k_levels), ROW_BYTES), dtype=torch.uint8, device=dev)
    u8 = int(images.dtype == torch.uint8)
    n_bytes = scratch_bytes("lvs_orb_scratch_bytes", b, h, w, len(k_levels), max(k_levels), u8)
    scratch = torch.empty((n_bytes,), dtype=torch.uint8, device=dev)
    ks = (ctypes.c_int * len(k_levels))(*k_levels)
    ORB_KERNEL.call(
        "lvs_orb_detect", ptr(images), u8, b, h, w, ctypes.cast(ks, ctypes.c_void_p), len(k_levels),
        float(np.float32(threshold)), _BORDER, ptr(disc), disc.shape[0], ptr(pattern), ptr(scratch), n_bytes,
        ptr(out),
    )
    ORB_KERNEL.launches += 1
    return out


def unpack_rows(packed: np.ndarray, max_features: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(B, K, 37) packed rows -> per image (descriptors (D, 32) uint8,
    keypoints (D, 2) int32) of its valid rows, at most `max_features`."""
    b = packed.shape[0]
    desc = packed[:, :, :32]
    kpts = packed[:, :, 32:36].copy().view(np.int16).astype(np.int32).reshape(b, -1, 2)
    valid = packed[:, :, 36].astype(bool)
    return [(desc[i][valid[i]][:max_features], kpts[i][valid[i]][:max_features]) for i in range(b)]


def pack_descriptors(desc_bits: np.ndarray) -> np.ndarray:
    """(K, 256) bool -> (K, 32) uint8 (cv::Mat-compatible row layout)."""
    return np.packbits(np.asarray(desc_bits, bool), axis=1)


def unpack_descriptors(desc: np.ndarray) -> np.ndarray:
    """(K, 32) uint8 -> (K, 256) bool."""
    return np.unpackbits(np.asarray(desc, np.uint8), axis=1).astype(bool)


def _as_packed(desc: np.ndarray) -> np.ndarray:
    """(K, 32) uint8 as it is; (K, 256) bits packed."""
    desc = np.asarray(desc)
    return desc if desc.dtype == np.uint8 else pack_descriptors(desc)


class OrbExtractor:
    """Packed uint8 descriptors over a scale pyramid (2x average pool per
    level, like OpenCV ORB at scaleFactor 2): features from every level are
    merged, keypoints mapped back to level 0, and the feature budget split
    across levels in proportion to 0.75^level."""

    def __init__(self, max_features: int = 512, threshold: float = 20.0, n_levels: int = 3, device="cuda"):
        self.max_features = max_features
        self.threshold = threshold
        self.n_levels = n_levels
        self.device = torch.device(device)

    def _k_levels(self, h: int, w: int) -> tuple:
        norm = sum(0.75**level for level in range(self.n_levels))
        out = []
        for level in range(self.n_levels):
            if min(h, w) < 2 * (_PATCH_R + 1):
                break
            out.append(max(16, int(self.max_features * (0.75**level) / norm)))
            h //= 2
            w //= 2
        return tuple(out)

    def detect_and_compute(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Host image (H, W) [0, 255] -> (descriptors (D, 32) uint8, keypoints (D, 2))."""
        img = np.asarray(image, np.float32)
        k_levels = self._k_levels(*img.shape)
        if not k_levels:
            return np.zeros((0, 32), np.uint8), np.zeros((0, 2), np.int32)
        packed = detect_pyramid_batch(torch.from_numpy(img)[None].to(self.device), k_levels, self.threshold)
        return unpack_rows(packed.cpu().numpy(), self.max_features)[0]

    def detect_and_compute_batch(self, images: torch.Tensor) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(B, H, W) images on the device -> per image (descriptors (D, 32)
        uint8, keypoints (D, 2)): one kernel 12 call and one read for the
        batch."""
        b, h, w = images.shape
        k_levels = self._k_levels(h, w)
        if not k_levels:
            z = (np.zeros((0, 32), np.uint8), np.zeros((0, 2), np.int32))
            return [z] * b
        packed = detect_pyramid_batch(images, k_levels, self.threshold)
        return unpack_rows(packed.cpu().numpy(), self.max_features)


# ------------------------------------------------------------ matching


def hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """(Da, 256), (Db, 256) {0, 1} -> (Da, Db) Hamming distances through the
    reference's +-1 float matmul: (256 - agreements + disagreements) / 2."""
    pm_a = bits_a.to(torch.float32) * 2.0 - 1.0
    pm_b = bits_b.to(torch.float32) * 2.0 - 1.0
    return (bits_a.shape[-1] - pm_a @ pm_b.transpose(-1, -2)) * 0.5


def match_scores_masked_ref(a: torch.Tensor, a_mask: torch.Tensor, bs: torch.Tensor, b_masks: torch.Tensor,
                            max_dist: float = 64.0) -> torch.Tensor:
    """Plain version of `match_scores_masked`, line for line with the
    reference's vmapped `_match_scores_masked`."""
    d = hamming_matrix(_unpack_bits(a), _unpack_bits(bs))  # (k, D, D)
    valid = a_mask[None, :, None] & b_masks[:, None, :]
    d = torch.where(valid, d, 1e9)
    best_ab = torch.argmin(d, dim=2)  # first index on ties
    best_ba = torch.argmin(d, dim=1)
    ia = torch.arange(a.shape[0], device=a.device)
    mutual = (torch.gather(best_ba, 1, best_ab) == ia) & a_mask
    dist_ok = torch.gather(d, 2, best_ab[..., None])[..., 0] <= max_dist
    n_good = torch.sum((mutual & dist_ok).to(torch.float32), dim=1)
    na = torch.sum(a_mask.to(torch.float32))
    nb = torch.sum(b_masks.to(torch.float32), dim=1)
    return n_good / torch.clamp(torch.minimum(na, nb), min=1.0)


def match_scores_masked(a: torch.Tensor, a_mask: torch.Tensor, bs: torch.Tensor, b_masks: torch.Tensor,
                        max_dist: float = 64.0) -> torch.Tensor:
    """Query descriptors a (D, 32) uint8 with mask (D,) against candidates
    bs (k, D, 32) with masks (k, D) -> (k,) float32: the fraction of masked
    mutual-best matches within `max_dist` bits, over the smaller set. Kernel
    12b on CUDA, the plain version on CPU."""
    if a.device.type == "cpu":
        return match_scores_masked_ref(a, a_mask, bs, b_masks, max_dist)
    name = "match_scores_batch"
    k, cap = b_masks.shape
    check_cuda(name, a, a_mask, bs, b_masks)
    check_dtype(name, a, torch.uint8, (cap, 32))
    check_dtype(name, a_mask, torch.bool, (cap,))
    check_dtype(name, bs, torch.uint8, (k, cap, 32))
    out = torch.empty((k,), dtype=torch.float32, device=a.device)
    MATCH_KERNEL.call("lvs_orb_match", ptr(a), ptr(a_mask), ptr(bs), ptr(b_masks), cap, k,
                      float(np.float32(max_dist)), ptr(out))
    MATCH_KERNEL.launches += 1
    return out


def _padded(desc: np.ndarray, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cap, 32) uint8 rows and (cap,) mask of the first `cap` descriptors."""
    rows = np.zeros((cap, 32), np.uint8)
    mask = np.zeros(cap, bool)
    if desc is not None and desc.shape[0] > 0:
        packed = _as_packed(desc)[:cap]
        rows[: packed.shape[0]] = packed
        mask[: packed.shape[0]] = True
    return rows, mask


def match_score(desc_a: np.ndarray, desc_b: np.ndarray, max_dist: float = 64.0, device="cuda") -> float:
    """[0, 1] similarity: the fraction of mutual-best matches under
    `max_dist`, the role of the DBoW3 query score (`loop_detector.hpp:244`
    gates at 0.04). Both sets padded to the larger, masks marking the pads."""
    if desc_a.shape[0] == 0 or desc_b.shape[0] == 0:
        return 0.0
    cap = max(desc_a.shape[0], desc_b.shape[0])
    (a, am), (b, bm) = _padded(desc_a, cap), _padded(desc_b, cap)
    dev = torch.device(device)
    score = match_scores_masked(torch.from_numpy(a).to(dev), torch.from_numpy(am).to(dev),
                                torch.from_numpy(b[None]).to(dev), torch.from_numpy(bm[None]).to(dev), max_dist)
    return float(score[0])


def match_scores_batch(desc_a: np.ndarray, desc_list, cap: int = 512, max_dist: float = 64.0,
                       device="cuda") -> np.ndarray:
    """`match_score` of one descriptor set against many candidates in one
    call. Sets are padded to `cap` rows and the candidate count to a power
    of two, as in the reference."""
    if desc_a.shape[0] == 0 or not desc_list:
        return np.zeros(len(desc_list))
    a, a_mask = _padded(desc_a, cap)
    k = len(desc_list)
    k_pad = 1
    while k_pad < k:
        k_pad *= 2
    bs = np.zeros((k_pad, cap, 32), np.uint8)
    b_masks = np.zeros((k_pad, cap), bool)
    for i, d in enumerate(desc_list):
        bs[i], b_masks[i] = _padded(d, cap)
    dev = torch.device(device)
    scores = match_scores_masked(
        torch.from_numpy(a).to(dev), torch.from_numpy(a_mask).to(dev), torch.from_numpy(bs).to(dev),
        torch.from_numpy(b_masks).to(dev), max_dist,
    )
    return scores.cpu().numpy()[:k]
