"""Generalized ICP (plane-to-plane), the registration factory's GICP /
GICP_OMP options (port of `lv_slam_tpu.ops.gicp`, the reference's
`pclomp::GeneralizedIterativeClosestPoint`).

Each point's covariance comes from its k = 8 grid neighbours (K9g's build,
K9k's k-NN), regularized to the plane shape (1e-3, 1, 1) along its
eigenvectors: kernel 19a (`csrc/gicp.cu`), for the source once and for the
target's matches in every iteration (there only on the lanes that the
normal equations read: `LaneTest`). Each Gauss-Newton iteration matches
the moved source to the target (K9k, k = 1) and reduces the Mahalanobis
normal equations sum J^T (C_b + R C_a R^T)^-1 J and sum J^T (...)^-1 d
(kernel 19b); the 6x6 solve with its ridge and the non-finite guard stay
torch on the device, so the fixed-trip loop never reads the host.
`*_ref` are the plain versions, which CPU tensors take.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.kernels._build import F32, I32, PTR, Kernel, check_cuda, check_dtype, ptr, scratch_bytes
from lv_slam_tpu_torch.ops.knn import KnnGrid, build_grid, knn
from lv_slam_tpu_torch.ops.linalg3 import eigh3x3
from lv_slam_tpu_torch.ops.ndt import finish_counter

_N_TERMS = 42  # H (36), g (6)
_GICP_EVALS = (1e-3, 1.0, 1.0)  # the reference's gicp_epsilon shape

COV_KERNEL = Kernel(
    "_plane_covariances",
    source="lv_slam_tpu_torch/csrc/gicp.cu",
    replaces="lv_slam_tpu/ops/gicp.py:31",
    entries={"lvs_plane_cov": [PTR, PTR, I32, I32, I32, PTR, PTR, PTR, PTR, F32, PTR, PTR]},
)
NORMAL_KERNEL = Kernel(
    "gicp_align",
    source="lv_slam_tpu_torch/csrc/gicp.cu",
    replaces="lv_slam_tpu/ops/gicp.py:48",
    entries={"lvs_gicp_normal": [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, I32, F32, PTR, ctypes.c_longlong, PTR, PTR]},
)


class GICPResult(NamedTuple):
    transform: torch.Tensor  # (4, 4)
    fitness: torch.Tensor    # () mean squared match distance
    n_matches: torch.Tensor  # () int32


_EVERY, _MASK, _NEED = 0, 1, 2  # csrc/gicp.cu's CovMode


class LaneTest(NamedTuple):
    """K19b's lane test, need = src_ok & nn_valid & (nn_dist < max_dist):
    the lanes whose target covariance the normal equations read."""

    src_ok: torch.Tensor    # (N,) bool
    nn_valid: torch.Tensor  # (N,) bool
    nn_dist: torch.Tensor   # (N,) float32
    max_dist: float

    def lanes(self) -> torch.Tensor:
        # csrc/gicp.cu's `lane_needed`, which K19a's lane-test call and K19b share
        return self.src_ok & self.nn_valid & (self.nn_dist < np.float32(self.max_dist))


def regularized_covariances(
    pts: torch.Tensor, valid: torch.Tensor, mask: Optional[torch.Tensor] = None, need: Optional[LaneTest] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """From each lane's k neighbours (pts (N, k, 3), valid (N, k)): the
    covariance of the valid ones, + 1e-9 I, with its eigenvalues replaced by
    (1e-3, 1, 1): (N, 3, 3). With `mask`, also ok = mask & (k valid >= 3)
    and the identity where not ok. With `need` (K19b's lane test), the
    matrix on the lanes it passes (no count test) and the identity on the
    others. Kernel 19a on CUDA, the plain version on CPU."""
    if mask is not None and need is not None:
        raise ValueError("regularized_covariances: give a mask or a lane test, not both")
    if pts.device.type == "cpu":
        return regularized_covariances_ref(pts, valid, mask, need)
    n, k = valid.shape
    pts, valid = pts.contiguous(), valid.contiguous()
    flags = () if mask is None else (mask.contiguous(),)
    if need is not None:
        flags = (need.src_ok.contiguous(), need.nn_valid.contiguous(), need.nn_dist.contiguous())
    check_cuda("_plane_covariances", pts, valid, *flags)
    check_dtype("_plane_covariances", pts, torch.float32, (n, k, 3))
    check_dtype("_plane_covariances", valid, torch.bool, (n, k))
    for t, dtype in zip(flags, (torch.bool, torch.bool, torch.float32)):
        check_dtype("_plane_covariances", t, dtype, (n,))
    cov = torch.empty((n, 3, 3), dtype=torch.float32, device=pts.device)
    ok = None if mask is None else torch.empty((n,), dtype=torch.bool, device=pts.device)
    mode = _EVERY if not flags else _MASK if mask is not None else _NEED
    mask_ptr = ptr(flags[0]) if mode == _MASK else None
    need_ptrs = [ptr(t) for t in flags] if mode == _NEED else [None, None, None]
    max_dist = float(np.float32(need.max_dist)) if need is not None else 0.0
    COV_KERNEL.call(
        "lvs_plane_cov", ptr(pts), ptr(valid), n, k, mode, mask_ptr, *need_ptrs, max_dist, ptr(cov),
        None if ok is None else ptr(ok),
    )
    COV_KERNEL.launches += 1
    return cov, ok


def regularized_covariances_ref(pts, valid, mask=None, need: Optional[LaneTest] = None):
    """Plain PyTorch version of `regularized_covariances`: the reference's
    formulas, each sum over the neighbours in order, as the kernel adds them."""
    def neighbour_sum(x):  # sum over the k axis in order
        s = x[:, 0]
        for j in range(1, x.shape[1]):
            s = s + x[:, j]
        return s

    w = valid.to(torch.float32)
    wsum = neighbour_sum(w)
    cnt = torch.clamp(wsum, min=1.0)
    mu = neighbour_sum(pts * w[..., None]) / cnt[:, None]
    c = (pts - mu[:, None, :]) * w[..., None]
    cov = neighbour_sum(c[..., :, None] * c[..., None, :]) / cnt[:, None, None]
    eye = torch.eye(3, dtype=torch.float32, device=pts.device)
    _, v = eigh3x3(cov + 1e-9 * eye)
    vg = [v[..., j] * g for j, g in enumerate(_GICP_EVALS)]  # columns, scaled
    reg = (vg[0][:, :, None] * v[:, None, :, 0] + vg[1][:, :, None] * v[:, None, :, 1]) \
        + vg[2][:, :, None] * v[:, None, :, 2]
    if need is not None:
        return torch.where(need.lanes()[:, None, None], reg, eye), None
    if mask is None:
        return reg, None
    ok = mask & (wsum >= 3)
    return torch.where(ok[:, None, None], reg, eye), ok


# How two sets of plane covariances from the same neighbourhoods are judged
# (the card against the plain version, the port against the reference). Where
# a neighbourhood's relative eigen-gap g = (lambda1 - lambda0) / lambda2
# exceeds GAP_SPLIT = sqrt(float32 eps), the reference's own float32
# eigenvectors move as 1 / g under one-ulp input noise, and its largest move
# times g is PLANE_ENVELOPE (`scripts/reference_spread.py gicp`). Below the
# split the low pair is repeated to rounding and the normal is noise in every
# implementation, so those lanes keep only the plane shape, to SHAPE_TOL.
PLANE_ENVELOPE = 6.7e-5
GAP_SPLIT = 3.4e-4
SHAPE_TOL = 1e-4


class PlaneCovarianceError(NamedTuple):
    n_gap: int         # lanes with g > GAP_SPLIT, compared entry by entry
    n_identical: int   # of those, the bit-identical ones
    max_diff: float    # their largest entry difference
    envelope: float    # their largest difference times g
    n_repeated: int    # lanes with g <= GAP_SPLIT
    shape_err: float   # their largest eigenvalue departure from (1e-3, 1, 1)

    @property
    def ok(self) -> bool:
        return self.envelope <= PLANE_ENVELOPE and self.shape_err <= SHAPE_TOL


def eigen_gap(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """g = (lambda1 - lambda0) / lambda2 of each lane's neighbour covariance
    (pts (N, k, 3), valid (N, k)), float64 on the host (cuSOLVER's batched
    eigh refuses large batches)."""
    w = valid.double().cpu()
    cnt = torch.clamp(w.sum(1), min=1.0)
    p = pts.double().cpu()
    mu = (p * w[..., None]).sum(1) / cnt[:, None]
    c = (p - mu[:, None]) * w[..., None]
    ev = torch.linalg.eigvalsh(torch.einsum("nki,nkj->nij", c, c) / cnt[:, None, None])
    return (ev[:, 1] - ev[:, 0]) / torch.clamp(ev[:, 2], min=1e-30)


def plane_covariance_error(got, want, pts, valid, ok=None) -> PlaneCovarianceError:
    """`got` against `want` ((N, 3, 3) each) on the lanes of `ok` (all lanes
    without it), whose neighbourhoods are pts / valid, as set out above."""
    got, want = got.cpu(), want.cpu()
    g = eigen_gap(pts, valid)
    keep = torch.ones_like(g, dtype=torch.bool) if ok is None else ok.cpu()
    sel, low = keep & (g > GAP_SPLIT), keep & (g <= GAP_SPLIT)
    d = (got - want).abs().amax(dim=(1, 2)).double()[sel]
    shape = torch.linalg.eigvalsh(got[low].double()) - torch.tensor(_GICP_EVALS, dtype=torch.float64)
    return PlaneCovarianceError(
        n_gap=int(sel.sum()), n_identical=int((d == 0).sum()), max_diff=float(d.max()) if d.numel() else 0.0,
        envelope=float((d * g[sel]).max()) if d.numel() else 0.0, n_repeated=int(low.sum()),
        shape_err=float(shape.abs().max()) if shape.numel() else 0.0,
    )


def _plane_covariances(xyz: torch.Tensor, mask: torch.Tensor, grid: KnnGrid, k: int = 8):
    """GICP-regularized covariance of each point from its k grid neighbours,
    and ok = mask & (>= 3 neighbours)."""
    _, pts, valid = knn(grid, xyz, k=k)
    return regularized_covariances(pts, valid, mask)


def gicp_normal_equations(
    src: torch.Tensor, src_ok: torch.Tensor, cov_a: torch.Tensor, transform: torch.Tensor, nn: torch.Tensor,
    nn_dist: torch.Tensor, nn_valid: torch.Tensor, cov_b: torch.Tensor, max_dist: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H (6, 6), g (6,)) = the sums of J^T W J and J^T W d over the lanes
    whose source is ok and whose match (nn, nn_dist, nn_valid) lies within
    `max_dist`, W = (C_b + R C_a R^T + 1e-6 I)^-1, d = T src - nn, J =
    [I, -[T src]x]. Kernel 19b on CUDA, the plain version on CPU."""
    if src.device.type == "cpu":
        return gicp_normal_equations_ref(src, src_ok, cov_a, transform, nn, nn_dist, nn_valid, cov_b, max_dist)
    n = src.shape[0]
    args = [t.contiguous() for t in (src, src_ok, cov_a, transform, nn, nn_dist, nn_valid, cov_b)]
    check_cuda("gicp_align", *args)
    for t, dtype, shape in zip(args, (torch.float32, torch.bool, torch.float32, torch.float32, torch.float32,
                                      torch.float32, torch.bool, torch.float32),
                               ((n, 3), (n,), (n, 3, 3), (4, 4), (n, 3), (n,), (n,), (n, 3, 3))):
        check_dtype("gicp_align", t, dtype, shape)
    # the tiles' partial rows and live flags; the last block's counter (0 between calls)
    scratch = torch.empty((scratch_bytes("lvs_gicp_normal_scratch_bytes", n),), dtype=torch.uint8, device=src.device)
    out = torch.empty((_N_TERMS,), dtype=torch.float32, device=src.device)
    NORMAL_KERNEL.call(
        "lvs_gicp_normal", *(ptr(t) for t in args), n, float(np.float32(max_dist)), ptr(scratch), scratch.numel(),
        ptr(finish_counter(src.device)), ptr(out),
    )
    NORMAL_KERNEL.launches += 1
    return out[:36].view(6, 6), out[36:]


def gicp_normal_equations_ref(src, src_ok, cov_a, transform, nn, nn_dist, nn_valid, cov_b, max_dist):
    """Plain PyTorch version of `gicp_normal_equations`, in the kernel's
    per-lane order of operations (the inverse by cofactors)."""
    y = se3.transform_points_fma(transform, src)
    rot = transform[:3, :3]

    def mat3(a, b):  # (..., 3, 3) @ (..., 3, 3), sums in order
        return (a[..., :, 0, None] * b[..., None, 0, :] + a[..., :, 1, None] * b[..., None, 1, :]) \
            + a[..., :, 2, None] * b[..., None, 2, :]

    eye = torch.eye(3, dtype=torch.float32, device=src.device)
    m = (cov_b + mat3(mat3(rot, cov_a), rot.T)) + 1e-6 * eye
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m20, m21, m22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    cof = torch.stack([
        torch.stack([m11 * m22 - m12 * m21, m12 * m20 - m10 * m22, m10 * m21 - m11 * m20], -1),
        torch.stack([m02 * m21 - m01 * m22, m00 * m22 - m02 * m20, m01 * m20 - m00 * m21], -1),
        torch.stack([m01 * m12 - m02 * m11, m02 * m10 - m00 * m12, m00 * m11 - m01 * m10], -1),
    ], -2)
    det = (m00 * cof[:, 0, 0] + m01 * cof[:, 0, 1]) + m02 * cof[:, 0, 2]
    w = cof.transpose(1, 2) / det[:, None, None]
    ok = src_ok & nn_valid & (nn_dist < np.float32(max_dist))
    zero, one = torch.zeros_like(y[:, 0]), torch.ones_like(y[:, 0])
    jac = torch.stack([
        torch.stack([one, zero, zero, zero, y[:, 2], -y[:, 1]], -1),
        torch.stack([zero, one, zero, -y[:, 2], zero, y[:, 0]], -1),
        torch.stack([zero, zero, one, y[:, 1], -y[:, 0], zero], -1),
    ], -2)  # (N, 3, 6)
    d = y - nn
    wj = (w[:, :, 0, None] * jac[:, None, 0, :] + w[:, :, 1, None] * jac[:, None, 1, :]) \
        + w[:, :, 2, None] * jac[:, None, 2, :]
    wd = (w[:, :, 0] * d[:, None, 0] + w[:, :, 1] * d[:, None, 1]) + w[:, :, 2] * d[:, None, 2]
    h = (jac[:, 0, :, None] * wj[:, None, 0, :] + jac[:, 1, :, None] * wj[:, None, 1, :]) \
        + jac[:, 2, :, None] * wj[:, None, 2, :]
    g = (jac[:, 0, :] * wd[:, None, 0] + jac[:, 1, :] * wd[:, None, 1]) + jac[:, 2, :] * wd[:, None, 2]
    h = torch.sum(torch.where(ok[:, None, None], h, 0.0), dim=0)
    g = torch.sum(torch.where(ok[:, None], g, 0.0), dim=0)
    return h, g


def gicp_align(
    target: PointCloud,
    source: PointCloud,
    guess: torch.Tensor,
    *,
    max_correspondence_distance: float = 2.0,
    max_iterations: int = 20,
    grid_cell: float = 1.0,
    k_covariance: int = 8,
) -> GICPResult:
    """Align `source` onto `target` from `guess` by `max_iterations`
    Gauss-Newton iterations (no early stop, as the reference's fori_loop)."""
    tgt_xyz, tgt_mask = target.masked_xyz().contiguous(), target.mask.contiguous()
    src_xyz, src_mask = source.masked_xyz().contiguous(), source.mask.contiguous()
    tgt_grid = build_grid(tgt_xyz, tgt_mask, grid_cell)
    src_grid = build_grid(src_xyz, src_mask, grid_cell)
    cov_src, src_ok = _plane_covariances(src_xyz, src_mask, src_grid, k_covariance)
    src_ok = src_mask & src_ok
    eye6 = torch.eye(6, dtype=torch.float32, device=guess.device)
    transform = guess
    for _ in range(max_iterations):
        y = se3.transform_points_fma(transform, src_xyz)
        dists, pts, valid = knn(tgt_grid, y, k=1)
        nn = pts[:, 0]
        # the target covariance fresh from the match's own neighbourhood
        _, nn_nbrs, nn_valid = knn(tgt_grid, nn, k=k_covariance)
        # (K19b's lanes only: it reads no other lane of them)
        cov_b, _ = regularized_covariances(
            nn_nbrs, nn_valid, need=LaneTest(src_ok, valid[:, 0], dists[:, 0], max_correspondence_distance))
        h, g = gicp_normal_equations(src_xyz, src_ok, cov_src, transform, nn, dists[:, 0], valid[:, 0], cov_b,
                                     max_correspondence_distance)
        ridge = 1e-6 * torch.trace(h) / 6.0 + 1e-9
        delta, _ = torch.linalg.solve_ex(h + ridge * eye6, -g)
        delta = torch.where(torch.all(torch.isfinite(delta)), delta, 0.0)
        transform = se3.exp_se3(delta) @ transform
    y = se3.transform_points_fma(transform, src_xyz)
    dists, _, valid = knn(tgt_grid, y, k=1)
    ok = src_mask & valid[:, 0] & (dists[:, 0] < np.float32(max_correspondence_distance))
    n = torch.sum(ok.to(torch.float32))
    fitness = torch.sum(torch.where(ok, dists[:, 0] ** 2, 0.0)) / torch.clamp(n, min=1.0)
    return GICPResult(transform=transform, fitness=fitness, n_matches=n.to(torch.int32))
