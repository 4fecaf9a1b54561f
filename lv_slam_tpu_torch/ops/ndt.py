"""NDT: the mixture constants, the result type, the damped Newton loop (K7)
and the generic derivative pass over the dense LUT with its align (port of
`lv_slam_tpu.ops.ndt`, and of the Newton loop of `lv_slam_tpu.ops.ndt_soa`).

`ndt_derivatives` is kernel K6G (`csrc/ndt_lut.cu`) on CUDA tensors and
`ndt_derivatives_ref` on CPU tensors: the reference's generic formulas over
`lookup_leaves`, the full 3x3 inverse covariance of each leaf. The host DLO
scores its retry with it, and `ndt_align` (the generic align, with
`dof_mask`) runs the Newton loop over it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.kernels._build import F32, I32, PTR, Kernel, check_cuda, check_dtype, ptr
from lv_slam_tpu_torch.ops.linalg3 import fma32
from lv_slam_tpu_torch.ops.voxel_map import VoxelMap, lookup_leaves, neighborhood_offsets

N_TERMS = 43  # score (1) + grad (6) + hess (36, not symmetric)
BLOCK = 256   # threads per block of the derivative passes (csrc/common.cuh kThreads)

KERNEL = Kernel(
    "ndt_derivatives",
    source="lv_slam_tpu_torch/csrc/ndt_lut.cu",
    replaces="lv_slam_tpu/ops/ndt.py:59",
    entries={
        "lvs_ndt_generic_derivatives": [
            PTR, PTR, PTR, PTR, PTR, F32, I32, PTR, I32, PTR, PTR, F32, F32, PTR, I32, I32, PTR, I32, PTR,
        ],
    },
)


class GaussParams(NamedTuple):
    d1: float
    d2: float
    d3: float


def make_gauss_params(resolution: float, outlier_ratio: float = 0.55) -> GaussParams:
    """Magnusson eq. 6.8 mixture constants, rounded through float32 at the
    same steps as the reference. They are host floats: the kernel takes them
    by value, so reading them costs no device round trip."""

    def f32(x) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32)

    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / resolution**3
    d3 = -torch.log(f32(c2))
    d1 = -torch.log(f32(c1 + c2)) - d3
    d2 = -2.0 * torch.log((-torch.log(f32(c1) * f32(math.exp(-0.5)) + c2) - d3) / d1)
    return GaussParams(float(d1), float(d2), float(d3))


class NDTResult(NamedTuple):
    transform: torch.Tensor          # (4,4) final source->target transform
    score: torch.Tensor              # () summed mixture score at the final pose
    iterations: int                  # Newton iterations, coarse phase included
    converged: bool
    hessian: torch.Tensor            # (6,6) at the final pose
    trans_probability: torch.Tensor  # () score / n_points


def ndt_derivatives(
    vmap_: VoxelMap,
    lut: torch.Tensor,         # (E^3,) int32
    src_xyz: torch.Tensor,     # (N, 3)
    src_mask: torch.Tensor,    # (N,)
    transform: torch.Tensor,   # (4, 4)
    gauss: GaussParams,
    offsets: torch.Tensor,     # (K, 3) int32
    weighted: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score, gradient (6,) and Hessian (6, 6) of the points against the map
    by the generic formulas. Kernel K6G on CUDA, the plain version on CPU."""
    if src_xyz.device.type == "cpu":
        return ndt_derivatives_ref(vmap_, lut, src_xyz, src_mask, transform, gauss, offsets, weighted)
    n, k, leaf_cap = src_xyz.shape[0], offsets.shape[0], vmap_.leaf_cap
    name = "ndt_derivatives"
    check_cuda(name, vmap_.means, vmap_.icovs, vmap_.weights, lut, vmap_.origin_cell, src_xyz, src_mask,
               transform, offsets)
    check_dtype(name, vmap_.means, torch.float32, (leaf_cap, 3))
    check_dtype(name, vmap_.icovs, torch.float32, (leaf_cap, 3, 3))
    check_dtype(name, vmap_.weights, torch.float32, (leaf_cap,))
    check_dtype(name, lut, torch.int32, (vmap_.extent ** 3,))
    check_dtype(name, vmap_.origin_cell, torch.int32, (3,))
    check_dtype(name, src_xyz, torch.float32, (n, 3))
    check_dtype(name, src_mask, torch.bool, (n,))
    check_dtype(name, transform, torch.float32, (4, 4))
    check_dtype(name, offsets, torch.int32, (k, 3))
    n_blocks = max(1, -(-n // BLOCK))
    partials = torch.empty((n_blocks, N_TERMS), dtype=torch.float32, device=src_xyz.device)
    out = torch.empty((N_TERMS,), dtype=torch.float32, device=src_xyz.device)
    KERNEL.call(
        "lvs_ndt_generic_derivatives",
        ptr(vmap_.means), ptr(vmap_.icovs), ptr(vmap_.weights), ptr(lut), ptr(vmap_.origin_cell),
        float(np.float32(vmap_.resolution)), vmap_.extent, ptr(src_xyz), n, ptr(src_mask), ptr(transform),
        float(np.float32(gauss.d1)), float(np.float32(gauss.d2)), ptr(offsets), k, int(weighted),
        ptr(partials), n_blocks, ptr(out),
    )
    KERNEL.launches += 1
    return out[0], out[1:7], out[7:].view(6, 6)


def _cross_fma(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u x w as XLA contracts `jnp.cross` on the CPU: fma(u1, w2, -(u2 * w1)), ..."""
    return torch.stack([
        fma32(u[..., 1], w[..., 2], -(u[..., 2] * w[..., 1])),
        fma32(u[..., 2], w[..., 0], -(u[..., 0] * w[..., 2])),
        fma32(u[..., 0], w[..., 1], -(u[..., 1] * w[..., 0])),
    ], dim=-1)


def ndt_derivatives_ref(vmap_, lut, src_xyz, src_mask, transform, gauss, offsets, weighted):
    """Plain PyTorch version of `ndt_derivatives`, line for line with the
    reference: the (N, K) point-neighbour grid from `lookup_leaves`, reduced
    by einsums."""
    y = se3.transform_points_fma(transform, src_xyz)
    means, icovs, weights, hit = lookup_leaves(vmap_, lut, y, offsets)
    hit = hit & src_mask[:, None]
    d = y[:, None, :] - means                                   # (N,K,3)
    q = torch.einsum("nkij,nkj->nki", icovs, d)
    md = torch.sum(d * q, dim=-1)
    e = torch.exp(-0.5 * gauss.d2 * md)
    gate_val = gauss.d2 * e
    gate = hit & (gate_val <= 1.0) & (gate_val >= 0.0) & torch.isfinite(gate_val)
    w = torch.where(gate, weights if weighted else 1.0, 0.0)
    score = torch.sum(w * (-gauss.d1 * e))

    f = (gauss.d1 * gauss.d2) * e
    yxq = _cross_fma(y[:, None, :].expand_as(q), q)
    g6 = torch.cat([q, yxq], dim=-1)                          # (N,K,6)
    wf = w * f
    grad = torch.einsum("nk,nki->i", wf, g6)
    h_outer = torch.einsum("nk,nki,nkj->ij", -gauss.d2 * wf, g6, g6)
    qy = torch.sum(q * y[:, None, :], dim=-1)
    eye3 = torch.eye(3, dtype=y.dtype, device=y.device)
    t2_rot = torch.einsum("nk,ni,nkj->ij", wf, y, q) - torch.sum(wf * qy) * eye3
    s_mat = se3.skew(y)
    c_sum = torch.einsum("nk,nkij->ij", wf, icovs)
    cs = torch.einsum("nk,nkij,njb->ib", wf, icovs, s_mat)
    sc = torch.einsum("nk,nia,nkab->ib", wf, s_mat, icovs)
    scs = torch.einsum("nk,nia,nkab,nbj->ij", wf, s_mat, icovs, s_mat)
    hess = h_outer.clone()
    hess[3:, 3:] += t2_rot
    hess[:3, :3] += c_sum
    hess[:3, 3:] -= cs
    hess[3:, :3] += sc
    hess[3:, 3:] -= scs
    return score, grad, hess


def ndt_align(
    vmap_: VoxelMap,
    lut: torch.Tensor,
    source: PointCloud,
    guess: torch.Tensor,
    *,
    resolution: float,
    outlier_ratio: float = 0.55,
    step_size: float = 0.1,
    transformation_epsilon: float = 0.01,
    max_iterations: int = 35,
    neighborhood: str = "DIRECT7",
    weighted: bool = False,
    dof_mask: Optional[Tuple[bool, ...]] = None,
) -> NDTResult:
    """Register `source` onto the map (and its LUT) with the generic pass.
    `dof_mask`: an optional 6-tuple of the free tangent dims (tx, ty, tz,
    rx, ry, rz); the others are frozen (the reference's DOF masking of the
    ground-constrained NDT)."""
    gauss = make_gauss_params(resolution, outlier_ratio)
    offsets = neighborhood_offsets(neighborhood, guess.device)
    dof = None if dof_mask is None else torch.tensor(dof_mask, dtype=torch.float32).to(guess.device)
    src_xyz = source.masked_xyz().contiguous()
    src_mask = source.mask.contiguous()

    def derivs(transform):
        return ndt_derivatives(vmap_, lut, src_xyz, src_mask, transform.contiguous(), gauss, offsets, weighted)

    transform, score, _, hess, _, it, converged = _newton_loop(
        derivs, guess, np.float32(transformation_epsilon), step_size, max_iterations, dof=dof,
    )
    n_pts = torch.clamp(torch.sum(src_mask.to(torch.float32)), min=1.0)
    return NDTResult(
        transform=transform, score=score, iterations=it, converged=converged, hessian=hess,
        trans_probability=score / n_pts,
    )


def _newton_loop(derivs, guess: torch.Tensor, eps: float, step_max: float, max_iterations: int,
                 dof: Optional[torch.Tensor] = None):
    """Monotone-guarded damped-Newton ascent on the NDT score (the
    reference's `ndt_soa._newton_loop`, and `ndt_align`'s loop with
    `dof`: a (6,) 0/1 float mask whose 0 dims are frozen by zeroing their
    rows and columns of the normal equations and pinning their diagonal).

    The reference's `lax.while_loop` becomes a Python loop: each iteration
    reads one bool (`converged`) back from the device, and the start reads
    whether the first score is NaN (the reference's `ndt_align` runs one
    iteration on a NaN start, which changes nothing but its count).
    Everything else stays on the device. Returns (transform, score, grad,
    hess, cap, iterations, converged)."""
    eps32 = np.float32(eps)
    step_min = float(eps32 / np.float32(2.0))
    eps = float(eps32)
    step_max = float(np.float32(step_max))
    score, grad, hess = derivs(guess)
    transform = guess
    eye6 = torch.eye(6, dtype=hess.dtype, device=hess.device)
    cap = torch.full((), step_max, dtype=hess.dtype, device=hess.device)
    it = 0
    converged = bool(torch.isnan(score))
    while not converged:
        ridge = 1e-6 * torch.trace(torch.abs(hess)) / 6.0 + 1e-12
        if dof is not None:
            grad = grad * dof
            hess = hess * dof[:, None] * dof[None, :] - (1.0 - dof) * eye6
        delta, info = torch.linalg.solve_ex(hess + ridge * eye6, -grad)
        norm = torch.sqrt(torch.sum(delta * delta))
        bad = (norm == 0.0) | ~torch.isfinite(norm) | (info != 0)
        direction = delta / torch.where(bad, 1.0, norm)
        dphi0 = -torch.dot(grad, direction)
        direction = torch.where(dphi0 > 0, -direction, direction)
        alpha = torch.minimum(torch.clamp(norm, min=step_min), cap)
        new_transform = se3.exp_se3(alpha * direction) @ transform
        new_score, new_grad, new_hess = derivs(new_transform)
        accept = ~bad & (new_score >= score)
        transform = torch.where(accept, new_transform, transform)
        score = torch.where(accept, new_score, score)
        grad = torch.where(accept, new_grad, grad)
        hess = torch.where(accept, new_hess, hess)
        cap = torch.where(accept, step_max, torch.clamp(cap * 0.5, min=step_min))
        it += 1
        shrunk_out = ~accept & (alpha <= step_min)
        stop = bad | (accept & (alpha < eps)) | shrunk_out
        converged = it > max_iterations or bool(stop)
    return transform, score, grad, hess, cap, it, converged


def _newton_loop_batched(derivs, guesses: torch.Tensor, eps: float, step_max: float, max_iterations: int):
    """`_newton_loop` over k lanes at once, as the reference's vmapped
    `lax.while_loop` runs it: every lane steps until all are done, and a
    done lane keeps its state, so each lane ends where its own loop would.
    `derivs(transforms, active)` returns the (k,), (k, 6), (k, 6, 6)
    derivatives at (k, 4, 4) transforms; `active` is the host list of lanes
    still running (a lane's result is ignored once it is done). Each
    iteration reads the k done flags back once. Returns (transforms, scores,
    iterations (k,) int64)."""
    eps32 = np.float32(eps)
    step_min = float(eps32 / np.float32(2.0))
    eps = float(eps32)
    step_max = float(np.float32(step_max))
    k = guesses.shape[0]
    score, grad, hess = derivs(guesses, [True] * k)
    transform = guesses
    eye6 = torch.eye(6, dtype=hess.dtype, device=hess.device)
    cap = torch.full((k,), step_max, dtype=hess.dtype, device=hess.device)
    it = torch.zeros((k,), dtype=torch.int64, device=hess.device)
    done = torch.isnan(score)
    active = [not d for d in done.tolist()]
    while any(active):
        run = ~done
        ridge = 1e-6 * torch.abs(hess).diagonal(dim1=-2, dim2=-1).sum(-1) / 6.0 + 1e-12
        delta, info = torch.linalg.solve_ex(hess + ridge[:, None, None] * eye6, -grad)
        norm = torch.sqrt(torch.sum(delta * delta, dim=-1))
        bad = (norm == 0.0) | ~torch.isfinite(norm) | (info != 0)
        direction = delta / torch.where(bad, 1.0, norm)[:, None]
        dphi0 = -torch.sum(grad * direction, dim=-1)
        direction = torch.where((dphi0 > 0)[:, None], -direction, direction)
        alpha = torch.minimum(torch.clamp(norm, min=step_min), cap)
        new_transform = se3.exp_se3(alpha[:, None] * direction) @ transform
        new_score, new_grad, new_hess = derivs(new_transform, active)
        accept = ~bad & (new_score >= score)
        take = run & accept
        transform = torch.where(take[:, None, None], new_transform, transform)
        score = torch.where(take, new_score, score)
        grad = torch.where(take[:, None], new_grad, grad)
        hess = torch.where(take[:, None, None], new_hess, hess)
        cap = torch.where(run, torch.where(accept, step_max, torch.clamp(cap * 0.5, min=step_min)), cap)
        it = it + run.to(torch.int64)
        shrunk_out = ~accept & (alpha <= step_min)
        stop = bad | (it > max_iterations) | (accept & (alpha < eps)) | shrunk_out
        done = done | (run & stop)
        active = [not d for d in done.tolist()]
    return transform, score, it
