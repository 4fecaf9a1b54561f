"""The LUT/SoA NDT pass (port of `lv_slam_tpu.ops.ndt_soa`): leaves packed
into (L, 16) rows [mu(3), upper inverse covariance (6), weight, pad(6)], one
LUT probe and one row read per point and DIRECT offset.

- `accumulate_ndt_terms` is the per-offset body that the hash-table pass
  (kernel 4) shares; its plain form is here.
- `ndt_derivatives_soa` is kernel K6L (`csrc/ndt_lut.cu`) on CUDA tensors
  and `ndt_derivatives_soa_ref` on CPU tensors.
- `ndt_align_soa` is the Newton loop (`ops/ndt._newton_loop`, K7) over it
  (`soa_pass`: K6L gated on the loop's state), with the reference's
  optional coarse phase as a second run on the same state; the host DLO
  and the fused odometry's `table="lut"` align with it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.kernels._build import F32, I32, PTR, Kernel, check_cuda, check_dtype, ptr
from lv_slam_tpu_torch.ops.ndt import (
    BLOCK, N_TERMS, DerivativePass, GaussParams, NDTResult, NewtonState, _newton_loop, check_offsets, finish_counter,
    make_gauss_params,
)
from lv_slam_tpu_torch.ops.voxel_map import VoxelMap, neighborhood_offsets, probe_cells

KERNEL = Kernel(
    "ndt_derivatives_soa",
    source="lv_slam_tpu_torch/csrc/ndt_lut.cu",
    replaces="lv_slam_tpu/ops/ndt_soa.py:134",
    entries={
        "lvs_ndt_lut_derivatives": [
            PTR, PTR, PTR, F32, I32, PTR, I32, PTR, PTR, F32, F32, PTR, I32, I32, PTR, I32, PTR, PTR,
        ],
        "lvs_ndt_lut_partials": [PTR, PTR, PTR, F32, I32, PTR, I32, PTR, PTR, PTR, F32, F32, PTR, I32, I32, PTR, I32],
    },
)


class VoxelMapSOA(NamedTuple):
    packed: torch.Tensor       # (L, 16): mu0..2, c00, c01, c02, c11, c12, c22, w, pad
    lut: torch.Tensor          # (E^3,) int32
    origin_cell: torch.Tensor  # (3,) int32
    resolution: float
    extent: int


def to_soa(vmap_: VoxelMap, lut: torch.Tensor) -> VoxelMapSOA:
    """Pack the map's leaves into the reference's (L, 16) rows (layout glue)."""
    c = vmap_.icovs
    packed = torch.cat(
        [
            vmap_.means,                                  # 0:3
            c[:, 0, 0:1], c[:, 0, 1:2], c[:, 0, 2:3],     # 3,4,5
            c[:, 1, 1:2], c[:, 1, 2:3], c[:, 2, 2:3],     # 6,7,8
            vmap_.weights[:, None],                       # 9
            c.new_zeros((vmap_.leaf_cap, 6)),
        ],
        dim=1,
    )
    return VoxelMapSOA(packed, lut, vmap_.origin_cell, vmap_.resolution, vmap_.extent)


def accumulate_ndt_terms(
    y: torch.Tensor,      # (3,N) transformed points
    row: torch.Tensor,    # (N,16) packed leaf attributes
    hit: torch.Tensor,    # (N,) leaf-hit mask
    gauss: GaussParams,
    weighted: bool,
    col0: int = 0,        # column of mu0 within the row (hash rows embed a key)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One neighborhood offset's (score, grad (6,), hess (6,6)) contribution;
    the plain version of kernel 4's per-point body (`csrc/ndt_hash.cu`).

    The Hessian is NOT symmetric (the T2 curvature block `y q^T - (q.y) I`
    is not), so all 36 entries are summed."""
    mu = row[:, col0:col0 + 3].T
    c00, c01, c02 = row[:, col0 + 3], row[:, col0 + 4], row[:, col0 + 5]
    c11, c12, c22 = row[:, col0 + 6], row[:, col0 + 7], row[:, col0 + 8]
    w_leaf = row[:, col0 + 9]

    d0, d1, d2_ = y[0] - mu[0], y[1] - mu[1], y[2] - mu[2]
    q0 = c00 * d0 + c01 * d1 + c02 * d2_
    q1 = c01 * d0 + c11 * d1 + c12 * d2_
    q2 = c02 * d0 + c12 * d1 + c22 * d2_
    md = d0 * q0 + d1 * q1 + d2_ * q2
    eterm = torch.exp(-0.5 * gauss.d2 * md)
    gate_val = gauss.d2 * eterm
    gate = hit & (gate_val <= 1.0) & (gate_val >= 0.0) & torch.isfinite(gate_val)
    w = torch.where(gate, w_leaf if weighted else 1.0, 0.0)

    score = torch.sum(w * (-gauss.d1 * eterm))
    f = w * (gauss.d1 * gauss.d2 * eterm)

    g3 = y[1] * q2 - y[2] * q1
    g4 = y[2] * q0 - y[0] * q2
    g5 = y[0] * q1 - y[1] * q0
    g6 = torch.stack([q0, q1, q2, g3, g4, g5])                # (6,N)

    grad = torch.einsum("n,in->i", f, g6)

    h1 = torch.einsum("n,in,jn->ij", -gauss.d2 * f, g6, g6)
    qy = q0 * y[0] + q1 * y[1] + q2 * y[2]
    q_st = torch.stack([q0, q1, q2])
    eye3 = torch.eye(3, dtype=y.dtype, device=y.device)
    t2 = torch.einsum("n,in,jn->ij", f, y, q_st) - torch.sum(f * qy) * eye3
    h2 = torch.zeros((6, 6), dtype=y.dtype, device=y.device)
    h2[3:, 3:] = t2

    # J^T C J = [[C, -CS], [SC, -SCS]] with S = skew(y), SC = -(CS)^T
    c = torch.stack([
        torch.stack([c00, c01, c02]),
        torch.stack([c01, c11, c12]),
        torch.stack([c02, c12, c22]),
    ])  # (3,3,N)
    cs = torch.stack([
        torch.stack([c[i, 1] * y[2] - c[i, 2] * y[1] for i in range(3)]),
        torch.stack([c[i, 2] * y[0] - c[i, 0] * y[2] for i in range(3)]),
        torch.stack([c[i, 0] * y[1] - c[i, 1] * y[0] for i in range(3)]),
    ], dim=1)   # cs[i,j] = (C S)_{ij}
    sc = -cs.transpose(0, 1)
    scs = torch.stack([
        torch.stack([sc[i, 1] * y[2] - sc[i, 2] * y[1] for i in range(3)]),
        torch.stack([sc[i, 2] * y[0] - sc[i, 0] * y[2] for i in range(3)]),
        torch.stack([sc[i, 0] * y[1] - sc[i, 1] * y[0] for i in range(3)]),
    ], dim=1)

    c_sum = torch.einsum("n,ijn->ij", f, c)
    cs_sum = torch.einsum("n,ijn->ij", f, cs)
    scs_sum = torch.einsum("n,ijn->ij", f, scs)
    h3 = torch.zeros((6, 6), dtype=y.dtype, device=y.device)
    h3[:3, :3] = c_sum
    h3[:3, 3:] = -cs_sum
    h3[3:, :3] = -cs_sum.T
    h3[3:, 3:] = -scs_sum

    return score, grad, h1 + h2 + h3




def _soa_args(soa: VoxelMapSOA, xs, mask, gauss: GaussParams, offsets, weighted: bool):
    """K6L's arguments before and after the transform, checked once (they
    do not change inside a Newton loop), and its block count."""
    n, k = xs.shape[1], offsets.shape[0]
    name = "ndt_derivatives_soa"
    check_cuda(name, soa.packed, soa.lut, soa.origin_cell, xs, mask, offsets)
    check_dtype(name, soa.packed, torch.float32, (soa.packed.shape[0], 16))
    check_dtype(name, soa.lut, torch.int32, (soa.extent ** 3,))
    check_dtype(name, soa.origin_cell, torch.int32, (3,))
    check_dtype(name, xs, torch.float32, (3, n))
    check_dtype(name, mask, torch.bool, (n,))
    check_dtype(name, offsets, torch.int32, (k, 3))
    check_offsets(name, offsets)
    head = (ptr(soa.packed), ptr(soa.lut), ptr(soa.origin_cell), float(np.float32(soa.resolution)), soa.extent,
            ptr(xs), n, ptr(mask))
    tail = (float(np.float32(gauss.d1)), float(np.float32(gauss.d2)), ptr(offsets), k, int(weighted))
    return head, tail, max(1, -(-n // BLOCK))


def ndt_derivatives_soa(
    soa: VoxelMapSOA,
    xs: torch.Tensor,          # (3, N)
    mask: torch.Tensor,        # (N,)
    transform: torch.Tensor,   # (4, 4)
    gauss: GaussParams,
    offsets: torch.Tensor,     # (K, 3) int32
    weighted: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused score / gradient / Hessian over every point and DIRECT offset,
    one LUT probe and one packed row per hit. Kernel K6L on CUDA (one
    launch: its last block sums the rows), the plain version on CPU."""
    if xs.device.type == "cpu":
        return ndt_derivatives_soa_ref(soa, xs, mask, transform, gauss, offsets, weighted)
    head, tail, n_blocks = _soa_args(soa, xs, mask, gauss, offsets, weighted)
    check_cuda("ndt_derivatives_soa", xs, transform)
    check_dtype("ndt_derivatives_soa", transform, torch.float32, (4, 4))
    partials = torch.empty((n_blocks, N_TERMS), dtype=torch.float32, device=xs.device)
    out = torch.empty((N_TERMS,), dtype=torch.float32, device=xs.device)
    KERNEL.call("lvs_ndt_lut_derivatives", *head, ptr(transform), *tail, ptr(partials), n_blocks,
                ptr(finish_counter(xs.device)), ptr(out))
    KERNEL.launches += 1
    return out[0], out[1:7], out[7:].view(6, 6)


def soa_pass(soa: VoxelMapSOA, xs, mask, gauss: GaussParams, offsets, weighted: bool) -> DerivativePass:
    """`ndt_derivatives_soa` as the Newton loop's pass: K6L's gated launch
    at the state's candidate on CUDA, the plain version on CPU."""

    def plain(transforms, active):
        return ndt_derivatives_soa_ref(soa, xs, mask, transforms[0], gauss, offsets, weighted)

    if xs.device.type == "cpu":
        return DerivativePass(plain, None, 0)
    head, tail, n_blocks = _soa_args(soa, xs, mask, gauss, offsets, weighted)

    def launch(state: NewtonState) -> None:
        KERNEL.call("lvs_ndt_lut_partials", *head, state.cand_ptr(), state.done_ptr(), *tail, ptr(state.partials),
                    n_blocks)
        KERNEL.launches += 1

    return DerivativePass(plain, launch, n_blocks)


def ndt_derivatives_soa_ref(soa, xs, mask, transform, gauss, offsets, weighted):
    """Plain PyTorch version of `ndt_derivatives_soa`: per offset, the LUT
    gather, the packed-row gather, then `accumulate_ndt_terms`. The points
    move as XLA compiles the reference's einsum on the CPU (the fma chain of
    `se3.transform_points_fma`, bit for bit), and as the kernel moves them,
    so all three put a point within an ulp of a cell face in one cell."""
    e = soa.extent
    y = se3.transform_points_fma(transform, xs.T).T
    coords = probe_cells(y.T, soa.origin_cell, soa.resolution).T       # (3,N) relative cells
    score = torch.zeros((), dtype=torch.float32, device=xs.device)
    grad = torch.zeros((6,), dtype=torch.float32, device=xs.device)
    hess = torch.zeros((6, 6), dtype=torch.float32, device=xs.device)
    for ki in range(offsets.shape[0]):
        rel = coords + offsets[ki][:, None]
        in_extent = torch.all((rel >= 0) & (rel < e), dim=0)
        flat = (rel[0] * e + rel[1]) * e + rel[2]
        leaf = soa.lut[torch.where(in_extent, flat, 0).to(torch.int64)]
        hit = in_extent & (leaf >= 0) & mask
        row = soa.packed[torch.where(hit, leaf, 0).to(torch.int64)]
        s, g, h = accumulate_ndt_terms(y, row, hit, gauss, weighted)
        score, grad, hess = score + s, grad + g, hess + h
    return score, grad, hess


def ndt_align_soa(vmap_: VoxelMap, lut: torch.Tensor, source: PointCloud, guess: torch.Tensor,
                  **kwargs) -> NDTResult:
    """`ndt_align_soa_table` on the map's freshly packed rows."""
    return ndt_align_soa_table(to_soa(vmap_, lut), source, guess, **kwargs)


def ndt_align_soa_table(
    soa: VoxelMapSOA,
    source: PointCloud,
    guess: torch.Tensor,
    *,
    resolution: float,
    outlier_ratio: float = 0.55,
    step_size: float = 0.1,
    transformation_epsilon: float = 0.01,
    max_iterations: int = 35,
    neighborhood: str = "DIRECT1",
    weighted: bool = False,
    coarse_subsample: int = 1,
) -> NDTResult:
    """Align `source` against packed rows. `coarse_subsample > 1` first runs
    Newton on every k-th lane at 2x eps, then polishes on all lanes."""
    gauss = make_gauss_params(resolution, outlier_ratio)
    offsets = neighborhood_offsets(neighborhood, guess.device)
    xs = source.masked_xyz().T.contiguous()
    mask = source.mask.contiguous()
    eps = np.float32(transformation_epsilon)
    state = NewtonState(guess[None])
    coarse_iters = None
    if coarse_subsample > 1:
        # lane i*k of the mask is the reference's `mask & (i % k == 0)` slice
        xs_c = xs[:, ::coarse_subsample].contiguous()
        mask_c = mask[::coarse_subsample].contiguous()
        _newton_loop(soa_pass(soa, xs_c, mask_c, gauss, offsets, weighted), state, eps * np.float32(2.0), step_size,
                     max_iterations)
        coarse_iters = state.iterations[0].clone()
        state.restart()
    _newton_loop(soa_pass(soa, xs, mask, gauss, offsets, weighted), state, eps, step_size, max_iterations)
    return state.result(mask, coarse_iters)
