"""NDT: the mixture constants, the result type, the damped Newton loop (K7)
and the generic derivative pass over the dense LUT with its align (port of
`lv_slam_tpu.ops.ndt`, and of the Newton loop of `lv_slam_tpu.ops.ndt_soa`).

`ndt_derivatives` is kernel K6G (`csrc/ndt_lut.cu`) on CUDA tensors and
`ndt_derivatives_ref` on CPU tensors: the reference's generic formulas over
`lookup_leaves`, the full 3x3 inverse covariance of each leaf. The host DLO
scores its retry with it, and `ndt_align` (the generic align, with
`dof_mask`) runs the Newton loop over it.

The Newton loop (`_newton_loop`, the reference's `lax.while_loop`) keeps its
state on the lanes' device (`NewtonState`: one row per align, or per loop
candidate) and runs each iteration as a derivative pass and one step. On
CUDA tensors both are kernels gated on the state's `done` flag (the pass
reads its transform from the state; `newton_step` is K7, `csrc/newton.cu`),
launched in groups of `NEWTON_GROUP` iterations with one host read of
`done` after each group: a launch after done is a no-op, so the result does
not depend on the group. On CPU tensors the same loop runs the plain twins
(`newton_step_ref`, today's operations with `torch.linalg.solve_ex`), which
skip the passes of finished lanes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

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
            PTR, PTR, PTR, PTR, PTR, F32, I32, PTR, I32, PTR, PTR, F32, F32, PTR, I32, I32, PTR, I32, PTR, PTR,
        ],
        "lvs_ndt_generic_partials": [
            PTR, PTR, PTR, PTR, PTR, F32, I32, PTR, I32, PTR, PTR, PTR, F32, F32, PTR, I32, I32, PTR, I32,
        ],
    },
)
NEWTON_KERNEL = Kernel(
    "newton_step",
    source="lv_slam_tpu_torch/csrc/newton.cu",
    replaces="lv_slam_tpu/ops/ndt_soa.py:167",
    entries={
        "lvs_newton_step": [PTR, I32, PTR, PTR, I32, F32, F32, F32, I32, I32],
    },
)
# the lanes' summed derivative rows before the step, for the sharded align's
# all-reduce: the per-shard sum ahead of the reference's `psum`
NEWTON_SUMS_KERNEL = Kernel(
    "newton_sums",
    source="lv_slam_tpu_torch/csrc/newton.cu",
    replaces="lv_slam_tpu/parallel/mesh.py:118",
    entries={"lvs_newton_sums": [PTR, I32, PTR, I32, PTR]},
)

# iterations launched between two host reads of the loop's `done` flag. The
# flagship runs stop after ~1 iteration per phase (`chip_smoke.py` on an
# H100: 2.22 per scan over the coarse and fine phases of the fused odometry,
# 191 in 171 host-DLO aligns), i.e. 2 launches of the pass and the step
# with the first: one read per phase, and no launch after done
NEWTON_GROUP = 2

# the state row of a lane (csrc/newton.cu): floats ...
F_WIDTH, F_T, F_SCORE, F_GRAD, F_HESS, F_CAND, F_CAP, F_ALPHA = 80, 0, 16, 17, 23, 59, 75, 76
# ... and ints
S_WIDTH, S_DONE, S_IT, S_STARTED, S_BAD = 4, 0, 1, 2, 3


# offsets a LUT pass takes (csrc/ndt_lut.cu kMaxOffsets): DIRECT26's 27 cells
MAX_OFFSETS = 27

_FINISH_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def finish_counter(device: torch.device) -> torch.Tensor:
    """The device counter of the one-launch reductions (the standalone LUT
    passes, K6L and K6G; GICP's normal equations, K19b) on the current
    stream of `device`: one int32 that is 0 between calls. A call's blocks
    count themselves on it, and the last one, having summed the rows, sets it
    back to 0, so a call needs no launch to clear it; a stream has its own,
    so calls on two streams never share one. Made (zeroed) at first use."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    counter = _FINISH_COUNTERS.get(key)
    if counter is None:
        counter = _FINISH_COUNTERS[key] = torch.zeros((1,), dtype=torch.int32, device=device)
    return counter


def check_offsets(name: str, offsets: torch.Tensor) -> None:
    if not 1 <= offsets.shape[0] <= MAX_OFFSETS:
        raise ValueError(f"{name}: {offsets.shape[0]} offsets; the LUT pass takes 1 to {MAX_OFFSETS}")


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
    iterations: torch.Tensor         # () int32 Newton iterations, coarse phase included
    converged: torch.Tensor          # () bool
    hessian: torch.Tensor            # (6,6) at the final pose
    trans_probability: torch.Tensor  # () score / n_points


def _generic_args(vmap_: VoxelMap, lut, src_xyz, src_mask, gauss: GaussParams, offsets, weighted: bool):
    """K6G's arguments before and after the transform, checked once (they
    do not change inside a Newton loop), and its block count."""
    n, k, leaf_cap = src_xyz.shape[0], offsets.shape[0], vmap_.leaf_cap
    name = "ndt_derivatives"
    check_cuda(name, vmap_.means, vmap_.icovs, vmap_.weights, lut, vmap_.origin_cell, src_xyz, src_mask, offsets)
    check_dtype(name, vmap_.means, torch.float32, (leaf_cap, 3))
    check_dtype(name, vmap_.icovs, torch.float32, (leaf_cap, 3, 3))
    check_dtype(name, vmap_.weights, torch.float32, (leaf_cap,))
    check_dtype(name, lut, torch.int32, (vmap_.extent ** 3,))
    check_dtype(name, vmap_.origin_cell, torch.int32, (3,))
    check_dtype(name, src_xyz, torch.float32, (n, 3))
    check_dtype(name, src_mask, torch.bool, (n,))
    check_dtype(name, offsets, torch.int32, (k, 3))
    check_offsets(name, offsets)
    head = (ptr(vmap_.means), ptr(vmap_.icovs), ptr(vmap_.weights), ptr(lut), ptr(vmap_.origin_cell),
            float(np.float32(vmap_.resolution)), vmap_.extent, ptr(src_xyz), n, ptr(src_mask))
    tail = (float(np.float32(gauss.d1)), float(np.float32(gauss.d2)), ptr(offsets), k, int(weighted))
    return head, tail, max(1, -(-n // BLOCK))


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
    by the generic formulas. Kernel K6G on CUDA (one launch: its last block
    sums the rows), the plain version on CPU."""
    if src_xyz.device.type == "cpu":
        return ndt_derivatives_ref(vmap_, lut, src_xyz, src_mask, transform, gauss, offsets, weighted)
    head, tail, n_blocks = _generic_args(vmap_, lut, src_xyz, src_mask, gauss, offsets, weighted)
    check_cuda("ndt_derivatives", src_xyz, transform)
    check_dtype("ndt_derivatives", transform, torch.float32, (4, 4))
    partials = torch.empty((n_blocks, N_TERMS), dtype=torch.float32, device=src_xyz.device)
    out = torch.empty((N_TERMS,), dtype=torch.float32, device=src_xyz.device)
    KERNEL.call("lvs_ndt_generic_derivatives", *head, ptr(transform), *tail, ptr(partials), n_blocks,
                ptr(finish_counter(src_xyz.device)), ptr(out))
    KERNEL.launches += 1
    return out[0], out[1:7], out[7:].view(6, 6)


def generic_pass(vmap_: VoxelMap, lut, src_xyz, src_mask, gauss: GaussParams, offsets, weighted: bool
                 ) -> "DerivativePass":
    """`ndt_derivatives` as the Newton loop's pass: K6G's gated launch at
    the state's candidate on CUDA, the plain version on CPU."""

    def plain(transforms, active):
        return ndt_derivatives_ref(vmap_, lut, src_xyz, src_mask, transforms[0], gauss, offsets, weighted)

    if src_xyz.device.type == "cpu":
        return DerivativePass(plain, None, 0)
    head, tail, n_blocks = _generic_args(vmap_, lut, src_xyz, src_mask, gauss, offsets, weighted)

    def launch(state: "NewtonState") -> None:
        KERNEL.call("lvs_ndt_generic_partials", *head, state.cand_ptr(), state.done_ptr(), *tail,
                    ptr(state.partials), n_blocks)
        KERNEL.launches += 1

    return DerivativePass(plain, launch, n_blocks)


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
    src_xyz = source.masked_xyz().contiguous()
    src_mask = source.mask.contiguous()
    pass_ = generic_pass(vmap_, lut, src_xyz, src_mask, gauss, offsets, weighted)
    state = NewtonState(guess[None])
    _newton_loop(pass_, state, transformation_epsilon, step_size, max_iterations, dof_mask=dof_mask)
    return state.result(src_mask)


class DerivativePass(NamedTuple):
    """One derivative pass bound to its map and points, checked once:
    `plain(transforms (k, 4, 4), active)` the twin's (score, grad, hess) of
    the lanes `active` marks (a host list; other rows are zeros), and on
    CUDA `launch(state)` the kernel's gated pass at the state's candidates
    into `state.partials`, `n_blocks` partial rows per lane."""

    plain: Callable
    launch: Optional[Callable]
    n_blocks: int


class LoopParams(NamedTuple):
    """The loop's constants, rounded through float32 as the reference's."""

    eps: float
    step_min: float
    step_max: float
    max_iterations: int
    dof: Optional[torch.Tensor]  # (6,) 0/1 float mask, frozen dims 0 (the twin's)
    dof_bits: int                # the same mask as bits, -1 for none (the kernel's)


@functools.lru_cache(maxsize=None)
def _dof_tensor(dof_mask: Tuple[bool, ...], device: str) -> torch.Tensor:
    """The mask as a float tensor, made once per device: a host-to-device
    copy each align would wait for the stream."""
    return torch.tensor(dof_mask, dtype=torch.float32).to(device)


def loop_params(eps, step_max, max_iterations: int, dof_mask=None, device="cpu") -> LoopParams:
    eps32 = np.float32(eps)
    dof = None if dof_mask is None else _dof_tensor(tuple(dof_mask), str(torch.device(device)))
    bits = -1 if dof_mask is None else sum(1 << i for i, free in enumerate(dof_mask) if free)
    return LoopParams(float(eps32), float(eps32 / np.float32(2.0)), float(np.float32(step_max)), int(max_iterations),
                      dof, bits)


class NewtonState:
    """The Newton loop's state of k lanes on their device: `f` (k, 80)
    float32 rows [transform (16), score, grad (6), hess (36), candidate
    (16), cap, alpha, pad] and `s` (k, 4) int32 rows [done, it, started,
    bad]; `partials` the derivative pass's rows. `batched`: the lanes are
    K13's loop candidates (the twin then runs the reference's vmapped
    loop's operations)."""

    def __init__(self, guesses: torch.Tensor, batched: bool = False):
        k = guesses.shape[0]
        self.k, self.batched = k, batched
        self.f = torch.zeros((k, F_WIDTH), dtype=torch.float32, device=guesses.device)
        self.f[:, F_T:F_T + 16] = guesses.reshape(k, 16)
        self.f[:, F_CAND:F_CAND + 16] = guesses.reshape(k, 16)
        self.s = torch.zeros((k, S_WIDTH), dtype=torch.int32, device=guesses.device)
        self.partials: Optional[torch.Tensor] = None
        self.sums: Optional[torch.Tensor] = None  # (k, 43) reduced rows of a sharded loop

    def clone(self) -> "NewtonState":
        """A copy with its own state rows (the partial rows shared)."""
        out = NewtonState.__new__(NewtonState)
        out.__dict__.update(self.__dict__)
        out.f, out.s = self.f.clone(), self.s.clone()
        return out

    def restart(self) -> None:
        """A second run from the first's result (the fine phase after the
        coarse one): its iteration count starts again from 0."""
        self.f[:, F_CAND:F_CAND + 16] = self.f[:, F_T:F_T + 16]
        self.s.zero_()

    def cand_ptr(self):
        return ctypes.c_void_p(self.f.data_ptr() + 4 * F_CAND)

    def done_ptr(self):
        return ctypes.c_void_p(self.s.data_ptr() + 4 * S_DONE)

    def all_done(self) -> bool:
        """The loop's one host read (per group of iterations on CUDA)."""
        return bool(torch.all(self.s[:, S_DONE] != 0))

    @property
    def transforms(self) -> torch.Tensor:
        return self.f[:, F_T:F_T + 16].reshape(self.k, 4, 4)

    @property
    def scores(self) -> torch.Tensor:
        return self.f[:, F_SCORE]

    @property
    def iterations(self) -> torch.Tensor:
        return self.s[:, S_IT]

    def result(self, mask: torch.Tensor, coarse_iterations: Optional[torch.Tensor] = None) -> NDTResult:
        """Lane 0 as an `NDTResult`, left on the device."""
        it = self.s[0, S_IT] if coarse_iterations is None else self.s[0, S_IT] + coarse_iterations
        score = self.f[0, F_SCORE]
        n_pts = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
        return NDTResult(
            transform=self.f[0, F_T:F_T + 16].view(4, 4), score=score, iterations=it,
            converged=self.s[0, S_DONE] != 0, hessian=self.f[0, F_HESS:F_HESS + 36].view(6, 6),
            trans_probability=score / n_pts,
        )


def _newton_loop(pass_: DerivativePass, state: NewtonState, eps, step_max, max_iterations: int,
                 dof_mask=None, read: bool = True, reduce: Optional[Callable] = None) -> NewtonState:
    """Monotone-guarded damped-Newton ascent on the NDT score from the
    state's candidates (the reference's `ndt_soa._newton_loop`, vmapped over
    the lanes; and `ndt_align`'s loop with `dof_mask`, whose frozen dims'
    rows and columns of the normal equations are zeroed and their diagonal
    pinned).

    An iteration is one pass at the candidates and one step; the first
    takes the guess's derivatives, and a NaN start stops there. A lane stops
    after at most `max_iterations + 1` steps, so `max_iterations + 2`
    iterations finish every lane. On CUDA they are launched in groups of
    `NEWTON_GROUP` with one read of `done` after each group but the last
    (`read=False`: no read at all, every iteration launched); on CPU the
    twins run, reading `done` freely and skipping finished lanes' passes.

    `reduce(t)`, when given, sums the lanes' (k, 43) derivative rows in
    place across the ranks that hold the lanes' other points (the sharded
    align's all-reduce, `parallel/mesh.py`) before each step. Every rank
    then takes the same step and reaches the same `done` flags, so all make
    the same collectives; a finished lane reduces zeros."""
    return _drive(pass_, state, eps, step_max, max_iterations, dof_mask, read, reduce)


def _newton_loop_plain(pass_: DerivativePass, state: NewtonState, eps, step_max, max_iterations: int,
                       dof_mask=None, read: bool = True) -> NewtonState:
    """`_newton_loop` with the twins on any device (the harness's plain path
    on the card; each iteration reads `done`)."""
    return _drive(pass_._replace(launch=None), state, eps, step_max, max_iterations, dof_mask, read)


def _drive(pass_: DerivativePass, state: NewtonState, eps, step_max, max_iterations: int, dof_mask,
           read: bool, reduce: Optional[Callable] = None) -> NewtonState:
    p = loop_params(eps, step_max, max_iterations, dof_mask, state.f.device)
    kernel = pass_.launch is not None
    if kernel:
        check_cuda("newton_step", state.f, state.s)
        rows = state.k * pass_.n_blocks * N_TERMS
        if state.partials is None or state.partials.numel() < rows:
            state.partials = torch.empty((rows,), dtype=torch.float32, device=state.f.device)
    bound = max_iterations + 2
    launched = 0
    while launched < bound:
        for _ in range(min(NEWTON_GROUP, bound - launched)):
            if kernel:
                pass_.launch(state)
                if reduce is None:
                    newton_step(state, pass_.n_blocks, p)
                else:  # the lanes' sums, reduced over the ranks, as a pass of one block
                    sums = newton_sums(state, pass_.n_blocks)
                    reduce(sums)
                    newton_step(state, 1, p, sums)
            else:
                _twin_iteration(pass_, state, p, reduce)
            launched += 1
        if launched < bound and (read or not kernel) and state.all_done():
            break
    return state


def newton_step(state: NewtonState, n_blocks: int, p: LoopParams, partials: Optional[torch.Tensor] = None) -> None:
    """K7: one gated Newton step of every lane from the pass's partial rows
    (or from `partials`, n_blocks rows per lane)."""
    rows = state.partials if partials is None else partials
    NEWTON_KERNEL.call("lvs_newton_step", ptr(rows), n_blocks, ptr(state.f), ptr(state.s), state.k, p.eps,
                       p.step_min, p.step_max, p.max_iterations, p.dof_bits)
    NEWTON_KERNEL.launches += 1


def newton_sums(state: NewtonState, n_blocks: int) -> torch.Tensor:
    """Each lane's 43 derivative sums (k, 43) from the pass's partial rows
    (n_blocks per lane), summed block by block in `newton_step`'s order,
    zeros for a finished lane; kept in `state.sums`. The plain version for
    a state on the CPU."""
    if state.f.device.type == "cpu":
        return newton_sums_ref(state, n_blocks)
    check_cuda("newton_sums", state.partials, state.s)
    if state.partials.numel() < state.k * n_blocks * N_TERMS:
        raise ValueError(f"newton_sums: {state.partials.numel()} partial floats for {state.k} lanes x {n_blocks} "
                         f"blocks")
    if state.sums is None:
        state.sums = torch.empty((state.k, N_TERMS), dtype=torch.float32, device=state.f.device)
    NEWTON_SUMS_KERNEL.call("lvs_newton_sums", ptr(state.partials), n_blocks, ptr(state.s), state.k, ptr(state.sums))
    NEWTON_SUMS_KERNEL.launches += 1
    return state.sums


def newton_sums_ref(state: NewtonState, n_blocks: int) -> torch.Tensor:
    """Plain PyTorch version of `newton_sums`: float32 adds from zero, one
    block after another, as `csrc/common.cuh column_sum` runs them."""
    rows = state.partials[:state.k * n_blocks * N_TERMS].view(state.k, n_blocks, N_TERMS)
    sums = torch.zeros((state.k, N_TERMS), dtype=torch.float32, device=rows.device)
    for b in range(n_blocks):
        sums = sums + rows[:, b]
    return torch.where((state.s[:, S_DONE] != 0)[:, None], 0.0, sums)


def _twin_iteration(pass_: DerivativePass, state: NewtonState, p: LoopParams,
                    reduce: Optional[Callable] = None) -> None:
    """One iteration with the plain twins: the pass for the running lanes
    (none once all are done), its rows reduced when `reduce` is given, then
    `newton_step_ref`."""
    active = (state.s[:, S_DONE] == 0).tolist()
    if not any(active):
        return
    cands = state.f[:, F_CAND:F_CAND + 16].reshape(state.k, 4, 4).clone()
    score, grad, hess = pass_.plain(cands, active)
    if reduce is not None:
        k = score.numel()
        terms = torch.cat([score.reshape(k, 1), grad.reshape(k, 6), hess.reshape(k, 36)], dim=1)
        reduce(terms)
        score, grad, hess = terms[:, 0].reshape(score.shape), terms[:, 1:7].reshape(grad.shape), \
            terms[:, 7:].reshape(hess.shape)
    newton_step_ref(state, score, grad, hess, p)


def newton_step_ref(state: NewtonState, score, grad, hess, p: LoopParams) -> None:
    """Plain PyTorch version of `newton_step`: the derivatives at the
    candidates ((k,), (k, 6), (k, 6, 6), or unbatched for one lane) taken
    in, then the reference's accept test and next proposal, with today's
    operations (`torch.linalg.solve_ex` for the 6x6 solve). The state is
    read into fresh tensors and written back in place."""
    if state.batched:
        _step_batched(state, score, grad, hess, p)
    else:
        _step_single(state, score.reshape(()), grad.reshape(6), hess.reshape(6, 6), p)


def _step_single(state: NewtonState, new_score, new_grad, new_hess, p: LoopParams) -> None:
    f, s = state.f[0], state.s[0]
    if not bool(s[S_STARTED]):
        f[F_SCORE] = new_score
        f[F_GRAD:F_GRAD + 6] = new_grad
        f[F_HESS:F_HESS + 36] = new_hess.reshape(36)
        f[F_CAP] = p.step_max
        s[S_STARTED] = 1
        done = bool(torch.isnan(new_score))
    else:
        score = f[F_SCORE].clone()
        bad = s[S_BAD] != 0
        alpha = f[F_ALPHA].clone()
        cap = f[F_CAP].clone()
        accept = ~bad & (new_score >= score)
        f[F_T:F_T + 16] = torch.where(accept, f[F_CAND:F_CAND + 16], f[F_T:F_T + 16])
        f[F_SCORE] = torch.where(accept, new_score, score)
        f[F_GRAD:F_GRAD + 6] = torch.where(accept, new_grad, f[F_GRAD:F_GRAD + 6])
        f[F_HESS:F_HESS + 36] = torch.where(accept, new_hess.reshape(36), f[F_HESS:F_HESS + 36])
        f[F_CAP] = torch.where(accept, p.step_max, torch.clamp(cap * 0.5, min=p.step_min))
        s[S_IT] += 1
        shrunk_out = ~accept & (alpha <= p.step_min)
        stop = bad | (accept & (alpha < p.eps)) | shrunk_out
        done = int(s[S_IT]) > p.max_iterations or bool(stop)
    s[S_DONE] = int(done)
    if done:
        return
    # the next candidate: the top of the reference's loop body
    transform = f[F_T:F_T + 16].view(4, 4).clone()
    grad = f[F_GRAD:F_GRAD + 6].clone()
    hess = f[F_HESS:F_HESS + 36].view(6, 6).clone()
    cap = f[F_CAP].clone()
    eye6 = torch.eye(6, dtype=hess.dtype, device=hess.device)
    ridge = 1e-6 * torch.trace(torch.abs(hess)) / 6.0 + 1e-12
    if p.dof is not None:
        grad = grad * p.dof
        hess = hess * p.dof[:, None] * p.dof[None, :] - (1.0 - p.dof) * eye6
        f[F_GRAD:F_GRAD + 6] = grad
        f[F_HESS:F_HESS + 36] = hess.reshape(36)
    delta, info = torch.linalg.solve_ex(hess + ridge * eye6, -grad)
    norm = torch.sqrt(torch.sum(delta * delta))
    bad = (norm == 0.0) | ~torch.isfinite(norm) | (info != 0)
    direction = delta / torch.where(bad, 1.0, norm)
    dphi0 = -torch.dot(grad, direction)
    direction = torch.where(dphi0 > 0, -direction, direction)
    alpha = torch.minimum(torch.clamp(norm, min=p.step_min), cap)
    f[F_CAND:F_CAND + 16] = (se3.exp_se3(alpha * direction) @ transform).reshape(16)
    f[F_ALPHA] = alpha
    s[S_BAD] = bad.to(torch.int32)


def _step_batched(state: NewtonState, new_score, new_grad, new_hess, p: LoopParams) -> None:
    """The vmapped loop's step over every lane: a finished lane keeps its
    state (`run` masks every update), and the next candidates are proposed
    for all lanes while any runs."""
    f, s, k = state.f, state.s, state.k
    if not bool(s[0, S_STARTED]):
        f[:, F_SCORE] = new_score
        f[:, F_GRAD:F_GRAD + 6] = new_grad
        f[:, F_HESS:F_HESS + 36] = new_hess.reshape(k, 36)
        f[:, F_CAP] = p.step_max
        s[:, S_STARTED] = 1
        s[:, S_DONE] = torch.isnan(new_score).to(torch.int32)
    else:
        done = s[:, S_DONE] != 0
        run = ~done
        score = f[:, F_SCORE].clone()
        bad = s[:, S_BAD] != 0
        alpha = f[:, F_ALPHA].clone()
        cap = f[:, F_CAP].clone()
        it = s[:, S_IT].to(torch.int64)
        accept = ~bad & (new_score >= score)
        take = run & accept
        f[:, F_T:F_T + 16] = torch.where(take[:, None], f[:, F_CAND:F_CAND + 16], f[:, F_T:F_T + 16])
        f[:, F_SCORE] = torch.where(take, new_score, score)
        f[:, F_GRAD:F_GRAD + 6] = torch.where(take[:, None], new_grad, f[:, F_GRAD:F_GRAD + 6])
        f[:, F_HESS:F_HESS + 36] = torch.where(take[:, None], new_hess.reshape(k, 36), f[:, F_HESS:F_HESS + 36])
        f[:, F_CAP] = torch.where(run, torch.where(accept, p.step_max, torch.clamp(cap * 0.5, min=p.step_min)), cap)
        it = it + run.to(torch.int64)
        s[:, S_IT] = it.to(torch.int32)
        shrunk_out = ~accept & (alpha <= p.step_min)
        stop = bad | (it > p.max_iterations) | (accept & (alpha < p.eps)) | shrunk_out
        s[:, S_DONE] = (done | (run & stop)).to(torch.int32)
    if bool(torch.all(s[:, S_DONE] != 0)):
        return
    transform = f[:, F_T:F_T + 16].reshape(k, 4, 4).clone()
    grad = f[:, F_GRAD:F_GRAD + 6].clone()
    hess = f[:, F_HESS:F_HESS + 36].reshape(k, 6, 6).clone()
    cap = f[:, F_CAP].clone()
    eye6 = torch.eye(6, dtype=hess.dtype, device=hess.device)
    ridge = 1e-6 * torch.abs(hess).diagonal(dim1=-2, dim2=-1).sum(-1) / 6.0 + 1e-12
    delta, info = torch.linalg.solve_ex(hess + ridge[:, None, None] * eye6, -grad)
    norm = torch.sqrt(torch.sum(delta * delta, dim=-1))
    bad = (norm == 0.0) | ~torch.isfinite(norm) | (info != 0)
    direction = delta / torch.where(bad, 1.0, norm)[:, None]
    dphi0 = -torch.sum(grad * direction, dim=-1)
    direction = torch.where((dphi0 > 0)[:, None], -direction, direction)
    alpha = torch.minimum(torch.clamp(norm, min=p.step_min), cap)
    f[:, F_CAND:F_CAND + 16] = (se3.exp_se3(alpha[:, None] * direction) @ transform).reshape(k, 16)
    f[:, F_ALPHA] = alpha
    s[:, S_BAD] = bad.to(torch.int32)
