"""NDT over the bucket-pair hash table (port of `lv_slam_tpu.ops.ndt_hash`).

Leaves are re-hashed into B buckets x 2 slots; each 16-float slot embeds its
voxel key (int32 bits in column 0) ahead of the mean / inverse covariance /
weight payload, so one 128-byte row read fetches both probe slots and the key
compare resolves in registers.

- `to_hash` is kernel 3 (`csrc/ndt_hash.cu`) on CUDA tensors and
  `to_hash_ref` on CPU tensors. It is deterministic: bit-exact parity.
- `ndt_derivatives_hash` is kernel 4 (same file) on CUDA tensors and
  `ndt_derivatives_hash_ref` (over `accumulate_ndt_terms`) on CPU tensors.
- `ndt_derivatives_hash_batched` is the same pass for k candidates in one
  launch (kernel 13's derivative pass, the reference's vmap over loop
  candidates), and `ndt_align_hash_table_batched` the vmapped align.
- `hash_pass` is either pass inside the Newton loop (K7, `ops/ndt.py`):
  each lane's transform read from the loop's state, gated on its `done`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
from lv_slam_tpu_torch.kernels._build import F32, I32, PTR, Kernel, check_cuda, check_dtype, ptr
from lv_slam_tpu_torch.ops.ndt import (
    BLOCK, F_WIDTH, N_TERMS, S_WIDTH, DerivativePass, GaussParams, NDTResult, NewtonState, _newton_loop,
    make_gauss_params,
)
from lv_slam_tpu_torch.ops.ndt_soa import accumulate_ndt_terms
from lv_slam_tpu_torch.ops.cells import cell_coords, inv_resolution
from lv_slam_tpu_torch.ops.voxel_map import VoxelMap, neighborhood_offsets

_FIB = 2654435769  # 2^32 / golden ratio (Fibonacci hashing)
_EMPTY_KEY = -1

TO_HASH_KERNEL = Kernel(
    "to_hash",
    source="lv_slam_tpu_torch/csrc/ndt_hash.cu",
    replaces="lv_slam_tpu/ops/ndt_hash.py:53",
    entries={
        "lvs_to_hash": [PTR, PTR, PTR, PTR, PTR, F32, I32, I32, I32, PTR, PTR, PTR],
    },
)
# the Newton loop's gated pass (one candidate for kernel 4, k for kernel 13)
_PARTIALS_ARGS = [PTR, I32, PTR, F32, I32, PTR, I32, PTR, PTR, I32, PTR, I32, I32, F32, F32, PTR, I32, I32, PTR, I32]
DERIVATIVES_KERNEL = Kernel(
    "ndt_derivatives_hash",
    source="lv_slam_tpu_torch/csrc/ndt_hash.cu",
    replaces="lv_slam_tpu/ops/ndt_hash.py:132",
    entries={
        "lvs_ndt_hash_derivatives": [
            PTR, I32, PTR, F32, I32, PTR, I32, PTR, PTR, F32, F32, PTR, I32, I32, PTR, I32, PTR,
        ],
        "lvs_ndt_hash_partials": _PARTIALS_ARGS,
    },
)

BATCHED_KERNEL = Kernel(
    "_fused_verify_fn",
    source="lv_slam_tpu_torch/csrc/ndt_hash.cu",
    replaces="lv_slam_tpu/graph/loop_detector.py:69",
    entries={
        "lvs_ndt_hash_derivatives_batched": [
            PTR, I32, PTR, F32, I32, PTR, I32, PTR, PTR, I32, F32, F32, PTR, I32, I32, PTR, I32, PTR,
        ],
        "lvs_ndt_hash_partials": _PARTIALS_ARGS,
    },
)


class HashVoxelMap(NamedTuple):
    table: torch.Tensor        # (B, 32): two 16-wide slots [key, mu(3), icov6, w, pad(5)]
    origin_cell: torch.Tensor  # (3,) int32
    resolution: float
    extent: int                # key space = extent^3 (the map's flat key)
    n_dropped: torch.Tensor    # () int32 leaves lost to bucket overflow


def _hash(key: torch.Tensor, b_bits: int) -> torch.Tensor:
    """`(uint32(key) * 2654435769) >> (32 - b_bits)` as int64 bucket index.

    uint32 arithmetic in int64 without overflow: the low 32 bits of the
    product are assembled from the 16-bit halves of the constant."""
    u = key.to(torch.int64) & 0xFFFFFFFF
    lo = u * (_FIB & 0xFFFF)
    hi = ((u * (_FIB >> 16)) & 0xFFFF) << 16
    h = (lo + hi) & 0xFFFFFFFF
    return h >> (32 - b_bits)


def _n_buckets(leaf_cap: int, buckets_per_leaf: int) -> int:
    n_buckets = 1
    while n_buckets < buckets_per_leaf * leaf_cap:
        n_buckets *= 2
    return n_buckets


def _check_extent(e: int) -> None:
    # keys are embedded as float32 bits: valid keys must stay below the first
    # NaN pattern (0x7F800000), which the reference guards for the TPU
    if e**3 >= 0x7F800000:
        raise ValueError(
            f"lut_extent {e} gives key space {e**3} >= 0x7F800000: embedded "
            "keys would be NaN bit patterns; max extent 1288"
        )


def to_hash(vmap_: VoxelMap, buckets_per_leaf: int = 4) -> HashVoxelMap:
    """Re-index a built VoxelMap into the bucket-pair hash table. Kernel 3 on
    CUDA, the plain version on CPU."""
    if vmap_.means.device.type == "cpu":
        return to_hash_ref(vmap_, buckets_per_leaf)
    e = vmap_.extent
    _check_extent(e)
    leaf_cap = vmap_.leaf_cap
    n_buckets = _n_buckets(leaf_cap, buckets_per_leaf)
    b_bits = n_buckets.bit_length() - 1
    check_cuda("to_hash", vmap_.means, vmap_.icovs, vmap_.weights, vmap_.valid, vmap_.origin_cell)
    check_dtype("to_hash", vmap_.means, torch.float32, (leaf_cap, 3))
    check_dtype("to_hash", vmap_.icovs, torch.float32, (leaf_cap, 3, 3))
    check_dtype("to_hash", vmap_.weights, torch.float32, (leaf_cap,))
    check_dtype("to_hash", vmap_.valid, torch.bool, (leaf_cap,))
    check_dtype("to_hash", vmap_.origin_cell, torch.int32, (3,))
    dev = vmap_.means.device
    # each leaf's key, then the (slot 0, slot 1) leaf index of each bucket
    scratch = torch.empty(((leaf_cap + 1) // 2 * 2 + 2 * n_buckets,), dtype=torch.int32, device=dev)
    table = torch.empty((n_buckets, 32), dtype=torch.float32, device=dev)
    n_dropped = torch.empty((), dtype=torch.int32, device=dev)
    TO_HASH_KERNEL.call(
        "lvs_to_hash",
        ptr(vmap_.means), ptr(vmap_.icovs), ptr(vmap_.weights), ptr(vmap_.valid),
        ptr(vmap_.origin_cell), inv_resolution(vmap_.resolution), e, leaf_cap, b_bits,
        ptr(scratch), ptr(table), ptr(n_dropped),
    )
    TO_HASH_KERNEL.launches += 1
    return HashVoxelMap(table, vmap_.origin_cell, vmap_.resolution, e, n_dropped)


def to_hash_ref(vmap_: VoxelMap, buckets_per_leaf: int = 4) -> HashVoxelMap:
    """Plain PyTorch version of `to_hash`: slot 0 takes each bucket's lowest
    leaf index, slot 1 the lowest of the rest, further leaves are dropped."""
    e = vmap_.extent
    _check_extent(e)
    leaf_cap = vmap_.leaf_cap
    n_buckets = _n_buckets(leaf_cap, buckets_per_leaf)
    b_bits = n_buckets.bit_length() - 1
    dev = vmap_.means.device
    valid = vmap_.valid

    # each leaf's key from its mean (the centered-moment build keeps the
    # mean inside its cell)
    rel = cell_coords(vmap_.means, vmap_.resolution) - vmap_.origin_cell
    key = (rel[:, 0] * e + rel[:, 1]) * e + rel[:, 2]
    key = torch.where(valid, key, _EMPTY_KEY).to(torch.int32)
    h = _hash(key, b_bits)

    rows = torch.arange(leaf_cap, dtype=torch.int64, device=dev)
    sentinel = leaf_cap
    first = torch.full((n_buckets,), sentinel, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, torch.where(valid, h, 0), torch.where(valid, rows, sentinel), "amin")
    is_first = valid & (rows == first[h])
    loser = valid & ~is_first
    second = torch.full((n_buckets,), sentinel, dtype=torch.int64, device=dev)
    second.scatter_reduce_(0, torch.where(loser, h, 0), torch.where(loser, rows, sentinel), "amin")
    is_second = loser & (rows == second[h])
    n_dropped = torch.sum((loser & ~is_second).to(torch.int32))

    c = vmap_.icovs
    packed = torch.cat(
        [
            key.view(torch.float32)[:, None],          # 0: embedded key bits
            vmap_.means,                               # 1:4
            c[:, 0, 0:1], c[:, 0, 1:2], c[:, 0, 2:3],  # 4,5,6
            c[:, 1, 1:2], c[:, 1, 2:3], c[:, 2, 2:3],  # 7,8,9
            vmap_.weights[:, None],                    # 10
            torch.zeros((leaf_cap, 5), dtype=torch.float32, device=dev),
        ],
        dim=1,
    )
    empty_row = torch.zeros((16,), dtype=torch.float32, device=dev)
    empty_row[0:1] = torch.full((1,), _EMPTY_KEY, dtype=torch.int32, device=dev).view(torch.float32)
    slot0 = torch.where(
        (first < sentinel)[:, None], packed[torch.clamp(first, max=leaf_cap - 1)], empty_row
    )
    slot1 = torch.where(
        (second < sentinel)[:, None], packed[torch.clamp(second, max=leaf_cap - 1)], empty_row
    )
    return HashVoxelMap(
        table=torch.cat([slot0, slot1], dim=1),
        origin_cell=vmap_.origin_cell,
        resolution=vmap_.resolution,
        extent=e,
        n_dropped=n_dropped,
    )


def _hash_args(name: str, hmap: HashVoxelMap, xs, mask, gauss: GaussParams, offsets, weighted: bool):
    """Kernel 4's (and 13's) arguments before and after the transform for
    points xs (3, N) or (k, 3, N), checked once (they do not change inside a
    Newton loop), and the block count per candidate."""
    n = xs.shape[-1]
    n_off = offsets.shape[0]
    n_buckets = hmap.table.shape[0]
    check_cuda(name, hmap.table, hmap.origin_cell, xs, mask, offsets)
    check_dtype(name, hmap.table, torch.float32, (n_buckets, 32))
    check_dtype(name, hmap.origin_cell, torch.int32, (3,))
    check_dtype(name, xs, torch.float32, (*xs.shape[:-2], 3, n))
    check_dtype(name, mask, torch.bool, (*xs.shape[:-2], n))
    check_dtype(name, offsets, torch.int32, (n_off, 3))
    if n_buckets & (n_buckets - 1):
        raise ValueError(f"{name}: bucket count {n_buckets} is not a power of two")
    head = (ptr(hmap.table), n_buckets.bit_length() - 1, ptr(hmap.origin_cell), inv_resolution(hmap.resolution),
            hmap.extent, ptr(xs), n, ptr(mask))
    tail = (float(np.float32(gauss.d1)), float(np.float32(gauss.d2)), ptr(offsets), n_off, int(weighted))
    return head, tail, max(1, -(-n // BLOCK))


def ndt_derivatives_hash(
    hmap: HashVoxelMap,
    xs: torch.Tensor,          # (3, N)
    mask: torch.Tensor,        # (N,)
    transform: torch.Tensor,   # (4,4)
    gauss: GaussParams,
    offsets: torch.Tensor,     # (K,3) int32
    weighted: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused score/gradient/Hessian over every point and DIRECT offset.
    Kernel 4 on CUDA, the plain version on CPU."""
    if xs.device.type == "cpu":
        return ndt_derivatives_hash_ref(hmap, xs, mask, transform, gauss, offsets, weighted)
    head, tail, n_blocks = _hash_args("ndt_derivatives_hash", hmap, xs, mask, gauss, offsets, weighted)
    check_cuda("ndt_derivatives_hash", xs, transform)
    check_dtype("ndt_derivatives_hash", transform, torch.float32, (4, 4))
    partials = torch.empty((n_blocks, N_TERMS), dtype=torch.float32, device=xs.device)
    out = torch.empty((N_TERMS,), dtype=torch.float32, device=xs.device)
    DERIVATIVES_KERNEL.call("lvs_ndt_hash_derivatives", *head, ptr(transform), *tail, ptr(partials), n_blocks,
                            ptr(out))
    DERIVATIVES_KERNEL.launches += 1
    return out[0], out[1:7], out[7:].view(6, 6)


def hash_pass(hmap: HashVoxelMap, xs, mask, gauss: GaussParams, offsets, weighted: bool) -> DerivativePass:
    """The Newton loop's pass over the hash table: points xs (3, N) for one
    align (kernel 4) or (k, 3, N) for K13's k candidates, each lane's
    transform the state's candidate, gated on its `done` flag, on CUDA; the
    plain version on CPU."""
    batched = xs.dim() == 3
    kernel = BATCHED_KERNEL if batched else DERIVATIVES_KERNEL

    def plain(transforms, active):
        if batched:
            return ndt_derivatives_hash_batched_ref(hmap, xs, mask, transforms, gauss, offsets, weighted, active)
        return ndt_derivatives_hash_ref(hmap, xs, mask, transforms[0], gauss, offsets, weighted)

    if xs.device.type == "cpu":
        return DerivativePass(plain, None, 0)
    head, tail, n_blocks = _hash_args(kernel.name, hmap, xs, mask, gauss, offsets, weighted)
    n_cand = xs.shape[0] if batched else 1

    def launch(state: NewtonState) -> None:
        kernel.call("lvs_ndt_hash_partials", *head, state.cand_ptr(), F_WIDTH, state.done_ptr(), S_WIDTH, n_cand,
                    *tail, ptr(state.partials), n_blocks)
        kernel.launches += 1

    return DerivativePass(plain, launch, n_blocks)


def ndt_derivatives_hash_ref(
    hmap: HashVoxelMap,
    xs: torch.Tensor,
    mask: torch.Tensor,
    transform: torch.Tensor,
    gauss: GaussParams,
    offsets: torch.Tensor,
    weighted: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `ndt_derivatives_hash`: one 32-wide row
    gather per offset, then `accumulate_ndt_terms`."""
    e = hmap.extent
    b_bits = hmap.table.shape[0].bit_length() - 1
    rot = transform[:3, :3]
    t = transform[:3, 3]
    y = torch.einsum("ij,jn->in", rot, xs) + t[:, None]
    coords = cell_coords(y.T, hmap.resolution).T

    score = torch.zeros((), dtype=torch.float32, device=xs.device)
    grad = torch.zeros((6,), dtype=torch.float32, device=xs.device)
    hess = torch.zeros((6, 6), dtype=torch.float32, device=xs.device)
    for ki in range(offsets.shape[0]):
        rel = coords - hmap.origin_cell[:, None] + offsets[ki][:, None]
        in_extent = torch.all((rel >= 0) & (rel < e), dim=0)
        key = (rel[0] * e + rel[1]) * e + rel[2]
        key = torch.where(in_extent & mask, key, _EMPTY_KEY)
        h = _hash(key, b_bits)
        row32 = hmap.table[h]                                  # (N,32)
        k0 = row32[:, 0].contiguous().view(torch.int32)
        k1 = row32[:, 16].contiguous().view(torch.int32)
        valid_key = key >= 0
        m0 = valid_key & (k0 == key)
        m1 = valid_key & ~m0 & (k1 == key)
        row = torch.where(m0[:, None], row32[:, :16], row32[:, 16:])
        s, g, hh = accumulate_ndt_terms(y, row, m0 | m1, gauss, weighted, col0=1)
        score, grad, hess = score + s, grad + g, hess + hh
    return score, grad, hess


def ndt_align_hash(
    vmap_: VoxelMap, source: PointCloud, guess: torch.Tensor, *, buckets_per_leaf: int = 4, **kwargs
) -> NDTResult:
    """`ndt_align_hash_table` on a freshly hashed VoxelMap."""
    return ndt_align_hash_table(to_hash(vmap_, buckets_per_leaf), source, guess, **kwargs)


def ndt_align_hash_table(
    hmap: HashVoxelMap,
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
    """Align `source` against a pre-built hash table. `coarse_subsample > 1`
    first runs Newton on every k-th lane at 2x eps, then polishes on all lanes."""
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
        _newton_loop(hash_pass(hmap, xs_c, mask_c, gauss, offsets, weighted), state, eps * np.float32(2.0), step_size,
                     max_iterations)
        coarse_iters = state.iterations[0].clone()
        state.restart()
    _newton_loop(hash_pass(hmap, xs, mask, gauss, offsets, weighted), state, eps, step_size, max_iterations)
    return state.result(mask, coarse_iters)


def ndt_derivatives_hash_batched(
    hmap: HashVoxelMap,
    xs: torch.Tensor,          # (k, 3, N)
    mask: torch.Tensor,        # (k, N)
    transforms: torch.Tensor,  # (k, 4, 4)
    gauss: GaussParams,
    offsets: torch.Tensor,     # (K, 3) int32
    weighted: bool,
    active: Optional[List[bool]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`ndt_derivatives_hash` for k candidates against one map: (k,), (k, 6),
    (k, 6, 6). One launch of kernel 13's pass on CUDA; on CPU the plain
    version per candidate, skipping those `active` marks done (their rows
    are zeros, which the batched Newton loop never reads)."""
    k = xs.shape[0]
    if xs.device.type == "cpu":
        return ndt_derivatives_hash_batched_ref(hmap, xs, mask, transforms, gauss, offsets, weighted, active)
    head, tail, n_blocks = _hash_args("ndt_derivatives_hash_batched", hmap, xs, mask, gauss, offsets, weighted)
    check_cuda("ndt_derivatives_hash_batched", xs, transforms)
    check_dtype("ndt_derivatives_hash_batched", transforms, torch.float32, (k, 4, 4))
    partials = torch.empty((k, n_blocks, N_TERMS), dtype=torch.float32, device=xs.device)
    out = torch.empty((k, N_TERMS), dtype=torch.float32, device=xs.device)
    d1, d2, *rest = tail
    BATCHED_KERNEL.call("lvs_ndt_hash_derivatives_batched", *head, ptr(transforms), k, d1, d2, *rest, ptr(partials),
                        n_blocks, ptr(out))
    BATCHED_KERNEL.launches += 1
    return out[:, 0], out[:, 1:7], out[:, 7:].reshape(k, 6, 6)


def ndt_derivatives_hash_batched_ref(hmap, xs, mask, transforms, gauss, offsets, weighted,
                                     active: Optional[List[bool]] = None):
    """Plain PyTorch version of `ndt_derivatives_hash_batched`: the plain
    pass per candidate (zeros for the candidates `active` marks done)."""
    zero = tuple(torch.zeros(shape, dtype=torch.float32, device=xs.device) for shape in ((), (6,), (6, 6)))
    rows = [
        ndt_derivatives_hash_ref(hmap, xs[c], mask[c], transforms[c], gauss, offsets, weighted)
        if active is None or active[c] else zero
        for c in range(xs.shape[0])
    ]
    return tuple(torch.stack(col) for col in zip(*rows))


def ndt_align_hash_table_batched(
    hmap: HashVoxelMap,
    sources: PointCloud,       # xyz (k, N, 3), intensity and mask (k, N)
    guesses: torch.Tensor,     # (k, 4, 4)
    *,
    resolution: float,
    outlier_ratio: float = 0.55,
    step_size: float = 0.1,
    transformation_epsilon: float = 0.01,
    max_iterations: int = 35,
    neighborhood: str = "DIRECT1",
    weighted: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`ndt_align_hash_table` vmapped over k sources sharing one map, as the
    reference's loop verification runs it: (transforms (k, 4, 4), scores
    (k,), iterations (k,))."""
    gauss = make_gauss_params(resolution, outlier_ratio)
    offsets = neighborhood_offsets(neighborhood, guesses.device)
    mask = sources.mask.contiguous()
    xs = torch.where(mask[..., None], sources.xyz, SENTINEL).transpose(1, 2).contiguous()
    state = NewtonState(guesses, batched=True)
    # no host read: the loop runs its bound of iterations (launches after a
    # candidate is done are no-ops), as the reference's program reads nothing
    _newton_loop(hash_pass(hmap, xs, mask, gauss, offsets, weighted), state, transformation_epsilon, step_size,
                 max_iterations, read=False)
    return state.transforms.contiguous(), state.scores, state.iterations
