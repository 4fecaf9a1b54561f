"""Registration and the pose graph across ranks (port of
`lv_slam_tpu.parallel.mesh`) over `torch.distributed`.

A mesh is a `DeviceMesh` of the default process group's ranks with the
reference's axes ("batch", "point"):

- **point sharding**: each rank of a "point" group holds the whole voxel
  map and a contiguous block of the scan's points; its derivative pass (K6L
  through `ops/ndt_soa.py`) sums its block, and an all-reduce over the group
  merges the 1 + 6 + 36 accumulator, the reference's `psum` (and the OpenMP
  join of `ndt_omp_impl2.hpp`);
- **pair batching**: the registrations of a batch are split over the
  "batch" axis, a contiguous block per row, and gathered back, so every
  rank returns the batch's results, as JAX's global array holds them.

`ndt_align_sharded` runs the Newton loop of the single-device aligns
(`ops/ndt._newton_loop`, K7 on the card) with the all-reduce between the
gated derivative pass and the step. `optimize_pose_graph_sharded` splits
every factor array over all the mesh's ranks, runs kernel 15 on its block,
all-reduces chi2, H and b over the whole mesh and runs the LM
(`graph/pose_graph.optimize_pose_graph`, `csrc/lm.cu` on the card)
replicated. Sums reduce in the collective's order, so a mesh of more than
one point rank matches the unsharded functions to float tolerance, and a
mesh of one rank equals them. NCCL's and gloo's sums give every rank the
same bits, and the steps that follow are deterministic on equal inputs, so
every rank reaches the same `done` flags and makes the same collectives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from lv_slam_tpu_torch.graph import pose_graph as pg
from lv_slam_tpu_torch.ops.ndt import GaussParams, NewtonState, _newton_loop, make_gauss_params
from lv_slam_tpu_torch.ops.ndt_soa import ndt_derivatives_soa, soa_pass, to_soa
from lv_slam_tpu_torch.ops.voxel_map import VoxelMap, neighborhood_offsets

AXES = ("batch", "point")


def make_mesh(n_batch: int = 1, n_point: Optional[int] = None, device_type: str = "cuda") -> DeviceMesh:
    """The (n_batch, n_point) mesh of the default process group's ranks,
    rank r at (r // n_point, r % n_point). The group must be initialised
    and hold exactly n_batch * n_point ranks (n_point defaults to the world
    size over n_batch)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no default process group; call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if n_point is None:
        n_point = world // n_batch
    if n_batch < 1 or n_point < 1 or n_batch * n_point != world:
        raise ValueError(f"make_mesh: a ({n_batch}, {n_point}) mesh needs {n_batch * n_point} ranks, "
                         f"the process group has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(n_batch, n_point), mesh_dim_names=AXES)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The mesh's length along `axis` (1 without a mesh)."""
    return 1 if mesh is None else mesh.mesh.shape[AXES.index(axis)]


def _block(n: int, parts: int, index: int, what: str) -> slice:
    """The index-th of `parts` contiguous blocks of n (JAX's sharding: n must
    divide evenly)."""
    if n % parts:
        raise ValueError(f"{what}: {n} does not split into {parts} equal blocks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def axis_block(mesh: Optional[DeviceMesh], axis: str, n: int, what: str) -> slice:
    """This rank's contiguous block of n rows split over `axis` (all of
    them without a mesh)."""
    parts = axis_size(mesh, axis)
    return _block(n, parts, mesh.get_local_rank(axis) if parts > 1 else 0, what)


def _all_reduce(group):
    def reduce(t: torch.Tensor) -> None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)

    return reduce


def gather_batch(mesh: Optional[DeviceMesh], local: torch.Tensor) -> torch.Tensor:
    """The "batch" rows' blocks of (B_local, ...) concatenated in row order
    on every rank (`local` itself without a "batch" axis longer than one)."""
    if axis_size(mesh, "batch") == 1:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(axis_size(mesh, "batch"))]
    dist.all_gather(parts, local, group=mesh.get_group("batch"))
    return torch.cat(parts)


def ndt_derivatives_sharded(
    mesh: DeviceMesh,
    vmap_: VoxelMap,
    lut: torch.Tensor,
    src_xyz: torch.Tensor,     # (N, 3)
    src_mask: torch.Tensor,    # (N,)
    transform: torch.Tensor,   # (4, 4)
    gauss: GaussParams,
    offsets: torch.Tensor,     # (K, 3) int32
    weighted: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Point-sharded derivative pass: the map (and its LUT) on every rank,
    the points split over "point", the (score, grad, hess) sums all-reduced
    over the "point" group. Every rank returns the whole pass's sums."""
    block = axis_block(mesh, "point", src_xyz.shape[0], "ndt_derivatives_sharded")
    xs = src_xyz[block].T.contiguous()
    score, grad, hess = ndt_derivatives_soa(to_soa(vmap_, lut), xs, src_mask[block].contiguous(), transform, gauss,
                                            offsets, weighted)
    terms = torch.cat([score.reshape(1), grad.reshape(6), hess.reshape(36)])
    _all_reduce(mesh.get_group("point"))(terms)
    return terms[0], terms[1:7], terms[7:].reshape(6, 6)


def _unstack(maps, i: int):
    """Map i of a `stack_maps` stack."""
    return type(maps)(*(f[i] if isinstance(f, torch.Tensor) else f for f in maps))


def ndt_align_sharded(
    mesh: DeviceMesh,
    vmaps: VoxelMap,
    lut: torch.Tensor,
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    guesses: torch.Tensor,
    *,
    resolution: float,
    outlier_ratio: float = 0.55,
    step_size: float = 0.1,
    transformation_epsilon: float = 0.01,
    max_iterations: int = 35,
    neighborhood: str = "DIRECT7",
    weighted: bool = False,
    coarse_subsample: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched + point-sharded NDT registration.

    vmaps: stacked VoxelMaps (`stack_maps`, leading batch axis B), lut (B,
    E^3) their LUTs; src_xyz (B, N, 3), src_mask (B, N), guesses (B, 4, 4).
    Returns (transforms (B, 4, 4), scores (B,), iterations (B,)) on every
    rank. Each "batch" row registers its B / n_batch pairs one after
    another; within a row each rank holds N / n_point points and the Newton
    loop (`ndt_align_soa_table`'s: the optional coarse phase on every k-th
    LOCAL lane at 2x eps, then all lanes) runs replicated off the
    all-reduced sums."""
    b, n = src_xyz.shape[:2]
    rows = axis_block(mesh, "batch", b, "ndt_align_sharded")
    pts = axis_block(mesh, "point", n, "ndt_align_sharded")
    reduce = _all_reduce(mesh.get_group("point"))
    gauss = make_gauss_params(resolution, outlier_ratio)
    offsets = neighborhood_offsets(neighborhood, guesses.device)
    eps = np.float32(transformation_epsilon)
    transforms, scores, iterations = [], [], []
    for j in range(rows.start, rows.stop):
        soa = to_soa(_unstack(vmaps, j), lut[j])
        xs = src_xyz[j, pts].T.contiguous()
        mask = src_mask[j, pts].contiguous()
        state = NewtonState(guesses[j][None])
        coarse_iters = 0
        if coarse_subsample > 1:
            xs_c = xs[:, ::coarse_subsample].contiguous()
            mask_c = mask[::coarse_subsample].contiguous()
            _newton_loop(soa_pass(soa, xs_c, mask_c, gauss, offsets, weighted), state, eps * np.float32(2.0),
                         step_size, max_iterations, reduce=reduce)
            coarse_iters = state.iterations[0].clone()
            state.restart()
        _newton_loop(soa_pass(soa, xs, mask, gauss, offsets, weighted), state, eps, step_size, max_iterations,
                     reduce=reduce)
        transforms.append(state.transforms[0].clone())
        scores.append(state.scores[0].clone())
        iterations.append(state.iterations[0] + coarse_iters)
    return (gather_batch(mesh, torch.stack(transforms)), gather_batch(mesh, torch.stack(scores)),
            gather_batch(mesh, torch.stack(iterations).to(torch.int32)))


# the factor arrays `optimize_pose_graph_sharded` splits (the reference's P(axes))
FACTOR_FIELDS = (
    "e_i", "e_j", "e_meas", "e_info", "e_huber", "e_valid",
    "p_node", "p_type", "p_meas", "p_info", "p_huber", "p_valid",
    "sp_i", "sp_plane", "sp_meas", "sp_info", "sp_huber", "sp_valid",
    "q_i", "q_j", "q_type", "q_meas", "q_info", "q_huber", "q_valid",
)


def optimize_pose_graph_sharded(mesh: DeviceMesh, graph: pg.PoseGraph, num_iterations: int = 64,
                                device=None) -> pg.OptimizeResult:
    """Factor-sharded pose-graph LM: every factor array (edges, priors,
    SE3-plane and plane-plane) split over all the mesh's ranks jointly, rank
    r = (batch, point) taking the r-th contiguous block of slots; nodes and
    planes on every rank. chi2, H and b are all-reduced over the whole mesh,
    then the gauge and the LM run replicated.

    The reference's sharded loop (`parallel/mesh.py:203-231`) has the rules
    of `optimize_pose_graph`'s (lambda from 1e-4, x0.5 / x4 within [1e-9,
    1e6], accept at chi2 not above the current, stop at num_iterations,
    max |delta| < 1e-6 or a relative chi2 change below 1e-8, the anchor
    re-applied), with a default of 64 iterations: the port runs that loop
    with the collectives inserted. `device` defaults to the mesh's (the
    current CUDA device on a "cuda" mesh)."""
    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError("optimize_pose_graph_sharded: the mesh must hold every rank of the default group")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else "cpu"
    rank = mesh.get_local_rank("batch") * axis_size(mesh, "point") + mesh.get_local_rank("point")
    n = mesh.mesh.numel()
    local = graph._replace(**{f: getattr(graph, f)[_block(getattr(graph, f).shape[0], n, rank, f)]
                              for f in FACTOR_FIELDS})
    return pg.optimize_pose_graph(local, num_iterations, device=device, reduce=_all_reduce(None))


def stack_maps(maps: list) -> VoxelMap:
    """Stack VoxelMaps (any NamedTuple of tensors) along a new leading batch
    axis; their non-tensor fields must agree."""
    fields = []
    for values in zip(*maps):
        if isinstance(values[0], torch.Tensor):
            fields.append(torch.stack(values))
        elif any(v != values[0] for v in values):
            raise ValueError(f"stack_maps: the maps differ in a scalar field: {values}")
        else:
            fields.append(values[0])
    return type(maps[0])(*fields)


def replicate_to_mesh(tree, mesh: DeviceMesh):
    """`tree` (a tensor, or a tuple / NamedTuple / list of them) as rank 0
    of the mesh holds it, broadcast in place; returns it."""
    if isinstance(tree, torch.Tensor):
        dist.broadcast(tree, src=int(mesh.mesh.flatten()[0]))
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            replicate_to_mesh(t, mesh)
    return tree
