"""The port's entry points: one odometry step (`entry`) and the multi-rank
dry run (`dryrun_multichip`), the counterparts of the reference's
`__graft_entry__.entry` and `dryrun_multichip`.

`entry()` returns `(fn, args)`: the flagship odometry step (the
PCA-weighted voxel map at 1 m, 8192 leaves in a 128-cell LUT, hashed, then
the DIRECT1 hash align with the coarse phase on every 2nd lane) on the
reference's straight 2-scan pair at cap 32768. `dryrun_multichip(n)` runs
the reference's multi-chip sequence over the port's mesh in the caller's
process group of n ranks: the sharded align, the sharded graph of 8 nodes,
the fleet without and with the fused LFA. On several cards, one NCCL rank
per card:

    torchrun --nproc-per-node=N -m lv_slam_tpu_torch.entry
"""

from __future__ import annotations

import numpy as np
import torch

from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.io import synthetic


def _example_pair(cap: int = 32768, n_scans: int = 2, device="cuda"):
    """The reference's example pair: scans 0 and 1 of a straight 1 m-step
    drive at 16 x 225 rays (seed 11), and the guess x = 1 m."""
    scans, _, _ = synthetic.make_sequence(n_scans, seed=11, trajectory="straight", step=1.0, n_rings=16,
                                          n_azimuth=225)
    guess = torch.eye(4, dtype=torch.float32, device=device)
    guess[0, 3] = 1.0
    return PointCloud.from_numpy(scans[0], cap=cap, device=device), \
        PointCloud.from_numpy(scans[1], cap=cap, device=device), guess


def entry(device="cuda"):
    """(fn, example_args): one scan-in / pose-out odometry step on the
    flagship model; fn(target, source, guess) -> (transform, score,
    iterations), on `device`."""
    from lv_slam_tpu_torch.ops.ndt_hash import ndt_align_hash
    from lv_slam_tpu_torch.ops.voxel_map import build_voxel_map

    cap, leaf_cap, lut_extent = 32768, 8192, 128

    def odometry_step(target_cloud, source_cloud, guess):
        vm = build_voxel_map(target_cloud, 1.0, leaf_cap=leaf_cap, lut_extent=lut_extent, weighted=True)
        result = ndt_align_hash(
            vm, source_cloud, guess, resolution=1.0, transformation_epsilon=0.01, max_iterations=64,
            neighborhood="DIRECT1", weighted=True, coarse_subsample=2,
        )
        return result.transform, result.score, result.iterations

    return odometry_step, _example_pair(cap, device=device)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Runs the reference's multi-chip sequence once over an n-rank mesh of
    the caller's process group (one rank per card on "cuda"; gloo ranks on
    the CPU with device="cpu"): the "batch" axis takes 2 or 4 of the ranks
    where that leaves at least 2 on "point". Raises if an output is not
    finite or has the wrong shape."""
    from lv_slam_tpu_torch.config import LfaConfig, NDTConfig, OdometryConfig
    from lv_slam_tpu_torch.graph import pose_graph as pg
    from lv_slam_tpu_torch.ops.voxel_map import build_lut, build_voxel_map
    from lv_slam_tpu_torch.parallel import fleet as pfleet, mesh as pmesh

    n_batch = 1
    for cand in (2, 4):
        if n_devices % cand == 0 and n_devices // cand >= 2:
            n_batch = cand
    n_point = n_devices // n_batch
    dev = torch.device(device)
    m = pmesh.make_mesh(n_batch=n_batch, n_point=n_point, device_type=dev.type)

    # sharded registration: pairs on "batch", points on "point"
    cap = 4096 * n_point  # divisible by the point axis
    scans, _, _ = synthetic.make_sequence(2, seed=11, trajectory="straight", step=1.0, n_rings=16, n_azimuth=225)
    target = PointCloud.from_numpy(scans[0], cap=cap, device=dev)
    source = PointCloud.from_numpy(scans[1], cap=cap, device=dev)
    vm = build_voxel_map(target, 1.0, leaf_cap=4096, lut_extent=64, weighted=True)
    b = n_batch
    guess = torch.eye(4, dtype=torch.float32, device=dev)
    guess[0, 3] = 1.0
    transforms, scores, iters = pmesh.ndt_align_sharded(
        m, pmesh.stack_maps([vm] * b), torch.stack([build_lut(vm)] * b), torch.stack([source.masked_xyz()] * b),
        torch.stack([source.mask] * b), torch.stack([guess] * b), resolution=1.0, max_iterations=8,
        transformation_epsilon=0.01, neighborhood="DIRECT1", weighted=True,
    )
    if tuple(transforms.shape) != (b, 4, 4) or not bool(torch.isfinite(transforms).all()):
        raise AssertionError(f"sharded align: transforms {tuple(transforms.shape)}, finite "
                             f"{bool(torch.isfinite(transforms).all())}")

    # the sharded global-graph step: factors split over every rank, the LM replicated
    graph = pg.empty_graph(node_cap=16, edge_cap=64, prior_cap=n_devices * 2)
    rng = np.random.default_rng(0)
    est = np.eye(4)
    for i in range(8):
        graph = pg.add_node(graph, i, est)
        if i > 0:
            rel = np.eye(4)
            rel[0, 3] = -1.0
            graph = pg.add_se3_edge(graph, i - 1, i, i - 1, rel, np.eye(6), huber=1.0)
        est = est.copy()
        est[0, 3] += 1.0 + rng.normal(0, 0.02)
    result = pmesh.optimize_pose_graph_sharded(m, graph, num_iterations=8, device=dev)
    chi2_before, chi2_after = float(result.chi2_before), float(result.chi2_after)
    if not bool(torch.isfinite(result.poses[:8]).all()) or chi2_after > chi2_before + 1e-6:
        raise AssertionError(f"sharded LM: chi2 {chi2_before} -> {chi2_after}")

    # the fleet: a sequence per "batch" row, without and with the fused LFA
    seq_cap = 4096
    clouds = [PointCloud.from_numpy(s, cap=seq_cap, device=dev) for s in scans]
    seq_xyz = torch.stack([torch.stack([c.xyz for c in clouds])] * n_batch)
    seq_mask = torch.stack([torch.stack([c.mask for c in clouds])] * n_batch)
    seq_stamps = (torch.arange(2, dtype=torch.float32, device=dev) * 0.1).expand(n_batch, 2).contiguous()
    fleet_cfg = OdometryConfig(ndt=NDTConfig(leaf_cap=2048, lut_extent=64, max_iterations=8, coarse_subsample=1))
    lfa_cfg = LfaConfig(scan_line=16, edge_cap=512, planar_cap=1024, map_edge_cap=4096, map_planar_cap=8192)
    for lfa in (None, lfa_cfg):
        poses = pfleet.run_fleet_odometry(m, seq_xyz, seq_mask, seq_stamps, fleet_cfg, lfa_cfg=lfa, device=dev)
        if tuple(poses.shape) != (n_batch, 2, 4, 4) or not bool(torch.isfinite(poses).all()):
            raise AssertionError(f"fleet (lfa={lfa is not None}): poses {tuple(poses.shape)}")


def main() -> None:
    """One rank of `torchrun --nproc-per-node=N -m lv_slam_tpu_torch.entry`:
    joins the NCCL group torchrun describes (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT; LOCAL_RANK picks the card), runs the odometry step and
    `dryrun_multichip(N)`, and rank 0 prints the step's result."""
    import os

    import torch.distributed as dist

    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl")
    try:
        fn, args = entry()
        transform, score, iterations = fn(*args)
        dryrun_multichip(dist.get_world_size())
        if dist.get_rank() == 0:
            print(f"entry ok: step to x = {float(transform[0, 3]):.4f} m, score {float(score):.2f}, "
                  f"{int(iterations)} iterations; dryrun_multichip({dist.get_world_size()}) ok")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
