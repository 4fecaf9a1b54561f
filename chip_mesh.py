#!/usr/bin/env python3
"""The mesh over NCCL on several cards, one rank per card:

    python -m torch.distributed.run --standalone --nproc-per-node=4 chip_mesh.py

Each rank simulates the first 17 scans of chip_smoke.py's circle and runs
`lv_slam_tpu_torch.parallel.check`'s rank body on every mesh of the world
((1, 4), (2, 2), (4, 1) for four ranks): the sharded derivatives, the
sharded align of K13's batch (8 pairs x 131072 lanes, DIRECT7, 1 m) and the
sharded LM on phase 2c's graph, held to the unsharded port on its own card
at `check.TOLERANCES` (the CPU tests' and chip_smoke.py's); every rank must
return the same bits. Then `dryrun_multichip`. Rank 0 prints every rank's
results as one JSON line, then "ALL OK"; the script raises otherwise. An
align's wall time (`align_ms`) includes the first collective of a new
subgroup (NCCL sets its communicator up then)."""
import json
import multiprocessing
import os
import time

import numpy as np

import chip_smoke as cs


def main():
    import torch
    import torch.distributed as dist

    from lv_slam_tpu_torch import entry, kitti_flagship_config
    from lv_slam_tpu_torch.io import synthetic
    from lv_slam_tpu_torch.ops import voxel_map
    from lv_slam_tpu_torch.parallel import check

    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local)
    dev = torch.device("cuda", local)
    dist.init_process_group("nccl")
    rank, world = dist.get_rank(), dist.get_world_size()
    with multiprocessing.get_context("spawn").Pool(8) as pool:
        scans = pool.starmap(cs._simulate, [(i, cs.N_FULL) for i in range(17)])
    gt = synthetic.circle_trajectory(cs.N_FULL, step=1.0)
    keyframe, cands, guesses = cs.loop_batch(torch, scans, gt, dev)
    vm = voxel_map.build_voxel_map(keyframe, 1.0, leaf_cap=16384, lut_extent=256)
    rel_all = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    graph, _ = cs.backend_graph(torch, rel_all, False)
    shapes = [(b, world // b) for b in range(1, world + 1) if world % b == 0]
    inputs = cs.mesh_inputs(vm, voxel_map.build_lut(vm), cands, guesses, graph,
                            kitti_flagship_config().loop.verify_max_iterations, shapes)
    got = check.sharded_cases(rank, inputs)
    want = check.unsharded_cases(inputs)
    out = {}
    for shape, res in got.items():
        try:  # every rank reaches the gather below, whatever its verdict
            check.check(res, want)
            verdict = "ok"
        except AssertionError as e:
            verdict = str(e)
        out[str(shape)] = dict(
            verdict=verdict, align_ms=res["align_ms"], iterations=res["iterations"].tolist(),
            lm_iterations=int(res["lm_iterations"]), align_max=float(np.abs(res["transforms"] - want["transforms"]).max()),
            score_rel=abs(float(res["score"]) - float(want["score"])) / abs(float(want["score"])),
            chi2_rel=abs(float(res["chi2_before"]) - float(want["chi2_before"])) / float(want["chi2_before"]),
            lm_t_max=float(np.abs(res["lm_poses"][:, :3, 3] - want["lm_poses"][:, :3, 3]).max()),
        )
    t0 = time.perf_counter()
    entry.dryrun_multichip(world)
    torch.cuda.synchronize()
    out["dryrun_s"] = time.perf_counter() - t0
    summaries, results = [None] * world, [None] * world
    dist.all_gather_object(summaries, out)
    dist.all_gather_object(results, got)
    ok = True
    if rank == 0:
        print(json.dumps(summaries))
        try:
            check.check_same_bits(results)
        except AssertionError as e:
            print(e)
            ok = False
        ok = ok and all(r[k]["verdict"] == "ok" for r in summaries for k in r if k.startswith("("))
        print("ALL OK" if ok else "FAILED")
    dist.destroy_process_group()
    if not ok:
        raise SystemExit("chip_mesh: a sharded function departs from the unsharded port")


if __name__ == "__main__":
    main()
