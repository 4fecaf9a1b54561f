"""The mesh held to the unsharded port, in a world of ranks.

One rank body (`sharded_cases`: the sharded derivatives, the sharded align
of a batch of pairs and the sharded LM on each mesh of the world), its
unsharded counterpart on one device (`unsharded_cases`), the comparison of
the two at `TOLERANCES` (`check`), and `spawn`, which runs a rank body in a
gloo world of spawned processes (a FileStore under a directory of the
caller's, a time limit). The CPU tests, `chip_smoke.py`'s 2-rank world on
the card and `chip_mesh.py`'s NCCL world under torchrun all use them.

Inputs are a dict of host arrays (a spawned rank uploads them): `map` (a
VoxelMap's fields), `lut`, `xyz` (B, N, 3), `mask` (B, N), `guesses` (B, 4,
4), `T` (the derivatives' transform), `graph` (a PoseGraph's fields),
`meshes` (the (n_batch, n_point) shapes to run), `align` (the aligns'
keyword arguments, `resolution`, `neighborhood` and `weighted` among them,
since the sharded and unsharded aligns' defaults differ), `lm_iterations`, `device` ("cpu" or "cuda", the
rank's current CUDA device) and, optionally, `fleet` (run a two-lane fleet
and `replicate_to_mesh` on each mesh too). The derivatives are those of
pair 0 at `T`; the map is one map for every pair.
"""

from __future__ import annotations

import datetime
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# tests/test_parallel.py's and tests/test_parallel_graph.py's tolerances:
# the sharded sums reduce in another order than the unsharded pass
TOLERANCES = dict(score_rtol=1e-5, grad_rtol=1e-4, grad_atol=1e-2, hess_rtol=1e-3, hess_atol=1.0, align_atol=5e-3,
                  chi2_rtol=1e-4, translation_atol=5e-3)
TIMEOUT_S = 300.0  # a spawned world's limit: a deadlock fails instead of hanging


def _tensors(tree, device):
    """numpy arrays (in dicts, tuples, lists) as tensors on `device`."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tensors(v, device) for v in tree)
    return tree


def _device(inputs: dict) -> torch.device:
    if inputs["device"] == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _args(inputs: dict):
    """(device, map, lut, xyz, mask, guesses, T, graph, gauss, offsets) on the inputs' device."""
    from lv_slam_tpu_torch.graph import pose_graph as pg
    from lv_slam_tpu_torch.ops.ndt import make_gauss_params
    from lv_slam_tpu_torch.ops.voxel_map import VoxelMap, neighborhood_offsets

    dev = _device(inputs)
    t = _tensors({k: inputs[k] for k in ("map", "lut", "xyz", "mask", "guesses", "T")}, dev)
    align = inputs["align"]
    return (dev, VoxelMap(**t["map"]), t["lut"], t["xyz"], t["mask"], t["guesses"], t["T"],
            pg.PoseGraph(**_tensors(inputs["graph"], "cpu")), make_gauss_params(align["resolution"]),
            neighborhood_offsets(align["neighborhood"], dev))


def _numpy(results: dict) -> dict:
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in results.items()}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_cases(rank: int, inputs: dict) -> dict:
    """The rank body, in the current default process group: per mesh shape
    of `inputs["meshes"]`, the sharded derivatives, the sharded align of the
    B pairs (and its wall time, `align_ms`) and the sharded LM, as host
    arrays."""
    from lv_slam_tpu_torch.parallel import mesh as pmesh

    dev, vm, lut, xyz, mask, guesses, t, graph, gauss, offsets = _args(inputs)
    align = inputs["align"]
    b = guesses.shape[0]
    out = {}
    for shape in inputs["meshes"]:
        mesh = pmesh.make_mesh(*shape, device_type=dev.type)
        s, g, h = pmesh.ndt_derivatives_sharded(mesh, vm, lut, xyz[0], mask[0], t, gauss, offsets,
                                                align["weighted"])
        _sync(dev)
        t0 = time.perf_counter()
        transforms, scores, iters = pmesh.ndt_align_sharded(mesh, pmesh.stack_maps([vm] * b), torch.stack([lut] * b),
                                                            xyz, mask, guesses, **align)
        _sync(dev)
        wall = time.perf_counter() - t0
        lm = pmesh.optimize_pose_graph_sharded(mesh, graph, inputs["lm_iterations"], device=dev)
        res = dict(score=s, grad=g, hess=h, transforms=transforms, scores=scores, iterations=iters, lm_poses=lm.poses,
                   chi2_before=lm.chi2_before, chi2_after=lm.chi2_after, lm_iterations=lm.iterations)
        if inputs.get("fleet"):
            res.update(_fleet_cases(rank, mesh, dev))
        out[tuple(shape)] = dict(_numpy(res), align_ms=wall * 1e3)
    return out


def _fleet_cases(rank: int, mesh, dev) -> dict:
    """`replicate_to_mesh` of a rank-dependent tensor, the "batch" split of
    4 lanes gathered back, and a fleet of two lanes of two scans
    (`dryrun_multichip`'s sequence, shifted for the second lane) on the
    mesh and without one."""
    from lv_slam_tpu_torch.config import NDTConfig, OdometryConfig
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.io import synthetic
    from lv_slam_tpu_torch.parallel import fleet, mesh as pmesh

    scans, _, _ = synthetic.make_sequence(3, seed=11, trajectory="straight", step=1.0, n_rings=16, n_azimuth=225)
    clouds = [PointCloud.from_numpy(s, cap=4096, device=dev) for s in scans]
    seq_xyz = torch.stack([torch.stack([c.xyz for c in clouds[i:i + 2]]) for i in range(2)])
    seq_mask = torch.stack([torch.stack([c.mask for c in clouds[i:i + 2]]) for i in range(2)])
    stamps = torch.tensor([[0.0, 0.1], [0.0, 0.1]], device=dev)
    cfg = OdometryConfig(ndt=NDTConfig(leaf_cap=2048, lut_extent=64, max_iterations=8, coarse_subsample=1))
    args = (seq_xyz, seq_mask, stamps, cfg)
    return dict(
        replicated=pmesh.replicate_to_mesh(torch.full((3,), float(rank + 1), device=dev), mesh),
        lanes=pmesh.gather_batch(mesh, fleet.shard_sequences(mesh, torch.arange(4, device=dev))),
        fleet=fleet.run_fleet_odometry(mesh, *args, device=dev),
        fleet_unsharded=fleet.run_fleet_odometry(None, *args, device=dev),
    )


def unsharded_cases(inputs: dict) -> dict:
    """The single-device functions on the same inputs: the SoA derivative
    pass of pair 0 at `T`, `ndt_align_soa` of each pair and
    `optimize_pose_graph`, as host arrays."""
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.graph import pose_graph as pg
    from lv_slam_tpu_torch.ops import ndt_soa

    dev, vm, lut, xyz, mask, guesses, t, graph, gauss, offsets = _args(inputs)
    align = inputs["align"]
    s, g, h = ndt_soa.ndt_derivatives_soa(ndt_soa.to_soa(vm, lut), xyz[0].T.contiguous(), mask[0], t, gauss, offsets,
                                          align["weighted"])
    aligns = [ndt_soa.ndt_align_soa(vm, lut, PointCloud(xyz[j], torch.zeros_like(mask[j], dtype=torch.float32),
                                                        mask[j]), guesses[j], **align)
              for j in range(guesses.shape[0])]
    lm = pg.optimize_pose_graph(graph, inputs["lm_iterations"], device=dev)
    return _numpy(dict(score=s, grad=g, hess=h, transforms=torch.stack([a.transform for a in aligns]),
                       lm_poses=lm.poses, chi2_before=lm.chi2_before, chi2_after=lm.chi2_after))


def check_derivatives(got: dict, want) -> None:
    """(score, grad, hess) of `got` against `want`'s at TOLERANCES."""
    s, g, h = want
    np.testing.assert_allclose(float(got["score"]), float(s), rtol=TOLERANCES["score_rtol"])
    np.testing.assert_allclose(got["grad"], np.asarray(g), rtol=TOLERANCES["grad_rtol"], atol=TOLERANCES["grad_atol"])
    np.testing.assert_allclose(got["hess"], np.asarray(h), rtol=TOLERANCES["hess_rtol"], atol=TOLERANCES["hess_atol"])


def check_aligns(got: dict, want) -> None:
    np.testing.assert_allclose(got["transforms"], np.asarray(want), atol=TOLERANCES["align_atol"])


def check_lm(got: dict, chi2_before, poses) -> None:
    """chi2 before the LM and the node translations; chi2 not raised."""
    np.testing.assert_allclose(float(got["chi2_before"]), float(chi2_before), rtol=TOLERANCES["chi2_rtol"])
    n = np.asarray(poses).shape[0]
    np.testing.assert_allclose(got["lm_poses"][:n, :3, 3], np.asarray(poses)[:, :3, 3],
                               atol=TOLERANCES["translation_atol"])
    assert float(got["chi2_after"]) <= float(got["chi2_before"]), (got["chi2_after"], got["chi2_before"])


def check(got: dict, want: dict) -> None:
    """One mesh's `sharded_cases` against `unsharded_cases`; raises
    AssertionError at the first value outside TOLERANCES."""
    check_derivatives(got, (want["score"], want["grad"], want["hess"]))
    check_aligns(got, want["transforms"])
    check_lm(got, want["chi2_before"], want["lm_poses"])


def check_same_bits(ranks: list) -> None:
    """Every rank returned rank 0's bits (the collectives' sums are
    replicated, and what follows them is deterministic)."""
    for shape, res in ranks[0].items():
        for r, other in enumerate(ranks[1:], 1):
            for key, value in res.items():
                if key != "align_ms" and not np.array_equal(other[shape][key], value):
                    raise AssertionError(f"mesh {shape}: rank {r}'s {key} differs from rank 0's")


def dryrun(rank: int, inputs: dict) -> dict:
    """The port's `dryrun_multichip` in this world."""
    from lv_slam_tpu_torch import entry

    entry.dryrun_multichip(dist.get_world_size(), device=inputs.get("device", "cpu"))
    return {}


def run(rank: int, world: int, store_path: str, job: str, inputs: dict, out_dir: str) -> None:
    """Rank `rank` of a gloo world of `world`: runs `job` (a function of this
    module) on the inputs' device (CUDA device 0 for "cuda") and saves its
    result, or the traceback, under `out_dir`."""
    torch.set_num_threads(1)
    if inputs.get("device") == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = {"ok": globals()[job](rank, inputs)}
    except Exception:  # reported by the spawning process, which reads every rank's file
        result = {"error": traceback.format_exc()}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def spawn(world: int, job: str, inputs: dict, out_dir: Path) -> list:
    """Runs `job` on every rank of a new gloo world of `world` spawned
    processes (a FileStore in the empty or new directory `out_dir`, so two
    worlds never share a port); returns the ranks' results in rank order.
    Raises if a rank raised, and kills the world if it has not ended within
    TIMEOUT_S."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*"):
        old.unlink()
    ctx = torch.multiprocessing.start_processes(
        run, args=(world, str(out_dir / "store"), job, inputs, str(out_dir)), nprocs=world, join=False,
        start_method="spawn",
    )
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"a gloo world of {world} running {job} did not end within {TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    results = []
    for rank in range(world):
        with open(out_dir / f"rank{rank}.pkl", "rb") as f:  # written by `run` above
            results.append(pickle.load(f))
    for rank, result in enumerate(results):
        if "error" in result:
            raise AssertionError(f"rank {rank} of {world} raised:\n{result['error']}")
    return [r["ok"] for r in results]
