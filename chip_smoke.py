#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`lv_slam_tpu_torch`) on one NVIDIA GPU.

    python chip_smoke.py

Phases, each of which raises on failure:
1. The card, the software, and the build of the hand-written kernels
   (`lv_slam_tpu_torch/csrc/*.cu`, compiled by nvcc at first use).
2. Every kernel against its plain PyTorch version on the card, at the shapes
   the odometry's main path gives it (one KITTI-density scan of 131072
   lanes, a 65536-lane scan-matching cloud, a 32768-leaf keyframe map), with
   the median time of each over 20 runs.
3. The slice end to end: 64 simulated KITTI-density scans through
   `run_sequence_fused` under `kitti_flagship_config()`, in two chunks of 32
   carried by `init_state` / `return_state`, with `return_filtered`. Every
   kernel must have been launched; the trajectory must pass the reference
   benchmark's accuracy gates (devkit relative translation error <= 0.010,
   final drift under 2 % of the distance); its first four scans must agree
   with the plain path run on the CPU to 1e-4 m and 1e-4. A second, warm
   pass is timed, its host syncs are counted, and a profiled pass splits the
   device time.

The last lines are the kernels' JSON record, the card's name and power
limit, and `{"ok": true, "device": {...}}`. Without a CUDA device the script
exits non-zero before it prints any result.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

N_SCANS = 64
CHUNK = 32
SEED = 5  # the reference benchmark's world and noise seeds
ROOT = Path(__file__).resolve().parent
CACHE = ROOT / "_cache" / "chip_smoke"  # git-ignored: scan cache and the profile table



def log(*args) -> None:
    print(*args, flush=True)


# ----------------------------------------------------------------- workload


def _simulate(i: int, n_scans: int) -> np.ndarray:
    """Scan i of the reference benchmark's circle: world seed 5, HDL-64 rays
    64 x 2000 (~125k returns), scan noise seed 5 + i."""
    from lv_slam_tpu_torch.io import synthetic

    world = synthetic.make_world(seed=SEED)
    pose = synthetic.circle_trajectory(n_scans, step=1.0)[i]
    return synthetic.simulate_scan(world, pose, synthetic.hdl64_rays(64, 2000), seed=SEED + i)


def load_scans(n_scans: int):
    """(scans, gt poses): simulated once in a process pool, cached under
    `_cache/chip_smoke/` (git-ignored)."""
    from lv_slam_tpu_torch.io import synthetic

    gt = synthetic.circle_trajectory(n_scans, step=1.0)
    path = CACHE / f"scans_v1_{n_scans}.npz"
    if path.exists():
        with np.load(path) as z:
            return [z[f"s{i}"] for i in range(n_scans)], gt
    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        scans = pool.starmap(_simulate, [(i, n_scans) for i in range(n_scans)])
    log(f"simulated {n_scans} scans in {time.perf_counter() - t0:.1f} s ({workers} processes)")
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.npz")
    np.savez(tmp, **{f"s{i}": s for i, s in enumerate(scans)})
    os.replace(tmp, path)
    return scans, gt


def devkit_t_err(gt_rel: np.ndarray, est: np.ndarray) -> float:
    """The reference benchmark's KITTI-devkit-style relative translation
    error, segment lengths scaled down for a short synthetic run."""
    from lv_slam_tpu_torch.io import kitti

    total = float(np.linalg.norm(gt_rel[1:, :3, 3] - gt_rel[:-1, :3, 3], axis=1).sum())
    lengths = tuple(f * total for f in (0.25, 0.5, 0.75)) if total < 850.0 else None
    t_err, _ = kitti.kitti_seq_error(gt_rel, est, step=5, lengths=lengths)
    return float(t_err)


# ----------------------------------------------------------------- phase 2


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_kernels(torch, scans, gt, dev):
    """Phase 2: each kernel vs its plain version at main-path shapes."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.ops import ndt_hash, prefilter, voxel_map
    from lv_slam_tpu_torch.ops.ndt import make_gauss_params

    cfg = kitti_flagship_config()
    pf, ndt = cfg.prefilter, cfg.odometry.ndt
    records = {}

    def clouds(i):
        raw = PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev)
        return prefilter.distance_filter(raw, pf.distance_near_thresh, pf.distance_far_thresh)

    # kernel 1: 131072 lanes -> out_cap 131072
    band = clouds(0)
    k1 = lambda: prefilter.voxel_downsample(band, pf.downsample_resolution, pf.out_cap)  # noqa: E731
    p1 = lambda: prefilter.voxel_downsample_ref(band, pf.downsample_resolution, pf.out_cap)  # noqa: E731
    got, want = k1(), p1()
    torch.cuda.synchronize()
    if not torch.equal(got.mask, want.mask):
        raise AssertionError("voxel_downsample: mask / lane order differs from the plain version")
    err = max(float((got.xyz - want.xyz).abs().max()), float((got.intensity - want.intensity).abs().max()))
    if err > 1e-5:
        raise AssertionError(f"voxel_downsample: max abs err {err} > 1e-5")
    records["voxel_downsample"] = dict(max_abs_err=err, ms=cuda_ms(torch, k1), plain_ms=cuda_ms(torch, p1))
    log(f"  voxel_downsample: {int(got.mask.sum())} voxels of {int(band.mask.sum())} returns, "
        f"mask and lane order identical, max abs err {err:.3g} (tol 1e-5)")

    # kernel 2: 65536 scan-matching lanes -> 32768 weighted leaves
    filtered = prefilter.stride_subsample(got, cfg.odometry.scan_matching_cap)
    kw = dict(
        leaf_cap=ndt.leaf_cap, lut_extent=ndt.lut_extent,
        min_points_per_voxel=ndt.min_points_per_voxel,
        min_covar_eigvalue_mult=ndt.min_covar_eigvalue_mult, weighted=ndt.weighted,
    )
    k2 = lambda: voxel_map.build_voxel_map(filtered, ndt.resolution, **kw)  # noqa: E731
    p2 = lambda: voxel_map.build_voxel_map_ref(filtered, ndt.resolution, **kw)  # noqa: E731
    vm, vm_ref = k2(), p2()
    differ = vm.valid != vm_ref.valid
    if bool(differ.any()):  # both round alike, so any difference is a fault
        ratio = voxel_map.leaf_eigen_ratio(filtered, ndt.resolution, ndt.leaf_cap, ndt.lut_extent)
        raise AssertionError(
            f"build_voxel_map: {int(differ.sum())} of {int(vm_ref.n_leaves)} leaves differ in validity "
            f"(float64 lambda0/lambda2 there: {ratio[differ].sort().values.tolist()[-10:]})"
        )
    v = vm_ref.valid
    err_mean = float((vm.means[v] - vm_ref.means[v]).abs().max())
    err_icov = float((vm.icovs[v] - vm_ref.icovs[v]).abs().max())
    err_w = float((vm.weights[v] - vm_ref.weights[v]).abs().max())
    icov_tol = 1e-4 * float(vm_ref.icovs[v].abs().max())
    w_tol = 1e-4 * float(vm_ref.weights[v].abs().max())
    if err_mean > 1e-5 or err_icov > icov_tol or err_w > w_tol:
        raise AssertionError(f"build_voxel_map: errors mean {err_mean} icov {err_icov} weight {err_w}")
    records["build_voxel_map"] = dict(max_abs_err=err_icov, ms=cuda_ms(torch, k2), plain_ms=cuda_ms(torch, p2))
    log(f"  build_voxel_map: {int(vm.n_leaves)} valid leaves, validity identical; "
        f"max abs err mean {err_mean:.3g} (tol 1e-5), icov {err_icov:.3g} (tol {icov_tol:.3g}), "
        f"weight {err_w:.3g} (tol {w_tol:.3g})")

    # kernel 3: the same VoxelMap -> 131072 x 32 table, bit-exact
    k3 = lambda: ndt_hash.to_hash(vm, ndt.hash_buckets_per_leaf)  # noqa: E731
    p3 = lambda: ndt_hash.to_hash_ref(vm, ndt.hash_buckets_per_leaf)  # noqa: E731
    hm, hm_ref = k3(), p3()
    if not torch.equal(hm.table.view(torch.int32), hm_ref.table.view(torch.int32)):
        raise AssertionError("to_hash: table is not bit-identical to the plain version")
    if int(hm.n_dropped) != int(hm_ref.n_dropped):
        raise AssertionError("to_hash: n_dropped differs")
    records["to_hash"] = dict(max_abs_err=0.0, ms=cuda_ms(torch, k3), plain_ms=cuda_ms(torch, p3))
    log(f"  to_hash: table {tuple(hm.table.shape)} bit-identical, n_dropped {int(hm.n_dropped)}")

    # kernel 4: scan 1's 65536 lanes against scan 0's map, at the true pose
    src_mid = prefilter.voxel_downsample(clouds(1), pf.downsample_resolution, pf.out_cap)
    src = prefilter.stride_subsample(src_mid, cfg.odometry.scan_matching_cap)
    xs = src.masked_xyz().T.contiguous()
    rel = torch.from_numpy((np.linalg.inv(gt[0]) @ gt[1]).astype(np.float32)).to(dev)
    gauss = make_gauss_params(ndt.resolution, ndt.outlier_ratio)
    err4, times = 0.0, {}
    for hood, weighted in (("DIRECT1", True), ("DIRECT7", False)):
        args = (hm, xs, src.mask.contiguous(), rel, gauss, voxel_map.neighborhood_offsets(hood, dev), weighted)
        k4 = lambda: ndt_hash.ndt_derivatives_hash(*args)  # noqa: E731
        p4 = lambda: ndt_hash.ndt_derivatives_hash_ref(*args)  # noqa: E731
        (s1, g1, h1), (s2, g2, h2) = k4(), p4()
        es = abs(float(s1) - float(s2))
        eg, eh = float((g1 - g2).abs().max()), float((h1 - h2).abs().max())
        tg, th = 2e-5 * float(g2.abs().max()), 2e-5 * float(h2.abs().max())
        if es > 1e-4 * abs(float(s2)) or eg > tg or eh > th:
            raise AssertionError(f"ndt_derivatives_hash {hood}: errors score {es} grad {eg} hess {eh}")
        err4 = max(err4, eg, eh)
        times[hood] = (cuda_ms(torch, k4), cuda_ms(torch, p4))
        log(f"  ndt_derivatives_hash {hood} weighted={weighted}: score {float(s2):.1f}, "
            f"errors score {es:.3g} (tol {1e-4 * abs(float(s2)):.3g}), grad {eg:.3g} (tol {tg:.3g}), "
            f"hess {eh:.3g} (tol {th:.3g}); {times[hood][0]:.4f} ms vs plain {times[hood][1]:.4f} ms")
    records["ndt_derivatives_hash"] = dict(
        max_abs_err=err4, ms=times["DIRECT1"][0], plain_ms=times["DIRECT1"][1]
    )
    for name, r in records.items():
        log(f"  time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms (median of 20)")
    return records


# ----------------------------------------------------------------- phase 3


def run_chunks(torch, run, xyz, mask, stamps, inten, cfg):
    """Two chunks carried by init_state / return_state, as a long sequence runs."""
    state, poses, iters, switches, filt = None, [], [], [], []
    for s in range(0, xyz.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        (p, it, sw, f), state = run(
            xyz[sl], mask[sl], stamps[sl], cfg.odometry, cfg.prefilter, with_stats=True,
            init_state=state, return_state=True, inten=inten[sl], return_filtered=True,
        )
        poses.append(p)
        iters.append(it)
        switches.append(sw)
        filt.append(f)
    return (
        torch.cat(poses), torch.cat(iters), torch.cat(switches),
        tuple(torch.cat(col) for col in zip(*filt)),
    )


def run_slice(torch, scans, gt, dev, card):
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.odometry.fused import run_sequence_fused

    cfg = kitti_flagship_config()
    cap = cfg.prefilter.raw_cap
    clouds = [PointCloud.from_numpy(s, cap=cap) for s in scans]
    xyz = torch.stack([c.xyz for c in clouds]).to(dev)
    mask = torch.stack([c.mask for c in clouds]).to(dev)
    inten = torch.stack([c.intensity for c in clouds]).to(dev)
    stamps = (torch.arange(len(scans), dtype=torch.float32) * 0.1).to(dev)
    torch.cuda.synchronize()

    reset_launches()
    poses, iters, switches, filt = run_chunks(torch, run_sequence_fused, xyz, mask, stamps, inten, cfg)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on the main path: {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    est = poses.cpu().numpy().astype(np.float64)
    n = len(scans)
    if est.shape != (n, 4, 4) or not np.isfinite(est).all():
        raise AssertionError(f"poses: shape {est.shape}, finite {np.isfinite(est).all()}")
    fx, fi, fm = filt
    if tuple(fx.shape) != (n, 3, cfg.prefilter.out_cap) or tuple(fm.shape) != (n, cfg.prefilter.out_cap):
        raise AssertionError(f"filtered product shape {tuple(fx.shape)}")
    if not bool(torch.isfinite(fx.transpose(1, 2)[fm]).all()):
        raise AssertionError("filtered product has non-finite valid lanes")
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    t_err = devkit_t_err(gt_rel, est)
    drift = float(np.linalg.norm(est[-1, :3, 3] - gt_rel[-1, :3, 3]))
    log(f"  {n} scans tracked: devkit_t_err {t_err:.6f} (gate 0.010), final drift {drift:.4f} m "
        f"(gate {0.02 * n:.2f} m), keyframes {int(switches.sum())}, "
        f"mean Newton iterations/scan {float(iters[1:].float().mean()):.2f}")
    if not (t_err <= 0.010 and drift < 0.02 * max(1.0, n)):
        raise AssertionError("the trajectory fails the accuracy gates")

    # the same first four scans through the plain path on the CPU
    k = 4
    ref = run_sequence_fused(
        xyz[:k].cpu(), mask[:k].cpu(), stamps[:k].cpu(), cfg.odometry, cfg.prefilter,
        inten=inten[:k].cpu(),
    ).numpy()
    dev_t = float(np.abs(ref[:, :3, 3] - est[:k, :3, 3]).max())
    dev_r = float(np.abs(ref[:, :3, :3] - est[:k, :3, :3]).max())
    log(f"  first {k} scans vs the plain path on the CPU: max difference translation {dev_t:.3g} m, "
        f"rotation {dev_r:.3g} (tol 1e-4 each)")
    if dev_t > 1e-4 or dev_r > 1e-4:
        raise AssertionError("the card's trajectory departs from the plain path's")

    # warm pass, timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_chunks(torch, run_sequence_fused, xyz, mask, stamps, inten, cfg)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    log(f"  warm pass: {n} scans in {elapsed:.3f} s = {n / elapsed:.2f} scans/s ({card})")

    # host syncs of one chunk (torch warns at each synchronizing call)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_sequence_fused(xyz[:CHUNK], mask[:CHUNK], stamps[:CHUNK], cfg.odometry, cfg.prefilter,
                               inten=inten[:CHUNK])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    log(f"  host syncs: {syncs} in {CHUNK} scans = {syncs / CHUNK:.1f} per scan")

    idle = profile(torch, run_sequence_fused, xyz, mask, stamps, inten, cfg)
    summary = dict(
        scans_per_s=n / elapsed, devkit_t_err=t_err, drift_m=drift, syncs_per_scan=syncs / CHUNK,
        idle_share=idle,
    )
    return summary, launches


def profile(torch, run, xyz, mask, stamps, inten, cfg) -> float:
    """Device time by kernel over one 8-scan window, from the profiler, and
    the device's idle share: 1 - summed kernel time / the wall time of the
    same window run without the profiler (median of 3). The full table goes
    to _cache/chip_smoke/profile.txt."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    k = 8

    def window():
        run(xyz[:k], mask[:k], stamps[:k], cfg.odometry, cfg.prefilter, inten=inten[:k])
        torch.cuda.synchronize()

    window()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        window()
        walls.append((time.perf_counter() - t0) * 1e6)
    wall_us = float(np.median(walls))
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        profiled_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    dev_time = [(getattr(e, attr), e.key, e.count) for e in kernels]
    busy = sum(t for t, _, _ in dev_time)
    CACHE.mkdir(parents=True, exist_ok=True)
    (CACHE / "profile.txt").write_text(events.table(sort_by=attr, row_limit=200))
    if busy <= 0:
        log("  profile: no device time recorded (device split not measured)")
        return float("nan")
    log(f"  profile of {k} scans: wall {wall_us / 1e3:.2f} ms unprofiled ({profiled_us / 1e3:.2f} ms "
        f"profiled), device busy {busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}")
    for t, key, count in sorted(dev_time, reverse=True)[:12]:
        log(f"    {t / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")
    return 1 - busy / wall_us


# ----------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from lv_slam_tpu_torch.kernels import KERNELS, LIBRARY

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, {smi.splitlines()[0].split(',')[-1].strip()} limit"
    log(f"phase 1: {smi}; python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    LIBRARY.load()
    built = f"nvcc build {LIBRARY.build_seconds:.1f} s" if LIBRARY.build_seconds else "reused build"
    log(f"  kernels: {built} ({time.perf_counter() - t0:.1f} s to load) -> {LIBRARY.path.name}")
    build_log = LIBRARY.path.parent / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")

    scans, gt = load_scans(N_SCANS)
    log(f"  workload: {N_SCANS} scans, mean {np.mean([s.shape[0] for s in scans]):.0f} returns/scan")

    log("phase 2: kernels vs plain versions at main-path shapes")
    records = check_kernels(torch, scans, gt, dev)

    log("phase 3: the odometry slice end to end")
    summary, launches = run_slice(torch, scans, gt, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")

    kernels = [
        dict(
            name=name, route="cuda", source=k.source, replaces=k.replaces,
            launches=launches[name], **records[name],
        )
        for name, k in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
