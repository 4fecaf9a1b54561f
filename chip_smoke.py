#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`lv_slam_tpu_torch`) on one NVIDIA GPU.

    python chip_smoke.py

Phases, each of which raises on failure:
1. The card, the software, and the build of the hand-written kernels
   (`lv_slam_tpu_torch/csrc/*.cu`, compiled by nvcc at first use).
2. Every kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it: for the odometry one KITTI-density scan of 131072
   lanes, a 65536-lane scan-matching cloud and a 32768-leaf keyframe map; for
   the LFA raw scan 1's features, world maps filled with the features of
   scans 0-3 at their true poses, and scan 4's features as queries. Masks,
   picks and tables must be identical; fitted floats and the GN pose agree
   to the stated tolerances. Each kernel's time is device-only, the median
   over the whole calls among 20 in a torch.profiler trace, each call
   bounded by a marker kernel (`whole_calls`): its own launches (`ms`) and the
   plain version's whole device work (`plain_ms`); `bound_ms` is the larger of
   its inputs and outputs moved once at 3.35 TB/s (for the cell tables, only
   the rows and slots this call's data touches) and its operations at the
   67 TFLOP/s float32 CUDA-core peak (NVIDIA's H100 SXM data sheet).
3. The odometry slice: 64 simulated KITTI-density scans through
   `run_sequence_fused` under `kitti_flagship_config()`, in two chunks of 32
   carried by `init_state` / `return_state`, with `return_filtered`. Its
   kernels must have been launched; the trajectory must pass the reference
   benchmark's accuracy gates (devkit relative translation error <= 0.010,
   final drift under 2 % of the distance); its first four scans must agree
   with the plain path run on the CPU to 1e-4 m and 1e-4. A second, warm
   pass is timed, its host syncs are counted, and a profiled pass splits the
   device time.
4. The main path, the dlo -> LFA chain: the same 64 scans through
   `run_sequence_chain`, chunked and carried the same way. Every kernel must
   have been launched; the odometry must equal phase 3's poses to 1e-6; the
   refined trajectory must pass the same gates; its first four poses must
   agree with the plain path on the CPU to 1e-4; the LFA stage must add no
   host sync to the odometry's. A warm pass is timed, the device's idle
   share and the peak device memory are measured.
5. The full main path, dlo -> LFA -> ggo, in the pure-lidar configuration:
   170 scans (the reference benchmark's whole circle, so the drive closes
   its loop) through `run_sequence_chain` in chunks of 32, each chunk's
   filtered product and refined poses fed to
   `AsyncBackend(GlobalGraph(...))` with the benchmark's `make_backend`
   settings and no images (`bench.py:257-425`): `add_scan_batch(filtered=
   True)` per chunk, `optimize()` every 100 scans, then `finish()` and
   `drain()`. Every kernel must have been launched; the refined trajectory
   must pass the gates; at least one loop must close and the keyframes must
   number the reference record's 19; the final graph re-solved by the plain
   path on the CPU must agree to 1e-4. A warm pass is timed, host syncs are
   counted on the synchronous backend, and the device's idle share and peak
   memory are measured.
6. The full main path as the reference benchmark runs it, with the camera:
   the same 170 scans and chain, each chunk's camera images (the circle's
   `render_camera_image(world, gt[i], seed=5)`, `bench.py:183-186`) uploaded
   as a uint8 (32, 128, 256) device stack and fed with the chunk, and the
   backend given the shipped 512-word vocabulary from the port's own asset
   (`bench.py:256-315`): ORB (K12) for the keyframes each chunk opens in one
   call, candidates ranked by BoW and gated at 0.04, then verified. Gates:
   the refined trajectory's, the reference records' 19 keyframes, every one
   described, at least one loop, each with a visual score >= 0.04, BoW
   active, K12 launched. A warm pass is timed and a profiled pass gives the
   idle share. 6b runs the path once more without a vocabulary and without
   auto-training, the reference's raw ranking mode, which is where K12b
   (descriptor matching) runs: it must launch.
7. Standalone LFA, the reference's own `lfa_kitti` path (A-LOAM's
   scan-to-scan feature odometry feeding its mapping, no NDT frontend), on
   the whole 170-scan circle. 7a: the device-resident
   `run_sequence_lfa(xyz, mask, LfaConfig())` without odometry, in chunks of
   32 carried by `init_state`; gates: the accuracy gates, the first four
   poses equal to the plain path's on the CPU to 1e-4, K9g and K9k launched,
   no host sync inside a step; a warm pass is timed, the idle share and
   peak memory measured. 7b: the per-scan orchestrator
   `LvSlam(kitti_flagship_config(), use_dlo=False, vocabulary=<the port's
   asset>)`, each scan with its camera image, then `finalize()`; gates: the
   LFA poses' accuracy, the reference record's 19 keyframes, a loop, K9c
   launched. Both print the JAX reference's CPU records of the same runs
   beside their results.
8. The LUT paths, the reference's default odometry (`LvSlam`'s host DLO).
   8a: `DirectLidarOdometry(kitti_flagship_config().odometry, .prefilter)`
   per scan over the 170 scans as `bench.py`'s host cell drives it (3 warm
   scans, then timed, one upload per scan); gates: the accuracy gates, the
   JAX record's 34 keyframes (0, 5, ..., 165), no retry kept on a
   warm-started scan, K3L and K6L launched, the first four poses equal to
   those with K3L's, K6L's and K6G's twins on the card to 1e-4 and within the
   reference's own spread (1e-2) of the CPU plain path's (the two devices'
   plain map builds differ in a few rounding-noise leaves); scans/s, host
   syncs per scan, idle share. 8b: `LvSlam(kitti_flagship_config(),
   vocabulary=<the port's asset>)` per scan with camera images, then
   `finalize()`; gates: both pose
   sets' accuracy, the record's 34 DLO keyframes, 19 backend keyframes (0,
   9, ..., 162), all described, and its loop (135, 0). 8c: the fused
   odometry with `NDTConfig(table="lut")` on the first 64 scans in two
   chunks; gates: accuracy, the first four poses equal to the CPU plain
   path's to 1e-4. 8d: the generic `ndt_align` (DIRECT7, unweighted) of scan
   1's 65536-lane subsample onto scan 0's keyframe map from the first-scan
   guess (x = +1.5 m); gates: within 0.05 m and 0.02 rad of the true step,
   converged, equal to the run with K3L's and K6G's twins on the card to
   1e-4 (and to the CPU plain path's within 1e-2), K6G launched.

Phase 2 holds every kernel, those of the backend too (2c: the window dedup
K1b/K2, the batched NDT pass K13, the centroid grid K14 and the pose-graph
normal equations K15; 2d: ORB K12 on four keyframe images of the circle and
the descriptor matching K12b of one keyframe against eight; 2e: standalone
LFA's grid build K9g, its 2-point lines / 3-point planes K9k and the host
mapping's table build K9c; 2f: the dense LUT K3L, the LUT/SoA derivative
pass K6L and the generic one K6G on the host DLO's 32768-leaf keyframe map
and 65536-lane subsample, at the true pose and one 0.3 m off), against its
plain version at the shapes phases 5-8 give it.

The last lines are the kernels' JSON record (each kernel's launches are
counted on the run of the path that drives it: phase 5 for the lidar
kernels, 6 for K12, 6b for K12b, 7a for K9g and K9k, 7b for K9c, 8a for
K3L and K6L, 8d for K6G, named under `launch_phase`), the card's name and power limit, and
`{"ok": true, "device": {...}}`. Without a CUDA device the script exits
non-zero before it prints any result.
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

N_SCANS = 64     # phases 3-4: the first 64 scans of the circle
N_FULL = 170     # phase 5: the whole circle, as the reference benchmark drives it
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

REPS = 20  # profiled calls per kernel timing
WARM = 3   # unprofiled calls before them
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_PER_S = 67e12      # H100 SXM float32 outside the tensor cores

# each kernel's own device functions (csrc/), for reading its device time
# out of the profiler: everything else a wrapper launches is torch glue
DEVICE_FUNCTIONS = {
    "voxel_downsample": ("mark_runs", "reduce_runs"),
    "build_voxel_map": ("mark_leaves", "build_leaves"),
    "to_hash": ("hash_init", "hash_slot0", "hash_slot1", "hash_dropped", "hash_rows"),
    "ndt_derivatives_hash": ("ndt_partials", "ndt_finish"),
    "extract_features": ("fill_best", "project", "rows", "compact"),
    "insert_cell_table": ("insert_keys", "insert_keep", "insert_place"),
    "crop_cell_table": ("crop",),
    "lines_from_fit": ("lines",),
    "planes_from_fit": ("planes",),
    "gn_solve": ("gn",),
    "voxel_dedup_first": ("dedup_keys", "dedup_mark", "dedup_compact"),
    "window_group_filtered_fn": ("window_keys", "dedup_mark", "dedup_compact"),
    "_fused_verify_fn": ("ndt_partials", "ndt_finish"),
    "build_centroid_grid": ("grid_mark", "grid_reduce"),
    "nn_sq_dists": ("grid_query", "grid_finish"),
    "_chi2_and_normal": ("se3_edges", "chi2_sum"),
    "_detect_pyramid_batch": ("orb_level0", "orb_halve", "orb_pixels", "orb_keys", "orb_describe"),
    "match_scores_batch": ("orb_match",),
    "build_grid": ("knn_grid_init", "knn_grid_cells", "knn_grid_keys", "knn_grid_gather"),
    "knn": ("knn_query", "knn_lines", "knn_planes"),
    "build_cell_table": ("table_keys", "table_zero", "table_place"),
    "build_lut": ("lut_fill", "lut_scatter"),
    "ndt_derivatives_soa": ("ndt_lut_partials", "ndt_finish"),
    "ndt_derivatives": ("ndt_generic_partials", "ndt_finish"),
}


def _is_function(key: str, fn: str) -> bool:
    """Whether a profiler kernel name (demangled or Itanium-mangled) is `fn`."""
    return f"::{fn}(" in key or key.startswith(f"{fn}(") or f"{len(fn)}{fn}E" in key


MARKER = "spin_kernel"  # the device function of torch.cuda._sleep, launched between timed calls


def whole_calls(names):
    """Indices of the device events of each whole call, from the
    time-ordered event names of a trace in which a marker precedes every call
    and follows the last. The trace may lack records (one on the card lost
    12 of 40 kernels of 20 calls), so a call counts only if its device work
    reads as most calls' does; a lost marker merges two calls, which then
    read as no single call does."""
    calls, current = [], None
    for i, name in enumerate(names):
        if MARKER in name:
            if current is not None:
                calls.append(current)
            current = []
        elif current is not None:
            current.append(i)
    if not calls:
        return []
    shapes = [tuple(names[i] for i in call) for call in calls]
    common = max(set(shapes), key=shapes.count)
    return [call for call, shape in zip(calls, shapes) if shape == common]


def device_ms(torch, fn, functions=(), reps: int = REPS):
    """(ms of the named device functions, ms of all device work, calls
    counted) per call of `fn`: medians over the whole calls among `reps`
    after a warm-up, from torch.profiler. A trace with whole calls for at
    most half of `reps` is taken again, twice at most."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.cuda._sleep(1000)
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted(
            (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start,
        )
        calls = whole_calls([e.name for e in events])
        if 2 * len(calls) > reps:
            break
    else:
        raise AssertionError(f"three traces held whole device work for at most {reps // 2} of {reps} calls")
    own = [[events[i] for i in call if any(_is_function(events[i].name, f) for f in functions)] for call in calls]
    if functions and not own[0]:
        raise AssertionError(f"the profiler saw no device time of {functions}")

    def median_ms(groups) -> float:
        return float(np.median([sum(e.time_range.elapsed_us() for e in g) for g in groups])) / 1e3

    return median_ms(own), median_ms([[events[i] for i in call] for call in calls]), len(calls)


def bound(n_bytes: float, n_ops: float):
    """(least ms, what bounds it) for moving `n_bytes` and doing `n_ops`."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def on_copies(table, fn):
    """A `device_ms` callable that runs `fn` on its own copy of the cell
    table `table` at each call, so every timed call does the same work. The
    copies are made here, before the timing."""
    from lv_slam_tpu_torch.ops.knn import CellTable

    copies = iter([CellTable(table.table.clone(), table.cell_size) for _ in range(WARM + REPS)])
    return lambda: fn(next(copies))


def measure(torch, records, name, kernel_fn, plain_fn, err, n_bytes, n_ops):
    """Times `name` device-only and records it beside its bound."""
    ms, wrapper_ms, n_kernel = device_ms(torch, kernel_fn, DEVICE_FUNCTIONS[name])
    _, plain_ms, n_plain = device_ms(torch, plain_fn)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    records[name] = dict(
        max_abs_err=float(err), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, wrapper_device_ms=wrapper_ms,
    )
    log(f"    {name}: kernel {ms:.4f} ms (wrapper with its torch glue {wrapper_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}) [device-only, median of "
        f"{n_kernel} / {n_plain} whole calls of {REPS}]")


def check_kernels(torch, scans, gt, dev):
    """Phase 2a: the odometry's kernels vs their plain versions at main-path shapes."""
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
    log(f"  voxel_downsample: {int(got.mask.sum())} voxels of {int(band.mask.sum())} returns, "
        f"mask and lane order identical, max abs err {err:.3g} (tol 1e-5)")
    n_in, n_vox = int(band.mask.sum()), int(got.mask.sum())
    measure(torch, records, "voxel_downsample", k1, p1, err,
            nbytes(band.xyz, band.intensity, band.mask, got.xyz, got.intensity, got.mask),
            4 * n_in + 4 * n_vox)  # 4 adds per point, 4 divisions per voxel

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
    log(f"  build_voxel_map: {int(vm.n_leaves)} valid leaves, validity identical; "
        f"max abs err mean {err_mean:.3g} (tol 1e-5), icov {err_icov:.3g} (tol {icov_tol:.3g}), "
        f"weight {err_w:.3g} (tol {w_tol:.3g})")
    n_pts = int(filtered.mask.sum())
    n_occupied = int(torch.unique(voxel_map._leaf_sort(filtered, ndt.resolution, ndt.lut_extent)[0]).numel())
    measure(torch, records, "build_voxel_map", k2, p2, err_icov,
            nbytes(filtered.xyz, filtered.mask, vm.means, vm.icovs, vm.weights, vm.normals, vm.valid),
            25 * n_pts + 300 * n_occupied)  # centered moments per point; eigh + inverse per leaf

    # kernel 3: the same VoxelMap -> 131072 x 32 table, bit-exact
    k3 = lambda: ndt_hash.to_hash(vm, ndt.hash_buckets_per_leaf)  # noqa: E731
    p3 = lambda: ndt_hash.to_hash_ref(vm, ndt.hash_buckets_per_leaf)  # noqa: E731
    hm, hm_ref = k3(), p3()
    if not torch.equal(hm.table.view(torch.int32), hm_ref.table.view(torch.int32)):
        raise AssertionError("to_hash: table is not bit-identical to the plain version")
    if int(hm.n_dropped) != int(hm_ref.n_dropped):
        raise AssertionError("to_hash: n_dropped differs")
    log(f"  to_hash: table {tuple(hm.table.shape)} bit-identical, n_dropped {int(hm.n_dropped)}")
    measure(torch, records, "to_hash", k3, p3, 0.0,
            nbytes(vm.means, vm.icovs, vm.weights, vm.valid, hm.table), 20 * int(vm.n_leaves))

    # kernel 4: scan 1's 65536 lanes against scan 0's map, at the true pose
    src_mid = prefilter.voxel_downsample(clouds(1), pf.downsample_resolution, pf.out_cap)
    src = prefilter.stride_subsample(src_mid, cfg.odometry.scan_matching_cap)
    xs = src.masked_xyz().T.contiguous()
    rel = torch.from_numpy((np.linalg.inv(gt[0]) @ gt[1]).astype(np.float32)).to(dev)
    gauss = make_gauss_params(ndt.resolution, ndt.outlier_ratio)
    err4, fns = 0.0, {}
    for hood, weighted in (("DIRECT1", True), ("DIRECT7", False)):
        args = (hm, xs, src.mask.contiguous(), rel, gauss, voxel_map.neighborhood_offsets(hood, dev), weighted)
        k4 = lambda args=args: ndt_hash.ndt_derivatives_hash(*args)  # noqa: E731
        p4 = lambda args=args: ndt_hash.ndt_derivatives_hash_ref(*args)  # noqa: E731
        (s1, g1, h1), (s2, g2, h2) = k4(), p4()
        es = abs(float(s1) - float(s2))
        eg, eh = float((g1 - g2).abs().max()), float((h1 - h2).abs().max())
        tg, th = 2e-5 * float(g2.abs().max()), 2e-5 * float(h2.abs().max())
        if es > 1e-4 * abs(float(s2)) or eg > tg or eh > th:
            raise AssertionError(f"ndt_derivatives_hash {hood}: errors score {es} grad {eg} hess {eh}")
        err4 = max(err4, eg, eh)
        fns[hood] = (k4, p4)
        log(f"  ndt_derivatives_hash {hood} weighted={weighted}: score {float(s2):.1f}, "
            f"errors score {es:.3g} (tol {1e-4 * abs(float(s2)):.3g}), grad {eg:.3g} (tol {tg:.3g}), "
            f"hess {eh:.3g} (tol {th:.3g})")
    n_src = int(src.mask.sum())
    # the whole table is an input; ~330 operations per lane and offset (DIRECT1)
    measure(torch, records, "ndt_derivatives_hash", *fns["DIRECT1"], err4,
            nbytes(hm.table, xs, src.mask) + 43 * 4, 330 * n_src)
    return records


def check_lfa_kernels(torch, scans, gt, dev):
    """Phase 2b: the LFA's kernels vs their plain versions at main-path shapes."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.lfa import features, registration
    from lv_slam_tpu_torch.lfa.fused import _GRID_CELL, _n_buckets
    from lv_slam_tpu_torch.ops import knn

    full = kitti_flagship_config()
    cfg = full.lfa
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    poses = [torch.from_numpy(p).to(dev) for p in gt_rel[:5]]
    raw = [PointCloud.from_numpy(scans[i], cap=full.prefilter.raw_cap, device=dev) for i in range(5)]
    records = {}

    def identical(a, b) -> bool:
        return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                               y.view(torch.int32) if y.dtype == torch.float32 else y)
                   for x, y in zip(a, b) if isinstance(x, torch.Tensor))

    # kernel 8: raw scan 1 -> the four feature clouds
    k8 = lambda: features.extract_features(raw[1], cfg)  # noqa: E731
    p8 = lambda: features.extract_features_ref(raw[1], cfg)  # noqa: E731
    got, want = k8(), p8()
    if not identical(got, want):
        raise AssertionError("extract_features: feature clouds differ from the plain version")
    counts = [int(m.sum()) for m in got[1::2]]
    log(f"  extract_features: sharp / less sharp / flat / less flat {counts} of lanes "
        f"{[m.numel() for m in got[1::2]]}, masks and points bit-identical")
    n_valid = int(raw[1].mask.sum())
    cells = cfg.scan_line * features.N_AZIMUTH
    k_ls, k_lf = features._picks(cfg)
    measure(torch, records, "extract_features", k8, p8, 0.0,
            nbytes(raw[1].xyz, raw[1].mask, *got),
            # projection ~50 per lane; window, extrema ~70 per cell; each top-k round scans its sector
            50 * n_valid + 70 * cells + (k_ls + k_lf) * cells)

    # kernel 9a: the world maps from scans 0-3's features at their true poses
    feats = [features.extract_features(c, cfg) for c in raw]
    res = (cfg.mapping_line_resolution, cfg.mapping_plane_resolution)

    def empty():
        return [
            knn.empty_cell_table(_n_buckets(cfg, cfg.map_edge_cap), cfg.knn_slots, _GRID_CELL, dev),
            knn.empty_cell_table(_n_buckets(cfg, cfg.map_planar_cap), cfg.knn_slots, _GRID_CELL, dev),
        ]

    def world(f, pose):
        return (
            (se3.transform_points(pose, f.less_sharp), f.less_sharp_mask),
            (se3.transform_points(pose, f.less_flat), f.less_flat_mask),
        )

    def stored(t) -> int:
        return int((t.table.view(-1, 4)[:, 3] > 0.5).sum())

    tables = {"kernel": empty(), "plain": empty()}
    for i in range(4):
        for j, (pts, m) in enumerate(world(feats[i], poses[i])):
            knn.insert_cell_table_(tables["kernel"][j], pts, m, res[j])
            knn.insert_cell_table_ref_(tables["plain"][j], pts, m, res[j])
    for j, name in enumerate(("edge", "surf")):
        if not identical(tables["kernel"][j], tables["plain"][j]):
            raise AssertionError(f"insert_cell_table: the {name} map differs from the plain version")
    edge, surf = tables["kernel"]  # the maps of scans 0-3
    n_stored = [stored(edge), stored(surf)]
    # the timed insert: scan 4's surf batch into the map of scans 0-3, as the chain's step inserts it
    pts4, m4 = world(feats[4], poses[4])[1]
    grown = {route: knn.CellTable(t[1].table.clone(), t[1].cell_size) for route, t in tables.items()}
    knn.insert_cell_table_(grown["kernel"], pts4, m4, res[1])
    knn.insert_cell_table_ref_(grown["plain"], pts4, m4, res[1])
    if not identical(grown["kernel"], grown["plain"]):
        raise AssertionError("insert_cell_table: scan 4's insert differs from the plain version")
    n_kept = stored(grown["kernel"]) - n_stored[1]
    log(f"  insert_cell_table: edge / surf maps {tuple(edge.table.shape)} / {tuple(surf.table.shape)} "
        f"after scans 0-3 hold {n_stored} points, scan 4 adds {n_kept} of its {int(m4.sum())} surf "
        f"points; every map bit-identical to the plain version")
    # bytes it must move: the batch, one bucket row per distinct bucket it
    # touches, one 16-byte slot per point it stores
    khi, _ = knn._insert_keys_ref(pts4, m4, surf.table.shape[0], res[1], surf.cell_size)
    b4 = khi >> 32
    n_rows = int(torch.unique(b4[b4 < surf.table.shape[0]]).numel())
    k9 = on_copies(surf, lambda t: knn.insert_cell_table_(t, pts4, m4, res[1]))
    p9 = on_copies(surf, lambda t: knn.insert_cell_table_ref_(t, pts4, m4, res[1]))
    measure(torch, records, "insert_cell_table", k9, p9, 0.0,
            nbytes(pts4, m4) + n_rows * surf.table.shape[1] * 4 + 16 * n_kept, 20 * pts4.shape[0])

    # kernel 9b: crop the surf map around scan 4's pose, gate open
    center = poses[4][:3, 3].contiguous()
    last = center + 1e6
    crop_k = knn.CellTable(surf.table.clone(), surf.cell_size)
    crop_p = knn.CellTable(surf.table.clone(), surf.cell_size)
    ck = knn.crop_cell_table_(crop_k, center, cfg.crop_radius, last, cfg.crop_interval)
    cp = knn.crop_cell_table_ref_(crop_p, center, cfg.crop_radius, last, cfg.crop_interval)
    if not identical((ck, crop_k.table), (cp, crop_p.table)):
        raise AssertionError("crop_cell_table: table or crop center differs from the plain version")
    n_dropped = n_stored[1] - stored(crop_k)
    log(f"  crop_cell_table: {stored(crop_k)} of {n_stored[1]} surf points within {cfg.crop_radius} m, "
        f"table and crop center bit-identical")
    # bytes it must move: one read of the table and the centers, one 4-byte
    # flag per slot it frees, the new crop center
    k9b = on_copies(surf, lambda t: knn.crop_cell_table_(t, center, cfg.crop_radius, last, cfg.crop_interval))
    p9b = on_copies(surf, lambda t: knn.crop_cell_table_ref_(t, center, cfg.crop_radius, last, cfg.crop_interval))
    measure(torch, records, "crop_cell_table", k9b, p9b, 0.0,
            nbytes(surf.table, center, last) + 4 * n_dropped + 12, 10 * surf.table.numel() // 4)

    # kernel 10: scan 4's features at its true pose against the maps
    f4 = feats[4]
    ye = se3.transform_points(poses[4], f4.less_sharp)
    ys = se3.transform_points(poses[4], f4.less_flat)
    fields = {}
    for name, fn, ref, y, m, table in (
        ("lines_from_fit", registration.lines_from_fit, registration.lines_from_fit_ref, ye,
         f4.less_sharp_mask, edge),
        ("planes_from_fit", registration.planes_from_fit, registration.planes_from_fit_ref, ys,
         f4.less_flat_mask, surf),
    ):
        k10 = lambda fn=fn, y=y, m=m, table=table: fn(y, m, table, k=cfg.knn_k)  # noqa: E731
        p10 = lambda ref=ref, y=y, m=m, table=table: ref(y, m, table, k=cfg.knn_k)  # noqa: E731
        got, want = k10(), p10()
        if not torch.equal(got.valid, want.valid):
            raise AssertionError(f"{name}: {int((got.valid != want.valid).sum())} accept decisions differ")
        # gn_solve reads every lane, a rejected one with weight 0, and 0 * NaN
        # is NaN: the fitted floats must be finite on every lane. They are
        # compared on accepted queries: a rejected fit may be a degenerate
        # eigenvector, which the two routes may pick differently
        if not all(bool(torch.isfinite(a).all()) for a in got[:2]):
            raise AssertionError(f"{name}: non-finite fitted floats")
        v = want.valid
        err = max(float((a[v] - b[v]).abs().max()) for a, b in zip(got[:2], want[:2]))
        if err > 1e-5:
            raise AssertionError(f"{name}: max abs err {err} > 1e-5")
        fields[name] = got
        log(f"  {name}: {int(got.valid.sum())} of {int(m.sum())} queries accepted, decisions identical, "
            f"fitted floats finite on every lane, max abs err {err:.3g} on accepted ones (tol 1e-5)")
        measure(torch, records, name, k10, p10, err, nbytes(y, m, table.table, *got),
                1500 * y.shape[0])  # 8 x 6 candidates ~25 each, one eigh ~300

    # kernel 11: GN from those fields, seeded 0.3 m off the true pose
    seed = poses[4].clone()
    seed[0, 3] += 0.3
    lines, planes = fields["lines_from_fit"], fields["planes_from_fit"]
    gn_args = (seed, f4.less_sharp, lines, f4.less_flat, planes, cfg.mapping_max_iterations)
    k11 = lambda: registration.gn_solve(*gn_args)  # noqa: E731
    p11 = lambda: registration.gn_solve_ref(*gn_args)  # noqa: E731
    got, want = k11(), p11()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > 1e-4:
        raise AssertionError(f"gn_solve: max abs err {err} > 1e-4")
    moved = float(torch.linalg.vector_norm(got[:3, 3] - poses[4][:3, 3]))
    log(f"  gn_solve: {cfg.mapping_max_iterations} iterations over {lines.valid.numel()} + "
        f"{planes.valid.numel()} lanes, max abs err {err:.3g} (tol 1e-4); the 0.3 m seed "
        f"ends {moved:.4f} m from the true pose")
    ne, ns = lines.valid.numel(), planes.valid.numel()
    measure(torch, records, "gn_solve", k11, p11, err,
            nbytes(seed, f4.less_sharp, *lines, f4.less_flat, *planes) + 64,
            cfg.mapping_max_iterations * (150 * ne + 90 * ns))
    return records


def check_backend_kernels(torch, scans, gt, dev):
    """Phase 2c: the backend's kernels vs their plain versions at the shapes
    phase 5 gives them: a 16-scan window group of filtered KITTI-density
    scans (2.1 M rows in, 131072 out), the merge of two partials, 8 loop
    candidates of 131072 lanes against the 1 m map of that keyframe cloud,
    its 0.25 m centroid grid, and a 64-node, 128-edge pose graph."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.graph import pose_graph
    from lv_slam_tpu_torch.ops import ndt_hash, nn, prefilter, voxel_map
    from lv_slam_tpu_torch.ops.ndt import make_gauss_params
    from lv_slam_tpu_torch.pipeline import window

    pf = kitti_flagship_config().prefilter
    res, kf_cap = pf.downsample_resolution, 131072
    records = {}

    def filtered(i):
        raw = PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev)
        band = prefilter.distance_filter(raw, pf.distance_near_thresh, pf.distance_far_thresh)
        return prefilter.voxel_downsample(band, pf.downsample_resolution, pf.out_cap)

    def identical(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    scans_f = [filtered(i) for i in range(24)]

    def group(first, length):
        rows = scans_f[first:first + length]
        chunk = (torch.stack([c.xyz.T for c in rows]).contiguous(), torch.stack([c.intensity for c in rows]),
                 torch.stack([c.mask for c in rows]))
        rels = torch.from_numpy(rel[first:first + length]).to(dev)
        return (*chunk, 0, rels, torch.ones(length, dtype=torch.bool, device=dev), res, kf_cap)

    # kernel 2: scans 0-15 moved into scan 0's frame, first point per voxel
    g16 = group(0, 16)
    k2 = lambda: window.window_group_filtered(*g16)  # noqa: E731
    p2 = lambda: window.window_group_filtered_ref(*g16)  # noqa: E731
    keyframe, want = k2(), p2()
    if not identical(keyframe, want):
        raise AssertionError("window_group_filtered_fn: kept lanes differ from the plain version")
    n_in, n_kept = int(g16[2].sum()), int(keyframe.mask.sum())
    log(f"  window_group_filtered_fn: 16 x {g16[0].shape[2]} rows, {n_in} valid -> {n_kept} voxels "
        f"in {keyframe.cap} lanes, identical to the plain version")
    measure(torch, records, "window_group_filtered_fn", k2, p2, 0.0,
            nbytes(*g16[:3], g16[4], g16[5]) + 17 * keyframe.cap, 20 * g16[2].numel())

    # kernel 1b: that partial merged with scans 16-23's (a window across chunks)
    part2 = window.window_group_filtered(*group(16, 8))
    both = PointCloud(*(torch.cat([a, b]) for a, b in zip(keyframe, part2)))
    k1b = lambda: prefilter.voxel_dedup_first(both, res, kf_cap)  # noqa: E731
    p1b = lambda: prefilter.voxel_dedup_first_ref(both, res, kf_cap)  # noqa: E731
    got, want = k1b(), p1b()
    if not identical(got, want):
        raise AssertionError("voxel_dedup_first: kept lanes differ from the plain version")
    log(f"  voxel_dedup_first: {both.cap} rows, {int(both.mask.sum())} valid -> {int(got.mask.sum())} voxels, "
        f"identical to the plain version")
    measure(torch, records, "voxel_dedup_first", k1b, p1b, 0.0, nbytes(*both) + 17 * got.cap,
            10 * both.cap)

    # kernel 13: 8 candidates (scans 2, 4, .., 16, 0.2 m off their true
    # pose) against the keyframe cloud's 1 m map, and the 4 m rung's
    # strided lanes
    cands = [scans_f[i] for i in range(2, 18, 2)]
    guesses = torch.from_numpy(rel[2:18:2].copy()).to(dev)
    guesses[:, 0, 3] += 0.2
    offsets = voxel_map.neighborhood_offsets("DIRECT7", dev)
    err13 = 0.0
    for r, stride in ((4.0, 4), (1.0, 1)):
        hm = ndt_hash.to_hash(voxel_map.build_voxel_map(keyframe, r, leaf_cap=16384, lut_extent=256))
        xs = torch.stack([c.masked_xyz().T[:, ::stride] for c in cands]).contiguous()
        mask = torch.stack([c.mask[::stride] for c in cands]).contiguous()
        args = (hm, xs, mask, guesses, make_gauss_params(r), offsets, False)
        k13 = lambda args=args: ndt_hash.ndt_derivatives_hash_batched(*args)  # noqa: E731
        p13 = lambda args=args: ndt_hash.ndt_derivatives_hash_batched_ref(*args)  # noqa: E731
        (s1, g1, h1), (s2, g2, h2) = k13(), p13()
        es = float((s1 - s2).abs().max())
        eg, eh = float((g1 - g2).abs().max()), float((h1 - h2).abs().max())
        # partial sums over up to 8 x 131072 lanes x 7 offsets in another
        # order than the plain pass's; near the optimum the gradient is a
        # cancelling sum (on an H100: 2.41 against a largest entry of 1.2e5)
        ts, tg, th = 1e-4 * float(s2.abs().max()), 1e-4 * float(g2.abs().max()), 2e-5 * float(h2.abs().max())
        if es > ts or eg > tg or eh > th:
            raise AssertionError(f"_fused_verify_fn at {r} m: errors score {es} grad {eg} hess {eh}")
        err13 = max(err13, eg, eh)
        log(f"  _fused_verify_fn (batched K6, DIRECT7) at {r} m: {len(cands)} x {xs.shape[2]} lanes, "
            f"errors score {es:.3g} (tol {ts:.3g}), grad {eg:.3g} (tol {tg:.3g}), hess {eh:.3g} (tol {th:.3g})")
    n_lanes = int(mask.sum())
    # the table is an input; per lane 7 probes (~40 operations) and ~330 per hit
    measure(torch, records, "_fused_verify_fn", k13, p13, err13, nbytes(hm.table, xs, mask, guesses),
            (7 * 40 + 330) * n_lanes)

    # kernel 14: the keyframe cloud's 0.25 m grid, then the 8 candidates'
    # fitness at their guesses
    k14 = lambda: nn.build_centroid_grid(keyframe, 0.25)  # noqa: E731
    p14 = lambda: nn.build_centroid_grid_ref(keyframe, 0.25)  # noqa: E731
    grid, want = k14(), p14()
    if not (torch.equal(grid.keys, want.keys) and torch.equal(grid.counts, want.counts)):
        raise AssertionError("build_centroid_grid: keys or counts differ from the plain version")
    v = want.counts > 0
    err = float(((grid.centroids[v] - want.centroids[v]).abs() / want.centroids[v].abs().clamp(min=1.0)).max())
    if err > 1e-6:
        raise AssertionError(f"build_centroid_grid: centroid error {err} > 1e-6")
    log(f"  build_centroid_grid: {n_kept} points -> {int(v.sum())} of {grid.keys.shape[0]} leaves, keys and "
        f"counts identical, centroids within {err:.3g} (tol 1e-6 relative)")
    measure(torch, records, "build_centroid_grid", k14, p14, err,
            nbytes(keyframe.xyz, keyframe.mask, grid.keys, grid.centroids, grid.counts), 4 * n_kept)

    batch = PointCloud(torch.stack([c.xyz for c in cands]), torch.stack([c.intensity for c in cands]),
                       torch.stack([c.mask for c in cands]))
    moved = cands[0].transformed(guesses[0])
    d2, d2_ref = nn.nn_sq_dists(grid, moved.masked_xyz(), moved.mask), nn.nn_sq_dists_ref(
        grid, moved.masked_xyz(), moved.mask)
    hit = torch.isfinite(d2_ref)
    if not torch.equal(torch.isfinite(d2), hit):
        raise AssertionError("nn_sq_dists: the hit set differs from the plain version")
    err_d2 = float(((d2[hit] - d2_ref[hit]).abs() / d2_ref[hit].clamp(min=1e-12)).max())
    kq = lambda: nn.fitness_batch(grid, batch, guesses)  # noqa: E731
    pq = lambda: nn.fitness_batch_ref(grid, batch, guesses)  # noqa: E731
    fit, fit_ref = kq(), pq()
    err_fit = float(((fit - fit_ref).abs() / fit_ref.abs()).max())
    if err_d2 > 1e-6 or err_fit > 1e-5:
        raise AssertionError(f"nn_sq_dists: d2 error {err_d2} (tol 1e-6), fitness error {err_fit} (tol 1e-5)")
    log(f"  nn_sq_dists: hit set identical ({int(hit.sum())} of {int(moved.mask.sum())} lanes), d2 within "
        f"{err_d2:.3g} (tol 1e-6 relative); fitness of {len(cands)} candidates {fit.tolist()} within "
        f"{err_fit:.3g} (tol 1e-5 relative)")
    n_q = int(batch.mask.sum())
    measure(torch, records, "nn_sq_dists", kq, pq, err_fit,
            nbytes(batch.xyz, batch.mask, guesses, grid.keys, grid.centroids, fit), 27 * 60 * n_q)

    # kernel 15: 64 keyframes (every other pose of the circle, 0.05 m / 0.01
    # rad of noise), 63 odometry edges and loops from the last 16 to the first
    rng = np.random.default_rng(SEED)
    g = pose_graph.empty_graph(64, 128, 16, 8, 8, 16)
    kf = rel[::2][:64].astype(np.float64)
    info = np.diag([2.0] * 3 + [10.0] * 3)

    def noise(scale_t, scale_r):
        d = np.r_[rng.normal(0, scale_t, 3), rng.normal(0, scale_r, 3)].astype(np.float32)
        return se3.exp_se3(torch.from_numpy(d)).double().numpy()

    for i in range(64):
        pose_graph.add_node(g, i, kf[i] @ noise(0.05, 0.01))
    n_edges = 0
    for i in range(1, 64):
        pose_graph.add_se3_edge(g, n_edges, i, i - 1, np.linalg.inv(kf[i]) @ kf[i - 1] @ noise(0.01, 0.002),
                                info, huber=1.0)
        n_edges += 1
    for i in range(48, 64, 2):
        pose_graph.add_se3_edge(g, n_edges, i, (i - 48) // 2, np.linalg.inv(kf[i]) @ kf[(i - 48) // 2], info,
                                huber=1.0)
        n_edges += 1
    dg = pose_graph.to_device(g, dev)
    k15 = lambda: pose_graph._chi2_and_normal(dg, dg.poses, True)  # noqa: E731
    p15 = lambda: pose_graph._chi2_and_normal_ref(dg, dg.poses, True)  # noqa: E731
    (c1, h1, b1), (c2, h2, b2) = k15(), p15()
    # the judge is the plain version in float64: residuals are centimetres
    # left from ~50 m coordinates, so float32 rounding alone moves b by
    # ~3e-5 of its scale. The kernel's error may be twice the float32 plain
    # version's, plus 1e-6 of the scale (atomicAdd order)
    dg64 = dg._replace(poses=dg.poses.double(), e_meas=dg.e_meas.double(), e_info=dg.e_info.double(),
                       e_huber=dg.e_huber.double())
    c64, h64, b64 = pose_graph._chi2_and_normal_ref(dg64, dg64.poses, True)

    def errs(c, hh, bb):
        return (abs(float(c) - float(c64)), float((hh.double() - h64).abs().max()),
                float((bb.double() - b64).abs().max()))

    got_e, plain_e = errs(c1, h1, b1), errs(c2, h2, b2)
    scale = (abs(float(c64)), float(h64.abs().max()), float(b64.abs().max()))
    tols = [2 * p + 1e-6 * sc for p, sc in zip(plain_e, scale)]
    if any(g_ > t_ for g_, t_ in zip(got_e, tols)):
        raise AssertionError(f"_chi2_and_normal: errors vs float64 (chi2, H, b) {got_e}, tolerances {tols}")
    ec, eh, eb = got_e
    n = h1.shape[0]
    log(f"  _chi2_and_normal: {n_edges} edges, H {n} x {n}; errors against the float64 plain version: chi2 "
        f"{ec:.3g} (float32 plain {plain_e[0]:.3g}, tol {tols[0]:.3g}), H {eh:.3g} ({plain_e[1]:.3g}, tol "
        f"{tols[1]:.3g}), b {eb:.3g} ({plain_e[2]:.3g}, tol {tols[2]:.3g}); scales {scale}")
    measure(torch, records, "_chi2_and_normal", k15, p15, max(eh, eb),
            nbytes(dg.poses, dg.e_i, dg.e_j, dg.e_meas, dg.e_info, dg.e_huber, dg.e_valid, h1, b1),
            3000 * n_edges)
    hg, bg = pose_graph._apply_gauge(h1, b1, dg)
    damped = hg + 1e-4 * torch.diag(torch.clamp(torch.diagonal(hg), min=1e-6))

    def solve():
        chol, _ = torch.linalg.cholesky_ex(damped)
        return torch.cholesky_solve(-bg[:, None], chol)

    _, chol_ms, _ = device_ms(torch, solve)
    records["_chi2_and_normal"]["cholesky_ms"] = chol_ms
    log(f"    the LM's dense solve (cholesky_ex + cholesky_solve, a library call) on the {n} x {n} system: "
        f"{chol_ms:.4f} ms device-only")
    return records


def keyframe_openers(gt, n: int):
    """The first `n` scans that open a keyframe window on the ground-truth
    drive, under the backend's default keyframe gate."""
    from lv_slam_tpu_torch.config import GraphConfig
    from lv_slam_tpu_torch.graph.keyframe import KeyframeUpdater

    cfg = GraphConfig()
    updater = KeyframeUpdater(cfg.keyframe_delta_trans, cfg.keyframe_delta_angle)
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float64)
    return [i for i in range(len(gt)) if updater.update(gt_rel[i])][:n]


def render_images(gt, indices):
    """The reference benchmark's camera images of scans `indices`: uint8 (n, 128, 256)."""
    from lv_slam_tpu_torch.io import synthetic

    world = synthetic.make_world(seed=SEED)
    return np.stack([synthetic.render_camera_image(world, gt[i], seed=SEED) for i in indices]).astype(np.uint8)


def check_orb_kernels(torch, gt, dev):
    """Phase 2d: ORB (K12) on four keyframe images of the circle, as one
    chunk's batch, and the matching (K12b) of the first keyframe's
    descriptors against eight sets from that output, padded to the
    descriptor cap as the loop detector pads them."""
    from lv_slam_tpu_torch.config import LoopDetectorConfig
    from lv_slam_tpu_torch.ops import orb

    cap = LoopDetectorConfig().descriptor_cap
    openers = keyframe_openers(gt, 4)
    images = torch.from_numpy(render_images(gt, openers)).to(dev)
    k_levels = orb.OrbExtractor(max_features=cap)._k_levels(*images.shape[1:])
    records = {}

    k12 = lambda: orb.detect_pyramid_batch(images, k_levels)  # noqa: E731
    p12 = lambda: orb.detect_pyramid_batch_ref(images, k_levels)  # noqa: E731
    got, want = k12(), p12()
    cpu = orb.detect_pyramid_batch_ref(images.cpu(), k_levels)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        rows = (got != want).any(dim=2)
        raise AssertionError(f"_detect_pyramid_batch: {int(rows.sum())} of {rows.numel()} rows differ from the "
                             f"plain version (keypoints, valid flags or descriptor bits)")
    if not torch.equal(got.cpu(), cpu):
        raise AssertionError("_detect_pyramid_batch: the card's rows differ from the plain version on the CPU")
    valid = got[:, :, 36].bool()
    per_level, start = [], 0
    for k in k_levels:
        per_level.append(valid[:, start:start + k].sum(dim=1).tolist())
        start += k
    log(f"  _detect_pyramid_batch: scans {openers}, {tuple(images.shape)} uint8 -> {tuple(got.shape)} rows "
        f"(levels {k_levels}), valid per level and image {per_level}; keypoints, valid flags and every "
        f"descriptor bit identical to the plain version on the card and on the CPU")
    n_pixels = sum(images.shape[0] * (images.shape[1] >> lv) * (images.shape[2] >> lv) for lv in range(len(k_levels)))
    # per pixel ~110 (16-point circle, run test, score, suppression, blur);
    # per row ~9400 (the 709-pixel disc moments, 256 rotated, rounded pairs)
    measure(torch, records, "_detect_pyramid_batch", k12, p12, 0.0, nbytes(images, got),
            110 * n_pixels + 9400 * got.shape[0] * got.shape[1])

    sets = [d for d, _ in orb.unpack_rows(got.cpu().numpy(), cap)]
    padded = [orb._padded(d, cap) for d in sets]
    a, a_mask = (torch.from_numpy(v).to(dev) for v in padded[0])
    order = [(1 + i) % len(sets) for i in range(8)]  # the other keyframes first, then the query's own
    bs = torch.from_numpy(np.stack([padded[i][0] for i in order])).to(dev)
    b_masks = torch.from_numpy(np.stack([padded[i][1] for i in order])).to(dev)
    k12b = lambda: orb.match_scores_masked(a, a_mask, bs, b_masks)  # noqa: E731
    p12b = lambda: orb.match_scores_masked_ref(a, a_mask, bs, b_masks)  # noqa: E731
    got_s, want_s = k12b(), p12b()
    torch.cuda.synchronize()
    if not torch.equal(got_s, want_s):
        raise AssertionError(f"match_scores_batch: scores {got_s.tolist()} differ from the plain version's "
                             f"{want_s.tolist()}")
    log(f"  match_scores_batch: {int(a_mask.sum())} query descriptors against {len(order)} candidates of "
        f"{b_masks.sum(dim=1).tolist()} (cap {cap}); scores {[round(v, 6) for v in got_s.tolist()]} "
        f"identical to the plain version")
    pairs = int(a_mask.sum()) * int(b_masks.sum())
    # per valid pair: 8 xor, 8 popcounts, 8 adds for the distance, 2 compares
    measure(torch, records, "match_scores_batch", k12b, p12b, 0.0, nbytes(a, a_mask, bs, b_masks, got_s), 26 * pairs)
    pm_a = orb._unpack_bits(a).float() * 2 - 1
    pm_b = orb._unpack_bits(bs).float() * 2 - 1
    _, lib_ms, _ = device_ms(torch, lambda: torch.matmul(pm_a, pm_b.transpose(1, 2)))
    records["match_scores_batch"]["library_ms"] = lib_ms
    log(f"    the reference's +-1 distance matmul alone (torch.matmul, a library call) on the same sets: "
        f"{lib_ms:.4f} ms device-only")
    return records


def check_standalone_kernels(torch, scans, dev):
    """Phase 2e: standalone LFA's kernels vs their plain versions at the
    shapes phase 7 gives them: K9g on scan 0's less-sharp (4096 lanes) and
    less-flat (8064) features; K9k's line and plane entries with scan 1's
    sharp (768) and flat (1536) features at the scan-to-scan solve's first
    guess (the identity: scan 0 leaves no motion to warm-start from) as
    queries against those grids, and its k-NN entry on the flat ones; K9c on
    the host mapping's edge and surf buffers (32768 and 65536 rows) after
    scans 0-3 of the host pipeline."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.lfa import LfaPipeline, features, registration
    from lv_slam_tpu_torch.lfa.fused import _GRID_CELL, _n_buckets
    from lv_slam_tpu_torch.ops import knn

    full = kitti_flagship_config()
    cfg = full.lfa
    raw = [PointCloud.from_numpy(scans[i], cap=full.prefilter.raw_cap, device=dev) for i in range(4)]
    f0, f1 = (features.extract_features(c, cfg) for c in raw[:2])
    records = {}

    def identical(a, b) -> bool:
        return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(a, b))

    # kernel 9g: the previous scan's grids
    grids = {}
    for name, pts, m in (("edge", f0.less_sharp, f0.less_sharp_mask), ("surf", f0.less_flat, f0.less_flat_mask)):
        got, want = knn.build_grid(pts, m, _GRID_CELL), knn.build_grid_ref(pts, m, _GRID_CELL)
        torch.cuda.synchronize()
        if not identical(got, want):
            raise AssertionError(f"build_grid: the {name} grid differs from the plain version")
        grids[name] = got
        log(f"  build_grid: {name} grid of {int(m.sum())} valid of {m.numel()} lanes, origin "
            f"{got.origin_cell.tolist()}, {int(torch.unique(got.keys).numel()) - 1} occupied cells; keys, "
            f"point order and origin identical to the plain version")
    pts, m, grid = f0.less_flat, f0.less_flat_mask, grids["surf"]
    measure(torch, records, "build_grid", lambda: knn.build_grid(pts, m, _GRID_CELL),
            lambda: knn.build_grid_ref(pts, m, _GRID_CELL), 0.0,
            nbytes(pts, m, grid.keys, grid.xyz, grid.origin_cell), 15 * pts.shape[0])

    # kernel 9k: one scan-to-scan round's lines and planes, and the k-NN entry
    guess = torch.eye(4, dtype=torch.float32, device=dev)
    ye, ys = se3.transform_points(guess, f1.sharp), se3.transform_points(guess, f1.flat)
    k9k = lambda: (registration.lines_from_2nn(ye, f1.sharp_mask, grids["edge"]),  # noqa: E731
                   registration.planes_from_3nn(ys, f1.flat_mask, grids["surf"]))
    p9k = lambda: (registration.lines_from_2nn_ref(ye, f1.sharp_mask, grids["edge"]),  # noqa: E731
                   registration.planes_from_3nn_ref(ys, f1.flat_mask, grids["surf"]))
    (lines, planes), (lines_p, planes_p) = k9k(), p9k()
    got_nn, want_nn = knn.knn(grids["surf"], ys, 3), knn.knn_ref(grids["surf"], ys, 3)
    torch.cuda.synchronize()
    for name, a, b in (("lines_from_2nn", lines, lines_p), ("planes_from_3nn", planes, planes_p),
                       ("knn (k = 3)", got_nn, want_nn)):
        if not identical(a, b):
            raise AssertionError(f"{name}: fields differ from the plain version")
    log(f"  knn: lines_from_2nn {int(lines.valid.sum())} of {int(f1.sharp_mask.sum())} sharp queries accepted, "
        f"planes_from_3nn {int(planes.valid.sum())} of {int(f1.flat_mask.sum())} flat ones, 3-NN of the flat "
        f"queries valid {int(got_nn[2].sum())} of {got_nn[2].numel()}; every field identical to the plain version")
    # operations this data needs: per query 27 binary searches (3 per step),
    # 2 per candidate slot, 9 per hit's squared distance, ~30 for the fit
    n_ops = 0
    for grid, y in ((grids["edge"], ye), (grids["surf"], ys)):
        steps = int(np.ceil(np.log2(grid.keys.shape[0] + 1)))
        n_hits = int(knn.knn_candidates(grid, y)[1].sum())
        n_ops += y.shape[0] * (27 * 3 * steps + 27 * 8 * 2 + 30) + 9 * n_hits
    measure(torch, records, "knn", k9k, p9k, 0.0,
            nbytes(*grids["edge"][:3], *grids["surf"][:3], ye, f1.sharp_mask, ys, f1.flat_mask, *lines, *planes),
            n_ops)

    # kernel 9c: the host mapping's tables, rebuilt from its buffers each scan
    pipe = LfaPipeline(cfg, device=dev)
    for c in raw:
        pipe.process(c)
    mapping = pipe.mapping
    for name, xyz, m, cap in (("edge", mapping._edge_map, mapping._edge_mask, cfg.map_edge_cap),
                              ("surf", mapping._surf_map, mapping._surf_mask, cfg.map_planar_cap)):
        nb = _n_buckets(cfg, cap)
        got = knn.build_cell_table(xyz, m, _GRID_CELL, nb, cfg.knn_slots)
        want = knn.build_cell_table_ref(xyz, m, _GRID_CELL, nb, cfg.knn_slots)
        torch.cuda.synchronize()
        if not torch.equal(got.table.view(torch.int32), want.table.view(torch.int32)):
            raise AssertionError(f"build_cell_table: the {name} table differs from the plain version")
        stored = int((got.table.view(-1, 4)[:, 3] > 0.5).sum())
        log(f"  build_cell_table: {name} map {int(m.sum())} of {m.numel()} rows -> table {tuple(got.table.shape)} "
            f"holding {stored}; bit-identical to the plain version, slot for slot")
    k9c = lambda: knn.build_cell_table(xyz, m, _GRID_CELL, nb, cfg.knn_slots)  # noqa: E731
    p9c = lambda: knn.build_cell_table_ref(xyz, m, _GRID_CELL, nb, cfg.knn_slots)  # noqa: E731
    measure(torch, records, "build_cell_table", k9c, p9c, 0.0, nbytes(xyz, m, got.table), 20 * xyz.shape[0])
    return records


def check_lut_kernels(torch, scans, gt, dev):
    """Phase 2f: the LUT paths' kernels vs their plain versions at the
    shapes the host DLO gives them: K3L on the 32768-leaf keyframe map built
    from scan 0's prefiltered, 65536-lane uniform subsample, then K6L
    (DIRECT1 weighted: the align; DIRECT7 weighted: the retry) and K6G
    (DIRECT1 weighted: the retry's arbiter) of scan 1's subsample against
    it, at the true relative pose and at one 0.3 m and 0.02 rad off."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.ops import ndt, ndt_soa, prefilter, voxel_map

    cfg = kitti_flagship_config()
    pf, ndt_cfg = cfg.prefilter, cfg.odometry.ndt
    records = {}

    def subsample(i):
        raw = PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev)
        return prefilter.uniform_subsample(prefilter.prefilter(raw, pf), cfg.odometry.scan_matching_cap)

    sub0, sub1 = subsample(0), subsample(1)
    vm = voxel_map.build_voxel_map(
        sub0, ndt_cfg.resolution, leaf_cap=ndt_cfg.leaf_cap, lut_extent=ndt_cfg.lut_extent,
        min_points_per_voxel=ndt_cfg.min_points_per_voxel, min_covar_eigvalue_mult=ndt_cfg.min_covar_eigvalue_mult,
        weighted=ndt_cfg.weighted,
    )
    kl = lambda: voxel_map.build_lut(vm)  # noqa: E731
    pl = lambda: voxel_map.build_lut_ref(vm)  # noqa: E731
    lut, lut_ref = kl(), pl()
    torch.cuda.synchronize()
    if not torch.equal(lut, lut_ref):
        raise AssertionError(f"build_lut: {int((lut != lut_ref).sum())} entries differ from the plain version")
    n_valid = int(vm.valid.sum())
    if int((lut >= 0).sum()) != n_valid:
        raise AssertionError("build_lut: the table does not hold one entry per valid leaf")
    log(f"  build_lut: ({lut.numel()},) table identical, {n_valid} leaves of {vm.leaf_cap} entered")
    measure(torch, records, "build_lut", kl, pl, 0.0, nbytes(vm.keys, vm.valid, lut), 0)

    soa = ndt_soa.to_soa(vm, lut)
    xs, xyz, mask = sub1.masked_xyz().T.contiguous(), sub1.masked_xyz().contiguous(), sub1.mask.contiguous()
    rel = torch.from_numpy((np.linalg.inv(gt[0]) @ gt[1]).astype(np.float32)).to(dev)
    off = se3.exp_se3(torch.tensor([0.3, 0.0, 0.0, 0.0, 0.0, 0.02], device=dev))
    gauss = ndt.make_gauss_params(ndt_cfg.resolution, ndt_cfg.outlier_ratio)
    score_gauss = ndt.make_gauss_params(ndt_cfg.resolution)  # the arbiter's, as the reference's ndt_score_fn
    errs, fns = {"ndt_derivatives_soa": 0.0, "ndt_derivatives": 0.0}, {}
    for pose_name, transform in (("true pose", rel), ("perturbed pose", (off @ rel).contiguous())):
        cases = [("ndt_derivatives_soa", hood, ndt_soa.ndt_derivatives_soa, ndt_soa.ndt_derivatives_soa_ref,
                  (soa, xs, mask, transform, gauss, voxel_map.neighborhood_offsets(hood, dev), ndt_cfg.weighted))
                 for hood in ("DIRECT1", "DIRECT7")]
        cases.append(("ndt_derivatives", "DIRECT1", ndt.ndt_derivatives, ndt.ndt_derivatives_ref,
                      (vm, lut, xyz, mask, transform, score_gauss, voxel_map.neighborhood_offsets("DIRECT1", dev),
                       ndt_cfg.weighted)))
        for name, hood, kernel, plain, args in cases:
            k6 = lambda kernel=kernel, args=args: kernel(*args)  # noqa: E731
            p6 = lambda plain=plain, args=args: plain(*args)  # noqa: E731
            (s1, g1, h1), (s2, g2, h2) = k6(), p6()
            es = abs(float(s1) - float(s2))
            eg, eh = float((g1 - g2).abs().max()), float((h1 - h2).abs().max())
            tg, th = 2e-5 * float(g2.abs().max()), 2e-5 * float(h2.abs().max())
            if not float(s2) > 0.0 or es > 1e-4 * abs(float(s2)) or eg > tg or eh > th:
                raise AssertionError(f"{name} {hood} at the {pose_name}: score {float(s2)}, errors score {es} "
                                     f"grad {eg} hess {eh}")
            errs[name] = max(errs[name], eg, eh)
            if pose_name == "true pose" and hood == "DIRECT1":
                fns[name] = (k6, p6, args)
            log(f"  {name} {hood} at the {pose_name}: score {float(s2):.1f}, errors score {es:.3g} (tol "
                f"{1e-4 * abs(float(s2)):.3g}), grad {eg:.3g} (tol {tg:.3g}), hess {eh:.3g} (tol {th:.3g})")

    # the bytes this call's data touches: the points and mask, each distinct
    # LUT entry probed and each distinct leaf hit once, the 43 outputs; about
    # 300 (K6L) and 400 (K6G) operations per hit
    cells = voxel_map.probe_cells(se3.transform_points(rel, xyz), vm.origin_cell, vm.resolution)
    e = vm.extent
    inside = torch.all((cells >= 0) & (cells < e), dim=1) & mask
    flat = ((cells[:, 0] * e + cells[:, 1]) * e + cells[:, 2])[inside].to(torch.int64)
    leaves = lut[flat]
    hits = int((leaves >= 0).sum())
    n_probed, n_leaves = int(torch.unique(flat).numel()), int(torch.unique(leaves[leaves >= 0]).numel())
    log(f"    DIRECT1 at the true pose: {int(mask.sum())} points, {hits} hits, {n_probed} distinct LUT entries, "
        f"{n_leaves} distinct leaves")
    for name, row_bytes, ops in (("ndt_derivatives_soa", 64, 300), ("ndt_derivatives", 52, 400)):
        k6, p6, args = fns[name]
        pts = nbytes(xs, mask)
        measure(torch, records, name, k6, p6, errs[name], pts + 4 * n_probed + row_bytes * n_leaves + 43 * 4,
                ops * hits)
    return records


# ----------------------------------------------------------------- phase 3

ODOMETRY_KERNELS = ("voxel_downsample", "build_voxel_map", "to_hash", "ndt_derivatives_hash")
CHAIN_KERNELS = ODOMETRY_KERNELS + (
    "extract_features", "insert_cell_table", "crop_cell_table", "lines_from_fit", "planes_from_fit", "gn_solve",
)


def run_chunks(torch, run, xyz, mask, stamps, inten, cfg):
    """Two chunks carried by init_state / return_state, as a long sequence runs."""
    state, poses, iters, switches, filt = None, [], [], [], []
    for s in range(0, xyz.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        (p, it, sw, f), state = run(
            xyz[sl], mask[sl], stamps[sl], cfg.odometry, cfg.prefilter, with_stats=True,
            init_state=state, return_state=True, inten=inten[sl], return_filtered=True,
            device=xyz.device,
        )
        poses.append(p)
        iters.append(it)
        switches.append(sw)
        filt.append(f)
    return (
        torch.cat(poses), torch.cat(iters), torch.cat(switches),
        tuple(torch.cat(col) for col in zip(*filt)),
    )


def stack_scans(torch, scans, cap, dev):
    from lv_slam_tpu_torch.core.cloud import PointCloud

    clouds = [PointCloud.from_numpy(s, cap=cap, device=dev) for s in scans]
    xyz = torch.stack([c.xyz for c in clouds])
    mask = torch.stack([c.mask for c in clouds])
    inten = torch.stack([c.intensity for c in clouds])
    stamps = (torch.arange(len(scans), dtype=torch.float32) * 0.1).to(dev)
    torch.cuda.synchronize()
    return xyz, mask, stamps, inten


def accuracy(est: np.ndarray, gt: np.ndarray, what: str, n: int) -> tuple:
    """(devkit_t_err, final drift m) of `est` against the ground truth;
    raises unless both pass the reference benchmark's gates."""
    if est.shape != (n, 4, 4) or not np.isfinite(est).all():
        raise AssertionError(f"{what}: shape {est.shape}, finite {np.isfinite(est).all()}")
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    t_err = devkit_t_err(gt_rel, est)
    drift = float(np.linalg.norm(est[-1, :3, 3] - gt_rel[-1, :3, 3]))
    distance = float(np.linalg.norm(gt_rel[1:, :3, 3] - gt_rel[:-1, :3, 3], axis=1).sum())
    log(f"  {what}: devkit_t_err {t_err:.6f} (gate 0.010), final drift {drift:.4f} m "
        f"(gate {0.02 * distance:.2f} m, 2 % of {distance:.1f} m)")
    if not (t_err <= 0.010 and drift < 0.02 * distance):
        raise AssertionError(f"{what} fails the accuracy gates")
    return t_err, drift


def count_syncs(torch, fn) -> int:
    """Host syncs of `fn` (torch warns at each synchronizing call)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def run_slice(torch, scans, gt, dev, card):
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.odometry.fused import run_sequence_fused

    cfg = kitti_flagship_config()
    xyz, mask, stamps, inten = stack_scans(torch, scans, cfg.prefilter.raw_cap, dev)

    reset_launches()
    poses, iters, switches, filt = run_chunks(torch, run_sequence_fused, xyz, mask, stamps, inten, cfg)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on the odometry path: {launches}")
    missing = [name for name in ODOMETRY_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the odometry path: {missing}")

    est = poses.cpu().numpy().astype(np.float64)
    n = len(scans)
    fx, fi, fm = filt
    if tuple(fx.shape) != (n, 3, cfg.prefilter.out_cap) or tuple(fm.shape) != (n, cfg.prefilter.out_cap):
        raise AssertionError(f"filtered product shape {tuple(fx.shape)}")
    if not bool(torch.isfinite(fx.transpose(1, 2)[fm]).all()):
        raise AssertionError("filtered product has non-finite valid lanes")
    t_err, drift = accuracy(est, gt, f"odometry, {n} scans", n)
    log(f"  keyframes {int(switches.sum())}, mean Newton iterations/scan {float(iters[1:].float().mean()):.2f}")

    # the same first four scans through the plain path on the CPU
    k = 4
    ref = run_sequence_fused(
        xyz[:k].cpu(), mask[:k].cpu(), stamps[:k].cpu(), cfg.odometry, cfg.prefilter,
        inten=inten[:k].cpu(), device="cpu",
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

    syncs = count_syncs(torch, lambda: run_sequence_fused(
        xyz[:CHUNK], mask[:CHUNK], stamps[:CHUNK], cfg.odometry, cfg.prefilter, inten=inten[:CHUNK],
        device=dev,
    ))
    log(f"  host syncs: {syncs} in {CHUNK} scans = {syncs / CHUNK:.2f} per scan")

    def window():
        run_sequence_fused(xyz[:8], mask[:8], stamps[:8], cfg.odometry, cfg.prefilter,
                           inten=inten[:8], device=dev)

    idle = profile(torch, window, "odometry")
    summary = dict(
        scans_per_s=n / elapsed, devkit_t_err=t_err, drift_m=drift, syncs_per_scan=syncs / CHUNK,
        idle_share=idle,
    )
    return summary, poses, syncs


def profile(torch, run, what: str) -> float:
    """Device time by kernel over one 8-scan window `run`, from the profiler,
    and the device's idle share: 1 - summed kernel time / the wall time of
    the same window run without the profiler (median of 3). The full table
    goes to _cache/chip_smoke/profile_<what>.txt."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    def window():
        run()
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
    (CACHE / f"profile_{what}.txt").write_text(events.table(sort_by=attr, row_limit=200))
    if busy <= 0:
        log("  profile: no device time recorded (device split not measured)")
        return float("nan")
    log(f"  profile of 8 scans ({what}): wall {wall_us / 1e3:.2f} ms unprofiled ({profiled_us / 1e3:.2f} ms "
        f"profiled), device busy {busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}")
    for t, key, count in sorted(dev_time, reverse=True)[:12]:
        log(f"    {t / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")
    return 1 - busy / wall_us


# ----------------------------------------------------------------- phase 4

def run_chain_chunks(torch, xyz, mask, stamps, inten, cfg):
    from lv_slam_tpu_torch.pipeline.fused_chain import run_sequence_chain

    state, odom, refined, filt = None, [], [], []
    for s in range(0, xyz.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        (o, r, f), state = run_sequence_chain(
            xyz[sl], mask[sl], stamps[sl], cfg.odometry, cfg.prefilter, cfg.lfa,
            init_state=state, return_state=True, inten=inten[sl], return_filtered=True,
            device=xyz.device,
        )
        odom.append(o)
        refined.append(r)
        filt.append(f)
    return torch.cat(odom), torch.cat(refined), tuple(torch.cat(col) for col in zip(*filt))


def run_main_path(torch, scans, gt, dev, card, odometry_poses, odometry_syncs):
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.pipeline.fused_chain import run_sequence_chain

    cfg = kitti_flagship_config()
    xyz, mask, stamps, inten = stack_scans(torch, scans, cfg.prefilter.raw_cap, dev)
    n = len(scans)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    odom, refined, filt = run_chain_chunks(torch, xyz, mask, stamps, inten, cfg)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches on the dlo -> LFA chain ({n} scans): {launches}")
    missing = [name for name in CHAIN_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the dlo -> LFA chain: {missing}")
    if tuple(filt[0].shape) != (n, 3, cfg.prefilter.out_cap):
        raise AssertionError(f"filtered product shape {tuple(filt[0].shape)}")

    d_odom = float((odom - odometry_poses).abs().max())
    log(f"  chain odometry vs phase 3's poses: max difference {d_odom:.3g} (tol 1e-6)")
    if d_odom > 1e-6:
        raise AssertionError("the chain's odometry departs from the odometry path's")
    est = refined.cpu().numpy().astype(np.float64)
    t_err, drift = accuracy(est, gt, f"refined (LFA), {n} scans", n)

    k = 4
    _, ref = run_sequence_chain(
        xyz[:k].cpu(), mask[:k].cpu(), stamps[:k].cpu(), cfg.odometry, cfg.prefilter, cfg.lfa,
        inten=inten[:k].cpu(), device="cpu",
    )
    ref = ref.numpy()
    dev_t = float(np.abs(ref[:, :3, 3] - est[:k, :3, 3]).max())
    dev_r = float(np.abs(ref[:, :3, :3] - est[:k, :3, :3]).max())
    log(f"  first {k} refined poses vs the plain path on the CPU: max difference translation "
        f"{dev_t:.3g} m, rotation {dev_r:.3g} (tol 1e-4 each)")
    if dev_t > 1e-4 or dev_r > 1e-4:
        raise AssertionError("the card's refined trajectory departs from the plain path's")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_chain_chunks(torch, xyz, mask, stamps, inten, cfg)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    log(f"  warm pass: {n} scans in {elapsed:.3f} s = {n / elapsed:.2f} scans/s ({card})")

    syncs = count_syncs(torch, lambda: run_sequence_chain(
        xyz[:CHUNK], mask[:CHUNK], stamps[:CHUNK], cfg.odometry, cfg.prefilter, cfg.lfa,
        inten=inten[:CHUNK], device=dev,
    ))
    log(f"  host syncs: chain {syncs}, odometry alone {odometry_syncs} in {CHUNK} scans "
        f"= {syncs / CHUNK:.2f} vs {odometry_syncs / CHUNK:.2f} per scan")
    if syncs != odometry_syncs:
        raise AssertionError("the LFA stage adds host syncs to the odometry's")

    def window():
        run_sequence_chain(xyz[:8], mask[:8], stamps[:8], cfg.odometry, cfg.prefilter, cfg.lfa,
                           inten=inten[:8], device=dev)

    idle = profile(torch, window, "chain")
    log(f"  peak device memory of the chunked run: {peak / 2**20:.1f} MiB")
    summary = dict(
        scans_per_s=n / elapsed, devkit_t_err=t_err, drift_m=drift, syncs_per_scan=syncs / CHUNK,
        idle_share=idle, peak_mib=peak / 2**20,
    )
    return summary, launches


# ----------------------------------------------------------------- phase 5

REFERENCE_KEYFRAMES = 19  # the reference's CPU accuracy records of this circle (BENCH_r05_cpu_accuracy_*.json)
CAMERA_KERNELS = ("_detect_pyramid_batch", "match_scores_batch")  # ORB (K12) and matching (K12b)
STANDALONE_KERNELS = ("build_grid", "knn", "build_cell_table")  # K9g, K9k, K9c: standalone LFA only
LUT_KERNELS = ("build_lut", "ndt_derivatives_soa", "ndt_derivatives")  # K3L, K6L, K6G: the LUT paths (phase 8)
# loop_rejections of the reference's BoW-ranked CPU records of this circle
# (BENCH_r05_cpu_accuracy_dedup_stride.json, _refvocab.json)
REFERENCE_REJECTIONS = {"verified": 1, "bow_rejected": 0, "guess_rejected": 0, "fitness_rejected": 0}


def make_backend(dev, asynchronous: bool, vocabulary=None, loop_cfg=None):
    """The reference benchmark's `make_backend` (`bench.py:257-313`): its
    graph settings, the given vocabulary (phase 5 has none: the pure-lidar
    configuration) and loop configuration."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.config import GraphConfig, LoopDetectorConfig
    from lv_slam_tpu_torch.pipeline.async_backend import AsyncBackend
    from lv_slam_tpu_torch.pipeline.backend import GlobalGraph

    backend = GlobalGraph(
        GraphConfig(keyframe_cap=64, edge_cap=256, prior_cap=16, solver_num_iterations=64),
        loop_cfg or LoopDetectorConfig(), prefilter_cfg=kitti_flagship_config().prefilter, device=dev,
        vocabulary=vocabulary,
    )
    return AsyncBackend(backend) if asynchronous else backend


def run_full(torch, xyz, mask, stamps, inten, cfg, backend, image_chunks=None):
    """One pass of the full path, as the reference benchmark's `run_chain`:
    chunk k's chain is launched before chunk k-1's refined poses are read
    and fed, with its filtered product (and its device image stack from
    `image_chunks`, when given), to the backend (on the backend's worker
    when it is an AsyncBackend); `optimize()` every 100 scans, then
    `finish()` and `drain()`. Returns (refined poses, the GlobalGraph)."""
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.pipeline.fused_chain import run_sequence_chain

    n = xyz.shape[0]
    stamps_np = (np.arange(n, dtype=np.float32) * 0.1).astype(np.float64)
    graph = getattr(backend, "graph_backend", backend)
    parts = {}

    def feed(s, e, refined, cloud):
        poses = refined.cpu().numpy()  # the chunk's read
        parts[s] = poses
        images = None if image_chunks is None else image_chunks[s // CHUNK]
        graph.add_scan_batch(s, stamps_np[s:e], poses, cloud, images=images, filtered=True)
        if any((i + 1) % 100 == 0 for i in range(s, e)):
            graph.optimize()

    def hand_over(p):
        if graph is backend:
            feed(*p)
        else:
            backend.submit(feed, *p)

    state, pending = None, None
    for s in range(0, n, CHUNK):
        e = min(s + CHUNK, n)
        (_, refined, filt), state = run_sequence_chain(
            xyz[s:e], mask[s:e], stamps[s:e], cfg.odometry, cfg.prefilter, cfg.lfa,
            init_state=state, return_state=True, inten=inten[s:e], return_filtered=True, device=xyz.device,
        )
        if pending is not None:
            hand_over(pending)
        pending = (s, e, refined, PointCloud(*filt))
    hand_over(pending)
    backend.finish()
    backend.drain()
    return np.concatenate([parts[k] for k in sorted(parts)]).astype(np.float64), graph


def run_full_path(torch, scans, gt, dev, card):
    """Phase 5: the full pure-lidar path over the whole circle."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    import lv_slam_tpu_torch.pipeline.backend as backend_module
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.graph import pose_graph
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches

    cfg = kitti_flagship_config()
    xyz, mask, stamps, inten = stack_scans(torch, scans, cfg.prefilter.raw_cap, dev)
    n = len(scans)

    # record each LM's input graph and result, to re-solve the last one on the CPU
    solves, solve = [], backend_module.pg.optimize_pose_graph

    def recording(graph, num_iterations, device):
        frozen = pose_graph.PoseGraph(*(np.array(a) for a in graph))
        result = solve(frozen, num_iterations, device=device)
        solves.append((frozen, num_iterations, result))
        return result

    backend_module.pg.optimize_pose_graph = recording
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        est, graph = run_full(torch, xyz, mask, stamps, inten, cfg, make_backend(dev, asynchronous=True))
        torch.cuda.synchronize()
    finally:
        backend_module.pg.optimize_pose_graph = solve
    peak = torch.cuda.max_memory_allocated()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on the full path ({n} scans): {launches}")
    missing = [name for name, count in launches.items()
               if count == 0 and name not in CAMERA_KERNELS + STANDALONE_KERNELS + LUT_KERNELS]
    if missing:
        raise AssertionError(f"kernels never launched on the full path: {missing}")
    log(f"  exempt from the launch check here: {list(CAMERA_KERNELS)} (no images in this configuration; "
        f"phases 6 and 6b drive them), {list(STANDALONE_KERNELS)} (standalone LFA; phase 7 drives them), "
        f"{list(LUT_KERNELS)} (the LUT paths; phase 8 drives them)")
    t_err, drift = accuracy(est, gt, f"refined (LFA) poses of the full path, {n} scans", n)

    loops = [(lp.key1.seq, lp.key2.seq, round(lp.fitness, 6)) for lp in graph.loops]
    stats = dict(graph.loop_detector.stats)
    log(f"  keyframes {len(graph.keyframes)} (reference record {REFERENCE_KEYFRAMES}), loops "
        f"(new seq, old seq, fitness) {loops}, loop_rejections {stats}, LM solves {len(solves)} "
        f"(iterations {[r.iterations for _, _, r in solves]})")
    if len(graph.keyframes) != REFERENCE_KEYFRAMES or not loops:
        raise AssertionError("the full path must give the reference's 19 keyframes and close a loop")
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    kf_err = [float(np.linalg.norm(k.estimate[:3, 3] - gt_rel[k.seq][:3, 3])) for k in graph.keyframes]
    odo_err = [float(np.linalg.norm(k.odom[:3, 3] - gt_rel[k.seq][:3, 3])) for k in graph.keyframes]
    log(f"  keyframe position error vs ground truth: odometry max {max(odo_err):.4f} m, optimized graph "
        f"max {max(kf_err):.4f} m")

    frozen, iters, result = solves[-1]
    ref = pose_graph.optimize_pose_graph(frozen, iters, device="cpu")
    n_nodes = int(frozen.node_valid.sum())
    d_graph = float(np.abs(result.poses.cpu().numpy()[:n_nodes] - ref.poses.numpy()[:n_nodes]).max())
    log(f"  the last LM ({n_nodes} nodes, {int(frozen.e_valid.sum())} edges) re-solved by the plain path on "
        f"the CPU: max pose difference {d_graph:.3g} (tol 1e-4); chi2 {float(result.chi2_before):.4f} -> "
        f"{float(result.chi2_after):.4f} on the card, {float(ref.chi2_after):.4f} on the CPU, iterations "
        f"{result.iterations} / {ref.iterations}")
    if d_graph > 1e-4:
        raise AssertionError("the card's pose graph departs from the plain path's")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est2, graph2 = run_full(torch, xyz, mask, stamps, inten, cfg, make_backend(dev, asynchronous=True))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if [k.seq for k in graph2.keyframes] != [k.seq for k in graph.keyframes] or len(graph2.loops) != len(loops):
        raise AssertionError("the warm pass's keyframes or loops differ from the first pass's")
    phase_ms = {k: (v if k == "opt_cycles" else v / n * 1e3) for k, v in sorted(graph2.timings.items())}
    log(f"  warm pass: {n} scans in {elapsed:.3f} s = {n / elapsed:.2f} scans/s ({card}); "
        f"backend_phase_ms_per_scan {json.dumps(phase_ms)}")

    syncs = count_syncs(torch, lambda: run_full(
        torch, xyz, mask, stamps, inten, cfg, make_backend(dev, asynchronous=False)))
    log(f"  host syncs, synchronous backend: {syncs} in {n} scans = {syncs / n:.2f} per scan")

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_full(torch, xyz, mask, stamps, inten, cfg, make_backend(dev, asynchronous=True))
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = "self_device_time_total" if hasattr(torch.autograd.profiler_util.FunctionEventAvg(),
                                               "self_device_time_total") else "self_cuda_time_total"
    kernels = sorted(((getattr(e, attr), e.key, e.count) for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_us = sum(t for t, _, _ in kernels)
    CACHE.mkdir(parents=True, exist_ok=True)
    (CACHE / "profile_full.txt").write_text(events.table(sort_by=attr, row_limit=200))
    idle = 1 - busy_us / 1e6 / elapsed
    log(f"  device busy {busy_us / 1e3:.1f} ms over the {n}-scan pass (profiled), against the warm pass's "
        f"{elapsed * 1e3:.1f} ms wall: idle share {idle:.3f}; peak device memory {peak / 2**20:.1f} MiB")
    for t, key, count in kernels[:12]:
        log(f"    {t / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")
    summary = dict(
        scans_per_s=n / elapsed, devkit_t_err=t_err, drift_m=drift, keyframes=len(graph.keyframes),
        n_loops=len(loops), loops=loops, loop_rejections=stats, backend_phase_ms_per_scan=phase_ms,
        syncs_per_scan=syncs / n, idle_share=idle, peak_mib=peak / 2**20,
    )
    return summary, launches


# ----------------------------------------------------------------- phase 6


def run_camera_path(torch, scans, gt, dev, card, lidar_loops, images):
    """Phase 6: the full path with camera images and the shipped vocabulary,
    as the reference benchmark runs it; 6b: the raw ranking mode (no
    vocabulary), which runs K12b. Returns (summary, launches of K12 in 6 and
    of K12b in 6b)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.config import LoopDetectorConfig
    from lv_slam_tpu_torch.graph.bow import VOCABULARY_ASSET, Vocabulary
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches

    cfg = kitti_flagship_config()
    xyz, mask, stamps, inten = stack_scans(torch, scans, cfg.prefilter.raw_cap, dev)
    n = len(scans)
    t0 = time.perf_counter()
    # uploaded once per chunk before the passes, as the benchmark pre-uploads
    image_chunks = [torch.from_numpy(images[s:s + CHUNK]).to(dev) for s in range(0, n, CHUNK)]
    torch.cuda.synchronize()
    vocab = Vocabulary.load(str(VOCABULARY_ASSET))
    log(f"  {n} camera images {images.shape[1:]} uploaded in {time.perf_counter() - t0:.1f} s; "
        f"vocabulary {VOCABULARY_ASSET.relative_to(ROOT)}: {vocab.n_words} words, baseline {vocab.baseline:.4f}")

    def camera_backend(asynchronous=True):
        return make_backend(dev, asynchronous, vocabulary=Vocabulary.load(str(VOCABULARY_ASSET)))

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    est, graph = run_full(torch, xyz, mask, stamps, inten, cfg, camera_backend(), image_chunks)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on the camera path ({n} scans): {launches}")
    if launches["_detect_pyramid_batch"] == 0:
        raise AssertionError("ORB (K12) was never launched on the camera path")
    t_err, drift = accuracy(est, gt, f"refined (LFA) poses of the camera path, {n} scans", n)
    loops = [(lp.key1.seq, lp.key2.seq, round(lp.fitness, 6), round(lp.visual_score, 6)) for lp in graph.loops]
    stats = dict(graph.loop_detector.stats)
    n_desc = [0 if k.descriptor is None else int(k.descriptor.shape[0]) for k in graph.keyframes]
    bow_active = graph.loop_detector.vocabulary is not None
    log(f"  keyframes {len(graph.keyframes)} (reference record {REFERENCE_KEYFRAMES}), descriptors per keyframe "
        f"{n_desc}; loops (new seq, old seq, fitness, visual score) {loops} (phase 5, no images: {lidar_loops}); "
        f"loop_rejections {stats} (reference record {REFERENCE_REJECTIONS}); bow_active {bow_active}")
    if len(graph.keyframes) != REFERENCE_KEYFRAMES or min(n_desc) == 0:
        raise AssertionError("the camera path must give the reference's 19 keyframes, each described")
    if not loops or any(v < 0.04 for *_, v in loops) or not bow_active:
        raise AssertionError("the camera path must close a loop past the 0.04 visual gate with BoW active")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, graph2 = run_full(torch, xyz, mask, stamps, inten, cfg, camera_backend(), image_chunks)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if [k.seq for k in graph2.keyframes] != [k.seq for k in graph.keyframes] or len(graph2.loops) != len(loops):
        raise AssertionError("the warm pass's keyframes or loops differ from the first pass's")
    phase_ms = {k: (v if k == "opt_cycles" else v / n * 1e3) for k, v in sorted(graph2.timings.items())}
    log(f"  warm pass: {n} scans in {elapsed:.3f} s = {n / elapsed:.2f} scans/s ({card}); "
        f"backend_phase_ms_per_scan {json.dumps(phase_ms)}")

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_full(torch, xyz, mask, stamps, inten, cfg, camera_backend(), image_chunks)
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = "self_device_time_total" if hasattr(torch.autograd.profiler_util.FunctionEventAvg(),
                                               "self_device_time_total") else "self_cuda_time_total"
    kernels = [(getattr(e, attr), e.key, e.count) for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(t for t, _, _ in kernels)
    orb_us = sum(t for t, key, _ in kernels
                 if any(_is_function(key, f) for f in DEVICE_FUNCTIONS["_detect_pyramid_batch"]))
    CACHE.mkdir(parents=True, exist_ok=True)
    (CACHE / "profile_camera.txt").write_text(events.table(sort_by=attr, row_limit=200))
    idle = 1 - busy_us / 1e6 / elapsed
    log(f"  device busy {busy_us / 1e3:.1f} ms over the {n}-scan pass (profiled; K12's own kernels "
        f"{orb_us / 1e3:.3f} ms), against the warm pass's {elapsed * 1e3:.1f} ms wall: idle share {idle:.3f}; "
        f"peak device memory {peak / 2**20:.1f} MiB")

    log("phase 6b: the raw ranking mode (no vocabulary, no auto-training), which runs K12b")
    reset_launches()
    raw_cfg = LoopDetectorConfig(auto_train_vocab=False)
    est_raw, graph_raw = run_full(torch, xyz, mask, stamps, inten, cfg,
                                  make_backend(dev, True, loop_cfg=raw_cfg), image_chunks)
    torch.cuda.synchronize()
    raw_launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on the raw-ranking path: {raw_launches}")
    if raw_launches["match_scores_batch"] == 0 or raw_launches["_detect_pyramid_batch"] == 0:
        raise AssertionError("descriptor matching (K12b) or ORB (K12) was never launched in the raw ranking mode")
    raw_loops = [(lp.key1.seq, lp.key2.seq, round(lp.fitness, 6), round(lp.visual_score, 6))
                 for lp in graph_raw.loops]
    t_raw, _ = accuracy(est_raw, gt, f"refined poses of the raw-ranking path, {n} scans", n)
    log(f"  raw ranking: keyframes {len(graph_raw.keyframes)}, loops {raw_loops}, loop_rejections "
        f"{dict(graph_raw.loop_detector.stats)}, vocabulary trained {graph_raw.loop_detector.vocabulary is not None}")
    summary = dict(
        scans_per_s=n / elapsed, devkit_t_err=t_err, drift_m=drift, keyframes=len(graph.keyframes),
        n_loops=len(loops), loops=loops, loop_rejections=stats, bow_active=bow_active,
        backend_phase_ms_per_scan=phase_ms, idle_share=idle, peak_mib=peak / 2**20,
        raw_ranking=dict(loops=raw_loops, loop_rejections=dict(graph_raw.loop_detector.stats), devkit_t_err=t_raw),
    )
    return summary, {"_detect_pyramid_batch": launches["_detect_pyramid_batch"],
                     "match_scores_batch": raw_launches["match_scores_batch"]}


# ----------------------------------------------------------------- phase 7

# The JAX reference's records of phase 7's runs (its CPU runs of the same
# circle at full width; `scripts/reference_circle.py` makes them): the fused
# standalone run, and the host pipeline that LvSlam(use_dlo=False) runs (its
# LFA poses equal the host pipeline's)
JAX_FUSED_LFA = dict(devkit_t_err=0.00130, drift_m=0.707)
JAX_LVSLAM = dict(devkit_t_err=0.00127, drift_m=0.774, keyframes=list(range(0, 163, 9)), loops=[(135, 0)],
                  max_keyframe_err_m=0.833)
LFA_KERNELS = ("extract_features", "insert_cell_table", "crop_cell_table", "lines_from_fit", "planes_from_fit",
               "gn_solve")


def run_lfa_chunks(torch, xyz, mask, cfg):
    """Standalone `run_sequence_lfa` in chunks of 32 carried by init_state."""
    from lv_slam_tpu_torch.lfa.fused import run_sequence_lfa

    state, poses = None, []
    for s in range(0, xyz.shape[0], CHUNK):
        p, state = run_sequence_lfa(xyz[s:s + CHUNK], mask[s:s + CHUNK], cfg, init_state=state, return_state=True,
                                    device=xyz.device)
        poses.append(p)
    return torch.cat(poses)


def run_standalone_lfa(torch, scans, gt, dev, card):
    """Phase 7a: the device-resident standalone LFA over the whole circle."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.lfa.fused import run_sequence_lfa

    full = kitti_flagship_config()
    cfg = full.lfa
    xyz, mask, _, _ = stack_scans(torch, scans, full.prefilter.raw_cap, dev)
    n = len(scans)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    poses = run_lfa_chunks(torch, xyz, mask, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on standalone LFA ({n} scans): {launches}")
    missing = [name for name in ("build_grid", "knn") + LFA_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on standalone LFA: {missing}")
    est = poses.cpu().numpy().astype(np.float64)
    t_err, drift = accuracy(est, gt, f"standalone LFA, {n} scans", n)
    log(f"  the JAX reference's record of this run (CPU): devkit_t_err {JAX_FUSED_LFA['devkit_t_err']}, final "
        f"drift {JAX_FUSED_LFA['drift_m']} m")
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    rel_est = np.linalg.inv(est[:-1]) @ est[1:]
    rel_gt = np.linalg.inv(gt_rel[:-1]) @ gt_rel[1:]
    steps = np.linalg.norm((np.linalg.inv(rel_est) @ rel_gt)[:, :3, 3], axis=1)
    log(f"  relative-step translation error: worst {steps.max():.4f} m at step {int(steps.argmax()) + 1}, median "
        f"{np.median(steps):.4f} m (the JAX record: 0.697 m at step 1, median 0.012 m)")

    k = 4
    ref = run_sequence_lfa(xyz[:k].cpu(), mask[:k].cpu(), cfg, device="cpu").numpy()
    dev_t = float(np.abs(ref[:, :3, 3] - est[:k, :3, 3]).max())
    dev_r = float(np.abs(ref[:, :3, :3] - est[:k, :3, :3]).max())
    log(f"  first {k} poses vs the plain path on the CPU: max difference translation {dev_t:.3g} m, "
        f"rotation {dev_r:.3g} (tol 1e-4 each)")
    if dev_t > 1e-4 or dev_r > 1e-4:
        raise AssertionError("the card's standalone trajectory departs from the plain path's")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_lfa_chunks(torch, xyz, mask, cfg)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    log(f"  warm pass: {n} scans in {elapsed:.3f} s = {n / elapsed:.2f} scans/s ({card})")

    # steps only: a chunk carried from scan 0's state
    _, state = run_sequence_lfa(xyz[:1], mask[:1], cfg, return_state=True, device=dev)
    syncs = count_syncs(torch, lambda: run_sequence_lfa(
        xyz[1:1 + CHUNK], mask[1:1 + CHUNK], cfg, init_state=state, device=dev))
    log(f"  host syncs inside the step: {syncs} in {CHUNK} steps")
    if syncs:
        raise AssertionError("the standalone LFA step reads back from the device")

    idle = profile(torch, lambda: run_sequence_lfa(xyz[:8], mask[:8], cfg, device=dev), "lfa")
    log(f"  peak device memory of the chunked run: {peak / 2**20:.1f} MiB")
    summary = dict(scans_per_s=n / elapsed, devkit_t_err=t_err, drift_m=drift, worst_step_m=float(steps.max()),
                   syncs_per_step=syncs / CHUNK, idle_share=idle, peak_mib=peak / 2**20,
                   jax_record=JAX_FUSED_LFA)
    return summary, launches


def run_lvslam(torch, scans, gt, dev, card, images):
    """Phase 7b: LvSlam(use_dlo=False) per scan with camera images, then finalize."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.graph.bow import VOCABULARY_ASSET, Vocabulary
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.pipeline.slam import LvSlam

    n = len(scans)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = LvSlam(kitti_flagship_config(), use_dlo=False, vocabulary=Vocabulary.load(str(VOCABULARY_ASSET)),
                  device=dev)
    for i, scan in enumerate(scans):
        slam.process(scan, 0.1 * i, image=images[i])
    slam.finalize()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on LvSlam(use_dlo=False) ({n} scans): {launches}")
    missing = [name for name in STANDALONE_KERNELS + ("_detect_pyramid_batch",) if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by LvSlam(use_dlo=False): {missing}")
    est = np.stack(slam.lfa_poses)
    t_err, drift = accuracy(est, gt, f"LvSlam's LFA poses, {n} scans", n)
    backend = slam.backend
    keyframes = [k.seq for k in backend.keyframes]
    loops = [(lp.key1.seq, lp.key2.seq, round(lp.fitness, 6), round(lp.visual_score, 6)) for lp in backend.loops]
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    traj = slam.trajectory()
    kf_err = [float(np.linalg.norm(p[:3, 3] - gt_rel[s][:3, 3])) for p, s in zip(traj, keyframes)]
    log(f"  keyframes {keyframes} ({len(keyframes)}; reference record {REFERENCE_KEYFRAMES}), loops (new seq, old "
        f"seq, fitness, visual score) {loops}, loop_rejections {dict(backend.loop_detector.stats)}; optimized "
        f"keyframe error max {max(kf_err):.4f} m, last {kf_err[-1]:.4f} m")
    log(f"  the JAX reference's record of this run (CPU): LFA devkit_t_err {JAX_LVSLAM['devkit_t_err']}, final "
        f"drift {JAX_LVSLAM['drift_m']} m, keyframes {JAX_LVSLAM['keyframes']}, loops {JAX_LVSLAM['loops']}, "
        f"largest keyframe error {JAX_LVSLAM['max_keyframe_err_m']} m")
    log(f"  one pass: {n} scans in {elapsed:.3f} s = {n / elapsed:.2f} scans/s ({card}), peak device memory "
        f"{peak / 2**20:.1f} MiB")
    if len(keyframes) != REFERENCE_KEYFRAMES or not loops:
        raise AssertionError("LvSlam(use_dlo=False) must give the reference's 19 keyframes and close a loop")
    summary = dict(scans_per_s=n / elapsed, devkit_t_err=t_err, drift_m=drift, keyframes=keyframes, loops=loops,
                   max_keyframe_err_m=max(kf_err), last_keyframe_err_m=kf_err[-1], peak_mib=peak / 2**20,
                   jax_record=JAX_LVSLAM)
    return summary, launches


# ----------------------------------------------------------------- phase 8

# The JAX reference's records of phase 8's runs (its CPU runs of the same
# circle at full width; `scripts/reference_circle.py dlo` and `slam_dlo` make
# them): the host DLO, and LvSlam at its default with camera images
JAX_HOST_DLO = dict(devkit_t_err=0.00082, drift_m=0.058, keyframes=list(range(0, 170, 5)), retries=0,
                    total_iterations=169, worst_step_m=0.005, median_step_m=0.002)
JAX_LVSLAM_DLO = dict(dlo_devkit_t_err=0.00082, dlo_drift_m=0.058, lfa_devkit_t_err=0.00057, lfa_drift_m=0.017,
                      dlo_keyframes=list(range(0, 170, 5)), keyframes=list(range(0, 163, 9)), loops=[(135, 0)],
                      max_keyframe_err_m=0.045, last_keyframe_err_m=0.015)
WARM_SCANS = 3  # bench.py's host cell: 3 warm scans, then the timed ones


def step_errors(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    rel_est = np.linalg.inv(est[:-1]) @ est[1:]
    rel_gt = np.linalg.inv(gt_rel[:-1]) @ gt_rel[1:]
    return np.linalg.norm((np.linalg.inv(rel_est) @ rel_gt)[:, :3, 3], axis=1)


def first_poses_vs_cpu(est: np.ndarray, ref: np.ndarray, what: str, where: str = "on the CPU",
                       tol: float = 1e-4) -> None:
    k = ref.shape[0]
    dev_t = float(np.abs(ref[:, :3, 3] - est[:k, :3, 3]).max())
    dev_r = float(np.abs(ref[:, :3, :3] - est[:k, :3, :3]).max())
    log(f"  first {k} {what} vs the plain path {where}: max difference translation {dev_t:.3g} m, "
        f"rotation {dev_r:.3g} (tol {tol:g} each)")
    if dev_t > tol or dev_r > tol:
        raise AssertionError(f"the card's {what} depart from the plain path's {where}")


# The card's LUT paths are held to the plain path run on the card with this
# slice's kernels (K3L, K6L, K6G) swapped for their twins (`plain_twins`) to
# 1e-4: the kernels before them (K1, K3) are deterministic and held to their
# twins in phase 2, while their twins are not all deterministic on the card
# (K1's sums in `index_add_` order), and the host DLO's first align (scan 1,
# from x = +1.5 m) takes Newton steps of about its 1 cm epsilon 0.4 m from
# the optimum, so a map that rounds otherwise changes where it stops. The
# CPU's plain path builds its maps with the plain eigh on another device,
# whose float32 rounding flips the validity of a few near-planar leaves (4
# of 1667 on scan 0's map; ROADMAP queue 3): it is held to the reference's
# own one-ulp spread of the host DLO (8.6 mm on tests/test_torch_dlo.py's
# sequence), rounded up.
CPU_SPREAD_M = 1e-2


class plain_twins:
    """Within the block, the LUT paths call K3L's, K6L's and K6G's plain
    twins on the card (the harness swaps the functions in; no wrapper falls
    back)."""

    def __enter__(self):
        from lv_slam_tpu_torch.odometry import dlo
        from lv_slam_tpu_torch.ops import ndt, ndt_soa, voxel_map

        self.saved = [
            (dlo, "build_lut", voxel_map.build_lut_ref),
            (voxel_map, "build_lut", voxel_map.build_lut_ref),
            (dlo, "ndt_derivatives", ndt.ndt_derivatives_ref),
            (ndt_soa, "ndt_derivatives_soa", ndt_soa.ndt_derivatives_soa_ref),
            (ndt, "ndt_derivatives", ndt.ndt_derivatives_ref),
        ]
        self.saved = [(mod, name, getattr(mod, name), twin) for mod, name, twin in self.saved]
        for mod, name, _, twin in self.saved:
            setattr(mod, name, twin)
        return self

    def __exit__(self, *exc):
        for mod, name, kernel, _ in self.saved:
            setattr(mod, name, kernel)
        return False


def run_host_dlo(torch, scans, gt, dev, card):
    """Phase 8a: the host DLO frontend per scan over the whole circle, as
    bench.py's host cell drives it (one upload per scan)."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.odometry.dlo import DirectLidarOdometry, run_sequence

    cfg = kitti_flagship_config()
    cap, n = cfg.prefilter.raw_cap, len(scans)

    def process(odo, i):
        odo.process(PointCloud.from_numpy(scans[i], cap=cap, device=dev), i * 0.1)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    odo = DirectLidarOdometry(cfg.odometry, cfg.prefilter, device=dev)
    retried, kept = [], []  # scans whose retry ran, and was kept
    odo_score = odo._score

    def logged_score(cloud, transform):  # the retry's arbiter: logs each scan whose retry ran
        retried.append(odo.stats.scan_count)
        return odo_score(cloud, transform)

    odo._score = logged_score

    def track(i):
        before = odo.stats.retries
        process(odo, i)
        if odo.stats.retries > before:
            kept.append(i)

    for i in range(WARM_SCANS):
        track(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARM_SCANS, n):
        track(i)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on the host DLO ({n} scans): {launches}")
    missing = [name for name in ("voxel_downsample", "build_voxel_map", "build_lut", "ndt_derivatives_soa")
               if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the host DLO: {missing}")
    est = np.stack(odo.poses)
    t_err, drift = accuracy(est, gt, f"host DLO poses, {n} scans", n)
    steps = step_errors(est, gt)
    stats = odo.stats
    log(f"  keyframes {odo.keyframe_indices} ({stats.keyframe_count}), retries {stats.retries}, Newton "
        f"iterations {stats.total_iterations}; relative-step error worst {steps.max():.4f} m at step "
        f"{int(steps.argmax()) + 1}, median {np.median(steps):.4f} m")
    log(f"  the retry ran at scans {retried} and was kept at {kept}; the JAX record keeps "
        f"{JAX_HOST_DLO['retries']}")
    log(f"  the JAX reference's record of this run (CPU): {JAX_HOST_DLO}")
    if odo.keyframe_indices != JAX_HOST_DLO["keyframes"]:
        raise AssertionError("the host DLO must give the JAX record's 34 keyframes")
    # scan 1 starts 0.5 m off (x = +1.5 m): whether DIRECT1 stops short there
    # and the retry wins is rounding (see CPU_SPREAD_M); no warm-started scan
    # may keep a retry, as none does in the record
    if [i for i in kept if i > 1]:
        raise AssertionError(f"the host DLO kept a retry at warm-started scans {kept}")

    with plain_twins():
        twin = DirectLidarOdometry(cfg.odometry, cfg.prefilter, device=dev)
        for i in range(4):
            process(twin, i)
    first_poses_vs_cpu(est, np.stack(twin.poses), "host DLO poses", "on the card")
    ref, _ = run_sequence(scans[:4], cfg=cfg.odometry, prefilter_cfg=cfg.prefilter, cap=cap, device="cpu")
    first_poses_vs_cpu(est, ref, "host DLO poses", tol=CPU_SPREAD_M)
    log(f"  timed: {n - WARM_SCANS} scans after {WARM_SCANS} warm in {elapsed:.3f} s = "
        f"{(n - WARM_SCANS) / elapsed:.2f} scans/s ({card}), peak device memory {peak / 2**20:.1f} MiB")

    warm = DirectLidarOdometry(cfg.odometry, cfg.prefilter, device=dev)
    for i in range(WARM_SCANS):
        process(warm, i)
    syncs = count_syncs(torch, lambda: [process(warm, i) for i in range(WARM_SCANS, WARM_SCANS + CHUNK)])
    log(f"  host syncs: {syncs} in {CHUNK} scans = {syncs / CHUNK:.2f} per scan")

    def window():
        fresh = DirectLidarOdometry(cfg.odometry, cfg.prefilter, device=dev)
        for i in range(8):
            process(fresh, i)

    idle = profile(torch, window, "host_dlo")
    summary = dict(scans_per_s=(n - WARM_SCANS) / elapsed, devkit_t_err=t_err, drift_m=drift,
                   keyframes=stats.keyframe_count, retries=stats.retries, newton_iterations=stats.total_iterations,
                   worst_step_m=float(steps.max()), syncs_per_scan=syncs / CHUNK, idle_share=idle,
                   peak_mib=peak / 2**20, jax_record=JAX_HOST_DLO)
    return summary, launches


def run_lvslam_default(torch, scans, gt, dev, card, images):
    """Phase 8b: LvSlam at its default (host DLO -> LFA mapping -> ggo) per
    scan with camera images and the shipped vocabulary, then finalize."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.graph.bow import VOCABULARY_ASSET, Vocabulary
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.pipeline.slam import LvSlam

    n = len(scans)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = LvSlam(kitti_flagship_config(), vocabulary=Vocabulary.load(str(VOCABULARY_ASSET)), device=dev)
    for i, scan in enumerate(scans):
        slam.process(scan, 0.1 * i, image=images[i])
    slam.finalize()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on LvSlam() ({n} scans): {launches}")
    missing = [name for name in ("build_lut", "ndt_derivatives_soa", "build_cell_table", "_detect_pyramid_batch")
               if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by LvSlam(): {missing}")
    dlo_t, dlo_drift = accuracy(np.stack(slam.dlo_poses), gt, f"LvSlam's DLO poses, {n} scans", n)
    lfa_t, lfa_drift = accuracy(np.stack(slam.lfa_poses), gt, f"LvSlam's LFA poses, {n} scans", n)
    backend = slam.backend
    keyframes = [k.seq for k in backend.keyframes]
    loops = [(lp.key1.seq, lp.key2.seq, round(lp.fitness, 6), round(lp.visual_score, 6)) for lp in backend.loops]
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    kf_err = [float(np.linalg.norm(p[:3, 3] - gt_rel[s][:3, 3])) for p, s in zip(slam.trajectory(), keyframes)]
    described = sum(k.descriptor is not None for k in backend.keyframes)
    log(f"  DLO keyframes {slam.dlo.keyframe_indices} ({len(slam.dlo.keyframe_indices)}), retries "
        f"{slam.dlo.stats.retries}; backend keyframes {keyframes} ({len(keyframes)}, {described} described), loops "
        f"(new seq, old seq, fitness, visual score) {loops}, loop_rejections {dict(backend.loop_detector.stats)}; "
        f"optimized keyframe error max {max(kf_err):.4f} m, last {kf_err[-1]:.4f} m")
    log(f"  the JAX reference's record of this run (CPU): {JAX_LVSLAM_DLO}")
    log(f"  one pass: {n} scans in {elapsed:.3f} s = {n / elapsed:.2f} scans/s ({card}), peak device memory "
        f"{peak / 2**20:.1f} MiB")
    if (slam.dlo.keyframe_indices != JAX_LVSLAM_DLO["dlo_keyframes"] or keyframes != JAX_LVSLAM_DLO["keyframes"]
            or [lp[:2] for lp in loops] != JAX_LVSLAM_DLO["loops"] or described != len(keyframes)):
        raise AssertionError("LvSlam() must give the JAX record's 34 DLO keyframes, 19 described backend "
                             "keyframes and its loop (135, 0)")
    summary = dict(scans_per_s=n / elapsed, dlo_devkit_t_err=dlo_t, dlo_drift_m=dlo_drift, lfa_devkit_t_err=lfa_t,
                   lfa_drift_m=lfa_drift, keyframes=keyframes, loops=loops, max_keyframe_err_m=max(kf_err),
                   last_keyframe_err_m=kf_err[-1], peak_mib=peak / 2**20, jax_record=JAX_LVSLAM_DLO)
    return summary, launches


def run_fused_lut(torch, scans, gt, dev, card):
    """Phase 8c: the fused odometry with NDTConfig(table="lut") on the first
    64 scans, in two chunks of 32."""
    import dataclasses

    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.odometry.fused import run_sequence_fused

    flagship = kitti_flagship_config()
    odometry = dataclasses.replace(flagship.odometry, ndt=dataclasses.replace(flagship.odometry.ndt, table="lut"))
    cfg = dataclasses.replace(flagship, odometry=odometry)
    xyz, mask, stamps, inten = stack_scans(torch, scans, cfg.prefilter.raw_cap, dev)
    n = len(scans)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, _, switches, _ = run_chunks(torch, run_sequence_fused, xyz, mask, stamps, inten, cfg)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on the fused LUT odometry ({n} scans): {launches}")
    missing = [name for name in ("build_lut", "ndt_derivatives_soa") if launches[name] == 0]
    if missing or launches["to_hash"] or launches["ndt_derivatives_hash"]:
        raise AssertionError(f"the LUT path must launch K3L and K6L and no hash kernel: {launches}")
    est = poses.cpu().numpy().astype(np.float64)
    t_err, drift = accuracy(est, gt, f"fused LUT odometry, {n} scans", n)
    ref = run_sequence_fused(xyz[:4].cpu(), mask[:4].cpu(), stamps[:4].cpu(), cfg.odometry, cfg.prefilter,
                             inten=inten[:4].cpu(), device="cpu").numpy()
    first_poses_vs_cpu(est, ref, "fused LUT poses")
    log(f"  keyframes {int(switches.sum())}; one pass (first, unwarmed): {n} scans in {elapsed:.3f} s = "
        f"{n / elapsed:.2f} scans/s ({card})")
    return dict(scans_per_s=n / elapsed, devkit_t_err=t_err, drift_m=drift, keyframes=int(switches.sum()))


def run_generic_align(torch, scans, gt, dev, card):
    """Phase 8d: the generic `ndt_align` (DIRECT7, unweighted) of scan 1's
    65536-lane subsample onto scan 0's keyframe map at full width, from the
    reference's first-scan guess (x = +1.5 m): tests/test_ndt.py:83 on the
    circle."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.ops import ndt, prefilter, voxel_map

    cfg = kitti_flagship_config()
    pf, ndt_cfg = cfg.prefilter, cfg.odometry.ndt

    def subsample(i, device):
        raw = PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=device)
        return prefilter.uniform_subsample(prefilter.prefilter(raw, pf), cfg.odometry.scan_matching_cap)

    def align(device):
        vm = voxel_map.build_voxel_map(
            subsample(0, device), ndt_cfg.resolution, leaf_cap=ndt_cfg.leaf_cap, lut_extent=ndt_cfg.lut_extent,
            min_points_per_voxel=ndt_cfg.min_points_per_voxel,
            min_covar_eigvalue_mult=ndt_cfg.min_covar_eigvalue_mult, weighted=ndt_cfg.weighted,
        )
        guess = torch.eye(4, device=device)
        guess[0, 3] = cfg.odometry.initial_guess_x
        return ndt.ndt_align(vm, voxel_map.build_lut(vm), subsample(1, device), guess, resolution=1.0,
                             transformation_epsilon=0.01, max_iterations=64, neighborhood="DIRECT7", weighted=False)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = align(dev)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on the generic align: {launches}")
    if launches["ndt_derivatives"] == 0:
        raise AssertionError("the generic align never launched K6G")
    got = res.transform.cpu().numpy().astype(np.float64)
    gt_rel = np.linalg.inv(gt[0]) @ gt[1]
    t_err = float(np.linalg.norm(got[:3, 3] - gt_rel[:3, 3]))
    r_err = float(se3.rotation_angle(torch.from_numpy(np.linalg.inv(gt_rel) @ got)[:3, :3]))
    log(f"  recovered scan 1 -> scan 0: translation error {t_err:.4f} m (gate 0.05), rotation error {r_err:.4f} rad "
        f"(gate 0.02), converged {res.converged} in {res.iterations} Newton iterations, {elapsed:.3f} s "
        f"map build and align included ({card})")
    if not (t_err < 0.05 and r_err < 0.02 and res.converged):
        raise AssertionError("the generic align misses tests/test_ndt.py's gates")
    with plain_twins():
        twin = align(dev)
    first_poses_vs_cpu(got[None], twin.transform.cpu().numpy()[None].astype(np.float64), "generic-align transform",
                       "on the card")
    ref = align("cpu")
    first_poses_vs_cpu(got[None], ref.transform.numpy()[None].astype(np.float64), "generic-align transform",
                       tol=CPU_SPREAD_M)
    return dict(t_err_m=t_err, r_err_rad=r_err, iterations=res.iterations, seconds=elapsed), launches


# ----------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from lv_slam_tpu_torch.kernels import KERNELS, LIBRARY
    import lv_slam_tpu_torch.pipeline.async_backend  # noqa: F401  (registers every kernel)
    import lv_slam_tpu_torch.pipeline.fused_chain  # noqa: F401

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
    if set(KERNELS) != set(DEVICE_FUNCTIONS):
        raise AssertionError(f"kernel registry {sorted(KERNELS)} != {sorted(DEVICE_FUNCTIONS)}")

    scans_all, gt_all = load_scans(N_FULL)
    scans, gt = scans_all[:N_SCANS], gt_all[:N_SCANS]
    log(f"  workload: {N_FULL} scans, mean {np.mean([s.shape[0] for s in scans_all]):.0f} returns/scan")

    log(f"phase 2: kernels vs plain versions at main-path shapes ({card})")
    records = check_kernels(torch, scans, gt, dev)
    records.update(check_lfa_kernels(torch, scans, gt, dev))
    log("phase 2c: the backend's kernels")
    records.update(check_backend_kernels(torch, scans_all, gt_all, dev))
    log("phase 2d: the camera kernels (ORB, descriptor matching)")
    records.update(check_orb_kernels(torch, gt_all, dev))
    log("phase 2e: standalone LFA's kernels (grid build, 2-NN lines / 3-NN planes, host table build)")
    records.update(check_standalone_kernels(torch, scans_all, dev))
    log("phase 2f: the LUT paths' kernels (dense LUT, LUT/SoA derivative pass, generic derivative pass)")
    records.update(check_lut_kernels(torch, scans_all, gt_all, dev))

    log("phase 3: the odometry slice end to end")
    summary, odometry_poses, odometry_syncs = run_slice(torch, scans, gt, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")

    log("phase 4: the dlo -> LFA chain end to end")
    summary, _ = run_main_path(torch, scans, gt, dev, card, odometry_poses, odometry_syncs)
    log(f"  summary ({card}): {json.dumps(summary)}")

    log("phase 5: the main path, dlo -> LFA -> ggo (pure lidar), end to end")
    summary, launches = run_full_path(torch, scans_all, gt_all, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    launch_phase = dict.fromkeys(launches, "5")

    log("phase 6: the main path as the benchmark runs it, with camera images and BoW ranking, end to end")
    t0 = time.perf_counter()
    images = render_images(gt_all, range(N_FULL))
    log(f"  {N_FULL} camera images rendered in {time.perf_counter() - t0:.1f} s (phases 6, 7b and 8b use them)")
    summary, camera_launches = run_camera_path(torch, scans_all, gt_all, dev, card,
                                               [(a, b) for a, b, _ in summary["loops"]], images)
    log(f"  summary ({card}): {json.dumps(summary)}")
    launches.update(camera_launches)
    launch_phase.update(_detect_pyramid_batch="6", match_scores_batch="6b")

    log("phase 7a: standalone LFA (device-resident, no odometry given), end to end")
    summary, lfa_launches = run_standalone_lfa(torch, scans_all, gt_all, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 7b: LvSlam(use_dlo=False), the per-scan lfa -> ggo stack with camera images, end to end")
    summary, slam_launches = run_lvslam(torch, scans_all, gt_all, dev, card, images)
    log(f"  summary ({card}): {json.dumps(summary)}")
    launches.update(build_grid=lfa_launches["build_grid"], knn=lfa_launches["knn"],
                    build_cell_table=slam_launches["build_cell_table"])
    launch_phase.update(build_grid="7a", knn="7a", build_cell_table="7b")

    log("phase 8a: the host DLO frontend (DirectLidarOdometry per scan), end to end")
    summary, dlo_launches = run_host_dlo(torch, scans_all, gt_all, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 8b: LvSlam() at its default, host DLO -> LFA -> ggo with camera images, end to end")
    summary, _ = run_lvslam_default(torch, scans_all, gt_all, dev, card, images)
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 8c: the fused odometry with table=\"lut\"")
    summary = run_fused_lut(torch, scans, gt, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 8d: the generic ndt_align (DIRECT7) at full width")
    summary, align_launches = run_generic_align(torch, scans_all, gt_all, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    launches.update(build_lut=dlo_launches["build_lut"], ndt_derivatives_soa=dlo_launches["ndt_derivatives_soa"],
                    ndt_derivatives=align_launches["ndt_derivatives"])
    launch_phase.update(build_lut="8a", ndt_derivatives_soa="8a", ndt_derivatives="8d")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(
            name=name, route="cuda", source=k.source, replaces=k.replaces,
            launches=launches[name], launch_phase=launch_phase[name], **{key: records[name][key] for key in keys},
            **({"cholesky_ms": records[name]["cholesky_ms"]} if "cholesky_ms" in records[name] else {}),
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
