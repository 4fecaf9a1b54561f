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

Phase 2 holds every kernel, those of the backend too (2c: the window dedup
K1b/K2, the batched NDT pass K13, the centroid grid K14 and the pose-graph
normal equations K15), against its plain version at the shapes phase 5
gives it.

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


def make_backend(dev, asynchronous: bool):
    """The reference benchmark's `make_backend` (`bench.py:257-313`) in the
    pure-lidar configuration: no vocabulary, no images."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.config import GraphConfig, LoopDetectorConfig
    from lv_slam_tpu_torch.pipeline.async_backend import AsyncBackend
    from lv_slam_tpu_torch.pipeline.backend import GlobalGraph

    backend = GlobalGraph(
        GraphConfig(keyframe_cap=64, edge_cap=256, prior_cap=16, solver_num_iterations=64),
        LoopDetectorConfig(), prefilter_cfg=kitti_flagship_config().prefilter, device=dev,
    )
    return AsyncBackend(backend) if asynchronous else backend


def run_full(torch, xyz, mask, stamps, inten, cfg, backend):
    """One pass of the full path, as the reference benchmark's `run_chain`:
    chunk k's chain is launched before chunk k-1's refined poses are read
    and fed, with its filtered product, to the backend (on the backend's
    worker when it is an AsyncBackend); `optimize()` every 100 scans, then
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
        graph.add_scan_batch(s, stamps_np[s:e], poses, cloud, filtered=True)
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
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the full path: {missing}")
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

    log("phase 3: the odometry slice end to end")
    summary, odometry_poses, odometry_syncs = run_slice(torch, scans, gt, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")

    log("phase 4: the dlo -> LFA chain end to end")
    summary, _ = run_main_path(torch, scans, gt, dev, card, odometry_poses, odometry_syncs)
    log(f"  summary ({card}): {json.dumps(summary)}")

    log("phase 5: the main path, dlo -> LFA -> ggo (pure lidar), end to end")
    summary, launches = run_full_path(torch, scans_all, gt_all, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(
            name=name, route="cuda", source=k.source, replaces=k.replaces,
            launches=launches[name], **{key: records[name][key] for key in keys},
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
