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
   scans 0-3 at their true poses, and scan 4's features as queries; K9a
   also over its one-launch cap (scans 4 and 5's surf batches in one
   insert: the route with the sort glue, under `over_cap`) and K11 at
   standalone LFA's shape (scan 4's sharp / flat features on scan 3's
   grids, under `standalone`). K1 and K8 are also held bit for bit to
   their twins run on a CPU copy, on their edge cases (`sort_cases`,
   `feature_cases`), with no synchronizing call and no device work but
   their own; `torch.sort` of K1's keys is timed beside K1. K3 likewise
   makes no synchronizing call and launches nothing but its own kernels,
   agrees with its twin on the card (validity, keys, n_leaves and origin
   identical) and on `map_cases` with the card's twin and the CPU twin
   (`map_agrees`), and `torch.sort` of the twin's keys is timed beside it;
   phase 2c does the same for K2 (`window_cases`) and K1b (`sort_cases`),
   bit for bit against their CPU twins, and times K3 at the loop
   detector's 4 m rung (under `rung_4m`). K5 (`to_hash`) is one C call
   with no synchronizing call and no device work but its own, its table
   and n_dropped bit-identical to its twin on the card and on a CPU copy,
   there and on its edge cases (`hash_cases`). K10's fits
   are held to the twin on a CPU copy too (decisions identical, the lines'
   means bit-identical) there and on their edge cases (`fit_cases`), one
   launch each and no synchronizing call. Masks,
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
   memory are measured; the profile lists every hand kernel of `csrc/`
   wherever it ranks, with its launches and ms per launch, and counts the
   library radix sort's launches left on the path.
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
   peak memory measured, and a traced pass of the whole run prints K9k's
   and K9g's device totals and the library's onesweep launches (none: K9g
   sorts with its own kernels). 7b: the per-scan orchestrator
   `LvSlam(kitti_flagship_config(), use_dlo=False, vocabulary=<the port's
   asset>)`, each scan with its camera image, then `finalize()`; gates: the
   LFA poses' accuracy, the reference record's 19 keyframes, a loop, K9c
   launched; a second whole pass records the mapping's 338 table builds,
   and their replay in a trace prints K9c's device total (its passes
   included). Both print the JAX reference's CPU records of the same runs
   beside their results.
8. The LUT paths, the reference's default odometry (`LvSlam`'s host DLO).
   8a: `DirectLidarOdometry(kitti_flagship_config().odometry, .prefilter)`
   per scan over the 170 scans as `bench.py`'s host cell drives it (3 warm
   scans, then timed, one upload per scan); gates: the accuracy gates, the
   JAX record's 34 keyframes (0, 5, ..., 165), no retry kept on a
   warm-started scan, K3L and K6L launched, K21 (`uniform_subsample`) once
   per scan, the first four poses equal to those with K3L's, K6L's, K6G's
   and K21's twins on the card to 1e-4 and within the reference's own
   spread (1e-2) of the CPU plain path's (the two devices' plain map builds
   differ in a few rounding-noise leaves); scans/s, host syncs per scan,
   idle share; then a fresh pass's 170 subsamples replayed by K21 and by its
   plain twin, each in one trace (their device totals and launches), and its
   aligns replayed in one trace (`align_replay`: the device totals and
   launches of K6L's gated pass and of `newton_step`). 8b: `LvSlam(kitti_flagship_config(),
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

9. The backend's other inputs and outputs. 9a: the main path of phase 6
   (camera images, the shipped vocabulary) with the backend's default feed,
   the raw chunk (`add_scan_batch(filtered=False)`: K2r per window group),
   and GPS (truth + [500, 300, 0] + 0.2 m noise), the IMU orientation and
   acceleration on the keyframes' scans, with `enable_gps` and
   `enable_imu_*`; gates: phase 6's keyframes, the loop (135, 0), three
   priors per keyframe, the last LM equal to the plain path's re-solve on
   the CPU to 1e-4, and, run again with exact GPS, the largest optimized
   keyframe error within 0.1 m of phase 6's; scans/s, idle share, peak
   memory, K2r's launches; the profiled pass's library onesweep launches
   beside the port's calls of torch's sorts by caller (`sort_callers`: none
   may come from the window group, and any onesweep launch needs a
   caller); and the first pass's window groups replayed by K2r in one trace
   (its whole device time and launches, no onesweep launch, no device work
   but its own). 9b: `LvSlam()` with images, `detect_floor=True`
   on every scan and the same readings on its keyframes' scans; gates: the
   floor found on every scan 1.73 m (within 0.1 m) below the sensor, one
   shared fixed floor plane that stays where it is, one floor edge and
   three priors per keyframe, 19 keyframes and the loop (135, 0), the last
   LM equal to the plain path's re-solve on the CPU to 1e-4, and that graph
   re-solved on the CPU with exact GPS and without the floor edges within
   0.1 m of phase 8b's largest keyframe error (with exact GPS and the floor,
   and with noisy GPS without it, printed beside); after the timed pass,
   the clouds it handed K16 are rebuilt (the DLO's prefilter of each scan),
   K16 gives the pass's results on them again, and its 170 detections are
   traced. 9c:
   9b's backend dumped, resumed by `load_dump` (its chi2 at the dumped
   estimates within 1e-4 of the dumped graph's), re-optimized (poses within
   1e-3 of the dumped estimates and of the dumped graph solved once more),
   its map saved at 0.05 m (kernel 1 at the map's shape timed
   against its twin) and its pose files written. 9d: `tests/test_multi_loop.py`'s 160-scan VLP-16 double
   circle with drifting odometry through the raw feed: three or more loops
   spaced by the interval gate, more than twice as many verified, the tail
   error shrunk below 0.6 of the odometry's, and the JAX reference's record
   of the same run: its keyframe count, loop pairs and loop counters.
10. The registrations and the prefilter's last branches. 10a: the
   registration factory (`select_registration_method`, reference
   `registrations.cpp`) on scans 40 -> 41 of the circle through the flagship
   prefilter (131072 lanes), from tests/test_registrations.py's perturbed
   guess, with `max_iterations=40`: NDT_OMP (DIRECT7), NDT_PCA (DIRECT1),
   ICP and GICP; gates: that test's translation bounds (0.06, 0.06, 0.25,
   0.10 m), fitness < 0.5, the transform within the stated tolerance of the
   plain path on the card, ICP launching K17 41 times and GICP K19a 21 and
   K19b 20 times; each method's warm ms per align. 10b: `ndt_ground_align`
   of scan 41 onto scan 40's 10 m map from a 0.5 m z error; gates: x and y
   within 5e-3 m, |z| < 0.4 m, K20 and K6G launched, equal to the plain path
   on the card to 1e-4. 10c: the host DLO (flagship config) over the 170
   scans with `outlier_removal_method="STATISTICAL"` and
   `use_angle_calibration=True`, then with `"RADIUS"`; gates: the accuracy
   gates, K18 (and K0a) launched once per scan, the first four poses equal
   to the plain path's on the card to 1e-4 and within the reference's
   one-ulp spread (1e-2) of the CPU plain path's (as phase 8a); scans/s and
   the lanes each removal dropped per scan.
11. Several sequences and several ranks (`lv_slam_tpu_torch.parallel`).
   11a: `run_fleet_odometry` without a mesh, as bench.py's `BENCH_FLEET`
   runs the reference's (scans 0-39 at 65536 lanes, the flagship odometry
   and LFA, 1 and 4 lanes of 32 scans, lane i from scan 2i, best of two
   warm passes); gates: every lane of the 4-lane pass equal to its
   single-sequence run (`run_sequence_fused` -> `run_sequence_lfa`) bit for
   bit and inside the accuracy gates; fleet_scans_per_sec_per_lane_b4,
   fleet_throughput_retention_b4 and the 4-lane pass's idle share. 11b: in
   a single-process NCCL world of one rank, mesh (1, 1): `ndt_align_sharded`
   on K13's batch at the 1 m rung (8 x 131072 lanes, DIRECT7) equal to
   `ndt_align_soa` of each pair bit for bit (its launches counted: K6L,
   `newton_sums` and K7 once per iteration), `optimize_pose_graph_sharded`
   on phase 2c's graph equal to `optimize_pose_graph` bit for bit (K15's
   sums have a fixed order); then a spawned gloo world of two ranks on the
   same card (NCCL refuses two ranks on one GPU), meshes (1, 2) and (2, 1), through
   `lv_slam_tpu_torch.parallel.check` (the CPU tests' rank body): the
   sharded derivatives, two aligns and the LM within its TOLERANCES of the
   unsharded port, both ranks bit-identical. 11c (in the
   NCCL world): `entry()`'s odometry step against the CPU plain path's
   within 1e-2 and `dryrun_multichip(1)`.

Phase 2 holds every kernel, those of the backend too (2c: the window dedup
K1b/K2, the batched NDT pass K13, the centroid grid K14, one C call with
no synchronizing call and no device work but its own, `torch.sort` of the
twin's keys timed beside it, and on `grid_cases` (an empty and an
all-masked cloud, leaf_cap below the runs, points an ulp either side of
cell faces, cells at the 1024 extent's edges, one cell holding every
point, sentinel lanes among real points) with its column probe's queries
bit for bit, and the pose-graph normal equations K15; 2b: the LFA's
kernels, K9b's crop of both tables in one launch (gate open, closed and
absent, and `crop_cases`) among them; 2d: ORB K12 on four keyframe images
of the circle, one C call with no synchronizing call and no device work
but its own (no torch.topk), bit for bit against its twin on the card and on a CPU copy,
there and on `orb_cases` (ties at the cut, a blank image, noise, a plateau
of equal scores past the select's shared memory, batches of 1 and 32, an
image whose k nears h x w), `torch.topk` of the twin's keys timed beside
it, and the descriptor matching K12b of one keyframe against eight, then K12b bit
for bit on `match_cases` (caps 1 to 1000, 1 to 32 candidates, masks with
holes, ties, pairs at max_dist, all-masked sets, cap 4096); 2e: standalone
LFA's grid build K9g, its 2-point lines / 3-point planes K9k and the host
mapping's table build K9c (both builds one C call with no synchronizing
call and no device work but their own, `torch.sort` of the twins' keys
timed beside them, K9c at both maps' shapes), then K9k's three entries with
K9g's grid on `knn_cases` (K9g's tail of masked and out-of-extent lanes
among 131072, three fields of 16 bits, a span past 2^31 cells among them)
and K9c on `table_cases` (every row masked, 40 rows in one cell, 256
buckets, 5001 rows, 2^15 and 2^18 buckets), bit for bit their twins; 2f: the dense LUT K3L, the LUT/SoA derivative
pass K6L and the generic one K6G on the host DLO's 32768-leaf keyframe map
and 65536-lane subsample, at the true pose and one 0.3 m off (each
standalone call one launch of `lut_pass`, no other device work, no
synchronizing call; K6L's gated Newton-loop pass one launch, its rows the
standalone sums in row order and the same bits twice; the gated pass alone,
DIRECT7 and `newton_step` over the pass's rows timed beside their bounds),
and on `lut_cases` (points within an ulp of a cell face, cells at and past
the extent for each DIRECT7 offset, an all-masked cloud, 1001 lanes, valid
lanes ending mid-row, masked, sentinel and gate-rejected lanes, a finished
candidate, DIRECT26, 131073 lanes: each standalone call one launch, no
synchronizing call, against the twin; each gated pass's rows the standalone
sums, a finished candidate's untouched), and the
subsample K21 (one launch with no synchronizing call and no device work
but its own) of scan 1's filtered cloud (45881 points into 65536 lanes)
and on `subsample_cases` (no point set, fewer points than out_cap, exactly
out_cap, KITTI density's 100000 into 65536, a holey mask, out_cap at the
lanes, a ragged tail) bit for bit its twin on a CPU copy; 2g: the raw
window group K2r at 16 x 131072 raw lanes (one C call with no
synchronizing call and no device work but its own, bit for bit its twin on
a CPU copy, there and on `raw_window_cases`: a group of 1 into more rows
than lanes, of 16, out_cap below the voxels, rows clipped to the chunk,
every row invalid, a move past the yz clip, points within 4 ulps of both
band edges), K15 with 192 priors, 64
SE3-plane edges and a fixed floor plane, and floor detection K16 on a
filtered scan and on `floor_cases`, its coefficients also bit for bit the
parent kernel's (`FLOOR_PARENT_COEFFS`); 2h: K17's nearest centroids and one ICP iteration, K9g's
two 131072-lane grids at 1 m (its key sort's route; the target's timed), K9k's
`knn` at GICP's three calls (a thread a query over a sample of the keys), K19a's
covariances (the source's, and the target's on K19b's lanes, timed beside
the same call on every lane) and K19b's normal equations on scan 41's 131072
lanes against scan 40 at phase 10's guess, K18's two removals and K20 on
scan 40, K0a's prefilter front (the calibration of raw scan 40, the main
path's band on raw scan 0, both in one pass; bit for bit their twins there
and on `front_cases`; the band's torch chain timed beside it), against its plain version at the shapes phases 5-10 give
it. Phase 1 fails unless ptxas gives K19a's k = 8 instance no stack frame;
phases 3-5 and 8a fail unless the band's kernel launched once per
prefiltered scan, 10c unless K0a's calibration carried the band.
Phase 2i holds the device-side loops against their
twins: K7's `newton_step` (the Newton step of every align, with the
derivative passes gated on the loop's `done` flag) step by step from
identical states, on 2f's map and 65536-lane subsample from three starts
and on K13's batch of 8 x 131072 lanes at the 1 m rung (2c's), the
sharded align's per-lane sums (`newton_sums`) on that batch's partial rows
bit for bit against the plain block-by-block adds, and on `sums_cases`
(1 to 2049 blocks, finished lanes, NaN and infinite rows), then whole
aligns and the rung, timed device and wall against the twins' loop, with
their host reads counted (at most ceil((iterations + 1) / NEWTON_GROUP)
per align, none per rung, none in a whole `dispatch_one`); and the LM
(an iteration is two hand launches around the library Cholesky: K15's
damped system, then `lm_step`) on 2c's and 2g's graphs: one iteration from
identical states, whole optimizes against the twin's loop on the card, the
reads of `done` and the wasted solves (iterations launched after done) per
optimize, then `lm_cases` (a failed Cholesky, a NaN step, done in the
middle of a group, node 0 with fixed nodes and a fixed plane, empty and
invalid families, more variables than the cluster's warps, one
iteration), K15's three modes one launch each and the hand launches an
iteration takes, counted from a trace. Phase
2j holds K9n (`knn_cell`, the k nearest of a cell table's 8-cell probe) on
the flagship LFA's world maps with scan 4's sharp and flat features, and
K10g (the line / plane fits' KnnGrid branch) on scan 3's grids with the
same queries, against their plain versions: K9n identical, K10g's
decisions identical and its fitted floats judged as `ops/gicp.py` judges
plane covariances (`registration.grid_fit_error`).

The last lines are the kernels' JSON record (each kernel's launches are
counted on the run of the path that drives it: phase 5 for the lidar
kernels and the LM's, 3 for K7's `newton_step` (with its launches on 8a,
on 5 over K13's pass and on 10b under `launches_by_phase`), 6 for K12, 6b
for K12b, 7a for K9g and K9k, 7b for K9c, 8a for K3L, K6L and K21, 8d for K6G,
9a for K2r, 9b for K16, 10a for K17, K19a and K19b, 10b for K20, 10c for
K18 and K0a, 11b for `newton_sums` (the sharded align's), and 2j's own
checks for K9n and K10g, which no path calls,
named under `launch_phase`), the card's name and power limit, and
`{"ok": true, "device": {...}}`. Without a CUDA device the script exits
non-zero before it prints any result.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import NamedTuple, Optional

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
    "voxel_downsample": ("voxel_ranges", "voxel_keys", "key_sort_pass", "voxel_runs"),
    "build_voxel_map": ("leaf_ranges", "leaf_keys", "key_sort_pass", "leaf_runs"),
    "to_hash": ("hash_init", "hash_slot0", "hash_slot1", "hash_rows"),
    "ndt_derivatives_hash": ("ndt_partials", "ndt_finish"),
    "extract_features": ("fill_best", "project", "select_sector"),
    "insert_cell_table": ("insert_cluster", "insert_keys", "insert_keep", "insert_place"),
    "crop_cell_table": ("crop_tables",),
    "lines_from_fit": ("lines",),
    "planes_from_fit": ("planes",),
    "gn_solve": ("gn_cluster",),
    "voxel_dedup_first": ("voxel_ranges", "voxel_keys", "key_sort_pass", "dedup_runs"),
    "window_group_filtered_fn": ("window_ranges", "voxel_keys", "key_sort_pass", "dedup_runs"),
    "_fused_verify_fn": ("ndt_partials", "ndt_finish"),
    "build_centroid_grid": ("grid_ranges", "grid_keys", "key_sort_pass", "grid_runs"),
    "nn_sq_dists": ("grid_query", "grid_finish"),
    "_chi2_and_normal": ("normal_cluster",),
    "_detect_pyramid_batch": ("orb_level0", "orb_halve", "orb_pixels", "orb_keys", "orb_select", "orb_describe"),
    "match_scores_batch": ("match_cluster",),
    "build_grid": ("knn_grid_cluster", "knn_grid_ranges", "knn_grid_pack", "key_sort_pass", "knn_grid_place"),
    "knn": ("knn_query", "knn_lines", "knn_planes"),
    "build_cell_table": ("table_clear", "table_count", "key_sort_pass", "table_fill"),
    "build_lut": ("lut_fill", "lut_scatter"),
    "ndt_derivatives_soa": ("lut_pass",),
    "ndt_derivatives": ("lut_pass",),
    "window_group_fn": ("window_raw_ranges", "voxel_keys", "key_sort_pass", "voxel_runs"),
    "uniform_subsample": ("subsample_cluster",),
    "detect_floor": ("floor_count", "floor_finish"),
    "nn_points": ("nn_points_kernel", "icp_match", "icp_means", "icp_cov", "icp_update"),
    "radius_outlier_removal": ("outlier_radius",),
    "statistical_outlier_removal": ("stat_dist", "stat_mean", "stat_var", "stat_thresh", "stat_keep"),
    "vertical_angle_calibration": ("prefilter_front",),
    "distance_filter": ("prefilter_front",),
    "_plane_covariances": ("plane_cov",),
    "gicp_align": ("gicp_normal", "gicp_finish"),
    "filter_ground_leaves": ("ground_filter",),
    "newton_step": ("newton_step",),
    "newton_sums": ("newton_sums",),
    "optimize_pose_graph": ("lm_damp", "lm_step", "lm_accept"),
    "knn_cell": ("knn_cell_query",),
    "grid_fits": ("grid_lines", "grid_planes"),
}


def _is_function(key: str, fn: str) -> bool:
    """Whether a profiler kernel name (demangled or Itanium-mangled, a
    template's instance too) is `fn`."""
    return any(f"::{fn}{c}" in key or key.startswith(f"{fn}{c}") for c in "(<") or any(
        f"{len(fn)}{fn}{c}" in key for c in "EI")


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
    most half of `reps` is taken again, four times at most."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
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
        raise AssertionError(f"five traces held whole device work for at most {reps // 2} of {reps} calls")
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


def foreign_functions(torch, fn, functions, reps: int = 5):
    """(names of the device work a call of `fn` launches besides
    `functions`, the number of device launches of a call), from the calls
    that a torch.profiler trace holds whole (`whole_calls`: the trace may
    lack records); a trace with no whole call is taken again, five times at
    most."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.cuda._sleep(1000)
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        calls = [call for call in whole_calls(names) if call]
        if calls:
            break
    else:
        raise AssertionError(f"five traces held no whole call of {functions}")
    others = {names[i] for call in calls for i in call if not any(_is_function(names[i], f) for f in functions)}
    return sorted(others), len(calls[0])



def one_call(torch, name: str, fn) -> int:
    """(launches of a call of `fn`): one C call, no synchronizing call, no
    device work but the kernel's own."""
    syncs = count_syncs(torch, fn)
    glue, n_launches = foreign_functions(torch, fn, DEVICE_FUNCTIONS[name])
    if syncs or glue:
        raise AssertionError(f"{name}: {syncs} synchronizing calls, device work besides its own: {glue}")
    return n_launches


def loop_pass_checks(torch, name: str, fn, functions=None) -> dict:
    """A Newton-loop wrapper's call `fn` (the gated pass, the step): one
    launch of its own kernel, no other device work, no synchronizing call."""
    functions = functions or LOOP_FUNCTIONS[name]
    syncs = count_syncs(torch, fn)
    glue, n_launches = foreign_functions(torch, fn, functions)
    if syncs or glue or n_launches != 1:
        raise AssertionError(f"{name}: {syncs} synchronizing calls, {n_launches} launches a call, device work besides "
                             f"its own: {glue}")
    log(f"  {name}'s Newton-loop wrapper: one launch of {functions[0]}, no other device work, no synchronizing call")
    return dict(loop_launches=n_launches, loop_syncs=syncs)



def same_twice(torch, name: str, launch, out) -> None:
    """Two calls of `launch` write the same bits into `out` (the pass's
    partial rows: a fixed order of sums, no float atomics)."""
    launch()
    first = out.clone()
    out.fill_(float("nan"))
    launch()
    torch.cuda.synchronize()
    if not torch.equal(first.view(torch.int32), out.view(torch.int32)):
        raise AssertionError(f"{name}: two launches on the same inputs wrote other bits")
    log(f"  {name}: two launches on the same inputs wrote the same bits")

# the kernel each Newton-loop wrapper launches: the gated passes, the step
LOOP_FUNCTIONS = {"ndt_derivatives_hash": ("ndt_partials",), "_fused_verify_fn": ("ndt_partials",),
                  "newton_step": ("newton_step",), "ndt_derivatives_soa": ("lut_pass",),
                  "ndt_derivatives": ("lut_pass",)}


def probe_sectors(torch, hm, xs, mask, transforms, offsets) -> dict:
    """The hash pass's probes whose cell lies in the extent and their hits
    (counted with the plain pass's keys, for candidates xs (k, 3, n)), and
    the table's 32-byte sectors: those the probes fetch from L2, repeats
    included (the earlier kernel 4 sectors (128 B) a probe; the shipped one
    the two slots' key sectors a probe and the matching slot's tail sector a
    hit, its head and covariance sharing its key's), and `needed_bytes`,
    the distinct sectors that the probes need, each once: a probe's slot-0
    key sector, slot 1's where slot 0 does not match, the hit slot's tail
    sector. The hash pass's byte bound counts these."""
    from lv_slam_tpu_torch.ops import ndt_hash
    from lv_slam_tpu_torch.ops.cells import cell_coords

    e, b_bits = hm.extent, hm.table.shape[0].bit_length() - 1
    probes = hits = 0
    needed = []
    for c in range(xs.shape[0]):
        y = torch.einsum("ij,jn->in", transforms[c, :3, :3], xs[c]) + transforms[c, :3, 3:]
        cells = cell_coords(y.T, hm.resolution).T - hm.origin_cell[:, None]
        for o in range(offsets.shape[0]):
            rel = cells + offsets[o][:, None]
            live = torch.all((rel >= 0) & (rel < e), dim=0) & mask[c]
            key = ((rel[0] * e + rel[1]) * e + rel[2]).to(torch.int32)
            bucket = ndt_hash._hash(torch.where(live, key, -1), b_bits).to(torch.int64)
            row = hm.table[bucket]
            slot0, slot1 = row[:, 0].contiguous().view(torch.int32), row[:, 16].contiguous().view(torch.int32)
            hit0, hit1 = live & (slot0 == key), live & (slot0 != key) & (slot1 == key)
            probes += int(live.sum())
            hits += int((hit0 | hit1).sum())
            needed += [4 * bucket[live], 4 * bucket[hit0] + 1, 4 * bucket[live & ~hit0] + 2, 4 * bucket[hit1] + 3]
    n_needed = int(torch.unique(torch.cat(needed)).numel())
    return dict(probes=probes, hits=hits, parent_bytes=128 * probes, kernel_bytes=32 * (2 * probes + hits),
                needed_bytes=32 * n_needed)


def log_sectors(name: str, rec: dict) -> None:
    sec = rec["l2_sectors"]
    log(f"    {name}: {sec['probes']} probes in the extent, {sec['hits']} hits; table sectors needed, each once "
        f"{sec['needed_bytes'] / 1e6:.3f} MB (counted in the bound's {rec['bound_ms']:.5f} ms, {rec['bound_by']}); "
        f"fetched from L2, repeats included, {sec['kernel_bytes'] / 1e6:.2f} MB "
        f"({sec['kernel_bytes'] / PEAK_BYTES_PER_S * 1e3:.5f} ms at the HBM rate; the earlier kernel's whole rows "
        f"{sec['parent_bytes'] / 1e6:.2f} MB)")


def ptxas_usage(text: str, names=("newton_step", "newton_sums", "ndt_partials", "lut_pass")) -> dict:
    """{mangled kernel: {registers, spills (store + load bytes), stack}} of
    the kernels whose names hold one of `names`, from ptxas -v's lines."""
    out, current = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line.split("'")[1] if "'" in line else line.split()[-1]
            current = fn if any(n in fn for n in names) else None
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out.setdefault(current, {}).update(stack=nums[0], spills=nums[1] + nums[2])
        elif current and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            out.setdefault(current, {})["registers"] = int(words[words.index("Used") + 1])
    return out

def on_cpu(cloud):
    from lv_slam_tpu_torch.core.cloud import PointCloud

    return PointCloud(cloud.xyz.cpu(), cloud.intensity.cpu(), cloud.mask.cpu())


def on_copies(tables, fn):
    """A `device_ms` callable that runs `fn` on its own copy of the cell
    table `tables` (or of each of a tuple of them) at each call, so every
    timed call does the same work. The copies, enough for `device_ms`'s five
    traces, are made here, before the timing."""
    from lv_slam_tpu_torch.ops.knn import CellTable

    tables = (tables,) if isinstance(tables, CellTable) else tables
    copies = iter([[CellTable(t.table.clone(), t.cell_size) for t in tables] for _ in range(WARM + 5 * REPS)])
    return lambda: fn(*next(copies))


def timed(torch, name, kernel_fn, plain_fn, err, n_bytes, n_ops, what=""):
    """`name`'s device-only times beside its bound, as a record."""
    ms, wrapper_ms, n_kernel = device_ms(torch, kernel_fn, DEVICE_FUNCTIONS[name])
    _, plain_ms, n_plain = device_ms(torch, plain_fn)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"    {name}{what}: kernel {ms:.4f} ms (wrapper with its torch glue {wrapper_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}) [device-only, median of "
        f"{n_kernel} / {n_plain} whole calls of {REPS}]")
    return dict(
        max_abs_err=float(err), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, wrapper_device_ms=wrapper_ms,
    )


def measure(torch, records, name, kernel_fn, plain_fn, err, n_bytes, n_ops):
    """Times `name` device-only and records it beside its bound."""
    records[name] = timed(torch, name, kernel_fn, plain_fn, err, n_bytes, n_ops)


SORT_LANES = 1 << 17  # K1's edge cases: phase 2's lane count
SORT_CASE_NAMES = ("every lane masked", "one voxel holding every point", "clip range, both signs of kx",
                   "out_cap below the runs", "APPROX_VOXELGRID", "out_cap above the lanes", "1025 lanes")


def _voxel_scene(rng, n: int) -> np.ndarray:
    """(n, 4) lidar-like points and intensities: spread over +-60 m with
    both signs, clusters of 4 inside one 0.1 m cell, points on cell faces."""
    centers = rng.uniform(-20.0, 20.0, (n // 8, 3))
    near = np.repeat(centers, 4, axis=0) + rng.normal(0.0, 0.01, (4 * (n // 8), 3))
    pts = np.concatenate([rng.uniform(-60.0, 60.0, (n - len(near), 3)), near])
    pts[rng.integers(0, n, n // 64)] = np.round(rng.uniform(-30.0, 30.0, (n // 64, 3)), 1)  # on faces
    return np.concatenate([pts, rng.uniform(0.0, 1.0, (n, 1))], axis=1).astype(np.float32)[rng.permutation(n)]


def sort_cases(seed: int = SEED):
    """K1's edge cases as numpy arrays: (name, points (n, 4) xyz and
    intensity, mask (n,), resolution, out_cap, method). Every lane masked;
    one 0.1 m voxel holding all 131072 points (a single run whose sum order
    matters; the key has no bit, the sort one pass); coordinates over the
    whole `_pack_yz` clip range and both signs of kx (every digit of a
    ~61-bit key moves, 8 passes), with masked lanes holding NaN and
    unmasked lanes at kx >= 2^30, which the twin's key counts as masked;
    out_cap below the number of runs; APPROX_VOXELGRID; out_cap above the
    lane count; a few lanes past a tile (1025)."""
    rng = np.random.default_rng(seed)
    n = SORT_LANES
    out = [("every lane masked", _voxel_scene(rng, n), np.zeros(n, bool), 0.1, n, "VOXELGRID")]
    one = np.empty((n, 4), np.float32)
    one[:, :3] = rng.uniform(0.005, 0.095, (n, 3)) + np.array([12.3, -4.5, 0.7])
    one[:, 3] = rng.uniform(0.0, 1.0, n)
    out.append(("one voxel holding every point", one, np.ones(n, bool), 0.1, 8, "VOXELGRID"))
    bases = np.stack([rng.uniform(-1.0e8, 1.0e8, n // 8), rng.uniform(-3000.0, 3000.0, n // 8),
                      rng.uniform(-3000.0, 3000.0, n // 8)], axis=1)
    wide = np.repeat(bases, 8, axis=0) + rng.normal(0.0, 0.01, (n, 3))
    wide[: n // 256, 0] = rng.uniform(1.08e8, 2.0e8, n // 256)  # kx past 2^30
    wide = np.concatenate([wide, rng.uniform(0.0, 1.0, (n, 1))], axis=1).astype(np.float32)[rng.permutation(n)]
    mask = rng.random(n) >= 0.1
    wide[~mask, :3] = np.nan
    out.append(("clip range, both signs of kx", wide, mask, 0.1, n, "VOXELGRID"))
    scene = _voxel_scene(rng, n)
    out.append(("out_cap below the runs", scene, rng.random(n) >= 0.05, 0.1, 4096, "VOXELGRID"))
    out.append(("APPROX_VOXELGRID", scene, rng.random(n) >= 0.05, 0.1, n, "APPROX_VOXELGRID"))
    out.append(("out_cap above the lanes", _voxel_scene(rng, 16384), np.ones(16384, bool), 0.1, 32768,
                "VOXELGRID"))
    out.append(("1025 lanes", _voxel_scene(rng, 1025), np.ones(1025, bool), 0.05, 1025, "APPROX_VOXELGRID"))
    assert tuple(name for name, *_ in out) == SORT_CASE_NAMES
    return out


def identical_clouds(torch, a, b) -> bool:
    """Masks equal and every float bit equal (both on the CPU)."""
    return torch.equal(a.mask, b.mask) and all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                                               for x, y in ((a.xyz, b.xyz), (a.intensity, b.intensity)))


def check_sort_cases(torch, dev):
    """K1 against its twin run on a CPU copy, bit for bit, on every case of
    `sort_cases`, one launch each; returns the number of cases."""
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import prefilter

    cases = sort_cases()
    for name, pts, mask, res, out_cap, method in cases:
        cpu = PointCloud(torch.from_numpy(pts[:, :3].copy()), torch.from_numpy(pts[:, 3].copy()),
                         torch.from_numpy(mask))
        card = PointCloud(cpu.xyz.to(dev), cpu.intensity.to(dev), cpu.mask.to(dev))
        before = KERNELS["voxel_downsample"].launches
        got = prefilter.voxel_downsample(card, res, out_cap, method)
        torch.cuda.synchronize()
        if KERNELS["voxel_downsample"].launches != before + 1:
            raise AssertionError(f"voxel_downsample ({name}): not one launch")
        got = PointCloud(got.xyz.cpu(), got.intensity.cpu(), got.mask.cpu())
        want = prefilter.voxel_downsample_ref(cpu, res, out_cap, method)
        if not identical_clouds(torch, got, want):
            raise AssertionError(f"voxel_downsample ({name}): {int(got.mask.sum())} voxels against the CPU "
                                 f"twin's {int(want.mask.sum())}, not bit-identical")
    return len(cases)


def check_dedup_cases(torch, dev):
    """K1b (`voxel_dedup_first`) against its twin run on a CPU copy, bit for
    bit, on every case of `sort_cases` (their out_cap; the method is K1's),
    one launch and no synchronizing call each; returns the number of cases."""
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import prefilter

    cases = sort_cases()
    for name, pts, mask, res, out_cap, _ in cases:
        cpu = PointCloud(torch.from_numpy(pts[:, :3].copy()), torch.from_numpy(pts[:, 3].copy()),
                         torch.from_numpy(mask))
        card = PointCloud(cpu.xyz.to(dev), cpu.intensity.to(dev), cpu.mask.to(dev))
        before = KERNELS["voxel_dedup_first"].launches
        got = []
        syncs = count_syncs(torch, lambda: got.append(prefilter.voxel_dedup_first(card, res, out_cap)))
        torch.cuda.synchronize()
        if KERNELS["voxel_dedup_first"].launches != before + 1 or syncs:
            raise AssertionError(f"voxel_dedup_first ({name}): {KERNELS['voxel_dedup_first'].launches - before} "
                                 f"launches, {syncs} synchronizing calls")
        want = prefilter.voxel_dedup_first_ref(cpu, res, out_cap)
        if not identical_clouds(torch, on_cpu(got[0]), want):
            raise AssertionError(f"voxel_dedup_first ({name}): {int(got[0].mask.sum())} voxels against the CPU "
                                 f"twin's {int(want.mask.sum())}, not bit-identical")
    return len(cases)


MAP_LANES = 1 << 14  # K3's edge cases
MAP_CASE_NAMES = ("every lane masked", "one voxel holding every lane", "lanes out of extent",
                  "more runs than leaf_cap", "min_points and min_points - 1", "collinear and coplanar voxels",
                  "NaN on masked lanes", "weighted", "unweighted", "1025 lanes", "e = 64")


def _blobs(rng, n: int, span: float, spread: float = 0.12) -> np.ndarray:
    """(n, 3) points in round blobs of 24 about centers spread over +-span m
    (both signs): each 1 m voxel a blob reaches holds a well-conditioned
    covariance, so leaf validity is no rounding call."""
    centers = rng.uniform(-span, span, (-(-n // 24), 3))
    pts = np.repeat(centers, 24, axis=0)[:n] + rng.normal(0.0, spread, (n, 3))
    return pts.astype(np.float32)[rng.permutation(n)]


def map_cases(seed: int = SEED):
    """Kernel 3's edge cases as numpy arrays: (name, points (n, 3), mask (n,),
    resolution, leaf_cap, extent, weighted), min_points 6 and the eigenvalue
    floor 0.01 throughout. Every lane masked; one 1 m voxel holding all
    16384 lanes (one run across 16 tiles, one thread's chain; the key has no
    bit); a scene over 600 cells, so that lanes lie past the 256-cell extent
    (and some at 1e9 m, far beyond); ~1800 runs into a leaf_cap of 256; voxels of
    exactly 6 and 5 points; points exactly on lines and on planes (a
    degenerate pair and a zero eigenvalue, floored by the inflation);
    masked lanes holding NaN; a weighted and an unweighted scene; 1025
    lanes at 0.5 m; the 64-cell extent of `entry.py`'s maps."""
    rng = np.random.default_rng(seed)
    n = MAP_LANES
    scene = _blobs(rng, n, 60.0)
    out = [("every lane masked", scene, np.zeros(n, bool), 1.0, 4096, 256, True)]
    one = (rng.uniform(0.02, 0.98, (n, 3)) + np.array([12.0, -5.0, 0.0])).astype(np.float32)
    out.append(("one voxel holding every lane", one, np.ones(n, bool), 1.0, 16, 256, True))
    wide = _blobs(rng, n, 300.0)
    wide[: n // 64] = rng.uniform(1.0e9, 1.5e9, (n // 64, 3)).astype(np.float32)
    out.append(("lanes out of extent", wide, np.ones(n, bool), 1.0, 8192, 256, True))
    out.append(("more runs than leaf_cap", scene, rng.random(n) >= 0.05, 1.0, 256, 256, True))
    counts = np.where(np.arange(n // 11) % 2 == 0, 6, 5)
    cells = rng.choice(200 ** 3, size=len(counts), replace=False)
    cells = np.stack([cells // 40000, (cells // 200) % 200, cells % 200], axis=1) - 100
    sizes = np.repeat(cells, counts, axis=0) + 0.5 + rng.uniform(-0.3, 0.3, (counts.sum(), 3))
    pad = np.full((n - len(sizes), 3), 1.0e6)
    out.append(("min_points and min_points - 1", np.concatenate([sizes, pad]).astype(np.float32),
                np.arange(n) < len(sizes), 1.0, 8192, 256, False))
    base = np.repeat(rng.integers(-40, 40, (n // 16, 3)), 16, axis=0).astype(np.float64) + 0.5
    t = rng.uniform(-0.45, 0.45, (n, 2))
    flat = np.where(np.arange(n)[:, None] % 32 < 16,  # alternate runs: a line along x, a plane z = const
                    np.stack([t[:, 0], np.full(n, 0.125), np.full(n, -0.25)], axis=1),
                    np.stack([t[:, 0], t[:, 1], np.full(n, 0.375)], axis=1))
    out.append(("collinear and coplanar voxels", (base + flat).astype(np.float32), np.ones(n, bool), 1.0, 4096,
                256, True))
    holes = scene.copy()
    mask = rng.random(n) >= 0.1
    holes[~mask] = np.nan
    out.append(("NaN on masked lanes", holes, mask, 1.0, 4096, 256, True))
    out.append(("weighted", scene, np.ones(n, bool), 1.0, 4096, 256, True))
    out.append(("unweighted", scene, np.ones(n, bool), 1.0, 4096, 256, False))
    out.append(("1025 lanes", _blobs(rng, 1025, 20.0, spread=0.06), np.ones(1025, bool), 0.5, 512, 256, True))
    out.append(("e = 64", _blobs(rng, n, 50.0), np.ones(n, bool), 1.0, 4096, 64, True))
    assert tuple(name for name, *_ in out) == MAP_CASE_NAMES
    return out


# A leaf whose float64 lambda0 / lambda2 is below this is flat or straight to
# rounding: its validity and eigenvectors are a rounding call of the float32
# Cardano eigh (acos near +-1), which the CPU's libm and the card's round
# apart (tests/test_torch_voxel_map.py's NOISY_RATIO)
NOISY_RATIO = 1e-5


def map_agrees(torch, what: str, got, want, ratio=None):
    """Kernel 3's map `got` against a twin's `want` (one device): keys and
    origin_cell identical; validity and n_leaves identical, or with `ratio`
    (each leaf's float64 lambda0 / lambda2, for a twin on another device)
    differing only on leaves below NOISY_RATIO; on the leaves valid in both
    (and, with `ratio`, not below it) means within 1e-5, icovs and weights
    within 1e-4 of their largest entry. Returns (mean, icov, weight) max
    abs errors."""
    for field in ("keys", "origin_cell"):
        if not torch.equal(getattr(got, field), getattr(want, field)):
            raise AssertionError(f"{what}: {field} differs")
    differ = got.valid != want.valid
    noisy = ratio < NOISY_RATIO if ratio is not None else torch.zeros_like(differ)
    if bool((differ & ~noisy).any()) or int(got.n_leaves) != int(got.valid.sum()) or (
            ratio is None and int(got.n_leaves) != int(want.n_leaves)):
        raise AssertionError(f"{what}: validity differs on {int(differ.sum())} leaves ({int((differ & noisy).sum())} "
                             f"of them flat to rounding), n_leaves {int(got.n_leaves)} against {int(want.n_leaves)}")
    both = got.valid & want.valid
    if not bool(both.any()):
        return 0.0, 0.0, 0.0
    err_mean = float((got.means[both] - want.means[both]).abs().max())
    v = both & ~noisy
    if not bool(v.any()):
        return err_mean, 0.0, 0.0
    err_icov = float((got.icovs[v] - want.icovs[v]).abs().max())
    err_w = float((got.weights[v] - want.weights[v]).abs().max())
    icov_tol = 1e-4 * float(want.icovs[v].abs().max())
    w_tol = 1e-4 * float(want.weights[v].abs().max())
    if err_mean > 1e-5 or err_icov > icov_tol or err_w > w_tol:
        raise AssertionError(f"{what}: errors mean {err_mean} (tol 1e-5) icov {err_icov} (tol {icov_tol}) "
                             f"weight {err_w} (tol {w_tol})")
    return err_mean, err_icov, err_w


def check_map_cases(torch, dev):
    """K3 (`build_voxel_map`) on every case of `map_cases`, one launch and no
    synchronizing call each, against its twin on the card (`map_agrees`:
    validity identical, both round alike) and against its twin run on a CPU
    copy (keys and origin identical, validity but for leaves flat to
    rounding); returns the number of cases."""
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import voxel_map

    cases = map_cases()
    for name, pts, mask, res, leaf_cap, e, weighted in cases:
        cpu = PointCloud(torch.from_numpy(pts), torch.zeros(len(pts)), torch.from_numpy(mask))
        card = PointCloud(cpu.xyz.to(dev), cpu.intensity.to(dev), cpu.mask.to(dev))
        kw = dict(leaf_cap=leaf_cap, lut_extent=e, weighted=weighted)
        before = KERNELS["build_voxel_map"].launches
        got = []
        syncs = count_syncs(torch, lambda: got.append(voxel_map.build_voxel_map(card, res, **kw)))
        torch.cuda.synchronize()
        if KERNELS["build_voxel_map"].launches != before + 1 or syncs:
            raise AssertionError(f"build_voxel_map ({name}): {KERNELS['build_voxel_map'].launches - before} "
                                 f"launches, {syncs} synchronizing calls")
        map_agrees(torch, f"build_voxel_map ({name})", got[0], voxel_map.build_voxel_map_ref(card, res, **kw))
        got = voxel_map.VoxelMap(*(t.cpu() if isinstance(t, torch.Tensor) else t for t in got[0]))
        map_agrees(torch, f"build_voxel_map ({name}, CPU twin)", got, voxel_map.build_voxel_map_ref(cpu, res, **kw),
                   voxel_map.leaf_eigen_ratio(cpu, res, leaf_cap, e))
    return len(cases)


GRID_LANES = 1 << 14  # K14's edge cases
GRID_RES = 0.25       # the fitness grid's cells
GRID_CASE_NAMES = ("empty cloud (every lane the sentinel)", "every lane masked", "leaf_cap below the runs",
                   "one ulp either side of cell faces", "cells at the 1024 extent's edges", "one cell holding every point",
                   "sentinel lanes among real points")


def _extent_edges(rng, n: int, res: float) -> tuple:
    """(points, queries): lanes in cells whose coordinates relative to the
    masked minimum are 0, 1, 1022, 1023 on every axis (and a few at 1024, out
    of the extent), so that the flat keys of (x, y, 1023) and (x, y + 1, 0)
    are neighbours; queries in and around those cells."""
    origin = np.array([-300, 37, -5])
    edge = np.array([0, 1, 1022, 1023])
    cells = np.stack(np.meshgrid(edge, edge, edge, indexing="ij"), -1).reshape(-1, 3)
    cells = np.concatenate([cells, [[1024, 5, 5], [5, 1024, 5], [5, 5, 1024], [512, 512, 512]]])
    pick = cells[rng.integers(0, len(cells), n)]
    pick[: len(cells)] = cells  # every cell holds at least one lane
    pts = ((origin + pick) + rng.uniform(0.1, 0.9, (n, 3))) * res
    near = cells[rng.integers(0, len(cells), n)] + rng.integers(-1, 2, (n, 3))
    queries = ((origin + near) + rng.uniform(0.05, 0.95, (n, 3))) * res
    return pts.astype(np.float32), queries.astype(np.float32)


def grid_cases(seed: int = SEED):
    """Kernel 14's edge cases as numpy arrays: (name, points (n, 3), mask
    (n,), leaf_cap, queries (n, 3), query mask (n,)) on the 0.25 m grid. An
    empty cloud (every lane masked at the sentinel) and real points all
    masked (origin 0, no leaf); ~15000 cells into a leaf_cap of 2048; points
    on the cell faces and one ulp either side (not at 0, where XLA's CPU code
    flushes subnormals); cells at 0, 1, 1022 and 1023 of the 1024 extent on
    each axis and at 1024 (dropped), queried in and around them, so that
    column searches meet z = 0 and z = 1023; one cell holding all 16384
    lanes (one run across 16 tiles); half the lanes masked at the sentinel
    among real points, which must not move the origin. Queries are the
    cloud's points moved by ~0.15 m, and a scene's for the empty grids."""
    rng = np.random.default_rng(seed)
    n, res = GRID_LANES, GRID_RES
    scene = _blobs(rng, n, 40.0, spread=0.6)
    jitter = (scene + rng.normal(0.0, 0.15, (n, 3))).astype(np.float32)
    every = np.ones(n, bool)
    sentinel = np.full((n, 3), SENTINEL_XYZ, np.float32)
    out = [("empty cloud (every lane the sentinel)", sentinel, np.zeros(n, bool), 4096, jitter, every),
           ("every lane masked", scene, np.zeros(n, bool), 4096, jitter, every),
           ("leaf_cap below the runs", scene, every, 2048, jitter, rng.random(n) >= 0.1)]
    base = scene[rng.choice(n, n // 4, replace=False)]
    faces = (np.round(base / res) * res).astype(np.float32)
    faces = np.where(faces == 0, np.float32(res), faces)
    ulps = np.concatenate([faces, np.nextafter(faces, np.float32(np.inf)), np.nextafter(faces, np.float32(-np.inf)),
                           scene[: n - 3 * len(faces)]])
    out.append(("one ulp either side of cell faces", ulps, every, 8192, ulps[rng.permutation(n)], every))
    edges, near = _extent_edges(rng, n, res)
    out.append(("cells at the 1024 extent's edges", edges, every, 4096, near, every))
    one = ((np.array([-41, 7, 3]) + rng.uniform(0.02, 0.98, (n, 3))) * res).astype(np.float32)
    out.append(("one cell holding every point", one, every, 16, (one + rng.normal(0.0, 0.2, (n, 3))).astype(np.float32),
                every))
    half = rng.random(n) >= 0.5
    mixed = np.where(half[:, None], scene, sentinel).astype(np.float32)
    out.append(("sentinel lanes among real points", mixed, half, 8192, jitter, every))
    assert tuple(name for name, *_ in out) == GRID_CASE_NAMES
    return out


def grid_agrees(torch, what: str, got, want) -> float:
    """Kernel 14's grid `got` against a twin's `want`: keys, counts and
    origin identical, centroids of occupied leaves within 1e-6 relative (the
    twin's segment sums may run in another order), the rest identical.
    Returns the centroids' largest relative error."""
    for field in ("keys", "counts", "origin_cell"):
        if not torch.equal(getattr(got, field), getattr(want, field)):
            raise AssertionError(f"{what}: {field} differs")
    v = want.counts > 0
    if not torch.equal(got.centroids[~v], want.centroids[~v]):
        raise AssertionError(f"{what}: the padding leaves' centroids differ")
    if not bool(v.any()):
        return 0.0
    err = float(((got.centroids[v] - want.centroids[v]).abs() / want.centroids[v].abs().clamp(min=1.0)).max())
    if err > 1e-6:
        raise AssertionError(f"{what}: centroid error {err} > 1e-6")
    return err


def check_grid_cases(torch, dev):
    """K14 (`build_centroid_grid`) on every case of `grid_cases`, one launch
    and no synchronizing call each, against its twin on the card and run on
    a CPU copy (`grid_agrees`); then on the kernel's grid the query kernels
    against their twins on the card: `nn_sq_dists` (hit set and d2
    bit-identical), `nn_points` (d2, match and validity bit-identical), and
    K18's radius removal of the case's cloud (mask identical). Returns the
    number of cases."""
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import nn

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    cases = grid_cases()
    for name, pts, mask, leaf_cap, queries, qmask in cases:
        cpu = PointCloud(torch.from_numpy(pts), torch.zeros(len(pts)), torch.from_numpy(mask))
        card = PointCloud(cpu.xyz.to(dev), cpu.intensity.to(dev), cpu.mask.to(dev))
        before = KERNELS["build_centroid_grid"].launches
        got = []
        syncs = count_syncs(torch, lambda: got.append(nn.build_centroid_grid(card, GRID_RES, leaf_cap)))
        torch.cuda.synchronize()
        if KERNELS["build_centroid_grid"].launches != before + 1 or syncs:
            raise AssertionError(f"build_centroid_grid ({name}): {KERNELS['build_centroid_grid'].launches - before} "
                                 f"launches, {syncs} synchronizing calls")
        grid = got[0]
        grid_agrees(torch, f"build_centroid_grid ({name})", grid, nn.build_centroid_grid_ref(card, GRID_RES, leaf_cap))
        grid_agrees(torch, f"build_centroid_grid ({name}, CPU twin)",
                    nn.CentroidGrid(*(t.cpu() if isinstance(t, torch.Tensor) else t for t in grid)),
                    nn.build_centroid_grid_ref(cpu, GRID_RES, leaf_cap))
        q = PointCloud(torch.from_numpy(queries).to(dev), torch.zeros(len(queries), device=dev),
                       torch.from_numpy(qmask).to(dev))
        y, m = q.masked_xyz(), q.mask
        d2, d2_ref = nn.nn_sq_dists(grid, y, m), nn.nn_sq_dists_ref(grid, y, m)
        if not torch.equal(bits(d2), bits(d2_ref)):
            raise AssertionError(f"nn_sq_dists ({name}): d2 or the hit set differs from the plain version")
        for a, b in zip(nn.nn_points(grid, y, m), nn.nn_points_ref(grid, y, m)):
            if not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"nn_points ({name}): distances, matches or validity differ")
        kept = nn.radius_outlier_removal(card, GRID_RES, 3)
        if not torch.equal(kept.mask, nn.radius_outlier_removal_ref(card, GRID_RES, 3).mask):
            raise AssertionError(f"radius_outlier_removal ({name}): the mask differs from the plain version")
    return len(cases)


def crop_cases():
    """Kernel 9b's two-table crop cases: (name, center, last center or
    None, interval, radius) on `crop_tables`' seeded tables (an edge table
    of 2^12 x 6 and a surf table of 2^13 x 6 slots, ~60% valid, points
    within +-60 m, flags 0 or 1): the gate open (moved past the interval),
    closed (not moved far enough) and absent (`crop_interval` 0), and a
    radius past every point."""
    c = np.array([3.0, -2.0, 0.5], np.float32)
    return [("gate open", c, c + np.float32(40.0), 10.0, 25.0),
            ("gate closed", c, c + np.float32(4.0), 10.0, 25.0),
            ("no gate (crop_interval 0)", c, None, 0.0, 25.0),
            ("radius past every point", c, c + np.float32(40.0), 10.0, 500.0)]


def crop_tables(torch, dev, seed: int = SEED):
    """(edge, surf) seeded cell tables for `crop_cases` on `dev`."""
    from lv_slam_tpu_torch.ops import knn

    rng = np.random.default_rng(seed)
    out = []
    for buckets in (1 << 12, 1 << 13):
        slots = rng.uniform(-60.0, 60.0, (buckets * 6, 4)).astype(np.float32)
        slots[:, 3] = (rng.random(buckets * 6) < 0.6).astype(np.float32)
        out.append(knn.CellTable(torch.from_numpy(slots.reshape(buckets, 24)).to(dev), 2.0))
    return out


def check_crop_cases(torch, dev):
    """K9b's two-table crop (`crop_cell_tables_`, one launch) on every case
    of `crop_cases`, both tables and the returned center bit-identical to
    the twin's two single-table crops; returns the number of cases."""
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import knn

    edge, surf = crop_tables(torch, dev)
    cases = crop_cases()
    for name, center, last, interval, radius in cases:
        c = torch.from_numpy(center).to(dev)
        lc = torch.from_numpy(last).to(dev) if last is not None else None
        got = [knn.CellTable(t.table.clone(), t.cell_size) for t in (edge, surf)]
        want = [knn.CellTable(t.table.clone(), t.cell_size) for t in (edge, surf)]
        before = KERNELS["crop_cell_table"].launches
        out = []
        syncs = count_syncs(torch, lambda: out.append(knn.crop_cell_tables_(*got, c, radius, lc, interval)))
        ref = knn.crop_cell_tables_ref_(*want, c, radius, lc, interval)
        torch.cuda.synchronize()
        if KERNELS["crop_cell_table"].launches != before + 1 or syncs:
            raise AssertionError(f"crop_cell_tables_ ({name}): {KERNELS['crop_cell_table'].launches - before} "
                                 f"launches, {syncs} synchronizing calls")
        for a, b in [(out[0], ref)] + [(g.table, w.table) for g, w in zip(got, want)]:
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"crop_cell_tables_ ({name}): a table or the crop center differs")
    return len(cases)


HASH_CASE_NAMES = ("no valid leaf", "every leaf in one bucket", "invalid leaves interleaved", "leaf_cap 3000",
                   "buckets_per_leaf 1", "buckets_per_leaf 8", "the 4 m rung's map", "extent 1288")


def _leaves(rng, cells: np.ndarray, res: float, origin: np.ndarray):
    """Leaves in the cells `cells` (n, 3) of a map at `res` with origin cell
    `origin`: (means (n, 3) well inside their cells, icovs (n, 3, 3), weights (n,))."""
    n = len(cells)
    means = ((origin + cells + rng.uniform(0.1, 0.9, (n, 3))) * res).astype(np.float32)
    icovs = rng.normal(0.0, 50.0, (n, 3, 3)).astype(np.float32)
    return means, icovs, rng.uniform(0.05, 1.0, n).astype(np.float32)


def hash_cases(seed: int = SEED):
    """Kernel 5's edge cases as numpy arrays: (name, means (L, 3), icovs (L,
    3, 3), weights (L,), valid (L,), origin_cell (3,), resolution, extent,
    buckets_per_leaf). No valid leaf; every valid leaf in one voxel, so one
    bucket (all but two dropped); half the leaves invalid, interleaved, with
    NaN in their fields; a leaf_cap of 3000 (16384 buckets); 1 and 8
    buckets a leaf (many and few collisions); the loop detector's 4 m rung
    (leaf_cap 16384, extent 256) over a +-60 m cloud, built by the plain
    K3; extent 1288, whose keys reach 1288^3 - 1, just under the first NaN
    pattern. Resolutions are powers of two, so the reference's division and
    the port's reciprocal give the same cells."""
    import torch

    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.ops import voxel_map

    rng = np.random.default_rng(seed)
    e = 256
    origin = np.array([-128, -128, -128], np.int32)

    def cells(n, extent=e):
        flat = rng.choice(extent ** 3, size=n, replace=False)
        return np.stack([flat // extent ** 2, (flat // extent) % extent, flat % extent], axis=1)

    out = []
    means, icovs, weights = _leaves(rng, cells(4096), 1.0, origin)
    out.append(("no valid leaf", means, icovs, weights, np.zeros(4096, bool), origin, 1.0, e, 4))
    means, icovs, weights = _leaves(rng, np.repeat(cells(1), 4096, axis=0), 1.0, origin)
    out.append(("every leaf in one bucket", means, icovs, weights, np.ones(4096, bool), origin, 1.0, e, 4))
    means, icovs, weights = _leaves(rng, cells(32768), 1.0, origin)
    valid = rng.random(32768) < 0.5
    means[~valid], icovs[~valid], weights[~valid] = np.nan, np.nan, np.nan
    out.append(("invalid leaves interleaved", means, icovs, weights, valid, origin, 1.0, e, 4))
    means, icovs, weights = _leaves(rng, cells(3000), 0.5, origin)
    out.append(("leaf_cap 3000", means, icovs, weights, rng.random(3000) < 0.9, origin, 0.5, e, 4))
    for bpl in (1, 8):
        means, icovs, weights = _leaves(rng, cells(8192), 1.0, origin)
        out.append((f"buckets_per_leaf {bpl}", means, icovs, weights, rng.random(8192) < 0.9, origin, 1.0, e, bpl))
    pts = torch.from_numpy(_blobs(rng, 1 << 16, 60.0, spread=1.5))
    cloud = PointCloud(pts, torch.zeros(len(pts)), torch.ones(len(pts), dtype=torch.bool))
    vm = voxel_map.build_voxel_map_ref(cloud, 4.0, leaf_cap=16384, lut_extent=e)
    out.append(("the 4 m rung's map", vm.means.numpy(), vm.icovs.numpy(), vm.weights.numpy(), vm.valid.numpy(),
                vm.origin_cell.numpy(), 4.0, e, 4))
    big = 1288
    corners = np.array([[0, 0, 0], [big - 1, big - 1, big - 1], [big - 1, 0, big - 1]])
    means, icovs, weights = _leaves(rng, np.concatenate([corners, cells(8189, big)]), 1.0,
                                    np.array([-644, -644, -644], np.int32))
    out.append(("extent 1288", means, icovs, weights, rng.random(8192) < 0.95, np.array([-644, -644, -644], np.int32),
                1.0, big, 4))
    assert tuple(name for name, *_ in out) == HASH_CASE_NAMES
    return out


def hash_case_map(torch, case, dev):
    """The port's VoxelMap of a `hash_cases` entry (without its name) on `dev`."""
    from lv_slam_tpu_torch.ops.voxel_map import VoxelMap

    means, icovs, weights, valid, origin, res, e, _ = case
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return VoxelMap(means=t(means), icovs=t(icovs), weights=t(weights), normals=torch.zeros_like(t(means)),
                    valid=t(valid), keys=torch.full((len(valid),), -1, dtype=torch.int32, device=dev),
                    origin_cell=t(origin), resolution=res, n_leaves=t(np.array(valid.sum(), np.int32)), extent=e)


def identical_hash(torch, got, want) -> bool:
    """Tables bit-identical and n_dropped equal (one device)."""
    return torch.equal(got.table.view(torch.int32), want.table.view(torch.int32)) and torch.equal(
        got.n_dropped, want.n_dropped)


def check_hash_twins(torch, what: str, got, vm, buckets_per_leaf: int = 4) -> None:
    """K5's table `got` of the card's map `vm` against its twin on the card
    and its twin run on a CPU copy, bit for bit."""
    from lv_slam_tpu_torch.ops import ndt_hash, voxel_map

    cpu = voxel_map.VoxelMap(*(t.cpu() if isinstance(t, torch.Tensor) else t for t in vm))
    want = ndt_hash.to_hash_ref(cpu, buckets_per_leaf)
    on_host = want._replace(table=got.table.cpu(), n_dropped=got.n_dropped.cpu())
    if not identical_hash(torch, got, ndt_hash.to_hash_ref(vm, buckets_per_leaf)):
        raise AssertionError(f"{what}: table or n_dropped not bit-identical to the plain version on the card")
    if not identical_hash(torch, on_host, want):
        raise AssertionError(f"{what}: n_dropped {int(got.n_dropped)} against the CPU twin's {int(want.n_dropped)}, "
                             f"or the table, not bit-identical")


def check_hash_cases(torch, dev):
    """K5 (`to_hash`) on every case of `hash_cases`, one launch and no
    synchronizing call each, bit for bit against its twin on the card and
    against its twin run on a CPU copy; returns the number of cases."""
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import ndt_hash

    cases = hash_cases()
    for name, *case in cases:
        bpl = case[-1]
        card = hash_case_map(torch, case, dev)
        before = KERNELS["to_hash"].launches
        got = []
        syncs = count_syncs(torch, lambda: got.append(ndt_hash.to_hash(card, bpl)))
        torch.cuda.synchronize()
        if KERNELS["to_hash"].launches != before + 1 or syncs:
            raise AssertionError(f"to_hash ({name}): {KERNELS['to_hash'].launches - before} launches, {syncs} "
                                 f"synchronizing calls")
        check_hash_twins(torch, f"to_hash ({name})", got[0], card, bpl)
    return len(cases)


# The hash pass's edge cases (`probe_cases`, K6 / K13's `ndt_partials`)
PROBE_CASE_NAMES = ("slot-1 keys and keys in neither slot, DIRECT1", "slot-1 keys and keys in neither slot, DIRECT7",
                    "cells past the extent, DIRECT7", "masked, sentinel and gate-rejected lanes, DIRECT1",
                    "1000 lanes, 3 candidates, one done, DIRECT7")


def _pd_leaves(rng, cells: np.ndarray, res: float, origin: np.ndarray):
    """`_leaves` with positive-definite inverse covariances (eigenvalues
    0.5 to ~6): a point's terms stay finite against any leaf."""
    means, _, weights = _leaves(rng, cells, res, origin)
    b = rng.normal(0.0, 0.7, (len(cells), 3, 3))
    icovs = (b @ b.transpose(0, 2, 1) + 0.5 * np.eye(3)).astype(np.float32)
    return means, icovs, weights


def _near(rng, means: np.ndarray, n: int, spread: float) -> np.ndarray:
    """(n, 3) points around seeded picks of `means`."""
    return (means[rng.integers(0, len(means), n)] + rng.normal(0.0, spread, (n, 3))).astype(np.float32)


def probe_cases(seed: int = SEED):
    """The hash pass's edge cases as dicts of numpy arrays: `leaves` (means,
    icovs, weights, valid, origin_cell, resolution, extent,
    buckets_per_leaf; `hash_case_map`'s tuple), points `xs` (k, 3, n),
    `mask` (k, n), `transforms` (k, 4, 4), `neighborhood`, `weighted`,
    `gauss` ((d1, d2) or None for the resolution's), `done` (k,). One
    bucket a leaf: many buckets hold two leaves (the second in slot 1) or
    more (the rest dropped, their keys in neither slot); an extent of 16
    with leaves on its faces and points past them (some offsets' cells
    outside [0, e)); masked lanes, lanes at the sentinel (masked and not),
    and lanes the gate rejects (d2 = 1.5 puts d2 * exp(-d2 * md / 2) above 1
    near a leaf's mean); 1000 lanes (not a multiple of 256) and three
    candidates, the second done."""
    rng = np.random.default_rng(seed)
    e, origin = 256, np.array([-128, -128, -128], np.int32)

    def cells(n, lo, hi):
        flat = rng.choice((hi - lo) ** 3, size=n, replace=False)
        return np.stack([flat // (hi - lo) ** 2, (flat // (hi - lo)) % (hi - lo), flat % (hi - lo)], 1) + lo - origin

    def moved(k):
        t = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
        t[:, :3, 3] = rng.uniform(-0.15, 0.15, (k, 3))
        return t

    def batch(pts_list):
        return np.ascontiguousarray(np.stack([p.T for p in pts_list]).astype(np.float32))

    out = []
    means, icovs, weights = _pd_leaves(rng, cells(4096, -20, 20), 1.0, origin)
    leaves = (means, icovs, weights, rng.random(4096) < 0.97, origin, 1.0, e, 1)
    for name, k, hood, weighted in ((PROBE_CASE_NAMES[0], 1, "DIRECT1", True), (PROBE_CASE_NAMES[1], 2, "DIRECT7", False)):
        pts = [np.concatenate([_near(rng, means, 3480, 0.2), rng.uniform(-20, 20, (616, 3)).astype(np.float32)])
               for _ in range(k)]
        out.append(dict(name=name, leaves=leaves, xs=batch(pts), mask=np.ones((k, 4096), bool), transforms=moved(k),
                        neighborhood=hood, weighted=weighted, gauss=None, done=np.zeros(k, bool)))
    # extent 16 from the origin: leaves on the faces and inside, points up to a cell past the faces
    small = np.zeros(3, np.int32)
    face = rng.integers(0, 16, (600, 3))
    face[np.arange(600), rng.integers(0, 3, 600)] = rng.choice([0, 15], 600)
    face = np.unique(face, axis=0)
    means, icovs, weights = _pd_leaves(rng, face, 1.0, small)
    pts = np.concatenate([_near(rng, means, 3000, 0.6), rng.uniform(-1.0, 17.0, (1096, 3)).astype(np.float32)])
    out.append(dict(name=PROBE_CASE_NAMES[2], leaves=(means, icovs, weights, np.ones(len(face), bool), small, 1.0, 16, 4),
                    xs=batch([pts]), mask=np.ones((1, 4096), bool), transforms=moved(1), neighborhood="DIRECT7",
                    weighted=False, gauss=None, done=np.zeros(1, bool)))
    # masked lanes, sentinel lanes (masked and not), lanes the gate rejects
    means, icovs, weights = _pd_leaves(rng, cells(2048, -12, 12), 1.0, origin)
    pts = _near(rng, means, 4096, 0.3)
    mask = rng.random(4096) > 0.3
    sentinel = rng.random(4096) < 0.15
    pts[sentinel] = SENTINEL_XYZ
    out.append(dict(name=PROBE_CASE_NAMES[3], leaves=(means, icovs, weights, np.ones(2048, bool), origin, 1.0, e, 4),
                    xs=batch([pts]), mask=mask[None], transforms=moved(1), neighborhood="DIRECT1", weighted=True,
                    gauss=(-1.0, 1.5), done=np.zeros(1, bool)))
    # 1000 lanes, three candidates, the second done
    means, icovs, weights = _pd_leaves(rng, cells(3000, -15, 15), 1.0, origin)
    pts = [_near(rng, means, 1000, 0.3) for _ in range(3)]
    out.append(dict(name=PROBE_CASE_NAMES[4], leaves=(means, icovs, weights, rng.random(3000) < 0.9, origin, 1.0, e, 4),
                    xs=batch(pts), mask=rng.random((3, 1000)) > 0.1, transforms=moved(3), neighborhood="DIRECT7",
                    weighted=False, gauss=None, done=np.array([False, True, False])))
    assert tuple(c["name"] for c in out) == PROBE_CASE_NAMES
    return out


SENTINEL_XYZ = 1.0e6  # core/cloud.py SENTINEL: a masked lane's coordinates


def probe_case_inputs(torch, case, dev):
    """A `probe_cases` entry on `dev`: (hash map (the plain K5's table of its
    leaves, built on the CPU), xs (k, 3, n), mask (k, n), transforms (k, 4, 4),
    GaussParams, offsets, weighted, done (k,) bool)."""
    from lv_slam_tpu_torch.ops import ndt, ndt_hash, voxel_map

    bpl = case["leaves"][-1]
    hm = ndt_hash.to_hash_ref(hash_case_map(torch, case["leaves"], "cpu"), bpl)
    hm = hm._replace(table=hm.table.to(dev), origin_cell=hm.origin_cell.to(dev), n_dropped=hm.n_dropped.to(dev))
    res = case["leaves"][5]
    gauss = ndt.make_gauss_params(res) if case["gauss"] is None else ndt.GaussParams(*case["gauss"], 0.0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (hm, t(case["xs"]), t(case["mask"]), t(case["transforms"]), gauss,
            voxel_map.neighborhood_offsets(case["neighborhood"], dev), case["weighted"], t(case["done"]))


def probe_sums(torch, rows):
    """(k, 43) sums of partial rows (k, n_blocks, 43) in block order (`ndt_finish`'s)."""
    sums = torch.zeros_like(rows[:, 0])
    for b in range(rows.shape[1]):
        sums = sums + rows[:, b]
    return sums


def check_probe_cases(torch, dev):
    """The hash pass (`ndt_partials`, K13's launch) on every case of
    `probe_cases`, one launch and no synchronizing call a case: a finished
    candidate's rows untouched, the others' rows, summed in block order,
    against the plain pass on the card at phase 2's tolerances (score 1e-4
    of its size, gradient and Hessian 2e-5 of their largest entry); returns
    the number of cases."""
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import ndt, ndt_hash

    cases = probe_cases()
    for case in cases:
        name = case["name"]
        hm, xs, mask, trans, gauss, offsets, weighted, done = probe_case_inputs(torch, case, dev)
        k = xs.shape[0]
        pass_ = ndt_hash.hash_pass(hm, xs, mask, gauss, offsets, weighted)
        state = ndt.NewtonState(trans, batched=True)
        state.s[:, ndt.S_DONE] = done.to(torch.int32)
        state.partials = torch.full((k * pass_.n_blocks * ndt.N_TERMS,), float("nan"), dtype=torch.float32,
                                    device=dev)
        before = KERNELS["_fused_verify_fn"].launches
        syncs = count_syncs(torch, lambda: pass_.launch(state))
        torch.cuda.synchronize()
        if KERNELS["_fused_verify_fn"].launches != before + 1 or syncs:
            raise AssertionError(f"ndt_partials ({name}): {KERNELS['_fused_verify_fn'].launches - before} launches, "
                                 f"{syncs} synchronizing calls")
        rows = state.partials.view(k, pass_.n_blocks, ndt.N_TERMS)
        active = (~done).tolist()
        if not bool(torch.isnan(rows[done]).all()):
            raise AssertionError(f"ndt_partials ({name}): a finished candidate's rows were written")
        got = probe_sums(torch, rows[~done])
        s2, g2, h2 = (a[~done] for a in ndt_hash.ndt_derivatives_hash_batched_ref(
            hm, xs, mask, trans, gauss, offsets, weighted, active))
        es = float((got[:, 0] - s2).abs().max())
        eg, eh = float((got[:, 1:7] - g2).abs().max()), float((got[:, 7:] - h2.reshape(-1, 36)).abs().max())
        ts, tg, th = 1e-4 * float(s2.abs().max()), 2e-5 * float(g2.abs().max()), 2e-5 * float(h2.abs().max())
        if not bool(torch.isfinite(got).all()) or es > ts or eg > tg or eh > th:
            raise AssertionError(f"ndt_partials ({name}): errors score {es} (tol {ts}), grad {eg} (tol {tg}), hess "
                                 f"{eh} (tol {th})")
    return len(cases)


# The LUT passes' edge cases (`lut_cases`, K6L's and K6G's `lut_pass`)
LUT_CASE_NAMES = ("points within an ulp of a cell face, DIRECT1, weighted",
                  "cells at and past the extent for each DIRECT7 offset",
                  "every lane masked, DIRECT7", "1001 lanes, DIRECT1, unweighted",
                  "valid lanes ending mid-row, DIRECT7, weighted",
                  "masked, sentinel and gate-rejected lanes, DIRECT1, weighted",
                  "a finished candidate (done), DIRECT7", "DIRECT26, weighted",
                  "131073 lanes, more rows than resident blocks, DIRECT7")


def _lut_of(means: np.ndarray, valid: np.ndarray, res: float, origin: np.ndarray, e: int) -> np.ndarray:
    """The dense (e^3,) LUT of leaves one to a cell: -1, the leaf's row at
    its cell's flat key (the cells of the valid leaves must differ)."""
    cells = (np.floor(means / np.float32(res)).astype(np.int64) - origin)[valid]
    assert ((cells >= 0) & (cells < e)).all() and len(np.unique(cells, axis=0)) == len(cells)
    lut = np.full(e ** 3, -1, np.int32)
    lut[(cells[:, 0] * e + cells[:, 1]) * e + cells[:, 2]] = np.flatnonzero(valid).astype(np.int32)
    return lut


def lut_cases(seed: int = SEED):
    """The LUT passes' edge cases as dicts of numpy arrays: `leaves` (means,
    icovs, weights, valid, origin_cell, resolution, extent), `lut` (e^3,),
    points `xs` (3, n), `mask` (n,), `transform` (4, 4), `neighborhood`,
    `weighted`, `gauss` ((d1, d2) or None for the resolution's), `done`
    (the Newton loop's gate). Points within an ulp of a cell face at a
    resolution of 0.7 (true division and a reciprocal part there), under
    the identity so each lands where it was put (the face through 0 too:
    one ulp below it is a negative denormal, in cell -1 on the card and in
    the twins, in cell 0 in the reference, which flushes it to 0: the CPU
    tests pin that); an extent of 16 with leaves
    on its faces and points in the cells at and one past them, so each
    DIRECT7 offset probes cells at and past the extent; every lane masked;
    1001 lanes (not a multiple of a 256-lane row); valid lanes ending in the
    middle of a row (K21's front-compacted mask: the rows after it hold no
    valid lane); masked lanes, lanes at the sentinel (masked and not) and
    lanes the gate rejects (d2 = 1.5); a finished candidate; DIRECT26; and
    131073 lanes, more rows than the card holds blocks of the pass at once."""
    rng = np.random.default_rng(seed + 24)
    e, origin = 64, np.array([-32, -32, -32], np.int32)

    def cells(n, lo, hi):
        flat = rng.choice((hi - lo) ** 3, size=n, replace=False)
        return np.stack([flat // (hi - lo) ** 2, (flat // (hi - lo)) % (hi - lo), flat % (hi - lo)], 1) + lo - origin

    def moved():
        t = np.eye(4, dtype=np.float32)
        c, s = np.cos(0.03), np.sin(0.03)
        t[:2, :2] = [[c, -s], [s, c]]
        t[:3, 3] = rng.uniform(-0.15, 0.15, 3)
        return t

    def case(name, means, icovs, weights, valid, res, org, ext, pts, mask, transform, hood, weighted, gauss=None,
             done=False):
        return dict(name=name, leaves=(means, icovs, weights, valid, org, res, ext),
                    lut=_lut_of(means, valid, res, org, ext), xs=np.ascontiguousarray(pts.T.astype(np.float32)),
                    mask=mask, transform=transform, neighborhood=hood, weighted=weighted, gauss=gauss, done=done)

    out = []
    # faces: points at k * 0.7 and one ulp either side along each axis, under the identity
    res = 0.7
    means, icovs, weights = _pd_leaves(rng, cells(3000, -14, 14), res, origin)
    base = _near(rng, means, 4096, 0.3)
    axis = rng.integers(0, 3, 4096)
    k = np.round(base[np.arange(4096), axis] / np.float32(res))
    face = np.float32(k * np.float32(res))
    face = np.where(rng.random(4096) < 0.5, np.nextafter(face, np.float32(np.inf)),
                    np.where(rng.random(4096) < 0.5, np.nextafter(face, np.float32(-np.inf)), face))
    base[np.arange(4096), axis] = face
    out.append(case(LUT_CASE_NAMES[0], means, icovs, weights, rng.random(3000) < 0.95, res, origin, e, base,
                    np.ones(4096, bool), np.eye(4, dtype=np.float32), "DIRECT1", True))
    # extent 16 from the origin: leaves on the faces, points in cells -1, 0, 15 and 16 along an axis
    small, ext = np.zeros(3, np.int32), 16
    face = rng.integers(0, ext, (700, 3))
    face[np.arange(700), rng.integers(0, 3, 700)] = rng.choice([0, ext - 1], 700)
    face = np.unique(face, axis=0)
    means, icovs, weights = _pd_leaves(rng, face, 1.0, small)
    pts = rng.uniform(0.0, float(ext), (4096, 3)).astype(np.float32)
    edge = rng.integers(0, 3, 4096)
    pts[np.arange(4096), edge] = (rng.choice([-1, 0, ext - 1, ext], 4096) + rng.uniform(0.05, 0.95, 4096)).astype(
        np.float32)
    out.append(case(LUT_CASE_NAMES[1], means, icovs, weights, np.ones(len(face), bool), 1.0, small, ext, pts,
                    np.ones(4096, bool), np.eye(4, dtype=np.float32), "DIRECT7", False))
    # every lane masked
    means, icovs, weights = _pd_leaves(rng, cells(2048, -12, 12), 1.0, origin)
    valid = np.ones(2048, bool)
    out.append(case(LUT_CASE_NAMES[2], means, icovs, weights, valid, 1.0, origin, e, _near(rng, means, 2048, 0.3),
                    np.zeros(2048, bool), moved(), "DIRECT7", True))
    # 1001 lanes
    out.append(case(LUT_CASE_NAMES[3], means, icovs, weights, valid, 1.0, origin, e, _near(rng, means, 1001, 0.3),
                    rng.random(1001) > 0.1, moved(), "DIRECT1", False))
    # valid lanes first, ending at lane 600 of 2048 (rows 3-7 hold none)
    pts = _near(rng, means, 2048, 0.3)
    mask = np.arange(2048) < 600
    pts[~mask] = SENTINEL_XYZ
    out.append(case(LUT_CASE_NAMES[4], means, icovs, weights, valid, 1.0, origin, e, pts, mask, moved(), "DIRECT7",
                    True))
    # masked, sentinel (masked and not) and gate-rejected lanes
    pts = _near(rng, means, 4096, 0.3)
    sentinel = rng.random(4096) < 0.15
    pts[sentinel] = SENTINEL_XYZ
    out.append(case(LUT_CASE_NAMES[5], means, icovs, weights, valid, 1.0, origin, e, pts, rng.random(4096) > 0.3,
                    moved(), "DIRECT1", True, gauss=(-1.0, 1.5)))
    # a finished candidate: the gated pass writes nothing, the standalone call sums as ever
    out.append(case(LUT_CASE_NAMES[6], means, icovs, weights, valid, 1.0, origin, e, _near(rng, means, 3000, 0.3),
                    np.ones(3000, bool), moved(), "DIRECT7", False, done=True))
    # DIRECT26
    means, icovs, weights = _pd_leaves(rng, cells(4000, -10, 10), 1.0, origin)
    valid = rng.random(4000) < 0.9
    out.append(case(LUT_CASE_NAMES[7], means, icovs, weights, valid, 1.0, origin, e, _near(rng, means, 3000, 0.4),
                    rng.random(3000) > 0.05, moved(), "DIRECT26", True))
    # 131073 lanes: 513 rows of 256
    out.append(case(LUT_CASE_NAMES[8], means, icovs, weights, valid, 1.0, origin, e, _near(rng, means, 131073, 0.4),
                    rng.random(131073) > 0.2, moved(), "DIRECT7", False))
    assert tuple(c["name"] for c in out) == LUT_CASE_NAMES
    return out


def lut_case_inputs(torch, case, dev):
    """A `lut_cases` entry on `dev`: (VoxelMap, lut, VoxelMapSOA, xs (3, n),
    xyz (n, 3), mask, transform, GaussParams, offsets, weighted, done)."""
    from lv_slam_tpu_torch.ops import ndt, ndt_soa, voxel_map

    means, icovs, weights, valid, origin, res, e = case["leaves"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    vm = voxel_map.VoxelMap(means=t(means), icovs=t(icovs), weights=t(weights), normals=torch.zeros_like(t(means)),
                            valid=t(valid), keys=torch.full((len(valid),), -1, dtype=torch.int32, device=dev),
                            origin_cell=t(origin), resolution=res, n_leaves=t(np.array(valid.sum(), np.int32)),
                            extent=e)
    lut = t(case["lut"])
    xs = t(case["xs"])
    gauss = ndt.make_gauss_params(res) if case["gauss"] is None else ndt.GaussParams(*case["gauss"], 0.0)
    return (vm, lut, ndt_soa.to_soa(vm, lut), xs, xs.T.contiguous(), t(case["mask"]), t(case["transform"]), gauss,
            voxel_map.neighborhood_offsets(case["neighborhood"], dev), case["weighted"], case["done"])


def derivative_errors(torch, got, want) -> tuple:
    """(score, gradient, Hessian) errors of two (score, grad, hess) triples
    and their tolerances: 1e-4 of the score, 2e-5 of the largest gradient
    and Hessian entry (phase 2's, and test_derivatives')."""
    (s1, g1, h1), (s2, g2, h2) = got, want
    errs = (abs(float(s1) - float(s2)), float((g1 - g2).abs().max()), float((h1 - h2).abs().max()))
    tols = (1e-4 * abs(float(s2)), 2e-5 * float(g2.abs().max()), 2e-5 * float(h2.abs().max()))
    return errs, tols


def check_lut_cases(torch, dev):
    """K6L and K6G (`lut_pass`) on every case of `lut_cases`: each
    standalone call one launch and no synchronizing call, against its plain
    twin on the card at phase 2's tolerances (an all-masked cloud's sums
    exactly 0); the Newton loop's gated pass at the same transform: a
    finished candidate's rows untouched, else its rows, summed in row order,
    the standalone call's sums bit for bit. Returns the number of cases."""
    from lv_slam_tpu_torch.ops import ndt, ndt_soa

    cases = lut_cases()
    for case in cases:
        name = case["name"]
        vm, lut, soa, xs, xyz, mask, trans, gauss, offsets, weighted, done = lut_case_inputs(torch, case, dev)
        passes = {
            "ndt_derivatives_soa": (ndt_soa.KERNEL, lambda: ndt_soa.ndt_derivatives_soa(
                soa, xs, mask, trans, gauss, offsets, weighted), lambda: ndt_soa.ndt_derivatives_soa_ref(
                soa, xs, mask, trans, gauss, offsets, weighted), ndt_soa.soa_pass(soa, xs, mask, gauss, offsets,
                                                                                 weighted)),
            "ndt_derivatives": (ndt.KERNEL, lambda: ndt.ndt_derivatives(
                vm, lut, xyz, mask, trans, gauss, offsets, weighted), lambda: ndt.ndt_derivatives_ref(
                vm, lut, xyz, mask, trans, gauss, offsets, weighted), ndt.generic_pass(vm, lut, xyz, mask, gauss,
                                                                                        offsets, weighted)),
        }
        for kname, (kernel, call, plain, pass_) in passes.items():
            got = []
            before = kernel.launches
            syncs = count_syncs(torch, lambda: got.append(call()))
            torch.cuda.synchronize()
            if kernel.launches != before + 1 or syncs:
                raise AssertionError(f"{kname} ({name}): {kernel.launches - before} launches, {syncs} synchronizing "
                                     f"calls")
            (s1, g1, h1), want = got[0], plain()
            (es, eg, eh), (ts, tg, th) = derivative_errors(torch, (s1, g1, h1), want)
            if not (bool(torch.isfinite(s1)) and bool(torch.isfinite(g1).all()) and bool(torch.isfinite(h1).all())) \
                    or es > ts or eg > tg or eh > th:
                raise AssertionError(f"{kname} ({name}): errors score {es} (tol {ts}), grad {eg} (tol {tg}), hess "
                                     f"{eh} (tol {th})")
            state = ndt.NewtonState(trans[None])
            state.s[0, ndt.S_DONE] = int(done)
            state.partials = torch.full((pass_.n_blocks * ndt.N_TERMS,), float("nan"), dtype=torch.float32,
                                        device=dev)
            before = kernel.launches
            syncs = count_syncs(torch, lambda: pass_.launch(state))
            torch.cuda.synchronize()
            if kernel.launches != before + 1 or syncs:
                raise AssertionError(f"{kname}'s gated pass ({name}): {kernel.launches - before} launches, {syncs} "
                                     f"synchronizing calls")
            rows = state.partials.view(1, pass_.n_blocks, ndt.N_TERMS)
            if done:
                if not bool(torch.isnan(rows).all()):
                    raise AssertionError(f"{kname}'s gated pass ({name}): a finished candidate's rows were written")
                continue
            sums = probe_sums(torch, rows)[0]
            standalone = torch.cat([s1.reshape(1), g1.reshape(6), h1.reshape(36)])
            if not torch.equal(sums.view(torch.int32), standalone.view(torch.int32)):
                raise AssertionError(f"{kname}'s gated pass ({name}): its rows summed in row order are not the "
                                     f"standalone call's sums bit for bit")
    return len(cases)


WINDOW_CAP = 8192  # K2's edge cases: lanes a scan
WINDOW_CASE_NAMES = ("length 1", "length 16", "rows past the chunk clipped", "every row invalid",
                     "moved past the yz clip range")


def window_rels(rng, length: int) -> np.ndarray:
    """(length, 4, 4) float32 window-relative transforms: yaw, small tilts,
    a few metres of translation."""
    out = np.tile(np.eye(4, dtype=np.float32), (length, 1, 1))
    for i in range(length):
        yaw = rng.uniform(-0.3, 0.3)
        c, s = np.cos(yaw), np.sin(yaw)
        out[i, :3, :3] = [[c, -s, 0.01], [s, c, -0.02], [-0.01, 0.02, 1.0]]
        out[i, :3, 3] = rng.uniform(-3.0, 3.0, 3)
    return out


def window_cases(seed: int = SEED):
    """Kernel 2's edge cases as numpy arrays: (name, chunk xyz (C, 3, cap)
    transposed, intensity (C, cap), mask (C, cap), start, rels (L, 4, 4),
    valid (L,), resolution, out_cap), filtered scans as the odometry returns
    them (masked lanes at the sentinel) of WINDOW_CAP lanes with clusters
    inside 0.1 m cells and points on cell faces. A group of one row; of 16;
    rows past the chunk's end (clipped to its last row) with a padding row;
    every row invalid; a transform that moves points 2 km in y and -3 km in
    z, past the key's [-16384, 16383] cell clip, beside one that does not."""
    rng = np.random.default_rng(seed)
    cap = WINDOW_CAP

    def chunk(rows):
        xyz = np.empty((rows, 3, cap), np.float32)
        mask = rng.random((rows, cap)) >= 0.1
        for r in range(rows):
            pts = _voxel_scene(rng, cap)[:, :3]
            xyz[r] = np.where(mask[r][:, None], pts, 1.0e6).T
        return xyz, rng.uniform(0.0, 1.0, (rows, cap)).astype(np.float32), mask

    out = []
    out.append(("length 1", *chunk(4), 2, window_rels(rng, 1), np.ones(1, bool), 0.1, 4096))
    out.append(("length 16", *chunk(16), 0, window_rels(rng, 16), np.ones(16, bool), 0.1, 65536))
    out.append(("rows past the chunk clipped", *chunk(6), 3, window_rels(rng, 8), np.arange(8) < 7, 0.1, 32768))
    out.append(("every row invalid", *chunk(4), 0, window_rels(rng, 4), np.zeros(4, bool), 0.1, 32768))
    far = window_rels(rng, 2)
    far[0, :3, 3] = [0.0, 2000.0, -3000.0]
    out.append(("moved past the yz clip range", *chunk(2), 0, far, np.ones(2, bool), 0.1, 16384))
    assert tuple(name for name, *_ in out) == WINDOW_CASE_NAMES
    return out


def check_window_cases(torch, dev):
    """K2 (`window_group_filtered`) against its twin run on a CPU copy, bit
    for bit, on every case of `window_cases`, one launch and no
    synchronizing call each; returns the number of cases."""
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.pipeline import window

    cases = window_cases()
    for name, xyz, inten, mask, start, rels, valid, res, out_cap in cases:
        cpu = [torch.from_numpy(a) for a in (xyz, inten, mask)]
        extra = [torch.from_numpy(rels), torch.from_numpy(valid)]
        card = [a.to(dev) for a in cpu]
        extra_card = [a.to(dev) for a in extra]
        before = KERNELS["window_group_filtered_fn"].launches
        got = []
        syncs = count_syncs(torch, lambda: got.append(window.window_group_filtered(
            *card, start, *extra_card, res, out_cap)))
        torch.cuda.synchronize()
        if KERNELS["window_group_filtered_fn"].launches != before + 1 or syncs:
            raise AssertionError(f"window_group_filtered_fn ({name}): "
                                 f"{KERNELS['window_group_filtered_fn'].launches - before} launches, {syncs} "
                                 f"synchronizing calls")
        want = window.window_group_filtered_ref(*cpu, start, *extra, res, out_cap)
        if not identical_clouds(torch, on_cpu(PointCloud(*got[0])), want):
            raise AssertionError(f"window_group_filtered_fn ({name}): {int(got[0].mask.sum())} voxels against the "
                                 f"CPU twin's {int(want.mask.sum())}, not bit-identical")
    return len(cases)


RAW_WINDOW_CASE_NAMES = ("length 1, out_cap above the lanes", "length 16", "out_cap below the voxels",
                         "rows past the chunk clipped", "every row invalid", "moved past the yz clip range",
                         "points within ulps of the band edges")
RAW_NEAR, RAW_FAR = 0.5, 100.0  # the flagship prefilter's distance band


def _band_shell(rng, n: int, radius: float) -> np.ndarray:
    """(n, 3) float32 points at `radius`, each coordinate then moved by -4 to
    +4 ulps: |p| lies within a few ulps of a band edge."""
    d = rng.normal(size=(n, 3))
    p = (d / np.linalg.norm(d, axis=1, keepdims=True) * radius).astype(np.float32)
    steps = rng.integers(-4, 5, p.shape)
    for k in range(4):
        p = np.where(steps > k, np.nextafter(p, np.float32(np.inf)), p)
        p = np.where(steps < -k, np.nextafter(p, np.float32(-np.inf)), p)
    return p.astype(np.float32)


def raw_window_cases(seed: int = SEED):
    """Kernel 2r's edge cases as numpy arrays: (name, chunk xyz (C, cap, 3),
    intensity (C, cap), mask (C, cap), start, rels (L, 4, 4), valid (L,),
    near, far, resolution, out_cap), raw scans of WINDOW_CAP lanes as the
    sensor gives them (masked lanes at the sentinel, about 5 % of them)
    with clusters inside 0.1 m cells, points on cell faces, and points past
    the far edge. A group of one row into more rows than it has lanes; of
    16; out_cap below the voxels (the output truncated); rows past the
    chunk's end (clipped to its last row) with a padding row; every row
    invalid; a transform that moves points 2 km in y and -3 km in z, past the
    key's [-16384, 16383] cell clip, beside one that does not; and a chunk
    whose lanes are a quarter within 4 ulps of the near edge, a quarter of the
    far edge, masked lanes holding NaN."""
    rng = np.random.default_rng(seed)
    cap = WINDOW_CAP

    def chunk(rows, edges=False):
        xyz = np.empty((rows, cap, 3), np.float32)
        mask = rng.random((rows, cap)) >= 0.05
        q = cap // 4 if edges else cap // 64
        for r in range(rows):
            pts = np.concatenate([_band_shell(rng, q, RAW_NEAR), _band_shell(rng, q, RAW_FAR),
                                  _voxel_scene(rng, cap - 2 * q)[:, :3]])[rng.permutation(cap)]
            xyz[r] = np.where(mask[r][:, None], pts, np.nan if edges else 1.0e6)
        return xyz, rng.uniform(0.0, 1.0, (rows, cap)).astype(np.float32), mask

    band = (RAW_NEAR, RAW_FAR, 0.1)
    out = []
    out.append(("length 1, out_cap above the lanes", *chunk(4), 2, window_rels(rng, 1), np.ones(1, bool), *band,
                2 * cap))
    out.append(("length 16", *chunk(16), 0, window_rels(rng, 16), np.ones(16, bool), *band, 65536))
    out.append(("out_cap below the voxels", *chunk(4), 0, window_rels(rng, 4), np.ones(4, bool), *band, 1024))
    out.append(("rows past the chunk clipped", *chunk(6), 3, window_rels(rng, 8), np.arange(8) < 7, *band, 32768))
    out.append(("every row invalid", *chunk(4), 0, window_rels(rng, 4), np.zeros(4, bool), *band, 32768))
    far = window_rels(rng, 2)
    far[0, :3, 3] = [0.0, 2000.0, -3000.0]
    out.append(("moved past the yz clip range", *chunk(2), 0, far, np.ones(2, bool), *band, 16384))
    out.append(("points within ulps of the band edges", *chunk(4, edges=True), 0, window_rels(rng, 4),
                np.ones(4, bool), *band, 32768))
    assert tuple(name for name, *_ in out) == RAW_WINDOW_CASE_NAMES
    return out


def check_raw_window_cases(torch, dev):
    """K2r (`window_group`) against its twin run on a CPU copy, bit for bit,
    on every case of `raw_window_cases`, one launch and no synchronizing call
    each; returns the number of cases."""
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.pipeline import window

    cases = raw_window_cases()
    for name, xyz, inten, mask, start, rels, valid, near, far, res, out_cap in cases:
        cpu = [torch.from_numpy(a) for a in (xyz, inten, mask)]
        extra = [torch.from_numpy(rels), torch.from_numpy(valid)]
        card = [a.to(dev) for a in cpu]
        extra_card = [a.to(dev) for a in extra]
        before = KERNELS["window_group_fn"].launches
        got = []
        syncs = count_syncs(torch, lambda: got.append(window.window_group(
            *card, start, *extra_card, near, far, res, out_cap)))
        torch.cuda.synchronize()
        if KERNELS["window_group_fn"].launches != before + 1 or syncs:
            raise AssertionError(f"window_group_fn ({name}): {KERNELS['window_group_fn'].launches - before} launches, "
                                 f"{syncs} synchronizing calls")
        want = window.window_group_ref(*cpu, start, *extra, near, far, res, out_cap)
        if not identical_clouds(torch, on_cpu(PointCloud(*got[0])), want):
            raise AssertionError(f"window_group_fn ({name}): {int(got[0].mask.sum())} voxels against the CPU twin's "
                                 f"{int(want.mask.sum())}, not bit-identical")
    return len(cases)


SUBSAMPLE_CASE_NAMES = ("count 0", "count below out_cap", "count equal to out_cap", "KITTI density",
                        "holey mask", "out_cap at the lanes", "odd sizes")


def subsample_cases(seed: int = SEED):
    """Kernel 21's edge cases as numpy arrays: (name, points (n, 4) xyz and
    intensity, mask (n,), out_cap), front-compacted clouds as the prefilter
    returns them (masked lanes at the sentinel). No point set; fewer points
    than out_cap (the rows past them padding); exactly out_cap; 100000 of
    131072 lanes into 65536 (i * count overflows int32 there, the case of
    tests/test_dlo.py; a stride of 1.526 rounds in float32); a mask with
    holes, which the count takes whole; out_cap equal to the lanes (the
    cloud itself, no launch); and 12347 lanes, 9001 set, into 1001 rows (a
    ragged last group of rows, an unaligned tail of mask bytes)."""
    rng = np.random.default_rng(seed)

    def cloud(n, n_set, holes=False):
        pts = np.concatenate([rng.uniform(-50.0, 50.0, (n, 3)), rng.uniform(0.0, 1.0, (n, 1))], axis=1)
        mask = rng.random(n) >= 0.3 if holes else np.arange(n) < n_set
        pts[~mask, :3] = 1.0e6
        pts[~mask, 3] = 0.0
        return pts.astype(np.float32), mask

    out = [("count 0", *cloud(32768, 0), 8192), ("count below out_cap", *cloud(32768, 5000), 8192),
           ("count equal to out_cap", *cloud(32768, 8192), 8192), ("KITTI density", *cloud(131072, 100000), 65536),
           ("holey mask", *cloud(32768, 0, holes=True), 8192), ("out_cap at the lanes", *cloud(8192, 6000), 8192),
           ("odd sizes", *cloud(12347, 9001), 1001)]
    assert tuple(name for name, *_ in out) == SUBSAMPLE_CASE_NAMES
    return out


def check_subsample_cases(torch, dev):
    """K21 (`uniform_subsample`) against its twin run on a CPU copy, bit for
    bit, on every case of `subsample_cases`, one launch (none where out_cap
    reaches the lanes) and no synchronizing call each; returns the number of
    cases."""
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import prefilter

    cases = subsample_cases()
    for name, pts, mask, out_cap in cases:
        cpu = PointCloud(torch.from_numpy(pts[:, :3].copy()), torch.from_numpy(pts[:, 3].copy()),
                         torch.from_numpy(mask))
        card = PointCloud(cpu.xyz.to(dev), cpu.intensity.to(dev), cpu.mask.to(dev))
        before = KERNELS["uniform_subsample"].launches
        got = []
        syncs = count_syncs(torch, lambda: got.append(prefilter.uniform_subsample(card, out_cap)))
        torch.cuda.synchronize()
        launches = KERNELS["uniform_subsample"].launches - before
        if launches != (out_cap < len(pts)) or syncs:
            raise AssertionError(f"uniform_subsample ({name}): {launches} launches, {syncs} synchronizing calls")
        want = prefilter.uniform_subsample_ref(cpu, out_cap)
        if not identical_clouds(torch, on_cpu(got[0]), want):
            raise AssertionError(f"uniform_subsample ({name}): {int(got[0].mask.sum())} rows set against the CPU "
                                 f"twin's {int(want.mask.sum())}, not bit-identical")
    return len(cases)


def check_kernels(torch, scans, gt, dev):
    """Phase 2a: the odometry's kernels vs their plain versions at main-path shapes."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.ops import ndt_hash, prefilter, voxel_map
    from lv_slam_tpu_torch.ops.ndt import N_TERMS, NewtonState, make_gauss_params

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
    # the card's twin sums with atomics; on the CPU it sums in lane order, as the kernel does
    if not identical_clouds(torch, on_cpu(got), prefilter.voxel_downsample_ref(on_cpu(band), pf.downsample_resolution,
                                                                                pf.out_cap)):
        raise AssertionError("voxel_downsample: not bit-identical to the plain version run on a CPU copy")
    syncs = count_syncs(torch, k1)
    glue, n_launches = foreign_functions(torch, k1, DEVICE_FUNCTIONS["voxel_downsample"])
    if syncs or glue:
        raise AssertionError(f"voxel_downsample: {syncs} synchronizing calls, device work besides its own: {glue}")
    n_cases = check_sort_cases(torch, dev)
    log(f"  voxel_downsample: {int(got.mask.sum())} voxels of {int(band.mask.sum())} returns, "
        f"mask and lane order identical, max abs err {err:.3g} against the card's twin (tol 1e-5), bit-identical "
        f"to the twin on a CPU copy; {n_launches} launches of its own, no other device work, no synchronizing "
        f"call; the {n_cases} sort_cases bit-identical to the CPU twin, one launch each")
    n_in, n_vox = int(band.mask.sum()), int(got.mask.sum())
    measure(torch, records, "voxel_downsample", k1, p1, err,
            nbytes(band.xyz, band.intensity, band.mask, got.xyz, got.intensity, got.mask),
            4 * n_in + 4 * n_vox)  # 4 adds per point, 4 divisions per voxel
    # the glue the kernel's own sort replaced: torch.sort of the twin's int64 key over the same lanes
    key, _ = prefilter._voxel_key(band, pf.downsample_resolution)
    _, sort_ms, _ = device_ms(torch, lambda: torch.sort(key, stable=True))
    records["voxel_downsample"]["torch_sort_ms"] = sort_ms
    log(f"    torch.sort(stable=True) of the twin's {key.numel()} int64 keys: {sort_ms:.4f} ms device-only")

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
    err_mean, err_icov, err_w = map_agrees(torch, "build_voxel_map", vm, vm_ref)
    icov_tol = 1e-4 * float(vm_ref.icovs[v].abs().max())
    w_tol = 1e-4 * float(vm_ref.weights[v].abs().max())
    syncs = count_syncs(torch, k2)
    glue, n_launches = foreign_functions(torch, k2, DEVICE_FUNCTIONS["build_voxel_map"])
    if syncs or glue:
        raise AssertionError(f"build_voxel_map: {syncs} synchronizing calls, device work besides its own: {glue}")
    n_cases = check_map_cases(torch, dev)
    log(f"  build_voxel_map: {int(vm.n_leaves)} valid leaves, validity, keys, n_leaves and origin identical; "
        f"max abs err mean {err_mean:.3g} (tol 1e-5), icov {err_icov:.3g} (tol {icov_tol:.3g}), "
        f"weight {err_w:.3g} (tol {w_tol:.3g}); {n_launches} launches of its own, no other device work, no "
        f"synchronizing call; the {n_cases} map_cases agree with the card's twin and the CPU twin, one launch each")
    n_pts = int(filtered.mask.sum())
    skeys, order, _, _ = voxel_map._leaf_sort(filtered, ndt.resolution, ndt.lut_extent)
    n_occupied = int(torch.unique(skeys[skeys < ndt.lut_extent ** 3]).numel())
    measure(torch, records, "build_voxel_map", k2, p2, err_icov,
            nbytes(filtered.xyz, filtered.mask, vm.means, vm.icovs, vm.weights, vm.normals, vm.valid),
            25 * n_pts + 300 * n_occupied)  # centered moments per point; eigh + inverse per leaf
    # the glue the kernel's own sort replaced: torch.sort of the twin's int32 flat keys
    key = torch.empty_like(skeys)
    key[order] = skeys
    _, sort_ms, _ = device_ms(torch, lambda: torch.sort(key, stable=True))
    records["build_voxel_map"]["torch_sort_ms"] = sort_ms
    log(f"    torch.sort(stable=True) of the twin's {key.numel()} int32 keys: {sort_ms:.4f} ms device-only")

    # kernel 3: the same VoxelMap -> 131072 x 32 table, bit-exact
    k3 = lambda: ndt_hash.to_hash(vm, ndt.hash_buckets_per_leaf)  # noqa: E731
    p3 = lambda: ndt_hash.to_hash_ref(vm, ndt.hash_buckets_per_leaf)  # noqa: E731
    hm = k3()
    check_hash_twins(torch, "to_hash", hm, vm, ndt.hash_buckets_per_leaf)
    syncs = count_syncs(torch, k3)
    glue, n_launches = foreign_functions(torch, k3, DEVICE_FUNCTIONS["to_hash"])
    if syncs or glue:
        raise AssertionError(f"to_hash: {syncs} synchronizing calls, device work besides its own: {glue}")
    n_cases = check_hash_cases(torch, dev)
    log(f"  to_hash: table {tuple(hm.table.shape)} and n_dropped {int(hm.n_dropped)} bit-identical to the plain "
        f"version on the card and on a CPU copy; {n_launches} launches of its own, no other device work, no "
        f"synchronizing call; the {n_cases} hash_cases bit-identical to both twins, one launch each")
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
    # bytes: the points, the mask, the table's sectors that the probes need
    # (each once) and the 43 outputs; ~330 operations per lane and offset
    # (DIRECT1)
    d1 = voxel_map.neighborhood_offsets("DIRECT1", dev)
    sectors = probe_sectors(torch, hm, xs[None], src.mask[None], rel[None], d1)
    measure(torch, records, "ndt_derivatives_hash", *fns["DIRECT1"], err4,
            nbytes(xs, src.mask) + sectors["needed_bytes"] + 43 * 4, 330 * n_src)
    # the Newton loop's gated pass at the same shape: one launch, no
    # synchronizing call, no device work but its own; the L2 sectors its
    # probes fetch beside the bound's bytes
    state = NewtonState(rel[None])
    loop_pass = ndt_hash.hash_pass(hm, xs, src.mask.contiguous(), gauss, d1, True)
    state.partials = torch.empty((loop_pass.n_blocks * N_TERMS,), dtype=torch.float32, device=dev)
    records["ndt_derivatives_hash"].update(loop_pass_checks(torch, "ndt_derivatives_hash", lambda: loop_pass.launch(state)))
    same_twice(torch, "ndt_partials (K6)", lambda: loop_pass.launch(state), state.partials)
    records["ndt_derivatives_hash"]["l2_sectors"] = sectors
    log_sectors("ndt_partials (K6)", records["ndt_derivatives_hash"])
    n_cases = check_probe_cases(torch, dev)
    log(f"  ndt_partials: the {n_cases} probe_cases against the plain pass on the card, one launch and no "
        f"synchronizing call each, finished candidates' rows untouched")
    return records


def _ring_points(ranges: np.ndarray, min_elev_deg: float, max_elev_deg: float) -> np.ndarray:
    """Points at the centers of a (rings, 1800) range image's cells (NaN
    range: no return), as K8 projects them."""
    rings, n_az = ranges.shape
    elev = np.deg2rad(max_elev_deg - np.arange(rings) * (max_elev_deg - min_elev_deg) / (rings - 1))[:, None]
    azim = (np.arange(n_az) + 0.5) * (2.0 * np.pi / n_az) - np.pi
    pts = np.stack(np.broadcast_arrays(np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)),
                   axis=-1) * ranges[..., None]
    return pts.reshape(-1, 3)[np.isfinite(ranges).reshape(-1)]


def _room(rng, rings: int, min_elev_deg: float, max_elev_deg: float) -> np.ndarray:
    """A dense scan of every cell: walls whose range steps every 45 columns
    (edges), smooth stretches between (surfs), 1 cm of noise."""
    az = np.arange(1800)
    wall = 12.0 + 4.0 * np.sin(az * (2.0 * np.pi / 1800.0) * 3.0) + 1.5 * ((az // 45) % 3)
    ranges = np.repeat(wall[None, :], rings, axis=0) + rng.normal(0.0, 0.01, (rings, 1800))
    return _ring_points(ranges, min_elev_deg, max_elev_deg)


def _line(ring_z: float, ks, bump_every: int = 0) -> np.ndarray:
    """Points (10, k / 8, z) in one ring near the horizon: exact binary
    coordinates, so interior curvatures tie exactly (0 on a straight line);
    every `bump_every`-th point at x = 10.25 gives equal edge scores."""
    x = np.full(len(ks), 10.0)
    if bump_every:
        x[np.arange(len(ks)) % bump_every == 0] = 10.25
    return np.stack([x, np.asarray(ks, float) / 8.0, np.full(len(ks), ring_z)], axis=1)


FEATURE_CAP = 1 << 17  # K8's edge cases: phase 2's lane count
FEATURE_CASE_NAMES = ("every cell valid", "tied scores", "fewer than k good picks", "empty scan",
                      "VLP-16, less-flat k 85")


def feature_cases(seed: int = SEED):
    """K8's edge cases as numpy arrays: (name, xyz (n, 3), mask (n,),
    LfaConfig fields). A scan where every cell of every ring is valid (the
    windows wrap around full rows); sectors with tied scores (a straight
    line: equal surf scores; a line bumped every 6th point: equal edge
    scores; each across a sector edge); a ring holding one 15-point line
    (fewer than k good picks); an empty scan; VLP-16's 16 rings, where the
    less-flat k is 85 (more than a warp's 32 picks)."""
    rng = np.random.default_rng(seed)
    hdl = dict(min_elev_deg=-24.8, max_elev_deg=2.0)
    out = []
    full = _room(rng, 64, **hdl)
    out.append(("every cell valid", full, np.ones(len(full), bool), {}))
    # ring 5 of 64 sits at -0.1270 degrees: z = -0.0222 at 10 m
    ties = np.concatenate([_line(-0.0222, range(-24, 24), bump_every=6),
                           _line(-0.0222 - 10.0 * np.tan(np.deg2rad(2 * 26.8 / 63)), range(-30, 30))])
    out.append(("tied scores", ties, np.ones(len(ties), bool), {}))
    few = _line(-0.0222, range(-7, 8))
    out.append(("fewer than k good picks", few, np.ones(len(few), bool), {}))
    out.append(("empty scan", full, np.zeros(len(full), bool), {}))
    vlp = dict(min_elev_deg=-15.0, max_elev_deg=15.0)
    room16 = _room(rng, 16, **vlp)
    out.append(("VLP-16, less-flat k 85", room16, np.ones(len(room16), bool),
                dict(scan_line=16, minimum_range=0.3, **vlp)))
    assert tuple(name for name, *_ in out) == FEATURE_CASE_NAMES
    return [(name, xyz.astype(np.float32), mask, kw) for name, xyz, mask, kw in out]


def check_feature_cases(torch, dev):
    """K8 against its twin run on a CPU copy, bit for bit (all four clouds),
    on every case of `feature_cases`, one launch each; returns the number of
    cases."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.lfa import features

    cases = feature_cases()
    for name, xyz, mask, kw in cases:
        cfg = dataclasses.replace(kitti_flagship_config().lfa, **kw)
        cpu = PointCloud.from_numpy(xyz, cap=FEATURE_CAP, device="cpu")
        cpu.mask[: len(mask)] &= torch.from_numpy(mask)
        card = PointCloud(cpu.xyz.to(dev), cpu.intensity.to(dev), cpu.mask.to(dev))
        before = KERNELS["extract_features"].launches
        got = features.extract_features(card, cfg)
        torch.cuda.synchronize()
        if KERNELS["extract_features"].launches != before + 1:
            raise AssertionError(f"extract_features ({name}): not one launch")
        want = features.extract_features_ref(cpu, cfg)
        for field, a, b in zip(features.FeatureClouds._fields, got, want):
            a = a.cpu()
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                raise AssertionError(f"extract_features ({name}): {field} differs from the CPU twin's")
    return len(cases)


FIT_CELL = 2.0  # the flagship's cell-table cell (lfa/odometry.py _GRID_CELL)
FIT_CASE_NAMES = ("every query masked", "one bucket", "dense cluster, 48 candidates", "d^2 exactly 1",
                  "k - 1 and k participants", "q = 1", "q = 1025", "q = 0", "S = 1", "S = 32")


def fit_table(pts: np.ndarray, n_buckets: int, slots: int, cell: float = FIT_CELL) -> np.ndarray:
    """(n_buckets, slots * 4) cell table of the float32 points in order: each
    point in the first free slot of its cell's bucket (the cell floor(p /
    cell), hashed as kernel 10 probes it), dropped when the bucket is full."""
    table = np.zeros((n_buckets, slots, 4), np.float32)
    filled = np.zeros(n_buckets, np.int64)
    c = np.floor(pts / np.float32(cell)).astype(np.int64)
    h = ((c[:, 0] * 73856093) ^ (c[:, 1] * 19349669) ^ (c[:, 2] * 83492791)) & 0xFFFFFFFF
    for p, b in zip(pts, h % n_buckets):
        if filled[b] < slots:
            table[b, filled[b]] = (*p, 1.0)
            filled[b] += 1
    return table.reshape(n_buckets, slots * 4)


def _strip(rng, center, n: int, half=(0.9, 0.3, 0.01)) -> np.ndarray:
    """n points of a flat strip around `center`: long in x, narrow in y,
    thin in z, so both fits accept them (a line along x, a plane normal to z)."""
    return (np.asarray(center) + rng.uniform(-1.0, 1.0, (n, 3)) * np.asarray(half)).astype(np.float32)


def _octants(rng, n: int) -> np.ndarray:
    """n points in each of the 8 cells around (2, 2, 2) (cell 2.0), all
    within 0.91 m of it, a strip long in x, narrow in y, thin in z."""
    out = []
    for o in range(8):
        sign = np.array([1.0 if (o >> (2 - a)) & 1 else -1.0 for a in range(3)])
        mag = np.stack([rng.uniform(0.3, 0.85, n), rng.uniform(0.05, 0.3, n), rng.uniform(0.002, 0.01, n)], axis=1)
        out.append(2.0 + sign * mag)
    return np.concatenate(out).astype(np.float32)


def fit_cases(seed: int = SEED):
    """Kernel 10's edge cases as numpy arrays: (name, table (B, S * 4),
    queries (q, 3), mask (q,), k), each run by `lines_from_fit` and
    `planes_from_fit` on cell tables of cell FIT_CELL. Every query masked
    out, with sentinel (1e6) and NaN queries; one bucket, so the 8 probes
    of a query hit it and only probe 0 reads it (k 6: its 6 slots); a dense
    cluster whose 48 candidates all take part (k 48); a candidate at a
    float32 d^2 of exactly 1 (out) beside one at 1 - 2^-23 (in) and 5
    others (k 6); queries with exactly k - 1 and k participants and
    points just past 1 m in their probes; one query; 1025 queries on a
    map of a floor, a wall and upright boards; no query; one slot; 32 slots (256
    candidates, slots past the registers read again)."""
    rng = np.random.default_rng(seed)
    out = []
    strips = np.concatenate([_strip(rng, rng.uniform(-8.0, 8.0, 3), 30) for _ in range(12)])
    near = strips[rng.integers(0, len(strips), 24)] + rng.normal(0.0, 0.05, (24, 3)).astype(np.float32)
    queries = np.concatenate([near, np.full((8, 3), 1.0e6, np.float32), np.full((8, 3), np.nan, np.float32)])
    out.append(("every query masked", fit_table(strips, 4096, 6), queries, np.zeros(len(queries), bool), 5))
    row = _strip(rng, (0.5, 0.5, 0.5), 6, half=(0.45, 0.15, 0.005))
    queries = row[:3] + np.float32(0.01)
    out.append(("one bucket", fit_table(row, 1, 6), queries, np.ones(3, bool), 6))
    dense = _octants(rng, 6)
    at_dense = (2.0 + rng.uniform(-0.05, 0.05, (4, 3))).astype(np.float32)
    out.append(("dense cluster, 48 candidates", fit_table(dense, 4096, 6), at_dense, np.ones(4, bool), 48))
    gate = np.array([[-0.5, 0.1, 0.0], [-0.25, -0.1, 0.0], [0.25, 0.12, 0.0], [0.5, -0.08, 0.0], [-0.75, 0.05, 0.0],
                     [1.0, 0.0, 0.0], [np.nextafter(np.float32(-1.0), np.float32(0.0)), 0.0, 0.0]], np.float32)
    out.append(("d^2 exactly 1", fit_table(gate, 4096, 6), np.zeros((1, 3), np.float32), np.ones(1, bool), 6))
    a, b = np.float32([10.0, 10.0, 10.0]), np.float32([-10.0, 10.0, 10.0])
    beyond = np.array([[1.5, 0.0, 0.0], [0.0, 1.2, 0.3], [-1.1, -0.4, 0.0]], np.float32)
    pts = np.concatenate([_strip(rng, a, 5, half=(0.6, 0.2, 0.005)), a + beyond,
                          _strip(rng, b, 4, half=(0.6, 0.2, 0.005)), b + beyond])
    out.append(("k - 1 and k participants", fit_table(pts, 4096, 6), np.stack([a, b]), np.ones(2, bool), 5))
    out.append(("q = 1", fit_table(dense, 4096, 6), at_dense[:1], np.ones(1, bool), 5))
    floor = np.concatenate([rng.uniform(-12.0, 12.0, (3000, 2)), rng.normal(0.0, 0.01, (3000, 1))], axis=1)
    wall = np.concatenate([rng.normal(6.0, 0.01, (1500, 1)), rng.uniform(-12.0, 12.0, (1500, 1)),
                           rng.uniform(0.0, 4.0, (1500, 1))], axis=1)
    boards = np.repeat(rng.uniform(-10.0, 10.0, (20, 3)) * np.array([1.0, 1.0, 0.0]), 40, axis=0) + np.concatenate(
        [rng.normal(0.0, 0.005, (800, 1)), rng.uniform(-1.0, 1.0, (800, 1)), rng.uniform(0.0, 2.0, (800, 1))], axis=1)
    world = np.concatenate([floor, wall, boards]).astype(np.float32)[rng.permutation(5300)]
    queries = (world[rng.integers(0, len(world), 1025)] + rng.normal(0.0, 0.1, (1025, 3))).astype(np.float32)
    out.append(("q = 1025", fit_table(world, 8192, 6), queries, rng.random(1025) >= 0.1, 5))
    out.append(("q = 0", fit_table(world, 8192, 6), np.zeros((0, 3), np.float32), np.zeros(0, bool), 5))
    out.append(("S = 1", fit_table(dense, 4096, 1), at_dense, np.ones(4, bool), 5))
    out.append(("S = 32", fit_table(_octants(rng, 32), 4096, 32), at_dense, np.ones(4, bool), 5))
    assert tuple(name for name, *_ in out) == FIT_CASE_NAMES
    return out


def check_fit_cases(torch, dev):
    """Kernel 10 (`lines_from_fit`, `planes_from_fit` on a cell table)
    against its twin run on a CPU copy on every case of `fit_cases`, one
    launch each and no synchronizing call: accept decisions identical, the
    lines' means bit-identical, the other floats finite on every lane and
    within 1e-5 on accepted queries; returns the number of cases."""
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.lfa import registration
    from lv_slam_tpu_torch.ops.knn import CellTable

    cases = fit_cases()
    for name, table, y, mask, k in cases:
        cpu = CellTable(torch.from_numpy(table), FIT_CELL), torch.from_numpy(y), torch.from_numpy(mask)
        card = CellTable(cpu[0].table.to(dev), FIT_CELL), cpu[1].to(dev), cpu[2].to(dev)
        for kind, fn in (("lines_from_fit", registration.lines_from_fit),
                         ("planes_from_fit", registration.planes_from_fit)):
            before = KERNELS[kind].launches
            got = []
            syncs = count_syncs(torch, lambda: got.append(fn(card[1], card[2], card[0], k=k)))
            torch.cuda.synchronize()
            if KERNELS[kind].launches != before + 1 or syncs:
                raise AssertionError(f"{kind} ({name}): {KERNELS[kind].launches - before} launches, {syncs} syncs")
            got = [t.cpu() for t in got[0]]
            want = fn(cpu[1], cpu[2], cpu[0], k=k)
            fit_agrees(torch, f"{kind} ({name})", got, want, kind == "lines_from_fit")
    return len(cases)


def fit_agrees(torch, what: str, got, want, bits: bool) -> float:
    """Kernel 10's fields `got` against its twin's `want` (both on the CPU):
    accept decisions identical, the fitted floats finite on every lane (gn_solve
    reads every lane, a rejected one with weight 0, and 0 * NaN is NaN) and
    within 1e-5 on accepted queries (a rejected fit may be a degenerate
    eigenvector, which the two eigh may pick differently); with `bits`, the
    first field (the lines' means: sums and one division, no libm)
    bit-identical on every lane. Returns the max abs err."""
    if not torch.equal(got[2], want[2]):
        raise AssertionError(f"{what}: {int((got[2] != want[2]).sum())} accept decisions differ")
    if not all(bool(torch.isfinite(a).all()) for a in got[:2]):
        raise AssertionError(f"{what}: non-finite fitted floats")
    if bits and not torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)):
        raise AssertionError(f"{what}: means not bit-identical to the twin's")
    v = want[2]
    err = max((float((a[v] - b[v]).abs().max()) if bool(v.any()) else 0.0) for a, b in zip(got[:2], want[:2]))
    if err > 1e-5:
        raise AssertionError(f"{what}: max abs err {err} > 1e-5")
    return err


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
    poses = [torch.from_numpy(p).to(dev) for p in gt_rel[:6]]
    raw = [PointCloud.from_numpy(scans[i], cap=full.prefilter.raw_cap, device=dev) for i in range(6)]
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
    if not identical([t.cpu() for t in got], features.extract_features_ref(on_cpu(raw[1]), cfg)):
        raise AssertionError("extract_features: feature clouds differ from the plain version run on a CPU copy")
    syncs = count_syncs(torch, k8)
    glue, n_launches = foreign_functions(torch, k8, DEVICE_FUNCTIONS["extract_features"])
    if syncs or glue or n_launches > 3:
        raise AssertionError(f"extract_features: {syncs} synchronizing calls, {n_launches} launches, device work "
                             f"besides its own: {glue}")
    n_cases = check_feature_cases(torch, dev)
    counts = [int(m.sum()) for m in got[1::2]]
    log(f"  extract_features: sharp / less sharp / flat / less flat {counts} of lanes "
        f"{[m.numel() for m in got[1::2]]}, masks and points bit-identical to the twin on the card and on a CPU "
        f"copy; {n_launches} launches, no other device work, no synchronizing call; the {n_cases} feature_cases "
        f"bit-identical to the CPU twin, one launch each")
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
    # over the one-block cap: scans 4 and 5's surf batches in one insert,
    # the route with the torch.sort glue
    pts5, m5 = world(feats[5], poses[5])[1]
    pts45, m45 = torch.cat([pts4, pts5]), torch.cat([m4, m5])
    if pts45.shape[0] <= knn.INSERT_BLOCK_ROWS:
        raise AssertionError(f"insert_cell_table: {pts45.shape[0]} rows are under the one-block cap")
    over = {route: knn.CellTable(t[1].table.clone(), t[1].cell_size) for route, t in tables.items()}
    knn.insert_cell_table_(over["kernel"], pts45, m45, res[1])
    knn.insert_cell_table_ref_(over["plain"], pts45, m45, res[1])
    if not identical(over["kernel"], over["plain"]):
        raise AssertionError("insert_cell_table: scans 4-5's insert over the cap differs from the plain version")
    n_kept45 = stored(over["kernel"]) - n_stored[1]
    khi, _ = knn._insert_keys_ref(pts45, m45, surf.table.shape[0], res[1], surf.cell_size)
    b45 = khi >> 32
    n_rows45 = int(torch.unique(b45[b45 < surf.table.shape[0]]).numel())
    log(f"  insert_cell_table over the cap: scans 4-5's {pts45.shape[0]} surf rows add {n_kept45} points; "
        f"the map bit-identical to the plain version")
    records["insert_cell_table"]["over_cap"] = timed(
        torch, "insert_cell_table",
        on_copies(surf, lambda t: knn.insert_cell_table_(t, pts45, m45, res[1])),
        on_copies(surf, lambda t: knn.insert_cell_table_ref_(t, pts45, m45, res[1])), 0.0,
        nbytes(pts45, m45) + n_rows45 * surf.table.shape[1] * 4 + 16 * n_kept45, 20 * pts45.shape[0],
        what=f" over the cap ({pts45.shape[0]} rows)",
    )

    # kernel 9b: crop both maps around scan 4's pose in one launch, as the
    # LFA step does: gate open (moved past the interval), closed, absent
    center = poses[4][:3, 3].contiguous()
    last = center + 1e6
    for what, lc, interval in (("gate open", last, cfg.crop_interval), ("gate closed", center + 0.5 * cfg.crop_interval,
                                                                      cfg.crop_interval), ("no gate", None, 0.0)):
        got_t = [knn.CellTable(t.table.clone(), t.cell_size) for t in (edge, surf)]
        want_t = [knn.CellTable(t.table.clone(), t.cell_size) for t in (edge, surf)]
        ck = knn.crop_cell_tables_(*got_t, center, cfg.crop_radius, lc, interval)
        cp = knn.crop_cell_tables_ref_(*want_t, center, cfg.crop_radius, lc, interval)
        if not identical((ck, got_t[0].table, got_t[1].table), (cp, want_t[0].table, want_t[1].table)):
            raise AssertionError(f"crop_cell_tables_ ({what}): a table or the crop center differs from the plain "
                                 f"version")
        if what == "gate open":
            n_dropped = [n - stored(t) for n, t in zip(n_stored, got_t)]
            log(f"  crop_cell_tables_ ({what}): {stored(got_t[0])} of {n_stored[0]} edge and {stored(got_t[1])} of "
                f"{n_stored[1]} surf points within {cfg.crop_radius} m, both tables and the crop center bit-identical")
        else:
            log(f"  crop_cell_tables_ ({what}): both tables and the crop center bit-identical")
    n_cases = check_crop_cases(torch, dev)
    log(f"  crop_cell_tables_: the {n_cases} crop_cases bit-identical to the twin, one launch each")
    # bytes it must move: one read of both tables and the centers, one 4-byte
    # flag per slot it frees, the new crop center; gate closed, the centers
    k9b = on_copies((edge, surf), lambda e, s: knn.crop_cell_tables_(e, s, center, cfg.crop_radius, last,
                                                                      cfg.crop_interval))
    p9b = on_copies((edge, surf), lambda e, s: knn.crop_cell_tables_ref_(e, s, center, cfg.crop_radius, last,
                                                                          cfg.crop_interval))
    measure(torch, records, "crop_cell_table", k9b, p9b, 0.0,
            nbytes(edge.table, surf.table, center, last) + 4 * sum(n_dropped) + 12,
            10 * (edge.table.numel() + surf.table.numel()) // 4)
    near = center + 0.5 * cfg.crop_interval
    records["crop_cell_table"]["gate_closed"] = timed(
        torch, "crop_cell_table",
        lambda: knn.crop_cell_tables_(edge, surf, center, cfg.crop_radius, near, cfg.crop_interval),
        lambda: knn.crop_cell_tables_ref_(edge, surf, center, cfg.crop_radius, near, cfg.crop_interval), 0.0,
        nbytes(center, near) + 12, 10, what=" (both tables, gate closed)")
    records["crop_cell_table"]["surf_only"] = timed(
        torch, "crop_cell_table",
        on_copies(surf, lambda t: knn.crop_cell_table_(t, center, cfg.crop_radius, last, cfg.crop_interval)),
        on_copies(surf, lambda t: knn.crop_cell_table_ref_(t, center, cfg.crop_radius, last, cfg.crop_interval)), 0.0,
        nbytes(surf.table, center, last) + 4 * n_dropped[1] + 12, 10 * surf.table.numel() // 4,
        what=" (the surf table alone, gate open)")

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
        got = k10()
        err = fit_agrees(torch, name, [t.cpu() for t in got], [t.cpu() for t in p10()], False)
        # and against the twin on a CPU copy, the lines' means bit for bit
        fit_agrees(torch, f"{name} (CPU twin)", [t.cpu() for t in got],
                   ref(y.cpu(), m.cpu(), knn.CellTable(table.table.cpu(), table.cell_size), k=cfg.knn_k),
                   name == "lines_from_fit")
        fields[name] = got
        log(f"  {name}: {int(got.valid.sum())} of {int(m.sum())} queries accepted, decisions identical, "
            f"fitted floats finite on every lane, max abs err {err:.3g} on accepted ones (tol 1e-5); the same "
            f"against the twin on a CPU copy{', the means bit-identical' if name == 'lines_from_fit' else ''}")
        measure(torch, records, name, k10, p10, err, nbytes(y, m, table.table, *got),
                1500 * y.shape[0])  # 8 x 6 candidates ~25 each, one eigh ~300

    n_cases = check_fit_cases(torch, dev)
    log(f"  lines_from_fit, planes_from_fit: the {n_cases} fit_cases against the twin on a CPU copy, one launch "
        f"each and no synchronizing call: decisions identical, the lines' means bit-identical")

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
    # standalone LFA's odometry shape: scan 4's sharp / flat features on
    # scan 3's grids (lfa/odometry.py odom_step), seeded 0.3 m off
    from lv_slam_tpu_torch.lfa.odometry import feature_grids

    edge_grid, surf_grid = feature_grids(feats[3])
    rel = torch.linalg.inv(poses[3]) @ poses[4]
    guess = rel.clone()
    guess[0, 3] += 0.3
    lines = registration.lines_from_2nn(se3.transform_points(guess, f4.sharp), f4.sharp_mask, edge_grid)
    planes = registration.planes_from_3nn(se3.transform_points(guess, f4.flat), f4.flat_mask, surf_grid)
    gn_args = (guess, f4.sharp, lines, f4.flat, planes, cfg.odom_max_iterations)
    k11 = lambda: registration.gn_solve(*gn_args)  # noqa: E731
    p11 = lambda: registration.gn_solve_ref(*gn_args)  # noqa: E731
    got, want = k11(), p11()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > 1e-4:
        raise AssertionError(f"gn_solve at the standalone shape: max abs err {err} > 1e-4")
    ne, ns = lines.valid.numel(), planes.valid.numel()
    log(f"  gn_solve at standalone LFA's shape: {cfg.odom_max_iterations} iterations over {ne} + {ns} lanes "
        f"({int(lines.valid.sum())} + {int(planes.valid.sum())} matched), max abs err {err:.3g} (tol 1e-4)")
    records["gn_solve"]["standalone"] = timed(
        torch, "gn_solve", k11, p11, err, nbytes(guess, f4.sharp, *lines, f4.flat, *planes) + 64,
        cfg.odom_max_iterations * (150 * ne + 90 * ns), what=f" at {ne} + {ns} lanes",
    )
    return records


def backend_graph(torch, rel: np.ndarray, sensors: bool):
    """(graph, SE3 edges): phase 2c's 64 keyframes (every other pose of the
    circle `rel`, 0.05 m / 0.01 rad of noise), 63 odometry edges and 8
    loops from the last 16 keyframes to the first; with `sensors`, phase
    2g's: GPS / IMU orientation / gravity priors on each keyframe, a fixed
    floor plane and an SE3-plane edge from each."""
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.graph import pose_graph

    rng = np.random.default_rng(SEED)
    g = pose_graph.empty_graph(64, 128, 256, 8, 64, 16) if sensors else pose_graph.empty_graph(64, 128, 16, 8, 8, 16)
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
    if not sensors:
        return g, n_edges
    pose_graph.add_plane_node(g, 0, [0.0, 0.0, 1.0, 0.0], fixed=True)
    for i in range(64):
        rot = kf[i][:3, :3]
        quat = se3.quat_from_matrix(torch.from_numpy(rot.astype(np.float32))).double().numpy()
        pose_graph.add_prior(g, 3 * i, i, pose_graph.PRIOR_XYZ, kf[i][:3, 3] + rng.normal(0, 0.2, 3),
                             np.diag([1 / 20.0, 1 / 20.0, 1 / 5.0]), huber=1.0)
        pose_graph.add_prior(g, 3 * i + 1, i, pose_graph.PRIOR_QUAT, quat, np.eye(3), huber=1.0)
        pose_graph.add_prior(g, 3 * i + 2, i, pose_graph.PRIOR_VEC, np.r_[0.0, 0.0, 1.0, rot.T @ [0.0, 0.0, 1.0]],
                             np.eye(3), huber=1.0)
        pose_graph.add_se3_plane_edge(g, i, i, 0, np.r_[rng.normal(0, 0.01, 2), 1.0, 1.73], np.eye(3) / 100.0)
    return g, n_edges


def check_backend_kernels(torch, scans, gt, dev):
    """Phase 2c: the backend's kernels vs their plain versions at the shapes
    phase 5 gives them: a 16-scan window group of filtered KITTI-density
    scans (2.1 M rows in, 131072 out), the merge of two partials, 8 loop
    candidates of 131072 lanes against the 1 m map of that keyframe cloud,
    its 0.25 m centroid grid, and a 64-node, 128-edge pose graph."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.graph import pose_graph
    from lv_slam_tpu_torch.ops import ndt_hash, nn, prefilter, voxel_map
    from lv_slam_tpu_torch.ops.ndt import N_TERMS, NewtonState, make_gauss_params
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

    def sort_ms(name, cloud):
        """torch.sort of the twin's int64 voxel keys of `cloud`, the glue the kernel's own sort replaced."""
        key, _ = prefilter._voxel_key(cloud, res)
        _, ms, _ = device_ms(torch, lambda: torch.sort(key, stable=True))
        records[name]["torch_sort_ms"] = ms
        log(f"    torch.sort(stable=True) of the twin's {key.numel()} int64 keys: {ms:.4f} ms device-only")

    # kernel 2: scans 0-15 moved into scan 0's frame, first point per voxel
    g16 = group(0, 16)
    k2 = lambda: window.window_group_filtered(*g16)  # noqa: E731
    p2 = lambda: window.window_group_filtered_ref(*g16)  # noqa: E731
    keyframe, want = k2(), p2()
    if not identical(keyframe, want):
        raise AssertionError("window_group_filtered_fn: kept lanes differ from the plain version")
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in g16]
    if not identical_clouds(torch, on_cpu(keyframe), window.window_group_filtered_ref(*cpu_args)):
        raise AssertionError("window_group_filtered_fn: not bit-identical to the plain version run on a CPU copy")
    n_launches = one_call(torch, "window_group_filtered_fn", k2)
    n_cases = check_window_cases(torch, dev)
    n_in, n_kept = int(g16[2].sum()), int(keyframe.mask.sum())
    log(f"  window_group_filtered_fn: 16 x {g16[0].shape[2]} rows, {n_in} valid -> {n_kept} voxels "
        f"in {keyframe.cap} lanes, identical to the plain version on the card and on a CPU copy; {n_launches} "
        f"launches of its own, no other device work, no synchronizing call; the {n_cases} window_cases "
        f"bit-identical to the CPU twin, one launch each")
    measure(torch, records, "window_group_filtered_fn", k2, p2, 0.0,
            nbytes(*g16[:3], g16[4], g16[5]) + 17 * keyframe.cap, 20 * g16[2].numel())
    idx = torch.arange(16, device=dev)  # the twin's moved cloud, as window_group_filtered_ref forms it
    moved_mask = g16[2][idx] & g16[5][:, None]
    moved = torch.where(moved_mask[..., None], se3.transform_points_fma(g16[4], g16[0][idx].transpose(1, 2)), 1.0e6)
    sort_ms("window_group_filtered_fn",
            PointCloud(moved.reshape(-1, 3), g16[1][idx].reshape(-1), moved_mask.reshape(-1)))

    # kernel 1b: that partial merged with scans 16-23's (a window across chunks)
    part2 = window.window_group_filtered(*group(16, 8))
    both = PointCloud(*(torch.cat([a, b]) for a, b in zip(keyframe, part2)))
    k1b = lambda: prefilter.voxel_dedup_first(both, res, kf_cap)  # noqa: E731
    p1b = lambda: prefilter.voxel_dedup_first_ref(both, res, kf_cap)  # noqa: E731
    got, want = k1b(), p1b()
    if not identical(got, want):
        raise AssertionError("voxel_dedup_first: kept lanes differ from the plain version")
    if not identical_clouds(torch, on_cpu(got), prefilter.voxel_dedup_first_ref(on_cpu(both), res, kf_cap)):
        raise AssertionError("voxel_dedup_first: not bit-identical to the plain version run on a CPU copy")
    n_launches = one_call(torch, "voxel_dedup_first", k1b)
    n_cases = check_dedup_cases(torch, dev)
    log(f"  voxel_dedup_first: {both.cap} rows, {int(both.mask.sum())} valid -> {int(got.mask.sum())} voxels, "
        f"identical to the plain version on the card and on a CPU copy; {n_launches} launches of its own, no other "
        f"device work, no synchronizing call; the {n_cases} sort_cases bit-identical to the CPU twin, one launch each")
    measure(torch, records, "voxel_dedup_first", k1b, p1b, 0.0, nbytes(*both) + 17 * got.cap,
            10 * both.cap)
    sort_ms("voxel_dedup_first", both)

    # kernel 3 at the loop detector's 4 m rung over that keyframe cloud: runs of hundreds of points
    k3 = lambda: voxel_map.build_voxel_map(keyframe, 4.0, leaf_cap=16384, lut_extent=256)  # noqa: E731
    p3 = lambda: voxel_map.build_voxel_map_ref(keyframe, 4.0, leaf_cap=16384, lut_extent=256)  # noqa: E731
    vm4 = k3()
    err = map_agrees(torch, "build_voxel_map (4 m rung)", vm4, p3())
    skeys = voxel_map._leaf_sort(keyframe, 4.0, 256)[0]
    _, runs = torch.unique_consecutive(skeys[skeys < 256 ** 3], return_counts=True)
    rung = timed(torch, "build_voxel_map", k3, p3, err[1],
                 nbytes(keyframe.xyz, keyframe.mask, vm4.means, vm4.icovs, vm4.weights, vm4.normals, vm4.valid),
                 25 * int(keyframe.mask.sum()) + 300 * runs.numel(), what=" (4 m rung)")
    rung.update(runs=runs.numel(), longest_run=int(runs.max()), valid_leaves=int(vm4.n_leaves))
    records["_build_voxel_map_4m"] = rung
    log(f"  build_voxel_map at the 4 m rung: {runs.numel()} runs (longest {int(runs.max())} points), "
        f"{int(vm4.n_leaves)} valid leaves, agreeing with the card's twin")
    # kernel 5 on that rung's map, as the loop detector re-indexes it
    hm4 = ndt_hash.to_hash(vm4)
    check_hash_twins(torch, "to_hash (4 m rung)", hm4, vm4)
    log(f"  to_hash at the 4 m rung: table {tuple(hm4.table.shape)}, n_dropped {int(hm4.n_dropped)}, bit-identical "
        f"to the plain version on the card and on a CPU copy")

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
    # bytes: the points, masks and guesses and the table's sectors that the
    # probes need (each once); per lane 7 probes (~40 operations) and ~330
    # per hit
    sectors = probe_sectors(torch, hm, xs, mask, guesses, offsets)
    measure(torch, records, "_fused_verify_fn", k13, p13, err13,
            nbytes(xs, mask, guesses) + sectors["needed_bytes"] + 8 * 43 * 4, (7 * 40 + 330) * n_lanes)
    state = NewtonState(guesses, batched=True)
    loop_pass = ndt_hash.hash_pass(hm, xs, mask, make_gauss_params(1.0), offsets, False)
    state.partials = torch.empty((len(cands) * loop_pass.n_blocks * N_TERMS,), dtype=torch.float32, device=dev)
    records["_fused_verify_fn"].update(loop_pass_checks(torch, "_fused_verify_fn", lambda: loop_pass.launch(state)))
    same_twice(torch, "ndt_partials (K13, 1 m)", lambda: loop_pass.launch(state), state.partials)
    records["_fused_verify_fn"]["l2_sectors"] = sectors
    log_sectors("ndt_partials (K13, 1 m)", records["_fused_verify_fn"])

    # kernel 14: the keyframe cloud's 0.25 m grid, then the 8 candidates'
    # fitness at their guesses
    k14 = lambda: nn.build_centroid_grid(keyframe, 0.25)  # noqa: E731
    p14 = lambda: nn.build_centroid_grid_ref(keyframe, 0.25)  # noqa: E731
    grid, want = k14(), p14()
    err = grid_agrees(torch, "build_centroid_grid", grid, want)
    v = want.counts > 0
    n_launches = one_call(torch, "build_centroid_grid", k14)
    n_cases = check_grid_cases(torch, dev)
    log(f"  build_centroid_grid: {n_kept} points -> {int(v.sum())} of {grid.keys.shape[0]} leaves, keys, counts and "
        f"origin identical, centroids within {err:.3g} (tol 1e-6 relative); {n_launches} launches of its own, no "
        f"other device work, no synchronizing call; the {n_cases} grid_cases agree with the card's twin and the CPU "
        f"twin, one launch each, their queries (nn_sq_dists, nn_points, the radius removal) bit for bit")
    measure(torch, records, "build_centroid_grid", k14, p14, err,
            nbytes(keyframe.xyz, keyframe.mask, grid.keys, grid.centroids, grid.counts), 4 * n_kept)
    # the glue the kernel's own sort replaced: torch.sort of the twin's int32 flat keys
    key14, _, _ = nn._grid_keys(keyframe, 0.25)
    _, sort14_ms, _ = device_ms(torch, lambda: torch.sort(key14, stable=True))
    records["build_centroid_grid"]["torch_sort_ms"] = sort14_ms
    log(f"    torch.sort(stable=True) of the twin's {key14.numel()} int32 keys: {sort14_ms:.4f} ms device-only")

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
    # operations per masked-in lane: 9 column searches (3 a step), 27 hit
    # tests and distances (10 each), the move (~30)
    steps = int(np.ceil(np.log2(grid.keys.shape[0] + 1)))
    measure(torch, records, "nn_sq_dists", kq, pq, err_fit,
            nbytes(batch.xyz, batch.mask, guesses, grid.keys, grid.centroids, fit), n_q * (9 * 3 * steps + 27 * 10 + 30))

    # kernel 15: 64 keyframes (every other pose of the circle, 0.05 m / 0.01
    # rad of noise), 63 odometry edges and loops from the last 16 to the first
    g, n_edges = backend_graph(torch, rel, sensors=False)
    dg = pose_graph.to_device(g, dev)
    k15 = lambda: pose_graph._chi2_and_normal(dg, dg.poses, True)  # noqa: E731
    p15 = lambda: pose_graph._chi2_and_normal_ref(dg, dg.poses, True)  # noqa: E731
    (c1, h1, b1), (c2, h2, b2) = k15(), p15()
    # the judge is the plain version in float64: residuals are centimetres
    # left from ~50 m coordinates, so float32 rounding alone moves b by
    # ~3e-5 of its scale. The kernel's error may be twice the float32 plain
    # version's, plus 1e-6 of the scale (its own order of the sums)
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
    c3, h3, b3 = k15()
    if not (torch.equal(c3, c1) and torch.equal(h3, h1) and torch.equal(b3, b1)):
        raise AssertionError("_chi2_and_normal: a second call on the same graph gave other bits (its sums have a "
                             "fixed order)")
    log(f"  _chi2_and_normal: {n_edges} edges, H {n} x {n}; errors against the float64 plain version: chi2 "
        f"{ec:.3g} (float32 plain {plain_e[0]:.3g}, tol {tols[0]:.3g}), H {eh:.3g} ({plain_e[1]:.3g}, tol "
        f"{tols[1]:.3g}), b {eb:.3g} ({plain_e[2]:.3g}, tol {tols[2]:.3g}); scales {scale}; a second call "
        f"bit-identical")
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


def check_graph_input_kernels(torch, scans, gt, dev):
    """Phase 2g: the raw window group K2r at the flagship raw group (scans
    0-15 of the circle, 16 x 131072 raw lanes, moved into scan 0's frame,
    the distance band, 0.1 m centroids into 131072 lanes), kernel 15 on a
    graph with every factor the sensors bring (phase 2c's 64 keyframes and
    128 edges, GPS / IMU orientation / gravity priors on each, a fixed floor
    plane and an SE3-plane edge from each keyframe), and floor detection K16
    on a filtered KITTI-density scan."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.graph import pose_graph
    from lv_slam_tpu_torch.ops import floor, prefilter
    from lv_slam_tpu_torch.pipeline import window

    pf = kitti_flagship_config().prefilter
    res, kf_cap = pf.downsample_resolution, 131072
    records = {}
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)

    # K2r: one C call (no synchronizing call, no device work but its own),
    # bit for bit its twin run on a CPU copy, here and on `raw_window_cases`
    raw = [PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev) for i in range(16)]
    group = (torch.stack([c.xyz for c in raw]), torch.stack([c.intensity for c in raw]),
             torch.stack([c.mask for c in raw]), 0, torch.from_numpy(rel[:16].copy()).to(dev),
             torch.ones(16, dtype=torch.bool, device=dev), pf.distance_near_thresh, pf.distance_far_thresh, res,
             kf_cap)
    k2r = lambda: window.window_group(*group)  # noqa: E731
    p2r = lambda: window.window_group_ref(*group)  # noqa: E731
    n_launches = one_call(torch, "window_group_fn", k2r)
    got = on_cpu(k2r())
    want = window.window_group_ref(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in group])
    if not identical_clouds(torch, got, want):
        raise AssertionError(f"window_group_fn: {int(got.mask.sum())} voxels against the CPU twin's "
                             f"{int(want.mask.sum())}, not bit-identical")
    n_cases = check_raw_window_cases(torch, dev)
    n_in = int(group[2].sum())
    log(f"  window_group_fn: 16 x {pf.raw_cap} raw lanes, {n_in} valid -> {int(got.mask.sum())} voxels in "
        f"{got.cap} lanes, bit for bit the CPU twin's; one C call of {n_launches} launches of its own, no other "
        f"device work, no synchronizing call; the {n_cases} raw_window_cases bit for bit too")
    # what this group's data needs: each valid point read once (12 + 4 bytes),
    # one mask byte per lane, the poses, each output lane written once (17
    # bytes); ~30 operations per valid point
    measure(torch, records, "window_group_fn", k2r, p2r, 0.0,
            16 * n_in + nbytes(group[2], group[4], group[5]) + 17 * got.cap, 30 * n_in)

    # K15 with the sensor factors, against the float64 plain version as in 2c
    g, n_edges = backend_graph(torch, rel, sensors=True)
    dg = pose_graph.to_device(g, dev)
    k15 = lambda: pose_graph._chi2_and_normal(dg, dg.poses, True)  # noqa: E731
    p15 = lambda: pose_graph._chi2_and_normal_ref(dg, dg.poses, True)  # noqa: E731
    (c1, h1, b1), (c2, h2, b2) = k15(), p15()
    float_fields = ("poses", "e_meas", "e_info", "e_huber", "p_meas", "p_info", "p_huber", "planes", "sp_meas",
                    "sp_info", "sp_huber", "q_meas", "q_info", "q_huber")
    dg64 = dg._replace(**{f: getattr(dg, f).double() for f in float_fields})
    c64, h64, b64 = pose_graph._chi2_and_normal_ref(dg64, dg64.poses, True)

    def errs(c, hh, bb):
        return (abs(float(c) - float(c64)), float((hh.double() - h64).abs().max()),
                float((bb.double() - b64).abs().max()))

    got_e, plain_e = errs(c1, h1, b1), errs(c2, h2, b2)
    scale = (abs(float(c64)), float(h64.abs().max()), float(b64.abs().max()))
    tols = [2 * p + 1e-6 * sc for p, sc in zip(plain_e, scale)]
    if any(g_ > t_ for g_, t_ in zip(got_e, tols)):
        raise AssertionError(f"_chi2_and_normal (priors, planes): errors vs float64 (chi2, H, b) {got_e}, "
                             f"tolerances {tols}")
    n_p, n_s = int(dg.p_valid.sum()), int(dg.sp_valid.sum())
    log(f"  _chi2_and_normal with {n_edges} edges, {n_p} priors, {n_s} SE3-plane edges and a fixed floor plane, H "
        f"{h1.shape[0]} x {h1.shape[0]}; errors against the float64 plain version: chi2 {got_e[0]:.3g} (float32 "
        f"plain {plain_e[0]:.3g}, tol {tols[0]:.3g}), H {got_e[1]:.3g} ({plain_e[1]:.3g}, tol {tols[1]:.3g}), b "
        f"{got_e[2]:.3g} ({plain_e[2]:.3g}, tol {tols[2]:.3g})")
    sensors_ms, sensors_wrapper_ms, _ = device_ms(torch, k15, DEVICE_FUNCTIONS["_chi2_and_normal"])
    _, sensors_plain_ms, _ = device_ms(torch, p15)
    # each family's valid rows read once (the share of its arrays they fill),
    # H and b written once
    valid_of = dict(e_=dg.e_valid, p_=dg.p_valid, sp_=dg.sp_valid, q_=dg.q_valid, plane=dg.plane_valid)
    read = sum(a.numel() * a.element_size() * float(valid.float().mean())
               for name, a in dg._asdict().items()
               for valid in [next((v for k, v in valid_of.items() if name.startswith(k)), dg.node_valid)])
    sensors_bound, sensors_by = bound(read + nbytes(h1, b1), 3000 * n_edges + 2500 * n_p + 4000 * n_s)
    log(f"    _chi2_and_normal (all families): kernel {sensors_ms:.4f} ms (wrapper {sensors_wrapper_ms:.4f} ms), "
        f"plain {sensors_plain_ms:.4f} ms, bound {sensors_bound:.5f} ms ({sensors_by})")
    records["_chi2_and_normal_sensors"] = dict(
        max_abs_err=max(got_e[1:]), ms=sensors_ms, plain_ms=sensors_plain_ms, bound_ms=sensors_bound,
        bound_by=sensors_by, library_ms=None, wrapper_device_ms=sensors_wrapper_ms)

    # K16: the filtered scan 0 (distance band, 0.1 m centroids)
    band = prefilter.distance_filter(PointCloud.from_numpy(scans[0], cap=pf.raw_cap, device=dev),
                                     pf.distance_near_thresh, pf.distance_far_thresh)
    cloud = prefilter.voxel_downsample(band, res, pf.out_cap)
    k16 = lambda: floor.detect_floor(cloud)  # noqa: E731
    p16 = lambda: floor.detect_floor_ref(cloud)  # noqa: E731
    got, want = k16(), p16()
    err = floor_agrees(torch, "scan 0", got, want, expect_found=True)
    n_pts = int(cloud.mask.sum())
    # the z band `detect_floor_ref` tests (the default sensor height and clip)
    n_band = int((cloud.mask & ((cloud.xyz[:, 2] + 1.73).abs() < 1.0)).sum())
    log(f"  detect_floor: {n_pts} filtered points in {cloud.cap} lanes ({n_band} in the z band), 256 hypotheses: "
        f"found, best {int(got.best)}, "
        f"{int(got.n_inliers)} inliers (equal to the plain version), coeffs {got.coeffs.tolist()} (bits "
        f"{floor_bits(torch, got.coeffs)}) within {err:.3g} (tol 1e-5)"
        + (", bit for bit the parent kernel's" if "scan 0" in FLOOR_PARENT_COEFFS else ""))
    # what this scan needs: each valid point read once (12 bytes), one mask
    # byte per lane; 7 operations per band point and hypothesis
    measure(torch, records, "detect_floor", k16, p16, err, 12 * n_pts + cloud.cap, 7 * 256 * n_band)
    check_floor_cases(torch, dev)
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


MATCH_CAPS = (1, 7, 300, 512, 1000)  # K12b's edge cases: below, at and past the cluster's 8 slices
MATCH_KS = (1, 8, 32)  # one candidate (`match_score`), phase 2d's batch, the loop detector's padding


def _flipped(rng, rows: np.ndarray, n_flips: np.ndarray) -> np.ndarray:
    """`rows` (n, 32) uint8 with n_flips[r] distinct bits of row r flipped."""
    ranks = np.argsort(np.argsort(rng.random((rows.shape[0], 256)), axis=1), axis=1)
    return rows ^ np.packbits(ranks < n_flips[:, None], axis=1)


def _with_copies(rng, rows: np.ndarray, share: float) -> np.ndarray:
    """`rows` with a `share` of them overwritten by copies of others: argmin ties."""
    rows = rows.copy()
    dst = np.flatnonzero(rng.random(rows.shape[0]) < share)
    rows[dst] = rows[rng.integers(0, rows.shape[0], dst.size)]
    return rows


def match_cases(seed: int = SEED):
    """K12b's edge cases as numpy arrays: (name, a (cap, 32) uint8, a_mask
    (cap,), bs (k, cap, 32), b_masks (k, cap), max_dist). For each cap and k:
    a query with copied rows (ties in the column argmins) under a mask with
    holes; each candidate the query's rows shuffled with 0-80 bits flipped
    (exactly 64 and 65 among them: a pair at max_dist and one past it), a
    fifth random, a tenth copies (ties in the row argmins), under its own
    mask with holes; candidate 1 all masked. Then an all-masked query, the
    loop detector's prefix masks, four distinct descriptors in all, a
    max_dist of 1e9, at which masked pairs count, and a cap of 4096 (past
    the first kernel's shared memory)."""
    rng = np.random.default_rng(seed)

    def candidates(a, k, keep=0.75):
        cap = a.shape[0]
        bs = np.empty((k, cap, 32), np.uint8)
        for c in range(k):
            flips = rng.integers(0, 81, cap)
            flips[:2] = (64, 65)[:cap]
            b = _flipped(rng, a[rng.permutation(cap)], flips)
            rand = rng.random(cap) < 0.2
            b[rand] = rng.integers(0, 256, (int(rand.sum()), 32), dtype=np.uint8)
            bs[c] = _with_copies(rng, b, 0.1)
        b_masks = rng.random((k, cap)) < keep
        if k > 1:
            b_masks[1] = False
        return bs, b_masks

    out = []
    for cap in MATCH_CAPS:
        for k in MATCH_KS:
            a = _with_copies(rng, rng.integers(0, 256, (cap, 32), dtype=np.uint8), 0.1)
            out.append((f"cap {cap}, k {k}", a, rng.random(cap) < 0.8, *candidates(a, k), 64.0))
    a = rng.integers(0, 256, (512, 32), dtype=np.uint8)
    out.append(("all-masked query", a, np.zeros(512, bool), *candidates(a, 8), 64.0))
    bs, _ = candidates(a, 8)
    prefix = np.arange(512)[None, :] < np.array([348, 0, 512, 1, 300, 348, 511, 7])[:, None]
    out.append(("prefix masks", a, np.arange(512) < 348, bs, prefix, 64.0))
    protos = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    a = protos[rng.integers(0, 4, 300)]
    bs = protos[rng.integers(0, 4, (8, 300))]
    out.append(("four distinct descriptors", a, rng.random(300) < 0.8, bs, rng.random((8, 300)) < 0.8, 64.0))
    a = rng.integers(0, 256, (7, 32), dtype=np.uint8)
    a_mask = np.array([True, False, True, True, False, True, True])
    out.append(("max_dist 1e9", a, a_mask, *candidates(a, 8), 1e9))
    a = rng.integers(0, 256, (4096, 32), dtype=np.uint8)
    out.append(("cap 4096, k 2", a, rng.random(4096) < 0.8, *candidates(a, 2), 64.0))
    return out


def check_match_cases(torch, dev):
    """K12b against its plain version on the card, bit for bit, on every
    case of `match_cases`, one launch each; returns the number of cases."""
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import orb

    cases = match_cases()
    for name, *arrays, max_dist in cases:
        a, a_mask, bs, b_masks = (torch.from_numpy(v).to(dev) for v in arrays)
        before = KERNELS["match_scores_batch"].launches
        got = orb.match_scores_masked(a, a_mask, bs, b_masks, max_dist)
        want = orb.match_scores_masked_ref(a, a_mask, bs, b_masks, max_dist)
        torch.cuda.synchronize()
        if KERNELS["match_scores_batch"].launches != before + 1:
            raise AssertionError(f"match_scores_batch ({name}): not one launch")
        if not torch.equal(got, want):
            raise AssertionError(f"match_scores_batch ({name}): scores {got.tolist()} differ from the plain "
                                 f"version's {want.tolist()}")
    return len(cases)


ORB_K_LEVELS = (221, 166, 124)  # OrbExtractor(512)._k_levels(128, 256), the main path's
ORB_CASE_NAMES = ("tiles (ties at the cut)", "blank image", "noise image", "plateau past the shared-memory cap",
                  "batch of 1", "batch of 32", "tiny image, k near h x w")


def _tiles(shift=(0, 0)) -> np.ndarray:
    """A constant background with one bright pixel per 8 x 8 tile: hundreds
    of corners with equal scores, so the top-K cut falls inside a tie."""
    img = np.full((128, 256), 50, np.uint8)
    img[4::8, 4::8] = 200
    return np.roll(img, shift, axis=(0, 1))


def orb_cases(seed: int = SEED):
    """Kernel 12's edge cases as numpy arrays: (name, images (B, H, W)
    uint8, k_levels), the main path's rows unless said. tests/test_torch_orb.py's
    tiles (equal scores across the cut at levels 0 and 1); a blank image (no
    kept pixel: every row by flat index); uniform noise (thousands of kept
    pixels, corners on the border); 2 x 2 bright blocks every 5 pixels of a
    256 x 256 image, each block four neighbouring corners of one score that
    suppression keeps together, ~8000 equal keys at level 0 (past the
    select's 4096 in shared memory, and 5000 rows: two rounds); a batch of 1
    (that image, 300 rows: one round past the cap) and one of 32 (64 x 128
    noise, every fourth image blank); a 33 x 35 image (h * w not a multiple
    of 32) whose levels ask for 1150 of 1155 pixels and all 272."""
    rng = np.random.default_rng(seed)
    noise = lambda n, h=128, w=256: rng.integers(0, 256, (n, h, w)).astype(np.uint8)  # noqa: E731
    tiles = np.stack([_tiles(), _tiles((3, 5))])
    out = [("tiles (ties at the cut)", tiles, ORB_K_LEVELS)]
    blank = np.full((2, 128, 256), 90, np.uint8)
    out.append(("blank image", blank, ORB_K_LEVELS))
    out.append(("noise image", noise(2), ORB_K_LEVELS))
    plateau = np.full((2, 256, 256), 50, np.uint8)
    for i, (dy, dx) in enumerate(((0, 0), (2, 3))):
        for oy in (0, 1):
            for ox in (0, 1):
                plateau[i, dy + oy::5, dx + ox::5] = 200
    out.append(("plateau past the shared-memory cap", plateau, (5000, 1200, 300)))
    out.append(("batch of 1", plateau[1:], (300, 1200, 300)))
    many = noise(32, 64, 128)
    many[::4] = 90
    out.append(("batch of 32", many, ORB_K_LEVELS))
    out.append(("tiny image, k near h x w", noise(2, 33, 35), (1150, 272)))
    assert tuple(name for name, *_ in out) == ORB_CASE_NAMES
    return out


def check_orb_cases(torch, dev):
    """K12 (`detect_pyramid_batch`) on every case of `orb_cases`, one launch
    and no synchronizing call each, bit for bit against its twin on the card
    and against its twin run on a CPU copy; returns the number of cases."""
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import orb

    cases = orb_cases()
    for name, images, k_levels in cases:
        card = torch.from_numpy(images).to(dev)
        before = KERNELS["_detect_pyramid_batch"].launches
        got = []
        syncs = count_syncs(torch, lambda: got.append(orb.detect_pyramid_batch(card, k_levels)))
        torch.cuda.synchronize()
        if KERNELS["_detect_pyramid_batch"].launches != before + 1 or syncs:
            raise AssertionError(f"_detect_pyramid_batch ({name}): {KERNELS['_detect_pyramid_batch'].launches - before} "
                                 f"launches, {syncs} synchronizing calls")
        for where, want in (("on the card", orb.detect_pyramid_batch_ref(card, k_levels).cpu()),
                            ("run on a CPU copy", orb.detect_pyramid_batch_ref(torch.from_numpy(images), k_levels))):
            rows = (got[0].cpu() != want).any(dim=2)
            if bool(rows.any()):
                raise AssertionError(f"_detect_pyramid_batch ({name}): {int(rows.sum())} of {rows.numel()} rows differ "
                                     f"from the plain version {where}")
    return len(cases)


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
    syncs = count_syncs(torch, k12)
    glue, n_launches = foreign_functions(torch, k12, DEVICE_FUNCTIONS["_detect_pyramid_batch"])
    if syncs or glue:
        raise AssertionError(f"_detect_pyramid_batch: {syncs} synchronizing calls, device work besides its own: "
                             f"{glue}")
    n_cases = check_orb_cases(torch, dev)
    log(f"  _detect_pyramid_batch: {n_launches} launches of its own, no other device work (no torch.topk), no "
        f"synchronizing call; the {n_cases} orb_cases bit-identical to the plain version on the card and on a CPU "
        f"copy, one launch each")
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
    # the glue the kernel's own selection replaced: torch.topk of the twin's int64 keys, level by level
    img, level_keys = images.float(), []
    for k in k_levels:
        level_keys.append((orb._keys(orb._fast_scores(img, 20.0)), k))
        img = orb._halve(img)
    _, topk_ms, _ = device_ms(torch, lambda: [torch.topk(keys, k, dim=1) for keys, k in level_keys])
    records["_detect_pyramid_batch"]["torch_topk_ms"] = topk_ms
    log(f"    torch.topk of the twin's int64 keys alone, one call a level: {topk_ms:.4f} ms device-only")

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
    n_cases = check_match_cases(torch, dev)
    log(f"  match_scores_batch: {n_cases} edge cases (caps {MATCH_CAPS} x k {MATCH_KS} with holes, copies and pairs "
        f"at max_dist; an all-masked query and candidates, prefix masks, four distinct descriptors, max_dist "
        f"1e9, cap 4096) identical to the plain version, one launch each")
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


# ----------------------------------------------------------------- K9k's and K16's edge cases

KNN_CELL = 2.0  # standalone LFA's grid cell (lfa/fused._GRID_CELL)
KNN_CASE_KS = (1, 8)  # the knn entry's k on every case (the lines' 2 and the planes' 3 besides)
KNN_THREAD_QUERIES = 16384  # csrc/knn_grid.cu kThreadQueries: from this batch on, a thread a query
KNN_CASE_NAMES = ("points mirrored about a query", "duplicated points", "a cell holding more than 8 points",
                  "the extent's first and last cells", "masked tail rows", "empty grid",
                  "sampled search (22000 lanes)", "the gates at d0^2 = 25 and norm = 1e-3",
                  "16384 queries, a thread each", "16384 queries on the sampled grid",
                  "131072 lanes, masked and out-of-extent lanes among valid ones", "three fields of 16 bits",
                  "a span past 2^31 cells")
GRID_SORT_LANES = 1 << 17  # K9g's largest knn_cases grid: GICP's lane count, the key sort's route


def _five_metres_off(p: np.ndarray) -> np.ndarray:
    """A query whose squared distance to `p`, as the kernels round it (an fma
    chain; ops.linalg3.dot3_fma), gives a nearest distance d0 with d0 * d0
    exactly 25 in float32: p + (3, 3.2, 2.4), its last digits searched."""
    p = p.astype(np.float32)
    base = (p + np.array([3.0, 3.2, 2.4], np.float32)).astype(np.float32)
    for dy in range(-8, 9):
        for dz in range(-8, 9):
            q = base.copy()
            q[1] = np.float32(q[1] + np.float32(dy) * np.spacing(q[1]))
            q[2] = np.float32(q[2] + np.float32(dz) * np.spacing(q[2]))
            d = (q - p).astype(np.float32)
            inner = np.float32(d[0] * d[0])
            inner = np.float32(np.float64(d[1]) * np.float64(d[1]) + np.float64(inner))
            d2 = np.float32(np.float64(d[2]) * np.float64(d[2]) + np.float64(inner))
            d0 = np.float32(np.sqrt(d2, dtype=np.float32))
            if np.float32(d0 * d0) == np.float32(25.0):
                return q
    raise AssertionError("no query 5 m off")


def knn_cases(seed: int = SEED):
    """Kernel 9k's edge cases as numpy arrays: (name, grid points (n, 3),
    grid mask (n,), queries (q, 3), query mask (q,)) on the 2 m grid. Each
    case runs the knn entry at every k of KNN_CASE_KS and the lines and
    planes entries. Exact 1/64 m coordinates mirrored about each query
    (equal squared distances: ties to the lower candidate index); each point
    three times; 40 points in one cell (its slots overflow) beside one point
    alone in the highest cell (its run ends at the last row, whose clamped
    slots repeat it); cells at 0, 1, 1022 and 1023 of the 1024 extent on
    each axis and at 1024 (out of it), queried in and around them; 100
    masked rows after 300 (INT32_MAX keys at the tail), with queries out of
    the extent and at the sentinel; every lane masked; 20000 points and 2000
    masked rows (past 8192 keys the search bisects a sample of the keys,
    then the keys themselves); the gates: a nearest point exactly 5 m off
    (d0 * d0 = 25, not below it) and 2 mm further in, two points 1 mm apart
    (the line's norm 1e-3, not above it) and a third 1 m off square to them
    (the plane's cross product 1e-3 long); and batches of 16384 queries,
    which take a thread a query, on a 6000-lane grid and a 22000-lane one
    (sampled), masked lanes among the rows. Then K9g's build: 131072 lanes
    (its key sort's route, many tiles), a third masked among the valid ones
    and 4000 valid lanes past the 2 km extent, whose INT32_MAX tail keeps
    lane order, with 320 queries; cells spanning exactly 64 x 32 x 32 (the
    packed key's three fields 6 + 5 + 5 = 16 bits: two digit passes, the
    edge of the pass count); and lanes 3e9 m either side of 0 (cells
    1.5e9 either side of the origin's: a span past 2^31 - 1 cells, whose
    offset wraps negative in int32 and leaves the extent as in int64)."""
    rng = np.random.default_rng(seed)
    out = []

    q = rng.integers(64, 18 * 64, (16, 3)) / 64.0
    v = rng.integers(-90, 91, (16, 4, 3)) / 64.0
    pts = np.concatenate([(q[:, None] + v).reshape(-1, 3), (q[:, None] - v).reshape(-1, 3),
                          rng.integers(0, 20 * 64, (200, 3)) / 64.0])
    out.append((pts, np.ones(len(pts), bool), q))

    base = rng.uniform(0.0, 16.0, (60, 3))
    pts = np.concatenate([base, base[::-1], base])
    out.append((pts, np.ones(len(pts), bool), np.concatenate([base[:20], base[20:] + rng.normal(0, 0.3, (40, 3))])))

    crowd = (np.array([3, 3, 3]) + rng.uniform(0.05, 0.95, (40, 3))) * KNN_CELL
    lone = (np.array([[9, 9, 9]]) + 0.5) * KNN_CELL
    pts = np.concatenate([crowd, rng.uniform(0.0, 16.0, (100, 3)), lone])
    near = np.concatenate([(np.array([3, 3, 3]) + rng.integers(-1, 2, (12, 3)) + rng.uniform(0.1, 0.9, (12, 3))),
                           (np.array([9, 9, 9]) + rng.integers(-1, 2, (6, 3)) + rng.uniform(0.1, 0.9, (6, 3)))])
    out.append((pts, np.ones(len(pts), bool), np.concatenate([near * KNN_CELL, lone, rng.uniform(0, 16, (10, 3))])))

    edges, around = _extent_edges(rng, 400, KNN_CELL)
    out.append((edges, np.ones(len(edges), bool), around[:120]))

    pts = rng.uniform(0.0, 30.0, (400, 3))
    mask = np.arange(400) < 300
    far = np.array([[5000.0, 0.0, 0.0], [SENTINEL_XYZ] * 3, [-3000.0, 10.0, 10.0]])
    out.append((pts, mask, np.concatenate([rng.uniform(0.0, 30.0, (50, 3)), far])))

    pts = rng.uniform(0.0, 30.0, (64, 3))
    out.append((pts, np.zeros(64, bool), rng.uniform(0.0, 30.0, (20, 3))))

    pts = np.concatenate([_blobs(rng, 20000, 60.0, spread=1.5), rng.uniform(0.0, 60.0, (2000, 3))])
    mask = np.arange(len(pts)) < 20000
    out.append((pts, mask, np.concatenate([pts[rng.choice(20000, 250, replace=False)] + rng.normal(0, 0.5, (250, 3)),
                                           rng.uniform(-5.0, 65.0, (50, 3))])))

    p3 = np.array([10.0, 10.0, 10.0], np.float32)
    q5 = _five_metres_off(p3)
    pts = np.array([[0.0, 0.0, 0.0], [0.001, 0.0, 0.0], [0.0, 1.0, 0.0], p3, [15.99, 15.99, 15.99],
                    [15.99, 10.0, 15.99], [40.0, 40.0, 40.0]], np.float32)  # the last keeps the others' slots unclamped
    inside = (q5 - np.float32(0.002) * (q5 - p3) / np.float32(5.0)).astype(np.float32)
    queries = np.array([q5, inside, [0.0005, 0.0, 0.0], [0.0, 0.0001, 0.0]], np.float32)
    out.append((pts, np.ones(len(pts), bool), queries))

    # a batch of KNN_THREAD_QUERIES queries takes a thread a query: near
    # points, far off and at the sentinel; on a grid staged whole, then a
    # sampled one
    for n_grid in (6000, 22000):
        pts = np.concatenate([_blobs(rng, n_grid - 500, 40.0, spread=1.0), rng.uniform(-40.0, 40.0, (500, 3))])
        mask = rng.random(n_grid) >= 0.05
        near = pts[rng.choice(n_grid, KNN_THREAD_QUERIES - 1000)] + rng.normal(0, 0.4, (KNN_THREAD_QUERIES - 1000, 3))
        out.append((pts, mask, np.concatenate([near, rng.uniform(-45.0, 45.0, (900, 3)),
                                               np.full((100, 3), SENTINEL_XYZ)])))

    # K9g's edge cases: the key sort's route with a tail among the tiles, the
    # pass count's edge, a span past 2^31 cells
    n = GRID_SORT_LANES
    pts = np.concatenate([_blobs(rng, n - 14000, 60.0, spread=1.5), rng.uniform(-60.0, 60.0, (10000, 3)),
                          rng.uniform(0.0, 60.0, (4000, 3)) + np.array([2100.0, 0.0, 0.0])])
    order = rng.permutation(n)
    pts, past = pts[order], order >= n - 4000
    mask = (rng.random(n) >= 0.33) | past  # the lanes past the extent stay valid
    mask[rng.choice(np.flatnonzero(past), 200, replace=False)] = False
    pts[~mask & (rng.random(n) < 0.5)] = SENTINEL_XYZ
    near = pts[rng.choice(np.flatnonzero(mask & ~past), 280, replace=False)] + rng.normal(0, 0.5, (280, 3))
    out.append((pts, mask, np.concatenate([near, pts[np.flatnonzero(past)[:20]], rng.uniform(-70.0, 70.0, (20, 3))])))

    cells = np.concatenate([rng.integers(0, [64, 32, 32], (1900, 3)), [[0, 0, 0], [63, 31, 31]]])
    pts = (cells + rng.uniform(0.05, 0.95, cells.shape)) * KNN_CELL + np.array([-40.0, 10.0, -30.0])
    out.append((pts, np.ones(len(pts), bool), pts[rng.choice(len(pts), 150, replace=False)] +
                rng.normal(0, 0.6, (150, 3))))

    wide = np.concatenate([np.c_[np.full(60, -3.0e9), rng.uniform(0.0, 40.0, (60, 2))],
                           np.c_[np.full(60, 3.0e9), rng.uniform(0.0, 40.0, (60, 2))]])[rng.permutation(120)]
    out.append((wide, np.ones(120, bool), np.c_[np.full(40, -3.0e9), rng.uniform(-2.0, 42.0, (40, 2))]))

    cases = []
    for name, (pts, mask, queries) in zip(KNN_CASE_NAMES, out):
        queries = np.asarray(queries, np.float32)
        qmask = np.ones(len(queries), bool)
        qmask[6::7] = False  # the lines' and planes' query mask gates too
        cases.append((name, np.asarray(pts, np.float32), mask, queries, qmask))
    return cases


def knn_case_inputs(torch, pts, mask, queries, qmask, dev) -> tuple:
    """One `knn_cases` entry's arrays as tensors on `dev`."""
    return tuple(torch.from_numpy(a).to(dev) for a in (pts, mask, queries, qmask))


def knn_case_outputs(torch, inputs, plain: bool):
    """(grid, [knn at each k of KNN_CASE_KS], lines, planes) of one
    `knn_cases` entry's `knn_case_inputs`, by the kernels or (`plain`) their
    twins."""
    from lv_slam_tpu_torch.lfa import registration
    from lv_slam_tpu_torch.ops import knn

    x, m, y, ym = inputs
    build = knn.build_grid_ref if plain else knn.build_grid
    grid = build(x, m, KNN_CELL)
    if plain:
        return (grid, [knn.knn_ref(grid, y, k) for k in KNN_CASE_KS], registration.lines_from_2nn_ref(y, ym, grid),
                registration.planes_from_3nn_ref(y, ym, grid))
    return (grid, [knn.knn(grid, y, k) for k in KNN_CASE_KS], registration.lines_from_2nn(y, ym, grid),
            registration.planes_from_3nn(y, ym, grid))


def knn_flat(torch, outputs) -> list:
    """The tensors of `knn_case_outputs`, in one list, floats as their bits."""
    grid, nns, lines, planes = outputs
    flat = [grid.keys, grid.xyz, grid.origin_cell, *(t for nn in nns for t in nn), *lines, *planes]
    return [t.cpu().view(torch.int32) if t.dtype == torch.float32 else t.cpu() for t in flat]


def check_knn_cases(torch, dev):
    """K9k's three entries (and the grid K9g builds for them) on every
    `knn_cases` entry, each call one launch with no synchronizing call,
    bit for bit against the twins on the card and run on a CPU copy.
    Returns the number of cases."""
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.lfa import registration
    from lv_slam_tpu_torch.ops import knn

    cases = knn_cases()
    for name, *arrays in cases:
        card, cpu = knn_case_inputs(torch, *arrays, dev), knn_case_inputs(torch, *arrays, "cpu")
        grid = knn.build_grid(*card[:2], KNN_CELL)
        y, ym = card[2:]
        calls = [lambda k=k: knn.knn(grid, y, k) for k in KNN_CASE_KS]
        calls += [lambda: registration.lines_from_2nn(y, ym, grid), lambda: registration.planes_from_3nn(y, ym, grid)]
        for call in calls:
            before = KERNELS["knn"].launches
            syncs = count_syncs(torch, call)
            torch.cuda.synchronize()
            if KERNELS["knn"].launches != before + 1 or syncs:
                raise AssertionError(f"knn ({name}): {KERNELS['knn'].launches - before} launches a call, {syncs} "
                                     f"synchronizing calls")
        got = knn_flat(torch, knn_case_outputs(torch, card, False))
        for where, want in (("on the card", knn_case_outputs(torch, card, True)),
                            ("on the CPU", knn_case_outputs(torch, cpu, True))):
            bad = [i for i, (a, b) in enumerate(zip(got, knn_flat(torch, want))) if not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"knn ({name}): outputs {bad} differ from the twins {where}")
    log(f"  knn_cases: {len(cases)} cases, knn at k = {KNN_CASE_KS}, lines_from_2nn and planes_from_3nn, each one "
        f"launch and no synchronizing call, bit for bit the twins on the card and on the CPU")
    return len(cases)


# ----------------------------------------------------------------- K9c's edge cases

TABLE_CASE_NAMES = ("every row masked", "40 rows in one cell", "hash collisions, 256 buckets (one pass)",
                    "5001 rows (not a multiple of 1024), 1024 buckets", "65536 rows, 2^15 buckets",
                    "100000 rows, 2^18 buckets (three passes)")


def table_cases(seed: int = SEED):
    """Kernel 9c's edge cases as numpy arrays: (name, points (n, 3), mask
    (n,), n_buckets, slots) on the 2 m cells. Every row masked; 40 rows in
    one cell among 2000 others (its bucket overflows its 6 slots, and input
    order decides which stay); 20000 rows in 256 buckets, 8 slots (every
    bucket shared by many cells and overflowing; one digit pass); 5001 rows
    into 1024 buckets (a tile of the sort cut short); the surf map's 2^15 x 6
    at 65536 rows, a third masked among them; 100000 rows into 2^18 buckets
    (the flagship's largest table: three digit passes)."""
    rng = np.random.default_rng(seed)
    scene = lambda n: rng.uniform(-80.0, 80.0, (n, 3))  # noqa: E731
    crowd = (np.array([3, -2, 1]) + rng.uniform(0.05, 0.95, (40, 3))) * KNN_CELL
    rows = np.concatenate([scene(2000), crowd])[rng.permutation(2040)]
    out = [(scene(5000), np.zeros(5000, bool), 1024, 6), (rows, np.ones(2040, bool), 4096, 6),
           (_blobs(rng, 20000, 60.0, spread=1.0), rng.random(20000) >= 0.1, 256, 8),
           (scene(5001), rng.random(5001) >= 0.2, 1024, 6),
           (_blobs(rng, 65536, 70.0, spread=1.5), rng.random(65536) >= 0.33, 1 << 15, 6),
           (scene(100000), rng.random(100000) >= 0.2, 1 << 18, 6)]
    return [(name, np.asarray(p, np.float32), m, b, s) for name, (p, m, b, s) in zip(TABLE_CASE_NAMES, out)]


def check_table_cases(torch, dev):
    """K9c (`build_cell_table`) on every `table_cases` entry, one launch and
    no synchronizing call each, the table bit for bit its twin's on the card
    and run on a CPU copy. Returns the number of cases."""
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import knn

    cases = table_cases()
    for name, pts, mask, n_buckets, slots in cases:
        x, m = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
        before = KERNELS["build_cell_table"].launches
        got = []
        syncs = count_syncs(torch, lambda: got.append(knn.build_cell_table(x, m, KNN_CELL, n_buckets, slots)))
        torch.cuda.synchronize()
        if KERNELS["build_cell_table"].launches != before + 1 or syncs:
            raise AssertionError(f"build_cell_table ({name}): {KERNELS['build_cell_table'].launches - before} "
                                 f"launches, {syncs} synchronizing calls")
        table = got[0].table.view(torch.int32)
        for where, want in (("on the card", knn.build_cell_table_ref(x, m, KNN_CELL, n_buckets, slots)),
                            ("on the CPU", knn.build_cell_table_ref(x.cpu(), m.cpu(), KNN_CELL, n_buckets, slots))):
            if not torch.equal(table.cpu(), want.table.view(torch.int32).cpu()):
                raise AssertionError(f"build_cell_table ({name}): the table differs from the twin's {where}")
    log(f"  table_cases: {len(cases)} cases, each one launch and no synchronizing call, bit for bit the twin's "
        f"table on the card and on the CPU")
    return len(cases)


FLOOR_CASE_NAMES = ("two identical best hypotheses", "no valid hypothesis", "an empty band", "one hypothesis",
                    "1024 hypotheses", "5000 lanes, masked among them", "140000 lanes, the finish in two stages")
# K16's coefficients (float32 bits, hex) of the parent tree's kernel (00aa305) on
# phase 2g's scan 0 and on `floor_cases`, as scripts/knn_floor_parent.py
# printed them on an NVIDIA H100 80GB HBM3 (700 W): the redesign keeps them
# bit for bit
FLOOR_PARENT_COEFFS = {
    "scan 0": ["b794a8ce", "37de8c16", "3f800000", "3fdd3d99"],
    "two identical best hypotheses": ["00000000", "00000000", "3f800000", "3fdd70a4"],
    "no valid hypothesis": ["3f800000", "00000000", "00000000", "c0a00000"],
    "an empty band": ["3f800000", "00000000", "00000000", "80000000"],
    "one hypothesis": ["bc23eef3", "3ba401da", "3f7ffbe7", "3fdd71ed"],
    "1024 hypotheses": ["bc234b65", "3ba367a2", "3f7ffbef", "3fdd6ee4"],
    "5000 lanes, masked among them": ["bc24ee90", "3ba4100e", "3f7ffbdc", "3fdd753f"],
    "140000 lanes, the finish in two stages": ["bc23e05e", "3ba3b41a", "3f7ffbe7", "3fdd6cdc"],
}


def _floor_scene(rng, n_floor: int, n_clutter: int, noise: float) -> np.ndarray:
    """A floor 1.73 m below the sensor, tilted a little, with `noise`, and clutter above it."""
    xy = rng.uniform(-20.0, 20.0, (n_floor, 2))
    z = -1.73 + 0.01 * xy[:, 0] - 0.005 * xy[:, 1] + rng.normal(0.0, noise, n_floor)
    clutter = np.c_[rng.uniform(-20.0, 20.0, (n_clutter, 2)), rng.uniform(-1.2, 3.0, n_clutter)]
    return np.concatenate([np.c_[xy, z], clutter])


def floor_cases(seed: int = SEED):
    """Kernel 16's edge cases as numpy arrays: (name, points (n, 3), mask
    (n,), n_hypotheses). A floor exactly flat at z = -1.73 (every floor
    hypothesis counts every floor point: the best count is many
    hypotheses', and the first wins); walls only inside the z band (every
    hypothesis fails the normal gate: found is false); every point above
    the band; one hypothesis on a noisy floor, 1024 on one with clutter; 5000
    lanes (not a multiple of 32 or 1024) with a fifth of them masked among
    the others; 140000 lanes in random order, a tenth of them masked (past
    the 131072 lanes that the finish stages at once: it stages them twice)."""
    rng = np.random.default_rng(seed)
    flat = np.c_[rng.uniform(-20.0, 20.0, (6000, 2)), np.full(6000, -1.73)]
    flat = np.concatenate([flat, np.c_[rng.uniform(-20.0, 20.0, (2192, 2)), rng.uniform(0.5, 3.0, 2192)]])
    wall = np.c_[np.full(4000, 5.0), rng.uniform(-20.0, 20.0, 4000), rng.uniform(-2.6, -0.9, 4000)]
    wall = np.concatenate([wall, np.c_[rng.uniform(-20.0, 20.0, (96, 2)), rng.uniform(1.0, 3.0, 96)]])
    above = np.c_[rng.uniform(-20.0, 20.0, (4096, 2)), rng.uniform(1.0, 5.0, 4096)]
    scene = _floor_scene(rng, 6000, 2192, 0.02)
    bare = _floor_scene(rng, 8192, 0, 0.02)  # the one hypothesis's triple lies on the floor
    ragged = _floor_scene(rng, 3500, 1500, 0.02)
    out = [(flat, np.ones(len(flat), bool), 256), (wall, np.ones(len(wall), bool), 256),
           (above, np.ones(len(above), bool), 256), (bare, np.ones(len(bare), bool), 1),
           (scene, np.ones(len(scene), bool), 1024), (ragged, rng.random(len(ragged)) >= 0.2, 256)]
    wide = _floor_scene(rng, 100000, 40000, 0.02)[rng.permutation(140000)]
    out.append((wide, rng.random(len(wide)) >= 0.1, 256))
    return [(name, np.asarray(p, np.float32), m, h) for name, (p, m, h) in zip(FLOOR_CASE_NAMES, out)]


def check_floor_cases(torch, dev):
    """K16 on every `floor_cases` entry, one launch and no synchronizing
    call each: found, the best index and its inlier count identical to the
    twin run on a CPU copy, the coefficients within 1e-5 of it and bit for
    bit the parent tree's (`FLOOR_PARENT_COEFFS`). Returns the number of
    cases."""
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import floor

    cases = floor_cases()
    missing = [name for name, *_ in cases if name not in FLOOR_PARENT_COEFFS]
    if missing:
        raise AssertionError(f"floor_cases {missing}: no parent coefficients to hold them to")
    for name, pts, mask, n_hyp in cases:
        cpu = PointCloud(torch.from_numpy(pts), torch.zeros(len(pts)), torch.from_numpy(mask))
        card = PointCloud(cpu.xyz.to(dev), cpu.intensity.to(dev), cpu.mask.to(dev))
        floor.detect_floor(card, n_hypotheses=n_hyp)  # uploads the case's triples once
        torch.cuda.synchronize()
        before = KERNELS["detect_floor"].launches
        got = []
        syncs = count_syncs(torch, lambda: got.append(floor.detect_floor(card, n_hypotheses=n_hyp)))
        torch.cuda.synchronize()
        if KERNELS["detect_floor"].launches != before + 1 or syncs:
            raise AssertionError(f"detect_floor ({name}): {KERNELS['detect_floor'].launches - before} launches, "
                                 f"{syncs} synchronizing calls (the triples uploaded before)")
        floor_agrees(torch, name, got[0], floor.detect_floor_ref(cpu, n_hypotheses=n_hyp))
    log(f"  floor_cases: {len(cases)} cases, each one launch and no synchronizing call; found, best and inliers "
        f"identical to the CPU twin, coeffs within 1e-5 of it and bit for bit the parent kernel's")
    return len(cases)


def floor_bits(torch, coeffs) -> list:
    """The coefficients' float32 bits as hex strings."""
    return [f"{int(b) & 0xFFFFFFFF:08x}" for b in coeffs.detach().cpu().contiguous().view(torch.int32).tolist()]


def floor_agrees(torch, name: str, got, want, expect_found=None) -> float:
    """K16's result `got` against the twin's `want`: found, best and the
    inlier count identical, coeffs within 1e-5, and the coeffs' bits those of
    the parent kernel where FLOOR_PARENT_COEFFS holds them. Returns the coeffs'
    largest difference."""
    same = (bool(got.found) == bool(want.found) and int(got.best) == int(want.best)
            and int(got.n_inliers) == int(want.n_inliers))
    err = float((got.coeffs.cpu() - want.coeffs.cpu()).abs().max())
    if not same or err > 1e-5 or (expect_found is not None and bool(want.found) != expect_found):
        raise AssertionError(f"detect_floor ({name}): found {bool(got.found)}/{bool(want.found)}, best "
                             f"{int(got.best)}/{int(want.best)}, inliers {int(got.n_inliers)}/{int(want.n_inliers)}, "
                             f"coeffs error {err} (tol 1e-5)")
    parent = FLOOR_PARENT_COEFFS.get(name)
    if parent is not None and floor_bits(torch, got.coeffs) != parent:
        raise AssertionError(f"detect_floor ({name}): coeffs {floor_bits(torch, got.coeffs)} are not the parent "
                             f"kernel's {parent}")
    return err


def check_standalone_kernels(torch, scans, dev):
    """Phase 2e: standalone LFA's kernels vs their plain versions at the
    shapes phase 7 gives them: K9g on scan 0's less-sharp (4096 lanes) and
    less-flat (8064) features; K9k's line and plane entries with scan 1's
    sharp (768) and flat (1536) features at the scan-to-scan solve's first
    guess (the identity: scan 0 leaves no motion to warm-start from) as
    queries against those grids, and its k-NN entry on the flat ones, then
    all three on `knn_cases`; K9c on the host mapping's edge and surf
    buffers (32768 and 65536 rows) after scans 0-3 of the host pipeline."""
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
    k9g = lambda: knn.build_grid(pts, m, _GRID_CELL)  # noqa: E731
    n_launches = one_call(torch, "build_grid", k9g)
    log(f"  build_grid: {n_launches} launch(es) of its own a call, no other device work, no synchronizing call")
    measure(torch, records, "build_grid", k9g, lambda: knn.build_grid_ref(pts, m, _GRID_CELL), 0.0,
            nbytes(pts, m, grid.keys, grid.xyz, grid.origin_cell), 15 * pts.shape[0])
    # the glue the kernel's own sort replaced: torch.sort of the twin's int32 flat keys
    key9g, _ = knn._grid_keys_ref(pts, m, _GRID_CELL)
    _, sort9g_ms, _ = device_ms(torch, lambda: torch.sort(key9g, stable=True))
    records["build_grid"]["torch_sort_ms"] = sort9g_ms
    log(f"    torch.sort(stable=True) of the twin's {key9g.numel()} int32 keys: {sort9g_ms:.4f} ms device-only")

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
    check_knn_cases(torch, dev)

    # kernel 9c: the host mapping's tables, rebuilt from its buffers each scan
    pipe = LfaPipeline(cfg, device=dev)
    for c in raw:
        pipe.process(c)
    mapping = pipe.mapping
    timings = {}
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
            f"holding {stored} ({knn.table_passes(nb)} digit passes); bit-identical to the plain version, slot for "
            f"slot")
        k9c = lambda: knn.build_cell_table(xyz, m, _GRID_CELL, nb, cfg.knn_slots)  # noqa: E731
        p9c = lambda: knn.build_cell_table_ref(xyz, m, _GRID_CELL, nb, cfg.knn_slots)  # noqa: E731
        if name == "surf":
            n_launches = one_call(torch, "build_cell_table", k9c)
            log(f"  build_cell_table: {n_launches} launches of its own a call, no other device work, no "
                f"synchronizing call")
        # bytes: the rows and mask read once, the table written once; ~20
        # operations a row (its cell, hash and digits)
        timings[name] = timed(torch, "build_cell_table", k9c, p9c, 0.0, nbytes(xyz, m, got.table), 20 * xyz.shape[0],
                              f" ({name} map, {nb} x {cfg.knn_slots})")
        # the glue the kernel's own sort replaced: torch.sort of the twin's int32 bucket keys
        key9c = knn._table_keys_ref(xyz, m, _GRID_CELL, nb)
        _, timings[name]["torch_sort_ms"], _ = device_ms(torch, lambda: torch.sort(key9c, stable=True))
        log(f"    torch.sort(stable=True) of the twin's {key9c.numel()} int32 keys: "
            f"{timings[name]['torch_sort_ms']:.4f} ms device-only")
    records["build_cell_table"] = dict(timings["surf"], edge=timings["edge"])
    check_table_cases(torch, dev)
    return records


def check_cell_knn_kernels(torch, scans, gt, dev):
    """Phase 2j: K9n (`knn_cell`, the k nearest of a cell table's 8-cell
    probe) and K10g (the line / plane fits' KnnGrid branch) vs their plain
    versions. K9n on the flagship LFA's world maps (phase 2's: scans 0-3's
    features inserted at their true poses, the edge map 2^14 x 6 and the
    surf map 2^15 x 6) with scan 4's sharp (768) and flat (1536) features at
    its true pose as queries, k = `knn_k` (5); K10g on standalone LFA's grids
    (K9g's shape: scan 3's 4096 less-sharp and 8064 less-flat features at
    its true pose) with the same queries. No path of either package calls
    them, so their launches are this phase's checks (the timed calls
    excluded). Returns (records, launches)."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.lfa import features, registration
    from lv_slam_tpu_torch.lfa.fused import _GRID_CELL, _n_buckets
    from lv_slam_tpu_torch.ops import knn
    from lv_slam_tpu_torch.ops.gicp import PLANE_ENVELOPE

    full = kitti_flagship_config()
    cfg = full.lfa
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    poses = [torch.from_numpy(p).to(dev) for p in gt_rel[:5]]
    feats = [features.extract_features(PointCloud.from_numpy(scans[i], cap=full.prefilter.raw_cap, device=dev), cfg)
             for i in range(5)]
    edge = knn.empty_cell_table(_n_buckets(cfg, cfg.map_edge_cap), cfg.knn_slots, _GRID_CELL, dev)
    surf = knn.empty_cell_table(_n_buckets(cfg, cfg.map_planar_cap), cfg.knn_slots, _GRID_CELL, dev)
    for f, pose in zip(feats[:4], poses):
        knn.insert_cell_table_(edge, se3.transform_points(pose, f.less_sharp), f.less_sharp_mask,
                               cfg.mapping_line_resolution)
        knn.insert_cell_table_(surf, se3.transform_points(pose, f.less_flat), f.less_flat_mask,
                               cfg.mapping_plane_resolution)
    f3, f4 = feats[3], feats[4]
    ye, ys = se3.transform_points(poses[4], f4.sharp), se3.transform_points(poses[4], f4.flat)
    k = cfg.knn_k
    records = {}

    reset_launches()
    for name, table, y in (("edge", edge, ye), ("surf", surf, ys)):
        got, want = knn.knn_cell(table, y, k), knn.knn_cell_ref(table, y, k)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"knn_cell: the {name} map's neighbours differ from the plain version")
        log(f"  knn_cell: {name} map {tuple(table.table.shape)}, {y.shape[0]} queries, k = {k}: "
            f"{int(got[2].sum())} of {got[2].numel()} neighbours valid; distances, points (invalid slots too) "
            f"and valid flags identical to the plain version")
    grids = {}
    for name, pts, m in (("edge", f3.less_sharp, f3.less_sharp_mask), ("surf", f3.less_flat, f3.less_flat_mask)):
        grids[name] = knn.build_grid_ref(se3.transform_points(poses[3], pts), m, _GRID_CELL)
    fits = {}
    for name, fn, ref, y, m, grid in (
        ("lines", registration.lines_from_fit, registration.lines_from_fit_ref, ye, f4.sharp_mask, grids["edge"]),
        ("planes", registration.planes_from_fit, registration.planes_from_fit_ref, ys, f4.flat_mask, grids["surf"]),
    ):
        got, want = fn(y, m, grid, k), ref(y, m, grid, k)
        torch.cuda.synchronize()
        if not torch.equal(got.valid, want.valid):
            raise AssertionError(f"grid fits ({name}): {int((got.valid != want.valid).sum())} decisions differ")
        if not all(bool(torch.isfinite(a).all()) for a in got[:2]):
            raise AssertionError(f"grid fits ({name}): non-finite fitted floats")
        diff, envelope, n, n_split = registration.grid_fit_error(got, want, y, grid, k)
        same = int((torch.stack([(a == b).reshape(y.shape[0], -1).all(1) for a, b in zip(got[:2], want[:2])])
                    .all(0) & want.valid).sum())
        log(f"  grid fits, {name}: {int(got.valid.sum())} of {int(m.sum())} queries accepted, decisions identical, "
            f"fitted floats finite on every lane, {same} accepted ones bit-identical; over the {n} with an eigen gap "
            f"above the split ({n_split} at it) max diff {diff:.3g}, times the gap {envelope:.3g} "
            f"(tol {PLANE_ENVELOPE})")
        if envelope > PLANE_ENVELOPE:
            raise AssertionError(f"grid fits ({name}): difference x gap {envelope} > {PLANE_ENVELOPE}")
        fits[name] = (got, diff)
    launches = {name: KERNELS[name].launches for name in ("knn_cell", "grid_fits")}
    log(f"  launches of the checks: {launches}")

    # K9n timed on the surf map: the queries, each bucket row that some
    # query probes read once (the batch's distinct buckets; a row that
    # several queries share, or a duplicate probe, is read once), the
    # outputs; 9 operations per candidate's distance and a log2(k + 1)
    # insertion per candidate
    n_rows = int(torch.unique(knn.probe_buckets(surf, ys)).numel())
    slots = 8 * surf.slots
    dists, points, valid = knn.knn_cell(surf, ys, k)
    measure(torch, records, "knn_cell", lambda: knn.knn_cell(surf, ys, k), lambda: knn.knn_cell_ref(surf, ys, k), 0.0,
            nbytes(ys, dists, points, valid) + n_rows * surf.table.shape[1] * 4,
            ys.shape[0] * slots * (9 + int(np.ceil(np.log2(k + 1)))))

    # K10g timed on both grids, one lines and one planes call: per query
    # 27 binary searches (3 operations per step), 2 per candidate slot, 9 per
    # hit's squared distance, ~30 per kept neighbour and ~300 for the eigh
    n_ops, n_bytes = 0, 0
    for (name, (got, _)), grid, y, m in zip(fits.items(), (grids["edge"], grids["surf"]), (ye, ys),
                                            (f4.sharp_mask, f4.flat_mask)):
        steps = int(np.ceil(np.log2(grid.keys.shape[0] + 1)))
        n_hits = int(knn.knn_candidates(grid, y)[1].sum())
        n_ops += y.shape[0] * (27 * 3 * steps + 27 * 8 * 2 + 30 * k + 300) + 9 * n_hits
        n_bytes += nbytes(*grid[:3], y, m, *got)
    k10g = lambda: (registration.lines_from_fit(ye, f4.sharp_mask, grids["edge"], k),  # noqa: E731
                    registration.planes_from_fit(ys, f4.flat_mask, grids["surf"], k))
    p10g = lambda: (registration.lines_from_fit_ref(ye, f4.sharp_mask, grids["edge"], k),  # noqa: E731
                    registration.planes_from_fit_ref(ys, f4.flat_mask, grids["surf"], k))
    measure(torch, records, "grid_fits", k10g, p10g, max(d for _, d in fits.values()), n_bytes, n_ops)
    return records, launches


def check_lut_kernels(torch, scans, gt, dev):
    """Phase 2f: the LUT paths' kernels vs their plain versions at the
    shapes the host DLO gives them: K3L on the 32768-leaf keyframe map built
    from scan 0's prefiltered, 65536-lane uniform subsample, then K6L
    (DIRECT1 weighted: the align; DIRECT7 weighted: the retry) and K6G
    (DIRECT1 weighted: the retry's arbiter) of scan 1's subsample against
    it, at the true relative pose and at one 0.3 m and 0.02 rad off; each
    standalone call one launch; K6L's gated Newton-loop pass (one launch,
    its rows the standalone sums), timed alone, then `newton_step` over its
    rows and K6L's DIRECT7 call; `lut_cases`; K21."""
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
    pts = nbytes(xs, mask)
    for name, row_bytes, ops in (("ndt_derivatives_soa", 64, 300), ("ndt_derivatives", 52, 400)):
        k6, p6, args = fns[name]
        n_launches = one_call(torch, name, k6)
        if n_launches != 1:
            raise AssertionError(f"{name}: a standalone call made {n_launches} device launches, not one")
        log(f"  {name}: a standalone call is {n_launches} launch of lut_pass (its last block sums the rows), no other "
            f"device work, no synchronizing call")
        measure(torch, records, name, k6, p6, errs[name], pts + 4 * n_probed + row_bytes * n_leaves + 43 * 4,
                ops * hits)

    # the Newton loop's gated K6L pass alone (DIRECT1, the align's), its rows
    # written at the true pose; then `newton_step` over its rows
    d1 = voxel_map.neighborhood_offsets("DIRECT1", dev)
    pass_ = ndt_soa.soa_pass(soa, xs, mask, gauss, d1, ndt_cfg.weighted)
    state = ndt.NewtonState(rel[None])
    state.partials = torch.empty((pass_.n_blocks * ndt.N_TERMS,), dtype=torch.float32, device=dev)
    rec = records["ndt_derivatives_soa"]
    rec.update(loop_pass_checks(torch, "ndt_derivatives_soa", lambda: pass_.launch(state)))
    same_twice(torch, "ndt_derivatives_soa's gated pass", lambda: pass_.launch(state), state.partials)
    rows = state.partials.view(1, pass_.n_blocks, ndt.N_TERMS)
    s1, g1, h1 = ndt_soa.ndt_derivatives_soa(soa, xs, mask, rel, gauss, d1, ndt_cfg.weighted)
    if not torch.equal(probe_sums(torch, rows)[0].view(torch.int32),
                       torch.cat([s1.reshape(1), g1.reshape(6), h1.reshape(36)]).view(torch.int32)):
        raise AssertionError("ndt_derivatives_soa: the gated pass's rows, summed in row order, are not the standalone "
                             "call's sums")
    rec["gated_pass"] = timed(
        torch, "ndt_derivatives_soa", lambda: pass_.launch(state), fns["ndt_derivatives_soa"][1], errs[
            "ndt_derivatives_soa"], pts + 4 * n_probed + 64 * n_leaves + 4 * ndt.N_TERMS * pass_.n_blocks, 300 * hits,
        f": the Newton loop's gated pass alone ({pass_.n_blocks} rows)")
    p = ndt.loop_params(np.float32(ndt_cfg.transformation_epsilon), ndt_cfg.step_size, ndt_cfg.max_iterations)
    f0, s0 = state.f.clone(), state.s.clone()
    twin = state.clone()

    def k7():
        state.f.copy_(f0)
        state.s.copy_(s0)
        ndt.newton_step(state, pass_.n_blocks, p)

    def p7():
        twin.f.copy_(f0)
        twin.s.copy_(s0)
        ndt.newton_step_ref(twin, s1, g1, h1, p)

    # one step over the gated pass's rows against the twin's over the
    # standalone sums (the same bits, checked above), held as phase 2i holds it
    running = (state.s[:, ndt.S_DONE] == 0).tolist()
    k7()
    p7()
    flips, et, e64 = compare_step(torch, ndt, state, twin, running, p)
    log(f"  newton_step over the gated pass's {pass_.n_blocks} rows: iteration count, accepted transform, score, "
        f"gradient, Hessian and cap bit for bit the twin's, {flips} done / bad flags decided by rounding, candidate "
        f"within {et:.3g} of the twin's and alpha within {e64:.3g} of float64's (tol 1e-5)")
    # as phase 2i bounds it: the rows and the state row read once, the state written once
    rec["newton_step_rows"] = dict(rows=pass_.n_blocks, **timed(
        torch, "newton_step", k7, p7, et, 4 * pass_.n_blocks * ndt.N_TERMS + 2 * (4 * ndt.F_WIDTH + 4 * ndt.S_WIDTH),
        pass_.n_blocks * ndt.N_TERMS + 400, f" over the gated pass's {pass_.n_blocks} rows"))

    # DIRECT7 (the retry's align), standalone: the probes' distinct LUT entries and leaves
    d7 = voxel_map.neighborhood_offsets("DIRECT7", dev)
    cells7 = (cells[:, None, :] + d7[None]).reshape(-1, 3)
    inside7 = torch.all((cells7 >= 0) & (cells7 < e), dim=1) & mask.repeat_interleave(d7.shape[0])
    flat7 = ((cells7[:, 0] * e + cells7[:, 1]) * e + cells7[:, 2])[inside7].to(torch.int64)
    leaves7 = lut[flat7]
    hits7 = int((leaves7 >= 0).sum())
    n_probed7, n_leaves7 = int(torch.unique(flat7).numel()), int(torch.unique(leaves7[leaves7 >= 0]).numel())
    log(f"    DIRECT7 at the true pose: {hits7} hits, {n_probed7} distinct LUT entries, {n_leaves7} distinct leaves")
    rec["direct7"] = timed(
        torch, "ndt_derivatives_soa",
        lambda: ndt_soa.ndt_derivatives_soa(soa, xs, mask, rel, gauss, d7, ndt_cfg.weighted),
        lambda: ndt_soa.ndt_derivatives_soa_ref(soa, xs, mask, rel, gauss, d7, ndt_cfg.weighted),
        errs["ndt_derivatives_soa"], pts + 4 * n_probed7 + 64 * n_leaves7 + 43 * 4, 300 * hits7, " DIRECT7")

    n_cases = check_lut_cases(torch, dev)
    log(f"  lut_pass (K6L, K6G): the {n_cases} lut_cases against the plain passes on the card, each standalone "
        f"call one launch with no synchronizing call, each gated pass's rows the standalone sums bit for bit (a "
        f"finished candidate's untouched)")

    # K21: the host DLO's subsample of scan 1's filtered cloud, one launch
    # with no synchronizing call and no device work but its own, bit for bit
    # its twin run on a CPU copy, here and on `subsample_cases`
    filtered = prefilter.prefilter(PointCloud.from_numpy(scans[1], cap=pf.raw_cap, device=dev), pf)
    k = cfg.odometry.scan_matching_cap
    k21 = lambda: prefilter.uniform_subsample(filtered, k)  # noqa: E731
    p21 = lambda: prefilter.uniform_subsample_ref(filtered, k)  # noqa: E731
    n_launches = one_call(torch, "uniform_subsample", k21)
    got, want = on_cpu(k21()), prefilter.uniform_subsample_ref(on_cpu(filtered), k)
    if not identical_clouds(torch, got, want):
        raise AssertionError(f"uniform_subsample: {int(got.mask.sum())} rows set against the CPU twin's "
                             f"{int(want.mask.sum())}, not bit-identical")
    n_cases = check_subsample_cases(torch, dev)
    log(f"  uniform_subsample: {int(filtered.mask.sum())} points in {filtered.cap} lanes -> {k} lanes, bit for bit "
        f"the CPU twin's; {n_launches} launch of its own, no other device work, no synchronizing call; the "
        f"{n_cases} subsample_cases bit for bit too")
    # bytes: the mask read once, the chosen rows (17 bytes) read and written once
    measure(torch, records, "uniform_subsample", k21, p21, 0.0, filtered.cap + 2 * 17 * k, 0)
    return records


# ----------------------------------------------------------------- phase 3

ODOMETRY_KERNELS = ("distance_filter", "voxel_downsample", "build_voxel_map", "to_hash", "ndt_derivatives_hash",
                    "newton_step")
CHAIN_KERNELS = ODOMETRY_KERNELS + (
    "extract_features", "insert_cell_table", "crop_cell_table", "lines_from_fit", "planes_from_fit", "gn_solve",
)


def band_gate(launches: dict, where: str) -> None:
    """Each prefilter of a scan on the fused paths (`odometry/fused._prefilter_mid`:
    one per odometry step, and scan 0's map and filtered product) launches
    the band's kernel once, beside K1: no torch band remains."""
    if launches["distance_filter"] != launches["voxel_downsample"] or launches["vertical_angle_calibration"]:
        raise AssertionError(f"{where}: the band launched {launches['distance_filter']} times for "
                             f"{launches['voxel_downsample']} prefiltered scans (K0a's calibration "
                             f"{launches['vertical_angle_calibration']})")
    log(f"  {where}: the band's kernel launched once per prefiltered scan ({launches['distance_filter']})")


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
    band_gate(launches, "the odometry path")

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
    return summary, poses, syncs, launches


def profile(torch, run, what: str, span: str = "8 scans") -> float:
    """Device time by kernel over one `span` (8 scans) `run`, from the profiler,
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
    log(f"  profile of {span} ({what}): wall {wall_us / 1e3:.2f} ms unprofiled ({profiled_us / 1e3:.2f} ms "
        f"profiled), device busy {busy / 1e3:.2f} ms over {sum(c for _, _, c in dev_time)} device launches, idle "
        f"share {1 - busy / wall_us:.3f}")
    log_kernels(sorted(dev_time, reverse=True))
    return 1 - busy / wall_us


def log_kernels(top) -> None:
    """Logs a profile's (device us, name, launches) rows, largest first: the
    top 12, the library sorts' glue wherever it ranks, then every hand
    kernel of csrc/ wherever it ranks, with its ms per launch."""
    for t, key, count in top[:12]:
        log(f"    {t / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")
    for t, key, count in top[12:]:
        if "RadixSort" in key:
            log(f"    {t / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")
    log("    hand kernels (total ms, launches, ms per launch, rank):")
    for rank, (t, key, count) in enumerate(top, 1):
        if is_hand_kernel(key):
            log(f"    {t / 1e3:9.3f} ms  {count:6d} x  {t / 1e3 / max(count, 1):.4f} ms  #{rank}  {key[:80]}")
    for fn in ("newton_step", "ndt_partials", "normal_cluster", "lm_step"):  # the Newton pair, K15 and the LM
        rows = [(t, count) for t, key, count in top if _is_function(key, fn)]
        if rows:
            t, count = sum(r[0] for r in rows), sum(r[1] for r in rows)
            log(f"    {fn}: {t / 1e3:.3f} ms over {count} launches ({t / 1e3 / count:.4f} ms a launch)")


# the device functions of K14's build and query, K17, K18, K9b, K9k (its
# three entries: knn, lines, planes), K16, K9g's build and K9c's as a trace
# names them; the builds' `key_sort_pass` launches (K14's, K9g's past 8192
# lanes, K9c's) are shared with K1, K1b, K2 and K3: "key sort" sums every
# caller's passes
TRACED_FAMILY = {
    "K14 build": ("grid_ranges", "grid_keys", "grid_runs"), "K14 query": ("grid_query", "grid_finish"),
    "K17": ("nn_points_kernel", "icp_match", "icp_means", "icp_cov", "icp_update"), "K18 radius": ("outlier_radius",),
    "K18 statistical": ("stat_dist", "stat_mean", "stat_var", "stat_thresh", "stat_keep"), "K9b": ("crop_tables",),
    "K9k": DEVICE_FUNCTIONS["knn"], "K16": DEVICE_FUNCTIONS["detect_floor"],
    "K9g": tuple(f for f in DEVICE_FUNCTIONS["build_grid"] if f != "key_sort_pass"),
    "K9c": tuple(f for f in DEVICE_FUNCTIONS["build_cell_table"] if f != "key_sort_pass"),
    "key sort": ("key_sort_pass",),
}


def device_rows(torch, events) -> list:
    """A profile's (device us, name, launches) rows, largest first."""
    attr = "self_device_time_total" if hasattr(torch.autograd.profiler_util.FunctionEventAvg(),
                                               "self_device_time_total") else "self_cuda_time_total"
    return sorted(((getattr(e, attr), e.key, e.count) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)


TRACE_LEAD_IN = 32  # marker kernels a trace starts with, ahead of the traced call


def trace_rows(torch, fn) -> list:
    """`device_rows` of one traced call of `fn`. The trace opens with
    TRACE_LEAD_IN marker kernels and a synchronization: traces on the card
    lost their first kernels' records (phase 10a's GICP align, its two grid
    builds; 7b's first scan's), so the markers stand where a lost record
    would be."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_LEAD_IN):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return device_rows(torch, prof.key_averages())


def traced_family(rows) -> dict:
    """{kernel: {ms, launches}} of TRACED_FAMILY's device functions in a
    profile's rows (device launches: a K14 build is three, its four passes
    aside), and the library's onesweep launches."""
    out = {}
    for name, fns in TRACED_FAMILY.items():
        hit = [(t, c) for t, key, c in rows if any(_is_function(key, f) for f in fns)]
        if hit:
            out[name] = dict(ms=sum(t for t, _ in hit) / 1e3, launches=sum(c for _, c in hit))
    out["onesweep_launches"] = sum(c for _, key, c in rows if "DeviceRadixSortOnesweepKernel" in key)
    return out


def log_family(what: str, family: dict) -> None:
    parts = [f"{k} {v['ms']:.4f} ms over {v['launches']} device launches" for k, v in family.items()
             if isinstance(v, dict)]
    log(f"  traced {what}: {'; '.join(parts) or 'no launch of ' + ' / '.join(TRACED_FAMILY)}; library onesweep launches "
        f"{family['onesweep_launches']}")


class sort_callers:
    """Within the block, the port's calls of torch's sorts on CUDA tensors
    (the library's radix sort, whose onesweep launches a trace counts), by
    the innermost frame of `lv_slam_tpu_torch` that made them: `calls` maps
    "file:line" to a count. The functions are swapped on `torch` and
    `torch.Tensor` (every thread sees them, the backend's worker too)."""

    SORTS = ("sort", "argsort", "msort", "topk", "kthvalue", "unique", "unique_consecutive")

    def __enter__(self):
        import inspect
        import threading

        import torch

        calls = self.calls = {}
        lock = threading.Lock()

        def counted(fn):
            def call(*args, **kwargs):
                if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                    frame = inspect.currentframe().f_back
                    while frame is not None and "lv_slam_tpu_torch" not in frame.f_code.co_filename:
                        frame = frame.f_back
                    where = ("(outside the port)" if frame is None else
                             f"{frame.f_code.co_filename.split('lv_slam_tpu_torch/')[-1]}:{frame.f_lineno}")
                    with lock:
                        calls[where] = calls.get(where, 0) + 1
                return fn(*args, **kwargs)
            return call

        self.saved = [(owner, name, getattr(owner, name), name in vars(owner)) for owner in (torch, torch.Tensor)
                      for name in self.SORTS if hasattr(owner, name)]
        for owner, name, fn, _ in self.saved:
            setattr(owner, name, counted(fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn, own in self.saved:
            if own:
                setattr(owner, name, fn)
            else:  # a method torch.Tensor inherits
                delattr(owner, name)
        return False


def is_hand_kernel(key: str) -> bool:
    """Whether a profiler kernel name is one of csrc/'s: their kernels sit in
    top-level anonymous namespaces or in lvs::, PyTorch's under at:: or c10::."""
    name = key[5:] if key.startswith("void ") else key
    return name.startswith(("(anonymous namespace)::", "lvs::"))


def hand_launches(torch, fn, functions=None, reps: int = 5) -> list:
    """The hand kernels (`functions`, by default the device functions of
    DEVICE_FUNCTIONS; names demangled or not) that one call of `fn`
    launches on the card, in launch order: the shape most of `reps` calls
    take in a torch.profiler trace, a marker between calls (`whole_calls`:
    a trace may lack records); a trace with no whole call is taken again,
    five times at most."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    functions = sorted(functions or {f for fs in DEVICE_FUNCTIONS.values() for f in fs})
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.cuda._sleep(1000)
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [e.name for e in sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                                        key=lambda e: e.time_range.start)]
        calls = whole_calls(names)
        if calls:
            return [f for i in calls[0] for f in functions if _is_function(names[i], f)]
    raise AssertionError("hand_launches: five traces held no whole call")


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
    band_gate(launches, "the dlo -> LFA chain")
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
# K3L, K6L, K6G, K21: the LUT paths and the host DLO's subsample (phase 8)
LUT_KERNELS = ("build_lut", "ndt_derivatives_soa", "ndt_derivatives", "uniform_subsample")
INPUT_KERNELS = ("window_group_fn", "detect_floor")  # K2r, K16: the raw feed and floor detection (phase 9)
# K17, K19a, K19b, K20 (the registrations), K18 and K0a (the prefilter's
# last branches): phase 10
OFF_PATH_KERNELS = ("nn_points", "_plane_covariances", "gicp_align", "filter_ground_leaves", "radius_outlier_removal",
                    "statistical_outlier_removal", "vertical_angle_calibration")
CELL_KNN_KERNELS = ("knn_cell", "grid_fits")  # K9n, K10g: no path of either package calls them (phase 2j)
MESH_KERNELS = ("newton_sums",)  # the sharded align's sums: phase 11b
# loop_rejections of the reference's BoW-ranked CPU records of this circle
# (BENCH_r05_cpu_accuracy_dedup_stride.json, _refvocab.json)
REFERENCE_REJECTIONS = {"verified": 1, "bow_rejected": 0, "guess_rejected": 0, "fitness_rejected": 0}


def make_backend(dev, asynchronous: bool, vocabulary=None, loop_cfg=None, **graph):
    """The reference benchmark's `make_backend` (`bench.py:257-313`): its
    graph settings (`graph` overrides some), the given vocabulary (phase 5
    has none: the pure-lidar configuration) and loop configuration."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.config import GraphConfig, LoopDetectorConfig
    from lv_slam_tpu_torch.pipeline.async_backend import AsyncBackend
    from lv_slam_tpu_torch.pipeline.backend import GlobalGraph

    backend = GlobalGraph(
        GraphConfig(**{**dict(keyframe_cap=64, edge_cap=256, prior_cap=16, solver_num_iterations=64), **graph}),
        loop_cfg or LoopDetectorConfig(), prefilter_cfg=kitti_flagship_config().prefilter, device=dev,
        vocabulary=vocabulary,
    )
    return AsyncBackend(backend) if asynchronous else backend


def run_full(torch, xyz, mask, stamps, inten, cfg, backend, image_chunks=None, raw=False, sensors=None):
    """One pass of the full path, as the reference benchmark's `run_chain`:
    chunk k's chain is launched before chunk k-1's refined poses are read
    and fed, with its filtered product (with `raw`, the raw chunk: the
    backend's default feed) and its device image stack from `image_chunks`
    and its scans' sensor readings from `sensors`, when given, to the
    backend (on the backend's worker when it is an AsyncBackend);
    `optimize()` every 100 scans, then `finish()` and `drain()`. Returns
    (refined poses, the GlobalGraph)."""
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
        graph.add_scan_batch(s, stamps_np[s:e], poses, cloud, images=images,
                             sensors=None if sensors is None else sensors[s:e], filtered=not raw)
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
        out, state = run_sequence_chain(
            xyz[s:e], mask[s:e], stamps[s:e], cfg.odometry, cfg.prefilter, cfg.lfa,
            init_state=state, return_state=True, inten=inten[s:e], return_filtered=not raw, device=xyz.device,
        )
        if pending is not None:
            hand_over(pending)
        cloud = PointCloud(xyz[s:e], inten[s:e], mask[s:e]) if raw else PointCloud(*out[2])
        pending = (s, e, out[1], cloud)
    hand_over(pending)
    backend.finish()
    backend.drain()
    return np.concatenate([parts[k] for k in sorted(parts)]).astype(np.float64), graph


def keyframe_errors(graph, gt):
    """Each keyframe's optimized position error against the ground truth (m)."""
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    return [float(np.linalg.norm(k.estimate[:3, 3] - gt_rel[k.seq][:3, 3])) for k in graph.keyframes]


SOLVES = CACHE / "phase5_solves.npz"  # phase 5's LM solves, for scripts/pose_graph_parent.py


def recorded_solves(run):
    """(run's result, [(graph, num_iterations, result)] of each LM solve the
    backend made in it): `optimize_pose_graph` wrapped while `run()` runs."""
    import lv_slam_tpu_torch.pipeline.backend as backend_module
    from lv_slam_tpu_torch.graph import pose_graph

    solves, solve = [], backend_module.pg.optimize_pose_graph

    def recording(graph, num_iterations, device):
        frozen = pose_graph.PoseGraph(*(np.array(a) for a in graph))
        result = solve(frozen, num_iterations, device=device)
        solves.append((frozen, num_iterations, result))
        return result

    backend_module.pg.optimize_pose_graph = recording
    try:
        out = run()
    finally:
        backend_module.pg.optimize_pose_graph = solve
    return out, solves


def save_solves(solves) -> None:
    """The solves' graphs and iteration limits into SOLVES."""
    arrays = {f"{i}_{field}": value for i, (graph, _, _) in enumerate(solves)
              for field, value in graph._asdict().items()}
    arrays.update({f"{i}_num_iterations": np.int64(it) for i, (_, it, _) in enumerate(solves)})
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = SOLVES.with_suffix(f".{os.getpid()}.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, SOLVES)


def load_solves():
    """[(graph, num_iterations)] from SOLVES."""
    from lv_slam_tpu_torch.graph import pose_graph

    with np.load(SOLVES) as z:
        count = len([k for k in z.files if k.endswith("_num_iterations")])
        return [(pose_graph.PoseGraph(*(z[f"{i}_{field}"] for field in pose_graph.PoseGraph._fields)),
                 int(z[f"{i}_num_iterations"])) for i in range(count)]


def run_full_path(torch, scans, gt, dev, card):
    """Phase 5: the full pure-lidar path over the whole circle."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.graph import pose_graph
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches

    cfg = kitti_flagship_config()
    xyz, mask, stamps, inten = stack_scans(torch, scans, cfg.prefilter.raw_cap, dev)
    n = len(scans)

    # record each LM's input graph and result, to re-solve the last one on the CPU
    def first_pass():
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out = run_full(torch, xyz, mask, stamps, inten, cfg, make_backend(dev, asynchronous=True))
        torch.cuda.synchronize()
        return out

    (est, graph), solves = recorded_solves(first_pass)
    save_solves(solves)
    peak = torch.cuda.max_memory_allocated()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on the full path ({n} scans): {launches}")
    missing = [name for name, count in launches.items()
               if count == 0
               and name not in CAMERA_KERNELS + STANDALONE_KERNELS + LUT_KERNELS + INPUT_KERNELS + OFF_PATH_KERNELS
               + CELL_KNN_KERNELS + MESH_KERNELS]
    if missing:
        raise AssertionError(f"kernels never launched on the full path: {missing}")
    band_gate(launches, "the full path")
    log(f"  exempt from the launch check here: {list(CAMERA_KERNELS)} (no images in this configuration; "
        f"phases 6 and 6b drive them), {list(STANDALONE_KERNELS)} (standalone LFA; phase 7 drives them), "
        f"{list(LUT_KERNELS)} (the LUT paths and the host DLO; phase 8 drives them), {list(INPUT_KERNELS)} (the raw feed and "
        f"floor detection; phase 9 drives them), {list(OFF_PATH_KERNELS)} (the registrations and the prefilter's "
        f"last branches; phase 10 drives them), {list(CELL_KNN_KERNELS)} (no path calls them; phase 2j checks them), "
        f"{list(MESH_KERNELS)} (the sharded align; phase 11b drives it)")
    t_err, drift = accuracy(est, gt, f"refined (LFA) poses of the full path, {n} scans", n)

    loops = [(lp.key1.seq, lp.key2.seq, round(lp.fitness, 6)) for lp in graph.loops]
    stats = dict(graph.loop_detector.stats)
    log(f"  keyframes {len(graph.keyframes)} (reference record {REFERENCE_KEYFRAMES}), loops "
        f"(new seq, old seq, fitness) {loops}, loop_rejections {stats}, LM solves {len(solves)} "
        f"(iterations {[int(r.iterations) for _, _, r in solves]})")
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
        f"{int(result.iterations)} / {int(ref.iterations)}")
    if d_graph > 1e-4:
        raise AssertionError("the card's pose graph departs from the plain path's")
    dg = pose_graph.to_device(frozen, dev)
    damped, rhs = pose_graph._damped_system(dg, dg.poses, dg.planes, 1e-4)

    def solve():
        chol, _ = torch.linalg.cholesky_ex(damped)
        return torch.cholesky_solve(rhs[:, None], chol)

    _, solve_ms, _ = device_ms(torch, solve)
    log(f"  the LM's library solve (cholesky_ex + cholesky_solve) on the last solve's {damped.shape[0]} x "
        f"{damped.shape[0]} system: {solve_ms:.4f} ms device-only")

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
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    kernels = device_rows(torch, events)
    busy_us = sum(t for t, _, _ in kernels)
    CACHE.mkdir(parents=True, exist_ok=True)
    (CACHE / "profile_full.txt").write_text(events.table(sort_by=attr, row_limit=200))
    idle = 1 - busy_us / 1e6 / elapsed
    log(f"  device busy {busy_us / 1e3:.1f} ms over the {n}-scan pass (profiled), against the warm pass's "
        f"{elapsed * 1e3:.1f} ms wall: idle share {idle:.3f}; peak device memory {peak / 2**20:.1f} MiB")
    log_kernels(kernels)
    # the library's radix sorts that remain on the path (K14's grid; torch.sort under any other wrapper)
    cub = {kind: sum(count for _, key, count in kernels if f"DeviceRadixSort{kind}Kernel" in key)
           for kind in ("Onesweep", "Histogram", "ExclusiveSum")}
    log(f"  library radix-sort launches on the {n}-scan pass: onesweep {cub['Onesweep']}, histogram "
        f"{cub['Histogram']}, exclusive sum {cub['ExclusiveSum']}")
    family = traced_family(kernels)
    log_family(f"on the {n}-scan pass", family)
    summary = dict(
        scans_per_s=n / elapsed, devkit_t_err=t_err, drift_m=drift, keyframes=len(graph.keyframes),
        n_loops=len(loops), loops=loops, loop_rejections=stats, backend_phase_ms_per_scan=phase_ms,
        syncs_per_scan=syncs / n, idle_share=idle, peak_mib=peak / 2**20, busy_ms=busy_us / 1e3,
        cub_sort_launches=cub, traced_k14_k17_k18_k9b=family, lm_solve_ms=solve_ms, lm_solve_dofs=int(damped.shape[0]),
        lm_iterations=[int(r.iterations) for _, _, r in solves],
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
    kf_err = keyframe_errors(graph, gt)
    log(f"  optimized keyframe position error vs ground truth: max {max(kf_err):.4f} m")
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
        keyframe_seqs=[k.seq for k in graph.keyframes], max_keyframe_err_m=max(kf_err),
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
    family = traced_family(trace_rows(torch, lambda: run_lfa_chunks(torch, xyz, mask, cfg)))
    log_family(f"over the whole {n}-scan run (K9k: its lines and planes)", family)
    summary = dict(scans_per_s=n / elapsed, devkit_t_err=t_err, drift_m=drift, worst_step_m=float(steps.max()),
                   syncs_per_step=syncs / CHUNK, idle_share=idle, peak_mib=peak / 2**20,
                   jax_record=JAX_FUSED_LFA, traced=family)
    return summary, launches


def run_lvslam(torch, scans, gt, dev, card, images):
    """Phase 7b: LvSlam(use_dlo=False) per scan with camera images, then finalize."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.graph.bow import VOCABULARY_ASSET, Vocabulary
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.pipeline.slam import LvSlam

    n = len(scans)
    vocabulary = Vocabulary.load(str(VOCABULARY_ASSET))

    def one_pass():
        slam = LvSlam(kitti_flagship_config(), use_dlo=False, vocabulary=vocabulary, device=dev)
        for i, scan in enumerate(scans):
            slam.process(scan, 0.1 * i, image=images[i])
        slam.finalize()
        return slam

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = one_pass()
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
    # a second whole pass with the mapping's table builds recorded, then
    # those builds replayed in a trace: K9c alone, its passes included
    # (`key sort` there is K9c's own)
    from lv_slam_tpu_torch.lfa import mapping as lfa_mapping
    from lv_slam_tpu_torch.ops import knn

    recorded = []

    def recording(xyz, mask, *args):
        recorded.append((xyz.clone(), mask.clone(), args))
        return knn.build_cell_table(xyz, mask, *args)

    lfa_mapping.build_cell_table = recording
    try:
        one_pass()
    finally:
        lfa_mapping.build_cell_table = knn.build_cell_table
    family = traced_family(trace_rows(torch, lambda: [knn.build_cell_table(x, m, *a) for x, m, a in recorded]))
    family["builds"] = len(recorded)
    log_family(f"K9c's {len(recorded)} table builds of a second pass, replayed", family)
    summary = dict(scans_per_s=n / elapsed, devkit_t_err=t_err, drift_m=drift, keyframes=keyframes, loops=loops,
                   max_keyframe_err_m=max(kf_err), last_keyframe_err_m=kf_err[-1], peak_mib=peak / 2**20,
                   jax_record=JAX_LVSLAM, traced=family)
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
# slice's kernels (K3L, K6L, K6G, K21) swapped for their twins (`plain_twins`) to
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
# a whole LM on the card against its twin's loop on the card: poses (m),
# planes, chi2 (relative), tests/test_torch_pose_graph.py's LM tolerances
# where the iteration counts may differ (the twin damps and updates with
# other roundings than csrc/lm.cu, and near the optimum a step that moves
# chi2 by less than its rounding is taken or not: 2c's graph ran 29
# iterations and ended 1.4e-4 m from the twin's)
LM_TOL = (1e-3, 1e-4, 1e-3)
# a whole Newton loop against its twins' on the card, the same iterations: a
# tenth of its transformation_epsilon (the twin's float32 6x6 solve errs by
# cond(H) x 2^-23, ~1e-4 of a 0.1 m step at these maps' cond ~1e4); an
# iteration apart, the last step (< eps) may be taken or not: CPU_SPREAD_M
NDT_LOOP_TOL = 1e-3


class plain_twins:
    """Within the block, the LUT paths call K3L's, K6L's, K6G's and K21's
    plain twins on the card and run the Newton loop (K7) with `newton_step_ref`,
    and the registrations and the prefilter's front and branches call those
    of K17-K20 and K0a (the harness swaps the functions in; no wrapper falls
    back)."""

    def __enter__(self):
        from lv_slam_tpu_torch.odometry import dlo, fused
        from lv_slam_tpu_torch.ops import gicp, icp, ndt, ndt_ground, ndt_soa, nn, prefilter, voxel_map

        self.saved = [
            (dlo, "build_lut", voxel_map.build_lut_ref),
            (voxel_map, "build_lut", voxel_map.build_lut_ref),
            (dlo, "ndt_derivatives", ndt.ndt_derivatives_ref),
            (dlo, "_subsample_cache", lambda out_cap: lambda cloud: prefilter.uniform_subsample_ref(cloud, out_cap)),
            (prefilter, "uniform_subsample", prefilter.uniform_subsample_ref),
            (ndt_soa, "ndt_derivatives_soa", ndt_soa.ndt_derivatives_soa_ref),
            (ndt, "ndt_derivatives", ndt.ndt_derivatives_ref),
            (icp, "icp_step", icp.icp_step_ref),
            (icp, "icp_fitness", icp.icp_fitness_ref),
            (gicp, "regularized_covariances", gicp.regularized_covariances_ref),
            (gicp, "gicp_normal_equations", gicp.gicp_normal_equations_ref),
            (ndt_ground, "filter_ground_leaves", ndt_ground.filter_ground_leaves_ref),
            (nn, "radius_outlier_removal", nn.radius_outlier_removal_ref),
            (nn, "statistical_outlier_removal", nn.statistical_outlier_removal_ref),
            (prefilter, "vertical_angle_calibration", prefilter.vertical_angle_calibration_ref),
            (prefilter, "distance_filter", prefilter.distance_filter_ref),
            (prefilter, "calibrated_band", prefilter.calibrated_band_ref),
            (fused, "distance_filter", prefilter.distance_filter_ref),
            (ndt, "_newton_loop", ndt._newton_loop_plain),
            (ndt_soa, "_newton_loop", ndt._newton_loop_plain),
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
    aligns = []  # one entry per align: the K7 loops of this run
    odo_align, odo_retry = odo._align, odo._align_retry
    odo._align = lambda *a, **kw: aligns.append(1) or odo_align(*a, **kw)
    if odo_retry is not None:
        odo._align_retry = lambda *a, **kw: aligns.append(1) or odo_retry(*a, **kw)

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
    missing = [name for name in ("voxel_downsample", "build_voxel_map", "build_lut", "ndt_derivatives_soa",
                                 "newton_step") if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the host DLO: {missing}")
    if launches["uniform_subsample"] != n:
        raise AssertionError(f"the host DLO launched K21 {launches['uniform_subsample']} times, not once per scan")
    if launches["distance_filter"] != n or launches["vertical_angle_calibration"]:
        raise AssertionError(f"the host DLO launched the band's kernel {launches['distance_filter']} times, not once "
                             f"per scan")
    est = np.stack(odo.poses)
    t_err, drift = accuracy(est, gt, f"host DLO poses, {n} scans", n)
    steps = step_errors(est, gt)
    stats = odo.stats
    log(f"  keyframes {odo.keyframe_indices} ({stats.keyframe_count}), retries {stats.retries}, Newton "
        f"iterations {stats.total_iterations} in {len(aligns)} aligns (K7 loops); relative-step error worst "
        f"{steps.max():.4f} m at step "
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
    clouds, recorded = host_dlo_pass(process, cfg, dev, n)
    subsample = subsample_replay(torch, clouds, cfg)
    lut_traced = align_replay(torch, recorded)
    summary = dict(scans_per_s=(n - WARM_SCANS) / elapsed, devkit_t_err=t_err, drift_m=drift,
                   keyframes=stats.keyframe_count, retries=stats.retries, newton_iterations=stats.total_iterations,
                   aligns=len(aligns),
                   worst_step_m=float(steps.max()), syncs_per_scan=syncs / CHUNK, idle_share=idle,
                   peak_mib=peak / 2**20, jax_record=JAX_HOST_DLO, uniform_subsample_traced=subsample,
                   lut_traced=lut_traced)
    return summary, launches


def record_aligns(odo) -> list:
    """Wraps the host DLO `odo`'s aligns (and its retry's) so that each
    call's (function, arguments, keywords) is kept; returns the list."""
    calls = []
    for attr in ("_align", "_align_retry"):
        fn = getattr(odo, attr)
        if fn is not None:
            setattr(odo, attr, lambda *a, fn=fn, **kw: calls.append((fn, a, kw)) or fn(*a, **kw))
    return calls


def host_dlo_pass(process, cfg, dev, n: int):
    """A fresh `DirectLidarOdometry` over the n scans: (the prefiltered
    clouds its subsample was handed, its aligns as `record_aligns` keeps
    them)."""
    from lv_slam_tpu_torch.odometry.dlo import DirectLidarOdometry

    odo = DirectLidarOdometry(cfg.odometry, cfg.prefilter, device=dev)
    clouds, sub = [], odo._subsample
    odo._subsample = lambda cloud: clouds.append(cloud) or sub(cloud)
    aligns = record_aligns(odo)
    for i in range(n):
        process(odo, i)
    return clouds, aligns


def align_replay(torch, aligns, what: str = "K6L", pass_fn: str = "lut_pass", results=None) -> dict:
    """A host-DLO pass's aligns (`host_dlo_pass`) replayed in one trace
    (`trace_rows`): the device totals and launches of the LUT pass (device
    function `pass_fn`: K6L gated in the Newton loop) and of `newton_step`.
    `results`, where given, receives each align's result."""
    results = [] if results is None else results
    rows = [r for r in trace_rows(torch, lambda: results.extend(fn(*a, **kw) for fn, a, kw in aligns))
            if MARKER not in r[1]]
    out = dict(aligns=len(aligns))
    for key, fn in (("pass", pass_fn), ("newton_step", "newton_step")):
        hit = [(t, c) for t, name, c in rows if _is_function(name, fn)]
        out[f"{key}_ms"] = sum(t for t, _ in hit) / 1e3
        out[f"{key}_launches"] = sum(c for _, c in hit)
    out["total_ms"] = out["pass_ms"] + out["newton_step_ms"]
    log(f"  traced {what} over the {len(aligns)} aligns of a host-DLO pass, replayed: {pass_fn} {out['pass_ms']:.4f} "
        f"ms over {out['pass_launches']} launches, newton_step {out['newton_step_ms']:.4f} ms over "
        f"{out['newton_step_launches']}; together {out['total_ms']:.4f} ms")
    if not out["pass_launches"] or out["pass_launches"] != out["newton_step_launches"]:
        raise AssertionError(f"the aligns' replay must launch {pass_fn} and newton_step once per Newton step each")
    return out


def subsample_replay(torch, clouds, cfg) -> dict:
    """K21 over a whole host-DLO pass: the prefiltered clouds that a fresh
    `DirectLidarOdometry` handed its subsample (`host_dlo_pass`), replayed by
    K21 and by its plain twin, each in one trace (`trace_rows`): their
    device totals, launches and K21's launches of its own."""
    from lv_slam_tpu_torch.ops import prefilter

    k = cfg.odometry.scan_matching_cap
    out = dict(calls=len(clouds))
    for key, fn in (("kernel", prefilter.uniform_subsample), ("plain", prefilter.uniform_subsample_ref)):
        rows = [r for r in trace_rows(torch, lambda fn=fn: [fn(c, k) for c in clouds]) if MARKER not in r[1]]
        out[f"{key}_ms"] = sum(t for t, _, _ in rows) / 1e3
        out[f"{key}_launches"] = sum(c for _, _, c in rows)
        if key == "kernel":
            out["own_launches"] = sum(c for _, name, c in rows if _is_function(name, "subsample_cluster"))
    log(f"  traced K21 over the {len(clouds)} subsamples of a host-DLO pass, replayed: {out['kernel_ms']:.4f} ms over "
        f"{out['kernel_launches']} device launches ({out['own_launches']} of subsample_cluster); the plain version "
        f"{out['plain_ms']:.4f} ms over {out['plain_launches']}")
    if not out["own_launches"] or out["kernel_launches"] != out["own_launches"]:
        raise AssertionError("K21's replay launched no subsample_cluster, or device work besides it")
    return out


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
    missing = [name for name in ("build_lut", "ndt_derivatives_soa", "uniform_subsample", "build_cell_table",
                                 "_detect_pyramid_batch") if launches[name] == 0]
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
        f"(gate 0.02), converged {bool(res.converged)} in {int(res.iterations)} Newton iterations, {elapsed:.3f} s "
        f"map build and align included ({card})")
    if not (t_err < 0.05 and r_err < 0.02 and bool(res.converged)):
        raise AssertionError("the generic align misses tests/test_ndt.py's gates")
    with plain_twins():
        twin = align(dev)
    first_poses_vs_cpu(got[None], twin.transform.cpu().numpy()[None].astype(np.float64), "generic-align transform",
                       "on the card")
    ref = align("cpu")
    first_poses_vs_cpu(got[None], ref.transform.numpy()[None].astype(np.float64), "generic-align transform",
                       tol=CPU_SPREAD_M)
    return dict(t_err_m=t_err, r_err_rad=r_err, iterations=int(res.iterations), seconds=elapsed), launches


# ----------------------------------------------------------------- phase 9

SENSOR_GRAPH = dict(enable_gps=True, enable_imu_orientation=True, enable_imu_acceleration=True)


def circle_sensors(gt, at, gps_noise: float = 0.2):
    """Per scan, the readings a GPS and an IMU would give on the circle, in
    the odometry's frame (gt[0]^-1 gt: the backend anchors keyframe 0 at the
    identity and takes GPS relative to its first fix): GPS = truth + [500,
    300, 0] + N(0, `gps_noise` m) (numpy seed 7), the orientation quaternion of the
    truth and the local acceleration R^T [0, 0, 9.81]; None for the scans
    not in `at`. The backend gives a keyframe the latest reading of its
    window (the reference's rule), so readings on the keyframes' own scans
    stand for the reference nodelet's association of the message nearest
    the keyframe's stamp."""
    import torch

    from lv_slam_tpu_torch.core import se3

    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float64)
    rng = np.random.default_rng(7)
    quats = se3.quat_from_matrix(torch.from_numpy(gt_rel[:, :3, :3].astype(np.float32))).double().numpy()
    at = set(at)
    readings = [dict(gps=g[:3, 3] + [500.0, 300.0, 0.0] + gps_noise * rng.normal(0, 1.0, 3), imu_quat=q,
                     imu_acc=g[:3, :3].T @ [0.0, 0.0, 9.81]) for g, q in zip(gt_rel, quats)]
    return [r if i in at else None for i, r in enumerate(readings)]


def resolve_on_cpu(graph, phase: str) -> float:
    """Re-solves the backend's last LM (`GlobalGraph.last_solve`) with the
    plain path on the CPU and fails unless the card's poses agree to 1e-4;
    writes the graph and the card's solution to `chiprun_out/graph_<phase>
    .npz` for `scripts/resolve_graph.py` (the JAX reference's LM on the same
    graph, where JAX runs). Returns the largest pose difference."""
    from lv_slam_tpu_torch.graph import pose_graph

    frozen, iters, result = graph.last_solve
    ref = pose_graph.optimize_pose_graph(frozen, iters, device="cpu")
    n_nodes = int(frozen.node_valid.sum())
    d_graph = float(np.abs(result.poses.cpu().numpy()[:n_nodes] - ref.poses.numpy()[:n_nodes]).max())
    log(f"  the last LM ({n_nodes} nodes, {int(frozen.e_valid.sum())} edges, {int(frozen.p_valid.sum())} priors, "
        f"{int(frozen.sp_valid.sum())} SE3-plane edges) re-solved by the plain path on the CPU: max pose difference "
        f"{d_graph:.3g} (tol 1e-4)")
    if d_graph > 1e-4:
        raise AssertionError(f"phase {phase}: the card's pose graph with priors departs from the plain path's")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    np.savez(ROOT / "chiprun_out" / f"graph_{phase}.npz", iters=iters, card_poses=result.poses.cpu().numpy(),
             **{name: np.asarray(a) for name, a in frozen._asdict().items()})
    return d_graph


def run_raw_path(torch, scans, gt, dev, card, images, camera):
    """Phase 9a: the main path with the backend's default feed, the raw
    chunk (`add_scan_batch(filtered=False)`, K2r per window group), camera
    images, the shipped vocabulary and GPS / IMU readings on phase 6's
    keyframe scans; then, for comparison, with exact GPS. The reference
    takes GPS information as 1/sigma (0.05 at its 20 m) against odometry
    edges of information ~2, so the priors carry the GPS noise into the
    graph: the noise-free run holds the graph to phase 6's, and the noisy
    run's last LM is re-solved by the plain path on the CPU."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.graph.bow import VOCABULARY_ASSET, Vocabulary
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.pipeline import backend as backend_module, window

    cfg = kitti_flagship_config()
    xyz, mask, stamps, inten = stack_scans(torch, scans, cfg.prefilter.raw_cap, dev)
    n = len(scans)
    image_chunks = [torch.from_numpy(images[s:s + CHUNK]).to(dev) for s in range(0, n, CHUNK)]
    sensors = circle_sensors(gt, camera["keyframe_seqs"])

    def backend():
        return make_backend(dev, True, vocabulary=Vocabulary.load(str(VOCABULARY_ASSET)), prior_cap=64,
                            **SENSOR_GRAPH)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    groups = []  # K2r's calls of this pass, for the replay below
    feed = backend_module.window_group
    backend_module.window_group = lambda *a: groups.append(a) or feed(*a)
    try:
        est, graph = run_full(torch, xyz, mask, stamps, inten, cfg, backend(), image_chunks, raw=True,
                              sensors=sensors)
    finally:
        backend_module.window_group = feed
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on the raw-chunk path ({n} scans): {launches}")
    missing = [name for name in ("window_group_fn", "_detect_pyramid_batch", "_fused_verify_fn", "_chi2_and_normal")
               if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the raw-chunk path: {missing}")
    if launches["window_group_filtered_fn"]:
        raise AssertionError("the raw-chunk path ran the filtered window group")
    accuracy(est, gt, f"refined (LFA) poses of the raw-chunk path, {n} scans", n)
    seqs = [k.seq for k in graph.keyframes]
    loops = [(lp.key1.seq, lp.key2.seq, round(lp.fitness, 6), round(lp.visual_score, 6)) for lp in graph.loops]
    kf_err = keyframe_errors(graph, gt)
    priors = graph._n_priors
    log(f"  keyframes {seqs} (phase 6: {camera['keyframe_seqs']}), loops (new seq, old seq, fitness, visual score) "
        f"{loops}, loop_rejections {dict(graph.loop_detector.stats)}; {priors} priors on {len(seqs)} keyframes, "
        f"zero_utm {graph.zero_utm.tolist()}; optimized keyframe error max {max(kf_err):.4f} m (phase 6: "
        f"{camera['max_keyframe_err_m']:.4f} m)")
    if seqs != camera["keyframe_seqs"] or [lp[:2] for lp in loops] != [(135, 0)]:
        raise AssertionError("the raw-chunk path must give phase 6's keyframes and the loop (135, 0)")
    if priors != 3 * len(seqs) or graph.graph.p_valid.sum() != priors:
        raise AssertionError(f"the raw-chunk path must attach three priors per keyframe, got {priors}")
    d_graph = resolve_on_cpu(graph, "9a")
    # the same path with exact GPS: the priors must not pull the graph off
    _, exact = run_full(torch, xyz, mask, stamps, inten, cfg, backend(), image_chunks, raw=True,
                        sensors=circle_sensors(gt, camera["keyframe_seqs"], gps_noise=0.0))
    exact_err = keyframe_errors(exact, gt)
    log(f"  optimized keyframe error max: GPS with 0.2 m noise {max(kf_err):.4f} m, exact GPS "
        f"{max(exact_err):.4f} m (gate: within 0.1 m of phase 6's {camera['max_keyframe_err_m']:.4f} m)")
    if abs(max(exact_err) - camera["max_keyframe_err_m"]) > 0.1:
        raise AssertionError("exact GPS / IMU priors pulled the graph more than 0.1 m off phase 6's")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, graph2 = run_full(torch, xyz, mask, stamps, inten, cfg, backend(), image_chunks, raw=True, sensors=sensors)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if [k.seq for k in graph2.keyframes] != seqs or len(graph2.loops) != len(loops):
        raise AssertionError("the warm pass's keyframes or loops differ from the first pass's")
    phase_ms = {k: (v if k == "opt_cycles" else v / n * 1e3) for k, v in sorted(graph2.timings.items())}
    log(f"  warm pass: {n} scans in {elapsed:.3f} s = {n / elapsed:.2f} scans/s ({card}); "
        f"backend_phase_ms_per_scan {json.dumps(phase_ms)}")
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof, sort_callers() as sorts:
        run_full(torch, xyz, mask, stamps, inten, cfg, backend(), image_chunks, raw=True, sensors=sensors)
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = "self_device_time_total" if hasattr(torch.autograd.profiler_util.FunctionEventAvg(),
                                               "self_device_time_total") else "self_cuda_time_total"
    kernels = [(getattr(e, attr), e.key, e.count) for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(t for t, _, _ in kernels)
    onesweep = sum(c for _, key, c in kernels if "DeviceRadixSortOnesweepKernel" in key)
    CACHE.mkdir(parents=True, exist_ok=True)
    (CACHE / "profile_raw.txt").write_text(events.table(sort_by=attr, row_limit=200))
    idle = 1 - busy_us / 1e6 / elapsed
    log(f"  device busy {busy_us / 1e3:.1f} ms over the {n}-scan pass (profiled), against the warm pass's "
        f"{elapsed * 1e3:.1f} ms wall: idle share {idle:.3f}; peak device memory {peak / 2**20:.1f} MiB; K2r launches "
        f"{launches['window_group_fn']}")
    log(f"  library onesweep launches over the profiled pass: {onesweep}; the port's calls of torch's sorts on the "
        f"card there, by caller: {sorts.calls or 'none'}")
    if [where for where in sorts.calls if "pipeline/window.py" in where]:
        raise AssertionError("the raw window group called torch's sort")
    if onesweep and not sorts.calls:
        raise AssertionError("onesweep launches on the raw-chunk path with no caller in the port")
    # K2r's whole device time: the first pass's window groups replayed in one trace
    rows = [r for r in trace_rows(torch, lambda: [window.window_group(*a) for a in groups]) if MARKER not in r[1]]
    k2r = dict(calls=len(groups), ms=sum(t for t, _, _ in rows) / 1e3, launches=sum(c for _, _, c in rows),
               onesweep_launches=sum(c for _, key, c in rows if "DeviceRadixSortOnesweepKernel" in key),
               by_function={f: sum(c for _, key, c in rows if _is_function(key, f))
                            for f in DEVICE_FUNCTIONS["window_group_fn"]})
    log(f"  traced K2r over the pass's {len(groups)} window groups, replayed: {k2r['ms']:.4f} ms over "
        f"{k2r['launches']} device launches {k2r['by_function']}, onesweep {k2r['onesweep_launches']}")
    foreign = [key for _, key, _ in rows if not any(_is_function(key, f) for f in DEVICE_FUNCTIONS["window_group_fn"])]
    if k2r["onesweep_launches"] or foreign or len(groups) != launches["window_group_fn"]:
        raise AssertionError(f"K2r's replay: device work besides its own {foreign}, or {len(groups)} groups against "
                             f"{launches['window_group_fn']} launches")
    summary = dict(scans_per_s=n / elapsed, keyframes=seqs, loops=loops, priors=priors, max_keyframe_err_m=max(kf_err),
                   exact_gps_max_keyframe_err_m=max(exact_err),
                   lm_vs_cpu=d_graph, backend_phase_ms_per_scan=phase_ms, idle_share=idle, peak_mib=peak / 2**20,
                   window_group_launches=launches["window_group_fn"], onesweep_launches=onesweep,
                   sort_callers=sorts.calls, window_group_traced=k2r)
    return summary, launches


def run_lvslam_sensors(torch, scans, gt, dev, card, images, default_err):
    """Phase 9b: LvSlam() at its default with camera images, `detect_floor=
    True` on every scan and the GPS / IMU readings on its keyframes' scans
    (the JAX record's 0, 9, ..., 162). Its last LM is re-solved by the plain
    path on the CPU, and again with exact GPS and without the floor edges, to
    tell the GPS noise's pull from the floor prior's. `default_err` is phase
    8b's largest keyframe error. Returns (summary, K16's launches, the
    LvSlam)."""
    import dataclasses

    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.graph import pose_graph
    from lv_slam_tpu_torch.graph.bow import VOCABULARY_ASSET, Vocabulary
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.ops import floor as floor_ops
    from lv_slam_tpu_torch.ops import prefilter
    from lv_slam_tpu_torch.pipeline.slam import LvSlam

    n = len(scans)
    cfg = kitti_flagship_config()
    cfg = dataclasses.replace(cfg, graph=dataclasses.replace(cfg.graph, **SENSOR_GRAPH))
    sensors = circle_sensors(gt, JAX_LVSLAM_DLO["keyframes"])
    floors = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = LvSlam(cfg, vocabulary=Vocabulary.load(str(VOCABULARY_ASSET)), device=dev)
    for i, scan in enumerate(scans):
        s = sensors[i] or dict(gps=None, imu_quat=None, imu_acc=None)
        slam.process(scan, 0.1 * i, image=images[i], gps_xyz=s["gps"], imu_quat_wxyz=s["imu_quat"],
                     imu_acceleration=s["imu_acc"], detect_floor=True)
        floors.append(slam.last_floor)
    slam.finalize()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"  launches on LvSlam() with sensors and floor detection ({n} scans): {launches}")
    if launches["detect_floor"] != n:
        raise AssertionError(f"floor detection (K16) launched {launches['detect_floor']} times for {n} scans")
    found = [bool(r.found) for r in floors]
    heights = np.array([-float(r.coeffs[3]) / float(r.coeffs[2]) for r in floors])
    backend = slam.backend
    keyframes = [k.seq for k in backend.keyframes]
    loops = [(lp.key1.seq, lp.key2.seq, round(lp.fitness, 6), round(lp.visual_score, 6)) for lp in backend.loops]
    plane = backend.graph.planes[0].tolist()
    kf_err = keyframe_errors(backend, gt)
    g = backend.graph
    sp = g.sp_valid
    sp_heights = g.sp_meas[sp, 3] / g.sp_meas[sp, 2]
    log(f"  floor found on {sum(found)} of {n} scans; floor height -d/n_z {heights.min():.4f} .. {heights.max():.4f} m "
        f"(expected -1.73); planes {backend._n_planes} (floor node {backend.floor_plane_node_id}, after the graph "
        f"{plane}), SE3-plane edges {backend._n_sp_edges} (measured -d/n_z {-sp_heights.max():.4f} .. "
        f"{-sp_heights.min():.4f} m, on nodes {sorted(g.sp_i[sp].tolist())}), priors {backend._n_priors}")
    log(f"  keyframes {keyframes} ({len(keyframes)}), loops {loops}, optimized keyframe error max {max(kf_err):.4f} m; "
        f"one pass {n / elapsed:.2f} scans/s ({card}); K16 launches {launches['detect_floor']}")
    # the clouds the pass handed K16 (the DLO's prefilter of each scan),
    # rebuilt after the timed pass, the same results again, then traced
    clouds = [prefilter.prefilter(PointCloud.from_numpy(scan, cap=cfg.prefilter.raw_cap, device=dev), cfg.prefilter)
              for scan in scans]
    again = [floor_ops.detect_floor(c) for c in clouds]
    if not all(floor_bits(torch, a.coeffs) == floor_bits(torch, b.coeffs) and bool(a.found) == bool(b.found)
               and int(a.best) == int(b.best) and int(a.n_inliers) == int(b.n_inliers) for a, b in zip(again, floors)):
        raise AssertionError("K16 on the rebuilt clouds departs from the pass's results")
    family = traced_family(trace_rows(torch, lambda: [floor_ops.detect_floor(c) for c in clouds]))
    log_family(f"K16 over the {len(clouds)} clouds the pass handed it, rebuilt and called again", family)
    if not all(found) or np.abs(heights + 1.73).max() > 0.1:
        raise AssertionError("the floor must be found on every scan, 1.73 m below the sensor")
    if backend._n_planes != 1 or backend.floor_plane_node_id != 0 or plane != [0.0, 0.0, 1.0, 0.0]:
        raise AssertionError("the floor must be one shared, fixed plane that does not move")
    if len(keyframes) != REFERENCE_KEYFRAMES or [lp[:2] for lp in loops] != [(135, 0)]:
        raise AssertionError("LvSlam() with sensors must give 19 keyframes and the loop (135, 0)")
    nodes = sorted(k.node_id for k in backend.keyframes)
    if (sorted(g.sp_i[sp].tolist()) != nodes or np.any(g.sp_plane[sp] != 0)
            or np.abs(sp_heights - 1.73).max() > 0.1 or backend._n_priors != 3 * len(keyframes)):
        raise AssertionError("LvSlam() must attach one floor edge (1.73 m) to the floor plane and three priors per "
                             "keyframe")
    d_graph = resolve_on_cpu(backend, "9b")

    # the split: the same last graph re-solved on the CPU with exact GPS
    # (each GPS prior at its keyframe's true position: what the noise-free
    # readings give, the first fix being the truth) and without the floor
    # edges, from the card's solution
    frozen, iters, _ = backend.last_solve
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    seq_of = {k.node_id: k.seq for k in backend.keyframes}
    exact_meas = frozen.p_meas.copy()
    for i in np.flatnonzero(frozen.p_valid & (frozen.p_type == pose_graph.PRIOR_XYZ)):
        exact_meas[i, :3] = gt_rel[seq_of[int(frozen.p_node[i])]][:3, 3]

    def split_err(exact_gps: bool, with_floor: bool) -> float:
        graph = frozen._replace(p_meas=exact_meas if exact_gps else frozen.p_meas,
                                sp_valid=frozen.sp_valid & with_floor)
        poses = pose_graph.optimize_pose_graph(graph, iters, device="cpu").poses.numpy()
        return max(float(np.linalg.norm(poses[k.node_id][:3, 3] - gt_rel[k.seq][:3, 3])) for k in backend.keyframes)

    split = {"noisy GPS, no floor": split_err(False, False), "exact GPS, floor": split_err(True, True),
             "exact GPS, no floor": split_err(True, False)}
    log(f"  largest keyframe error of the last graph re-solved on the CPU: noisy GPS and floor (the card's) "
        f"{max(kf_err):.4f} m, " + ", ".join(f"{k} {v:.4f} m" for k, v in split.items())
        + f" (gate: exact GPS without the floor within 0.1 m of phase 8b's {default_err:.4f} m)")
    if abs(split["exact GPS, no floor"] - default_err) > 0.1:
        raise AssertionError("exact GPS / IMU priors pulled LvSlam's graph more than 0.1 m off phase 8b's")
    summary = dict(scans_per_s=n / elapsed, floor_found=sum(found), floor_height_m=[heights.min(), heights.max()],
                   keyframes=keyframes, loops=loops, max_keyframe_err_m=max(kf_err), lm_vs_cpu=d_graph,
                   max_keyframe_err_split_m=split, sp_edges=backend._n_sp_edges, priors=backend._n_priors,
                   detect_floor_launches=launches["detect_floor"], traced=family)
    return summary, launches, slam


def run_services(torch, slam, dev, card):
    """Phase 9c: phase 9b's backend dumped, resumed by `load_dump`,
    re-optimized, its map saved and its pose files written."""
    import shutil

    from lv_slam_tpu_torch.graph import map_cloud
    from lv_slam_tpu_torch.io import kitti, pcd
    from lv_slam_tpu_torch.ops import prefilter
    from lv_slam_tpu_torch.pipeline.backend import load_dump

    backend = slam.backend
    out = CACHE / "services"  # git-ignored; the dump's keyframe clouds are tens of MB
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    backend.dump(str(out / "dump"))
    t_dump = time.perf_counter() - t0
    files = sorted(p.name for p in (out / "dump").iterdir())
    expected = {"graph.g2o", "graph.g2o.kernels", "special_nodes.csv", "zero_utm", "ggo_kf_odom.txt",
                "ggo_wf_odom.txt", *(f"{i:06d}" for i in range(len(backend.keyframes)))}
    if set(files) != expected:
        raise AssertionError(f"dump wrote {files}")
    t0 = time.perf_counter()
    loaded = load_dump(str(out / "dump"), backend.cfg, device=dev)
    t_load = time.perf_counter() - t0
    same = ([(k.seq, k.node_id, int(k.cloud.mask.sum())) for k in loaded.keyframes]
            == [(k.seq, k.node_id, int(k.cloud.mask.sum())) for k in backend.keyframes])
    if not same or loaded._n_priors != backend._n_priors or loaded.floor_plane_node_id != 0:
        raise AssertionError("load_dump did not resume the dumped keyframes and factors")
    before = np.stack([k.estimate for k in backend.keyframes])
    loaded._graph_dirty = True
    t0 = time.perf_counter()
    result = loaded.optimize()
    t_opt = time.perf_counter() - t0
    after = np.stack([k.estimate for k in loaded.keyframes])
    moved = float(np.abs(after - before).max())
    # the same second solve on the graph that was dumped. The text file keeps
    # 9 digits and each measurement's rotation as a quaternion (re-made
    # orthonormal), and the weak GPS priors leave a flat valley, so both
    # solves move on from the first one's stop; their start must see the
    # same factors (chi2 at the dumped estimates)
    backend._graph_dirty = True
    orig = backend.optimize()
    same = float(np.abs(after - np.stack([k.estimate for k in backend.keyframes])).max())
    d_chi2 = abs(float(result.chi2_before) - float(orig.chi2_before)) / float(orig.chi2_before)
    t0 = time.perf_counter()
    if not backend.save_map(str(out / "map.pcd"), utm=True):
        raise AssertionError("save_map wrote nothing")
    t_map = time.perf_counter() - t0
    points = pcd.read_pcd(str(out / "map.pcd"))
    # kernel 1 at the map's shape (the union of the keyframe clouds, padded
    # to a power of two, 0.05 m), against its twin
    union = map_cloud.map_union([k.cloud for k in backend.keyframes], [k.estimate for k in backend.keyframes])
    map_cap = min(1 << 20, union.cap)
    k1 = lambda: prefilter.voxel_downsample(union, 0.05, map_cap)  # noqa: E731
    p1 = lambda: prefilter.voxel_downsample_ref(union, 0.05, map_cap)  # noqa: E731
    got, want = k1(), p1()
    err = float((got.xyz - want.xyz).abs().max())
    if not torch.equal(got.mask, want.mask) or err > 1e-5 + 1e-6 * float(want.xyz[want.mask].abs().max()):
        raise AssertionError(f"voxel_downsample at the map's shape: masks differ or error {err}")
    if not identical_clouds(torch, on_cpu(got), prefilter.voxel_downsample_ref(on_cpu(union), 0.05, map_cap)):
        raise AssertionError("voxel_downsample at the map's shape: not bit-identical to the twin on a CPU copy")
    map_records = {}
    n_union = int(union.mask.sum())
    # each valid point read once (12 + 4 bytes), one mask byte per lane, each
    # output lane written once (17 bytes); ~8 operations per valid point
    measure(torch, map_records, "voxel_downsample", k1, p1, err, 16 * n_union + union.cap + 17 * map_cap,
            8 * n_union)
    log(f"  voxel_downsample at the map's shape: {n_union} points in {union.cap} lanes -> "
        f"{int(got.mask.sum())} voxels, identical voxels and order, centroids within {err:.3g} of the card's twin "
        f"and bit-identical to the twin on a CPU copy")
    backend.save_pose(str(out))
    kf_rows = kitti.read_pose_file(str(out / "ggo_kf_odom.txt")).shape[0]
    wf_rows = kitti.read_pose_file(str(out / "ggo_wf_odom.txt")).shape[0]
    log(f"  dump {len(files)} entries in {t_dump:.2f} s; load_dump {len(loaded.keyframes)} keyframes in "
        f"{t_load:.2f} s; "
        f"re-optimized in {int(result.iterations)} iterations ({t_opt:.2f} s, chi2 {float(result.chi2_before):.4f} -> "
        f"{float(result.chi2_after):.4f}; the dumped graph's chi2 there {float(orig.chi2_before):.6g}, relative "
        f"difference {d_chi2:.3g}, tol 1e-4), largest pose change {moved:.3g} from the dumped estimates (tol 1e-3), "
        f"{same:.3g} from the dumped graph solved again (tol 1e-3); map {points.shape[0]} points "
        f"at 0.05 m in {t_map:.2f} s (cap {1 << 20}), offset by zero_utm; pose files {kf_rows} keyframe and "
        f"{wf_rows} scan rows ({card})")
    if d_chi2 > 1e-4 or same > 1e-3 or moved > 1e-3:
        raise AssertionError("the resumed graph's factors or re-optimized poses depart from the dumped graph's")
    if not 0 < points.shape[0] <= 1 << 20 or kf_rows != len(backend.keyframes) or wf_rows != len(backend.odoms):
        raise AssertionError("save_map or save_pose wrote the wrong number of rows")
    return dict(dump_s=t_dump, load_s=t_load, reoptimize_iterations=int(result.iterations), max_pose_change=moved,
                vs_dumped_graph_resolved=same, chi2_rel_diff=d_chi2,
                map_points=int(points.shape[0]), map_s=t_map, pose_rows=[kf_rows, wf_rows],
                map_voxel_downsample=map_records["voxel_downsample"])


DOUBLE_N = 160  # tests/test_multi_loop.py's double circle: 160 VLP-16 scans, two 80 m laps
# The JAX reference's record of phase 9d's run (its CPU run of the same feed;
# `scripts/reference_circle.py double` makes it)
JAX_DOUBLE = dict(keyframes=54, loops=[(66, 0), (87, 6), (108, 27), (129, 48), (150, 69)],
                  loop_rejections=dict(verified=33, bow_rejected=0, guess_rejected=0, fitness_rejected=0),
                  tail_err_odom_m=0.7669, tail_err_graph_m=0.0551)


def _simulate_double(i: int) -> np.ndarray:
    from lv_slam_tpu_torch.io import synthetic

    gt = synthetic.circle_trajectory(DOUBLE_N, step=1.0, laps=2)
    return synthetic.simulate_scan(synthetic.make_world(seed=9), gt[i], synthetic.vlp16_rays(16, 600), seed=9 + i)


def run_double_circle(torch, dev, card):
    """Phase 9d: `tests/test_multi_loop.py`'s double circle through the raw
    feed on the card (drifting odometry, chunks of 16, an optimize after
    each), held to the JAX reference's record of the same run."""
    from lv_slam_tpu_torch.config import GraphConfig, LoopDetectorConfig, PrefilterConfig
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.io import synthetic
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.pipeline.backend import GlobalGraph

    gt = synthetic.circle_trajectory(DOUBLE_N, step=1.0, laps=2)
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        scans = pool.map(_simulate_double, range(DOUBLE_N))
    log(f"  simulated {DOUBLE_N} VLP-16 scans in {time.perf_counter() - t0:.1f} s")
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float64)
    rels = np.einsum("nij,njk->nik", np.linalg.inv(gt_rel[:-1]), gt_rel[1:])
    c, s_ = np.cos(5e-4), np.sin(5e-4)
    bias = np.array([[c, -s_, 0, 0], [s_, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    odom = [np.eye(4)]
    for r in rels:
        r = r.copy()
        r[:3, 3] *= 1.004
        odom.append(odom[-1] @ (bias @ r))
    odom = np.stack(odom)
    loop_cfg = LoopDetectorConfig(distance_thresh=15.0, accum_distance_thresh=60.0, min_edge_interval=20.0,
                                  fitness_score_thresh=0.5, auto_train_vocab=False)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_run = GlobalGraph(GraphConfig(keyframe_cap=64, edge_cap=256, prior_cap=16, keyframe_delta_trans=3.0,
                                       solver_num_iterations=32), loop_cfg, keyframe_cloud_cap=16384,
                           prefilter_cfg=PrefilterConfig(raw_cap=8192, out_cap=8192), device=dev)
    clouds = [PointCloud.from_numpy(sc, cap=8192, device=dev) for sc in scans]
    for s in range(0, DOUBLE_N, 16):
        e = min(s + 16, DOUBLE_N)
        chunk = PointCloud(*(torch.stack([getattr(cl, f) for cl in clouds[s:e]])
                             for f in ("xyz", "intensity", "mask")))
        card_run.add_scan_batch(s, np.arange(s, e) * 0.1, odom[s:e], chunk)
        card_run.optimize()
    card_run.finish()
    card_run.drain()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = KERNELS["window_group_fn"].launches
    loops = [(lp.key1.seq, lp.key2.seq) for lp in card_run.loops]
    stats = dict(card_run.loop_detector.stats)
    accums = sorted(lp.key1.accum_distance for lp in card_run.loops)
    truth = np.stack([gt_rel[k.seq][:3, 3] for k in card_run.keyframes])
    err_odom = np.linalg.norm(np.stack([k.odom[:3, 3] for k in card_run.keyframes]) - truth, axis=1)
    err_est = np.linalg.norm(np.stack([k.estimate[:3, 3] for k in card_run.keyframes]) - truth, axis=1)
    tail = slice(len(err_odom) // 2, None)
    log(f"  card: {len(card_run.keyframes)} keyframes, loops {loops}, loop_rejections {stats}, tail error "
        f"odometry {err_odom[tail].mean():.4f} m -> graph {err_est[tail].mean():.4f} m; {DOUBLE_N} scans in "
        f"{elapsed:.2f} s ({card}), K2r launches {launches}")
    log(f"  the JAX reference's record of this run (CPU): {JAX_DOUBLE}")
    if len(loops) < 3 or any(b - a < loop_cfg.min_edge_interval - 1e-6 for a, b in zip(accums, accums[1:])):
        raise AssertionError("the double circle must close three or more loops spaced by the interval gate")
    if stats["verified"] <= 2 * len(loops) or not err_est[tail].mean() < 0.6 * err_odom[tail].mean():
        raise AssertionError("the double circle's verifications or its tail error fail the reference test's gates")
    if len(card_run.keyframes) != JAX_DOUBLE["keyframes"] or loops != JAX_DOUBLE["loops"] \
            or stats != JAX_DOUBLE["loop_rejections"]:
        raise AssertionError("the double circle's keyframes, loops or loop counters differ from the JAX record's")
    return dict(keyframes=len(card_run.keyframes), loops=loops, loop_rejections=stats,
                tail_err_odom_m=err_odom[tail].mean(), tail_err_graph_m=err_est[tail].mean(), seconds=elapsed,
                window_group_launches=launches)


# ----------------------------------------------------------------- phase 2h and phase 10

PAIR = (40, 41)  # phase 10's consecutive circle scans
PAIR_PERTURBATION = [0.12, -0.08, 0.03, 0.01, -0.01, 0.02]  # tests/test_registrations.py's guess, on the true step
# tests/test_registrations.py's methods and translation bounds
FACTORY = (("NDT_OMP", "DIRECT7", 0.06), ("NDT_PCA", "DIRECT1", 0.06), ("ICP", "DIRECT7", 0.25),
           ("GICP", "DIRECT7", 0.10))
# the factory's card results held to the plain path on the card: the NDT
# methods run deterministic kernels (K3, K3L) and K6G, whose sums run in
# another order: DIRECT7 unweighted to 1e-4 (as phase 8d), DIRECT1 weighted
# to phase 8's CPU_SPREAD_M (its Newton steps near the optimum are accepted
# or rejected on the score's last bits: 2.07e-3 m apart on the H100; the
# reference's own one-ulp spread of NDT_PCA on tests/test_registrations.py's
# pair is 15.7 mm). ICP's 40 and GICP's 20
# iterations carry their block sums' last bits and ICP's float64 Kabsch SVD
# against the twin's float32 one (the reference's own one-ulp spread on the
# tests' pair: 0.33 mm and 2.5 mm, `scripts/reference_spread.py icp|gicp`)
FACTORY_TOL = {"NDT_OMP": 1e-4, "NDT_PCA": 1e-2, "ICP": 1e-3, "GICP": 3e-3}
REGISTRATION_KERNELS = ("nn_points", "_plane_covariances", "gicp_align")  # K17, K19a, K19b (phase 10a)
BRANCH_KERNELS = ("radius_outlier_removal", "statistical_outlier_removal", "vertical_angle_calibration")  # 10c


def _band_edge(rng, radius: float, n: int) -> np.ndarray:
    """n points at `radius` in random directions, each coordinate then moved
    by -4 to +4 ulps: |p| lies within a few ulps of the band edge."""
    d = rng.normal(size=(n, 3))
    p = (d / np.linalg.norm(d, axis=1, keepdims=True) * radius).astype(np.float32)
    steps = rng.integers(-4, 5, p.shape)
    for k in range(4):
        p = np.where(steps > k, np.nextafter(p, np.float32(np.inf)), p)
        p = np.where(steps < -k, np.nextafter(p, np.float32(-np.inf)), p)
    return p.astype(np.float32)


FRONT_ANGLES = (0.11, 1.7)  # degrees: the reference's calibration and a larger one


def front_cases(seed: int = SEED):
    """[(name, points (n, 3) float32, cap)] for the prefilter's front (K0a:
    the calibration, the band, both): lidar-range points with points on and
    near the z axis (no rotation axis: the full form of R), x and y of 1e-30
    (products that underflow), zeros of both signs and a NaN row (masked by
    `PointCloud.from_numpy`); clouds whose calibrated |p| lies within ulps of
    the band's edges; odd capacities; every lane masked; 3 lanes."""
    rng = np.random.default_rng(seed)
    lidar = np.concatenate([
        rng.uniform(-60.0, 60.0, (20000, 3)),
        rng.normal(0.0, 1.0, (500, 3)) * [0.0, 0.0, 1.0],
        rng.uniform(-1.0, 1.0, (500, 3)) * 1e-3,
        np.concatenate([rng.uniform(-1.0, 1.0, (200, 2)) * 1e-30, rng.uniform(1.0, 50.0, (200, 1))], 1),
        [[0.0, 0.0, 5.0], [-0.0, 0.0, 5.0], [0.0, -0.0, -5.0], [-0.0, -0.0, 0.0], [3.0, -0.0, 1.0], [-0.0, 7.0, 1.0]],
        [[np.nan, 1.0, 2.0]],
    ]).astype(np.float32)
    lidar = lidar[rng.permutation(len(lidar))]
    return [
        ("lidar range, the z axis, near it, underflowing x and y, signed zeros, a NaN row", lidar, len(lidar) + 3),
        ("|p| within ulps of 0.5 m", _band_edge(rng, 0.5, 20000), 20001),
        ("|p| within ulps of 100 m", _band_edge(rng, 100.0, 20000), 20002),
        ("every lane masked", np.zeros((0, 3), np.float32), 1027),
        ("3 lanes", rng.uniform(-60.0, 60.0, (3, 3)).astype(np.float32), 3),
    ]


def check_front_cases(torch, dev) -> int:
    """Every `front_cases` entry through each form of the prefilter's front
    (the calibration at FRONT_ANGLES, the band, both), bit for bit its twins
    on the card; so is a slice of a cloud one lane off the 16-byte boundary
    (the main path passes `xyz[i]` slices of a chunk). Returns the number of
    cases."""
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.ops import prefilter

    near, far = 0.5, 100.0
    forms = [(f"calibration at {a} degrees", lambda c, a=a: prefilter.vertical_angle_calibration(c, a),
              lambda c, a=a: prefilter.vertical_angle_calibration_ref(c, a)) for a in FRONT_ANGLES]
    forms.append(("band", lambda c: prefilter.distance_filter(c, near, far),
                  lambda c: prefilter.distance_filter_ref(c, near, far)))
    forms += [(f"calibration at {a} degrees and band", lambda c, a=a: prefilter.calibrated_band(c, a, near, far),
               lambda c, a=a: prefilter.calibrated_band_ref(c, a, near, far)) for a in FRONT_ANGLES]
    cases = front_cases()
    pts, cap = cases[0][1], cases[0][2]
    wide = PointCloud.from_numpy(pts, cap=cap + 1, device=dev)
    clouds = [(name, PointCloud.from_numpy(pts, cap=cap, device=dev)) for name, pts, cap in cases]
    clouds.append((f"{cases[0][0]}, one lane off the 16-byte boundary",
                   PointCloud(wide.xyz[1:], wide.intensity[1:], wide.mask[1:])))
    for name, cloud in clouds:
        for form, kernel, plain in forms:
            if not identical_clouds(torch, kernel(cloud), plain(cloud)):
                raise AssertionError(f"prefilter front ({form}) on front_cases {name!r}: not bit for bit its twins")
    return len(cases)


def registration_pair(torch, scans, gt, dev):
    """Phase 10's pair on `dev`: scans 40 and 41 through the flagship
    prefilter (131072 lanes), their true relative pose and
    tests/test_registrations.py's perturbed guess on it."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.ops import prefilter

    pf = kitti_flagship_config().prefilter
    target, source = (prefilter.prefilter(PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev), pf)
                      for i in PAIR)
    rel = np.linalg.inv(gt[PAIR[0]]) @ gt[PAIR[1]]
    pert = se3.exp_se3(torch.tensor(PAIR_PERTURBATION, dtype=torch.float32, device=dev))
    guess = (pert @ torch.from_numpy(rel.astype(np.float32)).to(dev)).contiguous()
    return target, source, rel, guess


def check_registration_kernels(torch, scans, gt, dev):
    """Phase 2h: kernels 17-20 and 0a vs their plain versions at phase 10's
    shapes: K17 (nn_points, one ICP iteration), K9g's two grids (bit for
    bit, the target's timed as the `gicp` entry of K9g's record), K9k's
    `knn` at GICP's three calls (bit for bit, timed as the `gicp` entry of
    K9k's record), K19a (the source's covariances, and the target's at the
    matches on K19b's lanes, timed beside the same call on every lane) and
    K19b (one GICP normal-equation pass) on scan 41's 131072 lanes against
    scan 40 at the guess, K18 (both removals) and K20 on scan 40 (filtered;
    its 10 m map with a 64^3 LUT), K0a's three forms (the calibration of raw
    scan 40, the band of raw scan 0, both in one pass on raw scan 40; the
    band's torch chain timed and its launches counted), bit for bit their
    twins there and on `front_cases`."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.ops import gicp, icp, knn, ndt_ground, nn, prefilter, voxel_map

    pf = kitti_flagship_config().prefilter
    target, source, _, guess = registration_pair(torch, scans, gt, dev)
    records = {}
    src, mask = source.masked_xyz().contiguous(), source.mask.contiguous()
    n_src = int(mask.sum())
    y = se3.transform_points_fma(guess, src)

    # kernel 17: the nearest centroids of the moved source, then one ICP
    # iteration (the match, the sums, the Kabsch update)
    grid = nn.build_centroid_grid(target, 0.25)
    got, want = nn.nn_points(grid, y, mask), nn.nn_points_ref(grid, y, mask)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("nn_points: distances, matches or validity differ from the plain version")
    hit, leaf = nn._probe27(grid, y)
    n_touched = int(torch.unique(leaf[hit & mask[:, None]]).numel())
    steps = int(np.ceil(np.log2(grid.keys.shape[0] + 1)))
    log(f"  nn_points: {int(want[2].sum())} of {n_src} source points matched among {int((grid.counts > 0).sum())} "
        f"leaves ({n_touched} touched); distances, matches and validity identical to the plain version")
    k17 = lambda: icp.icp_step(grid, src, mask, guess, 4.0)  # noqa: E731
    p17 = lambda: icp.icp_step_ref(grid, src, mask, guess, 4.0)  # noqa: E731
    t_k, t_p = k17(), p17()
    (fit_k, n_k), (fit_p, n_p) = icp.icp_fitness(grid, src, mask, guess, 4.0), icp.icp_fitness_ref(
        grid, src, mask, guess, 4.0)
    err = float((t_k - t_p).abs().max())
    err_fit = abs(float(fit_k) - float(fit_p)) / abs(float(fit_p))
    log(f"  one ICP iteration: transform within {err:.3g} of the plain version (tol 1e-5), fitness within "
        f"{err_fit:.3g} (tol 1e-5 relative), matches {int(n_k)} / {int(n_p)}")
    if err > 1e-5 or err_fit > 1e-5 or int(n_k) != int(n_p):
        raise AssertionError("the ICP iteration departs from its plain version")
    # bytes: the mask of every lane, the masked-in source points, each touched
    # leaf's key and centroid, the transforms; operations per masked-in lane:
    # 9 column searches (3 per step), 10 per cell's hit test and distance,
    # ~60 for the move, the sums and the centred second pass
    measure(torch, records, "nn_points", k17, p17, err, nbytes(mask, guess) + 12 * n_src + 16 * n_touched + 64,
            n_src * (9 * 3 * steps + 27 * 10 + 60))

    # kernel 18: both removals on the filtered target, one leaf per lane
    for name, args, ops in (("radius_outlier_removal", (pf.radius_radius, pf.radius_min_neighbors), 10),
                            ("statistical_outlier_removal", (pf.statistical_mean_k, pf.statistical_stddev), 40)):
        kernel, plain = getattr(nn, name), getattr(nn, f"{name}_ref")
        got, want = kernel(target, *args), plain(target, *args)
        torch.cuda.synchronize()
        if not (torch.equal(got.mask, want.mask) and torch.equal(got.xyz, want.xyz)):
            raise AssertionError(f"{name}: {int((got.mask != want.mask).sum())} lanes differ from the plain version")
        n_in, n_kept = int(target.mask.sum()), int(got.mask.sum())
        log(f"  {name}: {n_in} points -> {n_kept} kept ({n_in - n_kept} dropped), mask and points identical")
        # bytes: the mask of every lane, the masked-in points, 8 bytes of the
        # grid per masked-in point, the cloud out
        measure(torch, records, name, lambda k=kernel, a=args: k(target, *a), lambda p=plain, a=args: p(target, *a),
                0.0, nbytes(target.mask, got.xyz, got.mask) + 20 * n_in,
                n_in * (9 * 3 * int(np.ceil(np.log2(target.cap + 1))) + 27 * 3 + ops))

    # kernel 0a, the prefilter's front: the calibration, the band (the main
    # path's, at phase 3's raw shape) and the two in one pass, each bit for
    # bit its twins on the raw scans and on `front_cases`, and timed
    raw = PointCloud.from_numpy(scans[PAIR[0]], cap=pf.raw_cap, device=dev)
    n_raw = int(raw.mask.sum())
    near, far, angle = pf.distance_near_thresh, pf.distance_far_thresh, pf.angle_base
    raw3 = PointCloud.from_numpy(scans[0], cap=pf.raw_cap, device=dev)
    fronts = (("vertical_angle_calibration", raw, lambda c: prefilter.vertical_angle_calibration(c, angle),
               lambda c: prefilter.vertical_angle_calibration_ref(c, angle)),
              ("distance_filter", raw3, lambda c: prefilter.distance_filter(c, near, far),
               lambda c: prefilter.distance_filter_ref(c, near, far)),
              ("calibrated_band", raw, lambda c: prefilter.calibrated_band(c, angle, near, far),
               lambda c: prefilter.calibrated_band_ref(c, angle, near, far)))
    out0, out1, out2 = (kernel(cloud) for _, cloud, kernel, _ in fronts)
    for (name, cloud, _, plain), got in zip(fronts, (out0, out1, out2)):
        if not identical_clouds(torch, got, plain(cloud)):
            raise AssertionError(f"{name}: not bit for bit its twins on the card")
    n_cases = check_front_cases(torch, dev)
    kept = int(out2.mask.sum())
    log(f"  the prefilter's front (K0a): the calibration of raw scan {PAIR[0]} ({n_raw} points at {angle} degrees), "
        f"the band of raw scan 0 ({int(raw3.mask.sum())} points) and both in one pass ({kept} kept) bit for bit their "
        f"twins on the card; the {n_cases} front_cases too")
    # bytes: the mask of every lane and the point of each masked-in lane read,
    # the point (and the keep flag) of every lane written; operations per
    # masked-in lane: ~70 for the calibration (its float64 fmas and their
    # conversions), 7 for |p|
    n_raw3 = int(raw3.mask.sum())
    measure(torch, records, "vertical_angle_calibration", lambda: fronts[0][2](raw), lambda: fronts[0][3](raw), 0.0,
            nbytes(raw.mask, out0.xyz) + 12 * n_raw, 70 * n_raw)
    measure(torch, records, "distance_filter", lambda: fronts[1][2](raw3), lambda: fronts[1][3](raw3), 0.0,
            nbytes(raw3.mask, out1.xyz, out1.mask) + 12 * n_raw3, 7 * n_raw3)
    _, records["distance_filter"]["plain_launches"] = foreign_functions(torch, lambda: fronts[1][3](raw3), ())
    records["vertical_angle_calibration"]["with_band"] = timed(
        torch, "vertical_angle_calibration", lambda: fronts[2][2](raw), lambda: fronts[2][3](raw), 0.0,
        nbytes(raw.mask, out2.xyz, out2.mask) + 12 * n_raw, 77 * n_raw, " with the band (one pass)")
    log(f"    the band's torch chain (distance_filter_ref): {records['distance_filter']['plain_launches']} device "
        f"launches a call")

    # kernel 9k at GICP's shapes, a thread a query over a 1024-key sample of
    # each 131072-lane grid's keys (phase 2e reaches that path only on
    # smaller grids): the source's covariance neighbours (k = 8), the
    # matches at the guess (k = 1) and the matches' neighbourhoods (k = 8),
    # every output bit for bit the twin's on the card
    src_grid = knn.build_grid(src, mask, 1.0)
    tgt_xyz, tgt_mask = target.masked_xyz(), target.mask
    tgt_grid = knn.build_grid(tgt_xyz, tgt_mask, 1.0)
    # kernel 9g at GICP's shapes (131072 lanes at 1 m: the key sort's route),
    # both grids bit for bit the twin's, the target's timed
    for what, g, x, m in (("source", src_grid, src, mask), ("target", tgt_grid, tgt_xyz, tgt_mask)):
        want = knn.build_grid_ref(x, m, 1.0)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(g[:3], want[:3])):
            raise AssertionError(f"build_grid at GICP's shapes ({what}): keys, points' bits or origin differ from the "
                                 f"plain version")
        log(f"  build_grid at GICP's shapes ({what}: {int(m.sum())} valid of {m.numel()} lanes at 1 m): keys, point "
            f"order and origin identical to the plain version")
    k9g = lambda: knn.build_grid(tgt_xyz, tgt_mask, 1.0)  # noqa: E731
    records["_grid_gicp"] = timed(torch, "build_grid", k9g, lambda: knn.build_grid_ref(tgt_xyz, tgt_mask, 1.0), 0.0,
                                  nbytes(tgt_xyz, tgt_mask, *tgt_grid[:3]), 15 * tgt_xyz.shape[0],
                                  " at GICP's shapes (the target)")
    key9g, _ = knn._grid_keys_ref(tgt_xyz, tgt_mask, 1.0)
    _, records["_grid_gicp"]["torch_sort_ms"], _ = device_ms(torch, lambda: torch.sort(key9g, stable=True))
    log(f"    torch.sort(stable=True) of the twin's {key9g.numel()} int32 keys: "
        f"{records['_grid_gicp']['torch_sort_ms']:.4f} ms device-only")
    matched = knn.knn(tgt_grid, y, 1)[1][:, 0].contiguous()
    gicp_knn = (("the source's covariances", src_grid, src, 8), ("the matches", tgt_grid, y, 1),
                ("the matches' neighbourhoods", tgt_grid, matched, 8))
    k9k = lambda: [knn.knn(g, q, k) for _, g, q, k in gicp_knn]  # noqa: E731
    p9k = lambda: [knn.knn_ref(g, q, k) for _, g, q, k in gicp_knn]  # noqa: E731
    got_knn, want_knn = k9k(), p9k()
    torch.cuda.synchronize()
    n_bytes, n_ops = 0, 0
    for (what, g, q, k), got, want in zip(gicp_knn, got_knn, want_knn):
        if not all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b) for a, b in zip(got, want)):
            raise AssertionError(f"knn at GICP's shapes ({what}, k = {k}): dists, points or valid differ from the "
                                 f"plain version")
        # operations this data needs, as phase 2e counts them: per query 27
        # binary searches (3 per step), 2 per candidate slot, 9 per hit's
        # squared distance
        steps = int(np.ceil(np.log2(g.keys.shape[0] + 1)))
        n_hits = int(knn.knn_candidates(g, q)[1].sum())
        n_ops += q.shape[0] * (27 * 3 * steps + 27 * 8 * 2) + 9 * n_hits
        n_bytes += nbytes(*g[:3], q, *got)
        log(f"  knn at GICP's shapes ({what}, k = {k}, {q.shape[0]} queries on {g.keys.shape[0]} lanes): valid "
            f"{int(got[2].sum())} of {got[2].numel()}; dists' bits, points and valid identical to the plain version")
    records["_knn_gicp"] = timed(torch, "knn", k9k, p9k, 0.0, n_bytes, n_ops, " at GICP's shapes (the three calls)")

    # kernel 19a: the source's covariances from its 8 grid neighbours
    _, pts, valid = got_knn[0]
    k19a = lambda: gicp.regularized_covariances(pts, valid, mask)  # noqa: E731
    p19a = lambda: gicp.regularized_covariances_ref(pts, valid, mask)  # noqa: E731
    (cov_k, ok_k), (cov_p, ok_p) = k19a(), p19a()
    if not torch.equal(ok_k, ok_p):
        raise AssertionError("_plane_covariances: the ok flags differ from the plain version")
    e = gicp.plane_covariance_error(cov_k, cov_p, pts, valid, ok_p)
    err = e.max_diff
    log(f"  _plane_covariances: ok identical ({int(ok_p.sum())} of {n_src}); {e.n_gap} lanes with a relative "
        f"eigen-gap above sqrt(eps) within {err:.3g}, {e.n_identical} identical, largest difference "
        f"times the gap {e.envelope:.3g} (tol {gicp.PLANE_ENVELOPE}); {e.n_repeated} repeated-pair lanes keep the "
        f"plane shape to {e.shape_err:.3g} (tol {gicp.SHAPE_TOL})")
    if not e.ok:
        raise AssertionError("_plane_covariances departs from its plain version")
    # bytes: the mask of every lane, the 8 flags and the valid neighbours of a
    # masked-in lane, the covariances and flags out
    n_nbrs = int(valid[mask].sum())
    measure(torch, records, "_plane_covariances", k19a, p19a, err,
            nbytes(mask, cov_k, ok_k) + 8 * n_src + 12 * n_nbrs, 600 * n_src)

    # kernel 19a's target call, as gicp_align makes it: the covariances at
    # the matches' neighbourhoods on the lanes that K19b reads (its lane
    # test), the identity elsewhere; bit for bit the every-lane call there
    dists, nn_pts, nn_valid = got_knn[1]
    _, nbrs, nbr_valid = got_knn[2]
    need = gicp.LaneTest(mask & ok_k, nn_valid[:, 0].contiguous(), dists[:, 0].contiguous(), 2.0)
    k19t = lambda: gicp.regularized_covariances(nbrs, nbr_valid, need=need)  # noqa: E731
    p19t = lambda: gicp.regularized_covariances_ref(nbrs, nbr_valid, need=need)  # noqa: E731
    every = lambda: gicp.regularized_covariances(nbrs, nbr_valid)  # noqa: E731
    (cov_b, _), (cov_t, _), (cov_e, _) = k19t(), p19t(), every()
    lanes = need.lanes()
    n_need = int(lanes.sum())
    if not (torch.equal(cov_b[lanes].view(torch.int32), cov_e[lanes].view(torch.int32))
            and bool((cov_b[~lanes] == torch.eye(3, device=dev)).all())):
        raise AssertionError("_plane_covariances' target call: not the every-lane call's bits on its lanes, or not "
                             "the identity elsewhere")
    e = gicp.plane_covariance_error(cov_b, cov_t, nbrs, nbr_valid, lanes)
    log(f"  _plane_covariances' target call: {n_need} of {n_src} lanes pass K19b's test; there bit for bit the "
        f"every-lane call, the identity elsewhere; against the plain version {e.n_identical} of {e.n_gap} gapped lanes "
        f"identical, largest difference times the gap {e.envelope:.3g} (tol {gicp.PLANE_ENVELOPE}), {e.n_repeated} "
        f"repeated-pair lanes keep the plane shape to {e.shape_err:.3g}")
    if not e.ok:
        raise AssertionError("_plane_covariances' target call departs from its plain version")
    # bytes: src_ok of every lane, nn_valid where it is set, nn_dist where
    # both are, the 8 flags and the valid neighbours of a needed lane, the
    # covariances out
    n_src_ok, n_nn = int(need.src_ok.sum()), int((need.src_ok & need.nn_valid).sum())
    n_nbrs = int(nbr_valid[lanes].sum())
    target_rec = timed(torch, "_plane_covariances", k19t, p19t, e.max_diff,
                   lanes.numel() + n_src_ok + 4 * n_nn + 8 * n_need + 12 * n_nbrs + nbytes(cov_b), 600 * n_need,
                   " the target call (K19b's lanes)")
    target_rec["every_lane_ms"], _, _ = device_ms(torch, every, DEVICE_FUNCTIONS["_plane_covariances"])
    log(f"    the same call on every lane (the earlier target route): {target_rec['every_lane_ms']:.4f} ms")
    records["_plane_covariances"]["target_call"] = target_rec

    # kernel 19b: one normal-equation pass at the guess, the target's matches
    args = (src, mask & ok_k, cov_k, guess, nn_pts[:, 0].contiguous(), dists[:, 0].contiguous(),
            nn_valid[:, 0].contiguous(), cov_b, 2.0)
    k19b = lambda: gicp.gicp_normal_equations(*args)  # noqa: E731
    p19b = lambda: gicp.gicp_normal_equations_ref(*args)  # noqa: E731
    (h_k, g_k), (h_p, g_p) = k19b(), p19b()
    eh = float((h_k - h_p).abs().max()) / float(h_p.abs().max())
    eg = float((g_k - g_p).abs().max()) / float(g_p.abs().max())
    n_src_ok, n_nn = int(args[1].sum()), int((args[1] & args[6]).sum())
    n_ok = int((args[1] & args[6] & (args[5] < 2.0)).sum())
    log(f"  gicp_align (normal equations): {n_ok} matched lanes; H within {eh:.3g} and g within {eg:.3g} of their "
        f"scale (tol 1e-5)")
    if eh > 1e-5 or eg > 1e-5:
        raise AssertionError("gicp_align's normal equations depart from the plain version")
    # bytes: the ok flag of every lane, the match's flag where ok and its
    # distance where matched, 96 bytes of a lane within the distance (its
    # point, its match, both covariances), the transform's 3x4, H and g out
    measure(torch, records, "gicp_align", k19b, p19b, max(eh, eg),
            nbytes(args[1]) + n_src_ok + 4 * n_nn + 96 * n_ok + 48 + 42 * 4, 350 * n_ok)

    # kernel 20: the ground filter of the target's 10 m map (64^3 LUT)
    vm = voxel_map.build_voxel_map(target, 10.0, leaf_cap=4096, lut_extent=64)
    lut = voxel_map.build_lut(vm)
    k20 = lambda: ndt_ground.filter_ground_leaves(vm, lut)  # noqa: E731
    p20 = lambda: ndt_ground.filter_ground_leaves_ref(vm, lut)  # noqa: E731
    (gm, gl), (wm, wl) = k20(), p20()
    if not (torch.equal(gl, wl) and torch.equal(gm.valid, wm.valid)):
        raise AssertionError("filter_ground_leaves: the LUT or the flags differ from the plain version")
    log(f"  filter_ground_leaves: {int(vm.valid.sum())} valid leaves -> {int(gm.valid.sum())} ground; LUT "
        f"({lut.numel()}) and flags identical")
    measure(torch, records, "filter_ground_leaves", k20, p20, 0.0,
            nbytes(lut, vm.valid, vm.normals, gl, gm.valid), 3 * lut.numel())
    return records


def _alpha64(ndt, state, lane: int, step_min: float):
    """Lane `lane`'s next step length from its state after a step, solved in
    float64 on the host (the 6x6 system rounded to float32 first, as the
    kernel takes it), and the system's condition number."""
    f = state.f[lane].double().cpu().numpy()
    g, h = f[ndt.F_GRAD:ndt.F_GRAD + 6], f[ndt.F_HESS:ndt.F_HESS + 36].reshape(6, 6)
    ridge = np.float32(1e-6) * np.float32(np.abs(np.diag(h)).sum()) / np.float32(6.0) + np.float32(1e-12)
    a = (h + ridge * np.eye(6)).astype(np.float32).astype(np.float64)
    norm = float(np.linalg.norm(np.linalg.solve(a, -g)))
    return min(max(norm, step_min), float(f[ndt.F_CAP])), float(np.linalg.cond(a))


def compare_step(torch, ndt, state, twin, running, p):
    """One `newton_step` (`state`) against `newton_step_ref` (`twin`) from
    identical states with the same sums, held as `newton_steps` says;
    `running` the lanes not done before the step. Returns (flag flips,
    largest candidate difference to the twin, largest relative alpha
    difference to float64)."""
    flips = 0
    worst_twin = worst64 = 0.0
    same_cols = ((ndt.F_T, ndt.F_T + 16), (ndt.F_SCORE, ndt.F_HESS + 36), (ndt.F_CAP, ndt.F_CAP + 1))
    if not torch.equal(state.s[:, ndt.S_IT], twin.s[:, ndt.S_IT]):
        raise AssertionError(f"newton_step: iteration counts {state.s[:, ndt.S_IT].tolist()} vs the twin's "
                             f"{twin.s[:, ndt.S_IT].tolist()}")
    # a NaN start: the lane is done at iteration 0 with its NaN score in both
    nan_start = (torch.isnan(state.f[:, ndt.F_SCORE]) & torch.isnan(twin.f[:, ndt.F_SCORE])
                 & (state.s[:, ndt.S_IT] == 0) & (state.s[:, ndt.S_DONE] == 1) & (twin.s[:, ndt.S_DONE] == 1))
    got_f, want_f = state.f.clone(), twin.f.clone()
    got_f[nan_start, ndt.F_SCORE] = want_f[nan_start, ndt.F_SCORE] = 0.0
    for lo, hi in same_cols:
        if not torch.equal(got_f[:, lo:hi], want_f[:, lo:hi]):
            raise AssertionError(f"newton_step: state columns {lo}:{hi} differ from the twin's")
    for c in range(state.k):
        if not running[c]:
            continue
        flags, twin_flags = state.s[c, [ndt.S_DONE, ndt.S_BAD]].tolist(), twin.s[c, [ndt.S_DONE, ndt.S_BAD]].tolist()
        alpha = float(state.f[c, ndt.F_ALPHA])
        if flags != twin_flags:
            near = min(abs(alpha - p.eps) / p.eps, abs(alpha - p.step_min) / p.step_min)
            if near > 1e-5:
                raise AssertionError(f"newton_step: done / bad {flags} vs the twin's {twin_flags}, alpha {alpha}")
            flips += 1
            continue
        if any(flags):
            continue
        cand = state.f[c, ndt.F_CAND:ndt.F_CAND + 16]
        twin_cand = twin.f[c, ndt.F_CAND:ndt.F_CAND + 16]
        alpha64, cond = _alpha64(ndt, state, c, p.step_min)
        e64, et = abs(alpha - alpha64) / alpha64, float((cand - twin_cand).abs().max())
        if e64 > 1e-5 or et > 1e-6 + 2.0**-23 * cond * alpha64:
            raise AssertionError(f"newton_step: alpha {e64} from float64's (tol 1e-5), candidate {et} from the "
                                 f"twin's (condition number {cond:.3g})")
        worst64, worst_twin = max(worst64, e64), max(worst_twin, et)
    return flips, worst_twin, worst64


def newton_steps(torch, ndt, state, pass_, sums_at, p):
    """Steps `state` to done one kernel iteration at a time; before each
    step a copy takes `newton_step_ref` with the same derivative sums
    (`sums_at(candidates)`: the pass and `ndt_finish`, the order
    `newton_step` sums in). Per lane the iteration count, the accepted
    transform, score, gradient, Hessian and cap must be identical (a lane
    with a NaN start may hold its NaN score, where the twin holds one too);
    `done`
    and `bad` too, except where alpha lies within the solves' rounding of
    eps or eps / 2 (counted); a running lane's step length alpha within
    1e-5 (relative) of the step solved in float64 (`_alpha64`), and its
    candidate within 1e-6 plus the twin's float32 solve error (2^-23 times
    the condition number times alpha) of the twin's. (A float64 candidate
    is no yardstick: the reference's float32 exp_se3 takes (1 - cos t) / t^2,
    which one ulp of cos moves by 6e-8 / t^2, up to ~1e-5 of the step at
    t ~ 1e-3 rad; kernel and twin share CUDA's cosf.) Returns (steps, flag
    flips, largest candidate difference to the twin, largest relative alpha
    difference to float64)."""
    steps = flips = 0
    worst_twin = worst64 = 0.0
    while not state.all_done():
        twin = state.clone()
        running = (state.s[:, ndt.S_DONE] == 0).tolist()
        sums = sums_at(twin.f[:, ndt.F_CAND:ndt.F_CAND + 16].reshape(state.k, 4, 4).contiguous())
        pass_.launch(state)
        ndt.newton_step(state, pass_.n_blocks, p)
        ndt.newton_step_ref(twin, *sums, p)
        steps += 1
        f, et, e64 = compare_step(torch, ndt, state, twin, running, p)
        flips, worst_twin, worst64 = flips + f, max(worst_twin, et), max(worst64, e64)
    return steps, flips, worst_twin, worst64


def loop_batch(torch, scans, gt, dev):
    """(keyframe, candidates, guesses): K13's batch at the 1 m rung, as phase
    2c gives it: the 131072-lane keyframe of the window group of scans 0-15
    (filtered at the flagship prefilter's resolution), the filtered scans
    2, 4, ..., 16 as the 8 candidates, their true poses 0.2 m off in x."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.ops import prefilter
    from lv_slam_tpu_torch.pipeline import window

    pf = kitti_flagship_config().prefilter
    res, kf_cap = pf.downsample_resolution, 131072
    rel_all = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)

    def filtered(i):
        raw = PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev)
        band = prefilter.distance_filter(raw, pf.distance_near_thresh, pf.distance_far_thresh)
        return prefilter.voxel_downsample(band, res, pf.out_cap)

    scans_f = [filtered(i) for i in range(17)]
    rows = scans_f[:16]
    keyframe = window.window_group_filtered(
        torch.stack([c.xyz.T for c in rows]).contiguous(), torch.stack([c.intensity for c in rows]),
        torch.stack([c.mask for c in rows]), 0, torch.from_numpy(rel_all[:16].copy()).to(dev),
        torch.ones(16, dtype=torch.bool, device=dev), res, kf_cap)
    guesses = torch.from_numpy(rel_all[2:18:2].copy()).to(dev)
    guesses[:, 0, 3] += 0.2
    return keyframe, [scans_f[i] for i in range(2, 18, 2)], guesses


SUMS_BLOCKS = (1, 5, 256, 512, 700, 2049)  # K7s: 2049 is one row past a round in shared memory (csrc/newton.cu)


def sums_cases(torch, ndt, dev, seed: int = SEED):
    """K7s's edge cases: (name, state, n_blocks), 8 lanes of seeded partial
    rows for each n_blocks of `SUMS_BLOCKS`, lanes 1 and 5 finished, a NaN in
    a row of lane 2 and an infinity in lane 3."""
    rng = np.random.default_rng(seed)
    out = []
    for n in SUMS_BLOCKS:
        rows = (rng.standard_normal((8, n, ndt.N_TERMS)) * 1e3).astype(np.float32)
        rows[2, n // 2, 7] = np.nan
        rows[3, n - 1, 0] = np.inf
        state = ndt.NewtonState(torch.eye(4, device=dev).expand(8, 4, 4).contiguous(), batched=True)
        state.partials = torch.from_numpy(rows.reshape(-1)).to(dev)
        state.s[[1, 5], ndt.S_DONE] = 1
        out.append((f"{n} blocks", state, n))
    return out


def check_sums_cases(torch, dev):
    """K7s against its plain version on the card, bit for bit (NaN's bits
    too), on every case of `sums_cases`, one launch each; returns the number
    of cases."""
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import ndt

    cases = sums_cases(torch, ndt, dev)
    for name, state, n in cases:
        before = KERNELS["newton_sums"].launches
        got = ndt.newton_sums(state, n).clone()
        want = ndt.newton_sums_ref(state, n)
        torch.cuda.synchronize()
        if KERNELS["newton_sums"].launches != before + 1:
            raise AssertionError(f"newton_sums ({name}): not one launch")
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"newton_sums ({name}): the lanes' sums differ from the plain version")
        if bool(got[[1, 5]].any()) or not bool(got[2, 7].isnan()) or float(got[3, 0]) != float("inf"):
            raise AssertionError(f"newton_sums ({name}): finished lanes, the NaN or the infinity not as the adds give")
    return len(cases)


# K7's edge cases (`newton_cases`): a canned quadratic score over the
# candidate's pose coordinates x(T) = (T03, T13, T23, T21, T02, T10): score
# c + (x - x*)^T H (x - x*) / 2, gradient H (x - x*), Hessian H, split on
# the card into n_blocks seeded partial rows a lane
NEWTON_CASE_NAMES = ("zero pivot", "row swaps", "NaN start", "ground dof", "x, y and yaw dof", "step_min",
                     "steps at the cap", "max_iterations", "1 row", "2049 rows", "4 lanes, one NaN start")
# a diagonal whose trace (5.722040176391602) is exact in any order of the
# adds, with H00 = -ridge(trace) = -2^-20: the system's first column is then
# exactly zero, a zero pivot (LAPACK's info 1)
ZERO_PIVOT_DIAG = (-2.0 ** -20, -1.7220392227172852, -1.0, -1.0, -1.0, -1.0)
GROUND_DOF = (False, False, True, True, True, False)  # ops/ndt_ground.GROUND_DOF: tz, roll, pitch


class NewtonCase(NamedTuple):
    """A canned Newton loop: Hessian `hess` (6, 6), maxima `x_star` (k, 6),
    NaN start scores `nan` (k,), guesses' translations `t0` (k, 3) (no
    rotation), the loop's max_iterations and dof_mask, and the partial rows
    a lane of its pass on the card."""

    name: str
    hess: np.ndarray
    x_star: np.ndarray
    nan: np.ndarray
    t0: np.ndarray
    max_iterations: int = 64
    dof_mask: Optional[tuple] = None
    n_blocks: int = 256
    exact_rows: bool = False  # the derivatives in the first row, zeros after: the sums are exactly them

    def guesses(self) -> np.ndarray:
        g = np.tile(np.eye(4, dtype=np.float32), (len(self.t0), 1, 1))
        g[:, :3, 3] = self.t0
        return g


def newton_case_specs():
    """`NEWTON_CASE_NAMES`' canned loops, as numpy arrays (the CPU tests
    drive JAX's loop with the same)."""
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    one = lambda *x: f32([x])  # noqa: E731
    swaps = -np.eye(6)
    swaps[:3, :3] = -np.array([[1.0, 5.0, 0.5], [5.0, 100.0, 3.0], [0.5, 3.0, 10.0]])  # |a10| > |a00|: a row swap
    swaps[3:, 3:] = -np.diag([1.0, 2.0, 3.0])
    coupled = -np.diag([2.0, 2.0, 4.0, 3.0, 3.0, 2.0])
    for i, j in ((0, 2), (2, 3), (1, 4)):
        coupled[i, j] = coupled[j, i] = -0.3
    no = np.zeros(1, bool)
    at0 = f32([[0.0, 0.0, 0.0]])
    far = one(0.45, -0.2, 0.1, 0.0, 0.0, 0.02)
    out = [
        NewtonCase("zero pivot", f32(np.diag(ZERO_PIVOT_DIAG)), one(0.05, 0.02, -0.01, 0, 0, 0), no, at0,
                   exact_rows=True),
        NewtonCase("row swaps", f32(swaps), one(0.06, -0.03, 0.02, 0.01, 0.0, 0.005), no, at0),
        NewtonCase("NaN start", f32(-np.eye(6)), one(0.1, 0, 0, 0, 0, 0), np.ones(1, bool), at0, n_blocks=128),
        NewtonCase("ground dof", f32(coupled), one(0.2, 0.1, 0.04, 0.02, -0.01, 0.05), no, at0, dof_mask=GROUND_DOF),
        NewtonCase("x, y and yaw dof", f32(coupled), one(0.2, 0.1, 0.04, 0.02, -0.01, 0.05), no, at0,
                   dof_mask=(True, True, False, False, False, True), n_blocks=512),
        NewtonCase("step_min", f32(-4.0 * np.eye(6)), one(0.003, 0, 0, 0, 0, 0), no, at0),
        NewtonCase("steps at the cap", f32(-2.0 * np.eye(6)), far, no, at0),
        NewtonCase("max_iterations", f32(-2.0 * np.eye(6)), far, no, at0, max_iterations=2),
        NewtonCase("1 row", f32(swaps), one(0.06, -0.03, 0.02, 0.01, 0.0, 0.005), no, at0, n_blocks=1),
        NewtonCase("2049 rows", f32(coupled), one(0.12, -0.05, 0.02, 0.0, 0.01, -0.02), no, f32([[0.02, 0.0, 0.0]]),
                   n_blocks=2049),
        NewtonCase("4 lanes, one NaN start", f32(-np.diag([1.0, 2.0, 3.0, 1.0, 1.0, 1.0])),
                   f32([[0.3, 0, 0, 0, 0, 0], [0.05, 0.05, 0, 0, 0, 0.01], [0.1, 0, 0, 0, 0, 0],
                        [0.0, -0.15, 0.02, 0.0, 0.0, 0.0]]),
                   np.array([False, False, True, False]), np.zeros((4, 3), np.float32), n_blocks=512),
    ]
    assert tuple(c.name for c in out) == NEWTON_CASE_NAMES
    return out


def canned_derivatives(torch, case: NewtonCase, dev):
    """The case's derivatives as torch ops: (score (k,), grad (k, 6), hess
    (k, 6, 6)) at transforms (k, 4, 4)."""
    hess = torch.from_numpy(case.hess).to(dev)
    x_star = torch.from_numpy(case.x_star).to(dev)
    nan = torch.from_numpy(case.nan).to(dev)

    def derivs(transforms):
        t = transforms
        x = torch.stack([t[:, 0, 3], t[:, 1, 3], t[:, 2, 3], t[:, 2, 1], t[:, 0, 2], t[:, 1, 0]], dim=1)
        d = x - x_star
        grad = torch.sum(hess[None] * d[:, None, :], dim=2)
        score = torch.where(nan, float("nan"), 0.5 * torch.sum(d * grad, dim=1))
        return score, grad, hess.expand(len(t), 6, 6)

    return derivs


def newton_cases(torch, ndt, dev, seed: int = SEED):
    """K7's edge cases on `dev`: (name, state, pass, loop params, sums_at)
    per `newton_case_specs` entry. The pass writes each lane's canned
    derivatives at its candidate as n_blocks partial rows (seeded positive
    weights of the row summing to about 1: the rows' float32 sums in block
    order round otherwise than the derivatives themselves; the zero pivot's
    in the first row, so its sums are exactly the singular system);
    `sums_at(cands)` is those sums, the plain block-by-block adds the step
    takes."""
    rng = np.random.default_rng(seed)
    out = []
    for case in newton_case_specs():
        derivs = canned_derivatives(torch, case, dev)
        w = rng.uniform(0.5, 1.5, case.n_blocks)
        w = np.eye(1, case.n_blocks)[0] if case.exact_rows else w / w.sum()
        weights = torch.from_numpy(w.astype(np.float32)).to(dev)
        k, n = len(case.t0), case.n_blocks

        def rows_at(cands, derivs=derivs, weights=weights):
            score, grad, hess = derivs(cands)
            terms = torch.cat([score[:, None], grad, hess.reshape(len(cands), 36)], dim=1)
            return terms[:, None, :] * weights[None, :, None]

        def sums_at(cands, rows_at=rows_at, n=n):
            rows = rows_at(cands)
            sums = torch.zeros_like(rows[:, 0])
            for b in range(n):
                sums = sums + rows[:, b]
            return sums[:, 0], sums[:, 1:7], sums[:, 7:].reshape(len(cands), 6, 6)

        def launch(state, rows_at=rows_at, n=n):
            cands = state.f[:, ndt.F_CAND:ndt.F_CAND + 16].reshape(state.k, 4, 4)
            state.partials[:state.k * n * ndt.N_TERMS] = rows_at(cands).reshape(-1)

        state = ndt.NewtonState(torch.from_numpy(case.guesses()).to(dev), batched=k > 1)
        state.partials = torch.empty((k * n * ndt.N_TERMS,), dtype=torch.float32, device=dev)
        p = ndt.loop_params(np.float32(0.01), 0.1, case.max_iterations, case.dof_mask, dev)
        out.append((case.name, state, ndt.DerivativePass(None, launch, n), p, sums_at))
    return out


def check_newton_cases(torch, dev):
    """K7 (`newton_step`) on every case of `newton_cases`, step by step to
    done against its twin from identical states by `newton_steps`' rules,
    one launch and no synchronizing call a step; returns the number of
    cases."""
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.ops import ndt

    cases = newton_cases(torch, ndt, dev)
    for name, state, pass_, p, sums_at in cases:
        probe = state.clone()
        probe.f, probe.s = state.f.clone(), state.s.clone()
        pass_.launch(probe)
        before = KERNELS["newton_step"].launches
        syncs = count_syncs(torch, lambda: ndt.newton_step(probe, pass_.n_blocks, p))
        if KERNELS["newton_step"].launches != before + 1 or syncs:
            raise AssertionError(f"newton_step ({name}): {KERNELS['newton_step'].launches - before} launches, "
                                 f"{syncs} synchronizing calls")
        try:
            steps, _, _, _ = newton_steps(torch, ndt, state, pass_, sums_at, p)
        except AssertionError as err:
            raise AssertionError(f"newton_cases ({name}): {err}") from err
        want_it = {"NaN start": [0], "max_iterations": [3], "zero pivot": [1], "step_min": [1],
                   "4 lanes, one NaN start": None}.get(name)
        got_it = state.s[:, ndt.S_IT].tolist()
        if (want_it is not None and got_it != want_it) or steps < 1:
            raise AssertionError(f"newton_step ({name}): iterations {got_it} (expected {want_it}), {steps} steps")
        if name == "zero pivot" and state.s[0].tolist() != [1, 1, 1, 1]:
            raise AssertionError(f"newton_step (zero pivot): state flags {state.s[0].tolist()}, not done and bad")
        if name == "4 lanes, one NaN start" and (int(state.s[2, ndt.S_IT]) != 0 or len(set(got_it)) < 2):
            raise AssertionError(f"newton_step ({name}): iterations {got_it}")
    return len(cases)


LM_CASE_NAMES = ("a Cholesky that fails", "a NaN delta", "done in the middle of a group",
                 "node 0, fixed nodes and a fixed plane", "no prior, SE3-plane or plane-plane slots",
                 "invalid prior, SE3-plane and plane slots (phase 5's bucket)", "more variables than warps",
                 "num_iterations = 1")


def _lm_case_graph(torch, rng, n_nodes: int, n_chain: int, caps, loops, step: float = 1.0, noise: float = 0.03):
    """A chain of `n_chain` keyframes (`step` m and 0.1 rad a step, each node
    moved by `noise` m / rad) in an empty graph of `n_nodes` node slots and
    (edge, prior, plane, SE3-plane, plane-plane) caps, odometry edges (info
    10, Huber 1) and loop edges between the pairs `loops`."""
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.graph import pose_graph

    def exp(v):
        return se3.exp_se3(torch.tensor(v, dtype=torch.float32)).double().numpy()

    g = pose_graph.empty_graph(n_nodes, *caps)
    poses = [np.eye(4)]
    for _ in range(n_chain - 1):
        poses.append(poses[-1] @ exp(np.r_[step, 0.0, 0.0, 0.0, 0.0, 0.1] + rng.normal(0, 0.01, 6)))
    for i, pose in enumerate(poses):
        pose_graph.add_node(g, i, pose @ exp(rng.normal(0, noise, 6)) if noise else pose)
    e = 0
    for i in range(1, n_chain):
        pose_graph.add_se3_edge(g, e, i, i - 1, np.linalg.inv(poses[i]) @ poses[i - 1], np.eye(6) * 10, huber=1.0)
        e += 1
    for i, j in loops:
        pose_graph.add_se3_edge(g, e, i, j, np.linalg.inv(poses[i]) @ poses[j] @ exp(rng.normal(0, noise / 3, 6)),
                                np.eye(6) * 10, huber=1.0)
        e += 1
    return g, poses, e


def lm_cases(torch, seed: int = SEED):
    """The LM's edge cases as host graphs: (name, graph, num_iterations).
    A Cholesky that fails (an edge of information -1000 makes the damped
    system indefinite: info != 0, the step is zero and `small` stops the
    loop); a NaN delta with info == 0 (an XYZ prior 1e30 m away, information
    1e10, no Huber: H finite, b not); done set in the middle of a group (a
    chain that its measurements fit to rounding, 5 cm a step: the first step
    is below 1e-6 and stops the loop, the group's three other iterations are
    launched and gated); node 0, a fixed node, a
    valid node that no factor reaches, an invalid node slot and a fixed
    floor plane among three free ones, with SE3-plane, plane-prior and
    plane-plane factors that their true values fit; families with no slots
    at all; the backend's bucket on the main path (prior, SE3-plane and
    plane slots, all invalid); 160 nodes and 8 planes (more variables than
    the cluster's 64 warps); num_iterations = 1."""
    from lv_slam_tpu_torch.graph import factors, pose_graph

    rng = np.random.default_rng(seed)
    out = []
    g, _, _ = _lm_case_graph(torch, rng, 16, 12, (32, 8, 8, 8, 16), ((11, 0),))
    g.e_info[5] = -1000.0 * np.eye(6, dtype=np.float32)
    out.append((LM_CASE_NAMES[0], g, 16))
    g, poses, _ = _lm_case_graph(torch, rng, 16, 12, (32, 8, 8, 8, 16), ((11, 0),))
    pose_graph.add_prior(g, 0, 4, pose_graph.PRIOR_XYZ, [1e30, 0.0, 0.0], np.eye(3) * 1e10)
    out.append((LM_CASE_NAMES[1], g, 16))
    g, _, _ = _lm_case_graph(torch, rng, 16, 12, (32, 8, 8, 8, 16), ((11, 0),), step=0.05, noise=0.0)
    out.append((LM_CASE_NAMES[2], g, 64))
    g, poses, _ = _lm_case_graph(torch, rng, 16, 12, (32, 16, 4, 16, 8), ((11, 0), (9, 2)))
    pose_graph.set_node_fixed(g, 5)
    g.node_valid[14] = True  # a valid node that no factor reaches, and an invalid slot (15) past it
    # the planes' true coefficients (unit normals), each node's measurement of
    # them in its own frame, their starting estimates 0.05 off
    true_planes = [np.array(p) / np.linalg.norm(p[:3]) for p in
                   ([0.0, 0.0, 1.0, 0.0], [0.05, 0.02, 1.0, -2.0], [1.0, 0.3, 0.02, 5.0], [0.05, 0.02, 1.0, -3.5])]
    pose_graph.add_plane_node(g, 0, true_planes[0], fixed=True)
    for q in range(1, 4):
        pose_graph.add_plane_node(g, q, true_planes[q] + rng.normal(0, 0.05, 4))
    for i in range(12):
        local = factors.plane_transform(torch.from_numpy(poses[i]), torch.from_numpy(true_planes[i % 3]))
        pose_graph.add_se3_plane_edge(g, i, i, i % 3, local.numpy(), np.eye(3) * 10, huber=1.0)
    for slot, (kind, i, j, meas) in enumerate((
            (pose_graph.PLANE_PRIOR_NORMAL, 1, 1, true_planes[1][:3]),
            (pose_graph.PLANE_PRIOR_DISTANCE, 2, 2, true_planes[2][3:]),
            (pose_graph.PLANE_PERPENDICULAR, 1, 2, np.zeros(1)),
            (pose_graph.PLANE_PARALLEL, 3, 1, np.zeros(3)))):
        pose_graph.add_plane_edge(g, slot, i, j, kind, meas, np.eye(len(meas)) * 2, huber=1.0)
    pose_graph.add_prior(g, 0, 3, pose_graph.PRIOR_XYZ, poses[3][:3, 3] + 0.1, np.eye(3), huber=1.0)
    out.append((LM_CASE_NAMES[3], g, 64))
    g, _, _ = _lm_case_graph(torch, rng, 16, 12, (32, 0, 0, 0, 0), ((11, 0),))
    out.append((LM_CASE_NAMES[4], g, 64))
    g, _, _ = _lm_case_graph(torch, rng, 32, 19, (32, 8, 8, 8, 16), ((18, 0),))
    out.append((LM_CASE_NAMES[5], g, 64))
    g, _, _ = _lm_case_graph(torch, rng, 160, 160, (256, 8, 8, 8, 16), ((159, 0), (120, 40)))
    pose_graph.add_plane_node(g, 0, [0.0, 0.0, 1.0, 0.0], fixed=True)
    out.append((LM_CASE_NAMES[6], g, 64))
    g, _, _ = _lm_case_graph(torch, rng, 16, 12, (32, 8, 8, 8, 16), ((11, 0),))
    out.append((LM_CASE_NAMES[7], g, 1))
    assert tuple(name for name, _, _ in out) == LM_CASE_NAMES
    return out


def agree(torch, a, b, tol: float):
    """Whether two tensors hold their non-finite entries at the same places
    with the same values and their finite ones within `tol`."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(torch.nan_to_num(a[~fa], nan=0.0), torch.nan_to_num(b[~fb], nan=0.0)):
        return False
    return not bool(fa.any()) or float((a[fa] - b[fb]).abs().max()) <= tol


def same_bits(torch, a, b) -> bool:
    """Equal float bits (NaN's too), or equal integers."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def k15_mode_checks(torch, g):
    """K15's modes on the device graph `g` at its own poses: the chi2 mode's
    sum equal to the raw build's bit for bit, the damped system and rhs
    equal to the raw build through `lm_damp` bit for bit (the sharded LM's
    route), a second raw build the same bits; each call one launch of one
    device kernel. Returns the raw build (chi2, H, b)."""
    from lv_slam_tpu_torch.graph import pose_graph
    from lv_slam_tpu_torch.kernels import KERNELS

    k15 = KERNELS["_chi2_and_normal"]
    before = k15.launches
    chi2, h, b = pose_graph._chi2_and_normal(g, g.poses, True)
    chi2_only, _, _ = pose_graph._chi2_and_normal(g, g.poses, False)
    damped, rhs = pose_graph._damped_system(g, g.poses, g.planes, 1e-4)
    if k15.launches != before + 3:
        raise AssertionError(f"_chi2_and_normal: {k15.launches - before} launches for three calls")
    again = pose_graph._chi2_and_normal(g, g.poses, True)
    st = pose_graph.LMState(g, chi2_only, sharded=True)
    st.h.copy_(h)
    st.b.copy_(b)
    pose_graph.LM_KERNEL.call("lvs_lm_damp", pose_graph.ptr(st.h), pose_graph.ptr(st.b), pose_graph.ptr(g.node_valid),
                              pose_graph.ptr(g.node_fixed), pose_graph.ptr(g.plane_valid),
                              pose_graph.ptr(g.plane_fixed), g.node_cap, pose_graph._n_dofs(g), pose_graph.ptr(st.lmf),
                              pose_graph.ptr(st.lmi), pose_graph.ptr(st.damped), pose_graph.ptr(st.rhs))
    failed = [what for what, ok in (
        ("the chi2 mode's sum", same_bits(torch, chi2_only, chi2)),
        ("the damped system", same_bits(torch, damped, st.damped) and same_bits(torch, rhs, st.rhs[:, 0])),
        ("a second raw build", all(same_bits(torch, x, y) for x, y in zip((chi2, h, b), again)))) if not ok]
    if failed:
        raise AssertionError(f"_chi2_and_normal: {failed} not bit-identical")
    return chi2, h, b


def check_lm_cases(torch, dev):
    """The LM on every case of `lm_cases` on the card against its twin on
    the card: K15's modes (`k15_mode_checks`), one iteration from identical
    states (poses and planes within 1e-5, the flags equal), then whole
    optimizes: the iterations launched (whole groups of LM_GROUP, at most
    num_iterations), the reads of `done` (one per group), and the result
    against the twin's loop within LM_TOL (non-finite entries equal); the
    cases with a known stop hold it (a failed Cholesky and a NaN delta:
    not ok, small, one iteration; the fitted chain: small at the first
    iteration, a whole group launched; num_iterations 1: one).
    Returns {case: record}."""
    from lv_slam_tpu_torch.graph import pose_graph
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches

    out = {}
    for name, graph, num_iterations in lm_cases(torch):
        g = pose_graph.to_device(graph, dev)
        k15_mode_checks(torch, g)
        chi2_0, _, _ = pose_graph._chi2_and_normal(g, g.poses, False, g.planes)
        a = pose_graph.LMState(g, chi2_0)
        b = a.clone()
        pose_graph._lm_iteration(g, a, num_iterations)
        pose_graph._lm_iteration_ref(g, b, num_iterations)
        if not (agree(torch, a.poses, b.poses, 1e-5) and agree(torch, a.planes, b.planes, 1e-5)
                and torch.equal(a.lmi, b.lmi)):
            raise AssertionError(f"lm_cases ({name}): the first iteration departs from the twin's: flags "
                                 f"{a.lmi.tolist()} vs {b.lmi.tolist()}")
        copies = count_syncs(torch, lambda: pose_graph.to_device(graph, dev))
        runs = []
        reset_launches()
        reads = count_syncs(torch, lambda: runs.append(pose_graph.optimize_pose_graph(graph, num_iterations,
                                                                                       device=dev))) - copies
        got, launched = runs[0], KERNELS["optimize_pose_graph"].launches
        saved = pose_graph._lm_iteration
        pose_graph._lm_iteration = pose_graph._lm_iteration_ref
        try:
            want = pose_graph.optimize_pose_graph(graph, num_iterations, device=dev)
        finally:
            pose_graph._lm_iteration = saved
        it = int(got.iterations)
        group = pose_graph.LM_GROUP
        want_launched = min(max(num_iterations, 1), -(-it // group) * group)
        rel_chi2 = abs(float(want.chi2_after)) if bool(torch.isfinite(want.chi2_after)) else 1.0
        if not (agree(torch, got.poses, want.poses, LM_TOL[0]) and agree(torch, got.planes, want.planes, LM_TOL[1])
                and agree(torch, got.chi2_after, want.chi2_after, LM_TOL[2] * max(rel_chi2, 1e-12))):
            raise AssertionError(
                f"lm_cases ({name}): the optimize departs from the twin's loop beyond {LM_TOL}: poses "
                f"{float((got.poses - want.poses).abs().max())}, planes {float((got.planes - want.planes).abs().max())}, "
                f"chi2 {float(got.chi2_after)} / {float(want.chi2_after)}, iterations {it} / {int(want.iterations)}")
        if launched != want_launched or reads > -(-it // group):
            raise AssertionError(f"lm_cases ({name}): {launched} iterations launched for {it} (expected "
                                 f"{want_launched}), {reads} reads")
        stop = {LM_CASE_NAMES[0]: 1, LM_CASE_NAMES[1]: 1, LM_CASE_NAMES[2]: 1, LM_CASE_NAMES[7]: 1}.get(name)
        if stop is not None and (it != stop or int(want.iterations) != stop):
            raise AssertionError(f"lm_cases ({name}): {it} iterations (the twin {int(want.iterations)}), expected "
                                 f"{stop}")
        if name in LM_CASE_NAMES[:2] and a.lmi.tolist()[1:] != [1, 0, 1]:
            raise AssertionError(f"lm_cases ({name}): flags [done, it, ok, small] {a.lmi.tolist()}, expected a "
                                 f"rejected step stopped by small")
        out[name] = dict(iterations=it, twin_iterations=int(want.iterations), launched=launched, reads=reads,
                         chi2_after=float(got.chi2_after))
    return out


def check_loop_kernels(torch, scans, gt, dev, prior):
    """Phase 2i: the device-side loops against their twins at the main
    path's shapes. K7 (`newton_step`, with the derivative passes gated on
    `done`): every step of the host DLO's align of scan 1's 65536-lane
    subsample onto scan 0's keyframe map (phase 2f's), from its warm
    start, from the first scan's x = +1.5 m guess and from 0.3 m and 0.02
    rad off, each from identical states; then whole aligns, timed against
    the twins' loop on the card, with their host reads counted; K13's batch
    of 8 candidates x 131072 lanes at the 1 m rung (phase 2c's) step by step
    and whole, and the whole `dispatch_one` of that batch (no synchronizing
    call). The LM (`optimize_pose_graph`: K15's damped system, the
    Cholesky, `lm_step`) on phase 2c's 64-keyframe graph and 2g's with
    priors: one iteration from identical states, whole optimizes against
    the twin's on the card, reads and wasted solves counted; `lm_cases`;
    the hand launches of an iteration and of each K15 mode. `prior`: the
    records of phases 2c and 2f (K6L's, K13's and K15's bounds, the
    Cholesky's time)."""
    import lv_slam_tpu_torch.graph.pose_graph as pose_graph
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.config import LoopDetectorConfig
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
    from lv_slam_tpu_torch.graph.keyframe import KeyFrame
    from lv_slam_tpu_torch.graph.loop_detector import LoopDetector
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.ops import ndt, ndt_hash, ndt_soa, prefilter, voxel_map

    cfg = kitti_flagship_config()
    pf, ndt_cfg = cfg.prefilter, cfg.odometry.ndt
    records = {}

    # K7 on phase 2f's map
    def subsample(i):
        raw = PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev)
        return prefilter.uniform_subsample(prefilter.prefilter(raw, pf), cfg.odometry.scan_matching_cap)

    sub0, sub1 = subsample(0), subsample(1)
    vm = voxel_map.build_voxel_map(
        sub0, ndt_cfg.resolution, leaf_cap=ndt_cfg.leaf_cap, lut_extent=ndt_cfg.lut_extent,
        min_points_per_voxel=ndt_cfg.min_points_per_voxel, min_covar_eigvalue_mult=ndt_cfg.min_covar_eigvalue_mult,
        weighted=ndt_cfg.weighted,
    )
    soa = ndt_soa.to_soa(vm, voxel_map.build_lut(vm))
    xs, mask = sub1.masked_xyz().T.contiguous(), sub1.mask.contiguous()
    gauss = ndt.make_gauss_params(ndt_cfg.resolution, ndt_cfg.outlier_ratio)
    offsets = voxel_map.neighborhood_offsets(ndt_cfg.neighborhood, dev)
    pass_ = ndt_soa.soa_pass(soa, xs, mask, gauss, offsets, ndt_cfg.weighted)
    p = ndt.loop_params(np.float32(ndt_cfg.transformation_epsilon), ndt_cfg.step_size, ndt_cfg.max_iterations)

    def sums_at(cands):
        return ndt_soa.ndt_derivatives_soa(soa, xs, mask, cands[0], gauss, offsets, ndt_cfg.weighted)

    rel = torch.from_numpy((np.linalg.inv(gt[0]) @ gt[1]).astype(np.float32)).to(dev)
    first = torch.eye(4, device=dev)
    first[0, 3] = cfg.odometry.initial_guess_x
    starts = {
        "warm start": (se3.exp_se3(torch.tensor([0.05, -0.03, 0.01, 0.0, 0.0, 0.005], device=dev)) @ rel).contiguous(),
        "x = +1.5 m": first,
        "0.3 m and 0.02 rad off": (se3.exp_se3(torch.tensor([0.3, 0.0, 0.0, 0.0, 0.0, 0.02], device=dev)) @ rel
                                   ).contiguous(),
    }
    total = [0, 0, 0.0, 0.0]
    for name, guess in starts.items():
        state = ndt.NewtonState(guess[None])
        state.partials = torch.empty((pass_.n_blocks * ndt.N_TERMS,), dtype=torch.float32, device=dev)
        steps, flips, et, e64 = newton_steps(torch, ndt, state, pass_, sums_at, p)
        total = [total[0] + steps, total[1] + flips, max(total[2], et), max(total[3], e64)]
        log(f"  newton_step from {name}: {steps} steps ({int(state.s[0, ndt.S_IT])} iterations) from identical "
            f"states, {flips} done / bad flags decided by rounding, candidates within {et:.3g} of the twin's and "
            f"alpha within {e64:.3g} of float64's (tol 1e-5)")

    # one step's time: from the state after the first step, at its candidate
    state = ndt.NewtonState(starts["x = +1.5 m"][None])
    state.partials = torch.empty((pass_.n_blocks * ndt.N_TERMS,), dtype=torch.float32, device=dev)
    pass_.launch(state)
    ndt.newton_step(state, pass_.n_blocks, p)
    pass_.launch(state)
    sums = sums_at(state.f[:, ndt.F_CAND:ndt.F_CAND + 16].reshape(1, 4, 4).contiguous())
    f0, s0 = state.f.clone(), state.s.clone()
    twin = state.clone()

    def k7():
        state.f.copy_(f0)
        state.s.copy_(s0)
        ndt.newton_step(state, pass_.n_blocks, p)

    def p7():
        twin.f.copy_(f0)
        twin.s.copy_(s0)
        ndt.newton_step_ref(twin, *sums, p)

    # bytes: the partial rows and the state row read once, the state written
    # once; operations: the rows' sums, the 6x6 LU (~150 in float64), the
    # exponential and the 4x4 product (~250)
    measure(torch, records, "newton_step", k7, p7, total[2],
            4 * pass_.n_blocks * ndt.N_TERMS + 2 * (4 * ndt.F_WIDTH + 4 * ndt.S_WIDTH),
            pass_.n_blocks * ndt.N_TERMS + 400)
    step_bound = records["newton_step"]["bound_ms"]

    # whole aligns: the host DLO's from its warm start, the kernels against
    # the twins' loop on the card
    align = lambda: ndt_soa.ndt_align_soa_table(  # noqa: E731
        soa, sub1, starts["warm start"], resolution=ndt_cfg.resolution, outlier_ratio=ndt_cfg.outlier_ratio,
        step_size=ndt_cfg.step_size, transformation_epsilon=ndt_cfg.transformation_epsilon,
        max_iterations=ndt_cfg.max_iterations, neighborhood=ndt_cfg.neighborhood, weighted=ndt_cfg.weighted)
    aligns = {}
    for name, guess in starts.items():
        run = lambda guess=guess: ndt_soa.ndt_align_soa_table(  # noqa: E731
            soa, sub1, guess, resolution=ndt_cfg.resolution, outlier_ratio=ndt_cfg.outlier_ratio,
            step_size=ndt_cfg.step_size, transformation_epsilon=ndt_cfg.transformation_epsilon,
            max_iterations=ndt_cfg.max_iterations, neighborhood=ndt_cfg.neighborhood, weighted=ndt_cfg.weighted)
        runs = []
        reads = count_syncs(torch, lambda run=run: runs.append(run()))
        got = runs[0]
        it = int(got.iterations)
        if reads > -(-(it + 1) // ndt.NEWTON_GROUP):
            raise AssertionError(f"K7 from {name}: {reads} host reads for {it} iterations (NEWTON_GROUP "
                                 f"{ndt.NEWTON_GROUP})")
        saved = ndt_soa._newton_loop
        ndt_soa._newton_loop = ndt._newton_loop_plain
        try:
            want = run()
        finally:
            ndt_soa._newton_loop = saved
        err = float((got.transform - want.transform).abs().max())
        tol = NDT_LOOP_TOL if it == int(want.iterations) else CPU_SPREAD_M
        if err > tol:
            raise AssertionError(f"K7 from {name}: the align departs from the twins' loop on the card by {err} "
                                 f"(tol {tol})")
        aligns[name] = dict(iterations=it, twin_iterations=int(want.iterations), reads=reads, max_abs_err=err)
        log(f"  K7 align from {name}: {it} iterations ({int(want.iterations)} with the twins), {reads} host reads "
            f"(at most ceil((it + 1) / {ndt.NEWTON_GROUP})), transform within {err:.3g} of the twins' loop on the card "
            f"(tol {tol})")
    it = aligns["warm start"]["iterations"]
    dev_ms, wall_ms = loop_ms(torch, align)
    saved = ndt_soa._newton_loop
    ndt_soa._newton_loop = ndt._newton_loop_plain
    try:
        plain_dev, plain_wall = loop_ms(torch, align)
    finally:
        ndt_soa._newton_loop = saved
    align_bound = (it + 1) * (prior["ndt_derivatives_soa"]["bound_ms"] + step_bound)
    records["newton_step"]["align"] = dict(
        iterations=it, device_ms=dev_ms, wall_ms=wall_ms, plain_device_ms=plain_dev, plain_wall_ms=plain_wall,
        bound_ms=align_bound, reads=aligns["warm start"]["reads"], starts=aligns)
    log(f"    the host DLO's align (K7 over K6L, {it} iterations): device {dev_ms:.3f} ms, wall {wall_ms:.3f} ms per "
        f"align; the twins' loop (K6L's twin, newton_step_ref) device {plain_dev:.3f} ms, wall {plain_wall:.3f} ms; "
        f"bound {align_bound:.5f} ms")

    # K13's batch at the 1 m rung (phase 2c's keyframe and candidates)
    rel_all = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    keyframe, cands, guesses = loop_batch(torch, scans, gt, dev)
    hm = ndt_hash.to_hash(voxel_map.build_voxel_map(keyframe, 1.0, leaf_cap=16384, lut_extent=256))
    batch = PointCloud(torch.stack([c.xyz for c in cands]), torch.stack([c.intensity for c in cands]),
                       torch.stack([c.mask for c in cands]))
    bmask = batch.mask.contiguous()
    bxs = torch.where(bmask[..., None], batch.xyz, SENTINEL).transpose(1, 2).contiguous()
    offsets7 = voxel_map.neighborhood_offsets("DIRECT7", dev)
    gauss1 = ndt.make_gauss_params(1.0)
    iters = kitti_flagship_config().loop.verify_max_iterations
    bpass = ndt_hash.hash_pass(hm, bxs, bmask, gauss1, offsets7, False)
    bp = ndt.loop_params(0.01, 0.1, iters)
    state = ndt.NewtonState(guesses, batched=True)
    state.partials = torch.empty((8 * bpass.n_blocks * ndt.N_TERMS,), dtype=torch.float32, device=dev)
    steps, flips, et, e64 = newton_steps(
        torch, ndt, state, bpass,
        lambda c: ndt_hash.ndt_derivatives_hash_batched(hm, bxs, bmask, c, gauss1, offsets7, False), bp)
    total = [total[0] + steps, total[1] + flips, max(total[2], et), max(total[3], e64)]
    log(f"  newton_step over K13's batch (8 x {bxs.shape[2]} lanes, 1 m, DIRECT7): {steps} steps from identical "
        f"states, iterations {state.s[:, ndt.S_IT].tolist()}, {flips} flags decided by rounding, candidates within "
        f"{et:.3g} of the twin's, alpha within {e64:.3g} of float64's (tol 1e-5)")
    # the sharded align's per-lane sums (`newton_sums`) on K13's batch: the
    # pass's partial rows at the guesses, lanes 1 and 5 finished; bit for bit
    # against the plain block-by-block adds, zeros for the finished lanes
    sums_state = ndt.NewtonState(guesses, batched=True)
    sums_state.partials = torch.empty_like(state.partials)
    bpass.launch(sums_state)
    sums_state.s[[1, 5], ndt.S_DONE] = 1
    got = ndt.newton_sums(sums_state, bpass.n_blocks).clone()
    if not torch.equal(got, ndt.newton_sums_ref(sums_state, bpass.n_blocks)) or bool(got[[1, 5]].any()):
        raise AssertionError("newton_sums: the lanes' sums differ from the plain version")
    log(f"  newton_sums over K13's batch (8 lanes x {bpass.n_blocks} blocks, lanes 1 and 5 finished): identical to "
        f"the plain block-by-block float32 adds, zeros for the finished lanes")
    n_cases = check_sums_cases(torch, dev)
    log(f"  newton_sums: {n_cases} edge cases (8 lanes x {SUMS_BLOCKS} blocks, lanes 1 and 5 finished, a NaN row and "
        f"an infinite one) identical to the plain version, one launch each")
    n_cases = check_newton_cases(torch, dev)
    log(f"  newton_step: the {n_cases} newton_cases ({', '.join(NEWTON_CASE_NAMES)}) step by step to done against "
        f"the twin by newton_steps' rules, one launch and no synchronizing call a step")
    step_state = sums_state.clone()
    records["newton_step"].update(loop_pass_checks(
        torch, "newton_step", lambda: ndt.newton_step(step_state, bpass.n_blocks, bp)))
    # bytes: the running lanes' partial rows, a done flag per lane, the sums;
    # one add per running lane's partial float
    n_running = int((sums_state.s[:, ndt.S_DONE] == 0).sum())
    sums_in = n_running * bpass.n_blocks * ndt.N_TERMS
    measure(torch, records, "newton_sums", lambda: ndt.newton_sums(sums_state, bpass.n_blocks),
            lambda: ndt.newton_sums_ref(sums_state, bpass.n_blocks), 0.0,
            4 * sums_in + 4 * 8 + nbytes(got), sums_in)
    rows = sums_state.partials[:8 * bpass.n_blocks * ndt.N_TERMS].view(8, bpass.n_blocks, ndt.N_TERMS)
    _, lib_ms, _ = device_ms(torch, lambda: torch.sum(rows, dim=1))
    records["newton_sums"]["library_ms"] = lib_ms
    log(f"    the same sums by torch.sum over the blocks (a library call, every lane): {lib_ms:.4f} ms device-only")
    verify = lambda: ndt_hash.ndt_align_hash_table_batched(  # noqa: E731
        hm, batch, guesses, resolution=1.0, transformation_epsilon=0.01, max_iterations=iters, neighborhood="DIRECT7")
    runs = []
    reset_launches()
    reads = count_syncs(torch, lambda: runs.append(verify()))
    got_t, _, got_it = runs[0]
    launched = KERNELS["newton_step"].launches
    if reads or launched != iters + 2:
        raise AssertionError(f"K13's loop: {reads} host reads, {launched} steps launched (expected 0 and {iters + 2})")
    if not bool(torch.isfinite(got_t).all()) or not torch.equal(got_it, state.s[:, ndt.S_IT]):
        raise AssertionError(f"K13's loop: iterations {got_it.tolist()} against the step-by-step run's "
                             f"{state.s[:, ndt.S_IT].tolist()}")
    k13_dev, k13_wall = loop_ms(torch, verify)
    k13_bound = (iters + 2) * (prior["_fused_verify_fn"]["bound_ms"] + 8 * step_bound)
    records["newton_step"]["k13_rung"] = dict(
        iterations=got_it.tolist(), launched=launched, reads=reads, device_ms=k13_dev, wall_ms=k13_wall,
        bound_ms=k13_bound)
    log(f"    K13's 1 m rung (8 candidates, {iters + 2} gated iterations launched, no host read): device "
        f"{k13_dev:.3f} ms, wall {k13_wall:.3f} ms per rung; bound {k13_bound:.5f} ms (the iterations it needs)")
    # the whole verification as the backend dispatches it: the new keyframe
    # (2c's window cloud) against the 8 candidates, the 4 / 2 / 1 m rungs
    # and the fitness; it must make no synchronizing call
    new_kf = KeyFrame(stamp=10.0, seq=100, odom=np.eye(4), accum_distance=200.0, cloud=keyframe, node_id=50)
    cand_kfs = []
    for i, cloud in zip(range(2, 18, 2), cands):
        odom = rel_all[i].astype(np.float64)
        odom[0, 3] += 0.2
        cand_kfs.append(KeyFrame(stamp=0.1 * i, seq=i, odom=odom, accum_distance=float(i), cloud=cloud, node_id=i))
    detector = LoopDetector(LoopDetectorConfig())
    detector.dispatch_one(cand_kfs, [1.0] * 8, new_kf)
    torch.cuda.synchronize()
    pending = []
    dispatch_syncs = count_syncs(torch, lambda: pending.append(detector.dispatch_one(cand_kfs, [1.0] * 8, new_kf)))
    if dispatch_syncs or not bool(torch.isfinite(pending[0].packed).all()):
        raise AssertionError(f"dispatch_one: {dispatch_syncs} synchronizing calls (expected none)")
    records["newton_step"]["dispatch_one_syncs"] = dispatch_syncs
    log(f"  dispatch_one (8 candidates x {bxs.shape[2]} lanes, rungs {detector._resolutions} m): {dispatch_syncs} "
        f"synchronizing calls")
    log(f"  newton_step: {total[0]} steps checked, {total[1]} flags decided by rounding; kernel "
        f"{records['newton_step']['ms']:.4f} ms per step")

    # the LM on phase 2c's and 2g's graphs
    lm_records = {}
    for name, sensors in (("2c", False), ("2g", True)):
        graph, _ = backend_graph(torch, rel_all, sensors)
        g = pose_graph.to_device(graph, dev)
        chi2_0, _, _ = pose_graph._chi2_and_normal(g, g.poses, False, g.planes)
        a = pose_graph.LMState(g, chi2_0)
        b = a.clone()
        pose_graph._lm_iteration(g, a, 64)
        pose_graph._lm_iteration_ref(g, b, 64)
        err1 = max(float((a.poses - b.poses).abs().max()), float((a.planes - b.planes).abs().max()))
        if err1 > 1e-5 or not torch.equal(a.lmi, b.lmi):
            raise AssertionError(f"the LM kernels' iteration on {name}'s graph: poses {err1} from the twin's "
                                 f"(tol 1e-5), flags {a.lmi.tolist()} vs {b.lmi.tolist()}")
        optimize = lambda graph=graph: pose_graph.optimize_pose_graph(graph, 1024, device=dev)  # noqa: E731
        copies = count_syncs(torch, lambda graph=graph: pose_graph.to_device(graph, dev))
        # the reads and the launches of one run, held to that run's iterations
        runs = []
        reset_launches()
        reads = count_syncs(torch, lambda: runs.append(optimize())) - copies
        got = runs[0]
        it = int(got.iterations)
        launched = KERNELS["optimize_pose_graph"].launches
        saved = pose_graph._lm_iteration
        pose_graph._lm_iteration = pose_graph._lm_iteration_ref
        try:
            want = optimize()
            plain_dev, plain_wall = loop_ms(torch, optimize, reps=3)
        finally:
            pose_graph._lm_iteration = saved
        again = optimize()
        if not (torch.equal(again.poses, got.poses) and torch.equal(again.planes, got.planes)
                and torch.equal(again.chi2_after, got.chi2_after) and int(again.iterations) == it):
            raise AssertionError(f"the LM on {name}'s graph: a second run differs from the first (K15's sums and "
                                 f"the LM kernels have a fixed order)")
        err = float((got.poses - want.poses).abs().max())
        err_planes = float((got.planes - want.planes).abs().max())
        err_chi2 = abs(float(got.chi2_after) - float(want.chi2_after)) / abs(float(want.chi2_after))
        if any(e > t for e, t in zip((err, err_planes, err_chi2), LM_TOL)):
            raise AssertionError(f"the LM on {name}'s graph: poses {err}, planes {err_planes}, chi2 {err_chi2} "
                                 f"(relative) from the twin's loop, tolerances {LM_TOL}")
        if reads > -(-it // pose_graph.LM_GROUP):
            raise AssertionError(f"the LM on {name}'s graph: {reads} reads for {it} iterations")
        dev_ms, wall_ms = loop_ms(torch, optimize, reps=3)
        lm_records[name] = dict(iterations=it, twin_iterations=int(want.iterations), launched=launched,
                                wasted_solves=launched - it, reads=reads, graph_copies=copies, device_ms=dev_ms,
                                wall_ms=wall_ms, plain_device_ms=plain_dev, plain_wall_ms=plain_wall, max_abs_err=err,
                                first_iteration_err=err1)
        log(f"  the LM on {name}'s graph: {it} iterations ({int(want.iterations)} with the twin), {launched} "
            f"launched ({launched - it} wasted solves), {reads} host reads of done (+{copies} for the graph's "
            f"copies to the card); poses within {err:.3g}, planes {err_planes:.3g}, chi2 {err_chi2:.3g} of the twin's "
            f"loop (tol {LM_TOL}), the first iteration within {err1:.3g} (tol 1e-5); a second run bit-identical; "
            f"device {dev_ms:.3f} ms, wall {wall_ms:.3f} ms per optimize; the twin's "
            f"loop device {plain_dev:.3f} ms, wall {plain_wall:.3f} ms")

    # the LM's edge cases against the twin
    case_records = check_lm_cases(torch, dev)
    log(f"  lm_cases: {len(case_records)} cases ({', '.join(LM_CASE_NAMES)}) against the twin on the card: K15's "
        f"chi2 mode equal to its raw build, the damped system to the raw build through lm_damp, bit for bit, one "
        f"launch each; the first iteration within 1e-5, flags equal; whole optimizes within {LM_TOL}, iterations "
        f"{ {k: (r['iterations'], r['twin_iterations']) for k, r in case_records.items()} } (card, twin)")

    # the LM kernels' time per iteration on 2c's graph, from one fixed state
    graph, n_edges = backend_graph(torch, rel_all, False)
    g = pose_graph.to_device(graph, dev)
    chi2_0, _, _ = pose_graph._chi2_and_normal(g, g.poses, False, g.planes)
    st0 = pose_graph.LMState(g, chi2_0)
    st, st_twin = st0.clone(), st0.clone()

    def restore(dst):
        for key, v in st0.__dict__.items():
            if key != "args":  # the graph's pointers, shared
                getattr(dst, key).copy_(v)

    def klm():
        restore(st)
        pose_graph._lm_iteration(g, st, 1024)

    def plm():
        restore(st_twin)
        pose_graph._lm_iteration_ref(g, st_twin, 1024)

    # the hand kernels an iteration and each K15 mode launch on the card
    restore(st)
    per_iteration = hand_launches(torch, lambda: pose_graph._lm_iteration(g, st, 1024))
    per_mode = {mode: hand_launches(torch, fn) for mode, fn in (
        ("raw", lambda: pose_graph._chi2_and_normal(g, g.poses, True)),
        ("chi2", lambda: pose_graph._chi2_and_normal(g, g.poses, False)),
        ("damped", lambda: pose_graph._damped_system(g, g.poses, g.planes, 1e-4)))}
    if len(per_iteration) != 2 or any(len(names) != 1 for names in per_mode.values()):
        raise AssertionError(f"hand launches: {per_iteration} per LM iteration (expected 2), {per_mode} per K15 mode "
                             f"(expected 1 each)")
    log(f"  hand launches per LM iteration: {len(per_iteration)} ({', '.join(per_iteration)}) around the library "
        f"solve (the earlier kernels: 13); _chi2_and_normal: one launch in each mode "
        f"({', '.join(f'{m} {len(v)}' for m, v in per_mode.items())})")

    n, k = pose_graph._n_dofs(g), g.node_cap
    # the work an iteration needs, whatever implements it: the graph's arrays
    # read once, the damped system written once, rhs, the poses and planes
    # read and written; operations: each factor's evaluation twice (~3000 an
    # edge), the damping, ~300 per node for the candidate
    lm_bytes = nbytes(*g) + 4 * (n * n + n) + 2 * nbytes(g.poses, g.planes)
    lm_ops = 2 * 3000 * n_edges + n * n + 300 * k
    measure(torch, records, "optimize_pose_graph", klm, plm, max(r["max_abs_err"] for r in lm_records.values()),
            lm_bytes, lm_ops)
    rec = records["optimize_pose_graph"]
    rec["lm_step_ms"] = rec["ms"]
    rec["ms"], _, _ = device_ms(torch, klm, DEVICE_FUNCTIONS["_chi2_and_normal"] + ("lm_step",))
    rec["hand_launches_per_iteration"] = len(per_iteration)
    rec["library_ms"] = prior["_chi2_and_normal"]["cholesky_ms"]
    rec["optimize"] = lm_records
    rec["lm_cases"] = case_records
    # the earlier count: H read and cleared, the damped system written, b,
    # rhs and the solve read, the poses and planes read, their candidates
    # written and read once more, plus K15's bound twice
    old_bound = bound(4 * (3 * n * n + 4 * n) + 3 * nbytes(g.poses, g.planes), n * n + 300 * k)[0] + 2 * prior[
        "_chi2_and_normal"]["bound_ms"]
    rec["bound_earlier_count_ms"] = old_bound
    per_it = rec["bound_ms"] + bound(0, n ** 3 / 3 + 2 * n * n)[0]
    for r in lm_records.values():
        r["bound_ms"] = r["iterations"] * per_it + prior["_chi2_and_normal"]["bound_ms"]
    log(f"    per iteration: the hand kernels (K15 damped + lm_step) {rec['ms']:.4f} ms (lm_step "
        f"{rec['lm_step_ms']:.4f}), "
        f"the whole iteration {rec['wrapper_device_ms']:.4f} ms device (the Cholesky "
        f"{prior['_chi2_and_normal']['cholesky_ms']:.4f} ms); bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}; the "
        f"earlier count, H's read and clear and K15 twice: {old_bound:.5f} ms); bound per optimize (2c) "
        f"{lm_records['2c']['bound_ms']:.5f} ms")
    return records


def run_factory(torch, scans, gt, dev, card):
    """Phase 10a: `select_registration_method`'s four methods on phase 10's
    pair at full width (tests/test_registrations.py's case at KITTI
    density), each against its plain path on the card, and warm-timed."""
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.ops.registrations import RegistrationParams, select_registration_method

    target, source, rel, guess = registration_pair(torch, scans, gt, dev)
    summary, launches = {}, {}
    for method, search, bound_m in FACTORY:
        reg = select_registration_method(
            RegistrationParams(registration_method=method, max_iterations=40, ndt_nn_search_method=search))
        reset_launches()
        res = reg(target, source, guess)
        torch.cuda.synchronize()
        counts = {name: k.launches for name, k in KERNELS.items() if k.launches}
        launches[method] = counts
        got = res.transform.cpu().numpy().astype(np.float64)
        t_err = float(np.linalg.norm(got[:3, 3] - rel[:3, 3]))
        fitness = float(res.fitness)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            reg(target, source, guess)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with plain_twins():
            twin = reg(target, source, guess).transform.cpu().numpy().astype(np.float64)
        dev_twin = float(np.abs(got - twin).max())
        log(f"  {method} ({search}): translation error {t_err:.4f} m (gate {bound_m}), fitness {fitness:.5f} (gate "
            f"0.5); vs the plain path on the card {dev_twin:.3g} (tol {FACTORY_TOL[method]:g}); warm "
            f"{np.median(walls) * 1e3:.2f} ms per align ({card}); launches {counts}")
        if not (t_err < bound_m and fitness < 0.5):
            raise AssertionError(f"{method} misses tests/test_registrations.py's gates at KITTI density")
        if dev_twin > FACTORY_TOL[method]:
            raise AssertionError(f"{method}: the card's transform departs from the plain path's")
        family = traced_family(trace_rows(torch, lambda: reg(target, source, guess)))
        log_family(f"{method} align", family)
        summary[method] = dict(t_err_m=t_err, fitness=fitness, ms_per_align=float(np.median(walls)) * 1e3,
                               vs_plain=dev_twin, traced=family)
    if launches["ICP"].get("nn_points", 0) != 41:
        raise AssertionError(f"ICP must launch K17 41 times (40 iterations and the fitness): {launches['ICP']}")
    if launches["GICP"].get("gicp_align", 0) != 20 or launches["GICP"].get("_plane_covariances", 0) != 21:
        raise AssertionError(f"GICP must launch K19b 20 and K19a 21 times: {launches['GICP']}")
    return summary, dict(nn_points=launches["ICP"]["nn_points"],
                         _plane_covariances=launches["GICP"]["_plane_covariances"],
                         gicp_align=launches["GICP"]["gicp_align"])


def run_ground_ndt(torch, scans, gt, dev, card):
    """Phase 10b: `ndt_ground_align` of scan 41 onto scan 40's 10 m map from
    a 0.5 m z error (tests/test_registrations.py's ground case)."""
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.ops import ndt_ground, voxel_map

    target, source, _, _ = registration_pair(torch, scans, gt, dev)
    guess = torch.eye(4, dtype=torch.float32, device=dev)
    guess[2, 3] = 0.5
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vm = voxel_map.build_voxel_map(target, 10.0, leaf_cap=4096, lut_extent=64)
    res = ndt_ground.ndt_ground_align(vm, voxel_map.build_lut(vm), source, guess, resolution=10.0,
                                      max_iterations=16)
    got = res.transform.cpu().numpy()
    elapsed = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items() if k.launches}
    log(f"  ground NDT: t = {got[:3, 3].round(5).tolist()} (gates |x|, |y| < 5e-3, |z| < 0.4), {int(res.iterations)} Newton "
        f"iterations, {elapsed * 1e3:.1f} ms map build and align included ({card}); launches {launches}")
    if not (abs(got[0, 3]) < 5e-3 and abs(got[1, 3]) < 5e-3 and abs(got[2, 3]) < 0.4):
        raise AssertionError("the ground NDT misses tests/test_registrations.py's gates")
    if not (launches.get("filter_ground_leaves") and launches.get("ndt_derivatives") and launches.get("newton_step")):
        raise AssertionError("the ground NDT must launch K20, K6G and K7")
    with plain_twins():
        twin = ndt_ground.ndt_ground_align(vm, voxel_map.build_lut(vm), source, guess, resolution=10.0,
                                           max_iterations=16).transform.cpu().numpy()
    first_poses_vs_cpu(got[None].astype(np.float64), twin[None].astype(np.float64), "ground-NDT transform",
                       "on the card")
    return dict(t=got[:3, 3].tolist(), iterations=int(res.iterations), ms=elapsed * 1e3), launches


TRACED_SCANS = 20  # phase 10c's traced prefilter calls


def run_dlo_branches(torch, scans, gt, dev, card):
    """Phase 10c: the host DLO (flagship config) over the whole circle with
    the prefilter's last branches: STATISTICAL with the angle calibration,
    then RADIUS."""
    import dataclasses

    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.odometry.dlo import DirectLidarOdometry, run_sequence
    from lv_slam_tpu_torch.ops.prefilter import prefilter

    cfg = kitti_flagship_config()
    n = len(scans)
    summary, launches = {}, {}
    for name, branches, kernels in (
        ("statistical", dict(outlier_removal_method="STATISTICAL", use_angle_calibration=True),
         ("statistical_outlier_removal", "vertical_angle_calibration")),
        ("radius", dict(outlier_removal_method="RADIUS"), ("radius_outlier_removal",)),
    ):
        pf = dataclasses.replace(cfg.prefilter, **branches)

        def cloud(i, device=dev):
            return PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=device)

        reset_launches()
        odo = DirectLidarOdometry(cfg.odometry, pf, device=dev)
        for i in range(WARM_SCANS):
            odo.process(cloud(i), i * 0.1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(WARM_SCANS, n):
            odo.process(cloud(i), i * 0.1)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = {k: KERNELS[k].launches for k in kernels}
        band = KERNELS["distance_filter"].launches
        log(f"  {name}: launches {counts} on {n} scans (one per scan); the band alone {band}")
        if any(c != n for c in counts.values()):
            raise AssertionError(f"{name}: each branch kernel must launch once per scan")
        if band != (0 if pf.use_angle_calibration else n):  # with the calibration, K0a's pass holds the band
            raise AssertionError(f"{name}: the band alone launched {band} times")
        launches.update(counts)
        est = np.stack(odo.poses)
        t_err, drift = accuracy(est, gt, f"host DLO poses with {name}, {n} scans", n)
        with plain_twins():
            twin = DirectLidarOdometry(cfg.odometry, pf, device=dev)
            for i in range(4):
                twin.process(cloud(i), i * 0.1)
        first_poses_vs_cpu(est, np.stack(twin.poses), f"host DLO poses with {name}", "on the card")
        ref, _ = run_sequence(scans[:4], cfg=cfg.odometry, prefilter_cfg=pf, cap=pf.raw_cap, device="cpu")
        first_poses_vs_cpu(est, ref, f"host DLO poses with {name}", tol=CPU_SPREAD_M)
        none = dataclasses.replace(pf, outlier_removal_method="NONE")
        dropped = np.array([int(prefilter(c, none).mask.sum()) - int(prefilter(c, pf).mask.sum())
                            for c in (cloud(i) for i in range(n))])
        log(f"  {name}: keyframes {odo.stats.keyframe_count}, retries {odo.stats.retries}; lanes the removal dropped "
            f"per scan: mean {dropped.mean():.1f}, min {dropped.min()}, max {dropped.max()}; timed "
            f"{n - WARM_SCANS} scans in {elapsed:.3f} s = {(n - WARM_SCANS) / elapsed:.2f} scans/s ({card})")
        family = traced_family(trace_rows(torch, lambda: [prefilter(cloud(i), pf) for i in range(TRACED_SCANS)]))
        log_family(f"{name}: the prefilter of {TRACED_SCANS} scans", family)
        summary[name] = dict(scans_per_s=(n - WARM_SCANS) / elapsed, devkit_t_err=t_err, drift_m=drift,
                             keyframes=odo.stats.keyframe_count, dropped_per_scan=float(dropped.mean()),
                             traced=family)
    return summary, launches


def loop_ms(torch, fn, reps: int = 5):
    """(device ms, wall ms) per call of a host loop `fn` (one that reads the
    host inside its loop): the median device work of the whole calls among
    `reps` in a torch.profiler trace (`device_ms`: a trace that lost records
    of a call leaves that call out), and the median host-clock wall of as
    many unprofiled calls, each ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    _, busy_ms, _ = device_ms(torch, fn, reps=reps)
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return busy_ms, float(np.median(walls))


# ----------------------------------------------------------------- phase 11

FLEET_CAP, FLEET_SCANS = 65536, 32  # bench.py:498-524: lanes at 65536 lanes, 32 scans each, lane i from scan 2i


def run_fleet(torch, scans, gt, dev, card):
    """Phase 11a: `run_fleet_odometry` without a mesh on the card, as
    bench.py's `BENCH_FLEET` runs the reference's (scans 0-39 of the circle
    at 65536 lanes, the flagship odometry and LFA, 1 and 4 lanes of 32 scans,
    lane i from scan 2i): a warm pass, then the best of two timed passes per
    lane count. Gates: every lane of the 4-lane pass equal to the
    single-sequence port run of its scans (`run_sequence_fused`, then
    `run_sequence_lfa` fed its poses) bit for bit, and its refined poses
    inside the accuracy gates. A profiled 4-lane pass gives the idle share."""
    import dataclasses

    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.lfa.fused import run_sequence_lfa
    from lv_slam_tpu_torch.odometry.fused import run_sequence_fused
    from lv_slam_tpu_torch.parallel.fleet import run_fleet_odometry

    cfg = kitti_flagship_config()
    pf = dataclasses.replace(cfg.prefilter, raw_cap=FLEET_CAP, out_cap=FLEET_CAP)
    clouds = [PointCloud.from_numpy(s, cap=FLEET_CAP, device=dev) for s in scans[:40]]
    fx, fm = torch.stack([c.xyz for c in clouds]), torch.stack([c.mask for c in clouds])
    stamps = torch.arange(FLEET_SCANS, dtype=torch.float32, device=dev) * 0.1

    def lanes_of(n):
        return (torch.stack([fx[2 * i:2 * i + FLEET_SCANS] for i in range(n)]),
                torch.stack([fm[2 * i:2 * i + FLEET_SCANS] for i in range(n)]), stamps.expand(n, FLEET_SCANS))

    def fleet(n):
        return run_fleet_odometry(None, *lanes_of(n), cfg.odometry, cfg.lfa, pf, device=dev)

    rate, poses = {}, None
    for n in (1, 4):
        reset_launches()
        poses = fleet(n)  # warm
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in KERNELS.items() if k.launches}
        best = np.inf
        for _ in range(2):
            t0 = time.perf_counter()
            fleet(n)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        rate[n] = n * FLEET_SCANS / best
        log(f"  {n} lane(s) x {FLEET_SCANS} scans: best of 2 passes {best:.3f} s = {rate[n]:.2f} scans/s in all "
            f"({card}); launches of the warm pass {launches}")
    errs = []
    for i in range(4):
        x, m = fx[2 * i:2 * i + FLEET_SCANS], fm[2 * i:2 * i + FLEET_SCANS]
        odom = run_sequence_fused(x, m, stamps, cfg.odometry, pf, device=dev)
        single = run_sequence_lfa(x, m, cfg.lfa, odom_poses=odom, device=dev)
        if not torch.equal(poses[i], single):
            raise AssertionError(f"fleet lane {i}: poses differ from the single-sequence run "
                                 f"(max {float((poses[i] - single).abs().max()):.3g})")
        errs.append(accuracy(poses[i].cpu().numpy().astype(np.float64), gt[2 * i:2 * i + FLEET_SCANS],
                             f"fleet lane {i} (scans {2 * i}-{2 * i + FLEET_SCANS - 1}), refined poses", FLEET_SCANS))
    log("  every lane of the 4-lane pass equals its single-sequence run (run_sequence_fused -> run_sequence_lfa) "
        "bit for bit")
    idle = profile(torch, lambda: fleet(4), "fleet_b4", span="the 4-lane fleet pass (128 scans)")
    summary = dict(fleet_scans_per_sec_per_lane_b4=rate[4] / 4, fleet_throughput_retention_b4=rate[4] / rate[1],
                   idle_share_b4=idle, scans_per_sec_b1=rate[1], scans_per_sec_b4=rate[4],
                   devkit_t_err_max=max(e[0] for e in errs), drift_m_max=max(e[1] for e in errs))
    log(f"  fleet_scans_per_sec_per_lane_b4 {summary['fleet_scans_per_sec_per_lane_b4']:.2f}, "
        f"fleet_throughput_retention_b4 {summary['fleet_throughput_retention_b4']:.3f}, idle share of the 4-lane "
        f"pass {idle:.3f} ({card})")
    return summary


MESH_ALIGN = dict(resolution=1.0, transformation_epsilon=0.01, neighborhood="DIRECT7", weighted=False)  # K13's 1 m rung
MESH_LM_ITERATIONS = 64


def mesh_inputs(vm, lut, cands, guesses, graph, iterations, meshes):
    """`lv_slam_tpu_torch.parallel.check`'s inputs (host arrays) for K13's
    batch at the 1 m rung and phase 2c's graph: the derivatives of pair 0 at
    its guess, the aligns of the pairs, the LM, on `meshes`, on the card."""
    return dict(
        map={k: v.cpu().numpy() if hasattr(v, "cpu") else v for k, v in vm._asdict().items()}, lut=lut.cpu().numpy(),
        xyz=np.stack([c.masked_xyz().cpu().numpy() for c in cands]),
        mask=np.stack([c.mask.cpu().numpy() for c in cands]), guesses=guesses.cpu().numpy(),
        T=guesses[0].cpu().numpy(), graph={k: np.asarray(v) for k, v in graph._asdict().items()}, meshes=meshes,
        align=dict(MESH_ALIGN, max_iterations=iterations), lm_iterations=MESH_LM_ITERATIONS, device="cuda",
    )


def run_mesh(torch, scans, gt, dev, card):
    """Phase 11b: the mesh. In a single-process NCCL world of one rank, mesh
    (1, 1) on the card: `ndt_align_sharded` on K13's batch at the 1 m rung (8
    pairs x 131072 lanes, DIRECT7) equal to `ndt_align_soa` of each pair bit
    for bit, and `optimize_pose_graph_sharded` on phase 2c's graph equal to
    `optimize_pose_graph` bit for bit (the all-reduce of one rank leaves H
    and b as they are, and K15 sums in a fixed order). Then phase 11c in
    the same world. Then a spawned 2-rank gloo world on the same card,
    meshes (1, 2) and (2, 1), held to the unsharded port on the card at
    `parallel.check.TOLERANCES` (the CPU tests'). The sharded align's
    launches (`newton_sums` among them) are counted from 0 in the NCCL
    world's align."""
    import torch.distributed as dist

    import lv_slam_tpu_torch.graph.pose_graph as pose_graph
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.kernels import KERNELS, reset_launches
    from lv_slam_tpu_torch.ops import ndt_soa, voxel_map
    from lv_slam_tpu_torch.parallel import check as pcheck, mesh as pmesh

    iters = kitti_flagship_config().loop.verify_max_iterations
    keyframe, cands, guesses = loop_batch(torch, scans, gt, dev)
    vm = voxel_map.build_voxel_map(keyframe, 1.0, leaf_cap=16384, lut_extent=256)
    lut = voxel_map.build_lut(vm)
    b = len(cands)
    xyz = torch.stack([c.masked_xyz() for c in cands])
    mask = torch.stack([c.mask for c in cands])
    rel_all = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    graph, _ = backend_graph(torch, rel_all, False)
    summary = {}

    store = CACHE / "mesh" / "nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(1, 1)
        log(f"  NCCL world of 1 on {torch.cuda.get_device_name(0)}: mesh {tuple(mesh.mesh.shape)} "
            f"{mesh.mesh_dim_names}")
        reset_launches()
        t0 = time.perf_counter()
        t, s, it = pmesh.ndt_align_sharded(mesh, pmesh.stack_maps([vm] * b), torch.stack([lut] * b), xyz, mask,
                                           guesses, max_iterations=iters, **MESH_ALIGN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in KERNELS.items() if k.launches}
        log(f"  launches of the sharded align: {launches}")
        if not launches.get("newton_sums") or launches.get("newton_sums") != launches.get("newton_step"):
            raise AssertionError(f"the sharded align launched newton_sums {launches.get('newton_sums', 0)} times, "
                                 f"newton_step {launches.get('newton_step', 0)} times (expected as many, and some)")
        aligns = [ndt_soa.ndt_align_soa(vm, lut, c, guesses[j], max_iterations=iters, **MESH_ALIGN)
                  for j, c in enumerate(cands)]
        for j, want in enumerate(aligns):
            if not (torch.equal(t[j], want.transform) and torch.equal(s[j], want.score)
                    and int(it[j]) == int(want.iterations)):
                raise AssertionError(f"sharded align, pair {j}: differs from ndt_align_soa "
                                     f"(max {float((t[j] - want.transform).abs().max()):.3g})")
        log(f"  ndt_align_sharded, {b} pairs x {xyz.shape[1]} lanes (DIRECT7, 1 m): iterations {it.tolist()}, "
            f"{wall * 1e3:.1f} ms wall; transforms, scores and iterations equal to ndt_align_soa's bit for bit")
        got = pmesh.optimize_pose_graph_sharded(mesh, graph, MESH_LM_ITERATIONS)
        want = pose_graph.optimize_pose_graph(graph, MESH_LM_ITERATIONS, device=dev)
        d_pose = float((got.poses - want.poses).abs().max())
        d_plane = float((got.planes - want.planes).abs().max())
        d_chi2 = abs(float(got.chi2_after) - float(want.chi2_after)) / max(float(want.chi2_after), 1e-30)
        log(f"  optimize_pose_graph_sharded on phase 2c's graph: {int(got.iterations)} iterations "
            f"({int(want.iterations)} unsharded), chi2 {float(got.chi2_before):.3f} -> {float(got.chi2_after):.3f}; "
            f"poses within {d_pose:.3g}, planes {d_plane:.3g}, chi2 {d_chi2:.3g} relative (bit for bit expected)")
        if not all(torch.equal(getattr(got, f), getattr(want, f)) for f in got._fields):
            raise AssertionError("the sharded LM on a mesh of one rank departs from optimize_pose_graph")
        summary["nccl_world_1"] = dict(align_ms=wall * 1e3, align_iterations=it.tolist(),
                                       lm_iterations=int(got.iterations), launches=launches)
        log("phase 11c: the port's entry points")
        summary["entry"] = run_entry(torch, dev, card)
    finally:
        dist.destroy_process_group()

    log("  NCCL refuses two ranks on one GPU (a communicator of duplicate devices), so the 2-rank check runs gloo "
        "on the same card; it exists to run the collectives with more than one rank, and is no fallback")
    inputs = mesh_inputs(vm, lut, cands[:2], guesses[:2], graph, iters, [(1, 2), (2, 1)])
    t0 = time.perf_counter()
    ranks = pcheck.spawn(2, "sharded_cases", inputs, CACHE / "mesh" / "gloo")
    wall = time.perf_counter() - t0
    pcheck.check_same_bits(ranks)
    unsharded = pcheck.unsharded_cases(inputs)
    for shape, res in ranks[0].items():
        pcheck.check(res, unsharded)
        log(f"  gloo mesh {shape} on the card: derivatives, 2 aligns (iterations {res['iterations'].tolist()}) and "
            f"the LM ({float(res['chi2_before']):.3f} -> {float(res['chi2_after']):.3f}) within "
            f"parallel.check.TOLERANCES {pcheck.TOLERANCES} of the unsharded port, both ranks bit-identical")
    summary["gloo_world_2_s"] = wall
    log(f"  the 2-rank gloo world took {wall:.1f} s with its spawn ({card})")
    return summary


def run_entry(torch, dev, card):
    """Phase 11c: `entry()`'s odometry step on the card, held to the same
    step with the plain versions on the CPU within the reference's one-ulp
    spread (CPU_SPREAD_M, phase 8's), and `dryrun_multichip(1)` in the
    caller's NCCL world of one rank."""
    from lv_slam_tpu_torch import entry

    fn, args = entry.entry(device=dev)
    t, s, it = fn(*args)
    t0 = time.perf_counter()
    t, s, it = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu_fn, cpu_args = entry.entry(device="cpu")
    t_cpu = cpu_fn(*cpu_args)[0]
    d = float((t.cpu() - t_cpu).abs().max())
    log(f"  entry(): step {wall * 1e3:.2f} ms warm, score {float(s):.2f}, {int(it)} iterations, transform within "
        f"{d:.3g} of the CPU plain path's (tol {CPU_SPREAD_M}) ({card})")
    if not bool(torch.isfinite(t).all()) or d > CPU_SPREAD_M:
        raise AssertionError("entry(): the card's step departs from the CPU plain path's")
    t0 = time.perf_counter()
    entry.dryrun_multichip(1)
    torch.cuda.synchronize()
    log(f"  dryrun_multichip(1): the sharded align, the sharded LM and the fleet with and without LFA ran in "
        f"{time.perf_counter() - t0:.2f} s")
    return dict(step_ms=wall * 1e3, iterations=int(it), cpu_diff=d)


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
    import lv_slam_tpu_torch.pipeline.slam  # noqa: F401  (floor detection)
    import lv_slam_tpu_torch.ops.ndt_ground  # noqa: F401  (K20)
    import lv_slam_tpu_torch.ops.registrations  # noqa: F401  (K17's ICP, K19a, K19b)

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
    usage = {}
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
        usage = ptxas_usage(build_log.read_text())
        for fn, u in sorted(usage.items()):
            log(f"  ptxas -v: {fn}: {u['registers']} registers, {u['spills']} bytes of spills, {u['stack']} of stack")
        front = ptxas_usage(build_log.read_text(), ("plane_cov", "prefilter_front"))
        for fn, u in sorted(front.items()):
            log(f"  ptxas -v: {fn}: {u['registers']} registers, {u['spills']} bytes of spills, {u['stack']} of stack")
        k8 = [u for fn, u in front.items() if "plane_covILi8E" in fn]
        if not k8 or k8[0]["stack"] or k8[0]["spills"]:
            raise AssertionError(f"K19a's k = 8 instance must keep its sums in registers (no stack frame): {k8}")
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
    records["build_voxel_map"]["rung_4m"] = records.pop("_build_voxel_map_4m")
    log("phase 2d: the camera kernels (ORB, descriptor matching)")
    records.update(check_orb_kernels(torch, gt_all, dev))
    log("phase 2e: standalone LFA's kernels (grid build, 2-NN lines / 3-NN planes, host table build)")
    records.update(check_standalone_kernels(torch, scans_all, dev))
    log("phase 2f: the LUT paths' kernels (dense LUT, LUT/SoA derivative pass, generic derivative pass)")
    records.update(check_lut_kernels(torch, scans_all, gt_all, dev))

    log("phase 2g: the backend's input kernels (raw window group, the sensor factors, floor detection)")
    graph_records = check_graph_input_kernels(torch, scans_all, gt_all, dev)
    records["_chi2_and_normal"]["with_sensor_factors"] = graph_records.pop("_chi2_and_normal_sensors")
    records.update(graph_records)
    log("phase 2h: the registrations' and the prefilter branches' kernels (K17-K20, K0a)")
    records.update(check_registration_kernels(torch, scans_all, gt_all, dev))
    records["knn"]["gicp"] = records.pop("_knn_gicp")
    records["build_grid"]["gicp"] = records.pop("_grid_gicp")
    log("phase 2i: the device-side loops (K7's newton_step over K6L and K13's pass, the LM's kernels around K15)")
    records.update(check_loop_kernels(torch, scans_all, gt_all, dev, records))
    for name, fn in (("newton_step", "newton_step"), ("ndt_derivatives_hash", "ndt_partials"),
                     ("_fused_verify_fn", "ndt_partials"), ("ndt_derivatives_soa", "lut_pass"),
                     ("ndt_derivatives", "lut_pass")):
        records[name]["ptxas"] = {k: v for k, v in usage.items() if fn in k}
    log("phase 2j: the 8-cell k-NN of a cell table (K9n) and the fits' KnnGrid branch (K10g)")
    cell_records, cell_launches = check_cell_knn_kernels(torch, scans_all, gt_all, dev)
    records.update(cell_records)

    log("phase 3: the odometry slice end to end")
    summary, odometry_poses, odometry_syncs, slice_launches = run_slice(torch, scans, gt, dev, card)
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
    camera_summary = summary
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
    dlo_summary = summary
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 8b: LvSlam() at its default, host DLO -> LFA -> ggo with camera images, end to end")
    summary, _ = run_lvslam_default(torch, scans_all, gt_all, dev, card, images)
    lvslam_err = summary["max_keyframe_err_m"]
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 8c: the fused odometry with table=\"lut\"")
    summary = run_fused_lut(torch, scans, gt, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 8d: the generic ndt_align (DIRECT7) at full width")
    summary, align_launches = run_generic_align(torch, scans_all, gt_all, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    records["ndt_derivatives_soa"]["traced_8a"] = dlo_summary["lut_traced"]
    launches.update(build_lut=dlo_launches["build_lut"], ndt_derivatives_soa=dlo_launches["ndt_derivatives_soa"],
                    uniform_subsample=dlo_launches["uniform_subsample"],
                    ndt_derivatives=align_launches["ndt_derivatives"])
    launch_phase.update(build_lut="8a", ndt_derivatives_soa="8a", uniform_subsample="8a", ndt_derivatives="8d")

    log("phase 9a: the main path with the backend's default raw-chunk feed, camera images and GPS / IMU priors")
    summary, raw_launches = run_raw_path(torch, scans_all, gt_all, dev, card, images, camera_summary)
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 9b: LvSlam() with GPS / IMU readings and floor detection, end to end")
    summary, floor_launches, slam = run_lvslam_sensors(torch, scans_all, gt_all, dev, card, images, lvslam_err)
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 9c: the services on phase 9b's backend: dump, load_dump, re-optimize, save_map, save_pose")
    summary = run_services(torch, slam, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 9d: tests/test_multi_loop.py's double circle through the raw feed")
    summary = run_double_circle(torch, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    launches.update(window_group_fn=raw_launches["window_group_fn"], detect_floor=floor_launches["detect_floor"])
    launch_phase.update(window_group_fn="9a", detect_floor="9b")

    log("phase 10a: the registration factory (NDT_OMP, NDT_PCA, ICP, GICP) on scans 40 -> 41 at full width")
    summary, factory_launches = run_factory(torch, scans_all, gt_all, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 10b: the ground-constrained NDT")
    summary, ground_launches = run_ground_ndt(torch, scans_all, gt_all, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 10c: the host DLO with the prefilter's last branches (STATISTICAL + calibration, RADIUS)")
    summary, branch_launches = run_dlo_branches(torch, scans_all, gt_all, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    # K7's steps on the phase of each path: the hash pass (3), K6L's (8a),
    # K13's (5: one step per batched pass) and the `dof` form (10b)
    newton_by_phase = {"3": slice_launches["newton_step"], "8a": dlo_launches["newton_step"],
                       "5 (K13)": launches["_fused_verify_fn"], "10b": ground_launches["newton_step"]}
    log(f"  newton_step launches by phase: {newton_by_phase}")
    launches.update(factory_launches, filter_ground_leaves=ground_launches["filter_ground_leaves"], **branch_launches,
                    newton_step=slice_launches["newton_step"])
    launch_phase.update(dict.fromkeys(factory_launches, "10a"), filter_ground_leaves="10b",
                        **dict.fromkeys(branch_launches, "10c"), newton_step="3")
    records["newton_step"]["launches_by_phase"] = newton_by_phase
    launches.update(cell_launches)
    launch_phase.update(dict.fromkeys(cell_launches, "2j"))

    log("phase 11a: the fleet, 1 and 4 lanes of the dlo -> LFA chain on the card (bench.py's BENCH_FLEET shape)")
    summary = run_fleet(torch, scans_all, gt_all, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    log("phase 11b: the mesh over torch.distributed (an NCCL world of 1, then a gloo world of 2 on the card)")
    summary = run_mesh(torch, scans_all, gt_all, dev, card)
    log(f"  summary ({card}): {json.dumps(summary)}")
    launches["newton_sums"] = summary["nccl_world_1"]["launches"]["newton_sums"]
    launch_phase["newton_sums"] = "11b"

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(
            name=name, route="cuda", source=k.source, replaces=k.replaces,
            launches=launches[name], launch_phase=launch_phase[name], **{key: records[name][key] for key in keys},
            **{extra: records[name][extra]
               for extra in ("cholesky_ms", "with_sensor_factors", "launches_by_phase", "over_cap", "standalone",
                             "torch_sort_ms", "torch_topk_ms", "rung_4m", "lm_step_ms", "hand_launches_per_iteration",
                             "bound_earlier_count_ms", "gate_closed", "surf_only", "gicp", "edge", "gated_pass",
                             "direct7", "newton_step_rows", "traced_8a", "with_band", "plain_launches",
                             "target_call")
               if extra in records[name]},
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
