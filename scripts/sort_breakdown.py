#!/usr/bin/env python3
"""Splits the device time of the port's key-sort users into their kernels on
one NVIDIA GPU: K1 (`voxel_downsample`), K1b (`voxel_dedup_first`), K2
(`window_group_filtered`), K2r (`window_group`) and K3 (`build_voxel_map`),
at chip_smoke.py's shapes.

    python scripts/sort_breakdown.py [--out FILE]

Simulates the first 24 scans of the reference benchmark's circle (or reads
chip_smoke.py's scan cache), filters them through the flagship prefilter
(K1 at 131072 lanes), and times: K3 on scan 0's 65536-lane subsample with
the flagship NDT map (phase 2's shape), at the loop detector's 4 m and 1 m
rungs over the 16-scan keyframe cloud, and over one 1 m voxel holding
16384 lanes (one run, the longest chain); K2 on scans 0-15 (16 x 131072
rows); K2r on raw scans 0-15 (16 x 131072 raw lanes into 131072
centroids, phase 2g's flagship group; the group's voxel count is printed);
K1b on that keyframe cloud beside scans 16-23's (262144 rows). Each
is timed as chip_smoke.py times a kernel (`device_ms`: the median over the
whole calls among 20 in a torch.profiler trace), and split per device
function with torch.profiler's `key_averages()` over 20 more calls (us a
call, launches a call). Prints one line per shape and writes them as JSON
to FILE (default `chiprun_out/sort_breakdown.json`), beside the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N_SCANS = 24


def breakdown(torch, fn, reps: int = 20) -> dict:
    """{device function: (us a call, launches a call)} over `reps` calls of `fn`."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
            name = re.sub(r"^void |\(anonymous namespace\)::|lvs::keysort::", "", e.key).split("(")[0].split("<")[0]
            out[name] = (round(t / reps, 2), round(e.count / reps, 2))
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "sort_breakdown.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sort_breakdown: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs

    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.io import synthetic
    from lv_slam_tpu_torch.ops import prefilter, voxel_map
    from lv_slam_tpu_torch.pipeline import window

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    cfg = kitti_flagship_config()
    pf, ndt = cfg.prefilter, cfg.odometry.ndt
    if (cs.CACHE / f"scans_v1_{cs.N_FULL}.npz").exists():
        scans = cs.load_scans(cs.N_FULL)[0][:N_SCANS]
    else:
        with multiprocessing.get_context("spawn").Pool(8) as pool:
            scans = pool.starmap(cs._simulate, [(i, cs.N_FULL) for i in range(N_SCANS)])
    gt = synthetic.circle_trajectory(cs.N_FULL, step=1.0)
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)

    def band(i):
        raw = PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev)
        return prefilter.distance_filter(raw, pf.distance_near_thresh, pf.distance_far_thresh)

    rows = [prefilter.voxel_downsample(band(i), pf.downsample_resolution, pf.out_cap) for i in range(N_SCANS)]

    def group(first, length):
        r = rows[first:first + length]
        return (torch.stack([c.xyz.T for c in r]).contiguous(), torch.stack([c.intensity for c in r]),
                torch.stack([c.mask for c in r]), 0, torch.from_numpy(rel[first:first + length]).to(dev),
                torch.ones(length, dtype=torch.bool, device=dev), pf.downsample_resolution, 131072)

    g16 = group(0, 16)
    keyframe = window.window_group_filtered(*g16)
    both = PointCloud(*(torch.cat([a, b]) for a, b in zip(keyframe, window.window_group_filtered(*group(16, 8)))))
    scan = prefilter.stride_subsample(rows[0], cfg.odometry.scan_matching_cap)
    kw = dict(leaf_cap=ndt.leaf_cap, lut_extent=ndt.lut_extent, min_points_per_voxel=ndt.min_points_per_voxel,
              min_covar_eigvalue_mult=ndt.min_covar_eigvalue_mult, weighted=ndt.weighted)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    one = PointCloud(torch.rand(16384, 3, device=dev, generator=gen) * 0.9 + 12.05, torch.zeros(16384, device=dev),
                     torch.ones(16384, dtype=torch.bool, device=dev))
    b0 = band(0)
    raw = [PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev) for i in range(16)]
    g16r = [torch.stack([c.xyz for c in raw]), torch.stack([c.intensity for c in raw]),
            torch.stack([c.mask for c in raw]), 0, torch.from_numpy(rel[:16]).to(dev),
            torch.ones(16, dtype=torch.bool, device=dev), pf.distance_near_thresh, pf.distance_far_thresh,
            pf.downsample_resolution, 131072]
    every = window.window_group(*g16r[:-1], 16 * pf.raw_cap)
    print(f"K2r's flagship group: {int(g16r[2].sum())} valid lanes, {int(every.mask.sum())} voxels", flush=True)
    shapes = [
        ("K3 phase 2: 65536 lanes, the flagship map", "build_voxel_map",
         lambda: voxel_map.build_voxel_map(scan, ndt.resolution, **kw)),
        ("K3 the 4 m rung over the keyframe cloud", "build_voxel_map",
         lambda: voxel_map.build_voxel_map(keyframe, 4.0, leaf_cap=16384, lut_extent=256)),
        ("K3 the 1 m rung over the keyframe cloud", "build_voxel_map",
         lambda: voxel_map.build_voxel_map(keyframe, 1.0, leaf_cap=16384, lut_extent=256)),
        ("K3 one 1 m voxel holding 16384 lanes", "build_voxel_map",
         lambda: voxel_map.build_voxel_map(one, 1.0, leaf_cap=16, lut_extent=256)),
        ("K2 16 x 131072 rows", "window_group_filtered_fn", lambda: window.window_group_filtered(*g16)),
        ("K2r 16 x 131072 raw lanes", "window_group_fn", lambda: window.window_group(*g16r)),
        ("K1b 262144 rows", "voxel_dedup_first", lambda: prefilter.voxel_dedup_first(both, 0.1, 131072)),
        ("K1 131072 lanes", "voxel_downsample",
         lambda: prefilter.voxel_downsample(b0, pf.downsample_resolution, pf.out_cap)),
    ]
    out = []
    for name, kernel, fn in shapes:
        ms, all_ms, n = cs.device_ms(torch, fn, cs.DEVICE_FUNCTIONS[kernel])
        split = breakdown(torch, fn)
        out.append(dict(shape=name, ms=ms, device_ms=all_ms, calls=n, us_and_launches_a_call=split))
        print(f"{name}: {ms:.4f} ms of its own kernels ({all_ms:.4f} ms of device work, {n} whole calls); "
              f"us and launches a call: {split}", flush=True)
    skeys = voxel_map._leaf_sort(keyframe, 4.0, 256)[0]
    _, runs = torch.unique_consecutive(skeys[skeys < 256 ** 3], return_counts=True)
    print(f"the 4 m rung: {runs.numel()} runs, the longest {int(runs.max())} points", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, shapes=out, rung_4m_runs=runs.numel(),
                                        rung_4m_longest=int(runs.max())), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
