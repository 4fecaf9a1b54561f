#!/usr/bin/env python3
"""Holds kernel 3 (the NDT voxel-map build, `lv_slam_tpu_torch/csrc/voxel_map.cu`)
bit for bit against an earlier tree's kernel on one NVIDIA GPU, and times
both device-only.

    python scripts/k3_parent.py --parent DIR [--out FILE]

DIR holds an earlier tree's `lv_slam_tpu_torch/csrc` (e.g. `git archive
<commit> lv_slam_tpu_torch/csrc | tar -x -C DIR`) whose `voxel_map.cu` has the
route this kernel replaced: `ops/voxel_map._leaf_sort` (torch ops and
torch.sort of the flat keys), `lvs_voxel_map_mark`, `torch.cumsum` and
`lvs_voxel_map_build`, then `torch.sum` for n_leaves. The script builds
that file with `kernels/_build.py`'s nvcc flags into `_cache/k3_parent/`
and runs that route and the shipped `build_voxel_map` on the same clouds:
chip_smoke.py phase 2's (scan 0 of the reference benchmark's circle through
the flagship prefilter, 65536 lanes, the flagship NDT map), every case of
`chip_smoke.map_cases`, and the loop detector's 4 m and 1 m rungs over the
16-scan keyframe cloud of phase 2c. Every output (means, icovs, weights,
normals, valid, keys, n_leaves, origin_cell) must be bit-identical. Each
route is timed as chip_smoke.py times a kernel (the median over the whole
calls among 20 in a torch.profiler trace): the shipped kernel's own
launches, and the earlier route's whole device work, its torch glue
included. Prints one line per cloud and writes them as JSON to FILE
(default `chiprun_out/k3_parent.json`), beside the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import multiprocessing
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N_WINDOW = 16  # scans in the keyframe cloud of the loop detector's rungs


def build(source: Path, out: Path) -> ctypes.CDLL:
    from lv_slam_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc_path

    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc_path(), *NVCC_FLAGS, "-shared", "-I", str(source.parent), "-o", str(out), str(source)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(out))


def parent_route(torch, lib):
    """The earlier tree's `build_voxel_map` on CUDA, over its library `lib`."""
    from lv_slam_tpu_torch.kernels._build import ptr
    from lv_slam_tpu_torch.ops.cells import inv_resolution
    from lv_slam_tpu_torch.ops.voxel_map import VoxelMap, _leaf_sort

    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731

    def run(cloud, resolution, leaf_cap=32768, lut_extent=256, min_points_per_voxel=6,
            min_covar_eigvalue_mult=0.01, weighted=False):
        e, n, dev = lut_extent, cloud.cap, cloud.xyz.device
        skeys, order, xyz, origin = _leaf_sort(cloud, resolution, e)
        flag = torch.empty((n,), dtype=torch.int32, device=dev)
        out = dict(means=(leaf_cap, 3), icovs=(leaf_cap, 3, 3), weights=(leaf_cap,), normals=(leaf_cap, 3))
        out = {k: torch.empty(shape, dtype=torch.float32, device=dev) for k, shape in out.items()}
        valid = torch.empty((leaf_cap,), dtype=torch.bool, device=dev)
        keys = torch.empty((leaf_cap,), dtype=torch.int32, device=dev)
        if lib.lvs_voxel_map_mark(ptr(skeys), n, e * e * e, ptr(flag), stream()):
            raise RuntimeError("lvs_voxel_map_mark failed")
        cum = torch.cumsum(flag, dim=0, dtype=torch.int32)
        if lib.lvs_voxel_map_build(
                ptr(skeys), ptr(order), ptr(flag), ptr(cum), n, ptr(xyz), ptr(origin),
                ctypes.c_float(np.float32(resolution)), ctypes.c_float(inv_resolution(resolution)), e, leaf_cap,
                min_points_per_voxel, ctypes.c_float(np.float32(min_covar_eigvalue_mult)), int(weighted),
                ptr(out["means"]), ptr(out["icovs"]), ptr(out["weights"]), ptr(out["normals"]), ptr(valid), ptr(keys),
                stream()):
            raise RuntimeError("lvs_voxel_map_build failed")
        return VoxelMap(**out, valid=valid, keys=keys, origin_cell=origin, resolution=float(resolution),
                        n_leaves=torch.sum(valid.to(torch.int32)), extent=e)

    return run


def identical(torch, a, b) -> list:
    """The fields of two VoxelMaps that are not bit-identical."""
    differ = []
    for field in ("means", "icovs", "weights", "normals", "valid", "keys", "n_leaves", "origin_cell"):
        x, y = getattr(a, field), getattr(b, field)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            differ.append(field)
    return differ


def clouds(torch, cs, dev):
    """[(name, cloud, resolution, build kwargs)] at chip_smoke's shapes."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.io import synthetic
    from lv_slam_tpu_torch.ops import prefilter
    from lv_slam_tpu_torch.pipeline import window

    cfg = kitti_flagship_config()
    pf, ndt = cfg.prefilter, cfg.odometry.ndt
    if (cs.CACHE / f"scans_v1_{cs.N_FULL}.npz").exists():
        scans = cs.load_scans(cs.N_FULL)[0][:N_WINDOW]
    else:
        with multiprocessing.get_context("spawn").Pool(8) as pool:
            scans = pool.starmap(cs._simulate, [(i, cs.N_FULL) for i in range(N_WINDOW)])
    gt = synthetic.circle_trajectory(cs.N_FULL, step=1.0)

    def filtered(i):
        raw = PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev)
        band = prefilter.distance_filter(raw, pf.distance_near_thresh, pf.distance_far_thresh)
        return prefilter.voxel_downsample(band, pf.downsample_resolution, pf.out_cap)

    rows = [filtered(i) for i in range(N_WINDOW)]
    flagship = dict(leaf_cap=ndt.leaf_cap, lut_extent=ndt.lut_extent, min_points_per_voxel=ndt.min_points_per_voxel,
                    min_covar_eigvalue_mult=ndt.min_covar_eigvalue_mult, weighted=ndt.weighted)
    out = [("phase 2: scan 0, 65536 lanes, the flagship map",
            prefilter.stride_subsample(rows[0], cfg.odometry.scan_matching_cap), ndt.resolution, flagship)]
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt[:N_WINDOW]).astype(np.float32)
    keyframe = window.window_group_filtered(
        torch.stack([c.xyz.T for c in rows]).contiguous(), torch.stack([c.intensity for c in rows]),
        torch.stack([c.mask for c in rows]), 0, torch.from_numpy(rel).to(dev),
        torch.ones(N_WINDOW, dtype=torch.bool, device=dev), pf.downsample_resolution, 131072)
    for r in (4.0, 1.0):
        out.append((f"the loop detector's {r:g} m rung over the {N_WINDOW}-scan keyframe cloud", keyframe, r,
                    dict(leaf_cap=16384, lut_extent=256)))
    for name, pts, mask, res, leaf_cap, e, weighted in cs.map_cases():
        cloud = PointCloud(torch.from_numpy(pts).to(dev), torch.zeros(len(pts), device=dev),
                           torch.from_numpy(mask).to(dev))
        out.append((f"map_cases: {name}", cloud, res, dict(leaf_cap=leaf_cap, lut_extent=e, weighted=weighted)))
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, required=True, help="an earlier tree holding lv_slam_tpu_torch/csrc")
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "k3_parent.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_parent: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs

    from lv_slam_tpu_torch.ops import voxel_map

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    lib = build(args.parent / "lv_slam_tpu_torch" / "csrc" / "voxel_map.cu",
                ROOT / "_cache" / "k3_parent" / "libk3_parent.so")
    for fn in (lib.lvs_voxel_map_mark, lib.lvs_voxel_map_build):
        fn.restype = ctypes.c_int
    parent = parent_route(torch, lib)
    rows, failed = [], []
    for i, (name, cloud, res, kw) in enumerate(clouds(torch, cs, dev)):
        shipped = lambda: voxel_map.build_voxel_map(cloud, res, **kw)  # noqa: E731
        earlier = lambda: parent(cloud, res, **kw)  # noqa: E731
        got, want = shipped(), earlier()
        torch.cuda.synchronize()
        differ = identical(torch, got, want)
        if differ:
            failed.append(name)
        row = dict(cloud=name, lanes=cloud.cap, valid_leaves=int(want.n_leaves), bit_identical=not differ,
                   differ=differ)
        if i < 3:  # the main path's shapes: timed
            row["ms"] = cs.device_ms(torch, shipped, cs.DEVICE_FUNCTIONS["build_voxel_map"])[0]
            row["parent_ms"] = cs.device_ms(torch, earlier)[1]
        rows.append(row)
        times = f", shipped {row['ms']:.4f} ms, parent route {row['parent_ms']:.4f} ms" if "ms" in row else ""
        print(f"{name}: {row['valid_leaves']} valid leaves, "
              f"{'bit-identical' if not differ else 'DIFFERS in ' + ', '.join(differ)}{times}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    if failed:
        print(f"k3_parent: not bit-identical on {failed}", flush=True)
        return 1
    print(f"k3_parent: all {len(rows)} clouds bit-identical to the parent tree's kernel", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
